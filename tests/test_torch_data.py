"""The port's synthetic token pipeline is the reference's, array for array:
``batch_at`` over several (seed, step, shard, num_shards), the hash it is
built on, and the prefetcher's order."""
import numpy as np
import pytest

from repro.data import pipeline as R
from repro_torch.data import pipeline as T


@pytest.mark.parametrize("seed,step,shard,num_shards,vocab,seq,batch", [
    (0, 0, 0, 1, 256, 16, 4),
    (0, 7, 1, 2, 256, 16, 4),
    (3, 123, 3, 4, 151936, 33, 8),
    (11, 2**31 + 5, 0, 1, 97, 64, 2),
])
def test_batch_at_is_the_reference_stream(seed, step, shard, num_shards, vocab, seq, batch):
    kw = dict(vocab_size=vocab, seq_len=seq, global_batch=batch, seed=seed)
    want = R.SyntheticTokens(R.DataConfig(**kw)).batch_at(step, shard=shard,
                                                           num_shards=num_shards)
    got = T.SyntheticTokens(T.DataConfig(**kw)).batch_at(step, shard=shard,
                                                         num_shards=num_shards)
    assert set(got) == set(want) == {"tokens", "targets"}
    for k in want:
        assert got[k].dtype == want[k].dtype == np.int32
        np.testing.assert_array_equal(got[k], want[k])


def test_noise_setting_and_shards_tile_the_batch():
    kw = dict(vocab_size=50, seq_len=24, global_batch=6, seed=2, noise=0.5)
    ref, port = R.SyntheticTokens(R.DataConfig(**kw)), T.SyntheticTokens(T.DataConfig(**kw))
    whole = port.batch_at(4)
    np.testing.assert_array_equal(whole["tokens"], ref.batch_at(4)["tokens"])
    parts = [port.batch_at(4, shard=i, num_shards=3)["tokens"] for i in range(3)]
    np.testing.assert_array_equal(np.concatenate(parts), whole["tokens"])


def test_mix_hash_is_the_reference_hash():
    a = np.random.default_rng(0).integers(0, 2**63, 1000, dtype=np.uint64)
    np.testing.assert_array_equal(T._mix(a.copy()), R._mix(a.copy()))


def test_iteration_and_prefetcher_order():
    cfg = dict(vocab_size=50, seq_len=8, global_batch=2)
    src = T.SyntheticTokens(T.DataConfig(**cfg))
    it = iter(src)
    for step in range(3):
        np.testing.assert_array_equal(next(it)["tokens"], src.batch_at(step)["tokens"])
    pf = T.Prefetcher(src, start_step=5, depth=2)
    try:
        got = [pf.next() for _ in range(4)]
    finally:
        pf.close()
    assert [s for s, _ in got] == [5, 6, 7, 8]
    ref = R.SyntheticTokens(R.DataConfig(**cfg))
    for s, b in got:
        np.testing.assert_array_equal(b["tokens"], ref.batch_at(s)["tokens"])
    assert not pf._thread.is_alive()
