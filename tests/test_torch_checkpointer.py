"""The port's array ``Checkpointer``: round trip, retention, integrity,
async write, bfloat16 leaves bit for bit, and float32 checkpoints that
restore across the two packages in both directions."""
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.checkpoint.checkpointer import Checkpointer as RefCheckpointer
from repro_torch.checkpoint.checkpointer import Checkpointer


def _np_tree(seed=0):
    rng = np.random.default_rng(seed)
    return {
        "params": {"w": rng.standard_normal((4, 8)).astype(np.float32),
                   "blocks": {"pos0": {"scale": rng.standard_normal((2, 8)).astype(np.float32)}},
                   "embed": rng.standard_normal((16, 8)).astype(np.float32)},
        "opt": {"m": {"w": rng.standard_normal((4, 8)).astype(np.float32)},
                "count": np.asarray(3, np.int32)},
    }


def _torch_tree(tree):
    if isinstance(tree, dict):
        return {k: _torch_tree(v) for k, v in tree.items()}
    return torch.from_numpy(np.array(tree))


def _zeros_like(tree):
    if isinstance(tree, dict):
        return {k: _zeros_like(v) for k, v in tree.items()}
    return torch.zeros_like(tree)


def _flat(tree, prefix=""):
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_flat(v, f"{prefix}[{k!r}]"))
        return out
    return {prefix: tree}


def test_roundtrip_restores_values_dtypes_and_metadata(tmp_path):
    ck = Checkpointer(tmp_path / "ck")
    tree = _torch_tree(_np_tree())
    ck.save(10, tree, metadata={"config": "t"}, metric=1.0)
    restored, meta = ck.restore(None, _zeros_like(tree))
    assert meta["step"] == 10 and meta["config"] == "t" and meta["metric"] == 1.0
    for key, want in _flat(tree).items():
        got = _flat(restored)[key]
        assert got.dtype == want.dtype and got.shape == want.shape
        assert torch.equal(got, want), key


def test_restore_takes_the_dtype_and_device_of_like(tmp_path):
    ck = Checkpointer(tmp_path / "ck")
    tree = {"w": torch.randn(3, 5, generator=torch.Generator().manual_seed(0))}
    ck.save(1, tree)
    like = {"w": torch.zeros(3, 5, dtype=torch.float64)}
    restored, _ = ck.restore(1, like)
    assert restored["w"].dtype == torch.float64 and restored["w"].device.type == "cpu"
    np.testing.assert_array_equal(restored["w"].numpy(), tree["w"].double().numpy())
    with pytest.raises(ValueError, match="shape"):
        ck.restore(1, {"w": torch.zeros(5, 3)})
    with pytest.raises(ValueError, match="shardings"):
        ck.restore(1, tree, shardings={"w": None})


def test_keep_last_and_best(tmp_path):
    ck = Checkpointer(tmp_path / "ck", keep_last=2, keep_best=1)
    tree = _torch_tree(_np_tree())
    for step, metric in [(1, 5.0), (2, 1.0), (3, 2.0), (4, 0.5)]:
        ck.save(step, tree, metric=metric)
    ck.wait()
    assert ck.steps() == [1, 3, 4]  # the last two, and the best metric
    assert ck.latest_step() == 4


def test_corruption_raises_ioerror(tmp_path):
    ck = Checkpointer(tmp_path / "ck")
    tree = _torch_tree(_np_tree())
    ck.save(1, tree)
    ck.wait()
    blob = next((tmp_path / "ck").glob("step_*/shard_000.npz"))
    blob.write_bytes(blob.read_bytes()[:-4] + b"beef")
    with pytest.raises(IOError, match="corrupt"):
        ck.restore(None, tree)


def test_async_save_completes_and_restore_waits_for_it(tmp_path):
    ck = Checkpointer(tmp_path / "ck")
    tree = _torch_tree(_np_tree())
    ck.save(5, tree)
    restored, meta = ck.restore(None, _zeros_like(tree))  # waits for the write
    assert meta["step"] == 5 and ck.latest_step() == 5
    assert torch.equal(restored["params"]["w"], tree["params"]["w"])
    ck.save(6, tree)
    ck.wait()
    assert ck.steps() == [5, 6]
    assert not list((tmp_path / "ck").glob(".tmp_step_*"))


def test_save_is_a_snapshot(tmp_path):
    """What is saved is the tree at the call, whatever happens to it while
    the write is still in flight."""
    ck = Checkpointer(tmp_path / "ck")
    tree = {"w": torch.ones(64, 64)}
    ck.save(1, tree)
    tree["w"].mul_(3.0)
    restored, _ = ck.restore(1, {"w": torch.zeros(64, 64)})
    assert torch.equal(restored["w"], torch.ones(64, 64))


def test_bfloat16_leaves_come_back_bit_for_bit(tmp_path):
    g = torch.Generator().manual_seed(0)
    bits = torch.randint(-2**15, 2**15, (6, 10), dtype=torch.int32, generator=g)
    m = bits.to(torch.int16).view(torch.bfloat16)
    m = torch.where(torch.isnan(m), torch.zeros_like(m), m)
    tree = {"opt": {"m": m, "count": torch.tensor(7, dtype=torch.int32)},
            "params": {"w": torch.randn(6, 10, generator=g)}}
    ck = Checkpointer(tmp_path / "ck")
    ck.save(2, tree)
    ck.wait()
    manifest = json.loads(next((tmp_path / "ck").glob("step_*/manifest.json")).read_text())
    assert manifest["leaves"]["['opt']['m']"] == {"shape": [6, 10], "dtype": "bfloat16"}
    with np.load(next((tmp_path / "ck").glob("step_*/shard_000.npz"))) as data:
        assert data["['opt']['m']"].dtype == np.uint16  # not widened to f32
    restored, _ = ck.restore(2, _zeros_like(tree))
    got = restored["opt"]["m"]
    assert got.dtype == torch.bfloat16
    assert torch.equal(got.view(torch.int16), m.view(torch.int16))


def test_leaf_paths_are_the_reference_key_strings(tmp_path):
    tree = _np_tree()
    ck = Checkpointer(tmp_path / "port")
    ck.save(1, _torch_tree(tree))
    ck.wait()
    RefCheckpointer(str(tmp_path / "ref"), async_save=False).save(
        1, jax.tree_util.tree_map(jnp.asarray, tree))
    port = json.loads((tmp_path / "port/step_00000001/manifest.json").read_text())
    ref = json.loads((tmp_path / "ref/step_00000001/manifest.json").read_text())
    assert port["leaves"] == ref["leaves"]
    assert "['params']['blocks']['pos0']['scale']" in port["leaves"]


def test_reference_checkpoint_restores_in_the_port(tmp_path):
    tree = _np_tree(1)
    RefCheckpointer(str(tmp_path / "ck"), async_save=False).save(
        4, jax.tree_util.tree_map(jnp.asarray, tree), metadata={"config": "r"})
    restored, meta = Checkpointer(tmp_path / "ck").restore(
        None, _zeros_like(_torch_tree(tree)))
    assert meta["step"] == 4 and meta["config"] == "r"
    for key, want in _flat(tree).items():
        got = _flat(restored)[key]
        assert isinstance(got, torch.Tensor) and got.dtype == torch.from_numpy(want).dtype
        np.testing.assert_array_equal(got.numpy(), want)


def test_port_checkpoint_restores_in_the_reference(tmp_path):
    tree = _np_tree(2)
    ck = Checkpointer(tmp_path / "ck")
    ck.save(9, _torch_tree(tree), metadata={"config": "p"})
    ck.wait()
    like = jax.tree_util.tree_map(jnp.zeros_like, jax.tree_util.tree_map(jnp.asarray, tree))
    restored, meta = RefCheckpointer(str(tmp_path / "ck")).restore(None, like)
    assert meta["step"] == 9 and meta["config"] == "p"
    want = jax.tree_util.tree_leaves(tree)
    got = jax.tree_util.tree_leaves(restored)
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert np.asarray(g).dtype == w.dtype
        np.testing.assert_array_equal(np.asarray(g), w)
