"""The compiled decode step (``serve/serve_step.py``) on the CPU, where no
CUDA graph can be captured: it refuses CPU tensors with no eager
fallback; its binding refuses another cache, shape or parameter set and
bounds the position on the host; the launch-counter bookkeeping of a
captured region runs against a stand-in graph; and ``launch/serve.py
--device cpu`` allocates its cache once, zeroes it every wave and answers
as a fresh cache does.  Bit-for-bit equality of the graphed and the eager
step is checked on the card (``chip_smoke.py``, phase ``graphs``).
"""
import contextlib

import numpy as np
import pytest
import torch

from repro_torch.configs import get_config
from repro_torch.launch import serve as serve_cli
from repro_torch.models import build_model
from repro_torch.models.model import Model
from repro_torch.models.params import split_params, tree_leaves, tree_map
from repro_torch.models.runtime import Runtime
from repro_torch.serve import serve_step as SS

B, CACHE_LEN = 2, 12


def _model(arch):
    cfg = get_config(arch).reduced()
    model = build_model(cfg)
    params, _ = split_params(model.init(torch.Generator().manual_seed(0)))
    return model, params


def _cache(model, batch=B, cache_len=CACHE_LEN):
    return split_params(model.init_cache(batch, cache_len))[0]


def test_graphed_step_refuses_cpu_tensors_without_falling_back(monkeypatch):
    model, params = _model("qwen2-0.5b")
    cache = _cache(model)
    cache["pos"] = 3
    before = [t.clone() for t in tree_leaves(cache["layers"])]
    monkeypatch.setattr(Model, "decode_step",
                        lambda *a, **kw: pytest.fail("fell back to the eager step"))
    step = SS.make_graphed_decode_step(model, Runtime(compute_dtype="f32"))
    with pytest.raises(RuntimeError, match="on the card"):
        step(params, torch.zeros((B, 1), dtype=torch.int32), cache)
    assert cache["pos"] == 3 and step.binding is None and step.graph is None
    assert all(torch.equal(a, b) for a, b in zip(before, tree_leaves(cache["layers"])))
    with pytest.raises(TypeError):
        step(params, torch.zeros((B, 1), dtype=torch.int32), dict(cache, pos=torch.tensor(3)))


def test_binding_refuses_another_cache_shape_or_parameter_set():
    model, params = _model("qwen2-0.5b")
    tokens = torch.zeros((B, 1), dtype=torch.int32)
    cache = _cache(model)
    bound = SS.DecodeBinding(model, params, tokens, cache)
    bound.check(params, tokens, cache)
    bound.check(params, tokens.clone(), dict(cache, pos=5))  # new tokens, same storage
    with pytest.raises(ValueError, match="another cache"):
        bound.check(params, tokens, _cache(model))
    with pytest.raises(ValueError, match="shapes"):
        bound.check(params, tokens, _cache(model, cache_len=CACHE_LEN + 1))
    with pytest.raises(ValueError, match="shapes"):
        bound.check(params, torch.zeros((B + 1, 1), dtype=torch.int32), _cache(model, B + 1))
    with pytest.raises(ValueError, match="parameter set"):
        bound.check(tree_map(lambda t: t.clone(), params), tokens, cache)


@pytest.mark.parametrize("arch,limit", [
    ("qwen2-0.5b", CACHE_LEN), ("minicpm3-4b", CACHE_LEN), ("whisper-base", CACHE_LEN),
    ("h2o-danube-1.8b", None),  # a ring of 8 slots: no end
    ("rwkv6-3b", None), ("jamba-v0.1-52b", CACHE_LEN)])
def test_binding_bounds_the_position_on_the_host(arch, limit):
    model, params = _model(arch)
    cache = _cache(model)
    bound = SS.DecodeBinding(model, params, torch.zeros((B, 1), dtype=torch.int32), cache)
    assert bound.limit == limit == model.decode_limit(cache)
    bound.check_position(0)
    with pytest.raises(IndexError):
        bound.check_position(-1)
    if limit is None:
        bound.check_position(10 * CACHE_LEN)
    else:
        bound.check_position(limit - 1)
        with pytest.raises(IndexError, match=f"position {limit} "):
            bound.check_position(limit)


class _Counter:
    def __init__(self, n):
        self.launches = n


class _StandInGraph:
    """Captures by running nothing on a device; a replay runs no Python
    that a counter would see."""

    def __init__(self):
        self.captures = self.replays = 0

    @contextlib.contextmanager
    def capture(self):
        self.captures += 1
        yield

    def replay(self):
        self.replays += 1


def test_counted_graph_restores_the_capture_and_adds_each_replay():
    counters = [_Counter(5), _Counter(0), _Counter(7)]
    graph = SS.CountedGraph(_StandInGraph(), counters)
    with pytest.raises(RuntimeError):
        graph.replay()

    def region():  # what the wrappers do while captured: count
        counters[0].launches += 2
        counters[2].launches += 3
        return "logits"

    assert graph.capture(region) == "logits"
    assert [c.launches for c in counters] == [5, 0, 7]  # the capture launched nothing
    assert graph.increase == [2, 0, 3]
    for _ in range(4):
        graph.replay()
    assert [c.launches for c in counters] == [13, 0, 19] and graph.graph.replays == 4


def test_counted_graph_restores_the_counters_when_the_capture_fails():
    counters = [_Counter(1)]
    graph = SS.CountedGraph(_StandInGraph(), counters)

    def region():
        counters[0].launches += 9
        raise RuntimeError("operation not permitted when stream is capturing")

    with pytest.raises(RuntimeError, match="capturing"):
        graph.capture(region)
    assert counters[0].launches == 1 and graph.increase is None
    with pytest.raises(RuntimeError):
        graph.replay()


def test_kernel_counters_are_the_five_wrappers():
    names = [fn.__name__ for fn in SS.kernel_counters()]
    assert names == ["rmsnorm", "flash_attention", "decode_attention", "ssm_scan", "gla_scan"]
    assert all(isinstance(fn.launches, int) for fn in SS.kernel_counters())


def test_reset_cache_gives_a_fresh_cache_in_place():
    model, params = _model("jamba-v0.1-52b")
    cache = _cache(model)
    ptrs = [t.data_ptr() for t in tree_leaves(cache["layers"])]
    toks = torch.from_numpy(np.random.default_rng(0).integers(0, 200, (B, 6)).astype(np.int32))
    _, cache = SS.make_prefill_step(model, Runtime(compute_dtype="f32"))(
        params, {"tokens": toks}, cache)
    assert cache["pos"] == 6 and any(t.any() for t in tree_leaves(cache["layers"]))
    cache = SS.reset_cache(cache)
    assert cache["pos"] == 0
    assert [t.data_ptr() for t in tree_leaves(cache["layers"])] == ptrs
    for a, b in zip(tree_leaves(cache["layers"]), tree_leaves(_cache(model)["layers"])):
        assert a.dtype == b.dtype and torch.equal(a, b)


@pytest.mark.parametrize("arch", ["qwen2-0.5b", "rwkv6-3b"])
def test_serve_cpu_reuses_one_cache_and_answers_as_a_fresh_cache(arch, monkeypatch, capsys):
    """Three waves (the last one short): one cache allocation, one reset a
    wave, and every request's tokens those of a prefill + eager decode on
    a fresh cache."""
    requests, batch, prompt_len, gen_len = 5, 2, 8, 4
    allocs, resets = [], []
    init_cache, reset = Model.init_cache, SS.reset_cache
    monkeypatch.setattr(Model, "init_cache",
                        lambda self, *a, **kw: allocs.append(a) or init_cache(self, *a, **kw))
    monkeypatch.setattr(serve_cli, "reset_cache", lambda c: resets.append(1) or reset(c))
    done = serve_cli.main(["--device", "cpu", "--arch", arch, "--requests", str(requests),
                           "--batch", str(batch), "--prompt-len", str(prompt_len),
                           "--gen-len", str(gen_len)])
    assert f"[serve] {requests} requests" in capsys.readouterr().out
    assert len(allocs) == 1 and len(resets) == 3

    # the same weights and prompts, each wave on a fresh cache
    cfg = get_config(arch).reduced()
    model = build_model(cfg)
    rt = serve_cli.runtime(False, "f32")
    params, _ = split_params(model.init(torch.Generator().manual_seed(0), dtype=rt.dtype()))
    rng = np.random.default_rng(0)
    prompts = [rng.integers(0, cfg.vocab_size, size=rng.integers(prompt_len // 2, prompt_len + 1))
               for _ in range(requests)]
    got = dict(done)
    assert sorted(got) == list(range(requests))
    for w in range(0, requests, batch):
        toks = np.zeros((batch, prompt_len), np.int32)
        for i, p in enumerate(prompts[w: w + batch]):
            toks[i, prompt_len - len(p):] = p
        want, _ = SS.generate(model, params, {"tokens": torch.from_numpy(toks)}, rt=rt,
                              cache=_cache(model, batch, prompt_len + gen_len), steps=gen_len)
        for i in range(len(prompts[w: w + batch])):
            np.testing.assert_array_equal(got[w + i], want[i].numpy())
