"""The dry run for one card: the trace analysis (``tuning/trace_analysis.py``),
``launch/dryrun.py`` against the reference's ``lower_cell`` on a reduced
qwen2-0.5b, and ``RooflineEvaluator``.

Exact: argument bytes, in-place (alias) bytes of the cache, the toy
tracker's peak and traffic, the kernel regions' bytes, and FLOPs against
``FlopCounterMode``.  Against XLA's cost analysis FLOPs are held in a band:
the port counts matmul FLOPs only (``FlopCounterMode``'s table), XLA every
elementwise op too, so the port's count is at most XLA's and, at the
reduced config, at least 0.8 of it for train and prefill and 0.55 for
decode (one token a sequence: elementwise work is a larger share).

The reference runs in a subprocess with one host device: importing
``repro.launch.dryrun`` sets 512 host devices when ``XLA_FLAGS`` is unset,
which would change every later JAX test in the same worker.
"""
import json
import math
import os
import subprocess
import sys
import types

import pytest
import torch
from torch.utils._pytree import tree_flatten
from torch.utils.flop_counter import FlopCounterMode

from repro_torch.configs import get_config
from repro_torch.configs.base import ShapeConfig
from repro_torch.launch import dryrun
from repro_torch.runtime import trace_hooks
from repro_torch.tuning import trace_analysis as ta
from repro_torch.tuning.parameters import BASELINE

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CFG = get_config("qwen2-0.5b").reduced()


def _shape(kind, S=64, B=4):
    return ShapeConfig("t", S, B, kind)


def _bc(kind, **kw):
    return BASELINE.replace(unroll_layers=True, block_q=32,
                            microbatches=2 if kind == "train" else 1, **kw)


def _nbytes(tree):
    return sum(t.numel() * t.element_size() for t in tree_flatten(tree)[0]
               if isinstance(t, torch.Tensor))


# -- the tracker on toys ----------------------------------------------------------


def test_peak_and_traffic_of_a_toy_are_exact():
    n = 1024  # f32 elements: 4 KiB a tensor

    def step(x):
        a = x * 2          # +4K live (x, a)
        b = a + 1          # +4K (x, a, b): the peak, 12K
        del a              # a is freed
        c = b.sum()        # +4 bytes
        return b, c

    x = torch.empty(n, device="meta")
    (b, c), st = ta.trace(step, (x,))
    k = n * 4
    assert st.argument_B == k and st.output_B == k + 4 and st.alias_B == 0
    assert st.per_device_B == 3 * k
    assert st.temp_B == 3 * k - k - (k + 4)
    # mul: x in, a out; add: a in, b out; sum: b in, c out
    assert st.traffic_included == 2 * k + 2 * k + k + 4
    assert st.traffic_excluded == 0 and st.flops == 0 and st.ops == 3


def test_in_place_results_count_as_alias():
    def step(cache, x):
        cache[:, 1] = x
        return cache

    cache, x = torch.empty(4, 8, device="meta"), torch.empty(4, device="meta")
    _, st = ta.trace(step, (cache, x))
    assert st.argument_B == 4 * 8 * 4 + 16
    assert st.alias_B == st.output_B == 4 * 8 * 4
    assert st.per_device_B == st.argument_B  # nothing beyond the inputs


def test_kernel_regions_and_their_backward_are_excluded():
    n = 256
    w = torch.empty(n, device="meta", requires_grad=True)

    def step(x):
        h = x * w                                                        # outside
        y = trace_hooks.region("krnl_toy", lambda a: (a * a).exp(), h)   # inside
        loss = y.sum()                                                   # outside
        return torch.autograd.grad(loss, w)[0]

    _, st = ta.trace(step, (torch.empty(n, device="meta"),))
    k = n * 4
    # forward in the region: mul (2 in, 1 out), exp (1 in, 1 out); backward
    # in the region: exp's grad (grad * out: 2 in, 1 out) and mul's grad
    # (a*a: grad*a twice, 2 in 1 out each, then their sum: 2 in 1 out)
    assert st.excluded_by_tag == {"krnl_toy": st.traffic_excluded}
    assert st.traffic_excluded == 3 * k + 2 * k + 3 * k + 3 * k + 3 * k + 3 * k
    # the same step with the region as a plain call moves as many bytes
    def plain_step(x):
        h = x * w
        return torch.autograd.grad((h * h).exp().sum(), w)[0]

    _, plain = ta.trace(plain_step, (torch.empty(n, device="meta"),))
    assert plain.traffic_excluded == 0
    assert plain.traffic_included == st.traffic_included + st.traffic_excluded


def test_a_host_sync_raises():
    with pytest.raises(Exception):
        ta.trace(lambda x: x.sum().item(), (torch.empty(3, device="meta"),))


# -- the model's steps -------------------------------------------------------------


def _cell(kind, bc=None):
    shape = _shape(kind)
    bc = bc or _bc(kind)
    return dryrun.build_cell(CFG, shape, bc, dryrun.MetaGenerator())


@pytest.mark.parametrize("kind", ["train", "prefill", "decode"])
def test_argument_bytes_are_the_step_inputs(kind):
    step, args = _cell(kind)
    _, st = ta.trace(step, args)
    assert st.argument_B == _nbytes(args)
    if kind == "train":  # new params and optimizer state: the step is functional
        assert st.alias_B == 0 and st.output_B >= _nbytes(args[:2])
    else:  # the cache is updated in place
        assert st.alias_B == _nbytes(args[2])
    assert st.per_device_B >= st.argument_B + st.output_B - st.alias_B
    assert st.ops > 0 and st.flops > 0


@pytest.mark.parametrize("kind", ["train", "prefill", "decode"])
def test_flops_are_flop_counter_modes(kind):
    step, args = _cell(kind)
    _, st = ta.trace(step, args)
    step, args = _cell(kind)
    counter = FlopCounterMode(display=False)
    with counter:
        step(*args)
    assert st.flops == counter.get_total_flops()


@pytest.mark.parametrize("kind", ["train", "prefill"])
def test_the_kernel_regions_are_tagged(kind):
    step, args = _cell(kind)
    _, st = ta.trace(step, args)
    assert set(st.excluded_by_tag) == {"krnl_flash_attn"}
    assert st.traffic_excluded > 0 and st.traffic_included > 0


def test_a_decode_step_tags_decode_attention():
    step, args = _cell("decode")
    _, st = ta.trace(step, args)
    assert set(st.excluded_by_tag) == {"krnl_decode_attn"}


@pytest.mark.parametrize("arch,tag", [("jamba-v0.1-52b", "krnl_ssm_scan"),
                                      ("rwkv6-3b", "krnl_gla_scan")])
def test_the_scan_regions_are_tagged(arch, tag):
    cfg = get_config(arch).reduced()
    step, args = dryrun.build_cell(cfg, _shape("train", S=32, B=2),
                                   BASELINE.replace(scan_chunk=16, block_q=16),
                                   dryrun.MetaGenerator())
    _, st = ta.trace(step, args)
    assert tag in st.excluded_by_tag and st.excluded_by_tag[tag] > 0


class _NoCache(dict):
    def get(self, key, default=None):
        return None


def test_the_op_cache_and_the_microbatch_replay_change_nothing(monkeypatch):
    bc = _bc("train", remat="none").replace(microbatches=4)
    step, args = _cell("train", bc)
    _, fast = ta.trace(step, args)

    class Uncached(ta.Tracer):
        def __init__(self):
            super().__init__()
            self._cache = _NoCache()

    monkeypatch.setattr(ta, "Tracer", Uncached)
    monkeypatch.setattr(trace_hooks, "repeat", lambda fn, *a: fn(*a))
    step, args = _cell("train", bc)
    _, slow = ta.trace(step, args)
    for k in ("flops", "traffic_included", "traffic_excluded", "argument_B",
              "output_B", "alias_B", "ops"):
        assert getattr(fast, k) == getattr(slow, k), k
    assert fast.per_device_B == slow.per_device_B


@pytest.mark.parametrize("microbatches", [1, 4])
def test_trace_cost_traces_with_and_without_the_replay(microbatches):
    from repro_torch.benchmarks import trace_cost

    bc = _bc("train", remat="dots").replace(microbatches=microbatches)
    replayed = trace_cost.trace(CFG, _shape("train"), bc, replay=True)
    repeat = trace_hooks.repeat
    cache_only = trace_cost.trace(CFG, _shape("train"), bc, replay=False)
    assert trace_hooks.repeat is repeat  # put back
    for k in trace_cost.FIELDS:
        assert getattr(replayed, k) == getattr(cache_only, k), k


def test_traces_in_threads_do_not_mix():
    import threading

    step, args = _cell("prefill")
    _, alone = ta.trace(step, args)
    out = {}

    def run(i):
        s, a = _cell("prefill")
        out[i] = ta.trace(s, a)[1]

    threads = [threading.Thread(target=run, args=(i,)) for i in range(3)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    for st in out.values():
        assert (st.flops, st.traffic_included, st.traffic_excluded, st.per_device_B) == \
            (alone.flops, alone.traffic_included, alone.traffic_excluded, alone.per_device_B)


# -- against the reference's lower_cell -----------------------------------------------

_REF = """
import json, sys
import jax, numpy as np
from repro.configs import get_config
from repro.configs.base import ShapeConfig
from repro.launch.dryrun import lower_cell
from repro.tuning.hlo_analysis import cost_with_scan_correction
from repro.tuning.parameters import BASELINE
cfg = get_config("qwen2-0.5b").reduced()
# a 1x1 mesh with automatic axes (what the reference's make_mesh built
# before jax made explicit axes its default)
mesh = jax.sharding.Mesh(np.array(jax.devices()[:1]).reshape(1, 1), ("data", "model"))
out = {}
for kind in ("train", "prefill", "decode"):
    bc = BASELINE.replace(unroll_layers=True, block_q=32,
                          microbatches=2 if kind == "train" else 1)
    compiled = lower_cell(cfg, ShapeConfig("t", 64, 4, kind), mesh, bc).compile()
    mem = compiled.memory_analysis()
    out[kind] = {"argument_B": mem.argument_size_in_bytes, "alias_B": mem.alias_size_in_bytes,
                 "flops": cost_with_scan_correction(compiled)["flops"]}
print(json.dumps(out))
"""

FLOPS_BAND = {"train": 0.8, "prefill": 0.8, "decode": 0.55}


@pytest.fixture(scope="module")
def reference_cells():
    env = dict(os.environ, XLA_FLAGS="--xla_force_host_platform_device_count=1",
               JAX_PLATFORMS="cpu", PYTHONPATH=os.path.join(ROOT, "src"))
    out = subprocess.run([sys.executable, "-c", _REF], env=env, capture_output=True,
                         text=True, timeout=600, cwd=ROOT)
    assert out.returncode == 0, out.stderr[-3000:]
    return json.loads(out.stdout.strip().splitlines()[-1])


@pytest.mark.parametrize("kind", ["train", "prefill", "decode"])
def test_dry_run_of_a_reduced_qwen_against_the_reference(kind, reference_cells):
    ref = reference_cells[kind]
    rec = dryrun.analyze(CFG, _shape(kind), _bc(kind))
    mem = rec["memory"]
    # the reference's decode cache holds its position as an int32 array; the
    # port's is a host integer
    pos_B = 4 if kind == "decode" else 0
    assert mem["argument_B"] + pos_B == ref["argument_B"]
    if kind != "train":  # the reference's train step donates params and state
        assert mem["alias_B"] + pos_B == ref["alias_B"]
    flops = rec["cost"]["flops_per_device"]
    assert FLOPS_BAND[kind] * ref["flops"] <= flops <= ref["flops"]


def test_the_record_has_the_reference_keys():
    rec = dryrun.analyze(CFG, _shape("prefill"), _bc("prefill"))
    for k in ("arch", "shape", "multi_pod", "skipped", "chips", "mesh", "backend", "memory",
              "cost", "collectives", "roofline", "params", "compile_seconds"):
        assert k in rec
    for k in ("argument_B", "temp_B", "output_B", "alias_B", "per_device_B"):
        assert k in rec["memory"]
    for k in ("flops_per_device", "bytes_hlo_raw", "bytes_traffic_included",
              "bytes_traffic_kernel_excluded", "bytes_kernel_credit", "bytes_traffic_adjusted",
              "bytes_analytic", "bytes_adjusted", "scan_body_flops_once", "n_periods"):
        assert k in rec["cost"]
    # one card: no collectives, a 1x1 mesh
    assert rec["collectives"]["bytes_by_kind"] == {} and rec["roofline"]["collectives"] == "none"
    assert rec["mesh"] == {"data": 1, "model": 1} and rec["chips"] == 1
    m = rec["memory"]
    assert m["per_device_B"] == m["argument_B"] + m["temp_B"] + m["output_B"] - m["alias_B"]


def test_analyze_cell_on_a_full_config_skips_and_refuses_more_chips():
    """(Named for what it held before the port reached more than one card.)
    A cell the shape does not apply to is skipped at any mesh; more chips
    and two pods are the reference's meshes now (their traces are in
    ``test_torch_multichip_dryrun.py``)."""
    rec = dryrun.analyze_cell("qwen2-0.5b", "long_500k")
    assert rec["skipped"] and "quadratic" in rec["skip_reason"]
    for kw in ({"chips_per_pod": 256}, {"chips_per_pod": 256, "multi_pod": True}):
        rec = dryrun.analyze_cell("qwen2-0.5b", "long_500k", **kw)
        assert rec["skipped"] and rec["multi_pod"] == kw.get("multi_pod", False)
    bc = BASELINE.replace(log2_dp=3)
    assert dryrun.build_cell_mesh(bc, chips_per_pod=256).shape == {"data": 8, "model": 32}
    assert dryrun.build_cell_mesh(bc, multi_pod=True, chips_per_pod=256).shape == \
        {"pod": 2, "data": 8, "model": 32}
    assert dryrun.build_cell_mesh(bc).shape == {"data": 1, "model": 1}  # one card


def test_fast_analysis_extrapolates_the_depth():
    cfg = get_config("qwen2-0.5b").reduced()
    cfg4 = type(cfg)(**{**cfg.__dict__, "num_layers": 4})
    full = dryrun.analyze(cfg4, _shape("prefill"), _bc("prefill"))
    fast = dryrun.analyze(cfg4, _shape("prefill"), _bc("prefill"), fast=True)
    assert fast["cost"]["analysis"] == "fast" and full["cost"]["analysis"] == "full"
    # every layer adds the same: the extrapolation is exact for FLOPs and
    # argument bytes
    assert fast["cost"]["flops_per_device"] == full["cost"]["flops_per_device"]
    assert fast["memory"]["argument_B"] == full["memory"]["argument_B"]


def test_the_cli_runs_without_cuda(tmp_path):
    out_json = tmp_path / "rec.json"
    code = ("import sys, torch; from repro_torch.launch import dryrun; "
            "dryrun.main(sys.argv[1:]); "
            "assert not torch.cuda.is_initialized(); print('cuda untouched')")
    out = subprocess.run(
        [sys.executable, "-c", code, "--arch", "whisper-base", "--shape", "decode_32k",
         "--out", str(out_json)],
        env=dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src")),
        capture_output=True, text=True, timeout=600, cwd=ROOT)
    assert out.returncode == 0, out.stderr[-3000:]
    assert "OK mem/dev" in out.stdout and "cuda untouched" in out.stdout
    rec = json.loads(out_json.read_text())[0]
    assert rec["arch"] == "whisper-base" and rec["roofline"]["bottleneck"] == "memory"


# -- RooflineEvaluator ---------------------------------------------------------------


def _stub_dryrun(monkeypatch, fn):
    stub = types.ModuleType("repro_torch.launch.dryrun")
    stub.analyze_cell = fn
    monkeypatch.setitem(sys.modules, "repro_torch.launch.dryrun", stub)


def test_roofline_reconsults_store_before_tracing(tmp_path, monkeypatch):
    from repro_torch.tuning.cache import JsonCacheStore
    from repro_torch.tuning.evaluator import RooflineEvaluator, provenance
    from repro_torch.tuning.parameters import config_from_point

    def _no_trace(*a, **k):
        raise AssertionError("traced despite a store entry")

    _stub_dryrun(monkeypatch, _no_trace)
    cache = str(tmp_path / "roofline.json")
    ev = RooflineEvaluator("qwen2-0.5b", "train_4k", cache_path=cache)
    assert ev._cache == {}
    point = {"block_q": 256}
    # an entry of this torch and pod size (one written by another is traced
    # again: tests/test_torch_train_families.py)
    rec = {"skipped": False, "memory": {"per_device_B": 1.0},
           "roofline": {"throughput_tok_s": 123.0}, **provenance(1)}
    JsonCacheStore(cache).put(ev._key(config_from_point(point)), rec)
    value, meta = ev(point)
    assert value == 123.0 and len(ev._cache) == 1


def test_roofline_keys_are_the_reference_keys(tmp_path):
    from repro.tuning.evaluator import RooflineEvaluator as RefEvaluator
    from repro.tuning.parameters import config_from_point as ref_point
    from repro_torch.tuning.evaluator import RooflineEvaluator
    from repro_torch.tuning.parameters import config_from_point

    ours = RooflineEvaluator("qwen2-0.5b", "decode_32k")
    ref = RefEvaluator("qwen2-0.5b", "decode_32k")
    for point in ({}, {"block_q": 256, "remat": "dots"}, {"microbatches": 4}):
        for fast in (False, True):
            assert ours._key(config_from_point(point), fast=fast) == \
                ref._key(ref_point(point), fast=fast)
    full, fast = ours._key(BASELINE), ours._key(BASELINE, fast=True)
    assert full != fast and json.loads(full).get("analysis") is None
    assert json.loads(fast)["analysis"] == "fast"


def test_roofline_skip_oom_and_fidelity(tmp_path, monkeypatch):
    from repro_torch.tuning.evaluator import RooflineEvaluator

    calls = []

    def analyze_cell(arch, shape, *, multi_pod, bc, chips_per_pod, fast):
        calls.append((arch, shape, bc.block_q, chips_per_pod, fast))
        if arch == "qwen2-0.5b" and shape == "long_500k":
            return {"skipped": True, "skip_reason": "quadratic"}
        return {"skipped": False, "memory": {"per_device_B": 1e9 * bc.block_q / 128},
                "roofline": {"throughput_tok_s": float(bc.block_q)}}

    _stub_dryrun(monkeypatch, analyze_cell)
    ev = RooflineEvaluator("qwen2-0.5b", "long_500k")
    value, meta = ev({})
    assert value == -math.inf and meta == {"skip_reason": "quadratic"}
    ev = RooflineEvaluator("qwen2-0.5b", "train_4k", cache_path=str(tmp_path / "c.json"))
    assert ev({"block_q": 256}) == (256.0, {"roofline": {"throughput_tok_s": 256.0},
                                            "mem_per_device_B": 2e9})
    value, meta = ev({"block_q": 1024 * 12})  # 96 GB > 80 GB
    assert value == -math.inf and meta["oom"] is True
    value, meta = ev({"block_q": 256}, fidelity=1 / 3)
    assert value == 256.0 and meta["fidelity"] == 1 / 3
    assert ev({"block_q": 256}, fidelity=1.0) == ev({"block_q": 256})
    assert [c[-1] for c in calls] == [False, False, False, True]
    assert {c[3] for c in calls} == {1}  # one card
