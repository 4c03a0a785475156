"""The dry run on more than one device: DTensors over a fake process group
(``launch/mesh.py``), placed under ``ShardingRules`` and traced by
``tuning/trace_analysis.py`` at their local shapes.

* A two-layer MLP, column- then row-parallel at tp=4 on a fake 1x4 mesh:
  exactly one all-reduce forward, of B*S*D*4 bytes, and a quarter of the
  global FLOPs.  Exact.
* Reduced qwen2-0.5b and qwen3-moe-30b-a3b, train / prefill / decode on
  a 2x2 mesh, against the reference's ``lower_cell(...).compile()`` on 4
  placeholder CPU devices (a module-scoped subprocess):
  - per-device ``argument_B`` exact (the decode cache's position is an
    int32 array there, a host integer here);
  - per-device FLOPs: at most XLA's cost-analysis count (``FLOPS_BAND``'s
    upper bound), and within ``DOT_BAND`` of the FLOPs of XLA's ``dot``
    instructions, which the test sums from the compiled HLO.  The port
    counts matrix products only; on one device elementwise work is a small
    share of XLA's count, hence ``FLOPS_BAND``'s floor, but XLA's
    elementwise work does not split four ways (at 2x2 its decode count is
    0.49 of its one-device count where its dot count is 0.25), so the
    floor does not carry to a mesh and the like-for-like count is held;
  - collective kinds and bytes of both, side by side (printed with ``-s``);
    every kind the reference shows is non-empty in the port, itself or as
    the kind DTensor expresses it in (``DTENSOR_FORM``).
* The one-card analysis of a reduced cell is what it was before the port
  placed anything on a mesh, field for field, and builds no process group.
* The CLI at a 256-chip pod and across two pods runs without CUDA.
"""
import json
import math
import os
import subprocess
import sys

import pytest
import torch

from repro_torch.configs import get_config
from repro_torch.configs.base import ShapeConfig
from repro_torch.distributed.sharding import ShardingRules, active_rules, shard_hint
from repro_torch.launch import dryrun
from repro_torch.launch.mesh import Mesh, device_mesh
from repro_torch.tuning import trace_analysis as ta
from repro_torch.tuning.parameters import BASELINE

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ARCHS = ("qwen2-0.5b", "qwen3-moe-30b-a3b")
KINDS = ("train", "prefill", "decode")
MESH = Mesh(("data", "model"), (2, 2))
FLOPS_BAND = {"train": 0.8, "prefill": 0.8, "decode": 0.55}  # test_torch_dryrun.py's
DOT_BAND = (0.95, 1.05)
#: a kind XLA's partitioner uses that DTensor expresses in another: the
#: fake (CPU) process group has no all-to-all, so DTensor all-gathers and
#: keeps its chunk; XLA's collective-permutes here move a gathered index
#: (the embedding lookup, the cache's update slice), which DTensor does as
#: a masked partial sum, reduced by an all-reduce
DTENSOR_FORM = {"all-to-all": "all-gather", "collective-permute": "all-reduce"}
#: the cells the reference compiles: every (arch, kind) under the baseline's
#: GSPMD MoE, and qwen3-moe's train step again under shard_map expert
#: parallelism (``ep_local``), whose collective cut both packages must show
CELLS = [(a, k, "gspmd") for a in ARCHS for k in KINDS] + [("qwen3-moe-30b-a3b", "train",
                                                           "ep_local")]
#: how far below the reference's ep_local / gspmd ratio of weighted collective
#: bytes the port's may fall: the two express collectives in different kinds
#: (``DTENSOR_FORM``), so the bytes agree only in order of magnitude
EP_RATIO_FACTOR = 2.0


def _shape(kind):
    return ShapeConfig("t", 64, 4, kind)


def _bc(kind, moe_impl="gspmd"):
    return BASELINE.replace(unroll_layers=True, block_q=32,
                            microbatches=2 if kind == "train" else 1, moe_impl=moe_impl)


# -- a toy ------------------------------------------------------------------------------


def test_a_tensor_parallel_mlp_shows_one_all_reduce_and_a_quarter_of_the_flops():
    mesh = Mesh(("data", "model"), (1, 4))
    rules = ShardingRules(mesh, "tp", device_mesh=device_mesh(mesh))
    B, S, D, F = 2, 8, 32, 64
    x = rules.place(torch.empty(B, S, D, device="meta"), ("batch", None, None))
    w1 = rules.place(torch.empty(D, F, device="meta"), ("embed", "ff"))
    w2 = rules.place(torch.empty(F, D, device="meta"), ("ff", "embed"))
    assert tuple(w1.to_local().shape) == (D, F // 4) and tuple(w2.to_local().shape) == (F // 4, D)

    def mlp(x, w1, w2):
        with active_rules(rules):
            h = shard_hint(torch.relu(x @ w1), ("batch", None, "ff"))  # column-parallel
            return shard_hint(h @ w2, ("batch", None, None))           # row-parallel

    out, st = ta.trace(mlp, (x, w1, w2))
    assert tuple(out.shape) == (B, S, D) and tuple(out.to_local().shape) == (B, S, D)
    assert dict(st.collectives.count_by_kind) == {"all-reduce": 1}
    assert dict(st.collectives.bytes_by_kind) == {"all-reduce": B * S * D * 4}
    assert st.flops == 2 * (2 * B * S * D * F) // 4


# -- against the reference on 4 placeholder devices ---------------------------------------

_REF = """
import json, math, re
import jax, numpy as np
from repro.configs import get_config
from repro.configs.base import ShapeConfig
from repro.launch.dryrun import lower_cell
from repro.tuning.cost_model import weighted_collective_bytes
from repro.tuning.hlo_analysis import collect_collective_stats, cost_with_scan_correction
from repro.tuning.parameters import BASELINE

_DEF = re.compile(r"^\\s*(?:ROOT\\s+)?%?([\\w.\\-]+)\\s*=\\s*\\w+\\[([\\d,]*)\\]")
_DOT = re.compile(r"=\\s*\\w+\\[([\\d,]*)\\][^=]*?\\bdot\\(%?([\\w.\\-]+),\\s*%?([\\w.\\-]+)\\)"
                  r".*?lhs_contracting_dims=\\{([\\d,]*)\\}")

def dims(text):
    return [int(d) for d in text.split(",") if d]

def dot_flops(hlo):
    shapes = {m.group(1): dims(m.group(2)) for m in map(_DEF.match, hlo.splitlines()) if m}
    total = 0
    for line in hlo.splitlines():
        m = _DOT.search(line)
        if m:
            lhs = shapes[m.group(2)]
            total += 2 * math.prod(dims(m.group(1))) * math.prod(lhs[i] for i in dims(m.group(4)))
    return total

# a 2x2 mesh with automatic axes (what the reference's make_mesh built before
# jax made explicit axes its default)
mesh = jax.sharding.Mesh(np.array(jax.devices()[:4]).reshape(2, 2), ("data", "model"))
out = {}
for arch, kind, moe_impl in CELLS:
    bc = BASELINE.replace(unroll_layers=True, block_q=32,
                          microbatches=2 if kind == "train" else 1, moe_impl=moe_impl)
    compiled = lower_cell(get_config(arch).reduced(), ShapeConfig("t", 64, 4, kind), mesh,
                          bc).compile()
    mem, hlo = compiled.memory_analysis(), compiled.as_text()
    coll = collect_collective_stats(hlo)
    out["/".join([arch, kind] + ([] if moe_impl == "gspmd" else [moe_impl]))] = {
        "argument_B": mem.argument_size_in_bytes,
        "flops": cost_with_scan_correction(compiled)["flops"],
        "dot_flops": dot_flops(hlo),
        "bytes_by_kind": dict(coll.bytes_by_kind),
        "count_by_kind": dict(coll.count_by_kind),
        "weighted_bytes": weighted_collective_bytes(coll.bytes_by_kind)}
print(json.dumps(out))
""".replace("CELLS:", repr(CELLS) + ":")


@pytest.fixture(scope="module")
def reference():
    env = dict(os.environ, XLA_FLAGS="--xla_force_host_platform_device_count=4",
               JAX_PLATFORMS="cpu", PYTHONPATH=os.path.join(ROOT, "src"))
    out = subprocess.run([sys.executable, "-c", _REF], env=env, capture_output=True,
                         text=True, timeout=600, cwd=ROOT)
    assert out.returncode == 0, out.stderr[-3000:]
    return json.loads(out.stdout.strip().splitlines()[-1])


_PORT = {}


def _port(arch, kind, moe_impl="gspmd"):
    key = (arch, kind, moe_impl)
    if key not in _PORT:
        _PORT[key] = dryrun.analyze(get_config(arch).reduced(), _shape(kind),
                                    _bc(kind, moe_impl), MESH)
    return _PORT[key]


@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("arch", ARCHS)
def test_argument_bytes_a_device_equal_the_reference(arch, kind, reference):
    rec = _port(arch, kind)
    assert rec["mesh"] == {"data": 2, "model": 2} and rec["chips"] == 4
    pos_B = 4 if kind == "decode" else 0  # the reference's int32 position
    assert rec["memory"]["argument_B"] + pos_B == reference[f"{arch}/{kind}"]["argument_B"]


@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("arch", ARCHS)
def test_flops_a_device_against_the_reference(arch, kind, reference):
    ref = reference[f"{arch}/{kind}"]
    flops = _port(arch, kind)["cost"]["flops_per_device"]
    assert flops <= ref["flops"]
    assert DOT_BAND[0] * ref["dot_flops"] <= flops <= DOT_BAND[1] * ref["dot_flops"]
    print(f"\n{arch}/{kind}: port {flops:.0f}, XLA dots {ref['dot_flops']:.0f} "
          f"({flops / ref['dot_flops']:.4f}), XLA all {ref['flops']:.0f} "
          f"({flops / ref['flops']:.4f}; FLOPS_BAND floor {FLOPS_BAND[kind]})")


@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("arch", ARCHS)
def test_collective_kinds_of_the_reference_show_in_the_port(arch, kind, reference):
    ref = reference[f"{arch}/{kind}"]
    ours = _port(arch, kind)["collectives"]
    print(f"\n{arch}/{kind}")
    for k in sorted(set(ref["bytes_by_kind"]) | set(ours["bytes_by_kind"])):
        print(f"  {k:20s} XLA {ref['count_by_kind'].get(k, 0):4d}x "
              f"{ref['bytes_by_kind'].get(k, 0):9d} B   port "
              f"{ours['count_by_kind'].get(k, 0):4d}x {ours['bytes_by_kind'].get(k, 0):9d} B")
    for k in ref["bytes_by_kind"]:
        assert ours["bytes_by_kind"].get(DTENSOR_FORM.get(k, k), 0) > 0, k
    assert _port(arch, kind)["roofline"]["collective_s"] > 0


def test_ep_local_cuts_collective_bytes_in_the_port_as_in_the_reference(reference):
    """qwen3-moe's reduced train step: the ratio gspmd / ep_local of weighted
    collective bytes a device, in each package (printed with ``-s``).  Both
    cut, and the port's cut is within ``EP_RATIO_FACTOR`` of the reference's."""
    arch = "qwen3-moe-30b-a3b"
    ref = reference[f"{arch}/train"]["weighted_bytes"] / \
        reference[f"{arch}/train/ep_local"]["weighted_bytes"]
    port = _port(arch, "train")["collectives"]["weighted_bytes"] / \
        _port(arch, "train", "ep_local")["collectives"]["weighted_bytes"]
    print(f"\n{arch}/train gspmd / ep_local weighted collective bytes: "
          f"reference {ref:.4f}, port {port:.4f} (reference / port {ref / port:.4f})")
    assert ref > 1 and port > 1
    assert port * EP_RATIO_FACTOR >= ref


# -- the trace's shortcuts on a mesh -------------------------------------------------------


def _placed_cell(kind, bc, B):
    rules = dryrun._rules(MESH, bc)
    step, args = dryrun.build_cell(get_config("qwen2-0.5b").reduced(),
                                   ShapeConfig("t", 64, B, kind), bc,
                                   dryrun.MetaGenerator(), rules=rules)
    return rules, step, args


def _trace_placed(kind, bc, B=4):
    from torch.distributed.tensor.experimental import implicit_replication

    rules, step, args = _placed_cell(kind, bc, B)
    with active_rules(rules), implicit_replication():
        return ta.trace(step, args)[1]


class _NoCache(dict):
    def get(self, key, default=None):
        return None


_FIELDS = ("flops", "traffic_included", "traffic_excluded", "argument_B", "output_B",
           "alias_B", "ops", "per_device_B")


def test_the_op_cache_and_the_microbatch_replay_change_nothing_on_a_mesh(monkeypatch):
    from repro_torch.runtime import trace_hooks

    bc = _bc("train").replace(remat="none", microbatches=4)
    fast = _trace_placed("train", bc, B=8)  # 4 sequences a device, one a microbatch

    class Uncached(ta.Tracer):
        def __init__(self):
            super().__init__()
            self._cache = _NoCache()

    monkeypatch.setattr(ta, "Tracer", Uncached)
    monkeypatch.setattr(trace_hooks, "repeat", lambda fn, *a: fn(*a))
    slow = _trace_placed("train", bc, B=8)
    for k in _FIELDS:
        assert getattr(fast, k) == getattr(slow, k), k
    assert dict(fast.collectives.bytes_by_kind) == dict(slow.collectives.bytes_by_kind)
    assert dict(fast.collectives.count_by_kind) == dict(slow.collectives.count_by_kind)


def test_traces_in_threads_do_not_mix_on_a_mesh():
    import threading

    alone = _trace_placed("prefill", _bc("prefill"))
    out = {}

    def run(i):
        out[i] = _trace_placed("prefill", _bc("prefill"))

    threads = [threading.Thread(target=run, args=(i,)) for i in range(3)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    for st in out.values():
        assert [getattr(st, k) for k in _FIELDS] == [getattr(alone, k) for k in _FIELDS]
        assert dict(st.collectives.bytes_by_kind) == dict(alone.collectives.bytes_by_kind)


# -- one card: as before, and no process group ---------------------------------------------

#: the one-card analyses of the reduced qwen2-0.5b before the port placed
#: anything on a mesh (the record's memory, cost and roofline terms), but
#: for the prefill's ring-buffer fill: a cache the prompt fills exactly is
#: now written as a slice, with no slot index built (4 ops and 5,120 raw
#: bytes fewer; its memory, adjusted bytes and roofline as before); and
#: for the dense forward's aux loss, now written on the device by a fill
#: where it was a host copy, which a CUDA graph cannot capture (one op and
#: 4 raw bytes a forward: two in the train step's two microbatches)
ONE_CARD = json.loads("""
{"train": {"memory": {"argument_B": 1090308, "temp_B": 1053220, "output_B": 1088288, "alias_B": 0, "per_device_B": 3231816.0}, "cost": {"flops_per_device": 201326592.0, "bytes_hlo_raw": 109217480.0, "bytes_traffic_included": 60955720.0, "bytes_traffic_kernel_excluded": 48261760.0, "bytes_kernel_credit": 1048576.0, "bytes_traffic_adjusted": 62004296.0, "bytes_adjusted": 9949440.0, "scan_body_flops_once": 201326592.0, "n_periods": 2, "ops": 3937, "analysis": "full"}, "roofline": {"compute_s": 2.0356581597573307e-07, "memory_s": 2.969982089552239e-06, "collective_s": 0.0, "est_step_s": 2.969982089552239e-06, "bottleneck": "memory"}},
 "prefill": {"memory": {"argument_B": 429312, "temp_B": 781056, "output_B": 67584, "alias_B": 65536, "per_device_B": 1212416.0}, "cost": {"flops_per_device": 46268416.0, "bytes_hlo_raw": 22122228.0, "bytes_traffic_included": 9388692.0, "bytes_traffic_kernel_excluded": 12733536.0, "bytes_kernel_credit": 262144.0, "bytes_traffic_adjusted": 9650836.0, "bytes_adjusted": 1747200.0, "scan_body_flops_once": 46268416.0, "n_periods": 2, "ops": 511, "analysis": "full"}, "roofline": {"compute_s": 4.678302932254803e-08, "memory_s": 5.215522388059701e-07, "collective_s": 0.0, "est_step_s": 5.215522388059701e-07, "bottleneck": "memory"}},
 "decode": {"memory": {"argument_B": 428304, "temp_B": 100112, "output_B": 67584, "alias_B": 65536, "per_device_B": 530464.0}, "cost": {"flops_per_device": 851968.0, "bytes_hlo_raw": 1685072.0, "bytes_traffic_included": 944320.0, "bytes_traffic_kernel_excluded": 740752.0, "bytes_kernel_credit": 67584.0, "bytes_traffic_adjusted": 1011904.0, "bytes_adjusted": 455936.0, "scan_body_flops_once": 851968.0, "n_periods": 2, "ops": 373, "analysis": "full"}, "roofline": {"compute_s": 8.614438827098079e-10, "memory_s": 1.3610029850746268e-07, "collective_s": 0.0, "est_step_s": 1.3610029850746268e-07, "bottleneck": "memory"}}}
""")

_ONE_CARD = """
import json, sys
import torch.distributed as dist
from repro_torch.configs import get_config
from repro_torch.configs.base import ShapeConfig
from repro_torch.launch import dryrun
from repro_torch.tuning.parameters import BASELINE
kind = sys.argv[1]
bc = BASELINE.replace(unroll_layers=True, block_q=32, microbatches=2 if kind == "train" else 1)
rec = dryrun.analyze(get_config("qwen2-0.5b").reduced(), ShapeConfig("t", 64, 4, kind), bc)
assert not dist.is_initialized()  # one card builds no process group
rec["cost"].pop("bytes_analytic")
print(json.dumps({"memory": rec["memory"], "cost": rec["cost"], "mesh": rec["mesh"],
                  "collectives": rec["collectives"],
                  "roofline": {k: rec["roofline"][k] for k in ONE}}))
"""


@pytest.mark.parametrize("kind", KINDS)
def test_the_one_card_analysis_is_unchanged_and_builds_no_group(kind):
    code = "ONE = %r\n" % sorted(ONE_CARD[kind]["roofline"]) + _ONE_CARD
    out = subprocess.run([sys.executable, "-c", code, kind], capture_output=True, text=True,
                         timeout=300, cwd=ROOT,
                         env=dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src")))
    assert out.returncode == 0, out.stderr[-3000:]
    got = json.loads(out.stdout.strip().splitlines()[-1])
    for part in ("memory", "cost", "roofline"):
        assert got[part] == ONE_CARD[kind][part], part
    assert got["mesh"] == {"data": 1, "model": 1}
    assert got["collectives"]["bytes_by_kind"] == {}


# -- the CLI at a pod and across two ----------------------------------------------------------


def test_the_cli_at_a_pod_and_across_two_runs_without_cuda(tmp_path):
    out_json = tmp_path / "rec.json"
    code = ("import sys, torch; from repro_torch.launch import dryrun; "
            "dryrun.main(sys.argv[1:]); "
            "assert not torch.cuda.is_initialized(); print('cuda untouched')")
    out = subprocess.run(
        [sys.executable, "-c", code, "--arch", "qwen2-0.5b", "--shape", "decode_32k",
         "--chips-per-pod", "256", "--both-meshes", "--out", str(out_json)],
        env=dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src")),
        capture_output=True, text=True, timeout=600, cwd=ROOT)
    assert out.returncode == 0, out.stderr[-3000:]
    assert "cuda untouched" in out.stdout
    one_card_B = 59.96e9  # the decode step's peak on one card (test_torch_tune.py's band)
    pod, two = json.loads(out_json.read_text())
    for rec, chips, analysis in ((pod, 256, "full"), (two, 512, "fast")):
        for k in ("arch", "shape", "multi_pod", "skipped", "chips", "mesh", "backend",
                  "memory", "cost", "collectives", "roofline", "params", "compile_seconds"):
            assert k in rec
        assert rec["chips"] == chips and rec["cost"]["analysis"] == analysis
        assert 0 < rec["memory"]["per_device_B"] < one_card_B
        assert rec["collectives"]["weighted_bytes"] > 0
        assert rec["roofline"]["collective_s"] > 0 and math.isfinite(rec["roofline"]["est_step_s"])
    assert two["mesh"] == {"pod": 2, "data": 16, "model": 16} and two["multi_pod"]
