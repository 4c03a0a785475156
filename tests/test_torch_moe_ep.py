"""Expert-parallel MoE (``models/layers.py`` ``_moe_apply_ep``) against the
reference's ``_moe_apply_ep`` under ``shard_map``.

* Four ``gloo`` ranks (spawned processes) on a 1x4 mesh — reduced
  qwen3-moe, 4 experts, tp=4, f32 — against the reference on 4 placeholder
  CPU devices (a subprocess): output and aux at rtol = atol = 1e-5, on
  every rank, and one sum all-reduce a rank (counted by a dispatch mode).
* On a 1x1 mesh ``ep_local`` equals ``gspmd`` at the same tolerance.
* A trace of one MoE layer on a fake 2x2 mesh shows exactly one
  all-reduce, of the (B/dp, S, D) output in the compute dtype.
* ``repro_torch.benchmarks.ep_forward`` (the card's EP check) runs on one
  gloo rank, and holds each K1 and K2 call it taps against its plain
  version.

Each subprocess has a timeout of its own, so a hung rank fails its test
instead of running the suite into its limit.
"""
import json
import os
import socket
import subprocess
import sys

import numpy as np
import pytest
import torch

from repro_torch.configs import get_config
from repro_torch.distributed.sharding import ShardingRules, active_rules
from repro_torch.launch.mesh import Mesh, device_mesh, single_device_mesh
from repro_torch.models import layers as L
from repro_torch.models.runtime import Runtime
from repro_torch.tuning import trace_analysis as ta

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ARCH = "qwen3-moe-30b-a3b"
B, S = 2, 8
TOL = 1e-5
RANK_TIMEOUT = 120

# the same numpy inputs on both sides: x, router, w_gate, w_up, w_down
_INPUTS = """
import numpy as np
def inputs(d, e, f):
    rng = np.random.default_rng(0)
    x = rng.standard_normal((%d, %d, d)).astype(np.float32)
    p = {"router": (rng.standard_normal((d, e)) / np.sqrt(d)).astype(np.float32),
         "w_gate": (rng.standard_normal((e, d, f)) / np.sqrt(d)).astype(np.float32),
         "w_up": (rng.standard_normal((e, d, f)) / np.sqrt(d)).astype(np.float32),
         "w_down": (rng.standard_normal((e, f, d)) / np.sqrt(f)).astype(np.float32)}
    return x, p
""" % (B, S)

_REF = _INPUTS + """
import json
import jax, jax.numpy as jnp
from repro.configs import get_config
from repro.distributed.sharding import ShardingRules, active_rules
from repro.models import layers as RL
from repro.models.runtime import Runtime
cfg = get_config("%s").reduced()
m = cfg.moe
x, p = inputs(cfg.d_model, m.num_experts, m.d_expert)
mesh = jax.sharding.Mesh(np.array(jax.devices()[:4]).reshape(1, 4), ("data", "model"))
rt = Runtime(compute_dtype="f32", moe_impl="ep_local")
with active_rules(ShardingRules(mesh)):
    assert RL._ep_rules_available(cfg)
    out, aux = RL._moe_apply_ep({k: jnp.asarray(v) for k, v in p.items()}, jnp.asarray(x),
                                cfg=cfg, rt=rt)
print(json.dumps({"out": np.asarray(out).tolist(), "aux": float(aux)}))
""" % ARCH

_RANK = _INPUTS + """
import json, sys
from datetime import timedelta
import torch, torch.distributed as dist
from torch.utils._python_dispatch import TorchDispatchMode
class AllReduces(TorchDispatchMode):
    count = 0
    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        if func.namespace == "_c10d_functional" and "all_reduce" in func.__name__:
            self.count += 1
        return func(*args, **(kwargs or {}))
rank, port, path = int(sys.argv[1]), int(sys.argv[2]), sys.argv[3]
dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{port}", rank=rank,
                        world_size=4, timeout=timedelta(seconds=60))
from repro_torch.configs import get_config
from repro_torch.distributed.sharding import ShardingRules, active_rules
from repro_torch.launch.mesh import Mesh, device_mesh
from repro_torch.models import layers as L
from repro_torch.models.runtime import Runtime
cfg = get_config("%s").reduced()
m = cfg.moe
x, p = inputs(cfg.d_model, m.num_experts, m.d_expert)
mesh = Mesh(("data", "model"), (1, 4))
rules = ShardingRules(mesh, device_mesh=device_mesh(mesh, "cpu"))
rt = Runtime(compute_dtype="f32", moe_impl="ep_local")
with active_rules(rules), AllReduces() as seen:
    out, aux = L.moe_apply({k: torch.from_numpy(v) for k, v in p.items()},
                           torch.from_numpy(x), cfg=cfg, rt=rt)
json.dump({"out": out.tolist(), "aux": float(aux), "all_reduces": seen.count},
          open(path, "w"))
dist.destroy_process_group()
""" % ARCH


def _env(**kw):
    return dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"), JAX_PLATFORMS="cpu", **kw)


def _free_port():
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


@pytest.fixture(scope="module")
def reference():
    out = subprocess.run([sys.executable, "-c", _REF], capture_output=True, text=True,
                         timeout=RANK_TIMEOUT, cwd=ROOT,
                         env=_env(XLA_FLAGS="--xla_force_host_platform_device_count=4"))
    assert out.returncode == 0, out.stderr[-3000:]
    return json.loads(out.stdout.strip().splitlines()[-1])


@pytest.fixture(scope="module")
def gloo_ranks(tmp_path_factory):
    d = tmp_path_factory.mktemp("ep")
    port = _free_port()
    procs = [subprocess.Popen([sys.executable, "-c", _RANK, str(r), str(port),
                               str(d / f"rank{r}.json")],
                              stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
                              cwd=ROOT, env=_env())
             for r in range(4)]
    errs = []
    try:
        for p in procs:
            _, err = p.communicate(timeout=RANK_TIMEOUT)
            errs.append((p.returncode, err[-2000:]))
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    assert all(rc == 0 for rc, _ in errs), errs
    return [json.loads((d / f"rank{r}.json").read_text()) for r in range(4)]


def test_ep_on_four_gloo_ranks_equals_the_reference_shard_map(reference, gloo_ranks):
    want = np.asarray(reference["out"])
    for got in gloo_ranks:
        np.testing.assert_allclose(np.asarray(got["out"]), want, rtol=TOL, atol=TOL)
        np.testing.assert_allclose(got["aux"], reference["aux"], rtol=TOL, atol=TOL)
        assert got["all_reduces"] == 1  # one sum all-reduce over "model"


def _layer(cfg, seed=0):
    rng = np.random.default_rng(seed)
    m = cfg.moe
    d, e, f = cfg.d_model, m.num_experts, m.d_expert
    x = torch.from_numpy(rng.standard_normal((B, S, d)).astype(np.float32))
    p = {"router": rng.standard_normal((d, e)) / np.sqrt(d),
         "w_gate": rng.standard_normal((e, d, f)) / np.sqrt(d),
         "w_up": rng.standard_normal((e, d, f)) / np.sqrt(d),
         "w_down": rng.standard_normal((e, f, d)) / np.sqrt(f)}
    return x, {k: torch.from_numpy(v.astype(np.float32)) for k, v in p.items()}


def test_ep_local_equals_gspmd_on_a_one_by_one_mesh():
    cfg = get_config(ARCH).reduced()
    x, p = _layer(cfg)
    with active_rules(ShardingRules(single_device_mesh())):
        assert L._ep_rules_available(cfg)
        ep, ep_aux = L.moe_apply(p, x, cfg=cfg, rt=Runtime(compute_dtype="f32",
                                                            moe_impl="ep_local"))
    gs, gs_aux = L.moe_apply(p, x, cfg=cfg, rt=Runtime(compute_dtype="f32"))
    torch.testing.assert_close(ep, gs, rtol=TOL, atol=TOL)
    torch.testing.assert_close(ep_aux, gs_aux, rtol=TOL, atol=TOL)
    # no rules, or experts that the model axis does not divide: gspmd
    assert not L._ep_rules_available(cfg)
    with active_rules(ShardingRules(Mesh(("data", "model"), (1, 3)))):
        assert not L._ep_rules_available(cfg)


def test_a_fake_group_trace_of_one_moe_layer_shows_one_all_reduce():
    cfg = get_config(ARCH).reduced()
    mesh = Mesh(("data", "model"), (2, 2))
    rules = ShardingRules(mesh, device_mesh=device_mesh(mesh))
    D = cfg.d_model
    x = rules.place(torch.empty(B, S, D, dtype=torch.bfloat16, device="meta"),
                    ("batch", None, "embed_act"))
    m = cfg.moe
    axes = {"router": ("embed", "experts"), "w_gate": ("experts", "embed", "ff"),
            "w_up": ("experts", "embed", "ff"), "w_down": ("experts", "ff", "embed")}
    shapes = {"router": (D, m.num_experts), "w_gate": (m.num_experts, D, m.d_expert),
              "w_up": (m.num_experts, D, m.d_expert), "w_down": (m.num_experts, m.d_expert, D)}
    p = {k: rules.place(torch.empty(shapes[k], device="meta"), axes[k]) for k in axes}
    rt = Runtime(moe_impl="ep_local")  # bf16 compute
    with active_rules(rules), torch.no_grad():
        (out, aux), st = ta.trace(lambda p, x: L.moe_apply(p, x, cfg=cfg, rt=rt), (p, x))
    assert tuple(out.shape) == (B, S, D)
    assert st.collectives.count_by_kind["all-reduce"] == 1
    assert st.collectives.bytes_by_kind["all-reduce"] == (B // 2) * S * D * 2


def test_the_ep_forward_benchmark_runs_one_rank_on_the_cpu():
    """``repro_torch.benchmarks.ep_forward`` on gloo (a process of its own:
    it makes and ends its group): the two forwards agree, each MoE layer
    issues one all-reduce, and every K1 and K2 call of the tapped forward
    is reported (on the CPU the wrapper is its plain version: no error)."""
    out = subprocess.run(
        [sys.executable, "-m", "repro_torch.benchmarks.ep_forward", "--device", "cpu",
         "--reduced", "--seq", "16", "--dtype", "f32"],
        capture_output=True, text=True, timeout=RANK_TIMEOUT, cwd=ROOT, env=_env())
    assert out.returncode == 0, out.stderr[-3000:]
    rec = json.loads(out.stdout.strip().splitlines()[-1])
    assert rec["backend"] == "gloo" and rec["finite"] and rec["moe_layers"] == 2
    assert rec["max_abs_diff"] <= TOL * rec["max_abs_logit"]
    assert rec["all_reduces_one_forward"] == rec["moe_layers"] == 2
    calls = rec["kernel_calls"]
    assert [c["kernel"] for c in calls].count("rmsnorm") == 2 * rec["layers"] + 1
    assert [c["kernel"] for c in calls].count("flash_attention") == rec["layers"]
    for c in calls:
        assert c["finite"] and c["same_shape_dtype"] and c["shape"][0] == rec["batch"]
        assert c["max_abs_err"] == c["tol_needed"] == 0.0 and c["max_abs_plain"] > 0
