"""The steps placed on a mesh, run on real values: four ``gloo`` ranks
(spawned processes) on a 2x2 ``("data", "model")`` mesh, each step against
the same step on one device (no rules, plain tensors), f32, reduced
configs, the same weights and tokens from seed 0.

* qwen2-0.5b's loss and every gradient (``value_and_grad`` of the train
  loss: the vocab-parallel cross-entropy, the head-sharded projections and
  ``_attention``'s per-shard KV groups under ``local_map``);
* its train step at 2 microbatches (``_split_placed``'s per-device split):
  the loss and the gradient norm;
* a prefill of 12 tokens into a 16-slot cache (f32 here, bf16 in the
  model, so that a rounding step of bf16 does not hide behind the
  tolerance), then a decode step, with the
  cache sharded along its sequence (``cache_shard="seq"``) and by KV heads
  (``"heads"``): both steps' logits and every cache layer after each
  (``_write_seq``'s shard-by-shard writes, ``_decode_attention``);
* the same for h2o-danube-1.8b, whose sliding window (8 slots in the
  reduced config) makes the prefill fill the ring buffer with its rolled
  tail (``_fill_kv_cache``).

Each tensor is held at rtol = 1e-5 and an atol of 1e-5 of its own largest
|value| (gradients near zero carry only the summation order's noise).
Every rank checks its gathered results; each subprocess has a timeout of
its own, so a hung rank fails the test instead of running the suite into
its limit.
"""
import json
import os
import socket
import subprocess
import sys

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
RANKS = 4
RANK_TIMEOUT = 240
TOL = 1e-5

CASES = ["train_grads", "train_step_microbatches",
         "serve_qwen2-0.5b_seq", "serve_qwen2-0.5b_heads",
         "serve_h2o-danube-1.8b_seq", "serve_h2o-danube-1.8b_heads"]

_RANK = """
import dataclasses, json, sys, traceback
from datetime import timedelta
import torch, torch.distributed as dist
rank, port, path = int(sys.argv[1]), int(sys.argv[2]), sys.argv[3]
torch.set_num_threads(1)  # four ranks beside the suite's other workers
dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{port}", rank=rank,
                        world_size=%(ranks)d, timeout=timedelta(seconds=120))
from torch.distributed.tensor import DTensor
from torch.distributed.tensor.experimental import implicit_replication
from repro_torch.configs import get_config
from repro_torch.distributed.sharding import ShardingRules, active_rules
from repro_torch.launch.mesh import Mesh, device_mesh
from repro_torch.models.model import build_model
from repro_torch.models.params import split_params, tree_leaves, tree_map
from repro_torch.optim.optimizer import OptimizerConfig, adamw_init
from repro_torch.serve.serve_step import make_decode_step, make_prefill_step
from repro_torch.train.train_step import make_loss_fn, make_train_step, value_and_grad
from repro_torch.tuning.parameters import BASELINE

TOL = %(tol)r
B, S_TRAIN, S_PROMPT, CACHE = 4, 16, 12, 16
RT = dataclasses.replace(BASELINE.runtime(), compute_dtype="f32")
mesh = Mesh(("data", "model"), (2, 2))
dm = device_mesh(mesh, "cpu")
RULES = {"seq": ShardingRules(mesh, device_mesh=dm),
         "heads": ShardingRules(mesh, overrides={"cache_seq": None}, device_mesh=dm)}


def full(t):  # a copy of the whole tensor: a cache is written in place later
    return t.full_tensor() if isinstance(t, DTensor) else t.clone()


def setup(arch):
    cfg = get_config(arch).reduced()
    model = build_model(cfg)
    gen = torch.Generator().manual_seed(0)
    params, axes = split_params(model.init(gen))
    tokens = torch.randint(0, cfg.vocab_size, (B, S_TRAIN + 1), generator=gen,
                           dtype=torch.int32)
    return model, params, axes, tokens


def run(rules, fn):
    if rules is None:
        return fn(None)
    with active_rules(rules), implicit_replication():
        return fn(rules)


def place(rules, t, axes):
    return t if rules is None else rules.place(t, axes)


def grads(rules):
    model, params, axes, tokens = setup("qwen2-0.5b")
    if rules is not None:
        params = rules.tree_place(axes, params)
    batch = {"tokens": place(rules, tokens[:, :-1], ("batch", None)),
             "targets": place(rules, tokens[:, 1:], ("batch", None))}
    (loss, _), g = value_and_grad(make_loss_fn(model, RT), params, batch)
    return [full(loss)] + [full(x) for x in tree_leaves(g)]


def train_step(rules):
    model, params, axes, tokens = setup("qwen2-0.5b")
    opt_cfg = OptimizerConfig()
    opt = adamw_init(params, opt_cfg)
    if rules is not None:
        from repro_torch.optim.optimizer import optimizer_state_axes
        opt = rules.tree_place(optimizer_state_axes(axes, opt_cfg, params), opt)
        params = rules.tree_place(axes, params)
    batch = {"tokens": place(rules, tokens[:, :-1], ("batch", None)),
             "targets": place(rules, tokens[:, 1:], ("batch", None))}
    step = make_train_step(model, opt_cfg, RT, microbatches=2)
    _, _, metrics = step(params, opt, batch)
    return [full(metrics["loss_out"]), full(metrics["grad_norm"])]


def serve(arch):
    def go(rules):
        model, params, axes, tokens = setup(arch)
        cache, cache_axes = split_params(model.init_cache(B, CACHE))
        cache["layers"] = tree_map(lambda t: t.float(), cache["layers"])
        if rules is not None:
            params = rules.tree_place(axes, params)
            cache = rules.tree_place(cache_axes, cache)
        prompt = place(rules, tokens[:, :S_PROMPT], ("batch", None))
        nxt = place(rules, tokens[:, S_PROMPT:S_PROMPT + 1], ("batch", None))
        logits, cache = make_prefill_step(model, RT)(params, {"tokens": prompt}, cache)
        out = [full(logits)] + [full(x) for x in tree_leaves(cache["layers"])]
        logits, cache = make_decode_step(model, RT)(params, nxt, cache)
        assert cache["pos"] == S_PROMPT + 1
        return out + [full(logits)] + [full(x) for x in tree_leaves(cache["layers"])]
    return go


def compare(got, want):
    assert len(got) == len(want), (len(got), len(want))
    worst = 0.0
    for i, (g, w) in enumerate(zip(got, want)):
        scale = float(w.abs().max()) if w.numel() else 0.0
        torch.testing.assert_close(g, w, rtol=TOL, atol=TOL * scale,
                                   msg=lambda m: f"tensor {i}: {m}")
        worst = max(worst, float((g - w).abs().max()) / max(scale, 1e-30))
    return {"ok": True, "tensors": len(got), "worst_err_over_absmax": worst}


CASES = {"train_grads": (grads, None), "train_step_microbatches": (train_step, None),
         "serve_qwen2-0.5b_seq": (serve("qwen2-0.5b"), "seq"),
         "serve_qwen2-0.5b_heads": (serve("qwen2-0.5b"), "heads"),
         "serve_h2o-danube-1.8b_seq": (serve("h2o-danube-1.8b"), "seq"),
         "serve_h2o-danube-1.8b_heads": (serve("h2o-danube-1.8b"), "heads")}
out = {}
for name, (fn, shard) in CASES.items():
    try:
        want = run(None, fn)
        got = run(RULES[shard or "seq"], fn)
        out[name] = compare(got, want)
    except Exception:
        out[name] = {"ok": False, "error": traceback.format_exc()[-3000:]}
json.dump(out, open(path, "w"))
dist.destroy_process_group()
""" % {"ranks": RANKS, "tol": TOL}


def _free_port():
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    d = tmp_path_factory.mktemp("mesh_steps")
    port = _free_port()
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"))
    procs = [subprocess.Popen([sys.executable, "-c", _RANK, str(r), str(port),
                               str(d / f"rank{r}.json")],
                              stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
                              cwd=ROOT, env=env)
             for r in range(RANKS)]
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
    return [json.loads((d / f"rank{r}.json").read_text()) for r in range(RANKS)]


@pytest.mark.parametrize("case", CASES)
def test_a_step_on_a_two_by_two_gloo_mesh_equals_one_device(ranks, case):
    for r, res in enumerate(ranks):
        assert res[case]["ok"], f"rank {r}: {res[case].get('error')}"
        assert res[case]["tensors"] >= 2
