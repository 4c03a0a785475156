"""Expert parallelism through a process group, on one card: one forward
of a MoE model with ``moe_impl="ep_local"`` and one with ``"gspmd"`` on
the same weights and tokens.

    PYTHONPATH=src python -m repro_torch.benchmarks.ep_forward            # the card
    PYTHONPATH=src python -m repro_torch.benchmarks.ep_forward --device cpu --reduced

The forwards run under ``active_rules`` on a 1x1 ``DeviceMesh`` over a
one-rank process group (NCCL on the card, gloo on the CPU) that this
process makes and ends, so the expert-parallel combine is a real sum
all-reduce of the group, one a MoE layer.  The model is ``--arch`` at its
published width with its depth cut to ``--layers`` (the reduced config
with ``--reduced``), its weights drawn from seed 0 in ``--dtype``, run on
the served kernel runtime (``launch.serve.runtime(True, ...)``: K1 and K2,
the hand-written RMSNorm and flash attention, on plain tensors; the MoE is
PyTorch ops).  On the CPU each kernel's wrapper takes its plain version.

One JSON line: the largest logit difference of the two forwards beside
the largest |logit|; each kernel's launches in the timed expert-parallel
forward (counts set to 0 just before it, after an untimed one); and one
more expert-parallel forward, in which a dispatch mode counts the
all-reduces issued (``_c10d_functional.all_reduce``) and every K1 and K2
call is held against its plain version on the inputs it received
(``kernel_calls``: each call's largest error, the plain output's largest
|value|, and ``tol_needed``, the least t with |got - plain| <= t + t|plain|
everywhere); then each forward's seconds and peak bytes.
"""
import argparse
import contextlib
import dataclasses
import json
import socket
import time
import types

import torch
import torch.distributed as dist
from torch.utils._python_dispatch import TorchDispatchMode

from repro_torch.configs import get_config
from repro_torch.distributed.sharding import ShardingRules, active_rules
from repro_torch.launch.mesh import Mesh, device_mesh
from repro_torch.launch.serve import runtime
from repro_torch.models.model import build_model
from repro_torch.models.params import split_params


class _AllReduces(TorchDispatchMode):
    """Counts the c10d all-reduces dispatched while active."""

    def __init__(self):
        super().__init__()
        self.count = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        if func.namespace == "_c10d_functional" and "all_reduce" in func.__name__:
            self.count += 1
        return func(*args, **(kwargs or {}))


def _kernels():
    from repro_torch.runtime.graphs import kernel_counters

    return {fn.__name__: fn for fn in kernel_counters()}


@contextlib.contextmanager
def _tap_kernels(calls):
    """While active, every K1 and K2 call that the dispatch layer
    (``kernels/ops.py``) makes is appended to ``calls`` as ``(name, args,
    kwargs, out)``: the inputs the path gave the kernel and what it
    returned.  The dispatch layer reaches each kernel through its module,
    so standing in for the module there reaches every call site."""
    from repro_torch.kernels import ops

    saved = {"_rms_mod": ops._rms_mod, "_flash_mod": ops._flash_mod}

    def tap(name, fn):
        def tapped(*args, **kw):
            out = fn(*args, **kw)
            calls.append((name, args, kw, out))
            return out
        return tapped

    ops._rms_mod = types.SimpleNamespace(rmsnorm=tap("rmsnorm", ops._rms_mod.rmsnorm))
    ops._flash_mod = types.SimpleNamespace(
        flash_attention=tap("flash_attention", ops._flash_mod.flash_attention))
    try:
        yield
    finally:
        for attr, mod in saved.items():
            setattr(ops, attr, mod)


def _calls_vs_plain(calls):
    """Each tapped call against its plain version on the same inputs."""
    from repro_torch.kernels.flash_attention import flash_attention_plain
    from repro_torch.kernels.rmsnorm import rmsnorm_plain

    rows = []
    for name, args, kw, got in calls:
        if name == "rmsnorm":
            want = rmsnorm_plain(*args, eps=kw["eps"])
        else:
            want = flash_attention_plain(*args, causal=kw["causal"], window=kw["window"],
                                         scale=kw["scale"])
        g, w = got.float(), want.float()
        err = (g - w).abs()
        rows.append({"kernel": name, "shape": list(args[0].shape),
                     "dtype": str(got.dtype).removeprefix("torch."),
                     "same_shape_dtype": got.shape == want.shape and got.dtype == want.dtype,
                     "finite": bool(torch.isfinite(g).all()),
                     "max_abs_err": float(err.max()), "max_abs_plain": float(w.abs().max()),
                     "tol_needed": float((err / (1 + w.abs())).max())})
    return rows


def _free_port() -> int:
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def _sync(device):
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _forward(model, params, tokens, rt, device, before=lambda: None):
    """Seconds, peak bytes (the card) and logits of one forward, after one
    untimed (the first call of a kernel compiles it); ``before()`` runs
    just before the timed one."""
    run = lambda: model.apply(params, {"tokens": tokens}, rt=rt, mode="full")[0]
    run()
    _sync(device)
    before()
    if device.type == "cuda":
        torch.cuda.reset_peak_memory_stats(device)
    t0 = time.perf_counter()
    logits = run()
    _sync(device)
    seconds = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated(device) if device.type == "cuda" else None
    return seconds, peak, logits.float()


def run(arch="qwen3-moe-30b-a3b", layers=2, batch=2, seq=512, dtype="bf16",
        device="cuda", reduced=False):
    on_card = device == "cuda"
    if on_card and not torch.cuda.is_available():
        raise RuntimeError("--device cuda needs a card; --device cpu runs the kernels' plain versions")
    dev = torch.device("cuda", 0) if on_card else torch.device("cpu")
    if on_card:
        torch.cuda.set_device(dev)
    dist.init_process_group("nccl" if on_card else "gloo",
                            init_method=f"tcp://127.0.0.1:{_free_port()}", rank=0, world_size=1)
    try:
        cfg = get_config(arch)
        cfg = cfg.reduced() if reduced else dataclasses.replace(
            cfg, num_layers=layers * cfg.layer_period())
        if cfg.moe is None:
            raise ValueError(f"{arch} has no MoE layers")
        model = build_model(cfg)
        gen = torch.Generator(device=dev)
        gen.manual_seed(0)
        params, _ = split_params(model.init(gen, dtype={"bf16": torch.bfloat16,
                                                        "f32": torch.float32}[dtype]))
        tokens = torch.randint(0, cfg.vocab_size, (batch, seq), generator=gen,
                               dtype=torch.int32, device=dev)
        mesh = Mesh(("data", "model"), (1, 1))
        rules = ShardingRules(mesh, device_mesh=device_mesh(mesh, dev.type))
        rt = runtime(True, dtype)
        ep_rt = dataclasses.replace(rt, moe_impl="ep_local")
        gs_rt = dataclasses.replace(rt, moe_impl="gspmd")
        kernels = _kernels()
        moe_layers = sum(1 for _, mlp in cfg.layer_plan() if mlp == "moe")
        with active_rules(rules), torch.no_grad():
            gs_s, gs_peak, want = _forward(model, params, tokens, gs_rt, dev)

            def zero():
                for fn in kernels.values():
                    fn.launches = 0

            ep_s, ep_peak, got = _forward(model, params, tokens, ep_rt, dev, zero)
            launches = {name: int(fn.launches) for name, fn in kernels.items()}
            calls = []
            with _AllReduces() as seen, _tap_kernels(calls):  # one more forward
                model.apply(params, {"tokens": tokens}, rt=ep_rt, mode="full")
            _sync(dev)
            kernel_calls = _calls_vs_plain(calls)
            del calls
        return {"arch": cfg.name, "layers": cfg.num_layers, "moe_layers": moe_layers,
                "d_model": cfg.d_model, "experts": cfg.moe.num_experts, "batch": batch,
                "seq": seq, "dtype": dtype, "device": str(dev),
                "backend": dist.get_backend(),
                "finite": bool(torch.isfinite(got).all()), "shape": list(got.shape),
                "max_abs_diff": float((got - want).abs().max()),
                "max_abs_logit": float(want.abs().max()),
                "all_reduces_one_forward": seen.count,
                "launches": launches, "kernel_calls": kernel_calls,
                "ep_seconds": ep_s, "gspmd_seconds": gs_s,
                "ep_peak_B": ep_peak, "gspmd_peak_B": gs_peak}
    finally:
        dist.destroy_process_group()


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--arch", default="qwen3-moe-30b-a3b")
    ap.add_argument("--layers", type=int, default=2, help="periods kept of the config's depth")
    ap.add_argument("--batch", type=int, default=2)
    ap.add_argument("--seq", type=int, default=512)
    ap.add_argument("--dtype", choices=("bf16", "f32"), default="bf16")
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    ap.add_argument("--reduced", action="store_true", help="the reduced config")
    args = ap.parse_args(argv)
    out = run(args.arch, args.layers, args.batch, args.seq, args.dtype, args.device,
              args.reduced)
    print(json.dumps(out), flush=True)
    return out


if __name__ == "__main__":
    main()
