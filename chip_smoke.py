#!/usr/bin/env python3
"""Quickest proof that the PyTorch/CUDA port starts on an NVIDIA GPU.

    python3 chip_smoke.py            # all phases, needs one card
    python3 chip_smoke.py --phases env,build,kernels

Builds the hand-written kernels from the sources in this checkout, holds
each against its plain PyTorch version on the card, then serves
``qwen2-0.5b`` at its published width through the port's normal entry point
(``repro_torch.launch.serve``) and checks, by the kernels' launch counts,
that the served path really went through them.  Each phase prints one JSON
line; any failure ends the run with a non-zero exit code.  The last line
is ``{"ok": true, "device": {...}}``.

There is no CPU mode: without a card the script fails at once.
"""
import argparse
import contextlib
import io
import json
import math
import os
import re
import subprocess
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))

# the card's published peaks (NVIDIA H100 SXM data sheet, dense rates)
PEAK_BYTES_PER_S = 3.35e12
PEAK_FLOPS = {"bf16": 989e12, "f32": 67e12}

TOL = {
    "flash_attention": {"f32": 2e-5, "bf16": 2e-2},
    "decode_attention": {"f32": 2e-5, "bf16": 2e-2},
    "rmsnorm": {"f32": 1e-5, "bf16": 2e-2},
}

# B, Sq, Sk, H, K, dh, causal, window — the reference's sweep table
SWEEP = [
    (1, 16, 16, 4, 4, 16, True, None),
    (2, 37, 37, 4, 2, 16, True, None),
    (1, 64, 64, 8, 1, 32, True, None),
    (1, 50, 50, 4, 4, 16, True, 9),
    (2, 13, 29, 4, 1, 8, False, None),
    (1, 128, 128, 2, 2, 64, True, None),
]

SERVE_ARGS = ["--arch", "qwen2-0.5b", "--no-reduced", "--dtype", "bf16",
              "--requests", "16", "--prompt-len", "512", "--gen-len", "64",
              "--batch", "8"]


def emit(obj):
    print(json.dumps(obj), flush=True)


def run_text(cmd):
    return subprocess.run(cmd, capture_output=True, text=True, check=True).stdout.strip()


class Ctx:
    """What the phases share: modules, the full-width model, results."""


def time_ms(fn, arg_sets, *, warmup=3, min_iters=20, replays=5):
    """Milliseconds of one ``fn(*args)``: ``(device_ms, eager_ms)``.

    ``device_ms`` is the time on the card: the calls are captured into one
    CUDA graph and the graph's replay is timed by CUDA events, so the
    host's launch cost is not in it.  ``eager_ms`` is the same loop run
    eagerly between two events: where the host is slower than the card it
    is the host's cost of a call.  The calls rotate over ``arg_sets``
    (together larger than the L2 cache), so each launch finds its inputs in
    device memory, not in cache."""
    import torch

    n = len(arg_sets)
    iters = max(min_iters, n)
    for i in range(max(warmup, 1)):
        fn(*arg_sets[i % n])
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)

    start.record()
    for i in range(iters):
        fn(*arg_sets[i % n])
    stop.record()
    torch.cuda.synchronize()
    eager_ms = start.elapsed_time(stop) / iters

    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for i in range(iters):
            fn(*arg_sets[i % n])
    graph.replay()
    torch.cuda.synchronize()
    start.record()
    for _ in range(replays):
        graph.replay()
    stop.record()
    torch.cuda.synchronize()
    del graph
    return start.elapsed_time(stop) / (iters * replays), eager_ms


def n_sets_for(bytes_per_call, l2_bytes=50e6, cap=48):
    return int(min(cap, max(2, math.ceil(2.5 * l2_bytes / max(bytes_per_call, 1)))))


def max_err(a, b):
    return float((a.float() - b.float()).abs().max().item()) if a.numel() else 0.0


def check_close(name, what, got, want, tol):
    """The reference tests' criterion: |got - want| <= tol + tol * |want|."""
    import torch

    if got.shape != want.shape or got.dtype != want.dtype:
        raise AssertionError(f"{name} {what}: shape/dtype {tuple(got.shape)} {got.dtype} "
                             f"vs {tuple(want.shape)} {want.dtype}")
    g, w = got.float(), want.float()
    if not bool(torch.isfinite(g).all()):
        raise AssertionError(f"{name} {what}: non-finite values")
    bad = (g - w).abs() > tol + tol * w.abs()
    if bool(bad.any()):
        raise AssertionError(f"{name} {what}: max abs err {max_err(got, want):.3e} "
                             f"exceeds atol=rtol={tol}")
    return max_err(got, want)


# ---------------------------------------------------------------------------
# phases
# ---------------------------------------------------------------------------


def phase_env(cx):
    import torch
    import triton

    from repro_torch.kernels import _build

    smi = run_text(["nvidia-smi", "--query-gpu=name,power.limit",
                    "--format=csv,noheader"]).splitlines()[0].strip()
    nvcc = run_text([_build.find_nvcc(), "--version"]).splitlines()[-2:]
    cx.smi = smi
    emit({"phase": "env", "gpu": smi, "torch": torch.__version__,
          "cuda": torch.version.cuda, "triton": triton.__version__,
          "nvcc": " | ".join(nvcc), "python": sys.version.split()[0]})


def phase_build(cx):
    from repro_torch.kernels import _build

    t0 = time.perf_counter()
    logs = _build.build_all(extra_flags=("-Xptxas", "-v"))
    for stem in _build.SOURCES:
        _build.load(stem)
    secs = time.perf_counter() - t0
    summary = {}
    for stem, log in logs.items():
        (_build.build_dir() / f"{stem}.ptxas.log").write_text(log)
        regs = [int(x) for x in re.findall(r"Used (\d+) registers", log)]
        spills = [int(x) for x in re.findall(r"(\d+) bytes spill stores", log)]
        summary[stem] = {"kernels": len(regs), "max_registers": max(regs, default=0),
                         "kernels_with_spills": sum(1 for s in spills if s > 0)}
    emit({"phase": "build", "seconds": round(secs, 2), "built": sorted(logs),
          "dir": str(_build.build_dir()), "ptxas": summary})


def _flash_cases():
    cases = [dict(zip(("B", "Sq", "Sk", "H", "K", "dh", "causal", "window"), c),
                  block_q=16, block_kv=16) for c in SWEEP]
    for c in cases:
        c["dv"] = c["dh"]
    # dv != dh, a head dim that is no power of two
    cases.append(dict(B=2, Sq=33, Sk=33, H=4, K=4, dh=24, dv=16, causal=True,
                      window=None, block_q=16, block_kv=16))
    # window smaller than the gap: fully masked rows must be exact zeros
    cases.append(dict(B=1, Sq=8, Sk=8, H=2, K=2, dh=8, dv=8, causal=False,
                      window=1, block_q=4, block_kv=4))
    # more queries than keys: the first rows attend nothing
    cases.append(dict(B=1, Sq=40, Sk=24, H=2, K=1, dh=16, dv=16, causal=True,
                      window=None, block_q=16, block_kv=8))
    # default tiles, ragged against them
    cases.append(dict(B=1, Sq=300, Sk=300, H=2, K=1, dh=64, dv=64, causal=True,
                      window=64, block_q=128, block_kv=128))
    # K/V tiles smaller than the kernels' key chunks, causal
    cases.append(dict(B=1, Sq=40, Sk=40, H=2, K=2, dh=16, dv=16, causal=True,
                      window=None, block_q=4, block_kv=4))
    # several warps per block, GQA, ragged against the tiles
    cases.append(dict(B=2, Sq=200, Sk=200, H=4, K=2, dh=64, dv=64, causal=True,
                      window=None, block_q=64, block_kv=64))
    # not causal, windowed, more keys than queries
    cases.append(dict(B=1, Sq=100, Sk=130, H=2, K=2, dh=32, dv=32, causal=False,
                      window=20, block_q=32, block_kv=32))
    return cases


def phase_kernels(cx):
    import torch
    import torch.nn.functional as F

    from repro_torch.kernels import decode_attention as dec
    from repro_torch.kernels import flash_attention as fla
    from repro_torch.kernels import rmsnorm as rms

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev)
    gen.manual_seed(0)
    dtypes = {"f32": torch.float32, "bf16": torch.bfloat16}

    def rand(*shape, dtype):
        return torch.randn(shape, generator=gen, device=dev, dtype=torch.float32).to(dtype)

    checked = {"flash_attention": 0, "decode_attention": 0, "rmsnorm": 0}
    worst = {k: {"f32": 0.0, "bf16": 0.0} for k in checked}

    # -- flash attention: the reference's tables ------------------------------
    for name, dt in dtypes.items():
        tol = TOL["flash_attention"][name]
        for c in _flash_cases():
            q = rand(c["B"], c["Sq"], c["H"], c["dh"], dtype=dt)
            k = rand(c["B"], c["Sk"], c["K"], c["dh"], dtype=dt)
            v = rand(c["B"], c["Sk"], c["K"], c["dv"], dtype=dt)
            kw = dict(causal=c["causal"], window=c["window"])
            got = fla.flash_attention(q, k, v, block_q=c["block_q"],
                                      block_kv=c["block_kv"], **kw)
            want = fla.flash_attention_plain(q, k, v, block_kv=c["block_kv"], **kw)
            torch.cuda.synchronize()
            e = check_close("flash_attention", f"{name} {c}", got, want, tol)
            worst["flash_attention"][name] = max(worst["flash_attention"][name], e)
            checked["flash_attention"] += 1
        # strided views (a head-major buffer seen as (B, S, H, d)) are read in place
        qs = rand(2, 4, 40, 16, dtype=dt).transpose(1, 2)
        ks = rand(2, 2, 40, 16, dtype=dt).transpose(1, 2)
        vs = rand(2, 2, 40, 16, dtype=dt).transpose(1, 2)
        e = check_close("flash_attention", f"{name} strided",
                        fla.flash_attention(qs, ks, vs, block_q=16, block_kv=16),
                        fla.flash_attention_plain(qs, ks, vs), tol)
        worst["flash_attention"][name] = max(worst["flash_attention"][name], e)
        checked["flash_attention"] += 1
    # exact zeros where nothing is attended
    q, k, v = (rand(1, 8, 2, 8, dtype=torch.float32) for _ in range(3))
    out = fla.flash_attention(q, k, v, causal=True, window=None, block_q=4, block_kv=4)
    q2 = rand(1, 40, 2, 16, dtype=torch.float32)
    k2, v2 = (rand(1, 24, 1, 16, dtype=torch.float32) for _ in range(2))
    out2 = fla.flash_attention(q2, k2, v2, causal=True, block_q=16, block_kv=8)
    if not bool((out2[:, :16] == 0).all()) or not bool(torch.isfinite(out).all()):
        raise AssertionError("flash_attention: fully masked rows are not exact zeros")

    # -- decode attention -------------------------------------------------------
    decode_cases = [
        dict(B=3, H=8, K=2, dh=16, Smax=50, lengths=[50, 17, 1], block_kv=16),
        dict(B=4, H=8, K=2, dh=16, Smax=50, lengths=[50, 0, 1, 33], block_kv=16),
        dict(B=3, H=8, K=1, dh=32, Smax=70, lengths=[70, 5, 64], block_kv=4),   # MQA
        dict(B=2, H=6, K=6, dh=24, Smax=33, lengths=[33, 9], block_kv=512),     # MHA, dh 24
        dict(B=2, H=14, K=2, dh=64, Smax=200, lengths=[200, 77], block_kv=512), # group 7
        dict(B=2, H=24, K=2, dh=128, Smax=90, lengths=[90, 31], block_kv=64),   # 2 passes
    ]
    combos = {"f32": (torch.float32, torch.float32),
              "bf16": (torch.bfloat16, torch.bfloat16),
              "f32_q_bf16_cache": (torch.float32, torch.bfloat16)}
    for name, (qdt, kdt) in combos.items():
        tol = TOL["decode_attention"]["bf16" if qdt == torch.bfloat16 else "f32"]
        for c in decode_cases:
            q = rand(c["B"], c["H"], c["dh"], dtype=qdt)
            k = rand(c["B"], c["Smax"], c["K"], c["dh"], dtype=kdt)
            v = rand(c["B"], c["Smax"], c["K"], c["dh"], dtype=kdt)
            lengths = torch.tensor(c["lengths"], dtype=torch.int32, device=dev)
            got = dec.decode_attention(q, k, v, lengths, block_kv=c["block_kv"])
            want = dec.decode_attention_plain(q, k, v, lengths)
            torch.cuda.synchronize()
            e = check_close("decode_attention", f"{name} {c}", got, want, tol)
            if 0 in c["lengths"]:
                b0 = c["lengths"].index(0)
                if not bool((got[b0] == 0).all()):
                    raise AssertionError("decode_attention: empty cache is not exact zeros")
            key = "bf16" if qdt == torch.bfloat16 else "f32"
            worst["decode_attention"][key] = max(worst["decode_attention"][key], e)
            checked["decode_attention"] += 1

    # -- rmsnorm ----------------------------------------------------------------
    for name, dt in dtypes.items():
        tol = TOL["rmsnorm"][name]
        for shape, br in (((5, 33, 64), 16), ((5, 33, 64), 256), ((7, 100), 1),
                          ((3, 896), 8), ((2, 5, 2560), 4)):
            x = rand(*shape, dtype=dt)
            s = rand(shape[-1], dtype=torch.float32)
            got = rms.rmsnorm(x, s, 1e-5, block_rows=br)
            want = rms.rmsnorm_plain(x, s, 1e-5)
            torch.cuda.synchronize()
            e = check_close("rmsnorm", f"{name} {shape} block_rows={br}", got, want, tol)
            worst["rmsnorm"][name] = max(worst["rmsnorm"][name], e)
            checked["rmsnorm"] += 1

    # -- the main path's own shapes: error, time, plain time, library time, bound
    at_main = {}
    H, K, dh, D = 14, 2, 64, 896

    # flash: prefill of a wave, B=8, S=512
    B, S = 8, 512
    rows = []
    for name, dt in dtypes.items():
        esz = 4 if name == "f32" else 2
        nbytes = (2 * B * S * H * dh + 2 * B * S * K * dh) * esz
        sets = [(rand(B, S, H, dh, dtype=dt), rand(B, S, K, dh, dtype=dt),
                 rand(B, S, K, dh, dtype=dt)) for _ in range(n_sets_for(nbytes))]
        q, k, v = sets[0]
        got = fla.flash_attention(q, k, v, block_q=512, block_kv=512)
        cfg = dict(fla.flash_attention.last_config)
        want = fla.flash_attention_plain(q, k, v)
        e = check_close("flash_attention", f"{name} main shape", got, want,
                        TOL["flash_attention"][name])
        ms, eager_ms = time_ms(
            lambda q, k, v: fla.flash_attention(q, k, v, block_q=512, block_kv=512), sets)
        ms128, _ = time_ms(
            lambda q, k, v: fla.flash_attention(q, k, v, block_q=128, block_kv=128), sets)
        plain_ms, _ = time_ms(lambda q, k, v: fla.flash_attention_plain(q, k, v), sets[:4],
                              min_iters=4, replays=2)
        lib_sets = [(q.transpose(1, 2), k.repeat_interleave(H // K, dim=2).transpose(1, 2),
                     v.repeat_interleave(H // K, dim=2).transpose(1, 2)) for q, k, v in sets]
        lib_ms, _ = time_ms(
            lambda q, k, v: F.scaled_dot_product_attention(q, k, v, is_causal=True), lib_sets)
        del lib_sets
        live_pairs = S * (S + 1) // 2
        flops = B * H * live_pairs * (2 * dh + 2 * dh)
        t_bytes, t_ops = nbytes / PEAK_BYTES_PER_S * 1e3, flops / PEAK_FLOPS[name] * 1e3
        rows.append({"dtype": name, "shape": f"B={B} Sq=Sk={S} H={H} K={K} dh={dh} causal",
                     "config": cfg, "max_abs_err": e, "ms": ms, "eager_ms": eager_ms, "ms_block128": ms128,
                     "plain_ms": plain_ms, "library_ms": lib_ms, "bound_ms": max(t_bytes, t_ops),
                     "bound_by": "bytes" if t_bytes >= t_ops else "operations"})
        del sets
    at_main["flash_attention"] = rows

    # decode: one step of a wave, B=8, Smax=576, every sequence at length 575
    B, Smax = 8, 576
    rows = []
    for name, (qdt, kdt) in combos.items():
        esz = 2 if kdt == torch.bfloat16 else 4
        length = Smax - 1
        nbytes = 2 * B * length * K * dh * esz + 2 * B * H * dh * (2 if qdt == torch.bfloat16 else 4)
        lengths = torch.full((B,), length, dtype=torch.int32, device=dev)
        sets = [(rand(B, H, dh, dtype=qdt), rand(B, Smax, K, dh, dtype=kdt),
                 rand(B, Smax, K, dh, dtype=kdt), lengths) for _ in range(n_sets_for(nbytes))]
        q, k, v, _ = sets[0]
        got = dec.decode_attention(q, k, v, lengths, block_kv=512)
        cfg = dict(dec.decode_attention.last_config)
        want = dec.decode_attention_plain(q, k, v, lengths)
        e = check_close("decode_attention", f"{name} main shape", got, want,
                        TOL["decode_attention"]["bf16" if qdt == torch.bfloat16 else "f32"])
        ms, eager_ms = time_ms(lambda *a: dec.decode_attention(*a, block_kv=512), sets)
        plain_ms, _ = time_ms(lambda *a: dec.decode_attention_plain(*a), sets)
        mask = (torch.arange(Smax, device=dev)[None, :] < lengths[:, None])[:, None, None, :]
        lib_sets = [(q[:, :, None, :], k.to(qdt).repeat_interleave(H // K, dim=2).transpose(1, 2),
                     v.to(qdt).repeat_interleave(H // K, dim=2).transpose(1, 2))
                    for q, k, v, _ in sets]
        lib_ms, _ = time_ms(
            lambda q, k, v: F.scaled_dot_product_attention(q, k, v, attn_mask=mask), lib_sets)
        del lib_sets
        flops = B * H * length * 4 * dh
        t_bytes, t_ops = nbytes / PEAK_BYTES_PER_S * 1e3, flops / PEAK_FLOPS["f32" if qdt == torch.float32 else "bf16"] * 1e3
        rows.append({"dtype": name, "shape": f"B={B} Smax={Smax} len={length} H={H} K={K} dh={dh}",
                     "config": cfg, "max_abs_err": e, "ms": ms, "eager_ms": eager_ms,
                     "plain_ms": plain_ms, "library_ms": lib_ms, "bound_ms": max(t_bytes, t_ops),
                     "bound_by": "bytes" if t_bytes >= t_ops else "operations"})
        del sets
    at_main["decode_attention"] = rows

    # rmsnorm: prefill rows 8*512 and decode rows 8
    rows = []
    for name, dt in dtypes.items():
        esz = 4 if name == "f32" else 2
        for R in (4096, 8):
            nbytes = 2 * R * D * esz + D * 4
            s = rand(D, dtype=torch.float32)
            sets = [(rand(R, D, dtype=dt), s) for _ in range(n_sets_for(nbytes))]
            x = sets[0][0]
            got = rms.rmsnorm(x, s, 1e-6)
            cfg = dict(rms.rmsnorm.last_config)
            want = rms.rmsnorm_plain(x, s, 1e-6)
            e = check_close("rmsnorm", f"{name} rows={R}", got, want, TOL["rmsnorm"][name])
            ms, eager_ms = time_ms(lambda x, s: rms.rmsnorm(x, s, 1e-6), sets)
            plain_ms, _ = time_ms(lambda x, s: rms.rmsnorm_plain(x, s, 1e-6), sets)
            s_dt = s.to(dt)
            lib_ms, _ = time_ms(lambda x, s: F.rms_norm(x, (D,), s_dt, 1e-6), sets)
            flops = R * D * 4
            t_bytes, t_ops = nbytes / PEAK_BYTES_PER_S * 1e3, flops / PEAK_FLOPS["f32"] * 1e3
            rows.append({"dtype": name, "shape": f"rows={R} D={D}", "config": cfg,
                         "max_abs_err": e, "ms": ms, "eager_ms": eager_ms,
                         "plain_ms": plain_ms, "library_ms": lib_ms,
                         "bound_ms": max(t_bytes, t_ops),
                         "bound_by": "bytes" if t_bytes >= t_ops else "operations"})
            del sets
    at_main["rmsnorm"] = rows

    torch.cuda.empty_cache()
    cx.at_main = at_main
    emit({"phase": "kernels", "gpu": cx.smi, "tolerances": TOL, "cases_checked": checked,
          "worst_abs_err": worst, "at_main_shapes": at_main,
          "timing": "ms, plain_ms, library_ms: CUDA events around the replay of a CUDA graph "
                    "of >= 20 calls (device time); eager_ms: the same calls run eagerly "
                    "(host launch cost included); inputs rotated through buffers larger than "
                    "the L2 cache"})


def _full_model(cx):
    """qwen2-0.5b at its published width, random weights from seed 0, cast
    once to bf16 on the card."""
    if getattr(cx, "model", None) is not None:
        return
    import torch

    from repro_torch.configs import get_config
    from repro_torch.models.model import build_model
    from repro_torch.models.params import split_params, tree_map

    cfg = get_config("qwen2-0.5b")
    assert (cfg.num_layers, cfg.d_model, cfg.padded_vocab) == (24, 896, 152064)
    model = build_model(cfg)
    gen = torch.Generator(device="cuda")
    gen.manual_seed(0)
    params, _ = split_params(model.init(gen))
    cx.cfg, cx.model = cfg, model
    cx.params = tree_map(lambda a: a.to(torch.bfloat16), params)
    del params
    torch.cuda.empty_cache()


def phase_parity(cx):
    """Full width, bf16: the kernel path against the oracle path on the same
    weights and the same tokens, and both against the oracle path in f32.

    Two bf16 paths that round at different places (the RMSNorm kernel rounds
    once, its oracle three times) drift apart by a few bf16 ulps over 24
    layers, so the direct bound is stated in ulps of the largest logit:
    4 ulps (an ulp of a bf16 value in [4, 8) is 2^-5).  The sharper check is
    against the f32 run: the kernel path must be no farther from it than
    the oracle path is (factor 1.25, plus 1e-2 of slack for ties in
    rounding)."""
    import numpy as np
    import torch

    from repro_torch.models.params import split_params, tree_map
    from repro_torch.models.runtime import Runtime
    from repro_torch.serve.serve_step import greedy_sample, make_decode_step, make_prefill_step

    _full_model(cx)
    cfg, model = cx.cfg, cx.model
    B, S, steps = 2, 128, 8
    rng = np.random.default_rng(0)
    tokens = torch.from_numpy(rng.integers(0, cfg.vocab_size, (B, S)).astype(np.int32)).cuda()

    def run(impl, dtype, params, forced=None):
        rt = Runtime(compute_dtype=dtype, attn_impl=impl)
        prefill, decode = make_prefill_step(model, rt), make_decode_step(model, rt)
        cache, _ = split_params(model.init_cache(B, S + steps + 1, device="cuda"))
        logits, cache = prefill(params, {"tokens": tokens}, cache)
        all_logits, toks = [logits], [greedy_sample(logits)]
        for t in range(steps):
            fed = toks[-1] if forced is None else forced[t]
            logits, cache = decode(params, fed, cache)
            all_logits.append(logits)
            toks.append(greedy_sample(logits))
        return torch.cat(all_logits, dim=1).float(), toks, cache

    lk, tk, ck = run("cuda", "bf16", cx.params)
    lr, tr, cr = run("ref", "bf16", cx.params, forced=tk)  # the same tokens go into all runs
    params32 = tree_map(lambda a: a.float(), cx.params)     # the same (bf16-rounded) weights
    l32, t32, _ = run("ref", "f32", params32, forced=tk)
    del params32
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    if lk.shape != (B, steps + 1, cfg.padded_vocab) or not bool(torch.isfinite(lk).all()):
        raise AssertionError(f"parity: logits {tuple(lk.shape)} not finite or of the wrong shape")

    def per_step(a, b):
        return (a - b).abs().amax(dim=(0, 2)).tolist()

    absmax = float(l32.abs().max())
    ulp = 2.0 ** (math.floor(math.log2(absmax)) - 7)
    direct, e_k, e_r = per_step(lk, lr), per_step(lk, l32), per_step(lr, l32)
    tol_direct = 4 * ulp
    kc, kr = (c["layers"]["pos0"]["mixer"]["k"].float() for c in (ck, cr))
    emit({"phase": "parity", "model": cfg.name, "layers": cfg.num_layers, "d_model": cfg.d_model,
          "vocab": cfg.padded_vocab, "dtype": "bf16", "B": B, "S": S, "decode_steps": steps,
          "logit_absmax": absmax, "bf16_ulp_at_absmax": ulp,
          "kernels_vs_oracles_max_abs_err_per_step": direct, "tolerance_direct_abs": tol_direct,
          "kernels_vs_f32_max_abs_err_per_step": e_k, "oracles_vs_f32_max_abs_err_per_step": e_r,
          "k_cache_max_abs_err": float((kc - kr).abs().max()), "k_cache_absmax": float(kr.abs().max()),
          "pos": [ck["pos"], cr["pos"]],
          "greedy_cuda": torch.cat(tk, 1).tolist(), "greedy_ref": torch.cat(tr, 1).tolist(),
          "greedy_f32": torch.cat(t32, 1).tolist()})
    if max(direct) > tol_direct:
        raise AssertionError(f"parity: kernels vs oracles differ by {max(direct):.3e} > "
                             f"{tol_direct:.3e} (4 bf16 ulps at |logit| {absmax:.2f})")
    if max(e_k) > 1.25 * max(e_r) + 1e-2:
        raise AssertionError(f"parity: the kernel path is farther from the f32 run "
                             f"({max(e_k):.3e}) than the oracle path is ({max(e_r):.3e})")
    if ck["pos"] != cr["pos"] or ck["pos"] != S + steps:
        raise AssertionError("parity: cache positions differ")


def _counts(mods):
    return {name: int(fn.launches) for name, fn in mods.items()}


def _zero_counts(mods):
    for fn in mods.values():
        fn.launches = 0


def phase_serve(cx):
    import torch

    from repro_torch.kernels.decode_attention import decode_attention
    from repro_torch.kernels.flash_attention import flash_attention
    from repro_torch.kernels.rmsnorm import rmsnorm
    from repro_torch.launch import serve

    # free the earlier phases' copy of the model: the entry point makes its own
    cx.model = cx.params = None
    torch.cuda.empty_cache()
    mods = {"flash_attention": flash_attention, "decode_attention": decode_attention,
            "rmsnorm": rmsnorm}
    requests, gen_len, batch, layers = 16, 64, 8, 24
    waves = requests // batch
    expected = {"flash_attention": layers * waves,
                "decode_attention": layers * (gen_len - 1) * waves,
                "rmsnorm": (2 * layers + 1) * gen_len * waves}
    runs = []
    for label in ("first", "second"):
        torch.cuda.reset_peak_memory_stats()
        _zero_counts(mods)  # just before the main path ...
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            done = serve.main(SERVE_ARGS)
        counts = _counts(mods)  # ... and read just after
        torch.cuda.synchronize()
        line = [ln for ln in buf.getvalue().splitlines() if ln.startswith("[serve]")][-1]
        m = re.match(r"\[serve\] (\d+) requests, (\d+) tokens in ([\d.]+)s => ([\d.]+) tok/s", line)
        if m is None:
            raise AssertionError(f"serve: unexpected report line {line!r}")
        if counts != expected:
            raise AssertionError(f"serve: launch counts {counts} != expected {expected}: "
                                 "the served path ran past a kernel")
        if len(done) != requests or sorted(r for r, _ in done) != list(range(requests)):
            raise AssertionError("serve: not every request was answered")
        for _, toks in done:
            if toks.shape != (gen_len,) or toks.min() < 0 or toks.max() >= 152064:
                raise AssertionError("serve: a request's tokens have the wrong shape or range")
        runs.append({"run": label, "requests": int(m.group(1)), "tokens": int(m.group(2)),
                     "seconds": float(m.group(3)), "tok_per_s": float(m.group(4)),
                     "peak_memory_bytes": int(torch.cuda.max_memory_allocated()),
                     "launches": counts, "report": line})
    cx.launches = runs[0]["launches"]
    emit({"phase": "serve", "gpu": cx.smi, "args": SERVE_ARGS, "expected_launches": expected,
          "runs": runs, "note": "the first run includes one-time costs (Triton compilation, "
                                "first launches); both runs include their own weight initialisation "
                                "outside the timed region"})


def phase_tuning_db(cx):
    import torch

    from repro_torch.kernels import ops
    from repro_torch.kernels.flash_attention import flash_attention
    from repro_torch.models.params import split_params
    from repro_torch.models.runtime import Runtime
    from repro_torch.serve.serve_step import make_prefill_step
    from repro_torch.tuning.tundb import TuningDB, hardware_fingerprint

    _full_model(cx)
    model, params = cx.model, cx.params
    rt = Runtime(compute_dtype="bf16", attn_impl="cuda")
    batch = {"tokens": torch.zeros((1, 128), dtype=torch.int32, device="cuda")}

    seen = {}
    orig = ops._tuned

    def spy(db, kernel, dims, defaults):
        out = orig(db, kernel, dims, defaults)
        if db is not None:
            seen[kernel] = {"dims": dict(dims), "chosen": dict(out)}
        return out

    ops._tuned = spy
    try:
        db = TuningDB(fingerprint=hardware_fingerprint("cuda"))
        cache, _ = split_params(model.init_cache(1, 192, device="cuda"))
        logits0, _ = make_prefill_step(model, rt, tuning_db=db)(params, batch, cache)
        dims = seen["flash_attention"]["dims"]
        untuned = dict(flash_attention.last_config)
        if seen["flash_attention"]["chosen"] != {"block_q": rt.block_q, "block_kv": rt.block_kv}:
            raise AssertionError("tuning_db: an empty DB changed the defaults")
        if not (db.lookups > 0 and db.hits == 0):
            raise AssertionError(f"tuning_db: empty DB gave lookups={db.lookups} hits={db.hits}")
        lookups_empty = db.lookups

        db.record("flash_attention", dims, {"block_q": 32, "block_kv": 32}, 99.0)
        seen.clear()
        cache, _ = split_params(model.init_cache(1, 192, device="cuda"))
        logits1, _ = make_prefill_step(model, rt, tuning_db=db)(params, batch, cache)
        tuned = dict(flash_attention.last_config)
        torch.cuda.synchronize()
    finally:
        ops._tuned = orig
    if seen["flash_attention"]["chosen"] != {"block_q": 32, "block_kv": 32} or \
            tuned != {"block_q": 32, "block_kv": 32}:
        raise AssertionError(f"tuning_db: recorded tiles were not picked up: {seen}, {tuned}")
    if db.hits <= 0:
        raise AssertionError("tuning_db: no hit after a record")
    err = max_err(logits1, logits0)
    emit({"phase": "tuning_db", "dims": dims, "untuned_config": untuned, "tuned_config": tuned,
          "lookups_with_empty_db": lookups_empty, "lookups": db.lookups, "hits": db.hits,
          "logits_max_abs_err": err, "tolerance_abs": 2e-2,
          "fingerprint": db.fingerprint})
    if not err <= 2e-2:
        raise AssertionError(f"tuning_db: tuned and untuned logits differ by {err:.3e}")


def kernels_line(cx):
    """The contract line: one entry per kernel, at the main path's shape and
    type (bf16; the RMSNorm entry is the prefill one, rows = 8*512)."""
    pick = {"flash_attention": ("bf16", None), "decode_attention": ("bf16", None),
            "rmsnorm": ("bf16", "rows=4096 D=896")}
    meta = {
        "rmsnorm": ("triton", "src/repro_torch/kernels/rmsnorm.py",
                    "src/repro/kernels/rmsnorm.py:17"),
        "flash_attention": ("cuda", "src/repro_torch/kernels/csrc/flash_attention.cu",
                            "src/repro/kernels/flash_attention.py:35"),
        "decode_attention": ("cuda", "src/repro_torch/kernels/csrc/decode_attention.cu",
                             "src/repro/kernels/decode_attention.py:25"),
    }
    out = []
    for name, (route, source, replaces) in meta.items():
        dtype, shape = pick[name]
        row = next(r for r in cx.at_main[name]
                   if r["dtype"] == dtype and (shape is None or r["shape"] == shape))
        launches = cx.launches[name]
        if launches <= 0:
            raise AssertionError(f"{name}: not launched on the main path")
        out.append({"name": name, "route": route, "source": source, "replaces": replaces,
                    "launches": launches, "max_abs_err": row["max_abs_err"], "ms": row["ms"],
                    "plain_ms": row["plain_ms"], "bound_ms": row["bound_ms"],
                    "bound_by": row["bound_by"], "library_ms": row["library_ms"],
                    "shape": row["shape"], "dtype": dtype})
    emit({"kernels": out})


PHASES = {"env": phase_env, "build": phase_build, "kernels": phase_kernels,
          "parity": phase_parity, "serve": phase_serve, "tuning_db": phase_tuning_db}


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--phases", default=",".join(PHASES),
                    help="comma-separated subset of: " + ", ".join(PHASES))
    args = ap.parse_args(argv)
    phases = [p for p in args.phases.split(",") if p]
    unknown = [p for p in phases if p not in PHASES]
    if unknown:
        ap.error(f"unknown phases {unknown}")

    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is false; this script needs an NVIDIA GPU",
              file=sys.stderr)
        return 1
    sys.path.insert(0, os.path.join(HERE, "src"))
    import repro_torch  # noqa: F401  (fails here when the package is not beside this script)

    t0 = time.perf_counter()
    cx = Ctx()
    cx.smi = ""
    for name in phases:
        PHASES[name](cx)
    complete = phases == list(PHASES)
    if complete:
        kernels_line(cx)
    emit({"phase": "done", "seconds": round(time.perf_counter() - t0, 1), "phases": phases})
    print(run_text(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"])
          .splitlines()[0].strip(), flush=True)
    if not complete:
        print("chip_smoke: partial run (not every phase was asked for): no verdict",
              file=sys.stderr)
        return 4
    emit({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
