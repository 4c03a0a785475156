"""Where a served wave's time goes on the GPU (the PyTorch/CUDA port).

    PYTHONPATH=src python -m repro_torch.launch.serve_profile \
        [--arch qwen2-0.5b] [--dtype bf16] [--batch 8] [--prompt-len 512] [--steps 16]

Builds the model at its published width with random weights (seed 0), runs
one prefill and ``--steps`` decode steps twice: once timed by the host
clock around a device synchronise, once under ``torch.profiler``.  Prints
one JSON object: seconds per prefill and per decode step (host clock, no
profiler), the device's busy time per decode step (sum of the kernels' times
under the profiler) and its idle share of the unprofiled step, launches per
decode step, and the kernels and host operators that take the most time.  Needs a card; there is
no CPU mode.
"""
import argparse
import json
import subprocess
import time

import numpy as np
import torch

from repro_torch.configs import get_config
from repro_torch.models.model import build_model
from repro_torch.models.params import split_params, tree_map
from repro_torch.models.runtime import Runtime
from repro_torch.serve.serve_step import greedy_sample, make_decode_step, make_prefill_step


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="qwen2-0.5b")
    ap.add_argument("--dtype", choices=("f32", "bf16"), default="bf16")
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--prompt-len", type=int, default=512)
    ap.add_argument("--steps", type=int, default=16)
    ap.add_argument("--attn-impl", choices=("cuda", "ref"), default="cuda")
    ap.add_argument("--top", type=int, default=12)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise RuntimeError("serve_profile needs an NVIDIA GPU")

    cfg = get_config(args.arch)
    model = build_model(cfg)
    rt = Runtime(compute_dtype=args.dtype, attn_impl=args.attn_impl)
    gen = torch.Generator(device="cuda")
    gen.manual_seed(0)
    params, _ = split_params(model.init(gen))
    params = tree_map(lambda a: a.to(rt.dtype()), params)
    prefill, decode = make_prefill_step(model, rt), make_decode_step(model, rt)
    B, S = args.batch, args.prompt_len
    toks = torch.from_numpy(
        np.random.default_rng(0).integers(0, cfg.vocab_size, (B, S)).astype(np.int32)).cuda()

    def wave(steps):
        cache, _ = split_params(model.init_cache(B, S + steps + 1, device="cuda"))
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        logits, cache = prefill(params, {"tokens": toks}, cache)
        tok = greedy_sample(logits)
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        for _ in range(steps):
            logits, cache = decode(params, tok, cache)
            tok = greedy_sample(logits)
        torch.cuda.synchronize()
        return t1 - t0, (time.perf_counter() - t1) / steps

    wave(2)  # warm-up: builds, Triton compilation, cuBLAS handles
    prefill_s, step_s = wave(args.steps)

    cache, _ = split_params(model.init_cache(B, S + args.steps + 1, device="cuda"))
    logits, cache = prefill(params, {"tokens": toks}, cache)
    tok = greedy_sample(logits)
    torch.cuda.synchronize()
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    t0 = time.perf_counter()
    with torch.profiler.profile(activities=acts) as prof:
        for _ in range(args.steps):
            logits, cache = decode(params, tok, cache)
            tok = greedy_sample(logits)
        torch.cuda.synchronize()
    profiled_step_s = (time.perf_counter() - t0) / args.steps

    def dev_us(e):
        return float(getattr(e, "self_device_time_total", getattr(e, "self_cuda_time_total", 0.0)))

    avgs = prof.key_averages()
    # device-side events only: an operator's row repeats its kernels' time
    kernels = [e for e in avgs
               if e.device_type == torch.autograd.DeviceType.CUDA and dev_us(e) > 0]
    busy_us = sum(dev_us(e) for e in kernels)
    launches = sum(e.count for e in kernels)
    top_dev = sorted(kernels, key=dev_us, reverse=True)[: args.top]
    top_host = sorted(avgs, key=lambda e: e.self_cpu_time_total, reverse=True)[: args.top]
    gpu = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip().splitlines()[0]
    print(json.dumps({
        "gpu": gpu, "arch": cfg.name, "dtype": args.dtype, "attn_impl": args.attn_impl,
        "batch": B, "prompt_len": S, "decode_steps": args.steps,
        "prefill_seconds": prefill_s, "decode_step_seconds": step_s,
        "decode_tokens_per_second": B / step_s,
        "profiled_decode_step_seconds": profiled_step_s,
        "device_busy_seconds_per_decode_step": busy_us / 1e6 / args.steps,
        # against the step as timed without the profiler, whose own cost
        # stretches the profiled step many times over
        "device_idle_share_of_decode_step": 1.0 - busy_us / 1e6 / args.steps / step_s,
        "device_launches_per_decode_step": launches / args.steps,
        "top_device": [{"name": e.key[:80], "count_per_step": e.count / args.steps,
                        "device_us_per_step": dev_us(e) / args.steps} for e in top_dev],
        "top_host": [{"name": e.key[:80], "count_per_step": e.count / args.steps,
                      "self_cpu_us_per_step": e.self_cpu_time_total / args.steps}
                     for e in top_host],
    }))


if __name__ == "__main__":
    main()
