"""Where a served prefill's and decode step's time goes on the GPU, eager
and compiled (the PyTorch/CUDA port).

    PYTHONPATH=src python -m repro_torch.launch.serve_profile \
        [--arch qwen2-0.5b] [--dtype bf16] [--batch 8] [--prompt-len 512] [--steps 16]

Builds the model at its published width with random weights (seed 0),
prefills one batch of random prompts, and decodes ``--steps`` greedy
tokens from that one prefill through both decode paths in turn: the eager
step (``make_decode_step``) and the compiled one
(``make_graphed_decode_step``, one CUDA graph replayed a token).  Each
path runs from an equal copy of the prefilled cache three times: once
keeping every step's logits (the two paths must agree bit for bit), once
timed by the host clock between two device synchronises, once under
``torch.profiler``.  Prints one JSON object: the prefill's seconds, and
for each path the seconds a decode step, decode tokens/s, the device's busy
time a step (its kernels' times under the profiler) and its idle share of
the unprofiled step, the launches a step (all kernels under the
profiler, and the hand-written ones by their counters), the peak device bytes,
the kernels and host operators that take the most time, and whether the
paths' tokens and logits are equal.  For the compiled path the graph's
span on the device (CUDA events around each replay) is reported too.
The prefill is run the same way through both of its paths
(``make_prefill_step`` and ``make_graphed_prefill_step``) from one zeroed
cache (``prefill_paths``): seconds a prefill, busy time, idle share,
launches and peak bytes, and whether the logits and every cache leaf are
equal; for the compiled path also the first (eager) call's and the
capturing call's seconds.
Needs a card; there is no CPU mode.
"""
import argparse
import json
import statistics
import subprocess
import time

import numpy as np
import torch

from repro_torch.configs import get_config
from repro_torch.launch.serve import frontend_inputs, runtime
from repro_torch.models.model import build_model
from repro_torch.models.params import split_params, tree_leaves
from repro_torch.models.runtime import Runtime
from repro_torch.serve.serve_step import (greedy_sample, kernel_counters, make_decode_step,
                                          make_graphed_decode_step, make_graphed_prefill_step,
                                          make_prefill_step, reset_cache)

PATHS = {"eager": make_decode_step, "graphed": make_graphed_decode_step}
PREFILL_PATHS = {"eager": make_prefill_step, "graphed": make_graphed_prefill_step}


def _dev_us(e):
    return float(getattr(e, "self_device_time_total", getattr(e, "self_cuda_time_total", 0.0)))


def _profile(run, steps, top):
    """Busy device seconds, kernel launches and the top kernels / host
    operators of ``run()`` (``steps`` decode steps) under the profiler."""
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        run()
        torch.cuda.synchronize()
    avgs = prof.key_averages()
    # device-side events only: an operator's row repeats its kernels' time
    kernels = [e for e in avgs
               if e.device_type == torch.autograd.DeviceType.CUDA and _dev_us(e) > 0]
    top_dev = sorted(kernels, key=_dev_us, reverse=True)[:top]
    top_host = sorted(avgs, key=lambda e: e.self_cpu_time_total, reverse=True)[:top]
    return {
        "busy_s": sum(_dev_us(e) for e in kernels) / 1e6 / steps,
        "launches": sum(e.count for e in kernels) / steps,
        "top_device": [{"name": e.key[:80], "count_per_step": e.count / steps,
                        "device_us_per_step": _dev_us(e) / steps} for e in top_dev],
        "top_host": [{"name": e.key[:80], "count_per_step": e.count / steps,
                      "self_cpu_us_per_step": e.self_cpu_time_total / steps}
                     for e in top_host],
    }


def decode_paths(model, params, rt: Runtime, batch, steps: int, *, profile_steps: int = 16,
                 top: int = 12):
    """Both decode paths from one prefill of ``batch``, ``steps`` greedy
    tokens each, on the card.  Returns ``(report, kept)``: ``report`` the
    numbers described in the module docstring, ``kept[path]`` the logits of
    every step (clones) and the greedy tokens (the prefill's first)."""
    tokens = batch["tokens"]
    B, S = tokens.shape
    dev = tokens.device
    cache_len = S + steps + 1
    prefill = make_prefill_step(model, rt)
    snap, _ = split_params(model.init_cache(B, cache_len, device=dev))
    prefill(params, batch, snap)  # warm-up: first launches, Triton compilation
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    logits0, snap = prefill(params, batch, snap)
    torch.cuda.synchronize()
    prefill_s = time.perf_counter() - t0
    tok0 = greedy_sample(logits0)
    report = {"batch": B, "prompt_len": S, "decode_steps": steps,
              "profiled_steps": profile_steps, "prefill_seconds": prefill_s, "paths": {}}
    kept = {}
    for name, make in PATHS.items():
        decode = make(model, rt)
        cache, _ = split_params(model.init_cache(B, cache_len, device=dev))
        spans = []

        def run(n, keep=False, span=False):
            for dst, src in zip(tree_leaves(cache["layers"]), tree_leaves(snap["layers"])):
                dst.copy_(src)
            c = {"pos": snap["pos"], "layers": cache["layers"]}
            tok, logits_l, toks = tok0, [], [tok0]
            for _ in range(n):
                if span:
                    e0, e1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
                    e0.record()
                logits, c = decode(params, tok, c)
                if span:
                    e1.record()
                    spans.append((e0, e1))
                tok = greedy_sample(logits)
                if keep:
                    logits_l.append(logits.clone())
                    toks.append(tok)
            return logits_l, toks

        kept[name] = run(steps, keep=True)  # the compiled path captures at its second step
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        counted = [c.launches for c in kernel_counters()]
        t0 = time.perf_counter()
        run(steps)
        torch.cuda.synchronize()
        step_s = (time.perf_counter() - t0) / steps
        counted = {c.__name__: (c.launches - n) / steps
                   for c, n in zip(kernel_counters(), counted)}
        peak = int(torch.cuda.max_memory_allocated())
        prof = _profile(lambda: run(profile_steps), profile_steps, top)
        row = {"decode_step_seconds": step_s, "decode_tokens_per_second": B / step_s,
               "device_busy_seconds_per_decode_step": prof["busy_s"],
               # against the step as timed without the profiler, whose own
               # cost stretches the profiled step
               "device_idle_share_of_decode_step": 1.0 - prof["busy_s"] / step_s,
               "device_launches_per_decode_step": prof["launches"],
               # the hand-written kernels' own counters (a replay adds its share)
               "kernel_launches_per_decode_step": counted,
               "peak_memory_bytes": peak,
               "top_device": prof["top_device"], "top_host": prof["top_host"]}
        if name == "graphed":
            run(profile_steps, span=True)
            torch.cuda.synchronize()
            row["graph_span_seconds_per_decode_step"] = (
                sum(a.elapsed_time(b) for a, b in spans) / 1e3 / len(spans))
        report["paths"][name] = row
        del decode, cache
    (le, te), (lg, tg) = kept["eager"], kept["graphed"]
    report["tokens_equal"] = all(torch.equal(a, b) for a, b in zip(te, tg))
    report["logits_equal_per_step"] = [bool(torch.equal(a, b)) for a, b in zip(le, lg)]
    return report, kept


def prefill_paths(model, params, rt: Runtime, batch, cache_len: int, *, reps: int = 5,
                  top: int = 12):
    """Both prefill paths, each on a cache of its own zeroed before its
    first call, on the card.  Returns ``(report, kept)``: ``report`` the
    numbers described in the module docstring (seconds: the median of
    ``reps`` prefills, each between two device synchronises), ``kept[path]``
    the logits and cache leaves (clones) of a prefill from a zeroed cache,
    for the compiled path one that replayed its graph."""
    B, S = batch["tokens"].shape
    dev = batch["tokens"].device
    report = {"batch": B, "prompt_len": S, "cache_len": cache_len, "reps": reps, "paths": {}}
    kept = {}
    for name, make in PREFILL_PATHS.items():
        prefill = make(model, rt)
        cache, _ = split_params(model.init_cache(B, cache_len, device=dev))

        def timed():
            fresh = reset_cache(cache)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = prefill(params, batch, fresh)
            torch.cuda.synchronize()
            return out, time.perf_counter() - t0

        # eager: a warm-up; compiled: the eager call, then the capture + a replay
        (_, first_s), (_, second_s) = timed(), timed()
        (logits, c), _ = timed()
        kept[name] = (logits.clone(), [t.clone() for t in tree_leaves(c["layers"])])
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        counted = [k.launches for k in kernel_counters()]
        secs = [timed()[1] for _ in range(reps)]
        counted = {k.__name__: (k.launches - n) / reps
                   for k, n in zip(kernel_counters(), counted)}
        peak = int(torch.cuda.max_memory_allocated())
        step_s = statistics.median(secs)
        # the prefill alone: its work does not depend on what the cache holds
        prof = _profile(lambda: [prefill(params, batch, {"pos": 0, "layers": cache["layers"]})
                                 for _ in range(reps)], reps, top)
        row = {"prefill_seconds": step_s, "prefill_seconds_each": secs,
               "prefill_tokens_per_second": B * S / step_s,
               "device_busy_seconds_per_prefill": prof["busy_s"],
               "device_idle_share_of_prefill": 1.0 - prof["busy_s"] / step_s,
               "device_launches_per_prefill": prof["launches"],
               "kernel_launches_per_prefill": counted, "peak_memory_bytes": peak,
               "top_device": prof["top_device"], "top_host": prof["top_host"]}
        if name == "graphed":
            row.update(first_call_seconds=first_s, capture_call_seconds=second_s)
        report["paths"][name] = row
        del prefill, cache, c, logits
    (le, ce), (lg, cg) = kept["eager"], kept["graphed"]
    report["logits_equal"] = bool(torch.equal(le, lg))
    report["cache_leaves_equal"] = len(ce) == len(cg) and all(
        torch.equal(a, b) for a, b in zip(ce, cg))
    return report, kept


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
    rt = runtime(args.attn_impl == "cuda", args.dtype)  # "ref": the oracles on the card
    gen = torch.Generator(device="cuda")
    gen.manual_seed(0)
    params, _ = split_params(model.init(gen, dtype=rt.dtype()))
    toks = torch.from_numpy(np.random.default_rng(0).integers(
        0, cfg.vocab_size, (args.batch, args.prompt_len)).astype(np.int32)).cuda()
    batch = {"tokens": toks, **frontend_inputs(cfg, args.batch, toks.device)}
    prefill, _ = prefill_paths(model, params, rt, batch, args.prompt_len + args.steps + 1,
                               top=args.top)
    report, _ = decode_paths(model, params, rt, batch, args.steps,
                             profile_steps=args.steps, top=args.top)
    gpu = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip().splitlines()[0]
    print(json.dumps({"gpu": gpu, "arch": cfg.name, "dtype": args.dtype,
                      "attn_impl": args.attn_impl, "prefill": prefill, **report}))


if __name__ == "__main__":
    main()
