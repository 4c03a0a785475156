#!/usr/bin/env python3
"""Quickest proof that the PyTorch/CUDA port starts on an NVIDIA GPU.

    python3 chip_smoke.py            # all phases, needs one card
    python3 chip_smoke.py --phases env,build,kernels
    python3 chip_smoke.py --phases env,build,bo,service
    python3 chip_smoke.py --phases env,build,families
    python3 chip_smoke.py --phases env,build,train,paper,host_knobs
    python3 chip_smoke.py --phases env,build,roofline
    python3 chip_smoke.py --phases env,build,multichip
    python3 chip_smoke.py --phases env,build,train_families
    python3 chip_smoke.py --phases env,build,serve,graphs

Builds the hand-written kernels from the sources in this checkout, holds
each against its plain PyTorch version on the card, then serves
``qwen2-0.5b`` at its published width through the port's normal entry point
(``repro_torch.launch.serve``, whose prefill and decode step are each one
CUDA graph, replayed a wave and a token) and checks, by the kernels'
launch counts, that the served path really went through them.  Where the
reference compiles a step with ``jax.jit``, the port on the card replays
a CUDA graph: the served prefill and decode, the trainer's step and the
tuner's measured step.  The ``graphs`` phase prefills and decodes
qwen2-0.5b at its published width (and rwkv6-3b, minicpm3-4b and
whisper-base at the ``families`` phase's sizes) through the eager and
the compiled steps (``repro_torch.launch.serve_profile.prefill_paths``,
each from a zeroed cache, and ``decode_paths``, from one prefill): the
prefills' logits and cache leaves, and the decodes' tokens and every
step's logits, must be equal bit for bit; it reports both paths'
seconds, idle share, launches and peak bytes.  The ``sweep`` phase closes
the tuning loop: it tunes all five kernels at full-width shapes
(``repro_torch.benchmarks.kernel_sweep``), persists the answers in a
``TuningDB``, re-runs warm (nothing is measured again) and serves the model
with the DB, checking that the served kernels ran with the swept tiles.
The ``train`` phase trains ``qwen2-0.5b`` at its published width and
depth through ``repro_torch.launch.train`` (K1 and K2 forward, their
oracles backward), eagerly twice and through the compiled step: the
compiled losses and params must equal the eager ones bit for bit (or
stay within the eager runs' own spread), and every learning rate the
eager one; it checks that the loss falls, that the remat modes and
microbatching agree, and that failure + resume through the array
checkpointer replays the loss stream, all through the compiled step.
The ``sweep`` phase also holds each kernel's compiled measured step to
its eager one (equal output, both step times), and ``paper`` forces a
point that does not fit the card through the compiled evaluator.
The ``bo`` phase runs the same loop with Bayesian optimisation, recording
every measurement into a transfer corpus, times one GP fit + ranking
on the CPU and on the card, and runs the port's async-loop gate
(``perf_iterations --async-loop --check``) as a child; the ``service``
phase starts a measurement worker on the card and the tuning service as
processes of their own and runs one BO job through them.  The ``families`` phase runs the other
model families at full width (rwkv6-3b, one period of Jamba v0.1,
minicpm3-4b, whisper-base) through the kernels, K4 and K5 included,
against the oracle path on the same weights, and serves three of them
through ``repro_torch.launch.serve``.  The ``paper`` phase runs the paper's
experiment on the card: BO, GA and Nelder-Mead tune the measured training
throughput of ``dense_lm`` (qwen2-0.5b at full width and depth) through
``repro_torch.examples.quickstart``, then GA the other four workloads
(qwen3-MoE and RWKV-6 at full width, depth cut; the convnet and NCF at the
reference's sizes).  The ``host_knobs`` phase measures K1 in fresh child
processes at two thread counts (``KernelTuneEvaluator(allow_subprocess=
True)``).  The ``roofline`` phase runs the dry run for one card
(``repro_torch.launch.dryrun``: qwen2-0.5b traced on ``meta`` tensors) and
the tuning CLI over it (``repro_torch.launch.tune``, BO and GA), measures
the card's copy and matmul rates beside the data sheet's, and runs three
steps of qwen2-0.5b on the card beside their dry runs: peak bytes against
``max_memory_allocated``, step seconds against the roofline's estimate.
The ``multichip`` phase runs the dry run and the tuning CLI at a 256-chip
pod and across two pods (device-free: DTensors over a fake process group,
on this host), and expert parallelism on the card through a one-rank NCCL
group (``repro_torch.benchmarks.ep_forward``), each part in a child process.
The ``train_families`` phase trains the two scan families through
``repro_torch.launch.train``, f32, 2 x 2048 tokens: rwkv6-3b at its
published width, 16 of its 32 layers (K1 and K5 forward) and one Jamba v0.1 period at
the width of the reference's ``--d-model 1024`` (K1, K2 and K4 forward),
each under the cheapest remat mode that fits: falling loss, launches,
step time, peak bytes, the forward / backward / optimizer split with the
scans' oracle recompute, each scan call against its plain version, and
the kernel path against the chunked oracles.
Each phase prints JSON lines; any failure
ends the run with a non-zero exit code.  The last line is
``{"ok": true, "device": {...}}``.

There is no CPU mode: without a card the script fails at once.
"""
import argparse
import contextlib
import io
import json
import math
import os
import re
import shutil
import subprocess
import sys
import time
import types

HERE = os.path.dirname(os.path.abspath(__file__))

# the card's published peaks (NVIDIA H100 SXM data sheet, dense rates)
PEAK_BYTES_PER_S = 3.35e12
PEAK_FLOPS = {"bf16": 989e12, "f32": 67e12}

# absolute = relative tolerance, or (absolute, relative): the reference tests'
TOL = {
    "flash_attention": {"f32": 2e-5, "bf16": 2e-2},
    "decode_attention": {"f32": 2e-5, "bf16": 2e-2},
    "rmsnorm": {"f32": 1e-5, "bf16": 2e-2},
    "ssm_scan": {"f32": 2e-4, "bf16": 2e-2},
    "gla_scan": {"f32": (2e-4, 2e-3), "bf16": 2e-2},
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

# B, S, D, N, chunk, block_d — the reference's ssm table, then ragged and
# clamped knobs, a state size that is padded, the largest state size; then
# the lane split (8 states a lane: 1, 2, 4, 8 lanes) and every group split
# (1 to 32 blocks a group), a D that is no multiple of block_d inside a split
# group, N = 1 and 64, one step a chunk, fewer steps than one group of steps
SSM_CASES = [
    (1, 16, 8, 4, 8, 8),
    (2, 50, 12, 8, 16, 8),
    (1, 33, 24, 16, 8, 16),
    (2, 64, 16, 4, 32, 4),
    (2, 300, 600, 16, 128, 256),
    (1, 40, 70, 5, 16, 32),
    (1, 24, 40, 64, 8, 256),
    (1, 20, 33, 33, 1000, 1000),
    (2, 40, 600, 4, 16, 8),        # groups of 1
    (2, 64, 8192, 16, 32, 128),    # groups of 4
    (2, 30, 8192, 16, 128, 256),   # groups of 8, the sweep's widths
    (1, 20, 8192, 16, 128, 256),   # groups of 16, one sequence
    (1, 50, 1001, 32, 32, 256),    # 4 lanes, the last group ragged inside a block
    (2, 40, 100, 1, 16, 32),       # N = 1
    (2, 70, 300, 64, 64, 128),     # N = 64
    (1, 30, 64, 16, 1, 64),        # chunk 1
    (1, 5, 64, 16, 128, 64),       # S < one group of steps
]
# B, S, H, dk, dv, chunk — the reference's gla table, then a padded key dim,
# a value dim split over blocks, the largest key dim, one step a chunk; then
# every lane count (dk 8 to 128: 2 to 32 lanes; 8 rows a lane, 4 for a
# block of one warp or alone on its SM) and every column split (64, 32, 16, 8 columns a block, the
# last block ragged), fewer steps than one group of steps
GLA_CASES = [
    (1, 16, 2, 8, 8, 8),
    (2, 45, 3, 8, 8, 16),
    (1, 40, 4, 16, 16, 8),
    (2, 70, 3, 24, 40, 32),
    (1, 33, 2, 64, 600, 16),       # 8 columns a block
    (1, 50, 2, 128, 64, 64),
    (1, 30, 1, 8, 8, 1),
    (2, 20, 70, 8, 70, 16),        # 64 columns a block, ragged
    (2, 20, 40, 16, 50, 16),       # 32 columns a block, ragged
    (2, 30, 40, 64, 64, 64),       # 32 columns a block, the sweep's widths
    (1, 20, 40, 64, 64, 64),       # 16 columns a block, one sequence
    (1, 20, 2, 16, 100, 128),      # 64 columns a block, two blocks, ragged
    (1, 40, 3, 128, 72, 32),       # dk 128, 64 columns a block, ragged
    (1, 5, 2, 64, 64, 64),         # S < one group of steps
    (1, 300, 2, 64, 64, 128),      # a block alone on its SM: twice the lanes
]
# B, S, H, dk, dv — K5's gradient (chunk from bwd_chunk): S a multiple of the
# tile's chunk, not a multiple, shorter than one; the widest state; a value
# width not a multiple of 4; the training cell's shape, and it ragged
GLA_BWD_CASES = [
    (2, 64, 3, 8, 8),
    (2, 45, 2, 8, 12),
    (3, 5, 2, 16, 8),
    (1, 100, 3, 128, 128),
    (2, 70, 2, 64, 42),
    (2, 2048, 40, 64, 64),
    (2, 2001, 40, 64, 64),
]
GLA_BWD_SHAPE = (2, 2048, 40, 64, 64)  # rwkv6-3b-8l.train-2x2048
# each gradient within this share of its largest |value|: f32 sums over
# 2,048 steps whose states reach ~2,600; a bf16 gradient carries 2^-9 of
# its own size (tests/test_torch_gla_scan_bwd.py)
GLA_BWD_TOL = {"f32": 2e-5, "bf16": 1e-2}
GLA_BWD_GRADS = ("dr", "dk", "dv", "dw", "du")
# K5 storing its final state (``gla_scan_state``, the served prefill's):
# f32 or bf16 r, k, v beside an f32 decay; B, S, H, dk, dv, chunk, S a
# multiple of the staging depth and not
GLA_STATE_CASES = [
    (2, 256, 5, 64, 64, 64),
    (3, 301, 4, 64, 64, 64),
    (2, 77, 3, 32, 40, 16),
    (1, 50, 2, 128, 64, 32),
    (2, 45, 3, 8, 8, 16),
    (1, 33, 2, 20, 24, 16),  # bf16 rows of 40 bytes: staged by plain loads
]
# rwkv6-3b.serve-chat's prefill: a wave of 64 prompts padded to 2,048, bf16
GLA_STATE_SHAPE = (64, 2048, 40, 64, 64)
# y within the gla_scan tolerance of its type; the f32 state within 2e-5 of
# its largest |value| (f32 sums over up to 2,048 steps)
GLA_STATE_TOL = 2e-5
# the splits the cases above must cover
SSM_COVER = {"lanes": {1, 2, 4, 8}, "groups": {1, 2, 4, 8, 16, 32}}
GLA_COVER = {"lanes": {2, 4, 8, 16, 32}, "cols": {8, 16, 32, 64}}
# the H100's maximum boost clock, for the SFU bound (16 exponentials a
# clock an SM)
SM_CLOCK_HZ = 1.98e9
SFU_PER_SM_CLOCK = 16

SERVE_ARGS = ["--arch", "qwen2-0.5b", "--no-reduced", "--dtype", "bf16",
              "--requests", "16", "--prompt-len", "512", "--gen-len", "64",
              "--batch", "8"]

# the sweep: all five kernels at the full width of models the repo supports
SWEEP_SHAPES = {
    # Jamba v0.1's Mamba mixer: d_inner = 2 x 4096, d_state 16
    "ssm_scan": {"B": 2, "S": 2048, "D": 8192, "N": 16},
    # RWKV-6 3B: d_model 2560 in heads of 64
    "gla_scan": {"B": 2, "S": 2048, "H": 40, "dk": 64, "dv": 64},
    # qwen2-0.5b served: prefill of a wave, decode against its cache, the
    # prefill's norms
    "flash_attention": {"B": 8, "Sq": 512, "Sk": 512, "H": 14, "K": 2, "dh": 64},
    "decode_attention": {"B": 8, "H": 14, "K": 2, "dh": 64, "Smax": 576},
    "rmsnorm": {"rows": 4096, "D": 896},
}
SWEEP_ARGS = {"algorithm": "ga", "budget": 8, "seed": 0}
# the same loop with the paper's best engine: BO, budget 12 capped at each grid
# (LHS points + GP-ranked asks at these shapes: K1 5 + 5, K2 8 + 4, K3 3 + 4,
# K4 8 + 4, K5 4 + 5)
BO_ARGS = {"algorithm": "bo", "budget": 12, "seed": 0}
# one GP fit + acquisition ranking, timed on the host's CPU and on the card
BO_GP_ROWS = (8, 32, 128)
BO_GP_CANDIDATES = 4096
# the service phase: one BO job over ssm_scan's feasible space (77 points at
# the sweep shape), through a worker process on the card
SERVICE_BUDGET = 8
# training: qwen2-0.5b at its published width and depth, f32, batch 8 x 512
# tokens (the served prefill's shape, where K2's f32 times are taken), the
# reference script's learning rate and warm-up; then each remat mode, two
# microbatches, and failure + resume at full width and 2 layers (a
# checkpoint of ~2 GB): a checkpoint every 2 steps and a failure at step 3,
# restored from the checkpoint taken before step 2, which then runs again
TRAIN_ARGS = ["--arch", "qwen2-0.5b", "--batch", "8", "--seq", "512", "--lr", "1e-3"]
TRAIN_STEPS = 12
# the eager step's median when this training path was first measured on
# the card (PERF.md, §6), printed beside the compiled step's
TRAIN_FIRST_EAGER_MEDIAN = 0.41496
TRAIN_PROFILE_STEPS = 3  # steps of the compiled and of the eager step under the profiler
REMAT_STEPS = 2          # two steps: the compiled step's second is its first replay
RESUME_ARGS = ["--layers", "2", "--steps", "6"]
RESUME_FAIL_ARGS = ["--checkpoint-every", "2", "--inject-failure", "3"]
RESUME_REPLAYED = 2  # the step run twice: before the failure and after the restore
# served in f32, the type the sweep measured (a TuningDB key has no type)
SWEEP_EAGER_STEPS = 8  # eager calls of a kernel's default point (the evaluator's cap)
SWEEP_SERVE_ARGS = ["--arch", "qwen2-0.5b", "--no-reduced", "--dtype", "f32",
                    "--requests", "8", "--prompt-len", "512", "--gen-len", "64",
                    "--batch", "8"]


# the paper's experiment: dense_lm (qwen2-0.5b, full width and depth) at 512
# tokens a sequence, f32, each engine at budget 8 (seed 0); the other workloads
# 4 points each (GA, seed 0), the two language models at full width with their
# depth cut so that a step's weights, grads and AdamW state fit beside the
# activations of batch 16
PAPER_SEQ = 512
PAPER_BUDGET = 8
PAPER_SMALL_BUDGET = 4
PAPER_LAYERS = {"moe_lm": 2, "rwkv": 4}  # cut from 48 and 32
# the point the cross-check and the parity check run: the train phase's
# batch, tile (64 x 64 in f32) and remat
PAPER_CHECK_POINT = {"batch": 8, "microbatches": 1, "remat": "none", "block_q": 64}
# a point far past the card's memory (the train phase's batch 8 peaks near
# 28 GB in f32): it must score -inf with ``oom`` in its meta
PAPER_OOM_POINT = {"batch": 128, "microbatches": 1, "remat": "none", "block_q": 64}
# dense_lm's best tokens/s of the three engines when the measured step ran
# eagerly (PERF.md, §6)
PAPER_EAGER_BEST = (10391, 10429)
PAPER_STEP_RTOL = 0.15   # its step time against the train phase's median step
PAPER_LOSS_RTOL = 1e-4   # its loss on the kernel path against the oracle path
# host knobs: K1 at its sweep shape in a child process a thread count
HOST_THREADS = (1, 8)

# the roofline phase: qwen2-0.5b's dry runs for one card, the tuning CLI over
# them, and three of its steps measured on the card beside their dry runs
ROOFLINE_ARCH = "qwen2-0.5b"
ROOFLINE_POINTS = {"mb16_dots_bq256": {"microbatches": 16, "remat": "dots", "block_q": 256},
                   "mb4_none_bq1024": {"microbatches": 4, "remat": "none", "block_q": 1024,
                                       "block_kv": 1024}}
ROOFLINE_BUDGET = 8
ROOFLINE_CHECKS = (("train", 8, 512), ("prefill", 8, 512), ("decode", 128, 32768))
ROOFLINE_MEM_BAND = (0.8, 1.25)  # the dry run's peak bytes over max_memory_allocated
ROOFLINE_STEPS = 5               # timed steps a check point (median)
# bf16 train loss, kernel path against the chunked path: 2.4e-5 measured on
# the H100, 1e-3 leaves ~40x that for the host's reduction order
ROOFLINE_LOSS_RTOL = 1e-3
# bf16 logits, kernel path against the chunked path, and each K3 launch of a
# decode step against its plain version: bf16 ulps of the largest |value|
ROOFLINE_ULPS = 8
COPY_BYTES = 2 << 30             # device-to-device copy of 2 GiB
MATMUL_N = 8192                  # bf16 matmul of 8192^3

# the multichip phase: dry runs at the reference's 256-chip pod (device-free)
MULTICHIP_CELLS = ("qwen2_train", "qwen3_moe_train", "deepseek_decode")
MULTICHIP_CHIPS = 256
MULTICHIP_BUDGET = 8
MULTICHIP_EP = {"arch": "qwen3-moe-30b-a3b", "layers": 2, "batch": 2, "seq": 512,
                "dtype": "bf16"}
MULTICHIP_TIMEOUT = 540          # seconds a child of the phase may take
# the one failure the port's layout has where the reference's has none: a
# device's batch that the microbatch count does not divide (dp * microbatches
# above the batch; train/train_step.py MicrobatchSplitError).  Of the §Perf
# variants only qwen2_train's H5 (dp=256, 2 microbatches of a 256 batch)
MICROBATCH_SPLIT = "MicrobatchSplitError"
MULTICHIP_KNOWN_ERRORS = {("qwen2_train", "H5 ")}


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
    """The reference tests' criterion: |got - want| <= atol + rtol * |want|,
    with ``tol`` either one number for both or ``(atol, rtol)``."""
    import torch

    atol, rtol = tol if isinstance(tol, tuple) else (tol, tol)
    if got.shape != want.shape or got.dtype != want.dtype:
        raise AssertionError(f"{name} {what}: shape/dtype {tuple(got.shape)} {got.dtype} "
                             f"vs {tuple(want.shape)} {want.dtype}")
    g, w = got.float(), want.float()
    if not bool(torch.isfinite(g).all()):
        raise AssertionError(f"{name} {what}: non-finite values")
    bad = (g - w).abs() > atol + rtol * w.abs()
    if bool(bad.any()):
        raise AssertionError(f"{name} {what}: max abs err {max_err(got, want):.3e} "
                             f"exceeds atol={atol} rtol={rtol}")
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
                         "kernels_with_spills": sum(1 for s in spills if s > 0),
                         "families": _ptxas_families(log)}
    emit({"phase": "build", "seconds": round(secs, 2), "built": sorted(logs),
          "dir": str(_build.build_dir()), "ptxas": summary})


def _ptxas_families(log):
    """Registers and spills per kernel template (the ptxas lines of each
    entry function, grouped by the template's name)."""
    fams = {}
    for name, body in re.findall(r"Compiling entry function '(\w+)'.*?\n(.*?)(?=Compiling entry|\Z)",
                                 log, flags=re.S):
        fam = re.search(r"\d+([a-z_0-9]+?_kernel)", name)
        fam = fam.group(1) if fam else name
        regs = re.search(r"Used (\d+) registers", body)
        spill = re.search(r"(\d+) bytes spill stores", body)
        f = fams.setdefault(fam, {"kernels": 0, "registers": [], "spill_store_bytes": []})
        f["kernels"] += 1
        f["registers"].append(int(regs.group(1)) if regs else None)
        f["spill_store_bytes"].append(int(spill.group(1)) if spill else 0)
    return fams


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
    # the bf16 wgmma kernel (fp32: the register-tiled one): block_q 64 and
    # 128, Sq and Sk no multiples of 64, Sk > Sq and Sq > Sk, a window,
    # groups of 1, 2 and 7, dh 64, 128 and a padded 80, every K/V tile size
    for B, Sq, Sk, H, K, dh, causal, window, bq, bkv in (
            (2, 77, 190, 14, 2, 64, True, None, 128, 64),    # Sk > Sq, group 7
            (1, 150, 70, 2, 2, 128, True, None, 64, 32),     # Sq > Sk: rows with nothing
            (1, 257, 257, 7, 1, 128, True, None, 128, 128),  # dh 128, group 7
            (1, 100, 130, 4, 2, 64, False, 20, 64, 16),      # not causal, windowed
            (2, 64, 100, 2, 2, 32, False, None, 64, 128),    # no mask, padded dh 32
            (1, 65, 65, 2, 1, 80, True, 17, 128, 32),        # dh 80 padded to 128, window
            (1, 300, 300, 4, 2, 64, True, None, 64, 128)):   # several tiles, group 2
        cases.append(dict(B=B, Sq=Sq, Sk=Sk, H=H, K=K, dh=dh, dv=dh, causal=causal,
                          window=window, block_q=bq, block_kv=bkv))
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

    checked = {"flash_attention": 0, "decode_attention": 0, "rmsnorm": 0,
               "ssm_scan": 0, "gla_scan": 0, "gla_scan_bwd": 0, "gla_scan_state": 0}
    worst = {k: {"f32": 0.0, "bf16": 0.0} for k in checked}
    routes = {"f32": {}, "bf16": {}}  # flash kernel -> cases it took
    splits = {}  # decode: n_splits -> cases

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
            kern = fla.flash_attention.last_kernel
            want = fla.flash_attention_plain(q, k, v, block_kv=c["block_kv"], **kw)
            torch.cuda.synchronize()
            e = check_close("flash_attention", f"{name} {kern} {c}", got, want, tol)
            worst["flash_attention"][name] = max(worst["flash_attention"][name], e)
            checked["flash_attention"] += 1
            routes[name][kern] = routes[name].get(kern, 0) + 1
        # strided views (a head-major buffer seen as (B, S, H, d)) are read in
        # place: one the mma/fma kernels take, one TMA takes (strides of 8
        # elements), one TMA refuses (a head stride of 68 elements)
        views = (
            ("strided", 16, rand(2, 4, 40, 16, dtype=dt).transpose(1, 2),
             rand(2, 2, 40, 16, dtype=dt).transpose(1, 2),
             rand(2, 2, 40, 16, dtype=dt).transpose(1, 2)),
            ("strided tma", 64, rand(2, 4, 100, 64, dtype=dt).transpose(1, 2),
             rand(2, 2, 100, 64, dtype=dt).transpose(1, 2),
             rand(2, 2, 100, 64, dtype=dt).transpose(1, 2)),
            ("unaligned view", 64, rand(1, 90, 2, 68, dtype=dt)[..., :64],
             rand(1, 90, 1, 68, dtype=dt)[..., :64], rand(1, 90, 1, 68, dtype=dt)[..., :64]))
        for label, bq, qs, ks, vs in views:
            got = fla.flash_attention(qs, ks, vs, block_q=bq, block_kv=bq)
            kern = fla.flash_attention.last_kernel
            e = check_close("flash_attention", f"{name} {label} ({kern})", got,
                            fla.flash_attention_plain(qs, ks, vs), tol)
            worst["flash_attention"][name] = max(worst["flash_attention"][name], e)
            checked["flash_attention"] += 1
            routes[name][kern] = routes[name].get(kern, 0) + 1
            want_kern = {"strided": "mma", "strided tma": "wgmma", "unaligned view": "mma"}[label]
            if name == "bf16" and kern != want_kern:
                raise AssertionError(f"flash_attention: the {label} case ran on {kern}, "
                                     f"not {want_kern}")
    for name, need in (("f32", ("tiled", "fma")), ("bf16", ("wgmma", "mma", "fma"))):
        if any(routes[name].get(k, 0) == 0 for k in need):
            raise AssertionError(f"flash_attention: {name} cases missed a kernel: {routes[name]}")
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
        # the split cache: the served shape's 9 splits with a length shorter
        # than one split, lengths that leave trailing splits empty, length 0
        # beside full lengths; B*K >= 2*SMs (one split); a long cache
        dict(B=8, H=14, K=2, dh=64, Smax=576, lengths=[575, 30, 3, 10, 576, 64, 65, 1],
             block_kv=64),
        dict(B=4, H=14, K=2, dh=64, Smax=576, lengths=[576, 0, 575, 0], block_kv=512),
        dict(B=132, H=4, K=2, dh=64, Smax=64, lengths=[64 - (i % 64) for i in range(132)],
             block_kv=64),
        dict(B=2, H=14, K=2, dh=64, Smax=8192, lengths=[8191, 5000], block_kv=64),
        dict(B=3, H=24, K=2, dh=128, Smax=1000, lengths=[999, 7, 0], block_kv=32),
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
            n_splits = dec.decode_attention.last_splits
            want = dec.decode_attention_plain(q, k, v, lengths)
            torch.cuda.synchronize()
            e = check_close("decode_attention", f"{name} splits={n_splits} {c}", got, want, tol)
            # the plain version cut as the kernel cut it: the merge's arithmetic
            check_close("decode_attention", f"{name} plain splits={n_splits}", got,
                        dec.decode_attention_plain(q, k, v, lengths, n_splits=n_splits), tol)
            splits[n_splits] = splits.get(n_splits, 0) + 1
            if 0 in c["lengths"]:
                b0 = c["lengths"].index(0)
                if not bool((got[b0] == 0).all()):
                    raise AssertionError("decode_attention: empty cache is not exact zeros")
            key = "bf16" if qdt == torch.bfloat16 else "f32"
            worst["decode_attention"][key] = max(worst["decode_attention"][key], e)
            checked["decode_attention"] += 1
    if splits.get(1, 0) == 0 or not any(n > 1 for n in splits):
        raise AssertionError(f"decode_attention: the cases missed the split or unsplit path: {splits}")

    # -- rmsnorm ----------------------------------------------------------------
    for name, dt in dtypes.items():
        tol = TOL["rmsnorm"][name]
        # ragged tiles, one row a program, rows wider than a chunk (walked in
        # chunks of MAX_CHUNK), every width the families run, a persistent
        # grid (more tiles than one wave)
        for shape, br in (((5, 33, 64), 16), ((5, 33, 64), 256), ((7, 100), 1),
                          ((3, 896), 8), ((2, 5, 2560), 4), ((3, 9000), 256),
                          ((9, 768), 256), ((4100, 256), 256), ((65537, 64), 4096),
                          ((3000, 4096), 2)):
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

    # flash: prefill of a wave, B=8, S=512, and a 2k prefill at the same batch
    rows = []
    for (B, S), name in ((bs, n) for bs in ((8, 512), (8, 2048)) for n in dtypes):
        dt = dtypes[name]
        esz = 4 if name == "f32" else 2
        nbytes = (2 * B * S * H * dh + 2 * B * S * K * dh) * esz
        sets = [(rand(B, S, H, dh, dtype=dt), rand(B, S, K, dh, dtype=dt),
                 rand(B, S, K, dh, dtype=dt)) for _ in range(n_sets_for(nbytes))]
        q, k, v = sets[0]
        got = fla.flash_attention(q, k, v, block_q=512, block_kv=512)
        cfg, kern = dict(fla.flash_attention.last_config), fla.flash_attention.last_kernel
        want = fla.flash_attention_plain(q, k, v)
        e = check_close("flash_attention", f"{name} B={B} S={S}", got, want,
                        TOL["flash_attention"][name])
        del got, want
        ms, eager_ms = time_ms(
            lambda q, k, v: fla.flash_attention(q, k, v, block_q=512, block_kv=512), sets)
        ms128, _ = time_ms(
            lambda q, k, v: fla.flash_attention(q, k, v, block_q=128, block_kv=128), sets)
        cfg128 = dict(fla.flash_attention.last_config)
        tiles_ms = {}  # other tiles: all at the served shape, the wgmma ones at 2k
        tiles = ((64, 64), (64, 128), (128, 64), (128, 128), (32, 32), (32, 64), (64, 32))
        for bq, bkv in (tiles if S == 512 else tiles[:4] if name == "bf16" else ()):
            ms_t, _ = time_ms(lambda q, k, v: fla.flash_attention(
                q, k, v, block_q=bq, block_kv=bkv), sets)
            c = fla.flash_attention.last_config
            tiles_ms[f"{c['block_q']}x{c['block_kv']} {fla.flash_attention.last_kernel}"] = ms_t
        # the same queries over one K/V head per query head (no group shares a
        # tile): how much the group's shared K/V tiles matter to the kernel
        mha_sets = [(q, torch.randn_like(q), torch.randn_like(q))
                    for q, _, _ in sets[:n_sets_for(4 * B * S * H * dh * esz)]]
        mha_ms, _ = time_ms(lambda q, k, v: fla.flash_attention(q, k, v, block_q=512,
                                                                block_kv=512), mha_sets)
        del mha_sets
        plain_ms, _ = time_ms(lambda q, k, v: fla.flash_attention_plain(q, k, v), sets[:2],
                              warmup=1, min_iters=2, replays=1)
        lib_sets = [(q.transpose(1, 2), k.repeat_interleave(H // K, dim=2).transpose(1, 2),
                     v.repeat_interleave(H // K, dim=2).transpose(1, 2)) for q, k, v in sets]
        lib_ms, _ = time_ms(
            lambda q, k, v: F.scaled_dot_product_attention(q, k, v, is_causal=True), lib_sets)
        del lib_sets
        live_pairs = S * (S + 1) // 2
        flops = B * H * live_pairs * (2 * dh + 2 * dh)
        t_bytes, t_ops = nbytes / PEAK_BYTES_PER_S * 1e3, flops / PEAK_FLOPS[name] * 1e3
        rows.append({"dtype": name, "shape": f"B={B} Sq=Sk={S} H={H} K={K} dh={dh} causal",
                     "config": cfg, "kernel": kern, "max_abs_err": e, "ms": ms,
                     "eager_ms": eager_ms, "ms_block128": ms128, "config_block128": cfg128,
                     "tiles_ms": tiles_ms, "ms_no_gqa_sharing": mha_ms,
                     "plain_ms": plain_ms, "library_ms": lib_ms, "bound_ms": max(t_bytes, t_ops),
                     "bound_by": "bytes" if t_bytes >= t_ops else "operations",
                     "share_of_peak": flops / (ms * 1e-3) / PEAK_FLOPS[name]})
        del sets
    at_main["flash_attention"] = rows

    # decode: one step of a wave, B=8, Smax=576, every sequence at length 575;
    # then long caches (8k, 32k rows) in bf16, and the roofline phase's
    # decode_32k step: B=128 at a 32k cache
    rows = []
    shapes = ([(8, 576, n) for n in combos] + [(8, 8192, "bf16"), (8, 32768, "bf16"),
                                                (128, 32768, "bf16")])
    for B, Smax, name in shapes:
        qdt, kdt = combos[name]
        esz = 2 if kdt == torch.bfloat16 else 4
        length = Smax - 1
        nbytes = 2 * B * length * K * dh * esz + 2 * B * H * dh * (2 if qdt == torch.bfloat16 else 4)
        lengths = torch.full((B,), length, dtype=torch.int32, device=dev)
        sets = [(rand(B, H, dh, dtype=qdt), rand(B, Smax, K, dh, dtype=kdt),
                 rand(B, Smax, K, dh, dtype=kdt), lengths) for _ in range(n_sets_for(nbytes))]
        q, k, v, _ = sets[0]
        got = dec.decode_attention(q, k, v, lengths, block_kv=512)
        cfg, n_splits = dict(dec.decode_attention.last_config), dec.decode_attention.last_splits
        want = dec.decode_attention_plain(q, k, v, lengths)
        e = check_close("decode_attention", f"{name} B={B} Smax={Smax} splits={n_splits}", got,
                        want, TOL["decode_attention"]["bf16" if qdt == torch.bfloat16 else "f32"])
        del got, want
        ms, eager_ms = time_ms(lambda *a: dec.decode_attention(*a, block_kv=512), sets)
        block_kv_ms = {}
        for bkv in (16, 32):
            block_kv_ms[bkv], _ = time_ms(lambda *a: dec.decode_attention(*a, block_kv=bkv), sets)
            block_kv_ms[f"{bkv} splits"] = dec.decode_attention.last_splits
        plain_ms, _ = time_ms(lambda *a: dec.decode_attention_plain(*a), sets[:4],
                              min_iters=4, replays=2)
        mask = (torch.arange(Smax, device=dev)[None, :] < lengths[:, None])[:, None, None, :]
        lib_sets = [(q[:, :, None, :], k.to(qdt).repeat_interleave(H // K, dim=2).transpose(1, 2),
                     v.to(qdt).repeat_interleave(H // K, dim=2).transpose(1, 2))
                    for q, k, v, _ in sets[:4]]
        lib_ms, _ = time_ms(
            lambda q, k, v: F.scaled_dot_product_attention(q, k, v, attn_mask=mask), lib_sets)
        del lib_sets
        flops = B * H * length * 4 * dh
        t_bytes, t_ops = nbytes / PEAK_BYTES_PER_S * 1e3, flops / PEAK_FLOPS["f32" if qdt == torch.float32 else "bf16"] * 1e3
        rows.append({"dtype": name, "shape": f"B={B} Smax={Smax} len={length} H={H} K={K} dh={dh}",
                     "config": cfg, "splits": n_splits, "max_abs_err": e, "ms": ms,
                     "block_kv_ms": block_kv_ms,
                     "eager_ms": eager_ms, "plain_ms": plain_ms, "library_ms": lib_ms,
                     "bound_ms": max(t_bytes, t_ops),
                     "bound_by": "bytes" if t_bytes >= t_ops else "operations"})
        del sets
    at_main["decode_attention"] = rows

    # rmsnorm: prefill rows 8*512 and decode rows 8 at qwen2-0.5b's width; the
    # families' widths at 4096 rows (MLA's kv and q latents 256 and 768,
    # rwkv6-3b / minicpm3-4b 2560, jamba 4096); at the served shape every
    # block_rows of the tuner's space
    from repro_torch.tuning.kernel_objective import kernel_space

    rows = []
    for name, dt in dtypes.items():
        esz = 4 if name == "f32" else 2
        for R, Dn in ((4096, D), (8, D), (4096, 256), (4096, 768), (4096, 2560), (4096, 4096)):
            nbytes = 2 * R * Dn * esz + Dn * 4
            s = rand(Dn, dtype=torch.float32)
            sets = [(rand(R, Dn, dtype=dt), s) for _ in range(n_sets_for(nbytes))]
            x = sets[0][0]
            got = rms.rmsnorm(x, s, 1e-6)
            cfg, geo = dict(rms.rmsnorm.last_config), dict(rms.rmsnorm.last_geometry)
            want = rms.rmsnorm_plain(x, s, 1e-6)
            e = check_close("rmsnorm", f"{name} rows={R} D={Dn}", got, want, TOL["rmsnorm"][name])
            ms, eager_ms = time_ms(lambda x, s: rms.rmsnorm(x, s, 1e-6), sets)
            plain_ms, _ = time_ms(lambda x, s: rms.rmsnorm_plain(x, s, 1e-6), sets)
            s_dt = s.to(dt)
            lib_ms, _ = time_ms(lambda x, s: F.rms_norm(x, (Dn,), s_dt, 1e-6), sets)
            flops = R * Dn * 4
            t_bytes, t_ops = nbytes / PEAK_BYTES_PER_S * 1e3, flops / PEAK_FLOPS["f32"] * 1e3
            row = {"dtype": name, "shape": f"rows={R} D={Dn}", "config": cfg, "geometry": geo,
                   "max_abs_err": e, "ms": ms, "eager_ms": eager_ms,
                   "plain_ms": plain_ms, "library_ms": lib_ms,
                   "bound_ms": max(t_bytes, t_ops),
                   "bound_by": "bytes" if t_bytes >= t_ops else "operations",
                   "share_of_bound": max(t_bytes, t_ops) / ms, "vs_library": ms / lib_ms}
            if (R, Dn) == (4096, D):
                (space,) = kernel_space("rmsnorm", {"rows": R, "D": Dn})
                by_br = {}
                for br in space["choices"]:
                    by_br[br], _ = time_ms(lambda x, s: rms.rmsnorm(x, s, 1e-6, block_rows=br),
                                           sets)
                row["block_rows_ms"] = by_br
                row["block_rows_slowest_over_fastest"] = max(by_br.values()) / min(by_br.values())
            rows.append(row)
            del sets
    at_main["rmsnorm"] = rows

    _scan_kernels(rand, dtypes, checked, worst, at_main)
    torch.cuda.empty_cache()
    _gla_bwd_kernels(rand, dtypes, checked, worst, at_main)
    torch.cuda.empty_cache()
    _gla_state_kernels(rand, dtypes, checked, worst, at_main)
    torch.cuda.empty_cache()
    cx.at_main = at_main
    emit({"phase": "kernels", "gpu": cx.smi, "tolerances": TOL, "cases_checked": checked,
          "worst_abs_err": worst, "flash_routes": routes, "decode_splits": splits,
          "at_main_shapes": at_main,
          "timing": "ms, plain_ms, library_ms: CUDA events around the replay of a CUDA graph "
                    "of >= 20 calls (device time); eager_ms: the same calls run eagerly "
                    "(host launch cost included); inputs rotated through buffers larger than "
                    "the L2 cache"})


def _ssm_f64(x, dt, A, B_in, C_in, D_skip):
    """The selective scan's recurrence in float64, step by step: at S=8192 a
    channel whose decay is within ~1e-4 of 1 sums thousands of steps, so the
    ssm rows report how far the kernel and the plain version each lie from
    the exact answer (``_f64_distances``), beside the check against the
    plain version."""
    import torch

    xd, dtd, Ad, Bd, Cd = (t.double() for t in (x, dt, A, B_in, C_in))
    h = torch.zeros((x.shape[0], x.shape[2], A.shape[1]), dtype=torch.float64, device=x.device)
    y = torch.empty(x.shape, dtype=torch.float64, device=x.device)
    for t in range(x.shape[1]):
        h = torch.exp(dtd[:, t, :, None] * Ad) * h + (dtd[:, t] * xd[:, t])[..., None] * Bd[:, t, None]
        y[:, t] = (h * Cd[:, t, None]).sum(-1)
    return y + xd * D_skip.double()


def _f64_distances(got, plain, exact):
    """The largest distances of the kernel and of the plain version from the
    float64 answer (reported, not checked)."""
    return {"kernel_vs_f64": float((got.double() - exact).abs().max()),
            "plain_vs_f64": float((plain.double() - exact).abs().max())}


def _scan_kernels(rand, dtypes, checked, worst, at_main):
    """The two scans: the reference's tables and the split edge cases
    against the plain versions (and against the plain versions cut as the
    kernel cut them), then the sweep's full-width shapes and one long
    sequence (error, time, plain time, bound, split, blocks against SMs;
    for gla, CUDA's occupancy answer against the split rule's model of it).
    No single PyTorch call computes either scan, so there is no library
    time."""
    import torch
    import torch.nn.functional as F

    from repro_torch.kernels import gla_scan as gla
    from repro_torch.kernels import ssm_scan as ssm
    from repro_torch.kernels._tiles import sm_count

    sms = sm_count(torch.device("cuda"))

    def ssm_args(B, S, D, N, dt):
        # the reference test's distributions
        return (rand(B, S, D, dtype=dt), (rand(B, S, D, dtype=torch.float32).abs() * 0.1).to(dt),
                -rand(D, N, dtype=torch.float32).abs(), rand(B, S, N, dtype=dt),
                rand(B, S, N, dtype=dt), rand(D, dtype=torch.float32))

    def gla_args(B, S, H, dk, dv, dt):
        w = torch.exp(-torch.exp(rand(B, S, H, dk, dtype=torch.float32) * 0.5 - 1.0))
        return (rand(B, S, H, dk, dtype=dt), rand(B, S, H, dk, dtype=dt),
                rand(B, S, H, dv, dtype=dt), w.to(dt), rand(H, dk, dtype=torch.float32))

    def misaligned(t):
        # the same values 4 bytes past a 16-byte boundary: staged by plain loads
        flat = torch.empty(t.numel() + 8, dtype=t.dtype, device=t.device)
        off = 4 // t.element_size()
        view = flat[off:off + t.numel()].view(t.shape)
        view.copy_(t)
        return view

    seen = {"ssm_scan": {"lanes": set(), "groups": set()},
            "gla_scan": {"lanes": set(), "cols": set()}}
    for name, dt in dtypes.items():
        tol = TOL["ssm_scan"][name]
        for i, (B, S, D, N, chunk, block_d) in enumerate(SSM_CASES + [(2, 37, 96, 16, 16, 32)]):
            a = ssm_args(B, S, D, N, dt)
            label = f"{name} B={B} S={S} D={D} N={N} chunk={chunk} block_d={block_d}"
            if i == len(SSM_CASES):  # B and C 4 bytes off a 16-byte boundary
                a = a[:3] + (misaligned(a[3]), misaligned(a[4])) + a[5:]
                label += " misaligned B/C"
            got = ssm.ssm_scan(*a, chunk=chunk, block_d=block_d)
            sp = ssm.ssm_scan.last_split
            want = ssm.ssm_scan_plain(*a)
            torch.cuda.synchronize()
            e = check_close("ssm_scan", f"{label} {sp}", got, want, tol)
            check_close("ssm_scan", f"{label} plain lanes={sp['lanes']}", got,
                        ssm.ssm_scan_plain(*a, lanes=sp["lanes"]), tol)
            worst["ssm_scan"][name] = max(worst["ssm_scan"][name], e)
            checked["ssm_scan"] += 1
            seen["ssm_scan"]["lanes"].add(sp["lanes"])
            seen["ssm_scan"]["groups"].add(sp["groups"])
        tol = TOL["gla_scan"][name]
        for i, (B, S, H, dk, dv, chunk) in enumerate(GLA_CASES + [(1, 37, 3, 64, 64, 16)]):
            a = gla_args(B, S, H, dk, dv, dt)
            label = f"{name} B={B} S={S} H={H} dk={dk} dv={dv} chunk={chunk}"
            if i == len(GLA_CASES):  # r, k, w 4 bytes off a 16-byte boundary
                a = (misaligned(a[0]), misaligned(a[1]), a[2], misaligned(a[3]), a[4])
                label += " misaligned r/k/w"
            got = gla.gla_scan(*a, chunk=chunk)
            sp = gla.gla_scan.last_split
            want = gla.gla_scan_plain(*a)
            torch.cuda.synchronize()
            e = check_close("gla_scan", f"{label} {sp}", got, want, tol)
            check_close("gla_scan", f"{label} plain lanes={sp['lanes']}", got,
                        gla.gla_scan_plain(*a, lanes=sp["lanes"]), tol)
            worst["gla_scan"][name] = max(worst["gla_scan"][name], e)
            checked["gla_scan"] += 1
            seen["gla_scan"]["lanes"].add(sp["lanes"])
            seen["gla_scan"]["cols"].add(sp["cols"])
    for kname, cover in (("ssm_scan", SSM_COVER), ("gla_scan", GLA_COVER)):
        for key, want in cover.items():
            if not want <= seen[kname][key]:
                raise AssertionError(f"{kname}: the cases missed a {key} split: "
                                     f"{sorted(seen[kname][key])} lack {sorted(want)}")

    def at_shape(kname, shape_s, fn, plain, sets, nbytes, flops, name, exps=0, exact=None):
        """Error, time, plain time and bound at one shape.  With ``exact`` (a
        float64 evaluation of the same function), the row also reports both
        versions' distances from it (``_f64_distances``)."""
        got = fn(*sets[0])
        cfg, sp = dict(fn.last_config), dict(fn.last_split)
        want = plain(*sets[0])
        e = check_close(kname, f"{name} {shape_s}", got, want, TOL[kname][name])
        anchored = {} if exact is None else _f64_distances(got, want, exact(*sets[0]))
        del got, want
        ms, eager_ms = time_ms(fn, sets)
        # the plain version is a loop of ~10 small launches per step: one call
        plain_ms, _ = time_ms(plain, sets[:1], warmup=1, min_iters=1, replays=1)
        terms = {"bytes": nbytes / PEAK_BYTES_PER_S * 1e3,
                 "operations": flops / PEAK_FLOPS["f32"] * 1e3}
        if exps:
            terms["exponentials"] = exps / (SFU_PER_SM_CLOCK * sms * SM_CLOCK_HZ) * 1e3
        by = max(terms, key=terms.get)
        ctas = sp.get("ctas", sp.get("blocks"))
        return {"dtype": name, "shape": shape_s, "config": cfg, "split": sp, "ctas": ctas,
                "sms": sms, "max_abs_err": e, "ms": ms, "eager_ms": eager_ms,
                "plain_ms": plain_ms, "library_ms": None, "bound_ms": terms[by],
                "bytes_ms": terms["bytes"], "operations_ms": terms["operations"],
                "sfu_ms": terms.get("exponentials"), "bound_by": by,
                "share_of_bound": terms[by] / ms, **anchored}

    # ssm: the sweep's builder distributions; fp32 arithmetic whatever the
    # input type; the sweep's shape, then one long sequence
    s = SWEEP_SHAPES["ssm_scan"]
    D, N = s["D"], s["N"]
    rows = []
    for (B, S), name in ((bs, n) for bs in ((s["B"], s["S"]), (1, 8192)) for n in dtypes):
        dt = dtypes[name]
        esz = 4 if name == "f32" else 2
        nbytes = (3 * B * S * D + 2 * B * S * N) * esz + (D * N + D) * 4
        flops = 6 * B * S * D * N  # dt*A, dt*x*B, two multiply-adds on the state
        sets = [(rand(B, S, D, dtype=dt), F.softplus(rand(B, S, D, dtype=torch.float32)).to(dt),
                 -torch.exp(rand(D, N, dtype=torch.float32)), rand(B, S, N, dtype=dt),
                 rand(B, S, N, dtype=dt), torch.ones(D, device="cuda"))
                for _ in range(n_sets_for(nbytes))]
        rows.append(at_shape("ssm_scan", f"B={B} S={S} D={D} N={N}", ssm.ssm_scan,
                             ssm.ssm_scan_plain, sets, nbytes, flops, name, exps=B * S * D * N,
                             exact=_ssm_f64 if (S > s["S"] and name == "f32") else None))
        del sets
    at_main["ssm_scan"] = rows

    s = SWEEP_SHAPES["gla_scan"]
    H, dk, dv = s["H"], s["dk"], s["dv"]
    rows = []
    for (B, S), name in ((bs, n) for bs in ((s["B"], s["S"]), (1, 8192)) for n in dtypes):
        dt = dtypes[name]
        esz = 4 if name == "f32" else 2
        nbytes = B * S * H * (3 * dk + 2 * dv) * esz + H * dk * 4
        flops = B * S * H * (4 * dk * dv + 3 * dk + 2 * dv)
        sets = [(rand(B, S, H, dk, dtype=dt), rand(B, S, H, dk, dtype=dt),
                 rand(B, S, H, dv, dtype=dt),
                 torch.exp(-torch.exp(rand(B, S, H, dk, dtype=torch.float32))).to(dt),
                 rand(H, dk, dtype=torch.float32)) for _ in range(n_sets_for(nbytes))]
        cfg = gla.effective_config(128, S, dk, dv)  # the wrapper's default request
        sp = gla.split(B, H, dk, dv, sms, cfg["chunk"])
        # the split rule counts waves with its own model of the blocks an SM
        # holds: CUDA's occupancy answer must not be below it
        resident = gla.resident_blocks(dt, dk, cfg["chunk"], sp["lanes"], sp["cols"])
        rule = gla.resident(cfg["chunk"], dk, sp["cols"], sp["lanes"])
        if resident < rule:
            raise AssertionError(f"gla_scan: CUDA holds {resident} blocks an SM at {sp}, "
                                 f"the split rule counted {rule}")
        rows.append(dict(at_shape("gla_scan", f"B={B} S={S} H={H} dk={dk} dv={dv}",
                                  gla.gla_scan, gla.gla_scan_plain, sets, nbytes, flops, name),
                         resident_per_sm=resident, resident_per_sm_rule=rule))
        del sets
    at_main["gla_scan"] = rows
    for kname in ("ssm_scan", "gla_scan"):
        row = at_main[kname][0]  # f32 at the sweep's shape, the default request
        if row["ctas"] < sms:
            raise AssertionError(f"{kname}: {row['ctas']} blocks at the sweep's shape leave SMs "
                                 f"idle ({sms} SMs)")


def _check_grads(what, got, want, tol):
    """Each of K5's five gradients against the plain version's, within
    ``tol`` of that gradient's largest |value|: the worst absolute error,
    and the worst as a share of its gradient's largest |value|."""
    worst_abs = worst_share = 0.0
    for gname, g, w in zip(GLA_BWD_GRADS, got, want):
        scale = float(w.float().abs().max())
        e = check_close("gla_scan_bwd", f"{what} {gname}", g, w, (tol * scale, 0.0))
        worst_abs = max(worst_abs, e)
        worst_share = max(worst_share, e / scale if scale else 0.0)
    return worst_abs, worst_share


def _gla_bwd_kernels(rand, dtypes, checked, worst, at_main):
    """K5's gradient (``gla_scan_bwd``; no TPU kernel, no library call
    computes it): the cases of ``GLA_BWD_CASES`` against
    ``gla_scan_bwd_plain`` in f32 and bf16, two calls bit for bit, then
    at the training cell's shape in f32 its time beside the bound, the
    plain version's time and that of what it replaced (the chunked
    oracle's forward recomputed and differentiated by autograd), and its
    time at each tile size that fits (``bwd_chunk`` picks one)."""
    import torch

    from repro_torch.kernels import gla_scan as gla
    from repro_torch.kernels import ref

    def args(B, S, H, dk, dv, dt):
        # the card test's distributions: decays from ~1e-5 to ~0.99
        w = torch.exp(-torch.exp(rand(B, S, H, dk, dtype=torch.float32) - 2.0))
        return (rand(B, S, H, dk, dtype=dt), rand(B, S, H, dk, dtype=dt),
                rand(B, S, H, dv, dtype=dt), w.to(dt), rand(H, dk, dtype=torch.float32),
                rand(B, S, H, dv, dtype=dt))

    for name, dt in dtypes.items():
        for case in GLA_BWD_CASES:
            a = args(*case, dt)
            got = gla.gla_scan_bwd(*a)
            label = f"{name} B,S,H,dk,dv={case} chunk={gla.gla_scan_bwd.last_chunk}"
            e, _ = _check_grads(label, got, gla.gla_scan_bwd_plain(*a), GLA_BWD_TOL[name])
            if not all(torch.equal(x, y) for x, y in zip(got, gla.gla_scan_bwd(*a))):
                raise AssertionError(f"gla_scan_bwd {label}: two calls differ")
            worst["gla_scan_bwd"][name] = max(worst["gla_scan_bwd"][name], e)
            checked["gla_scan_bwd"] += 1
            del a, got

    B, S, H, dk, dv = GLA_BWD_SHAPE
    nbytes = 4 * (B * S * H * (6 * dk + 3 * dv) + 2 * H * dk)  # r k w v dy in, 4 out; u, du
    flops = 12 * dk * dv * B * S * H  # the state and its gradient, read for dr dk dv dw
    sets = [args(B, S, H, dk, dv, torch.float32) for _ in range(n_sets_for(nbytes))]
    got = gla.gla_scan_bwd(*sets[0])
    chunk = gla.gla_scan_bwd.last_chunk
    e, share = _check_grads(f"f32 {GLA_BWD_SHAPE}", got, gla.gla_scan_bwd_plain(*sets[0]),
                            GLA_BWD_TOL["f32"])
    del got
    ms, eager_ms = time_ms(gla.gla_scan_bwd, sets)
    chunk_ms = {}
    for c in (8, 16, 32):
        if gla.bwd_smem_bytes(c, dk, dv) <= gla.MAX_SMEM_BYTES:
            chunk_ms[c], _ = time_ms(lambda *x, c=c: gla._launch_bwd(
                *x, c, torch.cuda.current_stream().cuda_stream), sets)

    def oracle(*x):
        xs = [t.detach().requires_grad_(True) for t in x[:5]]
        return torch.autograd.grad(ref.gla_scan_chunked_ref(*xs, chunk=64)[0], xs, x[5])

    # both loop over the chunks in Python: CUDA events around eager calls
    plain_ms = _event_seconds(lambda: gla.gla_scan_bwd_plain(*sets[0]), 3) * 1e3
    oracle_ms = _event_seconds(lambda: oracle(*sets[0]), 3) * 1e3
    terms = {"bytes": nbytes / PEAK_BYTES_PER_S * 1e3,
             "operations": flops / PEAK_FLOPS["f32"] * 1e3}
    by = max(terms, key=terms.get)
    at_main["gla_scan_bwd"] = [{
        "dtype": "f32", "shape": f"B={B} S={S} H={H} dk={dk} dv={dv}", "chunk": chunk,
        "max_abs_err": e, "max_err_share_of_largest": share, "tolerance_share": GLA_BWD_TOL["f32"],
        "ms": ms, "eager_ms": eager_ms, "ms_by_chunk": chunk_ms, "plain_ms": plain_ms,
        "plain_timing": "eager, CUDA events", "oracle_autograd_ms": oracle_ms,
        "library_ms": None, "bound_ms": terms[by], "bytes_ms": terms["bytes"],
        "operations_ms": terms["operations"], "bound_by": by, "share_of_bound": terms[by] / ms}]
    del sets


def _gla_state_kernels(rand, dtypes, checked, worst, at_main):
    """K5 storing its final state (``gla_scan_state``: ``gla_state_kernel``,
    f32 decay; the served prefill's): the cases of ``GLA_STATE_CASES`` in f32
    and bf16 against ``gla_scan_plain(..., final_state=True)``, y and the
    state; two calls bit for bit; ``gla_scan`` on the same inputs at the
    same staging depth gives the same y.  Then ``GLA_STATE_SHAPE`` in bf16 (rwkv6-3b.serve-chat's
    prefill): error, time, plain time, and the bound of
    ``portbench/roofline_served.py`` (operations at the f32 rate, bytes
    over every slot: here nothing is padding)."""
    import torch

    from portbench.roofline_served import k5_state_call
    from repro_torch.kernels import gla_scan as gla

    def args(B, S, H, dk, dv, dt, decay=-3.0):
        w = torch.exp(-torch.exp(rand(B, S, H, dk, dtype=torch.float32) + decay))
        return (rand(B, S, H, dk, dtype=dt), rand(B, S, H, dk, dtype=dt),
                rand(B, S, H, dv, dtype=dt), w, rand(H, dk, dtype=torch.float32),
                torch.empty((B, H, dk, dv), dtype=torch.float32, device="cuda"))

    def share(got, want):
        return float((got.double() - want.double()).abs().max() / want.double().abs().max())

    for name, dt in dtypes.items():
        for case in GLA_STATE_CASES:
            B, S, H, dk, dv, chunk = case
            a = args(B, S, H, dk, dv, dt)
            y = gla.gla_scan_state(*a, chunk=chunk)
            want_y, want_s = gla.gla_scan_plain(*a[:5], final_state=True)
            label = f"{name} B,S,H,dk,dv,chunk={case} {gla.gla_scan_state.last_split}"
            e = check_close("gla_scan_state", f"{label} y", y, want_y, TOL["gla_scan"][name])
            s_share = share(a[5], want_s)
            if s_share > GLA_STATE_TOL:
                raise AssertionError(f"gla_scan_state {label}: state off by {s_share:.3e} of its "
                                     f"largest value (> {GLA_STATE_TOL})")
            again = torch.empty_like(a[5])
            if not (torch.equal(gla.gla_scan_state(*a[:5], again, chunk=chunk), y)
                    and torch.equal(again, a[5])):
                raise AssertionError(f"gla_scan_state {label}: two calls differ")
            depth = gla.gla_scan_state.last_config["chunk"]
            if not torch.equal(gla.gla_scan(*a[:5], chunk=depth), y):
                raise AssertionError(f"gla_scan_state {label}: gla_scan gives another y")
            worst["gla_scan_state"][name] = max(worst["gla_scan_state"][name], e)
            checked["gla_scan_state"] += 1

    B, S, H, dk, dv = GLA_STATE_SHAPE
    flops, nbytes = k5_state_call(B, S, H, dk, dv, "bf16")
    sets = [args(B, S, H, dk, dv, torch.bfloat16, decay=-5.0) for _ in range(n_sets_for(nbytes))]
    y = gla.gla_scan_state(*sets[0])
    cfg, sp = dict(gla.gla_scan_state.last_config), dict(gla.gla_scan_state.last_split)
    want_y, want_s = gla.gla_scan_plain(*sets[0][:5], final_state=True)
    e = check_close("gla_scan_state", f"bf16 {GLA_STATE_SHAPE} y", y, want_y,
                    TOL["gla_scan"]["bf16"])
    s_share = share(sets[0][5], want_s)
    if s_share > GLA_STATE_TOL:
        raise AssertionError(f"gla_scan_state bf16 {GLA_STATE_SHAPE}: state off by "
                             f"{s_share:.3e} of its largest value")
    del y, want_y, want_s
    ms, eager_ms = time_ms(gla.gla_scan_state, sets)
    plain_ms = _event_seconds(lambda: gla.gla_scan_plain(*sets[0][:5], final_state=True), 1) * 1e3
    resident = gla.resident_blocks(torch.bfloat16, dk, cfg["chunk"], sp["lanes"], sp["cols"],
                                   state_kernel=True)
    terms = {"bytes": nbytes / PEAK_BYTES_PER_S * 1e3,
             "operations": flops / PEAK_FLOPS["f32"] * 1e3}
    by = max(terms, key=terms.get)
    at_main["gla_scan_state"] = [{
        "dtype": "bf16", "shape": f"B={B} S={S} H={H} dk={dk} dv={dv}", "w_dtype": "f32",
        "config": cfg, "split": sp, "ctas": sp["blocks"], "resident_per_sm": resident,
        "resident_per_sm_rule": gla.resident(cfg["chunk"], dk, sp["cols"], sp["lanes"]),
        "max_abs_err": e, "state_err_share_of_largest": s_share, "ms": ms,
        "eager_ms": eager_ms, "plain_ms": plain_ms, "plain_timing": "eager, CUDA events",
        "library_ms": None, "bound_ms": terms[by], "bytes_ms": terms["bytes"],
        "operations_ms": terms["operations"], "bound_by": by, "share_of_bound": terms[by] / ms}]
    del sets


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
        report = _serve_report(buf)
        ran = {"flash_attention": flash_attention.last_kernel,
               "flash_config": flash_attention.last_config,
               "decode_splits": decode_attention.last_splits,
               "decode_config": decode_attention.last_config}
        if ran["flash_attention"] != "wgmma" or not ran["decode_splits"] > 1:
            raise AssertionError(f"serve: the served path did not run the redesigned kernels: {ran}")
        if counts != expected:
            raise AssertionError(f"serve: launch counts {counts} != expected {expected}: "
                                 "the served path ran past a kernel")
        if len(done) != requests or sorted(r for r, _ in done) != list(range(requests)):
            raise AssertionError("serve: not every request was answered")
        for _, toks in done:
            if toks.shape != (gen_len,) or toks.min() < 0 or toks.max() >= 152064:
                raise AssertionError("serve: a request's tokens have the wrong shape or range")
        runs.append(dict(report, run=label,
                         peak_memory_bytes=int(torch.cuda.max_memory_allocated()),
                         launches=counts, ran=ran))
    cx.launches = runs[0]["launches"]
    emit({"phase": "serve", "gpu": cx.smi, "args": SERVE_ARGS, "expected_launches": expected,
          "prefill": "make_graphed_prefill_step (one CUDA graph, captured at the second "
                     "wave and replayed at every later one)",
          "decode": "make_graphed_decode_step (one CUDA graph, replayed a token)",
          "runs": runs, "note": "the first run includes one-time costs (Triton compilation, "
                                "first launches); both runs include their own weight initialisation "
                                "outside the timed region, and each its graph's capture"})


GRAPHS_QWEN = {"B": 8, "prompt": 512, "steps": 63}  # launch/serve.py's served wave
GRAPHS_PREFILL_REPS = 5  # timed prefills a path (median)
GRAPHS_PROFILE_STEPS = {"qwen2-0.5b": 16, "families": 4}


def _graphed_equal(what, eager_logits, eager_toks, graphed_logits, graphed_toks):
    """The compiled decode step against the eager one from the same
    prefill: every step's tokens and logits equal bit for bit."""
    import torch

    if len(eager_logits) != len(graphed_logits) or len(eager_toks) != len(graphed_toks):
        raise AssertionError(f"graphs {what}: the paths ran different numbers of steps")
    for t, (a, b) in enumerate(zip(eager_toks, graphed_toks)):
        if not torch.equal(a, b):
            raise AssertionError(f"graphs {what}: greedy tokens differ at step {t}")
    for t, (a, b) in enumerate(zip(eager_logits, graphed_logits)):
        if not torch.equal(a, b):
            raise AssertionError(f"graphs {what}: logits differ at step {t} by up to "
                                 f"{max_err(a, b):.3e}; the compiled step must equal the "
                                 "eager one bit for bit")


def _prefill_equal(what, eager, graphed):
    """The compiled prefill against the eager one from one zeroed cache:
    logits and every cache leaf equal bit for bit."""
    import torch

    (le, ce), (lg, cg) = eager, graphed
    if not torch.equal(le, lg):
        raise AssertionError(f"graphs {what}: prefill logits differ by up to "
                             f"{max_err(le, lg):.3e}; the compiled prefill must equal the "
                             "eager one bit for bit")
    if len(ce) != len(cg):
        raise AssertionError(f"graphs {what}: the prefills' caches have different leaves")
    for i, (a, b) in enumerate(zip(ce, cg)):
        if a.dtype != b.dtype or not torch.equal(a, b):
            raise AssertionError(f"graphs {what}: prefill cache leaf {i} differs")


def _graphs_case(what, model, params, batch, steps, profile_steps):
    """``prefill_paths`` (eager and compiled, each from a zeroed cache) and
    ``decode_paths`` (eager, then compiled, from one prefill) on the kernel
    runtime in bf16; fails unless each pair agrees bit for bit and
    launches the same kernels a call."""
    from repro_torch.launch.serve import runtime
    from repro_torch.launch.serve_profile import decode_paths, prefill_paths

    rt = runtime(True, "bf16")
    B, S = batch["tokens"].shape
    prefill, kept = prefill_paths(model, params, rt, batch, S + steps + 1,
                                  reps=GRAPHS_PREFILL_REPS, top=8)
    _prefill_equal(what, kept["eager"], kept["graphed"])
    eager, graphed = prefill["paths"]["eager"], prefill["paths"]["graphed"]
    if eager["kernel_launches_per_prefill"] != graphed["kernel_launches_per_prefill"]:
        raise AssertionError(f"graphs {what}: kernel launches a prefill differ: eager "
                             f"{eager['kernel_launches_per_prefill']}, compiled "
                             f"{graphed['kernel_launches_per_prefill']}")
    del kept
    report, kept = decode_paths(model, params, rt, batch, steps,
                                profile_steps=profile_steps, top=8)
    report["prefill_paths"] = prefill
    (le, te), (lg, tg) = kept["eager"], kept["graphed"]
    _graphed_equal(what, le, te, lg, tg)
    eager, graphed = report["paths"]["eager"], report["paths"]["graphed"]
    if eager["kernel_launches_per_decode_step"] != graphed["kernel_launches_per_decode_step"]:
        raise AssertionError(f"graphs {what}: kernel launches a step differ: eager "
                             f"{eager['kernel_launches_per_decode_step']}, compiled "
                             f"{graphed['kernel_launches_per_decode_step']}")
    return report


def phase_graphs(cx):
    """The compiled prefill and decode step against the eager ones, at the
    served sizes: qwen2-0.5b at its published width, bf16, batch 8, prompt
    512, 63 decode steps (``launch/serve.py``'s wave), then rwkv6-3b,
    minicpm3-4b and whisper-base at the sizes the ``families`` phase serves
    them (``FAMILY_SERVE``).  The prefills each from a zeroed cache,
    through ``serve_profile.prefill_paths``: ``torch.equal`` logits and
    cache leaves, equal kernel launches.  The decode steps from one
    prefill, through ``serve_profile.decode_paths``: equal tokens and
    ``torch.equal`` logits at every step, equal kernel launches a step.
    Both paths' seconds, device busy time, idle share, launches and peak
    bytes.  (The Jamba period's compiled prefill and decode are held to
    their eager ones in the ``families`` phase, through
    ``_family_serve_steps``.)"""
    import numpy as np
    import torch

    from repro_torch.configs import get_config
    from repro_torch.launch.serve import frontend_inputs

    t_phase = time.perf_counter()
    mods = _kernel_wrappers()
    _zero_counts(mods)  # just before the path ...
    _full_model(cx)
    B, S, steps = GRAPHS_QWEN["B"], GRAPHS_QWEN["prompt"], GRAPHS_QWEN["steps"]
    rng = np.random.default_rng(0)
    tokens = torch.from_numpy(rng.integers(0, cx.cfg.vocab_size, (B, S)).astype(np.int32)).cuda()
    t0 = time.perf_counter()
    report = _graphs_case("qwen2-0.5b", cx.model, cx.params, {"tokens": tokens}, steps,
                          GRAPHS_PROFILE_STEPS["qwen2-0.5b"])
    emit({"phase": "graphs", "gpu": cx.smi, "model": "qwen2-0.5b", "dtype": "bf16",
          "equal_bit_for_bit": True, "seconds": time.perf_counter() - t0, **report})
    cx.model = cx.params = None
    torch.cuda.empty_cache()
    for arch, args in FAMILY_SERVE.items():
        t0 = time.perf_counter()
        B = int(args[args.index("--batch") + 1])
        S = int(args[args.index("--prompt-len") + 1])
        steps = int(args[args.index("--gen-len") + 1]) - 1
        cfg = get_config(arch)
        model, params = _family_init(cfg, torch.bfloat16)
        tokens = torch.from_numpy(rng.integers(0, cfg.vocab_size, (B, S)).astype(np.int32)).cuda()
        batch = {"tokens": tokens, **frontend_inputs(cfg, B, tokens.device)}
        report = _graphs_case(arch, model, params, batch, steps, GRAPHS_PROFILE_STEPS["families"])
        emit({"phase": "graphs", "gpu": cx.smi, "model": arch, "dtype": "bf16",
              "equal_bit_for_bit": True, "seconds": time.perf_counter() - t0, **report})
        del model, params, batch
        torch.cuda.empty_cache()
    cx.graphs_launches = _counts(mods)  # ... and read just after
    emit({"phase": "graphs", "launches": cx.graphs_launches,
          "seconds": time.perf_counter() - t_phase})


def _trainer_class(made, eager):
    """``Trainer`` as ``launch.train`` builds it, each instance appended to
    ``made``; with ``eager`` its step is the donated eager step
    (``make_train_step(..., donate=True)``) where the card's is one CUDA
    graph: the comparisons and the timed parts of a step need it."""
    from repro_torch.train.train_step import make_train_step
    from repro_torch.train.trainer import Trainer

    class Kept(Trainer):
        def __init__(self, *a, **kw):
            super().__init__(*a, **kw)
            made.append(self)

        def _build_step(self):
            if not eager:
                return super()._build_step()
            self._step_fn = make_train_step(self.model, self.opt_cfg, self.rt,
                                            microbatches=self.tcfg.microbatches,
                                            tuning_db=self.rt.tuning_db, donate=True)

    return Kept


def _train_run(args, mods, keep=False, eager=False):
    """``launch.train.main(args)`` on the card (with ``eager``, its trainer
    steps eagerly): its log, the launches of the kernels in ``mods`` during
    the run, its peak device memory (allocated and reserved) and its
    report line, and with ``keep`` the trainer.  Fails on a loss that is
    not finite."""
    import gc

    import torch

    from repro_torch.launch import train

    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    made, saved = [], train.Trainer
    train.Trainer = _trainer_class(made, eager)
    _zero_counts(mods)  # just before the main path ...
    buf = io.StringIO()
    try:
        with contextlib.redirect_stdout(buf):
            log = train.main(args)
    finally:
        train.Trainer = saved
    counts = _counts(mods)  # ... and read just after
    torch.cuda.synchronize()
    losses = [m["loss"] for m in log]
    if not losses or not all(math.isfinite(x) for x in losses):
        raise AssertionError(f"train {args}: losses {losses}")
    report = [ln for ln in buf.getvalue().splitlines() if ln.startswith("[train] done")]
    out = {"log": log, "losses": losses, "grad_norms": [m["grad_norm"] for m in log],
           "lrs": [m["lr"] for m in log], "seconds": [m["seconds"] for m in log],
           "launches": counts, "peak_memory_bytes": int(torch.cuda.max_memory_allocated()),
           "peak_reserved_bytes": int(torch.cuda.max_memory_reserved()),
           "report": report[-1] if report else None}
    if keep:
        out["trainer"] = made[0]
    return out


def _step_profile(trainer, steps):
    """Device-busy seconds and launches of one more step of ``trainer``
    (``steps`` of them, each on the run's first batch) under the profiler."""
    import torch

    from repro_torch.launch.serve_profile import _profile

    batch = {k: torch.from_numpy(v).to(trainer.device)
             for k, v in trainer.data.batch_at(0).items()}

    def run():
        for _ in range(steps):
            trainer.params, trainer.opt_state, _ = trainer._step_fn(
                trainer.params, trainer.opt_state, batch)

    run()  # the eager step of a graph not yet warm, and its capture, come first
    torch.cuda.synchronize()
    prof = _profile(run, steps, 6)
    return {"busy_seconds": prof["busy_s"], "launches": prof["launches"],
            "top_device": prof["top_device"]}


def _params_spread(a, b):
    """The largest |a - b| over the leaves of two runs' final params (0.0:
    equal bit for bit)."""
    return max(float((x - y).abs().max()) for x, y in zip(a, b))


def _check_same_stream(what, got, want, rtol):
    """Losses and grad norms of two runs, step by step, within ``rtol``."""
    for key in ("losses", "grad_norms"):
        a, b = got[key], want[key][:len(got[key])]
        if len(a) != len(b) or any(abs(x - y) > rtol * abs(y) for x, y in zip(a, b)):
            raise AssertionError(f"train {what}: {key} {a} != {b} (rtol {rtol})")


def _synced_seconds(fn, reps):
    """Mean seconds of ``fn()``, each call ended by a synchronise (as
    ``WallClockEvaluator`` times a step), after one warm-up call."""
    import torch

    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
    return sum(times) / reps


def _host_seconds(fn, reps):
    """Seconds of one ``fn()`` on the host clock, the loop ended by a
    synchronise; after one warm-up call."""
    import torch

    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) / reps


@contextlib.contextmanager
def _oracle_clock(events, step=lambda: 0):
    """While active, CUDA events around every oracle recompute that a
    kernel's forward pairs with (``_RefVJP.backward``, ``kernels/ops.py``),
    appended to ``events`` as ``(kernel, step(), start, stop)``."""
    import torch

    from repro_torch.kernels import ops

    backward = ops._RefVJP.backward

    def timed(ctx, g):
        e0, e1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        e0.record()
        out = backward(ctx, g)
        e1.record()
        events.append((ctx.kernel, step(), e0, e1))
        return out

    ops._RefVJP.backward = staticmethod(timed)
    try:
        yield
    finally:
        ops._RefVJP.backward = staticmethod(backward)


def _oracle_ms(events, step=None):
    """Device ms of the oracle recomputes in ``events`` by kernel (of one
    step, or of all)."""
    import torch

    torch.cuda.synchronize()
    out = {}
    for kernel, at, e0, e1 in events:
        if step is None or at == step:
            out[kernel] = out.get(kernel, 0.0) + e0.elapsed_time(e1)
    return out


def _oracle_calls(events, step=None):
    out = {}
    for kernel, at, *_ in events:
        if step is None or at == step:
            out[kernel] = out.get(kernel, 0) + 1
    return out


@contextlib.contextmanager
def _step_parts(parts):
    """While active, the seconds of each train step's forward, of its
    forward and backward together, and of its optimizer update (host
    clock, each ended by a synchronise), appended to ``parts``: the train
    step (``train/train_step.py``) reaches these through its module."""
    import torch

    from repro_torch.train import train_step as ts

    saved = ts.make_loss_fn, ts.value_and_grad, ts.adamw_update

    def synced(fn, key):
        def run(*a, **kw):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = fn(*a, **kw)
            torch.cuda.synchronize()
            parts[key].append(time.perf_counter() - t0)
            return out
        return run

    ts.make_loss_fn = lambda *a, **kw: synced(saved[0](*a, **kw), "forward")
    ts.value_and_grad = synced(saved[1], "forward_backward")
    ts.adamw_update = synced(saved[2], "optimizer")
    try:
        yield
    finally:
        ts.make_loss_fn, ts.value_and_grad, ts.adamw_update = saved


def _instrumented(args, mods, tap=None):
    """``_train_run(args, mods, keep=True, eager=True)`` (an eager run: the
    parts of a step are timed one by one, which a CUDA graph's replay does
    not allow) with each step's forward / backward / optimizer
    seconds (``_step_parts``) and the device time of its oracle recomputes
    (``_oracle_clock``) taken as it runs, and ``tap`` (a context manager)
    active: the run, and what was taken."""
    rec = {"parts": {"forward": [], "forward_backward": [], "optimizer": []}, "oracle": []}
    with _step_parts(rec["parts"]), tap or contextlib.nullcontext(), \
            _oracle_clock(rec["oracle"], lambda: len(rec["parts"]["optimizer"])):
        run = _train_run(args, mods, keep=True, eager=True)
    return run, rec


def _split(rec, steps):
    """Where a step's time goes, from ``_instrumented``: the medians of the
    forward, backward and optimizer seconds and of the oracle recomputes'
    device ms by kernel over the steps after the first (the warm-up)."""
    import statistics

    parts, timed = rec["parts"], range(1, steps)
    split = {"forward": [parts["forward"][i] for i in timed],
             "backward": [parts["forward_backward"][i] - parts["forward"][i] for i in timed],
             "optimizer": [parts["optimizer"][i] for i in timed]}
    split = {k: statistics.median(v) for k, v in split.items()}
    oracle = [_oracle_ms(rec["oracle"], i) for i in timed]
    return {"seconds_median_of": len(timed), **{f"{k}_seconds": v for k, v in split.items()},
            "step_seconds": sum(split.values()),
            "oracle_backward_calls_per_step": _oracle_calls(rec["oracle"], 1),
            "oracle_backward_ms_per_step": {
                k: statistics.median(o.get(k, 0.0) for o in oracle) for k in oracle[0]}}


def _oracle_estimates(cfg, B, S, device, backward_seconds):
    """The attention and RMSNorm oracles' backward at one step's shapes,
    timed alone (host clock), and their share of a step's backward."""
    import torch

    from repro_torch.kernels import ref

    gen = torch.Generator(device=device)
    gen.manual_seed(0)
    H, K, dh, D = cfg.num_heads, cfg.num_kv_heads, cfg.resolved_head_dim, cfg.d_model

    def leaf(*shape):
        return torch.randn(*shape, generator=gen, device=device).requires_grad_(True)

    q, k, v = leaf(B, S, H, dh), leaf(B, S, K, dh), leaf(B, S, K, dh)
    go = torch.randn(B, S, H, dh, generator=gen, device=device)
    x, scale = leaf(B, S, D), leaf(D)
    gx = torch.randn(B, S, D, generator=gen, device=device)
    attn_s = _host_seconds(lambda: torch.autograd.grad(
        ref.attention_ref(q, k, v, causal=True), (q, k, v), go), reps=5)
    norm_s = _host_seconds(lambda: torch.autograd.grad(
        ref.rmsnorm_ref(x, scale, cfg.norm_eps), (x, scale), gx), reps=5)
    layers = cfg.num_layers
    return {"oracle_attention_backward_seconds_per_call": attn_s,
            "oracle_rmsnorm_backward_seconds_per_call": norm_s,
            "oracle_attention_backward_seconds_per_step": attn_s * layers,
            "oracle_rmsnorm_backward_seconds_per_step": norm_s * (2 * layers + 1),
            "oracle_attention_share_of_backward": attn_s * layers / backward_seconds,
            "oracle_rmsnorm_share_of_backward": norm_s * (2 * layers + 1) / backward_seconds}


@contextlib.contextmanager
def _timed_checkpointer():
    """Times ``Checkpointer``'s host copy (``save``), its write (``_write``,
    on the writer thread: npz + sha256 + atomic rename) and its
    ``restore`` (after any write in flight has finished), and the bytes of
    each committed step."""
    import torch

    from repro_torch.checkpoint.checkpointer import Checkpointer

    rec = {"save_seconds": [], "write_seconds": [], "restore_seconds": [],
           "bytes_written": []}
    save, write, restore = Checkpointer.save, Checkpointer._write, Checkpointer.restore

    def timed_save(self, step, tree, **kw):
        self.wait()
        t0 = time.perf_counter()
        save(self, step, tree, **kw)
        rec["save_seconds"].append(time.perf_counter() - t0)

    def timed_write(self, step, flat, meta):
        t0 = time.perf_counter()
        write(self, step, flat, meta)
        rec["write_seconds"].append(time.perf_counter() - t0)
        rec["bytes_written"].append(sum(f.stat().st_size for f in self._dir(step).iterdir()))

    def timed_restore(self, step, like, **kw):
        self.wait()
        t0 = time.perf_counter()
        out = restore(self, step, like, **kw)
        torch.cuda.synchronize()
        rec["restore_seconds"].append(time.perf_counter() - t0)
        return out

    Checkpointer.save, Checkpointer._write, Checkpointer.restore = (
        timed_save, timed_write, timed_restore)
    try:
        yield rec
    finally:
        Checkpointer.save, Checkpointer._write, Checkpointer.restore = save, write, restore


def _train_phase(cx, cfg, base_args, device):
    import statistics
    import tempfile

    import torch

    from repro_torch.models.params import tree_leaves
    from repro_torch.models.runtime import REMAT_MODES

    # every kernel's count, zeroed before each run and read after it: the
    # train path launches K1 and K2 and nothing else
    mods = _kernel_wrappers()
    layers = cfg.num_layers
    per_step = {"rmsnorm": 2 * layers + 1, "flash_attention": layers,
                "decode_attention": 0, "ssm_scan": 0, "gla_scan": 0, "gla_scan_bwd": 0,
                "gla_scan_state": 0}
    B, S = (int(base_args[base_args.index(f) + 1]) for f in ("--batch", "--seq"))
    common = {"phase": "train", "gpu": cx.smi, "model": cfg.name, "layers": layers,
              "d_model": cfg.d_model, "vocab": cfg.padded_vocab, "dtype": "f32",
              "batch": B, "seq": S}

    def expect(run, what, steps, per):
        want = {k: v * steps for k, v in per.items()}
        if run["launches"] != want:
            raise AssertionError(f"train {what}: launches {run['launches']} != {want}: the "
                                 "train path ran past a kernel")

    # 1. the eager step twice (the first run also splits each step's
    # time), then the main path: 12 compiled steps through the entry point,
    # from the same weights and batches
    steps_args = base_args + ["--steps", str(TRAIN_STEPS)]
    # (each run's final params kept on the host: on the card they would
    # count in the next run's peak bytes)
    eager, rec = _instrumented(steps_args, mods)
    eager["params"] = [t.cpu() for t in tree_leaves(eager.pop("trainer").params)]
    eager2 = _train_run(steps_args, mods, keep=True, eager=True)
    trainer = eager2.pop("trainer")
    eager2["params"] = [t.cpu() for t in tree_leaves(trainer.params)]
    eager_profile = _step_profile(trainer, TRAIN_PROFILE_STEPS)  # steps past the run's
    del trainer
    main = _train_run(steps_args, mods, keep=True)
    expect(main, "main", TRAIN_STEPS, per_step)
    for run in (eager, eager2):
        expect(run, "eager", TRAIN_STEPS, per_step)
    if not main["losses"][-1] < main["losses"][0]:
        raise AssertionError(f"train: the loss did not fall: {main['losses']}")
    trainer = main.pop("trainer")
    main["params"] = [t.cpu() for t in tree_leaves(trainer.params)]
    if main["lrs"] != eager["lrs"]:
        raise AssertionError(f"train: the compiled step's learning rates {main['lrs']} != "
                             f"the eager step's {eager['lrs']}")
    # the eager step against itself: bit for bit, or the spread the compiled
    # step must stay within
    spread = {k: max(abs(x - y) for x, y in zip(eager[k], eager2[k]))
              for k in ("losses", "grad_norms")}
    spread["params"] = _params_spread(eager["params"], eager2["params"])
    apart = {k: max(abs(x - y) for x, y in zip(main[k], eager[k]))
             for k in ("losses", "grad_norms")}
    apart["params"] = _params_spread(main["params"], eager["params"])
    reproducible = not any(spread.values())
    if any(apart[k] > spread[k] for k in apart):
        raise AssertionError(f"train: the compiled step is {apart} from the eager one, "
                             f"whose own runs are {spread} apart")
    graph_profile = _step_profile(trainer, TRAIN_PROFILE_STEPS)  # steps past the run's
    del trainer, main["params"], eager["params"], eager2["params"]
    cx.train_launches = main["launches"]
    med, eager_med = (statistics.median(r["seconds"][1:]) for r in (main, eager))
    cx.train_median_step = med
    emit(dict(common, part="main", step="make_graphed_train_step (one CUDA graph)",
              steps=TRAIN_STEPS, losses=main["losses"], grad_norms=main["grad_norms"],
              lrs=main["lrs"], step_seconds=main["seconds"], median_step_seconds=med,
              median_of=TRAIN_STEPS - 1, tokens_per_s=B * S / med,
              first_eager_median_step_seconds=TRAIN_FIRST_EAGER_MEDIAN,
              device_busy_seconds_per_step=graph_profile["busy_seconds"],
              device_idle_share_of_step=1.0 - graph_profile["busy_seconds"] / med,
              device_launches_per_step=graph_profile["launches"],
              top_device=graph_profile["top_device"],
              peak_memory_bytes=main["peak_memory_bytes"],
              peak_reserved_bytes=main["peak_reserved_bytes"], launches=main["launches"],
              launches_per_step={k: v / TRAIN_STEPS for k, v in main["launches"].items()},
              report=main["report"]))
    emit(dict(common, part="eager_vs_compiled", eager_reproducible=reproducible,
              eager_spread=spread, compiled_vs_eager=apart,
              equal_bit_for_bit=not any(apart.values()), lrs_equal=True,
              eager_losses=eager["losses"], eager_losses_again=eager2["losses"],
              eager_step_seconds=eager["seconds"], eager_median_step_seconds=eager_med,
              eager_device_busy_seconds_per_step=eager_profile["busy_seconds"],
              eager_device_idle_share_of_step=1.0 - eager_profile["busy_seconds"] / eager_med,
              eager_device_launches_per_step=eager_profile["launches"],
              eager_peak_memory_bytes=eager["peak_memory_bytes"],
              eager_peak_reserved_bytes=eager["peak_reserved_bytes"]))

    # 2. where a step's time goes (in the first eager run's steps)
    split = _split(rec, TRAIN_STEPS)
    emit(dict(common, part="split", step="eager", **split,
              **_oracle_estimates(cfg, B, S, device, split["backward_seconds"])))

    # 3. the remat modes, from the same params on the same batches; every
    # mode but none runs each layer's kernels again in its recompute
    runs = {mode: _train_run(base_args + ["--steps", str(REMAT_STEPS), "--remat", mode], mods)
            for mode in REMAT_MODES}
    _check_same_stream("remat none vs the main run", runs["none"], main, 1e-5)
    for mode, run in runs.items():
        _check_same_stream(f"remat {mode}", run, runs["none"], 1e-5)
        again = {"rmsnorm": 2 * layers, "flash_attention": layers} if mode != "none" else {}
        expect(run, f"remat {mode}", REMAT_STEPS,
               {k: v + again.get(k, 0) for k, v in per_step.items()})
    if not runs["full"]["peak_memory_bytes"] < runs["none"]["peak_memory_bytes"]:
        raise AssertionError("train: remat full did not lower the peak memory: "
                             f"{runs['full']['peak_memory_bytes']} vs "
                             f"{runs['none']['peak_memory_bytes']}")
    emit(dict(common, part="remat", steps=REMAT_STEPS, tolerance_rel=1e-5, modes={
        mode: {"losses": r["losses"], "grad_norms": r["grad_norms"],
               "peak_memory_bytes": r["peak_memory_bytes"], "step_seconds": r["seconds"],
               "launches_per_step": {k: v / REMAT_STEPS for k, v in r["launches"].items()}}
        for mode, r in runs.items()}))
    del runs

    # 4. two microbatches against one (two steps: the second one a replay)
    mb = _train_run(base_args + ["--steps", str(REMAT_STEPS), "--microbatches", "2"], mods)
    _check_same_stream("microbatches 2 vs 1", mb, main, 1e-5)
    expect(mb, "microbatches", 2 * REMAT_STEPS, per_step)  # a forward a microbatch
    emit(dict(common, part="microbatches", microbatches=2, tolerance_rel=1e-5,
              loss=mb["losses"][0], loss_one_batch=main["losses"][0],
              losses=mb["losses"], grad_norm=mb["grad_norms"][0],
              grad_norm_one_batch=main["grad_norms"][0],
              peak_memory_bytes=mb["peak_memory_bytes"], step_seconds=mb["seconds"]))

    # 5. failure and resume through the array checkpointer
    args = base_args + RESUME_ARGS
    tmp = tempfile.mkdtemp(prefix="chip_smoke_train_")
    try:
        plain = _train_run(args, mods)
        with _timed_checkpointer() as ck:
            failing = _train_run(args + ["--checkpoint-dir", tmp] + RESUME_FAIL_ARGS, mods)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    # the log holds the replayed step twice: its run before the failure and
    # its run from the restored state, which must both equal the
    # uninterrupted run's (a restore that read nothing would replay it from
    # the state after that step, and differ)
    steps = [m["step"] for m in failing["log"]]
    n = RESUME_REPLAYED
    if steps != list(range(n + 1)) + list(range(n, len(plain["log"]))):
        raise AssertionError(f"train resume: steps {steps}")
    fail_at = int(RESUME_FAIL_ARGS[RESUME_FAIL_ARGS.index("--inject-failure") + 1])
    for event in (f"failure at step {fail_at}", "elastic rescale dp 2->1",
                  f"restored step {n}"):
        if event not in (failing["report"] or ""):
            raise AssertionError(f"train resume: no {event!r} in {failing['report']!r}")
    first = {k: failing[k][:n + 1] for k in ("losses", "grad_norms")}
    again = {k: failing[k][n + 1:] for k in ("losses", "grad_norms")}
    _check_same_stream("resume, before the failure, vs uninterrupted", first, plain, 1e-6)
    _check_same_stream("resume, from the restore on, vs uninterrupted", again,
                       {k: plain[k][n:] for k in again}, 1e-6)
    _check_same_stream("resume, the replayed step vs its first run",
                       {k: v[:1] for k, v in again.items()},
                       {k: v[n:] for k, v in first.items()}, 1e-6)
    if not ck["restore_seconds"] or not ck["bytes_written"]:
        raise AssertionError(f"train resume: the checkpointer did not run: {ck}")
    emit(dict(common, part="resume", layers=int(RESUME_ARGS[1]), tolerance_rel=1e-6,
              replayed_step=n, steps=steps,
              losses=failing["losses"], losses_uninterrupted=plain["losses"],
              report=failing["report"], **ck))


def phase_train(cx):
    """Training through ``repro_torch.launch.train`` at qwen2-0.5b's
    published width and depth, f32: K1 and K2 forward, their oracles
    backward.  The loss is finite and falls, K1 and K2 launch 49 and 24
    times a step, the remat modes and two microbatches give the same
    stream, and failure + resume through the array checkpointer replays
    it."""
    import torch

    from repro_torch.configs import get_config

    # free the earlier phases' copy of the model: the entry point makes its own
    cx.model = cx.params = None
    torch.cuda.empty_cache()
    cfg = get_config("qwen2-0.5b")
    assert (cfg.num_layers, cfg.d_model, cfg.num_heads, cfg.num_kv_heads, cfg.d_ff,
            cfg.vocab_size, cfg.tie_embeddings) == (24, 896, 14, 2, 4864, 151936, True)
    _train_phase(cx, cfg, TRAIN_ARGS, torch.device("cuda"))


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


def _serve_report(buf):
    line = [ln for ln in buf.getvalue().splitlines() if ln.startswith("[serve]")][-1]
    m = re.match(r"\[serve\] (\d+) requests, (\d+) tokens in ([\d.]+)s => ([\d.]+) tok/s", line)
    if m is None:
        raise AssertionError(f"serve: unexpected report line {line!r}")
    return {"requests": int(m.group(1)), "tokens": int(m.group(2)),
            "seconds": float(m.group(3)), "tok_per_s": float(m.group(4)), "report": line}


def phase_sweep(cx):
    """The tuning loop on the card: Tuner -> KernelTuneEvaluator ->
    WallClockEvaluator -> ops -> kernel for all five kernels at full width,
    best configs into a fresh TuningDB; a warm re-run measures nothing; then
    qwen2-0.5b is served with the DB and must run the swept tiles."""
    import torch

    from repro_torch.benchmarks.kernel_sweep import lookup_latency_ms, run_sweep
    from repro_torch.kernels import _build, ops
    from repro_torch.kernels import decode_attention as dec
    from repro_torch.kernels import flash_attention as fla
    from repro_torch.kernels import gla_scan as gla
    from repro_torch.kernels import rmsnorm as rms
    from repro_torch.kernels import ssm_scan as ssm
    from repro_torch.launch import serve
    from repro_torch.runtime.graphs import GraphedStep
    from repro_torch.tuning.evaluator import WallClockEvaluator
    from repro_torch.tuning.kernel_objective import KERNELS
    from repro_torch.tuning.tundb import TuningDB, hardware_fingerprint

    cx.model = cx.params = None  # the serve below builds its own model
    torch.cuda.empty_cache()
    modules = {"rmsnorm": rms, "flash_attention": fla, "decode_attention": dec,
               "ssm_scan": ssm, "gla_scan": gla}
    mods = {name: getattr(m, name) for name, m in modules.items()}
    names = list(SWEEP_SHAPES)
    path = _build.build_dir() / "sweep_tundb.json"
    path.unlink(missing_ok=True)
    fp = hardware_fingerprint("cuda")
    kw = dict(SWEEP_ARGS, shapes=SWEEP_SHAPES, device="cuda", emit=lambda *a: None)

    _zero_counts(mods)  # just before the main path ...
    rows, measured = run_sweep(names, TuningDB(path, fingerprint=fp), **kw)
    torch.cuda.synchronize()
    counts = _counts(mods)  # ... and read just after
    cx.sweep_launches = counts
    cx.sweep_rows = {r["kernel"]: r for r in rows}
    cx.sweep_defaults = {}
    for r in rows:
        if r["skipped"] or r["measurements"] <= 0 or not math.isfinite(r["value"]):
            raise AssertionError(f"sweep: {r['kernel']} was not measured: {r}")
    missing = [n for n in names if counts[n] <= 0]
    if missing:
        raise AssertionError(f"sweep: no launch of {missing} during the sweep: {counts}")

    warm_db = TuningDB(path, fingerprint=fp)
    _, warm_measured = run_sweep(names, warm_db, **kw)
    lookup_ms = lookup_latency_ms(warm_db, names, shapes=SWEEP_SHAPES)
    if warm_measured != 0:
        raise AssertionError(f"sweep: the warm re-run measured {warm_measured} points")
    if not lookup_ms < 1.0:
        raise AssertionError(f"sweep: median DB lookup {lookup_ms:.4f} ms >= 1 ms")

    # the defaults, measured the same way (outside the counted window); the
    # eager step timed as the evaluator times a replay (each call ended by a
    # synchronise), and the compiled step's output against the eager one's
    # on the same inputs
    recorded = {}
    for r in rows:
        name, shape, spec = r["kernel"], r["shape"], KERNELS[r["kernel"]]
        build = lambda p, spec=spec, shape=shape: spec.build(shape, p, "cuda")  # noqa: E731
        d_value, d_meta = WallClockEvaluator(build, warmup=1, iters=2, rel_halfwidth=0.5,
                                             name=name)({})
        step, args, examples = build({})
        eager_seconds = _synced_seconds(lambda: step(*args), SWEEP_EAGER_STEPS)
        want = step(*args).clone()
        graph = GraphedStep(name, "measured step")
        run = lambda inputs=None: step(*args)  # noqa: E731
        graph.run({"arguments": args}, {}, run, run)  # eager
        got = graph.run({"arguments": args}, {}, run, run).clone()  # captured, replayed
        graph.release()
        if not torch.equal(got, want):
            raise AssertionError(f"sweep {name}: the compiled step's output differs from the "
                                 f"eager one's by up to {max_err(got, want):.3e}")
        del step, args, want, got, graph
        cx.sweep_defaults[name] = d_value
        recorded[name] = warm_db.lookup(name, shape)["config"]
        emit({"phase": "sweep", "kernel": name, "shape": shape, "dtype": "f32",
              "engine": SWEEP_ARGS["algorithm"], "budget": SWEEP_ARGS["budget"],
              "default_config": spec.config({}), "default_runs_as": spec.effective(shape, {}),
              "default_value": d_value, "default_step_seconds": d_meta["step_seconds"],
              "default_eager_value": examples / eager_seconds,
              "default_eager_step_seconds": eager_seconds,
              "default_compiled_equals_eager": True,
              "best_config": r["best"], "best_runs_as": spec.effective(shape, r["best"]),
              "best_value": r["value"], "best_step_seconds": r["step_seconds"],
              "gain": r["value"] / d_value, "measurements": r["measurements"],
              "n_evals": r["n_evals"], "seconds": r["seconds"], "launches": counts[name],
              "value_unit": "examples/s (WallClockEvaluator: replays of one CUDA graph of "
                            "the step; the eager step called directly; host clock, one "
                            "synchronise per step)"})

    # serve with the swept DB; spies on the consults and on what each kernel ran
    served = ("flash_attention", "decode_attention", "rmsnorm")
    seen, ran = [], {n: [] for n in served}
    orig_tuned = ops._tuned
    orig_eff = {n: modules[n].effective_config for n in served}

    def spy(db, kernel, dims, defaults):
        out = orig_tuned(db, kernel, dims, defaults)
        if db is not None:
            seen.append((db, kernel, dict(dims), dict(out)))
        return out

    def eff_spy(name):
        def effective(*a, **k):
            out = orig_eff[name](*a, **k)
            ran[name].append(dict(out))
            return out
        return effective

    layers, gen_len = 24, 64
    expected = {"flash_attention": layers, "decode_attention": layers * (gen_len - 1),
                "rmsnorm": (2 * layers + 1) * gen_len}
    ops._tuned = spy
    for n in served:
        modules[n].effective_config = eff_spy(n)
    try:
        _zero_counts({n: mods[n] for n in served})
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            done = serve.main(SWEEP_SERVE_ARGS + ["--tuning-db", str(path)])
        serve_counts = _counts({n: mods[n] for n in served})
        torch.cuda.synchronize()
    finally:
        ops._tuned = orig_tuned
        for n in served:
            modules[n].effective_config = orig_eff[n]
    report = _serve_report(buf)
    if serve_counts != expected:
        raise AssertionError(f"sweep serve: launch counts {serve_counts} != {expected}")
    if len(done) != 8 or any(t.shape != (gen_len,) for _, t in done):
        raise AssertionError("sweep serve: not every request was answered in full")
    served_db = seen[0][0] if seen else None
    pickup = {}
    for n in served:
        at = [out for _, k, dims, out in seen if k == n and dims == SWEEP_SHAPES[n]]
        runs_as = KERNELS[n].effective(SWEEP_SHAPES[n], recorded[n])
        pickup[n] = {"recorded": recorded[n], "tuned_calls_at_swept_dims": len(at),
                     "runs_as": runs_as, "ran_with": sorted({json.dumps(c, sort_keys=True)
                                                             for c in ran[n]})}
        if not at or any(out != recorded[n] for out in at):
            raise AssertionError(f"sweep serve: {n} did not get its record at {SWEEP_SHAPES[n]}: "
                                 f"{[(k, d, o) for _, k, d, o in seen if k == n]}")
        if runs_as not in ran[n]:
            raise AssertionError(f"sweep serve: {n} never ran with {runs_as}: {ran[n]}")
    if served_db is None or served_db.hits < len(served):
        raise AssertionError(f"sweep serve: the DB got too few hits: "
                             f"{None if served_db is None else served_db.hits}")
    emit({"phase": "sweep", "gpu": cx.smi, "db": str(path), "cold_measurements": measured,
          "warm_measurements": warm_measured, "lookup_median_ms": lookup_ms,
          "sweep_launches": counts, "serve_args": SWEEP_SERVE_ARGS, "serve": report,
          "serve_launches": serve_counts, "db_lookups": served_db.lookups,
          "db_hits": served_db.hits, "pickup": pickup})


def _kernel_wrappers():
    from repro_torch.serve.serve_step import kernel_counters

    return {fn.__name__: fn for fn in kernel_counters()}


def _gp_ask_ms(device, rows, reps=5):
    """Median ms of one GP fit + acquisition ranking of BO_GP_CANDIDATES
    candidates on ``device`` (inputs made from a seed; one untimed call
    first)."""
    import numpy as np

    from repro_torch.core.gp import GaussianProcess

    rng = np.random.default_rng(rows)
    X, Xs = rng.random((rows, 4)), rng.random((BO_GP_CANDIDATES, 4))
    y = np.sin(3 * X[:, 0]) + X[:, 1] ** 2 - 0.5 * X[:, 2] + 0.05 * rng.standard_normal(rows)
    times = []
    for i in range(reps + 1):
        t0 = time.perf_counter()
        gp = GaussianProcess(device=device).fit(X, y)
        order, acq = gp.acquisition_rank(Xs, "smsego", float(y.max()))  # numpy: synchronised
        if i:
            times.append((time.perf_counter() - t0) * 1e3)
        if order.shape != (BO_GP_CANDIDATES,) or not np.isfinite(acq).all():
            raise AssertionError(f"bo: GP on {device} at {rows} rows gave a bad ranking")
    return sorted(times)[len(times) // 2]


def phase_bo(cx):
    """BO on the card: Tuner(bo) -> KernelTuneEvaluator -> WallClockEvaluator ->
    ops -> kernel for all five kernels at full width, into a fresh TuningDB,
    every measurement recorded into a fresh transfer corpus; then one GP fit
    + ranking timed on the CPU and on the card, and the async-loop gate."""
    import statistics

    import torch

    from repro_torch.benchmarks.kernel_sweep import run_sweep
    from repro_torch.core import SearchSpace, TransferConfig
    from repro_torch.kernels import _build
    from repro_torch.tuning.evaluator import WallClockEvaluator
    from repro_torch.tuning.kernel_objective import KERNELS, kernel_space
    from repro_torch.tuning.tundb import TuningDB, hardware_fingerprint

    mods = _kernel_wrappers()
    names = list(SWEEP_SHAPES)
    db_path = _build.build_dir() / "bo_tundb.json"
    corpus_path = _build.build_dir() / "bo_corpus.json"
    for p in (db_path, corpus_path):
        p.unlink(missing_ok=True)
    fp = hardware_fingerprint("cuda")
    _zero_counts(mods)  # just before the main path ...
    rows, measured = run_sweep(names, TuningDB(db_path, fingerprint=fp), **BO_ARGS,
                               shapes=SWEEP_SHAPES, device="cuda",
                               transfer=TransferConfig(corpus_path=str(corpus_path)),
                               emit=lambda *a: None)
    torch.cuda.synchronize()
    counts = _counts(mods)  # ... and read just after
    cx.bo_launches = counts
    missing = [n for n in names if counts[n] <= 0]
    if missing:
        raise AssertionError(f"bo: no launch of {missing} during the BO sweep: {counts}")
    records = list(json.loads(corpus_path.read_text()).values())
    if len(records) != measured or any(r["workload"]["hardware"] != fp for r in records):
        raise AssertionError(f"bo: the corpus holds {len(records)} rows for {measured} "
                             "measurements, or rows without the card's fingerprint")
    for r in rows:
        name, shape, spec = r["kernel"], r["shape"], KERNELS[r["kernel"]]
        if r["skipped"] or not math.isfinite(r["value"]) or r["measurements"] <= 0:
            raise AssertionError(f"bo: {name} was not measured: {r}")
        asks = r["ask_seconds"]
        if len(asks) != r["n_evals"]:
            raise AssertionError(f"bo: {name}: {len(asks)} ask times for {r['n_evals']} asks")
        points = list(SearchSpace.from_dicts(kernel_space(name, shape)).enumerate())
        grid = len(points)
        feasible = sum(1 for p in points if spec.feasible(shape, p))
        default = getattr(cx, "sweep_defaults", {}).get(name)
        if default is None:  # the sweep phase did not run: measure it here
            wall = WallClockEvaluator(lambda p, spec=spec, shape=shape: spec.build(shape, p, "cuda"),
                                      warmup=1, iters=2, rel_halfwidth=0.5, name=name)
            default = wall({})[0]
        ga = getattr(cx, "sweep_rows", {}).get(name)
        emit({"phase": "bo", "kernel": name, "shape": shape, "dtype": "f32",
              "engine": "bo", "budget": min(BO_ARGS["budget"], grid), "grid": grid,
              "grid_feasible": feasible,
              "default_value": default, "bo_best_config": r["best"], "bo_best_value": r["value"],
              "bo_best_step_seconds": r["step_seconds"],
              "ga_best_value": None if ga is None else ga["value"],
              "ga_budget": None if ga is None else min(SWEEP_ARGS["budget"], grid),
              "exhaustive_best_value": r["value"] if r["measurements"] >= grid else None,
              "measurements": r["measurements"], "seconds": r["seconds"],
              "ask_seconds_median": statistics.median(asks), "ask_seconds_max": max(asks),
              "ask_seconds_total": sum(asks), "ask_share": sum(asks) / r["seconds"],
              "ask_seconds": asks, "launches": counts[name],
              "value_unit": "examples/s (WallClockEvaluator: replays of one CUDA graph of "
                            "the step; the eager step called directly; host clock, one "
                            "synchronise per step)"})
    gp_ms = {dev: {rows_: _gp_ask_ms(dev, rows_) for rows_ in BO_GP_ROWS}
             for dev in ("cpu", "cuda")}
    emit({"phase": "bo", "gpu": cx.smi, "corpus_rows": len(records), "measurements": measured,
          "launches": counts, "gp_fit_and_rank_ms": gp_ms, "gp_candidates": BO_GP_CANDIDATES,
          "gp_note": "median of 5 of GaussianProcess(device).fit + acquisition_rank, host clock; "
                     "an observation, not a gate"})
    _async_gate()


def _async_gate():
    """The port's own async-loop gate on this host, as a child process:
    ``perf_iterations --async-loop --check`` (BO / GA / NMS / random,
    completion-driven vs batch-barrier, budget 16, parallelism 4).  A
    non-zero exit fails the phase."""
    from repro_torch.kernels import _build

    out = _build.build_dir() / "asyncbench.json"
    out.unlink(missing_ok=True)
    cmd = [sys.executable, "-m", "repro_torch.benchmarks.perf_iterations", "--async-loop",
           "--check", "--out", str(out)]
    t0 = time.perf_counter()
    proc = subprocess.run(cmd, capture_output=True, text=True, timeout=300, cwd=HERE,
                          env=dict(os.environ, PYTHONPATH=os.path.join(HERE, "src")))
    log = proc.stdout + proc.stderr
    if proc.returncode != 0:
        raise AssertionError(f"bo: perf_iterations --async-loop --check exited "
                             f"{proc.returncode}:\n" + log[-3000:])
    rows = json.loads(out.read_text())
    asks = {r["loop"]: r["mean_ask_seconds"] * 1e3 for r in rows
            if r["mode"] == "bo_suggestion_overhead"}
    total = next(r for r in rows if r["mode"] == "async_vs_batch_total")
    emit({"phase": "bo", "part": "async_gate", "command": " ".join(["python"] + cmd[1:5]),
          "rc": proc.returncode, "seconds": round(time.perf_counter() - t0, 1),
          "lines": [ln for ln in proc.stdout.splitlines()
                    if ln.startswith(("asyncbench", "bo_suggestion", "memocache"))],
          "bo_mean_ask_ms": asks, "batch_seconds": total["batch_seconds"],
          "async_seconds": total["async_seconds"], "speedup": total["speedup"]})


def make_service_objective():
    """Zero-argument factory the ``service`` phase's worker resolves
    (``--objective chip_smoke:make_service_objective()``): ssm_scan's tuning
    objective on the card at the sweep's shape, measured as the sweep does."""
    import torch  # noqa: F401  (loaded before the worker fingerprints its host: the card)

    from repro_torch.tuning.kernel_objective import KernelTuneEvaluator

    return KernelTuneEvaluator("ssm_scan", SWEEP_SHAPES["ssm_scan"], warmup=1, iters=2,
                               rel_halfwidth=0.5, device="cuda")


def _free_port():
    import socket

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _nvidia_files(pid):
    """The NVIDIA device files process ``pid`` holds open: initialising CUDA
    opens ``/dev/nvidiactl`` and a context opens ``/dev/nvidia<N>``;
    importing torch opens none."""
    out = []
    for fd in os.listdir(f"/proc/{pid}/fd"):
        try:
            target = os.readlink(f"/proc/{pid}/fd/{fd}")
        except FileNotFoundError:  # closed while listed
            continue
        if target.startswith("/dev/nvidia"):
            out.append(target)
    return sorted(set(out))


def _feasible_space(name):
    """``kernel_space`` of ``name`` at its sweep shape, each choice that no
    feasible point uses left out (ssm_scan: the chunks whose staging does
    not fit a block's shared memory on this card), so that every point of
    the job is a measurement on the card."""
    from repro_torch.core import SearchSpace
    from repro_torch.tuning.kernel_objective import KERNELS, kernel_space

    shape, spec = SWEEP_SHAPES[name], KERNELS[name]
    dims = kernel_space(name, shape)
    ok = [p for p in SearchSpace.from_dicts(dims).enumerate() if spec.feasible(shape, p)]
    dims = [dict(d, choices=[c for c in d["choices"] if any(p[d["name"]] == c for p in ok)])
            for d in dims]
    if SearchSpace.from_dicts(dims).grid_size() != len(ok):
        raise AssertionError(f"service: the feasible points of {name} are no grid")
    return dims


def _wait_for(procs, ready, what, timeout=120):
    deadline = time.time() + timeout
    while not ready():
        for name, proc in procs.items():
            if proc.poll() is not None:
                raise AssertionError(f"service: the {name} exited with {proc.returncode}")
        if time.time() > deadline:
            raise AssertionError(f"service: the {what} was not ready after {timeout} s")
        time.sleep(0.5)


def phase_service(cx):
    """The tuning service on the card: a worker process measuring ssm_scan on
    the card and the service daemon, both started as processes of their own;
    one BO job of SERVICE_BUDGET measurements over ssm_scan's feasible space
    submitted through the client."""
    from repro_torch.core import TunerConfig
    from repro_torch.kernels import _build
    from repro_torch.launch.service import ServiceClient
    from repro_torch.tuning.protocol import JobSpec

    state = _build.build_dir() / "service_state"
    shutil.rmtree(state, ignore_errors=True)
    state.mkdir(parents=True)
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        [os.path.join(HERE, "src"), HERE] + [p for p in os.environ.get("PYTHONPATH", "").split(
            os.pathsep) if p]))
    wport, sport = _free_port(), _free_port()
    logs = {n: open(state / f"{n}.log", "w") for n in ("worker", "daemon")}
    procs = {}
    try:
        procs["worker"] = subprocess.Popen(
            [sys.executable, "-m", "repro_torch.launch.worker", "--host", "127.0.0.1",
             "--port", str(wport), "--slots", "1",
             "--objective", "chip_smoke:make_service_objective()"],
            cwd=HERE, env=env, stdout=logs["worker"], stderr=subprocess.STDOUT)
        _wait_for(procs, lambda: "serving" in (state / "worker.log").read_text(), "worker")
        procs["daemon"] = subprocess.Popen(
            [sys.executable, "-m", "repro_torch.launch.service", "--serve",
             "--state-dir", str(state / "daemon"), "--host", "127.0.0.1", "--port", str(sport),
             "--workers", f"127.0.0.1:{wport}", "--parallelism", "1"],
            cwd=HERE, env=env, stdout=logs["daemon"], stderr=subprocess.STDOUT)
        clients = []

        def connected():
            try:
                clients.append(ServiceClient(f"127.0.0.1:{sport}"))
                return True
            except OSError:
                return False

        _wait_for(procs, connected, "daemon")  # it reaches the worker before it listens
        client = clients[0]
        config = TunerConfig(algorithm="bo", budget=SERVICE_BUDGET, seed=0, verbose=False)
        with client:
            t0 = time.perf_counter()
            job_id = client.submit(JobSpec(space=_feasible_space("ssm_scan"),
                                           config=config.to_dict(), name="ssm_scan-bo"))
            st = client.wait(job_id, timeout=600)
            wall_s = time.perf_counter() - t0
        nvidia = {n: _nvidia_files(p.pid) for n, p in procs.items()}
    finally:
        for proc in procs.values():
            if proc.poll() is None:
                proc.terminate()
                try:
                    proc.wait(timeout=15)
                except subprocess.TimeoutExpired:
                    proc.kill()
                    proc.wait()
        for f in logs.values():
            f.close()
    hist_path = state / "daemon" / "jobs" / job_id / "history.json"
    hist = json.loads(hist_path.read_text()) if hist_path.exists() else []
    if st["state"] != "done" or st["n_evals"] != SERVICE_BUDGET or len(hist) != SERVICE_BUDGET:
        tails = {n: (state / f"{n}.log").read_text().splitlines()[-40:] for n in logs}
        raise AssertionError(
            f"service: job {job_id} ended {st['state']} with {st['n_evals']} results "
            f"({len(hist)} in its history): {st.get('error')}\n"
            + "\n".join(f"--- the end of the {n}'s log:\n" + "\n".join(lines)
                        for n, lines in tails.items()))
    bad = [e for e in hist if not math.isfinite(e["value"]) or e["meta"].get("kernel") != "ssm_scan"
           or not math.isfinite(e["meta"].get("step_seconds", math.nan))]
    if bad:
        raise AssertionError(f"service: results that are no measurement of ssm_scan: {bad}")
    # the worker measured on the card; the daemon never initialised CUDA
    if not nvidia["worker"] or nvidia["daemon"]:
        raise AssertionError(f"service: NVIDIA device files open {nvidia}: wanted some "
                             "in the worker and none in the daemon")
    emit({"phase": "service", "gpu": cx.smi, "job": job_id, "state": st["state"],
          "results": len(hist), "wall_seconds": wall_s, "best": st["best"],
          "values": [e["value"] for e in hist],
          "step_seconds": [e["meta"]["step_seconds"] for e in hist],
          "nvidia_files_open": nvidia})



# ---------------------------------------------------------------------------
# the remaining model families at full width (rwkv6-3b, one period of Jamba,
# minicpm3-4b, whisper-base)
# ---------------------------------------------------------------------------

FAMILY_B, FAMILY_S = 2, 2048  # scored forwards: K4's and K5's sweep shapes
FAMILY_DECODE = 4             # decode steps after a prefill held against the oracle path
FAMILY_SERVE = {
    "rwkv6-3b": ["--arch", "rwkv6-3b", "--no-reduced", "--dtype", "bf16", "--requests", "8",
                 "--prompt-len", "128", "--gen-len", "32", "--batch", "8"],
    "minicpm3-4b": ["--arch", "minicpm3-4b", "--no-reduced", "--dtype", "bf16",
                    "--requests", "8", "--prompt-len", "128", "--gen-len", "16", "--batch", "8"],
    "whisper-base": ["--arch", "whisper-base", "--no-reduced", "--dtype", "bf16",
                     "--requests", "8", "--prompt-len", "32", "--gen-len", "32", "--batch", "8"],
}
# f32, the kernel path against the oracle path on the same weights: every
# op rounds at ~6e-8 relative, in other orders on the two paths (the
# scans' sequential kernels against their chunked oracles, the norms' one
# pass against three); over 32 layers, 1e-3 of the largest logit.  (In
# bf16 both paths of rwkv6-3b and Jamba land far from the f32 run on these
# random weights, most of the largest logit: RWKV's decays exp(-exp(w))
# within 0.0025 of 1 round to 0.996 or 1 in bf16.  So bf16 holds the kernel
# path to the oracle path's own distance from f32, as the parity phase
# does.)
FAMILY_F32_RTOL = 1e-3


def _ulp(x):
    """One bf16 ulp at |x|."""
    return 2.0 ** (math.floor(math.log2(max(abs(x), 1e-30))) - 7)


class _KernelClock:
    """CUDA events around every launch of the five kernels while active:
    the dispatch layer (``kernels/ops.py``) reaches each kernel through its
    module, so standing in for the module there reaches every call site.
    ``ms(counts)`` is each kernel's device time since the last ``reset()``,
    held to the launch counters, which count as before."""

    MODS = {"rmsnorm": "_rms_mod", "flash_attention": "_flash_mod",
            "decode_attention": "_decode_mod", "ssm_scan": "_ssm_mod", "gla_scan": "_gla_mod"}

    class _Timed:
        def __init__(self, mod, name, events):
            self._mod, self._name, self._events = mod, name, events

        def __getattr__(self, attr):
            fn = getattr(self._mod, attr)
            if attr != self._name:
                return fn

            def timed(*a, **kw):
                import torch

                if torch.cuda.is_current_stream_capturing():
                    return fn(*a, **kw)  # a capture launches nothing: nothing to time
                e0 = torch.cuda.Event(enable_timing=True)
                e1 = torch.cuda.Event(enable_timing=True)
                e0.record()
                out = fn(*a, **kw)
                e1.record()
                self._events[self._name].append((e0, e1))
                return out
            return timed

    def __enter__(self):
        from repro_torch.kernels import ops

        self.ops = ops
        self.reset()
        self.orig = {attr: getattr(ops, attr) for attr in self.MODS.values()}
        for name, attr in self.MODS.items():
            setattr(ops, attr, self._Timed(self.orig[attr], name, self.events))
        return self

    def __exit__(self, *exc):
        for attr, mod in self.orig.items():
            setattr(self.ops, attr, mod)

    def reset(self):
        self.events = getattr(self, "events", {})
        self.events.clear()
        self.events.update({n: [] for n in self.MODS})

    def ms(self, counts):
        """Each kernel's device time since ``reset()``.  ``counts`` are the
        launch counters over the same span: every launch must have been
        timed (a count without its events means the path reached a kernel
        past the clock, and its time would read 0)."""
        import torch

        torch.cuda.synchronize()
        for n, ev in self.events.items():
            if len(ev) != counts.get(n, 0):
                raise AssertionError(f"kernel clock: {n} launched {counts.get(n, 0)} times, "
                                     f"{len(ev)} calls timed")
        return {n: sum(a.elapsed_time(b) for a, b in ev) for n, ev in self.events.items()}


def _family_init(cfg, dtype):
    """Random weights from seed 0 on the card, each block cast to ``dtype``
    as soon as it is drawn (a period of Jamba is 53 GB in f32)."""
    import torch

    from repro_torch.models.model import build_model
    from repro_torch.models.params import split_params

    model = build_model(cfg)
    gen = torch.Generator(device="cuda")
    gen.manual_seed(0)
    params, _ = split_params(model.init(gen, dtype=dtype))
    torch.cuda.synchronize()
    return model, params


def _family_forward(model, params, batch, rt, mods, clock):
    """One ``mode="full"`` forward under no_grad, after one of warm-up (the
    first call of a kernel at new argument types compiles it): its logits
    (f32), the launches of every kernel (counters zeroed just before, read
    just after), each kernel's device time in it, its seconds (host clock
    between two synchronises), the same on the device's clock (events)
    and the peak bytes."""
    import torch

    with torch.no_grad():
        model.apply(params, batch, rt=rt)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    clock.reset()
    _zero_counts(mods)  # just before the path ...
    e0, e1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    t0 = time.perf_counter()
    e0.record()
    with torch.no_grad():
        logits, aux, _ = model.apply(params, batch, rt=rt)
    e1.record()
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    counts = _counts(mods)  # ... and read just after
    out = logits.float()
    del logits
    return out, {"seconds": secs, "device_ms": e0.elapsed_time(e1), "launches": counts,
                 "kernel_ms": clock.ms(counts), "aux": float(aux),
                 "peak_memory_bytes": int(torch.cuda.max_memory_allocated())}


def _family_serve_steps(model, params, batch, rt, mods, steps, forced=None, graphed=False):
    """Prefill + ``steps`` decode steps through ``serve/serve_step.py``:
    the logits of every step (f32), the greedy tokens, the launches and
    the cache leaves right after the prefill (clones).  ``forced`` feeds
    these tokens instead of the greedy ones (so two paths see the same
    inputs); ``graphed`` prefills and decodes through the compiled steps
    (the prefill's first, eager call comes first, on the zeroed cache, and
    the prefill kept is a replay of its graph)."""
    import torch

    from repro_torch.models.params import split_params, tree_leaves
    from repro_torch.serve.serve_step import (greedy_sample, make_decode_step,
                                              make_graphed_decode_step,
                                              make_graphed_prefill_step, make_prefill_step,
                                              reset_cache)

    B, S = batch["tokens"].shape
    cache, _ = split_params(model.init_cache(B, S + steps + 1, device=batch["tokens"].device))
    prefill = (make_graphed_prefill_step if graphed else make_prefill_step)(model, rt)
    if graphed:
        prefill(params, batch, cache)
        cache = reset_cache(cache)
    _zero_counts(mods)
    logits, cache = prefill(params, batch, cache)
    prefill_counts = _counts(mods)
    filled = [t.clone() for t in tree_leaves(cache["layers"])]
    decode = (make_graphed_decode_step if graphed else make_decode_step)(model, rt)
    outs, toks = [logits.float()], [greedy_sample(logits)]
    _zero_counts(mods)
    for t in range(steps):
        logits, cache = decode(params, toks[-1] if forced is None else forced[t], cache)
        outs.append((logits.clone() if graphed else logits).float())  # a replay overwrites it
        toks.append(greedy_sample(logits))
    torch.cuda.synchronize()
    return (torch.cat(outs, dim=1), toks, {"prefill": prefill_counts, "decode": _counts(mods)},
            filled)


def _family_serve_f32(what, model, params, batch, rt, mods, tokens, counts, total):
    """The kernel path's prefill + decode again in f32 on the same weights
    and tokens: its logits, for the f32 comparison.  It must launch what the
    bf16 run launched (``counts``); both runs' launches go into ``total``."""
    k32, _, c32, _ = _family_serve_steps(model, params, batch, rt, mods, FAMILY_DECODE,
                                         forced=tokens)
    _family_expect(f"{what} f32 prefill+decode", c32, counts)
    for c in (counts, c32):
        _add_counts(total, c["prefill"])
        _add_counts(total, c["decode"])
    return k32


def _family_compare(what, k16, o16, o32, k32=None):
    """The kernel path against the oracle path (parity-phase style).  bf16:
    the kernel path no farther from the f32 oracle run than the bf16
    oracle path is (factor 1.25, plus 2 bf16 ulps of the largest logit for
    ties in rounding).  f32 (where run): the two paths within
    FAMILY_F32_RTOL of the largest logit."""
    import torch

    for name, t in (("kernels bf16", k16), ("oracle bf16", o16), ("oracle f32", o32)):
        if not bool(torch.isfinite(t).all()):
            raise AssertionError(f"families {what}: {name} logits are not finite")
    absmax = float(o32.abs().max())
    e_k, e_o = float((k16 - o32).abs().max()), float((o16 - o32).abs().max())
    out = {"logit_absmax": absmax, "bf16_ulp_at_absmax": _ulp(absmax),
           "kernels_vs_oracle_bf16": float((k16 - o16).abs().max()),
           "kernels_bf16_vs_oracle_f32": e_k, "oracle_bf16_vs_oracle_f32": e_o,
           "tolerance_bf16": 1.25 * e_o + 2 * _ulp(absmax)}
    if e_k > out["tolerance_bf16"]:
        raise AssertionError(f"families {what}: the bf16 kernel path is farther from the f32 "
                             f"oracle run ({e_k:.3e}) than 1.25x the oracle path's ({e_o:.3e})")
    if k32 is not None:
        e32 = float((k32 - o32).abs().max())
        out.update(kernels_vs_oracle_f32=e32, tolerance_f32=FAMILY_F32_RTOL * absmax)
        if e32 > FAMILY_F32_RTOL * absmax:
            raise AssertionError(f"families {what}: f32 kernel vs oracle path {e32:.3e} > "
                                 f"{FAMILY_F32_RTOL} x |logit| {absmax:.3e}")
    return out


def _family_expect(what, got, want):
    if got != want:
        raise AssertionError(f"families {what}: launches {got} != expected {want}: the path "
                             "ran past a kernel, or a kernel it should not")


def _family_route(what, got, want):
    if got != want:
        raise AssertionError(f"families {what}: attention ran on {got}, not {want}")


def _family_served(arch, mods, expect):
    """``launch.serve.main`` at full width: its report, launches (zeroed
    just before, read just after) and peak bytes."""
    import torch

    from repro_torch.launch import serve

    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    _zero_counts(mods)
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        done = serve.main(FAMILY_SERVE[arch])
    counts = _counts(mods)
    torch.cuda.synchronize()
    args = FAMILY_SERVE[arch]
    requests, gen_len = int(args[args.index("--requests") + 1]), int(args[args.index("--gen-len") + 1])
    if sorted(r for r, _ in done) != list(range(requests)) or any(
            t.shape != (gen_len,) for _, t in done):
        raise AssertionError(f"families {arch} serve: not every request was answered")
    _family_expect(f"{arch} serve", counts, expect)
    return dict(_serve_report(buf), args=args, launches=counts,
                peak_memory_bytes=int(torch.cuda.max_memory_allocated()))


def _add_counts(total, counts):
    for k, v in counts.items():
        total[k] = total.get(k, 0) + v


def phase_families(cx):
    """The remaining model families on the card, at full width, through the
    kernels (``scan_impl="cuda"`` puts K4 and K5 on their models' paths)
    and against the oracle path on the same weights and tokens:
    rwkv6-3b (32 layers: K5 x 32 and K1 x 65 a forward, f32 and bf16, then
    served), one period of Jamba v0.1 (8 layers, depth cut from 32: K4 x 7,
    K2 x 1 and the MoE at the config's capacity in a forward, then prefill
    + decode through serve_step), minicpm3-4b (62 layers, MLA: K2 at dh 96
    / dv 64) and whisper-base (encoder-decoder: K2 and K3 on self- and
    cross-attention), each served through ``launch/serve.py``."""
    import dataclasses

    import numpy as np
    import torch

    from repro_torch.configs import get_config
    from repro_torch.kernels import flash_attention as fla
    from repro_torch.models.params import tree_map
    from repro_torch.models.runtime import Runtime

    cx.model = cx.params = None
    torch.cuda.empty_cache()
    t_phase = time.perf_counter()
    mods = _kernel_wrappers()
    zero = {k: 0 for k in mods}
    total = dict(zero)
    rng = np.random.default_rng(0)
    rt_k = {d: Runtime(compute_dtype=d, attn_impl="cuda", scan_impl="cuda") for d in ("bf16", "f32")}
    rt_o = {d: Runtime(compute_dtype=d, attn_impl="ref", scan_impl="chunked") for d in ("bf16", "f32")}
    report = {}

    with _KernelClock() as clock:
        # -- rwkv6-3b: full width and depth ------------------------------------
        t0 = time.perf_counter()
        cfg = get_config("rwkv6-3b")
        assert (cfg.num_layers, cfg.d_model, cfg.d_model // cfg.rwkv.head_size) == (32, 2560, 40)
        L = cfg.num_layers
        model, p16 = _family_init(cfg, torch.bfloat16)
        p32 = tree_map(lambda a: a.float(), p16)  # the same (bf16-rounded) weights in f32
        tokens = torch.from_numpy(rng.integers(0, cfg.vocab_size, (FAMILY_B, FAMILY_S))
                                  .astype(np.int32)).cuda()
        batch = {"tokens": tokens}
        want = dict(zero, rmsnorm=2 * L + 1, gla_scan=L)
        runs = {}
        for label, params, rt in (("kernels_f32", p32, rt_k["f32"]), ("oracle_f32", p32, rt_o["f32"]),
                                  ("kernels_bf16", p16, rt_k["bf16"]),
                                  ("oracle_bf16", p16, rt_o["bf16"])):
            logits, info = _family_forward(model, params, batch, rt, mods, clock)
            if label.startswith("kernels"):
                _family_expect(f"rwkv6-3b {label}", info["launches"], want)
                _add_counts(total, info["launches"])
            runs[label] = (logits, info)
        cmp = _family_compare("rwkv6-3b", runs["kernels_bf16"][0], runs["oracle_bf16"][0],
                              runs["oracle_f32"][0], k32=runs["kernels_f32"][0])
        infos = {k: v[1] for k, v in runs.items()}
        del runs, p32, p16, model
        torch.cuda.empty_cache()
        served = _family_served("rwkv6-3b", mods, dict(  # the prefill's K5 stores the state
            zero, rmsnorm=(2 * L + 1) * 32, gla_scan_state=L))
        _add_counts(total, served["launches"])
        report["rwkv6-3b"] = {"layers": L, "d_model": cfg.d_model, "B": FAMILY_B, "S": FAMILY_S,
                              "params": cfg.param_counts()["total"], "forward": infos,
                              "compare": cmp, "serve": served,
                              "seconds": time.perf_counter() - t0}
        emit({"phase": "families", "model": "rwkv6-3b", **report["rwkv6-3b"]})

        # -- jamba-v0.1-52b: full width, depth cut to one period ------------------
        t0 = time.perf_counter()
        full = get_config("jamba-v0.1-52b")
        cfg = dataclasses.replace(full, num_layers=full.layer_period())
        plan = cfg.layer_plan()
        assert (cfg.num_layers, cfg.d_model, cfg.mamba.expand * cfg.d_model, cfg.mamba.d_state,
                cfg.moe.num_experts, cfg.moe.d_expert) == (8, 4096, 8192, 16, 16, 14336)
        n_mamba = sum(m == "mamba" for m, _ in plan)
        n_attn = sum(m == "attn" for m, _ in plan)
        model, p16 = _family_init(cfg, torch.bfloat16)
        tokens = torch.from_numpy(rng.integers(0, cfg.vocab_size, (FAMILY_B, FAMILY_S))
                                  .astype(np.int32)).cuda()
        batch = {"tokens": tokens}
        want = dict(zero, rmsnorm=2 * cfg.num_layers + 1, ssm_scan=n_mamba,
                    flash_attention=n_attn)
        runs = {}
        # the f32 runs compute in f32 on the bf16 weights (cast at use: an f32
        # copy of the period would not fit beside them)
        for label, rt in (("kernels_bf16", rt_k["bf16"]), ("oracle_bf16", rt_o["bf16"]),
                          ("kernels_f32", rt_k["f32"]), ("oracle_f32", rt_o["f32"])):
            logits, info = _family_forward(model, p16, batch, rt, mods, clock)
            if label.startswith("kernels"):
                _family_expect(f"jamba {label}", info["launches"], want)
                _add_counts(total, info["launches"])
            if label == "kernels_bf16":
                flash_kernel = fla.flash_attention.last_kernel
            runs[label] = (logits, info)
        cmp = _family_compare("jamba", runs["kernels_bf16"][0], runs["oracle_bf16"][0],
                              runs["oracle_f32"][0], k32=runs["kernels_f32"][0])
        infos = {k: v[1] for k, v in runs.items()}
        del runs
        torch.cuda.empty_cache()
        # prefill + decode through serve_step: K2 / K3 on the attention layer
        sb = {"tokens": tokens[:, :512]}
        lk, tk, ck, fk = _family_serve_steps(model, p16, sb, rt_k["bf16"], mods, FAMILY_DECODE)
        _family_expect("jamba prefill", ck["prefill"], dict(
            zero, rmsnorm=2 * cfg.num_layers + 1, flash_attention=n_attn))
        _family_expect("jamba decode", ck["decode"], dict(
            zero, rmsnorm=(2 * cfg.num_layers + 1) * FAMILY_DECODE,
            decode_attention=n_attn * FAMILY_DECODE))
        # the same prefill and decode through the compiled steps: equal bit for bit
        lg, tg, cg, fg = _family_serve_steps(model, p16, sb, rt_k["bf16"], mods,
                                             FAMILY_DECODE, forced=tk, graphed=True)
        _prefill_equal("jamba", (lk[:, 0], fk), (lg[:, 0], fg))
        _graphed_equal("jamba", [lk[:, i] for i in range(lk.shape[1])], tk,
                       [lg[:, i] for i in range(lg.shape[1])], tg)
        _family_expect("jamba graphed prefill+decode", cg, ck)
        _add_counts(total, cg["prefill"])
        _add_counts(total, cg["decode"])
        del lg, fg, fk
        k32 = _family_serve_f32("jamba", model, p16, sb, rt_k["f32"], mods, tk, ck, total)
        lo, _, _, _ = _family_serve_steps(model, p16, sb, rt_o["bf16"], mods, FAMILY_DECODE, forced=tk)
        l32, _, _, _ = _family_serve_steps(model, p16, sb, rt_o["f32"], mods, FAMILY_DECODE, forced=tk)
        cmp_serve = _family_compare("jamba prefill+decode", lk, lo, l32, k32=k32)
        del model, p16, lk, lo, l32, k32
        torch.cuda.empty_cache()
        report["jamba-v0.1-52b"] = {
            "layers": cfg.num_layers, "cut_from_layers": full.num_layers, "d_model": cfg.d_model,
            "plan": [list(x) for x in plan], "params": cfg.param_counts()["total"],
            "B": FAMILY_B, "S": FAMILY_S, "moe_capacity": {
                "factor": cfg.moe.capacity_factor, "slots_per_expert": math.ceil(
                    cfg.moe.capacity_factor * FAMILY_S * cfg.moe.top_k / cfg.moe.num_experts)},
            "flash_kernel": flash_kernel, "forward": infos, "compare": cmp,
            "serve_steps": {"prompt": 512, "decode_steps": FAMILY_DECODE, "launches": ck,
                            "compare": cmp_serve, "graphed_equal_bit_for_bit": True,
                            "graphed_prefill_equal_bit_for_bit": True},
            "seconds": time.perf_counter() - t0}
        emit({"phase": "families", "model": "jamba-v0.1-52b", **report["jamba-v0.1-52b"]})
        _family_route("jamba", flash_kernel, "wgmma")

        # -- minicpm3-4b: full width and depth (MLA) --------------------------------
        t0 = time.perf_counter()
        cfg = get_config("minicpm3-4b")
        assert (cfg.num_layers, cfg.d_model, cfg.num_heads) == (62, 2560, 40)
        L = cfg.num_layers
        model, p16 = _family_init(cfg, torch.bfloat16)
        tokens = torch.from_numpy(rng.integers(0, cfg.vocab_size, (FAMILY_B, 512))
                                  .astype(np.int32)).cuda()
        sb = {"tokens": tokens}
        lk, tk, ck, _ = _family_serve_steps(model, p16, sb, rt_k["bf16"], mods, FAMILY_DECODE)
        flash_kernel = fla.flash_attention.last_kernel
        norms = 4 * L + 1  # norm1, norm2, q_norm, kv_norm a layer, the final norm
        _family_expect("minicpm3 prefill", ck["prefill"], dict(zero, rmsnorm=norms,
                                                                flash_attention=L))
        # decode attends in the latent space on the oracle, as the reference
        _family_expect("minicpm3 decode", ck["decode"], dict(zero, rmsnorm=norms * FAMILY_DECODE))
        k32 = _family_serve_f32("minicpm3-4b", model, p16, sb, rt_k["f32"], mods, tk, ck, total)
        lo, _, _, _ = _family_serve_steps(model, p16, sb, rt_o["bf16"], mods, FAMILY_DECODE, forced=tk)
        l32, _, _, _ = _family_serve_steps(model, p16, sb, rt_o["f32"], mods, FAMILY_DECODE, forced=tk)
        cmp = _family_compare("minicpm3-4b", lk, lo, l32, k32=k32)
        del model, p16, lk, lo, l32, k32
        torch.cuda.empty_cache()
        served = _family_served("minicpm3-4b", mods, dict(
            zero, rmsnorm=norms * 16, flash_attention=L))
        _add_counts(total, served["launches"])
        report["minicpm3-4b"] = {"layers": L, "d_model": cfg.d_model,
                                 "params": cfg.param_counts()["total"], "prompt": 512,
                                 "flash_kernel": flash_kernel, "launches": ck, "compare": cmp,
                                 "serve": served, "seconds": time.perf_counter() - t0}
        emit({"phase": "families", "model": "minicpm3-4b", **report["minicpm3-4b"]})
        _family_route("minicpm3-4b", flash_kernel, "mma")

        # -- whisper-base: encoder-decoder -------------------------------------
        t0 = time.perf_counter()
        cfg = get_config("whisper-base")
        assert (cfg.encoder_layers, cfg.num_layers, cfg.d_model, cfg.encoder_seq_len) == (
            6, 6, 512, 1500)
        model, p16 = _family_init(cfg, torch.bfloat16)
        tokens = torch.from_numpy(rng.integers(0, cfg.vocab_size, (FAMILY_B, 64))
                                  .astype(np.int32)).cuda()
        gen = torch.Generator(device="cuda")
        gen.manual_seed(1)
        enc = torch.randn((FAMILY_B, cfg.encoder_seq_len, cfg.d_model), generator=gen,
                          device=tokens.device)
        sb = {"tokens": tokens, "encoder_embeds": enc}
        E, Ld = cfg.encoder_layers, cfg.num_layers
        lk, tk, ck, _ = _family_serve_steps(model, p16, sb, rt_k["bf16"], mods, FAMILY_DECODE)
        _family_expect("whisper prefill", ck["prefill"], dict(zero, flash_attention=E + 2 * Ld))
        _family_expect("whisper decode", ck["decode"], dict(
            zero, decode_attention=2 * Ld * FAMILY_DECODE))
        k32 = _family_serve_f32("whisper-base", model, p16, sb, rt_k["f32"], mods, tk, ck, total)
        lo, _, _, _ = _family_serve_steps(model, p16, sb, rt_o["bf16"], mods, FAMILY_DECODE, forced=tk)
        l32, _, _, _ = _family_serve_steps(model, p16, sb, rt_o["f32"], mods, FAMILY_DECODE, forced=tk)
        cmp = _family_compare("whisper-base", lk, lo, l32, k32=k32)
        del model, p16, lk, lo, l32, k32
        torch.cuda.empty_cache()
        served = _family_served("whisper-base", mods, dict(
            zero, flash_attention=E + 2 * Ld, decode_attention=2 * Ld * 31))
        _add_counts(total, served["launches"])
        report["whisper-base"] = {"layers": [E, Ld], "d_model": cfg.d_model,
                                  "encoder_frames": cfg.encoder_seq_len,
                                  "params": cfg.param_counts()["total"], "launches": ck,
                                  "compare": cmp, "serve": served,
                                  "seconds": time.perf_counter() - t0}
        emit({"phase": "families", "model": "whisper-base", **report["whisper-base"]})

    for k in ("ssm_scan", "gla_scan"):
        if total[k] <= 0:
            raise AssertionError(f"families: {k} was not launched on a model path")
    cx.family_launches = total
    emit({"phase": "families", "gpu": cx.smi, "family_launches": total,
          "seconds": time.perf_counter() - t_phase})


# ---------------------------------------------------------------------------
# the paper's experiment on the card, and the thread knobs in fresh processes
# ---------------------------------------------------------------------------


def _paper_points(history):
    """Each measured point of a tuning run: value, point, step seconds, peak
    device bytes, the attention tile it ran with, or why it failed."""
    out = []
    for e in history.evals:
        m = e.meta
        out.append({"point": e.point, "value": e.value,
                    "step_seconds": m.get("step_seconds"), "iters": m.get("iters"),
                    "peak_bytes": m.get("peak_bytes"), "attn_config": m.get("attn_config"),
                    "attn_kernel": m.get("attn_kernel"), "oom": bool(m.get("oom")),
                    "error": m.get("error")})
    return out


def _paper_tune(name, ev, space, mods, budget, algos):
    """``quickstart.tune`` of one workload, the kernels' counts zeroed just
    before and read just after; per engine its best, coverage, seconds and
    ask seconds, and every point."""
    import torch

    from repro_torch.examples import quickstart

    seen = []

    class Seen(type(ev)):  # every point's answer, to say why a run found no finite one
        def __call__(self, point, fidelity=None):
            try:
                out = super().__call__(point, fidelity)
            except Exception as e:
                seen.append((point, repr(e)[:400]))
                raise
            seen.append((point, out[0], out[1].get("error")))
            return out

    ev.__class__ = Seen
    _zero_counts(mods)
    t0 = time.perf_counter()
    try:
        results = quickstart.tune(ev, space, budget=budget, seed=0, algos=algos,
                                  verbose=False, emit=lambda *_: None)
    except AssertionError as e:
        raise AssertionError(f"paper {name}: {e}: {seen}") from e
    seconds = time.perf_counter() - t0
    counts = _counts(mods)
    torch.cuda.synchronize()
    engines, n_oom, peak = {}, 0, 0
    for algo, r in results.items():
        points = _paper_points(r["history"])
        for i, p in enumerate(points):
            emit({"phase": "paper", "workload": name, "engine": algo, "i": i, **p})
        n_oom += sum(p["oom"] for p in points)
        # a batch that does not split into the microbatches fails in the
        # reference too (-inf); any other failure fails the phase
        indivisible = [p for p in points if "does not split into" in (p["error"] or "")]
        failed = [p for p in points if not math.isfinite(p["value"]) and not p["oom"]
                  and p not in indivisible]
        if failed:
            raise AssertionError(f"paper {name} {algo}: a point failed: {failed[0]}")
        peak = max([peak] + [p["peak_bytes"] or 0 for p in points])
        best = r["best"]
        asks = sum(r["ask_seconds"])
        engines[algo] = {"best_value": best.value, "best_point": best.point,
                         "coverage": r["coverage"], "seconds": r["seconds"],
                         "ask_seconds": asks, "ask_share": asks / r["seconds"],
                         "asks": len(r["ask_seconds"]), "points": len(points),
                         "oom_points": sum(p["oom"] for p in points),
                         "indivisible_points": len(indivisible)}
        if not math.isfinite(best.value):
            raise AssertionError(f"paper {name} {algo}: no point ran")
    return {"engines": engines, "launches": counts, "seconds": seconds,
            "oom_points": n_oom, "peak_bytes": peak}


def phase_paper(cx):
    """The paper's experiment on the card, through the entry points a user
    calls (``repro_torch.benchmarks.workloads.MeasuredEvaluator`` under
    ``repro_torch.examples.quickstart.tune``).  dense_lm at qwen2-0.5b's
    full width and depth: BO, GA and NMS, budget 8 each, K1 and K2 on the
    path; one point's step time against the train phase's median step, and
    its loss on the kernel path against the oracle path from the same
    weights and batch.  Then moe_lm (K2) and rwkv (K5) at full width, depth
    cut, and the convnet and NCF at the reference's sizes, 4 GA points
    each.  An out-of-memory point scores -inf, as a failed run does."""
    import torch

    from repro_torch.benchmarks import workloads as wl
    from repro_torch.core import SearchSpace
    from repro_torch.models.runtime import Runtime

    cx.model = cx.params = None
    torch.cuda.empty_cache()
    mods = _kernel_wrappers()
    total = {k: 0 for k in mods}
    report = {}
    by_name = {w["name"]: w for w in wl.MEASURED_WORKLOADS}

    # -- dense_lm: full width and depth, the three engines --------------------
    w = by_name["dense_lm"]
    cfg = wl.lm_config(w, reduced=False)
    assert (cfg.num_layers, cfg.d_model, cfg.vocab_size) == (24, 896, 151936)
    build = dict(reduced=False, seq_len=PAPER_SEQ)
    params = wl.lm_params(cfg, device="cuda")
    ev = wl.MeasuredEvaluator(w, device="cuda", iters=2, params=params, **build)
    space = SearchSpace.from_dicts(w["space"])
    run = _paper_tune("dense_lm", ev, space, mods, PAPER_BUDGET, ("bo", "ga", "nms"))
    for k in ("rmsnorm", "flash_attention"):
        if run["launches"][k] <= 0:
            raise AssertionError(f"paper dense_lm: {k} was not launched")
    _add_counts(total, run["launches"])

    # a point whose batch does not fit the card: -inf as a failed run, and
    # the next point (the cross-check's) measures as before
    oom_value, oom_meta = ev(PAPER_OOM_POINT)
    if oom_value != -math.inf or not oom_meta.get("oom"):
        raise AssertionError(f"paper: the out-of-memory point scored {oom_value}: {oom_meta}")
    emit({"phase": "paper", "workload": "dense_lm", "part": "out_of_memory",
          "point": PAPER_OOM_POINT, "value": oom_value, "meta": oom_meta})

    # the cross-check: the train phase's step through the workload's harness
    value, meta = ev(PAPER_CHECK_POINT)
    check = {"point": PAPER_CHECK_POINT, "value": value, "step_seconds": meta.get("step_seconds"),
             "attn_config": meta.get("attn_config"), "peak_bytes": meta.get("peak_bytes"),
             "train_median_step_seconds": getattr(cx, "train_median_step", None)}
    if not math.isfinite(value):
        raise AssertionError(f"paper: the check point failed: {meta}")
    if check["train_median_step_seconds"] is not None:
        rel = abs(meta["step_seconds"] / cx.train_median_step - 1)
        check["rel_diff"] = rel
        if rel > PAPER_STEP_RTOL:
            raise AssertionError(f"paper: step {meta['step_seconds']:.5f} s is {rel:.1%} from "
                                 f"the train phase's {cx.train_median_step:.5f} s")
    else:
        check["rel_diff"] = "not checked: the train phase did not run"

    # the parity check: one loss, kernel path against oracle path
    oracle = Runtime(compute_dtype="f32", attn_impl="chunked", scan_impl="chunked")
    losses = {}
    for label, rt in (("kernels", None), ("oracle", oracle)):
        fn, args, _ = wl.measured_make_step(w, device="cuda", params=params, runtime=rt,
                                            **build)(PAPER_CHECK_POINT)
        _zero_counts(mods)
        losses[label] = float(fn(*args))
        launched = _counts(mods)
        del fn, args
        if (label == "oracle") != (sum(launched.values()) == 0):
            raise AssertionError(f"paper parity: the {label} path launched {launched}")
    rel = abs(losses["kernels"] - losses["oracle"]) / abs(losses["oracle"])
    if not (math.isfinite(losses["kernels"]) and rel <= PAPER_LOSS_RTOL):
        raise AssertionError(f"paper parity: losses {losses}, rel {rel:.3e}")
    report["dense_lm"] = dict(run, layers=cfg.num_layers, d_model=cfg.d_model, seq=PAPER_SEQ,
                              params=cfg.param_counts()["total"], check=check,
                              eager_best_tokens_per_s_range=PAPER_EAGER_BEST,
                              parity={"losses": losses, "rel": rel, "rtol": PAPER_LOSS_RTOL})
    emit({"phase": "paper", "workload": "dense_lm", **report["dense_lm"]})
    del ev, params
    torch.cuda.empty_cache()

    # -- the other four: GA, 4 points each ------------------------------------
    for name, needs in (("moe_lm", "flash_attention"), ("rwkv", "gla_scan"),
                        ("convnet", None), ("ncf", None)):
        w = by_name[name]
        extra = {}
        if w["kind"] == "lm":
            extra = dict(build, num_layers=PAPER_LAYERS[name])
            cfg = wl.lm_config(w, reduced=False, num_layers=PAPER_LAYERS[name])
            extra_report = {"layers": cfg.num_layers, "d_model": cfg.d_model, "seq": PAPER_SEQ,
                            "params": cfg.param_counts()["total"]}
        else:
            extra_report = {}
        ev = wl.MeasuredEvaluator(w, device="cuda", iters=2, **extra)
        run = _paper_tune(name, ev, SearchSpace.from_dicts(w["space"]), mods,
                          PAPER_SMALL_BUDGET, ("ga",))
        if needs is not None and run["launches"][needs] <= 0:
            raise AssertionError(f"paper {name}: {needs} was not launched")
        _add_counts(total, run["launches"])
        report[name] = dict(run, **extra_report)
        emit({"phase": "paper", "workload": name, **report[name]})
        del ev
        torch.cuda.empty_cache()

    cx.paper_launches = total
    emit({"phase": "paper", "gpu": cx.smi, "paper_launches": total,
          "oom_points": {k: v["oom_points"] for k, v in report.items()},
          "peak_bytes": {k: v["peak_bytes"] for k, v in report.items()},
          "seconds": {k: v["seconds"] for k, v in report.items()}})


def _openmp_library():
    """The OpenMP runtime mapped into this process (GNU ``libgomp`` or Intel
    ``libiomp5``): what decides whether ``KMP_BLOCKTIME`` is read at all."""
    with open("/proc/self/maps") as f:
        names = {os.path.basename(line.split()[-1]) for line in f if "omp" in line}
    return sorted(n for n in names if n.startswith(("libgomp", "libiomp", "libomp")))


def phase_host_knobs(cx):
    """The paper's thread knobs in fresh processes: K1 at its sweep shape
    through ``KernelTuneEvaluator(allow_subprocess=True)``, one child
    process at each of two ``intra_op_threads``; each child reports the
    thread counts it ran with."""
    import torch

    from repro_torch.tuning.kernel_objective import KernelTuneEvaluator, kernel_space

    shape = SWEEP_SHAPES["rmsnorm"]
    dims = {d["name"]: d["choices"] for d in kernel_space("rmsnorm", shape, host_knobs=True)
            if d["name"].endswith("_threads")}
    ev = KernelTuneEvaluator("rmsnorm", shape, warmup=1, iters=2, rel_halfwidth=0.5,
                             device="cuda", allow_subprocess=True)
    children = []
    for n in HOST_THREADS:
        value, meta = ev({"intra_op_threads": n})
        threads = meta.get("threads", {})
        children.append({"intra_op_threads": n, "value": value, "threads": threads,
                         "child_seconds": meta.get("child_seconds"),
                         "step_seconds": meta.get("step_seconds"), "error": meta.get("error")})
        if not math.isfinite(value):
            raise AssertionError(f"host_knobs: the child at {n} threads failed: {meta}")
        if threads.get("intra_op_threads") != n or threads.get("OMP_NUM_THREADS") != str(n):
            raise AssertionError(f"host_knobs: the child asked for {n} threads ran with {threads}")
    info = torch.__config__.parallel_info()
    emit({"phase": "host_knobs", "gpu": cx.smi, "kernel": "rmsnorm", "shape": shape,
          "dtype": "f32", "choices": dims, "children": children,
          "parent_threads": {"intra_op": torch.get_num_threads(),
                             "inter_op": torch.get_num_interop_threads()},
          "openmp_library": _openmp_library(),
          "parallel_info": [line.strip() for line in info.splitlines() if line.strip()]})


def kernels_line(cx):
    """The contract line: one entry per kernel, at the main path's shape and
    type.  The served kernels (bf16; the RMSNorm entry is the prefill one,
    rows = 8*512) count their launches in the ``serve`` phase; the scans
    (f32, the sweep's type and shape) in the ``sweep`` phase, which is their
    path.  ``bo_launches`` counts each kernel's launches in the ``bo``
    phase; ``train_launches`` in the 12 steps of the ``train`` phase's main
    run (K1 and K2 forward; the scans and decode are not on that path);
    ``family_launches`` in the ``families`` phase; ``paper_launches`` in the
    ``paper`` phase, summed over its five workloads; ``roofline_launches``
    in the ``roofline`` phase's three steps on the kernel path;
    ``multichip_launches`` in the ``multichip`` phase's expert-parallel
    forward; ``graphs_launches`` in the ``graphs`` phase's eager and
    compiled decode steps.  K5's gradient (``gla_scan_bwd``, f32 at the
    training cell's shape) replaces no TPU kernel and counts its launches
    in the ``train_families`` phase, which is its path."""
    meta = {  # route, source, replaces (the pallas_call line), dtype, shape, launches
        "rmsnorm": ("triton", "src/repro_torch/kernels/rmsnorm.py",
                    "src/repro/kernels/rmsnorm.py:40", "bf16", "rows=4096 D=896",
                    cx.launches),
        "flash_attention": ("cuda", "src/repro_torch/kernels/csrc/flash_attention.cu",
                            "src/repro/kernels/flash_attention.py:163", "bf16",
                            "B=8 Sq=Sk=512 H=14 K=2 dh=64 causal", cx.launches),
        "decode_attention": ("cuda", "src/repro_torch/kernels/csrc/decode_attention.cu",
                             "src/repro/kernels/decode_attention.py:112", "bf16",
                             "B=8 Smax=576 len=575 H=14 K=2 dh=64", cx.launches),
        "ssm_scan": ("cuda", "src/repro_torch/kernels/csrc/ssm_scan.cu",
                     "src/repro/kernels/ssm_scan.py:89", "f32", "B=2 S=2048 D=8192 N=16",
                     cx.sweep_launches),
        "gla_scan": ("cuda", "src/repro_torch/kernels/csrc/gla_scan.cu",
                     "src/repro/kernels/gla_scan.py:89", "f32", "B=2 S=2048 H=40 dk=64 dv=64",
                     cx.sweep_launches),
        "gla_scan_bwd": ("cuda", "src/repro_torch/kernels/csrc/gla_scan_bwd.cu", "none", "f32",
                         "B=2 S=2048 H=40 dk=64 dv=64", cx.train_family_launches),
        "gla_scan_state": ("cuda", "src/repro_torch/kernels/csrc/gla_scan.cu",
                           "src/repro/kernels/gla_scan.py:89", "bf16",
                           "B=64 S=2048 H=40 dk=64 dv=64", cx.family_launches),
    }
    out = []
    for name, (route, source, replaces, dtype, shape, counts) in meta.items():
        row = next(r for r in cx.at_main[name]
                   if r["dtype"] == dtype and r["shape"] == shape)
        launches = counts[name]
        if launches <= 0:
            raise AssertionError(f"{name}: not launched on the main path")
        # an exponential is an operation (on the special-function units)
        by = "bytes" if row["bound_by"] == "bytes" else "operations"
        out.append({"name": name, "route": route, "source": source, "replaces": replaces,
                    "launches": launches, "max_abs_err": row["max_abs_err"], "ms": row["ms"],
                    "plain_ms": row["plain_ms"], "bound_ms": row["bound_ms"],
                    "bound_by": by, "library_ms": row["library_ms"],
                    "bo_launches": cx.bo_launches[name],
                    "train_launches": cx.train_launches[name],
                    "family_launches": cx.family_launches[name],
                    "paper_launches": cx.paper_launches[name],
                    "roofline_launches": cx.roofline_launches[name],
                    "multichip_launches": cx.multichip_launches[name],
                    "train_families_launches": cx.train_family_launches[name],
                    "graphs_launches": cx.graphs_launches[name],
                    "shape": row["shape"], "dtype": dtype})
    emit({"kernels": out})


def _event_seconds(fn, reps):
    """Seconds of one ``fn()`` on the card: CUDA events around ``reps``
    calls after two untimed ones."""
    import torch

    for _ in range(2):
        fn()
    start, stop = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(reps):
        fn()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / 1e3 / reps


def _tune_run(tmp, algo, tag, shape="train_4k"):
    """``python -m repro_torch.launch.tune`` on qwen2-0.5b / ``shape``, started
    in the background: (process, its command, its history path, its start).
    Runs of one algorithm on one shape share a memo cache."""
    hist = os.path.join(tmp, f"{tag}.json")
    cmd = [sys.executable, "-m", "repro_torch.launch.tune", "--arch", ROOFLINE_ARCH,
           "--shape", shape, "--algo", algo, "--budget", str(ROOFLINE_BUDGET),
           "--memo-cache", os.path.join(tmp, f"{algo}_{shape}.memo.json"), "--out", hist]
    env = dict(os.environ, PYTHONPATH=os.path.join(HERE, "src"))
    proc = subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
                            env=env, cwd=HERE)
    return proc, cmd, hist, time.perf_counter()


def _tune_result(run):
    """Wait for a tuning run; its evaluations, -inf count and best point."""
    proc, cmd, hist, t0 = run
    log, _ = proc.communicate(timeout=600)
    secs = time.perf_counter() - t0
    if proc.returncode != 0:
        raise AssertionError(f"roofline: {' '.join(cmd[2:])} exited {proc.returncode}:\n"
                             + log[-3000:])
    with open(hist) as f:
        evals = json.load(f)
    finite = [e for e in evals if math.isfinite(e["value"])]
    best = max(finite, key=lambda e: e["value"]) if finite else None
    return {"command": " ".join(["python"] + cmd[1:]), "seconds": secs,
            "evaluations": len(evals),
            "evaluated": sum(1 for e in evals if not e["meta"].get("memoized")),
            "minus_inf": len(evals) - len(finite),
            "oom": sum(1 for e in evals if e["meta"].get("oom")),
            "best_point": best and best["point"], "best_tok_s": best and best["value"],
            "points": [[e["point"], e["value"], e["meta"].get("mem_per_device_B")]
                       for e in evals]}


@contextlib.contextmanager
def _tap_decode(calls):
    """While active, every K3 call that the dispatch layer (``kernels/ops.py``)
    makes is appended to ``calls`` as ``(q, k, v, lengths, scale, out)``:
    the inputs the path gave the kernel (the cache's layers as views, not
    copies) and what it returned."""
    from repro_torch.kernels import ops

    mod = ops._decode_mod

    def tapped(q, k, v, lengths, **kw):
        out = mod.decode_attention(q, k, v, lengths, **kw)
        calls.append((q, k, v, lengths, kw.get("scale"), out))
        return out

    ops._decode_mod = types.SimpleNamespace(decode_attention=tapped)
    try:
        yield
    finally:
        ops._decode_mod = mod


def _decode_calls_vs_plain(calls, layers):
    """Each tapped K3 call held against ``decode_attention_plain`` on the same
    inputs: the kernels' tolerance (``check_close``) and ROOFLINE_ULPS bf16
    ulps of the plain output's largest |value| (a zero output misses
    both).  Run before the next step writes the cache."""
    import torch

    from repro_torch.kernels import decode_attention as dec

    if len(calls) != layers:
        raise AssertionError(f"roofline decode: {len(calls)} K3 calls in a step of {layers} layers")
    worst = {"calls": len(calls), "max_abs_err": 0.0, "max_ulps": 0.0, "min_abs_plain": math.inf}
    for i, (q, k, v, lengths, scale, got) in enumerate(calls):
        want = dec.decode_attention_plain(q, k, v, lengths, scale=scale)
        check_close("decode_attention", f"roofline decode, layer {i}", got, want,
                    TOL["decode_attention"]["bf16" if q.dtype == torch.bfloat16 else "f32"])
        absmax, err = float(want.float().abs().max()), max_err(got, want)
        ulps = err / _ulp(absmax)
        if ulps > ROOFLINE_ULPS:
            raise AssertionError(f"roofline decode, layer {i}: K3 {err:.3e} from its plain "
                                 f"version, {ulps:.1f} ulps of {absmax:.3e}")
        worst["max_abs_err"] = max(worst["max_abs_err"], err)
        worst["max_ulps"] = max(worst["max_ulps"], ulps)
        worst["min_abs_plain"] = min(worst["min_abs_plain"], absmax)
    return worst


def _roofline_row(rec):
    r = rec["roofline"]
    return {k: r[k] for k in ("compute_s", "memory_s", "collective_s", "bottleneck",
                              "est_step_s", "throughput_tok_s", "mfu", "useful_flops_ratio",
                              "fits_hbm", "memory_s_hlo_raw", "kernel_credit_GB")}


def phase_roofline(cx):
    """The roofline path for one card (``repro_torch.launch.dryrun``,
    ``repro_torch.launch.tune``), checked against the card.  (1) The card's
    memory, copy rate and bf16 matmul rate beside the data sheet's figures
    the cost model keeps.  (2) Dry runs of qwen2-0.5b: train_4k at BASELINE
    and two other points, decode_32k.  (3) The tuning CLI, BO and GA at
    budget 8 on train_4k (started first, in the background: a dry run needs
    no card), then BO again from its memo cache, which must evaluate
    nothing; BO at budget 8 on decode_32k, whose points fit, must pick a
    finite one.  (4) Three steps at full width and depth, bf16 as BASELINE
    says, each analysed by the dry run and then run on the card: its peak
    bytes on the chunked path that was traced against
    ``max_memory_allocated`` (ratio within ROOFLINE_MEM_BAND), and its
    median step on the kernel path against the roofline's estimate, with
    K1 / K2 / K3 launched where the path has them, each kernel's device
    time in one more step, and its output held against the chunked
    path's.  The decode cache is filled with seeded values first, so that
    K3 attends over data at every one of its 32,768 rows."""
    import tempfile

    t_phase = time.perf_counter()
    tmp = tempfile.mkdtemp(prefix="chip_smoke_roofline_")
    tuning = {"bo": _tune_run(tmp, "bo", "bo"), "ga": _tune_run(tmp, "ga", "ga"),
              "bo_decode": _tune_run(tmp, "bo", "bo_decode", shape="decode_32k")}
    try:
        _roofline_body(cx, tmp, tuning, t_phase)
    finally:  # a failure leaves no tuning run behind
        for proc, *_ in tuning.values():
            if proc.poll() is None:
                proc.kill()
                proc.wait()
        shutil.rmtree(tmp, ignore_errors=True)


def _roofline_body(cx, tmp, tuning, t_phase):
    import dataclasses
    import gc
    import statistics

    import torch
    from torch.utils._pytree import tree_flatten

    from repro_torch.configs import get_config
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.launch import dryrun
    from repro_torch.tuning import cost_model
    from repro_torch.tuning.parameters import BASELINE

    # -- (1) the card beside the data sheet --------------------------------------
    cx.model = cx.params = None
    gc.collect()
    torch.cuda.empty_cache()
    props = torch.cuda.get_device_properties(0)
    src = torch.empty(COPY_BYTES, dtype=torch.uint8, device="cuda")
    dst = torch.empty_like(src)
    copy_s = _event_seconds(lambda: dst.copy_(src), reps=10)
    del src, dst
    a = torch.randn(MATMUL_N, MATMUL_N, dtype=torch.bfloat16, device="cuda")
    b = torch.randn(MATMUL_N, MATMUL_N, dtype=torch.bfloat16, device="cuda")
    mm_s = _event_seconds(lambda: torch.matmul(a, b), reps=10)
    del a, b
    torch.cuda.empty_cache()
    copy_rate, mm_rate = 2 * COPY_BYTES / copy_s, 2 * MATMUL_N ** 3 / mm_s
    emit({"phase": "roofline", "part": "card", "gpu": cx.smi,
          "total_memory_B": props.total_memory, "data_sheet_hbm_B": cost_model.HBM_BYTES,
          "copy_GiB": COPY_BYTES / 2 ** 30, "copy_s": copy_s, "copy_B_per_s": copy_rate,
          "data_sheet_B_per_s": cost_model.HBM_BW, "copy_share": copy_rate / cost_model.HBM_BW,
          "matmul_n": MATMUL_N, "matmul_s": mm_s, "matmul_bf16_flop_per_s": mm_rate,
          "data_sheet_bf16_flop_per_s": cost_model.PEAK_FLOPS_BF16,
          "matmul_share": mm_rate / cost_model.PEAK_FLOPS_BF16})

    # -- (2) dry runs --------------------------------------------------------------
    dry = []
    for shape_name, label, point in (("train_4k", "baseline", {}),
                                     *(("train_4k", k, v) for k, v in ROOFLINE_POINTS.items()),
                                     ("decode_32k", "baseline", {})):
        rec = dryrun.analyze_cell(ROOFLINE_ARCH, shape_name, bc=BASELINE.replace(**point))
        row = {"phase": "roofline", "part": "dryrun", "arch": ROOFLINE_ARCH, "shape": shape_name,
               "point": label, "backend": point, "roofline": _roofline_row(rec),
               "per_device_B": rec["memory"]["per_device_B"], "memory": rec["memory"],
               "flops": rec["cost"]["flops_per_device"], "ops": rec["cost"]["ops"],
               "trace_seconds": rec["compile_seconds"]}
        if not (rec["roofline"]["est_step_s"] > 0 and rec["memory"]["per_device_B"] > 0):
            raise AssertionError(f"roofline: dry run {shape_name}/{label}: {row}")
        dry.append(row)
        emit(row)

    # -- (3) the tuning CLI ----------------------------------------------------------
    tuned = {algo: _tune_result(run) for algo, run in tuning.items()}
    rerun = _tune_result(_tune_run(tmp, "bo", "bo_again"))
    if rerun["evaluated"] != 0 or rerun["evaluations"] != tuned["bo"]["evaluations"]:
        raise AssertionError(f"roofline: the BO re-run evaluated {rerun['evaluated']} points")
    for tag, res in (*tuned.items(), ("bo_again", rerun)):
        if res["evaluations"] < ROOFLINE_BUDGET - 1:
            raise AssertionError(f"roofline: {tag} ran {res['evaluations']} points")
        emit({"phase": "roofline", "part": "tune", "algo": tag, **res})
    if tuned["bo_decode"]["best_tok_s"] is None:
        raise AssertionError("roofline: BO on decode_32k found no finite point: "
                             f"{tuned['bo_decode']['points']}")

    # -- (4) dry run against the card ---------------------------------------------------
    cfg = get_config(ROOFLINE_ARCH)
    mods = _kernel_wrappers()
    total = {k: 0 for k in mods}
    kernel_rt = dataclasses.replace(BASELINE.runtime(), attn_impl="cuda", scan_impl="cuda")
    checks = []
    for kind, B, S in ROOFLINE_CHECKS:
        shape = ShapeConfig(f"{kind}_{B}x{S}", S, B, kind)
        rec = dryrun.analyze(cfg, shape, BASELINE)
        gc.collect()
        torch.cuda.empty_cache()
        torch.cuda.synchronize()
        base = torch.cuda.memory_allocated()
        gen = torch.Generator(device="cuda")
        gen.manual_seed(0)
        step, args = dryrun.build_cell(cfg, shape, BASELINE, gen)
        if kind == "decode":  # data in every row (init_cache's zeros would hide a wrong K3)
            for t in tree_flatten(args[2])[0]:
                if isinstance(t, torch.Tensor) and t.is_floating_point():
                    t.normal_(generator=gen)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        out = step(*args)
        torch.cuda.synchronize()
        measured = torch.cuda.max_memory_allocated() - base
        want = (out[2]["loss_out"].float() if kind == "train" else out[0].float()).clone()
        del out
        gc.collect()
        ratio = rec["memory"]["per_device_B"] / measured

        step_k = dryrun.cell_step(cfg, shape, BASELINE, kernel_rt)
        _zero_counts(mods)
        times, got = [], None
        for i in range(ROOFLINE_STEPS + 1):  # the first is the warm-up
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = step_k(*args)
            torch.cuda.synchronize()
            if i:
                times.append(time.perf_counter() - t0)
            got = (out[2]["loss_out"].float() if kind == "train" else out[0].float()).clone()
            del out
        before = _counts(mods)
        with _KernelClock() as clock:  # each kernel's device time in one more step
            step_k(*args)
        after = _counts(mods)
        kernel_ms = clock.ms({k: after[k] - before[k] for k in after})
        k3 = None
        if kind == "decode":  # and each K3 launch of one more step against its plain version
            calls = []
            with _tap_decode(calls):
                step_k(*args)
            k3 = _decode_calls_vs_plain(calls, cfg.num_layers)
            del calls  # they hold the cache's layers
        launched = _counts(mods)
        _add_counts(total, launched)
        del args, step, step_k
        gc.collect()
        torch.cuda.empty_cache()

        median = statistics.median(times)
        est = rec["roofline"]["est_step_s"]
        if not bool(torch.isfinite(got).all()) or got.shape != want.shape:
            raise AssertionError(f"roofline {kind}: output {tuple(got.shape)} not finite")
        if kind == "train":
            err = float(abs(got - want) / abs(want))
            tol = ROOFLINE_LOSS_RTOL
        else:
            absmax = float(want.abs().max())
            err = float((got - want).abs().max())
            tol = ROOFLINE_ULPS * _ulp(absmax)
        row = {"phase": "roofline", "part": "check", "gpu": cx.smi, "kind": kind, "B": B, "S": S,
               "dtype": BASELINE.compute_dtype, "per_device_B": rec["memory"]["per_device_B"],
               "memory": rec["memory"], "max_memory_allocated_B": measured, "mem_ratio": ratio,
               "mem_band": ROOFLINE_MEM_BAND, "est_step_s": est,
               "bottleneck": rec["roofline"]["bottleneck"], "roofline": _roofline_row(rec),
               "median_step_s": median, "step_s": times, "step_ratio": median / est,
               "launches": launched, "kernel_ms_one_step": kernel_ms, "k3_vs_plain": k3,
               "kernel_share_of_step": sum(kernel_ms.values()) / 1e3 / median,
               "trace_seconds": rec["compile_seconds"],
               "kernels_vs_chunked": err, "tolerance": tol}
        checks.append(row)
        emit(row)
        if not ROOFLINE_MEM_BAND[0] <= ratio <= ROOFLINE_MEM_BAND[1]:
            raise AssertionError(f"roofline {kind}: dry-run peak {rec['memory']['per_device_B']:.4g}"
                                 f" B over the card's {measured:.4g} B is {ratio:.3f}")
        needed = ["rmsnorm", "decode_attention" if kind == "decode" else "flash_attention"]
        for name in needed:
            if launched[name] <= 0:
                raise AssertionError(f"roofline {kind}: {name} was not launched")
        if err > tol:
            raise AssertionError(f"roofline {kind}: kernel path {err:.3e} from the chunked "
                                 f"path (tolerance {tol:.3e})")
    cx.roofline_launches = total
    emit({"phase": "roofline", "part": "done", "gpu": cx.smi, "roofline_launches": total,
          "seconds": round(time.perf_counter() - t_phase, 1),
          "tune_seconds": {k: round(v["seconds"], 1) for k, v in tuned.items()},
          "mem_ratios": {c["kind"]: c["mem_ratio"] for c in checks},
          "step_ratios": {c["kind"]: c["step_ratio"] for c in checks}})


def _child(tmp, tag, args):
    """``python <args>`` in the background, its output to a file: (process,
    tag, log path, start)."""
    log = os.path.join(tmp, f"{tag}.log")
    env = dict(os.environ, PYTHONPATH=os.path.join(HERE, "src"))
    with open(log, "w") as f:
        proc = subprocess.Popen([sys.executable, *args], stdout=f, stderr=subprocess.STDOUT,
                                env=env, cwd=HERE)
    return proc, tag, log, time.perf_counter()


def _wait_child(run):
    """Wait for a child; its log and seconds.  A child that fails or runs
    past MULTICHIP_TIMEOUT fails the phase."""
    proc, tag, log, t0 = run
    try:
        proc.wait(timeout=max(1.0, MULTICHIP_TIMEOUT - (time.perf_counter() - t0)))
    except subprocess.TimeoutExpired:
        proc.kill()
        proc.wait()
        raise AssertionError(f"multichip: {tag} ran past {MULTICHIP_TIMEOUT} s")
    with open(log) as f:
        text = f.read()
    if proc.returncode != 0:
        raise AssertionError(f"multichip: {tag} exited {proc.returncode}:\n" + text[-3000:])
    return text, time.perf_counter() - t0


def phase_multichip(cx):
    """More than one card, as far as one card shows it.  Every part runs in
    a child process of its own, so that no process group outlives it.
    (a) Dry runs at the reference's 256-chip pod, device-free on this
    host (``repro_torch.benchmarks.perf_iterations --fast``: DTensors over
    a fake process group, 1 and 2 periods traced and extrapolated): the
    three §Perf cells' variants, and qwen2-0.5b train_4k across two pods
    at BASELINE; the factor by which ``ep_local`` cuts qwen3-moe's
    collective bytes against ``gspmd`` is printed, and ``ep_local`` below
    ``gspmd`` is the check; a variant that fails fails the phase, but for
    MULTICHIP_KNOWN_ERRORS.  (b) The tuning CLI at 256 chips, BO and GA at
    budget 8 on qwen2-0.5b train_4k: each must find a finite point; its
    -inf points are counted by reason (out of memory, skipped, the
    microbatch split the port cannot lay out), and any other error fails.  (c)
    Expert parallelism on the card (``repro_torch.benchmarks.ep_forward``):
    qwen3-moe-30b-a3b at full width, 2 of 48 layers, bf16, B=2, S=512, on
    the served kernel runtime under a 1x1 DeviceMesh over a one-rank NCCL
    group: the ``ep_local`` forward within ROOFLINE_ULPS bf16 ulps of the
    largest logit of the ``gspmd`` forward, K1 and K2 launched (counts set
    to 0 just before it), one NCCL all-reduce a MoE layer, and every K1
    and K2 call of the EP forward within the kernels' tolerance and
    ROOFLINE_ULPS of its plain version on the inputs it received.  The dry
    runs and the tuners start first and run on the host while (c) holds
    the card."""
    import tempfile

    t_phase = time.perf_counter()
    tmp = tempfile.mkdtemp(prefix="chip_smoke_multichip_")
    pod = ["--chips-per-pod", str(MULTICHIP_CHIPS)]
    runs = {}
    try:
        for algo in ("bo", "ga"):
            runs[f"tune_{algo}"] = _child(tmp, f"tune_{algo}", [
                "-m", "repro_torch.launch.tune", "--arch", ROOFLINE_ARCH, "--shape", "train_4k",
                "--algo", algo, "--budget", str(MULTICHIP_BUDGET), *pod,
                "--out", os.path.join(tmp, f"tune_{algo}.json")])
        for cell in MULTICHIP_CELLS:
            runs[cell] = _child(tmp, cell, [
                "-m", "repro_torch.benchmarks.perf_iterations", "--cell", cell, "--fast", *pod,
                "--out", os.path.join(tmp, f"{cell}.json")])
        runs["multi_pod"] = _child(tmp, "multi_pod", [
            "-m", "repro_torch.launch.dryrun", "--arch", ROOFLINE_ARCH, "--shape", "train_4k",
            *pod, "--multi-pod", "--out", os.path.join(tmp, "multi_pod.json")])
        ep = MULTICHIP_EP
        runs["ep"] = _child(tmp, "ep", [
            "-m", "repro_torch.benchmarks.ep_forward", "--arch", ep["arch"],
            "--layers", str(ep["layers"]), "--batch", str(ep["batch"]), "--seq", str(ep["seq"]),
            "--dtype", ep["dtype"]])
        _multichip_body(cx, tmp, runs, t_phase)
    finally:  # a failure leaves no child behind
        for proc, *_ in runs.values():
            if proc.poll() is None:
                proc.kill()
                proc.wait()
        shutil.rmtree(tmp, ignore_errors=True)


def _ep_calls_vs_plain(ep):
    """Each K1 and K2 call of the EP forward (``kernel_calls``: the child
    held each against its plain version on the inputs it received) against
    the kernels' tolerance (``check_close``'s criterion, as ``tol_needed``)
    and ROOFLINE_ULPS bf16 ulps of the plain output's largest |value|: per
    kernel the calls, the worst numbers and the calls that miss."""
    out = {name: {"calls": 0, "max_abs_err": 0.0, "max_ulps": 0.0, "max_tol_needed": 0.0,
                  "failures": []} for name in ("rmsnorm", "flash_attention")}
    for c in ep["kernel_calls"]:
        w = out[c["kernel"]]
        tol = TOL[c["kernel"]]["bf16" if c["dtype"] == "bfloat16" else "f32"]
        ulps = c["max_abs_err"] / _ulp(c["max_abs_plain"])
        w["calls"] += 1
        w["max_abs_err"] = max(w["max_abs_err"], c["max_abs_err"])
        w["max_ulps"] = max(w["max_ulps"], ulps)
        w["max_tol_needed"] = max(w["max_tol_needed"], c["tol_needed"])
        if not (c["same_shape_dtype"] and c["finite"] and c["tol_needed"] <= tol
                and ulps <= ROOFLINE_ULPS and c["max_abs_plain"] > 0):
            w["failures"].append({**c, "ulps": ulps, "tolerance": tol})
    return out


def _multichip_body(cx, tmp, runs, t_phase):
    seconds = {}
    # -- (c) expert parallelism on the card ------------------------------------------
    text, seconds["ep"] = _wait_child(runs["ep"])
    ep = json.loads(text.strip().splitlines()[-1])
    tol = ROOFLINE_ULPS * _ulp(ep["max_abs_logit"])
    vs_plain = _ep_calls_vs_plain(ep)
    emit({"phase": "multichip", "part": "ep", "gpu": cx.smi, **ep, "tolerance": tol,
          "kernels_vs_plain": vs_plain, "child_seconds": seconds["ep"]})
    for name, worst in vs_plain.items():
        if worst["calls"] != ep["launches"][name]:
            raise AssertionError(f"multichip ep: {worst['calls']} {name} calls tapped, "
                                 f"{ep['launches'][name]} launched in a forward")
        if worst["failures"]:
            raise AssertionError(f"multichip ep: {name} against its plain version: "
                                 f"{worst['failures']}")
    if not ep["finite"] or ep["shape"] != [ep["batch"], ep["seq"], ep["shape"][-1]]:
        raise AssertionError(f"multichip ep: logits {ep['shape']} not finite")
    if ep["max_abs_diff"] > tol:
        raise AssertionError(f"multichip ep: ep_local {ep['max_abs_diff']:.3e} from gspmd "
                             f"(tolerance {tol:.3e})")
    for name in ("rmsnorm", "flash_attention"):
        if ep["launches"][name] <= 0:
            raise AssertionError(f"multichip ep: {name} was not launched")
    if ep["all_reduces_one_forward"] != ep["moe_layers"] or ep["backend"] != "nccl":
        raise AssertionError(f"multichip ep: {ep['all_reduces_one_forward']} {ep['backend']} "
                             f"all-reduces in a forward of {ep['moe_layers']} MoE layers")
    cx.multichip_launches = ep["launches"]

    # -- (a) dry runs at 256 chips -------------------------------------------------------
    rows = {}
    for cell in MULTICHIP_CELLS:
        _, seconds[cell] = _wait_child(runs[cell])
        with open(os.path.join(tmp, f"{cell}.json")) as f:
            rows[cell] = json.load(f)
        for row in rows[cell]:
            emit({"phase": "multichip", "part": "dryrun", "chips": MULTICHIP_CHIPS,
                  "device_free": True, **row})
            if "error" in row:
                known = any(cell == c and row["variant"].startswith(v)
                            for c, v in MULTICHIP_KNOWN_ERRORS)
                if known and MICROBATCH_SPLIT in row["error"]:
                    continue  # the variant the port cannot lay out
                raise AssertionError(f"multichip: dry run {cell} {row['variant']}: "
                                     f"{row['error']}")
            if not (row["est_step_s"] > 0 and row["mem_GB"] > 0):
                raise AssertionError(f"multichip: dry run {cell} {row['variant']}: {row}")
    _, seconds["multi_pod"] = _wait_child(runs["multi_pod"])
    with open(os.path.join(tmp, "multi_pod.json")) as f:
        mp = json.load(f)[0]
    if "error" in mp or not mp["multi_pod"] or mp["chips"] != 2 * MULTICHIP_CHIPS:
        raise AssertionError(f"multichip: the two-pod dry run: {mp}")
    emit({"phase": "multichip", "part": "multi_pod", "device_free": True, "arch": mp["arch"],
          "shape": mp["shape"], "mesh": mp["mesh"], "chips": mp["chips"],
          "analysis": mp["cost"]["analysis"], "roofline": _roofline_row(mp),
          "per_device_B": mp["memory"]["per_device_B"], "collectives": mp["collectives"],
          "trace_seconds": mp["compile_seconds"]})
    moe = {r["overrides"].get("moe_impl", "gspmd"): r for r in rows["qwen3_moe_train"]
           if set(r["overrides"]) <= {"moe_impl"}}
    gspmd, ep_local = moe["gspmd"]["collective_bytes"], moe["ep_local"]["collective_bytes"]
    emit({"phase": "multichip", "part": "ep_vs_gspmd", "cell": "qwen3_moe_train",
          "device_free": True, "gspmd_weighted_B": gspmd, "ep_local_weighted_B": ep_local,
          "factor": gspmd / ep_local if ep_local else None,
          "reference_claim": "about 100x (the reference's H1)"})
    if not ep_local < gspmd:
        raise AssertionError(f"multichip: ep_local moves {ep_local:.4g} B, gspmd {gspmd:.4g}")

    # -- (b) the tuning CLI at 256 chips ------------------------------------------------
    tuned = {}
    for algo in ("bo", "ga"):
        _, seconds[f"tune_{algo}"] = _wait_child(runs[f"tune_{algo}"])
        with open(os.path.join(tmp, f"tune_{algo}.json")) as f:
            evals = json.load(f)
        finite = [e for e in evals if math.isfinite(e["value"])]
        best = max(finite, key=lambda e: e["value"]) if finite else None
        reasons = {"oom": 0, "skip": 0, "microbatch_split": 0, "error": 0}
        for e in evals:
            if math.isfinite(e["value"]):
                continue
            m = e["meta"]
            why = ("oom" if m.get("oom") else "skip" if "skip_reason" in m
                   else "microbatch_split" if MICROBATCH_SPLIT in m.get("error", "")
                   else "error")
            reasons[why] += 1
            if why == "error":
                raise AssertionError(f"multichip: {algo} at {MULTICHIP_CHIPS} chips, "
                                     f"{e['point']}: {m}")
        tuned[algo] = {"evaluations": len(evals), "finite": len(finite),
                       "minus_inf_by_reason": reasons,
                       "best_point": best and best["point"],
                       "best_tok_s": best and best["value"],
                       "best_mem_per_device_B": best and best["meta"].get("mem_per_device_B"),
                       "seconds": seconds[f"tune_{algo}"]}
        emit({"phase": "multichip", "part": "tune", "algo": algo, "chips": MULTICHIP_CHIPS,
              "arch": ROOFLINE_ARCH, "shape": "train_4k", "budget": MULTICHIP_BUDGET,
              "device_free": True, **tuned[algo]})
        if not finite:
            raise AssertionError(f"multichip: {algo} at {MULTICHIP_CHIPS} chips found no "
                                 "finite point")
    emit({"phase": "multichip", "part": "done", "gpu": cx.smi,
          "multichip_launches": cx.multichip_launches,
          "seconds": round(time.perf_counter() - t_phase, 1),
          "child_seconds": {k: round(v, 1) for k, v in seconds.items()},
          "ep_factor": gspmd / ep_local if ep_local else None})


# the two scan families trained through ``repro_torch.launch.train``: its
# flags (2 x 2048 tokens, f32 as the entry point runs, the reference
# script's learning rate), the steps of the main run, the cuts tried in
# order while a run does not fit one card (RWKV-6's depth; Jamba's width
# through the reference's --d-model flag, one period), the flags of the
# kernel path vs chunked path run (the chunked Mamba oracle keeps every
# level of its associative scan for the backward, 22 (B, S, d_inner, 16)
# tensors a layer: Jamba's period on it fits at d_model 512 and batch 1,
# not at 1024 or at batch 2), and the scan each runs.  rwkv6-3b's loss
# at lr 1e-3 rises while the learning rate warms up (20 steps) and falls
# below its first value from step 36 on, on the kernel path and on the
# chunked oracles alike at full depth (PERF.md, `train_families`): its
# main run takes 44 steps.  Its depth is cut to 16 of 32 layers (width,
# steps and the loss check kept), 8 where 16 does not fit: the full depth
# took 356 s of the script's 1,200, and the compiled steps of the other
# phases need part of them (the full depth, compiled, is measured once
# through ``launch.train`` itself: PERF.md).  The chunked oracles' run of
# the check at 4 layers keeps the remat mode full depth needed
# (``check_remat``, ``names``).  ``expect`` is the cut and remat mode
# that fit on the H100 when PERF.md's figures were taken; a run that fits
# another says so in a ``note`` line.
TRAIN_FAMILIES = {
    "rwkv6-3b": {"args": ["--arch", "rwkv6-3b", "--batch", "2", "--seq", "2048",
                          "--lr", "1e-3"], "steps": 44,
                 "cuts": (["--layers", "16"], ["--layers", "8"]),
                 "expect": {"cut": ["--layers", "16"], "remat": "none"},
                 "check": ["--layers", "4"], "check_remat": "names", "scan": "gla_scan"},
    "jamba-v0.1-52b": {"args": ["--arch", "jamba-v0.1-52b", "--layers", "8", "--batch", "2",
                                "--seq", "2048", "--lr", "1e-3"], "steps": 7,
                       "cuts": (["--d-model", "1024"], ["--d-model", "512"]),
                       "expect": {"cut": ["--d-model", "1024"], "remat": "none"},
                       "check": ["--d-model", "512", "--batch", "1"], "scan": "ssm_scan"},
}
TRAIN_FAMILY_REMAT = ("none", "names", "dots", "full")  # cheapest first
TRAIN_FAMILY_CHECK_STEPS = 3  # kernel path against chunked path
TRAIN_FAMILY_SPLIT_STEPS = 3  # eager steps whose parts are timed (median of the last 2)
TRAIN_FAMILY_LOSS_RTOL = 1e-3


def _family_launches(cfg, remat):
    """Launches of each kernel in one train step: two RMSNorms a layer and
    the final one, each layer's mixer kernel, each RWKV layer's gradient
    kernels (``gla_scan_bwd``); a remat mode but none runs every layer's
    forward kernels again in its recompute."""
    mixers = [m for m, _ in cfg.layer_plan()]
    fwd = {"rmsnorm": 2 * cfg.num_layers + 1, "flash_attention": mixers.count("attn"),
           "decode_attention": 0, "ssm_scan": mixers.count("mamba"),
           "gla_scan": mixers.count("rwkv")}
    bwd = {"gla_scan_bwd": mixers.count("rwkv"), "gla_scan_state": 0}
    if remat == "none":
        return {**fwd, **bwd}
    return {**{k: 2 * v - (k == "rmsnorm") for k, v in fwd.items()}, **bwd}


def _gla_f64(r, k, v, w, u):
    """RWKV-6's wkv recurrence in float64, step by step (the exact answer
    the kernel and the plain version are measured from)."""
    import torch

    rd, kd, vd, wd, ud = (t.double() for t in (r, k, v, w, u))
    B, S, H, dk = r.shape
    st = torch.zeros((B, H, dk, v.shape[-1]), dtype=torch.float64, device=r.device)
    y = torch.empty((B, S, H, v.shape[-1]), dtype=torch.float64, device=r.device)
    for t in range(S):
        kv = kd[:, t, :, :, None] * vd[:, t, :, None, :]
        y[:, t] = (rd[:, t, :, :, None] * (st + ud[:, :, None] * kv)).sum(dim=2)
        st = wd[:, t, :, :, None] * st + kv
    return y


def _excess(got, want, tol):
    """How far the worst element lies past ``check_close``'s bound at
    ``tol`` (<= 0: within it)."""
    atol, rtol = tol if isinstance(tol, tuple) else (tol, tol)
    g, w = got.double(), want.double()
    return float(((g - w).abs() - (atol + rtol * w.abs())).max())


def _at_scale(tol, scale):
    """A scan's f32 tolerance (``TOL``: the reference tests', whose inputs
    give outputs of order 1) with its absolute part at the output's scale:
    an f32 recurrence's rounding grows with the size of its terms, and at
    2048 steps of slow decay an RWKV-6 state sums to outputs near 2,600."""
    atol, rtol = tol if isinstance(tol, tuple) else (tol, tol)
    return atol * max(1.0, scale), rtol


@contextlib.contextmanager
def _tap_scan(name, found, calls):
    """While active, each of the first ``calls`` calls that the dispatch
    layer makes of the scan kernel ``name`` (one step's forward) is held
    against the kernel's plain version on the same inputs (``check_close``
    at the tolerance ``_at_scale`` gives), and both against the same
    recurrence in float64 (the last call: a float64 recurrence on the card
    takes seconds): ``found`` gathers the calls, the largest distances,
    the largest |output| and the worst excess over the tolerance as the
    reference tests state it (positive: outside).  Where the scan has
    gradient kernels (``gla_scan_bwd``), each of the first ``calls`` of
    them (the same step's backward) is held against their plain version
    on the same inputs as the ``kernels`` phase holds them
    (``_check_grads``): ``found`` gathers ``bwd_calls`` and the worst
    errors."""
    from repro_torch.kernels import ops

    attr = _KernelClock.MODS[name]
    mod = getattr(ops, attr)
    kernel, plain = getattr(mod, name), getattr(mod, name + "_plain")
    exact = {"gla_scan": _gla_f64, "ssm_scan": _ssm_f64}[name]
    tol = TOL[name]["f32"]
    bwd = getattr(mod, name + "_bwd", None)

    def tapped(*args, **kw):
        out = kernel(*args, **kw)
        if found["calls"] < calls:
            want = plain(*args)
            scale = float(want.abs().max())
            check_close(name, f"train step, call {found['calls']} {kw}", out, want,
                        _at_scale(tol, scale))
            worst = {"kernel_vs_plain": max_err(out, want), "max_abs_plain": scale,
                     "excess_vs_plain_unscaled": _excess(out, want, tol)}
            if found["calls"] == calls - 1:  # the last layer's: the exact answer
                ref = exact(*args)
                worst.update(kernel_vs_f64=float((out.double() - ref).abs().max()),
                             plain_vs_f64=float((want.double() - ref).abs().max()))
            for key, value in worst.items():
                found[key] = max(found.get(key, -math.inf), value)
            found["calls"] += 1
        return out

    def tapped_bwd(*args):
        grads = bwd(*args)
        if found.setdefault("bwd_calls", 0) < calls:
            e, share = _check_grads(f"train step, backward call {found['bwd_calls']}", grads,
                                    getattr(mod, name + "_bwd_plain")(*args), GLA_BWD_TOL["f32"])
            found["bwd_tolerance_share"] = GLA_BWD_TOL["f32"]
            found["bwd_kernel_vs_plain"] = max(found.get("bwd_kernel_vs_plain", 0.0), e)
            found["bwd_err_share_of_largest"] = max(found.get("bwd_err_share_of_largest", 0.0),
                                                    share)
            found["bwd_calls"] += 1
        return grads

    taps = {name: tapped}
    if bwd is not None:
        taps[name + "_bwd"] = tapped_bwd
    setattr(ops, attr, types.SimpleNamespace(**{**vars(mod), **taps}))
    try:
        yield
    finally:
        setattr(ops, attr, mod)


def _family_fit(name, spec, mods):
    """The main run: the first cut whose cheapest remat mode fits one card
    trains ``spec["steps"]`` compiled steps through the entry point.  Every
    try that ran out of device memory is kept with the allocator's
    message."""
    import torch

    from repro_torch.launch import train

    tried = []
    for cut in spec["cuts"]:
        for mode in TRAIN_FAMILY_REMAT:
            args = spec["args"] + cut + ["--steps", str(spec["steps"]), "--remat", mode]
            cfg = train.model_config(train.parse_args(args))
            try:
                run = _train_run(args, mods)
            except torch.cuda.OutOfMemoryError as e:
                tried.append({"cut": cut, "remat": mode,
                              "out_of_memory": str(e).splitlines()[0][:300]})
                continue
            tried.append({"cut": cut, "remat": mode, "fits": True})
            return args, cfg, mode, run, tried
    raise AssertionError(f"train_families {name}: no cut and remat mode fits one card: {tried}")


def _family_split(spec, args, cfg, mods):
    """TRAIN_FAMILY_SPLIT_STEPS eager steps of the main run's
    cut and remat mode, with each step's forward / backward / optimizer
    seconds, the oracle recomputes' device time and the first step's scan
    calls (forward and gradient) against the plain version taken as it
    runs."""
    i = args.index("--steps")
    split_args = args[:i] + ["--steps", str(TRAIN_FAMILY_SPLIT_STEPS)] + args[i + 2:]
    found = {"calls": 0}
    tap = _tap_scan(spec["scan"], found, _family_launches(cfg, "none")[spec["scan"]])
    run, rec = _instrumented(split_args, mods, tap)
    del run["trainer"]
    return run, dict(rec, tap=found)


def _family_check(cfg, mode, B, S, lr):
    """TRAIN_FAMILY_CHECK_STEPS steps of ``cfg`` on the kernel path (the
    entry point's runtime) and on the chunked oracles, from the same
    weights and batches: each step's loss within TRAIN_FAMILY_LOSS_RTOL."""
    import gc

    import torch

    from repro_torch.data.pipeline import DataConfig
    from repro_torch.launch import train
    from repro_torch.models.runtime import Runtime
    from repro_torch.optim.optimizer import OptimizerConfig
    from repro_torch.train.trainer import Trainer, TrainerConfig

    steps = TRAIN_FAMILY_CHECK_STEPS
    losses = {}
    for path, rt in (("kernel", train.runtime(True, mode)),
                     ("chunked", Runtime(compute_dtype="f32", attn_impl="ref",
                                         scan_impl="chunked", remat=mode))):
        gc.collect()
        torch.cuda.empty_cache()
        trainer = Trainer(cfg, OptimizerConfig(learning_rate=lr, warmup_steps=20,
                                               total_steps=steps),
                          DataConfig(vocab_size=cfg.vocab_size, seq_len=S, global_batch=B),
                          TrainerConfig(steps=steps, log_every=0, device="cuda"), rt=rt)
        losses[path] = [m["loss"] for m in trainer.run()]
        del trainer
    rel = [abs(a - b) / abs(b) for a, b in zip(losses["kernel"], losses["chunked"])]
    if len(rel) != steps or max(rel) > TRAIN_FAMILY_LOSS_RTOL:
        raise AssertionError(f"train_families {cfg.name}: kernel path {losses['kernel']} vs "
                             f"chunked path {losses['chunked']} (rtol {TRAIN_FAMILY_LOSS_RTOL})")
    return {"layers": cfg.num_layers, "steps": steps, "losses_kernel": losses["kernel"],
            "losses_chunked": losses["chunked"], "max_rel_diff": max(rel),
            "tolerance_rel": TRAIN_FAMILY_LOSS_RTOL}


def phase_train_families(cx):
    """Training the two scan families on the card through
    ``repro_torch.launch.train``, f32, 2 x 2048 tokens: rwkv6-3b at full
    width, 16 of its 32 layers (K1 + K5 forward; 8 where 16 does not
    fit), one Jamba v0.1 period at
    the width ``--d-model`` gives (K1 + K2 + K4 forward; the MoE's 16
    experts stay 14,336 wide), each under the cheapest remat mode that
    fits, through the compiled step.  Each run: a finite loss, lower at the
    last step than at the first; launches a step as the model's layers
    say; the median step, tokens/s and peak bytes (allocated and
    reserved).  Then, in three eager steps of the same cut: forward /
    backward / optimizer seconds and the scans' oracle recompute inside
    the backward (CUDA events around each ``_RefVJP.backward``), and each
    scan call of the first step's forward, and each call of K5's gradient
    in its backward, against the kernel's plain version.  Last, three steps on the kernel path against the chunked
    oracles from the same weights."""
    import gc
    import statistics

    import torch

    from repro_torch.launch import dryrun, train
    from repro_torch.models.model import build_model
    from repro_torch.models.params import split_params, tree_leaves

    cx.model = cx.params = None
    gc.collect()
    torch.cuda.empty_cache()
    mods = _kernel_wrappers()
    cx.train_family_launches = {k: 0 for k in mods}
    t_phase = time.perf_counter()
    for name, spec in TRAIN_FAMILIES.items():
        t0 = time.perf_counter()
        args, cfg, mode, main, tried = _family_fit(name, spec, mods)
        targs = train.parse_args(args)
        B, S, steps, scan = targs.batch, targs.seq, spec["steps"], spec["scan"]
        n_params = sum(p.numel() for p in tree_leaves(
            split_params(build_model(cfg).init(dryrun.MetaGenerator()))[0]))
        common = {"phase": "train_families", "gpu": cx.smi, "model": name,
                  "layers": cfg.num_layers, "d_model": cfg.d_model, "params": n_params,
                  "dtype": "f32", "batch": B, "seq": S, "remat": mode}
        emit(dict(common, part="fit", args=args, tried=tried))
        fit = {"cut": tried[-1]["cut"], "remat": mode}
        if fit != spec["expect"]:
            emit(dict(common, part="note", note=f"the run fell back to {fit}; PERF.md's "
                      f"figures are of {spec['expect']}: the tries between ran out of "
                      "device memory"))

        per_step = _family_launches(cfg, mode)
        want = {k: v * steps for k, v in per_step.items()}
        if main["launches"] != want:
            raise AssertionError(f"train_families {name}: launches {main['launches']} != "
                                 f"{want}: the train path ran past a kernel")
        for k, v in main["launches"].items():
            cx.train_family_launches[k] += v
        med = statistics.median(main["seconds"][1:])
        emit(dict(common, part="main", step="make_graphed_train_step (one CUDA graph)",
                  steps=steps, losses=main["losses"],
                  grad_norms=main["grad_norms"], step_seconds=main["seconds"],
                  median_step_seconds=med, median_of=steps - 1,
                  tokens_per_s=B * S / med, peak_memory_bytes=main["peak_memory_bytes"],
                  peak_reserved_bytes=main["peak_reserved_bytes"],
                  launches=main["launches"], launches_per_step=per_step,
                  report=main["report"]))
        if not main["losses"][-1] < main["losses"][0]:
            raise AssertionError(f"train_families {name}: the loss did not fall: "
                                 f"{main['losses']}")
        del main
        gc.collect()

        # where a step's time goes, in eager steps of the same cut
        srun, rec = _family_split(spec, args, cfg, mods)
        split = _split(rec, TRAIN_FAMILY_SPLIT_STEPS)
        emit(dict(common, part="split", step="eager", steps=TRAIN_FAMILY_SPLIT_STEPS,
                  eager_step_seconds=srun["seconds"], **split, scan_oracle_share_of_backward=(
            split["oracle_backward_ms_per_step"].get(scan, 0.0) / 1e3
            / split["backward_seconds"])))

        # each scan call of the first step's forward, and of its gradient in
        # the backward, against the plain version
        tap = rec["tap"]
        emit(dict(common, part="kernel_vs_plain", kernel=scan, tolerance=TOL[scan]["f32"],
                  tolerance_at_scale=_at_scale(TOL[scan]["f32"], tap["max_abs_plain"]),
                  **tap))
        held = _family_launches(cfg, "none")
        if (tap["calls"], tap.get("bwd_calls", 0)) != (held[scan], held.get(scan + "_bwd", 0)):
            raise AssertionError(f"train_families {name}: {tap['calls']} {scan} calls and "
                                 f"{tap.get('bwd_calls', 0)} of its gradient held to the "
                                 "plain version")
        del srun, rec
        gc.collect()
        torch.cuda.empty_cache()

        # the kernel path against the chunked oracles, from the same weights
        cargs = train.parse_args(args + spec["check"])
        ccfg = train.model_config(cargs)
        emit(dict(common, part="kernel_vs_chunked", d_model_checked=ccfg.d_model,
                  batch_checked=cargs.batch,
                  **_family_check(ccfg, spec.get("check_remat", mode), cargs.batch,
                                  cargs.seq, cargs.lr)))
        gc.collect()
        torch.cuda.empty_cache()
        emit(dict(common, part="seconds", seconds=round(time.perf_counter() - t0, 1)))
    emit({"phase": "train_families", "launches": cx.train_family_launches,
          "seconds": round(time.perf_counter() - t_phase, 1)})


PHASES = {"env": phase_env, "build": phase_build, "kernels": phase_kernels,
          "parity": phase_parity, "serve": phase_serve, "graphs": phase_graphs,
          "train": phase_train,
          "tuning_db": phase_tuning_db,
          "sweep": phase_sweep, "bo": phase_bo, "service": phase_service,
          "families": phase_families, "paper": phase_paper, "host_knobs": phase_host_knobs,
          "roofline": phase_roofline, "multichip": phase_multichip,
          "train_families": phase_train_families}


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
    seconds = {}
    for name in phases:
        t_phase = time.perf_counter()
        PHASES[name](cx)
        seconds[name] = round(time.perf_counter() - t_phase, 1)
    complete = phases == list(PHASES)
    if complete:
        kernels_line(cx)
    emit({"phase": "done", "seconds": round(time.perf_counter() - t0, 1), "phases": phases,
          "phase_seconds": seconds})
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
