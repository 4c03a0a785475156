"""How K1 (``kernels/rmsnorm.py``) walks a row: its chunking against the others.

    PYTHONPATH=src python -m repro_torch.benchmarks.rmsnorm_chunking [--out FILE]

Needs an NVIDIA GPU.  At rows=4096 and D = 896 and 2560, in f32 and bf16, it
times the Triton kernel with three ways to cut a row into power-of-two
column chunks: one masked chunk of ``pow2_ceil(D)`` columns, chunks of
``MAX_CHUNK`` (the wrapper's choice, ``col_chunks``) and exact chunks
(the largest power of two dividing D).  Each variant is held to
``rmsnorm_plain`` first.  Times are device milliseconds of one call: the
calls are captured into a CUDA graph whose replay is timed by CUDA events,
the inputs rotating through buffers larger than the L2 cache.  Prints one
JSON line per (dtype, D) and the card's name and power limit.
"""
from __future__ import annotations

import argparse
import json
import math
import subprocess


def _chunkings(D: int, max_chunk: int) -> dict:
    p2 = 1 << (D - 1).bit_length()
    low = D & -D
    return {"one masked chunk": (p2, 1),
            f"chunks of {max_chunk}": (min(p2, max_chunk), -(-D // min(p2, max_chunk))),
            "exact chunks": (low, D // low)}


def _graph_ms(fn, sets, iters=40, replays=5) -> float:
    import torch

    for a in sets[:3]:
        fn(*a)
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for i in range(iters):
            fn(*sets[i % len(sets)])
    graph.replay()
    torch.cuda.synchronize()
    start, stop = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(replays):
        graph.replay()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / (iters * replays)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--rows", type=int, default=4096)
    ap.add_argument("--widths", default="896,2560")
    ap.add_argument("--out", default=None, help="also write the lines to this file")
    args = ap.parse_args(argv)

    import torch

    from repro_torch.kernels import rmsnorm as rms

    if not torch.cuda.is_available():
        raise SystemExit("rmsnorm_chunking: needs an NVIDIA GPU")
    gen = torch.Generator(device="cuda")
    gen.manual_seed(0)
    lines = []
    for name, dt in (("f32", torch.float32), ("bf16", torch.bfloat16)):
        for D in (int(w) for w in args.widths.split(",")):
            nbytes = 2 * args.rows * D * dt.itemsize
            n_sets = int(min(48, max(2, math.ceil(125e6 / nbytes))))
            s = torch.randn(D, generator=gen, device="cuda")
            sets = [(torch.randn(args.rows, D, generator=gen, device="cuda").to(dt), s)
                    for _ in range(n_sets)]
            want = rms.rmsnorm_plain(sets[0][0], s, 1e-6)
            row = {"dtype": name, "rows": args.rows, "D": D,
                   "wrapper_chunking": list(rms.col_chunks(D)), "ms": {}}
            real = rms.col_chunks
            try:
                for label, chunks in _chunkings(D, rms.MAX_CHUNK).items():
                    rms.col_chunks = lambda d, c=chunks: c
                    err = float((rms.rmsnorm(sets[0][0], s, 1e-6).float() - want.float())
                                .abs().max())
                    if err > (2e-2 if dt == torch.bfloat16 else 1e-5):
                        raise AssertionError(f"{name} D={D} {label}: max abs err {err:.3e}")
                    row["ms"][f"{label} {chunks}"] = _graph_ms(
                        lambda x, s: rms.rmsnorm(x, s, 1e-6), sets)
            finally:
                rms.col_chunks = real
            lines.append(row)
            print(json.dumps(row), flush=True)
            del sets
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.splitlines()[0].strip()
    print(smi)
    if args.out:
        with open(args.out, "w") as f:
            for row in lines:
                f.write(json.dumps(dict(row, gpu=smi)) + "\n")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
