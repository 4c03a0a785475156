"""Where a compiled train step's memory goes, against the eager step's.

    python -m repro_torch.benchmarks.graph_memory [--arch qwen2-0.5b] [--layers 24]
        [--batch 8] [--seq 512] [--remat none] [--top 12]

Needs a card.  Builds the trainer's donated step at the entry point's
runtime (``launch/train.py``), f32, from seed 0, and records the caching
allocator's history (``torch.cuda.memory._record_memory_history``) over
one eager step (after a warm one) and over the compiled step's capture
(``make_graphed_train_step``'s second call).  For each it prints one JSON
line: the peak of the bytes held by live tensors, counted two ways (a
block is dead when its free is requested, or when the allocator has
completed it: a free completes later where the block was used on another
stream), the bytes held before the step, ``max_memory_allocated`` and
``max_memory_reserved``, and the live bytes at the peak grouped by the
innermost frame in the port's code that allocated them (the ``top``
largest groups).
"""
from __future__ import annotations

import argparse
import dataclasses
import gc
import json
from collections import Counter


def _live_at_peak(trace, completed: bool, top: int):
    """The peak of live bytes over ``trace`` and what was live at it."""
    dead = "free_completed" if completed else "free_requested"
    live, total, peak, at_peak = {}, 0, 0, {}
    for ev in trace:
        if ev["action"] == "alloc":
            live[ev["addr"]] = ev
            total += ev["size"]
        elif ev["action"] == dead and ev["addr"] in live:
            total -= live.pop(ev["addr"])["size"]
        if total > peak:
            peak, at_peak = total, dict(live)
    groups = Counter()
    for ev in at_peak.values():
        frames = [f for f in ev.get("frames", []) if "repro_torch" in f["filename"]]
        where = (f"{frames[0]['filename'].split('repro_torch/')[-1]}:{frames[0]['line']} "
                 f"{frames[0]['name']}") if frames else "(outside the port)"
        groups[where] += ev["size"]
    return peak, [{"where": w, "bytes": b} for w, b in groups.most_common(top)]


def _recorded(fn, top: int):
    import torch

    gc.collect()
    torch.cuda.synchronize()
    before = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    torch.cuda.memory._record_memory_history(max_entries=1_000_000)
    try:
        fn()
        torch.cuda.synchronize()
        snap = torch.cuda.memory._snapshot()
    finally:
        torch.cuda.memory._record_memory_history(enabled=None)
    trace = [ev for dev in snap["device_traces"] for ev in dev]
    out = {"bytes_before": before, "max_memory_allocated": torch.cuda.max_memory_allocated(),
           "max_memory_reserved": torch.cuda.max_memory_reserved()}
    for completed in (False, True):
        peak, groups = _live_at_peak(trace, completed, top)
        key = "free_completed" if completed else "free_requested"
        out[f"peak_live_bytes_{key}"] = peak
        out[f"live_at_peak_{key}"] = groups
    return out


def main(argv=None):
    import torch

    from repro_torch.configs import get_config
    from repro_torch.data.pipeline import DataConfig, SyntheticTokens
    from repro_torch.launch.train import runtime
    from repro_torch.models.model import build_model
    from repro_torch.models.params import split_params
    from repro_torch.optim.optimizer import OptimizerConfig, adamw_init
    from repro_torch.train.train_step import make_graphed_train_step, make_train_step

    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--arch", default="qwen2-0.5b")
    ap.add_argument("--layers", type=int, default=None)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=512)
    ap.add_argument("--remat", default="none")
    ap.add_argument("--top", type=int, default=12)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise RuntimeError("graph_memory measures the card's allocator and needs a GPU")
    cfg = get_config(args.arch)
    if args.layers:
        cfg = dataclasses.replace(cfg, num_layers=args.layers)
    model, rt = build_model(cfg), runtime(True, args.remat)
    opt = OptimizerConfig(learning_rate=1e-3, warmup_steps=20, total_steps=8)
    data = SyntheticTokens(DataConfig(vocab_size=cfg.vocab_size, seq_len=args.seq,
                                      global_batch=args.batch))
    batch = {k: torch.from_numpy(v).cuda() for k, v in data.batch_at(0).items()}
    common = {"arch": cfg.name, "layers": cfg.num_layers, "batch": args.batch,
              "seq": args.seq, "remat": args.remat, "dtype": "f32",
              "gpu": torch.cuda.get_device_name(0)}
    rows = []
    for path in ("eager", "compiled"):
        gen = torch.Generator(device="cuda").manual_seed(0)
        params, _ = split_params(model.init(gen))
        state = adamw_init(params, opt)
        if path == "eager":
            step = make_train_step(model, opt, rt, donate=True)
        else:
            step = make_graphed_train_step(model, opt, rt)
        step(params, state, batch)  # warm (the compiled step's eager first call)
        row = dict(common, path=path, **_recorded(lambda: step(params, state, batch),
                                                  args.top))
        rows.append(row)
        print(json.dumps(row), flush=True)
        if path == "compiled":
            step.release()
        del step, params, state
        gc.collect()
        torch.cuda.empty_cache()
    return rows


if __name__ == "__main__":
    main()
