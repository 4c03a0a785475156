"""End-to-end training entry point.

    PYTHONPATH=src python -m repro_torch.launch.train --arch qwen2-0.5b \
        --steps 12 --batch 8 --seq 512            # on the card, full config
    PYTHONPATH=src python -m repro_torch.launch.train --device cpu --reduced \
        --steps 20 --batch 8 --seq 64             # on the CPU, oracles

``--reduced`` trains the tiny same-family config; without it the full
config is used.  The fault-tolerance machinery (checkpoint / restart /
straggler detection) is active either way; ``--inject-failure``
demonstrates recovery.

Runs on the card (``--device cuda``, the default) through the hand-written
kernels forward (``runtime``: RMSNorm, flash attention and the scans, each
with its oracle's backward), and raises when there is no card.  On the
card the step is one CUDA graph (``train_step.make_graphed_train_step``,
as the reference jits it), the caching allocator takes expandable
segments unless ``PYTORCH_CUDA_ALLOC_CONF`` says otherwise
(``card_allocator``), and the report ends with the median step after
the first and the run's peak device memory, allocated and reserved.  ``--device cpu`` takes the
oracles, eagerly.  Beyond the flags of the reference package's script:
``--device`` and ``--remat``; ``--tuning-db`` is live here (the kernels
consult it), where the reference's oracles never read it.
"""
import argparse
import dataclasses
import os

import torch

from repro_torch.configs import get_config
from repro_torch.data.pipeline import DataConfig
from repro_torch.models.runtime import REMAT_MODES, Runtime
from repro_torch.optim.optimizer import OptimizerConfig
from repro_torch.runtime.fault_tolerance import FailureInjector
from repro_torch.train.trainer import Trainer, TrainerConfig


#: the caching allocator on the card.  The compiled step's graph keeps a
#: memory pool of its own beside the segments the rest of the run holds,
#: and with fixed-size segments both sides fragment: on the NVIDIA H100
#: 80GB HBM3 (700 W), rwkv6-3b at its full 32 layers (f32, 2 x 2048) ran
#: out of memory at the capture under every remat mode, though it
#: allocates no more than its eager step; with expandable segments it
#: trains at remat ``names`` in 67.22 GB allocated, 69.31 GB reserved
#: (PERF.md, PR 24).
CARD_ALLOCATOR = "expandable_segments:True"


def card_allocator() -> None:
    """``PYTORCH_CUDA_ALLOC_CONF`` set to ``CARD_ALLOCATOR`` unless the
    caller set it.  The allocator reads it once, at CUDA's first use in
    the process: call this before."""
    os.environ.setdefault("PYTORCH_CUDA_ALLOC_CONF", CARD_ALLOCATOR)


def runtime(on_card: bool, remat: str) -> Runtime:
    """The trained runtime, f32: on the card the kernels forward (attention,
    RMSNorm and the scans); on the CPU the oracles."""
    return Runtime(compute_dtype="f32", attn_impl="cuda" if on_card else "ref",
                   scan_impl="cuda" if on_card else "chunked", remat=remat)


def parse_args(argv=None) -> argparse.Namespace:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="qwen2-0.5b")
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--lr", type=float, default=1e-3)
    ap.add_argument("--microbatches", type=int, default=1)
    ap.add_argument("--checkpoint-dir", default=None)
    ap.add_argument("--checkpoint-every", type=int, default=50)
    ap.add_argument("--inject-failure", type=int, default=None,
                    help="simulate a worker failure at this step")
    ap.add_argument("--d-model", type=int, default=None,
                    help="override reduced width (e.g. for the ~100M example)")
    ap.add_argument("--layers", type=int, default=None)
    ap.add_argument("--tuning-db", default=None, metavar="PATH",
                    help="persisted TuningDB (benchmarks/kernel_sweep.py "
                         "output); the kernels take its tiles")
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    ap.add_argument("--remat", choices=REMAT_MODES, default="none",
                    help="activation recompute policy of each layer period")
    return ap.parse_args(argv)


def model_config(args: argparse.Namespace):
    """The config the flags name: ``--reduced``, then ``--d-model`` (which
    sets ``head_dim = d_model / heads`` and ``d_ff = 4 d_model``, and
    leaves MoE experts as they are) and ``--layers`` (whole periods), as
    the reference package's script builds it."""
    cfg = get_config(args.arch)
    if args.reduced:
        cfg = cfg.reduced()
    if args.d_model:
        cfg = dataclasses.replace(
            cfg, d_model=args.d_model, head_dim=args.d_model // cfg.num_heads,
            d_ff=4 * args.d_model,
        )
    if args.layers:
        period = cfg.layer_period()
        cfg = dataclasses.replace(cfg, num_layers=max(period, args.layers // period * period))
    return cfg


def main(argv=None):
    args = parse_args(argv)
    if args.device == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "--device cuda (the default) needs an NVIDIA GPU and none is "
            "visible; pass --device cpu to run the oracles on the CPU")
    on_card = args.device == "cuda"
    if on_card:
        card_allocator()
    cfg = model_config(args)

    opt_cfg = OptimizerConfig(learning_rate=args.lr, warmup_steps=20,
                              total_steps=args.steps)
    data_cfg = DataConfig(vocab_size=cfg.vocab_size, seq_len=args.seq,
                          global_batch=args.batch)
    tcfg = TrainerConfig(steps=args.steps, microbatches=args.microbatches,
                         checkpoint_dir=args.checkpoint_dir,
                         checkpoint_every=args.checkpoint_every,
                         device=args.device)
    injector = (FailureInjector(at_steps=[args.inject_failure])
                if args.inject_failure is not None else None)
    rt = runtime(on_card, args.remat)
    if args.tuning_db:
        from repro_torch.tuning.tundb import TuningDB, hardware_fingerprint
        rt = dataclasses.replace(rt, tuning_db=TuningDB(
            args.tuning_db, fingerprint=hardware_fingerprint(args.device)))
    trainer = Trainer(cfg, opt_cfg, data_cfg, tcfg,
                      rt=rt,
                      failure_injector=injector)
    log = trainer.run()
    first, last = log[0]["loss"], log[-1]["loss"]
    tail = ""
    if on_card:
        later = sorted(m["seconds"] for m in log[1:])
        if later:
            tail = f"; median step after the first {later[len(later) // 2]:.5f} s"
        tail += (f"; peak device memory {torch.cuda.max_memory_allocated() / 1e9:.2f} GB "
                 f"allocated, {torch.cuda.max_memory_reserved() / 1e9:.2f} GB reserved")
    print(f"[train] done: loss {first:.4f} -> {last:.4f} "
          f"({len(log)} logged steps); events: {trainer.events or 'none'}{tail}")
    return log


if __name__ == "__main__":
    main()
