"""End to end: train a ~100M-param dense LM for a few hundred steps
with checkpointing and a simulated worker failure + recovery.

    PYTHONPATH=src python -m repro_torch.examples.train_lm [--steps 200] [--small]
    PYTHONPATH=src python -m repro_torch.examples.train_lm --device cpu --small

``--small`` uses the tiny reduced config (about a minute on the CPU); the
default builds a ~100M-parameter qwen2-family model (same code path as the
production launcher, ``launch/train.py``).  On the card (``--device
cuda``, the default; raises when there is none) through the hand-written
kernels' forwards; ``--device cpu`` through the oracles.  The failure is
injected half way; checkpoints go to ``--checkpoint-dir`` (default: a
fresh directory under the system's temporary directory), every
``--checkpoint-every`` steps (50, as in the reference's script).
"""
import argparse
import tempfile

from repro_torch.launch.train import main as train_main


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=200)
    ap.add_argument("--small", action="store_true")
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    ap.add_argument("--checkpoint-dir", default=None)
    ap.add_argument("--checkpoint-every", type=int, default=50,
                    help="a run shorter than twice this restores nothing: "
                         "the failure comes before the first checkpoint")
    args = ap.parse_args(argv)
    ckpt = args.checkpoint_dir or tempfile.mkdtemp(prefix="repro_train_lm_ckpt_")

    argv = [
        "--arch", "qwen2-0.5b", "--reduced",
        "--steps", str(args.steps),
        "--checkpoint-dir", ckpt,
        "--checkpoint-every", str(args.checkpoint_every),
        "--inject-failure", str(args.steps // 2),
        "--lr", "1e-3",
        "--device", args.device,
    ]
    if args.small:
        argv += ["--batch", "8", "--seq", "128"]
    else:
        # ~100M params: widen the reduced config (24L family structure kept)
        argv += ["--batch", "8", "--seq", "256", "--d-model", "512",
                 "--layers", "12"]
    return train_main(argv)


if __name__ == "__main__":
    main()
