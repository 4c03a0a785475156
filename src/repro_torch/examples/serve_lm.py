"""Serve a small model with batched requests (prefill + decode loop).

    PYTHONPATH=src python -m repro_torch.examples.serve_lm [--arch rwkv6-3b]
    PYTHONPATH=src python -m repro_torch.examples.serve_lm --device cpu

Runs the server (``launch/serve.py``) on the reduced config of the
chosen architecture — the same serve steps that the decode_32k / long_500k
dry-run cells trace.  On the card (``--device cuda``, the default; raises
when there is none) through the hand-written kernels; ``--device cpu``
through the oracles.
"""
import argparse

from repro_torch.launch.serve import main as serve_main


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="rwkv6-3b")
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    args = ap.parse_args(argv)
    return serve_main(["--arch", args.arch, "--reduced", "--requests", "12",
                       "--prompt-len", "48", "--gen-len", "16", "--batch", "4",
                       "--device", args.device])


if __name__ == "__main__":
    main()
