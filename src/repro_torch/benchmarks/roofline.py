"""§Roofline table: reads a dry-run artifact and emits one roofline row a
(arch x shape) cell, for one H100 (mesh 1x1).

    PYTHONPATH=src python -m repro_torch.launch.dryrun --all --out artifacts/dryrun_h100.json
    PYTHONPATH=src python -m repro_torch.benchmarks.roofline

CSV rows: roofline,<arch>,<shape>,<mesh>,<compute_s>,<memory_s>,
          <collective_s>,<bottleneck>,<step_s>,<tput_tok_s>,<mfu>,
          <useful_ratio>,<mem_GB>,<fits>
"""
from __future__ import annotations

import argparse
import json
import pathlib

DEFAULT_ARTIFACT = (pathlib.Path(__file__).resolve().parents[3] / "artifacts"
                    / "dryrun_h100.json")


def run(artifact=DEFAULT_ARTIFACT, emit=print):
    path = pathlib.Path(artifact)
    if not path.exists():
        emit(f"roofline,SKIPPED,artifact missing: {path} "
             "(run: python -m repro_torch.launch.dryrun --all --out ...)")
        return []
    rows = []
    for rec in json.loads(path.read_text()):
        tag = f"{rec['arch']},{rec['shape']},1x1"
        if rec.get("skipped"):
            emit(f"roofline,{tag},SKIP,{rec['skip_reason']}")
            continue
        if "error" in rec:
            emit(f"roofline,{tag},ERROR,{rec['error']}")
            continue
        r = rec["roofline"]
        emit(
            f"roofline,{tag},{r['compute_s']:.4e},{r['memory_s']:.4e},"
            f"{r['collective_s']:.4e},{r['bottleneck']},{r['est_step_s']:.4e},"
            f"{r['throughput_tok_s']:.4g},{r['mfu']:.3f},"
            f"{r['useful_flops_ratio']:.3f},{r['mem_per_device_GB']:.2f},"
            f"{r['fits_hbm']}"
        )
        rows.append(rec)
    return rows


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--artifact", default=str(DEFAULT_ARTIFACT))
    args = ap.parse_args(argv)
    run(args.artifact)


if __name__ == "__main__":
    main()
