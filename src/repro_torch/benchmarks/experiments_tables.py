"""The §Dry-run and §Roofline markdown tables from a dry-run artifact
(reads the restart-safe jsonl that ``launch/dryrun.py --out`` writes),
for one H100 (mesh 1x1).

    PYTHONPATH=src python -m repro_torch.benchmarks.experiments_tables \
        [--artifact artifacts/dryrun_h100.json.jsonl]
"""
from __future__ import annotations

import argparse
import json
import pathlib

ART = pathlib.Path(__file__).resolve().parents[3] / "artifacts"
MESH = "1×1 (H100)"


def load(path=None):
    path = pathlib.Path(path or (ART / "dryrun_h100.json.jsonl"))
    recs = {}
    for line in path.read_text().splitlines():
        try:
            r = json.loads(line)
        except ValueError:
            continue
        recs[(r["arch"], r["shape"])] = r  # later lines win (reruns)
    return recs


def dryrun_table(recs) -> str:
    rows = ["| arch | shape | mesh | status | mem/dev GB | trace s |",
            "|---|---|---|---|---|---|"]
    for (arch, shape), r in sorted(recs.items()):
        if r.get("skipped"):
            rows.append(f"| {arch} | {shape} | {MESH} | SKIP ({r['skip_reason'][:40]}…) | — | — |")
        elif "error" in r:
            rows.append(f"| {arch} | {shape} | {MESH} | ERROR | — | — |")
        else:
            mem = r["memory"]["per_device_B"] / 1e9
            rows.append(f"| {arch} | {shape} | {MESH} | traced | {mem:.2f} "
                        f"| {r['compile_seconds']:.1f} |")
    return "\n".join(rows)


def roofline_table(recs) -> str:
    rows = [
        "| arch | shape | compute s | memory s (traced-raw s) | coll s | bottleneck "
        "| step s | tok/s | MFU | useful | mem GB | fits |",
        "|---|---|---|---|---|---|---|---|---|---|---|---|",
    ]
    for (arch, shape), r in sorted(recs.items()):
        if r.get("skipped") or "error" in r:
            continue
        x = r["roofline"]
        rows.append(
            f"| {arch} | {shape} | {x['compute_s']:.3f} | {x['memory_s']:.3f} "
            f"({x['memory_s_hlo_raw']:.1f}) | {x['collective_s']:.3f} "
            f"| {x['bottleneck']} | {x['est_step_s']:.3f} "
            f"| {x['throughput_tok_s']:.3g} | {x['mfu']:.3f} "
            f"| {x['useful_flops_ratio']:.2f} | {x['mem_per_device_GB']:.1f} "
            f"| {x['fits_hbm']} |"
        )
    return "\n".join(rows)


def pick_hillclimb_cells(recs):
    """worst roofline fraction / most collective-bound."""
    ok = {k: r for k, r in recs.items() if not r.get("skipped") and "error" not in r}
    frac = {k: r["roofline"]["roofline_fraction"] for k, r in ok.items()}
    coll_share = {
        k: r["roofline"]["collective_s"] / max(r["roofline"]["est_step_s"], 1e-12)
        for k, r in ok.items()
    }
    worst_frac = min(frac, key=frac.get)
    most_coll = max(coll_share, key=coll_share.get)
    return {"worst_roofline_fraction": worst_frac, "most_collective_bound": most_coll}


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--artifact", default=None)
    args = ap.parse_args(argv)
    recs = load(args.artifact)
    print("## §Dry-run\n")
    print(dryrun_table(recs))
    print(f"\n## §Roofline ({MESH})\n")
    print(roofline_table(recs))
    print("\n## hillclimb candidates\n")
    print(json.dumps({k: list(v) for k, v in pick_hillclimb_cells(recs).items()},
                     indent=1))


if __name__ == "__main__":
    main()
