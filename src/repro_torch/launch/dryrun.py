"""Dry run: trace one (arch x shape x mesh) cell's step and put a roofline
on it, with nothing allocated and no card needed.

For each cell this produces, per device
  * the peak of live bytes of the step   — proves it fits the card's HBM
  * FLOPs and per-op traffic             — from the trace of the port's own
                                           step (tuning/trace_analysis.py)
  * collectives by kind, with bytes      — from the same trace
  * the three-term roofline              — tuning/cost_model.py

The counterpart of the reference's ``lower_cell`` + ``compile()`` is
``trace_cell``: the step that ``launch/train.py`` / ``launch/serve.py`` run,
built by ``build_cell`` on ``meta`` tensors (params drawn by nothing) and
run once under the tracer.  The reference's HLO counts a scan body once,
so it compiles 1 and 2 periods and extrapolates; the port's layer loop is
python, so the trace counts every layer and the full analysis traces the
whole depth.  ``fast=True`` (the tuner's partial fidelity) traces 1 and 2
periods and extrapolates linearly, memory included.  The record keeps the
reference's keys; ``compile_seconds`` holds the trace's seconds (nothing
compiles) and ``bytes_hlo_raw`` every traced op's bytes.

The mesh is the reference's ``build_cell_mesh``: ``(dp, tp)`` of
``chips_per_pod`` chips, ``(2, dp, tp)`` across two pods.  The default is
one card (``chips_per_pod=1``: a 1x1 mesh, no process group, nothing
placed).  On a larger mesh ``trace_cell`` places params, optimizer state,
batch and cache under ``ShardingRules`` as DTensors over a fake process
group (``launch/mesh.py``), as the reference's ``lower_cell`` gives
``jit`` its ``in_shardings``, and traces under ``implicit_replication``
(a tensor the step makes afresh, a rope table or a zero buffer, is
replicated, as XLA's propagation would leave it).  DTensor's sharding
propagation then decides each op's collectives where the reference's
GSPMD partitioner does; ``ROADMAP.md`` Queue C lists where they differ.

The dry run never initialises CUDA (the tuner's process backend forks).

CLI:
  python -m repro_torch.launch.dryrun --arch qwen2-0.5b --shape train_4k
  python -m repro_torch.launch.dryrun --arch qwen2-0.5b --shape train_4k --chips-per-pod 256
  python -m repro_torch.launch.dryrun --all --out artifacts/dryrun_h100
"""
import argparse
import contextlib
import dataclasses
import json
import pathlib
import sys
import time
import traceback
from typing import Dict

import torch

from repro_torch.configs import SHAPES, applicable, get_config, get_shape, list_archs
from repro_torch.configs.base import ModelConfig, ShapeConfig
from repro_torch.distributed.sharding import ShardingRules, active_rules
from repro_torch.launch.mesh import Mesh, device_mesh
from repro_torch.models.model import build_model
from repro_torch.models.params import split_params, tree_map
from repro_torch.optim.optimizer import OptimizerConfig, adamw_init, optimizer_state_axes
from repro_torch.serve.serve_step import make_decode_step, make_prefill_step
from repro_torch.train.train_step import make_train_step
from repro_torch.tuning.cost_model import (
    Roofline,
    analytic_hbm_traffic,
    kernel_traffic_bytes,
    model_flops,
    tokens_per_step,
    weighted_collective_bytes,
)
from repro_torch.tuning.evaluator import provenance
from repro_torch.tuning.parameters import BASELINE, BackendConfig
from repro_torch.tuning.trace_analysis import TraceStats, trace

class MetaGenerator(torch.Generator):
    """A generator whose ``device`` is ``meta``: ``Model.init`` then builds
    every parameter as a stand-in and draws nothing."""

    @property
    def device(self):
        return torch.device("meta")


def cell_step(cfg: ModelConfig, shape: ShapeConfig, bc: BackendConfig, rt=None):
    """The cell's train / prefill / decode step under ``rt`` (default
    ``bc.runtime()``, the chunked oracle path the dry run traces)."""
    model = build_model(cfg)
    rt = rt or bc.runtime()
    if shape.kind == "train":
        opt_cfg = OptimizerConfig(state_dtype=bc.opt_state_dtype, factored=bc.factored_opt)
        return make_train_step(model, opt_cfg, rt, microbatches=bc.microbatches)
    if shape.kind == "prefill":
        return make_prefill_step(model, rt)
    return make_decode_step(model, rt)


def build_cell(cfg: ModelConfig, shape: ShapeConfig, bc: BackendConfig,
               gen: torch.Generator, rt=None, rules: ShardingRules = None):
    """``(step, args)``: ``cell_step`` and its arguments on ``gen.device`` —
    what the dry run traces on ``meta`` and what runs on the card.  Params
    are f32 (bf16 when serving with ``serve_bf16_params``); a decode step
    writes the cache's last slot.  Under ``rules`` on a mesh of more than
    one device every argument is placed (``ShardingRules.tree_place``) by
    its logical axes."""
    device = gen.device
    model = build_model(cfg)
    params, axes = split_params(model.init(gen))
    if shape.kind != "train" and bc.serve_bf16_params:
        params = tree_map(lambda p: p.to(torch.bfloat16) if p.dtype == torch.float32 else p,
                          params)
    place = rules is not None and rules.distributed
    batch = {}
    for name, spec in model.input_specs(shape).items():
        x = spec.make(device)
        if name in ("tokens", "targets") and device.type != "meta":
            x = torch.randint(0, cfg.vocab_size, spec.shape, generator=gen,
                              dtype=spec.dtype, device=device)
        batch[name] = rules.place(x, spec.logical_axes) if place else x
    step = cell_step(cfg, shape, bc, rt)
    if shape.kind == "train":
        opt_cfg = OptimizerConfig(state_dtype=bc.opt_state_dtype, factored=bc.factored_opt)
        opt = adamw_init(params, opt_cfg)
        if place:
            opt = rules.tree_place(optimizer_state_axes(axes, opt_cfg, params), opt)
            params = rules.tree_place(axes, params)
        return step, (params, opt, batch)
    if place:
        params = rules.tree_place(axes, params)
    cache, cache_axes = split_params(model.init_cache(shape.global_batch, shape.seq_len,
                                                      device=device))
    if place:
        cache = rules.tree_place(cache_axes, cache)
    if shape.kind == "prefill":
        return step, (params, batch, cache)
    cache["pos"] = shape.seq_len - 1
    return step, (params, batch["tokens"], cache)


def build_cell_mesh(bc: BackendConfig, *, multi_pod: bool = False,
                    chips_per_pod: int = 1) -> Mesh:
    """The reference's cell mesh: ``(dp, tp)``, or ``(2, dp, tp)`` across
    two pods (a description; ``trace_cell`` builds its DeviceMesh)."""
    dp, tp = bc.dp(chips_per_pod), bc.tp(chips_per_pod)
    if multi_pod:
        return Mesh(("pod", "data", "model"), (2, dp, tp))
    return Mesh(("data", "model"), (dp, tp))


def _rules(mesh: Mesh, bc: BackendConfig) -> ShardingRules:
    # decode attention locality: shard the KV cache by kv-heads instead of seq
    overrides = {"cache_seq": None} if bc.cache_shard == "heads" else None
    dm = device_mesh(mesh) if mesh.size > 1 else None
    return ShardingRules(mesh, bc.sharding_style, overrides=overrides, device_mesh=dm)


def trace_cell(cfg: ModelConfig, shape: ShapeConfig, mesh: Mesh,
               bc: BackendConfig) -> TraceStats:
    """Trace one cell's step on ``meta`` tensors, one device's share of it
    on a larger mesh (the counterpart of the reference's ``lower_cell``)."""
    rules = _rules(mesh, bc)
    step, args = build_cell(cfg, shape, bc, MetaGenerator(), rules=rules)
    replicate = contextlib.nullcontext()
    if rules.distributed:
        from torch.distributed.tensor.experimental import implicit_replication

        replicate = implicit_replication()
    with active_rules(rules), replicate:
        _, stats = trace(step, args)
    return stats


def _reduced_depth_cfg(cfg: ModelConfig, n_periods: int) -> ModelConfig:
    period = cfg.layer_period()
    kw = {"num_layers": n_periods * period}
    if cfg.encoder_layers:
        kw["encoder_layers"] = n_periods
    return dataclasses.replace(cfg, **kw)


_EXTRAPOLATED = ("flops", "traffic_included", "traffic_excluded", "argument_B",
                 "temp_B", "output_B", "alias_B", "ops")


def _extrapolate(s1: TraceStats, s2: TraceStats, n: int) -> TraceStats:
    """The depth-``n`` stats from the 1- and 2-period traces, linear in the
    number of periods (exact where each period adds the same)."""
    out = TraceStats()
    for k in _EXTRAPOLATED:
        a, b = getattr(s1, k), getattr(s2, k)
        setattr(out, k, type(a)(a + (n - 1) * (b - a)))
    for tag in set(s1.excluded_by_tag) | set(s2.excluded_by_tag):
        a, b = s1.excluded_by_tag.get(tag, 0.0), s2.excluded_by_tag.get(tag, 0.0)
        out.excluded_by_tag[tag] = a + (n - 1) * (b - a)
    for kind in set(s1.collectives.bytes_by_kind) | set(s2.collectives.bytes_by_kind):
        for attr in ("bytes_by_kind", "count_by_kind"):
            a = getattr(s1.collectives, attr).get(kind, 0)
            b = getattr(s2.collectives, attr).get(kind, 0)
            getattr(out.collectives, attr)[kind] = a + (n - 1) * (b - a)
    out.seconds = s1.seconds + s2.seconds
    return out


def analyze(cfg: ModelConfig, shape: ShapeConfig, bc: BackendConfig = BASELINE,
            mesh: Mesh = None, *, fast: bool = False) -> Dict:
    """Dry run + roofline of ``cfg`` at ``shape`` on ``mesh`` (default one
    card); the reference's record, key for key."""
    mesh = mesh or build_cell_mesh(bc)
    chips = mesh.size
    n_periods = cfg.num_layers // cfg.layer_period()
    t0 = time.perf_counter()
    if fast and n_periods > 2:
        st = _extrapolate(trace_cell(_reduced_depth_cfg(cfg, 1), shape, mesh, bc),
                          trace_cell(_reduced_depth_cfg(cfg, 2), shape, mesh, bc),
                          n_periods)
    else:
        st = trace_cell(cfg, shape, mesh, bc)
    seconds = time.perf_counter() - t0

    # Memory term, three estimates, most->least pessimistic:
    #   bytes_hlo_raw    — every traced op's bytes (the eager chains of the
    #                      oracle regions included)
    #   traffic_in + kernel credit — per-op traffic with the kernel regions
    #                      credited at their stream traffic
    #   analytic         — the fused-kernel model (headline term)
    kernel_credit = kernel_traffic_bytes(cfg, shape, bc, chips)
    traffic_adjusted = max(st.traffic_included, 0.0) + kernel_credit
    analytic = analytic_hbm_traffic(cfg, shape, bc, chips)
    bytes_raw = st.traffic_included + st.traffic_excluded
    coll = st.collectives
    rf = Roofline(
        flops_per_device=st.flops,
        bytes_per_device=analytic["total"],
        collective_bytes=weighted_collective_bytes(coll.bytes_by_kind),
        tokens_per_step=tokens_per_step(shape),
        chips=chips,
        model_flops=model_flops(cfg, shape, cfg.param_counts()["active"]),
        memory_per_device=float(st.per_device_B),
        collective_detail=coll.summary(),
        bytes_hlo_raw=bytes_raw,
        bytes_kernel_credit=kernel_credit,
    )
    return {
        "arch": cfg.name,
        "shape": shape.name,
        "multi_pod": "pod" in mesh.axis_names,
        "skipped": False,
        "chips": chips,
        "mesh": dict(mesh.shape),
        "backend": dataclasses.asdict(bc),
        "memory": {
            "argument_B": st.argument_B,
            "temp_B": st.temp_B,
            "output_B": st.output_B,
            "alias_B": st.alias_B,
            "per_device_B": float(st.per_device_B),
        },
        "cost": {
            "flops_per_device": st.flops,
            "bytes_hlo_raw": bytes_raw,
            "bytes_traffic_included": st.traffic_included,
            "bytes_traffic_kernel_excluded": st.traffic_excluded,
            "bytes_kernel_credit": kernel_credit,
            "bytes_traffic_adjusted": traffic_adjusted,
            "bytes_analytic": analytic,
            "bytes_adjusted": analytic["total"],
            # no scan: the trace counts every period
            "scan_body_flops_once": st.flops,
            "n_periods": n_periods,
            "ops": st.ops,
            "analysis": "fast" if fast and n_periods > 2 else "full",
        },
        "collectives": {
            "bytes_by_kind": dict(coll.bytes_by_kind),
            "count_by_kind": dict(coll.count_by_kind),
            "weighted_bytes": weighted_collective_bytes(coll.bytes_by_kind),
        },
        "roofline": rf.row(),
        "params": cfg.param_counts(),
        "compile_seconds": seconds,
    }


def analyze_cell(
    arch: str,
    shape_name: str,
    *,
    multi_pod: bool = False,
    bc: BackendConfig = BASELINE,
    chips_per_pod: int = 1,
    fast: bool = False,
) -> Dict:
    """Full dry run + roofline for one cell on ``chips_per_pod`` chips, or
    on two pods of them (default: one card).  Beside the reference's keys
    the record names the torch that traced it and ``chips_per_pod``."""
    cfg = get_config(arch)
    shape = get_shape(shape_name)
    ok, reason = applicable(cfg, shape)
    if not ok:
        return {"arch": arch, "shape": shape_name, "multi_pod": multi_pod,
                "skipped": True, "skip_reason": reason, **provenance(chips_per_pod)}
    mesh = build_cell_mesh(bc, multi_pod=multi_pod, chips_per_pod=chips_per_pod)
    return {**analyze(cfg, shape, bc, mesh, fast=fast), **provenance(chips_per_pod)}


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None)
    ap.add_argument("--multi-pod", action="store_true", help="two pods of --chips-per-pod")
    ap.add_argument("--both-meshes", action="store_true", help="one pod, then two")
    ap.add_argument("--all", action="store_true", help="all (arch x shape) cells")
    ap.add_argument("--out", default=None, help="JSON output path")
    ap.add_argument("--chips-per-pod", type=int, default=1,
                    help="chips of a pod (1: one card; the reference's default is 256)")
    ap.add_argument("--log2-dp", type=int, default=BASELINE.log2_dp)
    ap.add_argument("--style", default=BASELINE.sharding_style)
    ap.add_argument("--remat", default=BASELINE.remat)
    ap.add_argument("--microbatches", type=int, default=BASELINE.microbatches)
    args = ap.parse_args(argv)

    bc = BASELINE.replace(
        log2_dp=args.log2_dp, sharding_style=args.style, remat=args.remat,
        microbatches=args.microbatches,
    )
    cells = []
    if args.all:
        cells = [(arch, shape_name) for arch in list_archs() for shape_name in SHAPES]
    else:
        if not (args.arch and args.shape):
            ap.error("--arch/--shape or --all")
        cells.append((args.arch, args.shape))

    results, done = [], set()
    mine = provenance(args.chips_per_pod)
    jl = pathlib.Path(str(args.out) + ".jsonl") if args.out else None
    if jl is not None and jl.exists():  # restart-safe: skip cells already recorded
        for line in jl.read_text().splitlines():
            try:
                r = json.loads(line)
            except ValueError:
                continue
            # a record of another torch or pod size is traced again
            if "error" not in r and all(r.get(k) == v for k, v in mine.items()):
                done.add((r["arch"], r["shape"], bool(r.get("multi_pod"))))
                results.append(r)

    meshes = [False, True] if args.both_meshes else [args.multi_pod]
    for arch, shape_name in cells:
        for mp in meshes:
            if (arch, shape_name, mp) in done:
                continue
            mesh = build_cell_mesh(bc, multi_pod=mp, chips_per_pod=args.chips_per_pod)
            tag = f"{arch}/{shape_name}/{'x'.join(map(str, mesh.sizes))}"
            try:
                # the two-pod pass is the reference's fast one (fast=mp)
                rec = analyze_cell(arch, shape_name, multi_pod=mp, bc=bc,
                                   chips_per_pod=args.chips_per_pod, fast=mp)
                if rec.get("skipped"):
                    print(f"[dryrun] {tag}: SKIP ({rec['skip_reason']})")
                else:
                    r = rec["roofline"]
                    print(
                        f"[dryrun] {tag}: OK mem/dev "
                        f"{rec['memory']['per_device_B']/1e9:.2f}GB "
                        f"fits={r['fits_hbm']} bottleneck={r['bottleneck']} "
                        f"step={r['est_step_s']*1e3:.2f}ms "
                        f"tput={r['throughput_tok_s']:.3g}tok/s "
                        f"collectives={r['collectives']} "
                        f"trace={rec['compile_seconds']:.1f}s"
                    )
            except Exception as e:  # report, keep going
                traceback.print_exc()
                rec = {"arch": arch, "shape": shape_name, "multi_pod": mp,
                       "error": f"{type(e).__name__}: {e}", **mine}
                print(f"[dryrun] {tag}: FAIL {rec['error']}")
            results.append(rec)
            if jl is not None:  # incremental (restart-safe) record
                jl.parent.mkdir(parents=True, exist_ok=True)
                with open(jl, "a") as f:
                    f.write(json.dumps(rec, default=str) + "\n")
            sys.stdout.flush()

    if args.out:
        out = pathlib.Path(args.out)
        out.parent.mkdir(parents=True, exist_ok=True)
        out.write_text(json.dumps(results, indent=1, default=str))
        print(f"[dryrun] wrote {out}")
    return results


if __name__ == "__main__":
    main()
