"""AdamW over a param dict, with the large-scale memory options.

* ``state_dtype="f32"``   — standard AdamW (fp32 m, v).
* ``state_dtype="bf16"``  — m, v stored bf16 (halves the optimizer's
  memory; the update math still runs fp32).
* ``factored=True``       — Adafactor-style factored second moment for
  rank>=2 params (row/col means instead of full v): O(n+m) not O(nm).

Written against nested dicts of tensors rather than ``torch.optim.AdamW``
so that one step is the reference package's step, leaf for leaf: the same
bias corrections, the same global-norm clip, weight decay on matrices only
(``ndim >= 2``, which includes the stacked per-layer vectors) and the same
factored reconstruction.  Functional: the inputs are left as they were,
unless the caller donates them (``donate=True``, as the reference's jitted
step donates params and state): then each leaf is written back in place,
a large stacked leaf in slabs of ``_SLAB`` elements, so that the step
needs no second copy of params and state (a 3.1 B-parameter model keeps
50 GB of them in f32).
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Tuple

import torch

from repro_torch.models.params import tree_leaves, tree_map


@dataclass(frozen=True)
class OptimizerConfig:
    learning_rate: float = 3e-4
    beta1: float = 0.9
    beta2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    grad_clip: float = 1.0
    warmup_steps: int = 100
    total_steps: int = 10_000
    min_lr_ratio: float = 0.1
    state_dtype: str = "f32"  # f32 | bf16
    factored: bool = False


def lr_schedule(cfg: OptimizerConfig, step: torch.Tensor) -> torch.Tensor:
    """Linear warmup + cosine decay to min_lr_ratio (fp32, on step's device)."""
    step = step.to(torch.float32)
    warm = torch.clamp(step / max(cfg.warmup_steps, 1), max=1.0)
    prog = torch.clamp(
        (step - cfg.warmup_steps) / max(cfg.total_steps - cfg.warmup_steps, 1),
        0.0, 1.0,
    )
    cos = 0.5 * (1 + torch.cos(math.pi * prog))
    decay = cfg.min_lr_ratio + (1 - cfg.min_lr_ratio) * cos
    return cfg.learning_rate * warm * decay


def _state_dt(cfg: OptimizerConfig) -> torch.dtype:
    return torch.bfloat16 if cfg.state_dtype == "bf16" else torch.float32


def _is_factorable(p: torch.Tensor) -> bool:
    return p.dim() >= 2 and p.shape[-1] >= 8 and p.shape[-2] >= 8


def adamw_init(params, cfg: OptimizerConfig) -> dict:
    sdt = _state_dt(cfg)
    device = tree_leaves(params)[0].device

    def make_v(p):
        if cfg.factored and _is_factorable(p):
            return {
                "row": torch.zeros(p.shape[:-1], dtype=torch.float32, device=p.device),
                "col": torch.zeros(p.shape[:-2] + p.shape[-1:], dtype=torch.float32,
                                   device=p.device),
            }
        return torch.zeros_like(p, dtype=sdt)

    return {
        "m": tree_map(lambda p: torch.zeros_like(p, dtype=sdt), params),
        "v": tree_map(make_v, params),
        "count": torch.zeros((), dtype=torch.int32, device=device),
    }


def global_norm(tree) -> torch.Tensor:
    sq = [torch.sum(torch.square(x.to(torch.float32))) for x in tree_leaves(tree)]
    return torch.sqrt(torch.sum(torch.stack(sq)))


#: elements of a leaf that a donated update takes at once
_SLAB = 1 << 25


def _at(v, i):
    """Index ``i`` of a second moment, factored (a dict) or not."""
    return {k: t[i] for k, t in v.items()} if isinstance(v, dict) else v[i]


def _copy_(dst, src) -> None:
    if isinstance(dst, dict):
        for k in dst:
            dst[k].copy_(src[k])
    else:
        dst.copy_(src)


@torch.no_grad()
def adamw_update(
    grads, state: dict, params, cfg: OptimizerConfig, *, donate: bool = False
) -> Tuple[dict, dict, dict]:
    """Returns (new_params, new_state, metrics).  ``donate=True`` updates
    ``params`` and ``state`` in place and returns them, the step count
    included (a CUDA graph of the step replays the count it holds)."""
    count = state["count"].add_(1) if donate else state["count"] + 1
    lr = lr_schedule(cfg, count)
    gnorm = global_norm(grads)
    clip = torch.clamp(cfg.grad_clip / torch.clamp(gnorm, min=1e-9), max=1.0)
    sdt = _state_dt(cfg)
    b1, b2 = cfg.beta1, cfg.beta2
    c = count.to(torch.float32)
    bc1 = 1 - b1 ** c
    bc2 = 1 - b2 ** c

    def upd(p, g, m, v, decay):
        g = g.to(torch.float32) * clip
        m32 = b1 * m.to(torch.float32) + (1 - b1) * g
        if isinstance(v, dict):  # factored second moment
            g2 = g * g + 1e-30
            row = b2 * v["row"] + (1 - b2) * g2.mean(dim=-1)
            col = b2 * v["col"] + (1 - b2) * g2.mean(dim=-2)
            v_new = {"row": row, "col": col}
            # reconstruct: v ~ row x col / mean(row)
            denom = torch.clamp(row.mean(dim=-1, keepdim=True), min=1e-30)
            v32 = (row[..., None] * col[..., None, :] / denom[..., None]) / bc2
        else:
            v_new = b2 * v.to(torch.float32) + (1 - b2) * g * g
            v32 = v_new / bc2
            v_new = v_new.to(sdt)
        mhat = m32 / bc1
        step = mhat / (torch.sqrt(v32) + cfg.eps)
        if decay:  # decoupled weight decay on matrices only
            step = step + cfg.weight_decay * p.to(torch.float32)
        p_new = (p.to(torch.float32) - lr * step).to(p.dtype)
        return p_new, m32.to(sdt), v_new

    def upd_(p, g, m, v, decay):
        # a large leaf of more than two dims (layers, experts) in slabs of
        # its first dim: the temporaries of ``upd`` stay about a slab's size
        if p.dim() >= 3 and p.numel() > _SLAB:
            rows = max(1, _SLAB // p[0].numel())
            for i in range(0, p.shape[0], rows):
                at = slice(i, i + rows) if rows > 1 else i  # one row: a dim less
                upd_(p[at], g[at], m[at], _at(v, at), decay)
            return p
        for dst, src in zip((p, m, v), upd(p, g, m, v, decay)):
            _copy_(dst, src)
        return p

    metrics = {"lr": lr, "grad_norm": gnorm, "clip": clip}
    # walks the params' dicts: a factored ``v`` arrives whole at its leaf
    if donate:
        tree_map(lambda p, g, m, v: upd_(p, g, m, v, p.dim() >= 2),
                 params, grads, state["m"], state["v"])
        return params, dict(state, count=count), metrics
    out = tree_map(lambda p, g, m, v: upd(p, g, m, v, p.dim() >= 2),
                   params, grads, state["m"], state["v"])
    pick = lambda i: tree_map(lambda o: o[i], out)
    return pick(0), {"m": pick(1), "v": pick(2), "count": count}, metrics


def optimizer_state_axes(params_axes, cfg: OptimizerConfig, params_values):
    """Logical axes tree for the optimizer state (mirrors the params)."""

    def v_axes(axes, p):
        if cfg.factored and _is_factorable(p):
            return {"row": axes[:-1], "col": axes[:-2] + axes[-1:]}
        return axes

    is_axes = lambda x: isinstance(x, tuple) and all(
        isinstance(a, (str, type(None))) for a in x
    )
    return {
        "m": params_axes,
        "v": tree_map(v_axes, params_axes, params_values, is_leaf=is_axes),
        "count": (),
    }
