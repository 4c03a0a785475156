"""Logical-axis sharding rules.

Parameters and activations carry *logical* axis names ("embed", "ff",
"heads", "vocab", "experts", "batch", "seq", ...).  A ``ShardingRules``
maps logical names to mesh axis names, dropping any assignment whose
dimension is not divisible by the mesh-axis size (e.g. qwen2's 14 heads on
a 16-way model axis are replicated rather than unevenly sharded).

Two rule families (both tunable by the paper-style tuner):

* ``tp``      — pure tensor-parallel: params shard over "model" only; the
                "data"/"pod" axes carry batch (classic DP+TP).
* ``fsdp_tp`` — additionally shards the params' "embed" dimension over
                "data" (ZeRO-3/FSDP style).

The rules are pure mapping logic.  A spec is a plain tuple, one entry a
dimension (a mesh axis name, a tuple of names, or ``None``), trailing
``None`` dropped: the reference's ``PartitionSpec`` as a tuple.  A mesh is
anything with ``.shape`` (axis name -> size) and ``.axis_names``
(``repro_torch.launch.mesh.Mesh``).  Nothing here places a tensor: one
card has a 1x1 mesh, where every spec is empty, and ``sharding_for`` /
``tree_shardings`` return the specs.  Placement over several cards waits
for ROADMAP A14.
"""
from __future__ import annotations

import contextlib
import math
import threading
from typing import Optional, Sequence, Tuple


# logical name -> candidate mesh axes (first whose size divides the dim wins;
# a tuple value means "shard over these mesh axes jointly").
def make_rules(style: str, multi_pod: bool) -> dict:
    batch_axes = ("pod", "data") if multi_pod else ("data",)
    rules = {
        "batch": batch_axes,
        "seq": ("model",),  # activations' seq dim: only for long-context/SP
        "vocab": ("model",),
        "heads": ("model",),
        "kv_heads": ("model",),
        "ff": ("model",),
        "experts": ("model",),
        "cache_seq": ("model",),
        "state": ("model",),
        "layers": None,
        "head": None,
        "lora": None,
        "embed": ("data",) if style == "fsdp_tp" else None,
    }
    if style not in ("tp", "fsdp_tp"):
        raise ValueError(f"unknown sharding style {style!r}")
    return rules


def _is_axes(x) -> bool:
    return isinstance(x, tuple) and all(isinstance(a, (str, type(None))) for a in x)


class ShardingRules:
    def __init__(self, mesh, style: str = "fsdp_tp", overrides: Optional[dict] = None):
        self.mesh = mesh
        self.style = style
        multi_pod = "pod" in mesh.axis_names
        self.rules = make_rules(style, multi_pod)
        if overrides:
            self.rules.update(overrides)

    def _axis_size(self, axis) -> int:
        if isinstance(axis, tuple):
            return int(math.prod(self.mesh.shape[a] for a in axis))
        return int(self.mesh.shape[axis])

    def spec_for(
        self, logical_axes: Sequence[Optional[str]], shape: Optional[Tuple[int, ...]] = None
    ) -> tuple:
        """Resolve logical axes -> spec tuple, honouring divisibility."""
        out = []
        used: set = set()
        for i, name in enumerate(logical_axes):
            assignment = None
            if name is not None:
                cand = self.rules.get(name)
                if cand is not None:
                    flat = cand if isinstance(cand, tuple) else (cand,)
                    # skip axes already used by another dim of this array
                    if not (set(flat) & used):
                        size = self._axis_size(cand)
                        if shape is None or shape[i] % size == 0:
                            # bare name for single axes, as the reference
                            assignment = flat[0] if len(flat) == 1 else cand
                            used.update(flat)
            out.append(assignment)
        while out and out[-1] is None:
            out.pop()
        return tuple(out)

    def sharding_for(self, logical_axes, shape=None) -> tuple:
        return self.spec_for(logical_axes, shape)

    def tree_specs(self, axes_tree, values_tree):
        """Spec tree parallel to a params tree (nested dicts whose leaves
        are axes tuples, beside values with a ``.shape``)."""
        # imported here: the model code imports this module for shard_hint
        from repro_torch.models.params import tree_map

        return tree_map(
            lambda axes, v: self.spec_for(axes, tuple(v.shape)),
            axes_tree,
            values_tree,
            is_leaf=_is_axes,
        )

    def tree_shardings(self, axes_tree, values_tree):
        return self.tree_specs(axes_tree, values_tree)


# ---------------------------------------------------------------------------
# Activation sharding hints inside model code
# ---------------------------------------------------------------------------

_ACTIVE = threading.local()


@contextlib.contextmanager
def active_rules(rules: Optional[ShardingRules]):
    prev = getattr(_ACTIVE, "rules", None)
    _ACTIVE.rules = rules
    try:
        yield
    finally:
        _ACTIVE.rules = prev


def shard_hint(x, logical_axes: Sequence[Optional[str]]):
    """The sharding constraint of ``x`` under the active rules: the
    identity outside ``active_rules`` and on a mesh of one device.  A
    larger mesh would need its tensors placed, which waits for ROADMAP
    A14."""
    rules: Optional[ShardingRules] = getattr(_ACTIVE, "rules", None)
    if rules is None or math.prod(rules.mesh.shape.values()) == 1:
        return x
    raise NotImplementedError(
        "sharding hints over a mesh of more than one device are not ported "
        "(ROADMAP A14)")
