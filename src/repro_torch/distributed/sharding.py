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
(``repro_torch.launch.mesh.Mesh``).  ``sharding_for`` / ``tree_shardings``
return the specs.

Placement (the reference's ``NamedSharding``) is a ``DTensor`` on the
rules' ``device_mesh`` (``launch.mesh.device_mesh``): ``placements(spec,
mesh)`` turns a spec into one ``Shard(dim)`` / ``Replicate()`` a mesh axis
(a joint ``("pod", "data")`` entry shards one tensor dim over both, major
first, as a ``PartitionSpec`` does), and ``place`` / ``tree_place`` make a
tensor a ``DTensor`` holding this rank's shard: a ``meta`` tensor gets a
fresh ``meta`` shard (the dry run's per-device bytes), a real one its
slice.  ``shard_hint`` is ``with_sharding_constraint``: a ``redistribute``
to the hint's placements under active rules on a mesh of more than one
device, the identity on one card and outside ``active_rules``.
"""
from __future__ import annotations

import contextlib
import math
import threading
from typing import Optional, Sequence, Tuple

import torch


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


def _mesh_size(mesh) -> int:
    return int(math.prod(mesh.shape.values()))


def placements(spec: tuple, mesh) -> tuple:
    """The DTensor placements of ``spec`` on ``mesh``, one a mesh axis."""
    from torch.distributed.tensor import Replicate, Shard

    out = [Replicate()] * len(mesh.axis_names)
    for dim, entry in enumerate(spec):
        if entry is None:
            continue
        names = entry if isinstance(entry, tuple) else (entry,)
        idx = [mesh.axis_names.index(a) for a in names]
        if idx != sorted(idx):
            raise ValueError(f"joint spec {entry} is not in mesh order {mesh.axis_names}")
        for i in idx:
            out[i] = Shard(dim)
    return tuple(out)


def local_shape(spec: tuple, shape: Tuple[int, ...], mesh) -> Tuple[int, ...]:
    """One device's shard of a ``shape`` array under ``spec`` (the
    reference's ``NamedSharding(mesh, spec).shard_shape(shape)``)."""
    out = list(shape)
    for dim, entry in enumerate(spec):
        if entry is not None:
            names = entry if isinstance(entry, tuple) else (entry,)
            out[dim] //= int(math.prod(mesh.shape[a] for a in names))
    return tuple(out)


class ShardingRules:
    def __init__(self, mesh, style: str = "fsdp_tp", overrides: Optional[dict] = None,
                 device_mesh=None):
        self.mesh = mesh
        self.style = style
        #: the ``DeviceMesh`` that ``place`` and ``shard_hint`` place on
        #: (needed only on a mesh of more than one device)
        self.device_mesh = device_mesh
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

    # -- placement -------------------------------------------------------------
    @property
    def distributed(self) -> bool:
        """Whether tensors are placed: a mesh of more than one device."""
        return _mesh_size(self.mesh) > 1

    def _dm(self):
        if self.device_mesh is None:
            raise ValueError(f"placing on the {dict(self.mesh.shape)} mesh needs its "
                             "DeviceMesh (ShardingRules(..., device_mesh=...))")
        return self.device_mesh

    def placements_for(self, logical_axes, shape) -> tuple:
        return placements(self.spec_for(logical_axes, tuple(shape)), self.mesh)

    def place(self, t, logical_axes):
        """``t`` as a DTensor holding this rank's shard (``t`` itself on a
        mesh of one device)."""
        if not self.distributed:
            return t
        from torch.distributed.tensor import DTensor, Shard

        dm = self._dm()
        pl = self.placements_for(logical_axes, t.shape)
        if t.device.type == "meta":
            spec = self.spec_for(logical_axes, tuple(t.shape))
            local = torch.empty(local_shape(spec, tuple(t.shape), self.mesh),
                                dtype=t.dtype, device="meta")
        else:
            local, coord = t, dm.get_coordinate()
            for i, p in enumerate(pl):
                if isinstance(p, Shard):
                    local = local.chunk(dm.size(i), p.dim)[coord[i]]
            local = local.contiguous()
        return DTensor.from_local(local, dm, pl, shape=t.shape, stride=t.stride(),
                                  run_check=False)

    def tree_place(self, axes_tree, values_tree):
        from repro_torch.models.params import tree_map

        return tree_map(lambda axes, v: self.place(v, axes)
                        if isinstance(v, torch.Tensor) else v,
                        axes_tree, values_tree, is_leaf=_is_axes)


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


def local_region(fn, out_placements, in_placements, args, device_mesh):
    """``fn`` on each device's shards of ``args`` (``local_map``): each
    DTensor argument redistributed to its ``in_placements`` first (a plain
    tensor, the same on every rank, taken as replicated), the results laid
    out as ``out_placements`` say (one entry a result)."""
    from torch.distributed.tensor import DTensor, Replicate
    from torch.distributed.tensor.experimental import local_map

    placed = []
    for a, pl in zip(args, in_placements):
        if pl is not None and isinstance(a, torch.Tensor):
            if not isinstance(a, DTensor):
                a = DTensor.from_local(a, device_mesh, [Replicate()] * device_mesh.ndim,
                                       run_check=False)
            if tuple(a.placements) != tuple(pl):
                a = a.redistribute(device_mesh, pl)
        placed.append(a)
    return local_map(fn, out_placements=out_placements, in_placements=in_placements,
                     device_mesh=device_mesh)(*placed)


def placed_zeros(shape, logical_axes, *, dtype, device):
    """``torch.zeros(shape)`` laid out as ``logical_axes`` under the active
    rules: on a mesh each device makes only its shard (a buffer that an
    in-place scatter then fills); a plain tensor otherwise."""
    rules: Optional[ShardingRules] = getattr(_ACTIVE, "rules", None)
    if rules is None or not rules.distributed:
        return torch.zeros(shape, dtype=dtype, device=device)
    from torch.distributed.tensor import DTensor

    shape = tuple(shape)
    spec = rules.spec_for(logical_axes, shape)
    local = torch.zeros(local_shape(spec, shape, rules.mesh), dtype=dtype, device=device)
    stride = [1] * len(shape)
    for d in range(len(shape) - 2, -1, -1):
        stride[d] = stride[d + 1] * shape[d + 1]
    return DTensor.from_local(local, rules._dm(), placements(spec, rules.mesh),
                              shape=shape, stride=tuple(stride), run_check=False)


def shard_hint(x, logical_axes: Sequence[Optional[str]], shape=None):
    """The sharding constraint of ``x`` under the active rules: ``x``
    redistributed to the placements of ``logical_axes`` (a plain tensor is
    taken as replicated first), the identity outside ``active_rules`` and
    on a mesh of one device.  ``shape`` (default ``x.shape``) is what the
    divisibility of each dim is judged on."""
    rules: Optional[ShardingRules] = getattr(_ACTIVE, "rules", None)
    if rules is None or not rules.distributed:
        return x
    from torch.distributed.tensor import DTensor, Replicate

    dm = rules._dm()
    pl = rules.placements_for(logical_axes, x.shape if shape is None else shape)
    if not isinstance(x, DTensor):
        x = DTensor.from_local(x, dm, [Replicate()] * dm.ndim, run_check=False)
    if tuple(x.placements) == pl:
        return x
    return _Constrain.apply(x, dm, pl)


class _Constrain(torch.autograd.Function):
    """``with_sharding_constraint``: the value and its gradient both laid
    out as ``pl`` (DTensor's own redistribute gives a gradient back the
    input's layout, which may leave a partial sum unreduced)."""

    @staticmethod
    def forward(ctx, x, dm, pl):
        ctx.dm, ctx.pl = dm, pl
        return x.redistribute(dm, pl)

    @staticmethod
    def backward(ctx, g):
        return g.redistribute(ctx.dm, ctx.pl), None, None
