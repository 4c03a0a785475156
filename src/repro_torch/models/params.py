"""Parameter tree helpers.

``init`` functions build nested dicts whose leaves are ``P(value, axes)`` —
the tensor plus its *logical* sharding axes (names like "embed", "ff",
"heads", "vocab"; ``None`` = replicated dim).  ``split_params`` separates
the tree into (values, axes) so apply functions see plain tensors.  Leaf
names and layouts are the reference package's, so a reference tree converts
leaf by leaf (models/convert.py).
"""
from __future__ import annotations

import math
from typing import NamedTuple, Optional, Tuple

import torch


class P(NamedTuple):
    value: torch.Tensor
    axes: Tuple[Optional[str], ...]


def is_p(x) -> bool:
    return isinstance(x, P)


def tree_map(fn, tree, *rest, is_leaf=None):
    """Map ``fn`` over the leaves of nested dicts (everything that is not a
    dict, or for which ``is_leaf`` holds, is a leaf).  ``None`` maps to
    ``None``."""
    if tree is None:
        return None
    if isinstance(tree, dict) and not (is_leaf is not None and is_leaf(tree)):
        return {k: tree_map(fn, v, *(r[k] for r in rest), is_leaf=is_leaf)
                for k, v in tree.items()}
    return fn(tree, *rest)


def tree_leaves(tree) -> list:
    """The leaves of nested dicts, in the order ``tree_map`` visits them."""
    out = []
    tree_map(out.append, tree)
    return out


def split_params(tree):
    values = tree_map(lambda p: p.value, tree, is_leaf=is_p)
    axes = tree_map(lambda p: p.axes, tree, is_leaf=is_p)
    return values, axes


def dense_init(
    gen: torch.Generator,
    shape: Tuple[int, ...],
    axes: Tuple[Optional[str], ...],
    *,
    fan_in: Optional[int] = None,
    scale: float = 1.0,
    dtype=torch.float32,
) -> P:
    """Truncated-normal (±2σ) init with 1/sqrt(fan_in) scaling, drawn on the
    generator's device."""
    fan_in = fan_in if fan_in is not None else shape[0]
    std = scale / math.sqrt(max(fan_in, 1))
    value = torch.empty(shape, dtype=torch.float32, device=gen.device)
    torch.nn.init.trunc_normal_(value, mean=0.0, std=1.0, a=-2.0, b=2.0,
                                generator=gen)
    return P((std * value).to(dtype), axes)


def zeros_init(shape, axes, dtype=torch.float32, device=None) -> P:
    return P(torch.zeros(shape, dtype=dtype, device=device), axes)


def ones_init(shape, axes, dtype=torch.float32, device=None) -> P:
    return P(torch.ones(shape, dtype=dtype, device=device), axes)


def const_init(value, axes, device=None) -> P:
    return P(torch.as_tensor(value, device=device), axes)


def stack_layer_params(per_layer_trees):
    """Stack a list of identical param trees along a new leading 'layers' dim."""

    def stack(*ps):
        vals = torch.stack([p.value for p in ps])
        return P(vals, ("layers",) + ps[0].axes)

    return tree_map(stack, per_layer_trees[0], *per_layer_trees[1:],
                    is_leaf=is_p)


def stack_zeros(tree, n: int, device=None):
    """The stack of ``n`` copies of a P-tree of zeros (a cache's layer),
    allocated at once on ``device``: stacking ``n`` drawn trees would hold
    the layers twice (a 32k cache of batch 128 is 51.5 GB)."""
    def stack(p):
        v = p.value
        return P(torch.zeros((n,) + tuple(v.shape), dtype=v.dtype, device=device),
                 ("layers",) + p.axes)

    return tree_map(stack, tree, is_leaf=is_p)
