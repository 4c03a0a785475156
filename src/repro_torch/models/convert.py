"""Carry weights and serving state across from the reference package.

The reference's value trees arrive as numpy arrays (a test produces them
with ``jax.tree_util.tree_map(np.asarray, tree)``); the port's trees have
the same keys and layouts, so the conversion is leaf by leaf.  bfloat16
leaves arrive either as ``ml_dtypes`` bfloat16 arrays or already widened
to float32; both give the same torch tensor.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.models.params import tree_map


def _leaf_to_tensor(a, device) -> torch.Tensor:
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":  # ml_dtypes: reinterpret the 16 bits
        t = torch.from_numpy(np.ascontiguousarray(a).view(np.uint16).copy())
        return t.view(torch.bfloat16).to(device)
    return torch.from_numpy(np.ascontiguousarray(a).copy()).to(device)


def params_from_numpy(tree, *, device, dtype=None):
    """Reference value tree (numpy leaves) -> the port's value tree on
    ``device``.  ``dtype`` casts the floating leaves (the once-for-all cast
    of the serve path); ``None`` keeps each leaf's own type."""

    def conv(a):
        t = _leaf_to_tensor(a, device)
        if dtype is not None and t.is_floating_point():
            t = t.to(dtype)
        return t

    return tree_map(conv, tree)


def cache_from_numpy(tree, *, device):
    """Reference cache tree (numpy leaves) -> the port's: ``pos`` becomes a
    host integer, the K/V buffers go back to bfloat16 (what the reference
    stores, however the leaves were widened on the way)."""
    layers = tree_map(lambda a: _leaf_to_tensor(a, device).to(torch.bfloat16),
                      tree["layers"])
    return {"pos": int(np.asarray(tree["pos"])), "layers": layers}
