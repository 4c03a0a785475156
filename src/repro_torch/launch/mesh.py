"""Meshes.

A mesh here is a description: axis names and their sizes (and the devices
it would cover).  Nothing in this slice places a tensor on a mesh; the dry
run analyses one card, whose mesh is ``single_device_mesh()`` (1x1).
Building a mesh never touches CUDA unless the caller leaves ``devices``
out, and then only to count the cards.
"""
from __future__ import annotations

import math
from dataclasses import dataclass, field
from typing import Dict, Optional, Tuple


@dataclass(frozen=True)
class Mesh:
    axis_names: Tuple[str, ...]
    sizes: Tuple[int, ...]
    devices: tuple = field(default=(), compare=False)

    @property
    def shape(self) -> Dict[str, int]:
        """axis name -> size, in axis order."""
        return dict(zip(self.axis_names, self.sizes))

    @property
    def size(self) -> int:
        return math.prod(self.sizes)


def _visible_devices() -> list:
    import torch

    n = torch.cuda.device_count()
    return [f"cuda:{i}" for i in range(n)] if n else ["cpu"]


def make_production_mesh(*, multi_pod: bool = False) -> Mesh:
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return make_mesh(shape, axes)


def make_mesh(shape: Tuple[int, ...], axes: Tuple[str, ...],
              devices: Optional[list] = None) -> Mesh:
    """Arbitrary mesh factorization (the tuner's dp/tp knob).

    shape like (dp, tp) with axes ("data", "model"), or (pods, dp, tp).
    """
    n = math.prod(shape)
    devices = devices if devices is not None else _visible_devices()
    if len(devices) < n:
        raise ValueError(f"need {n} devices, have {len(devices)}")
    return Mesh(tuple(axes), tuple(shape), tuple(devices[:n]))


def single_device_mesh() -> Mesh:
    return Mesh(("data", "model"), (1, 1))
