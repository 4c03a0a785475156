"""Meshes.

A ``Mesh`` is a description: axis names and their sizes (and the devices
it would cover).  ``device_mesh(mesh, device_type)`` gives the
``torch.distributed`` ``DeviceMesh`` that tensors are placed on
(``distributed/sharding.py``):

* ``"cpu"`` with no process group in the process (the dry run): a ``fake``
  group of ``FAKE_WORLD`` ranks (two 256-chip pods), this process its rank
  0, is made once; every mesh the dry run or the tuner asks for (any dp x
  tp, one pod or two) is a sub-mesh of its first ``mesh.size`` ranks.  A
  fake group moves nothing: its collectives return their inputs' shapes,
  which is all a trace on ``meta`` tensors reads.
* otherwise over the default group the caller made (``gloo`` on the CPU,
  ``nccl`` on the card), whose world holds the mesh.

Building a mesh never touches CUDA unless the caller leaves ``devices``
out of ``make_mesh``, and then only to count the cards; ``device_mesh`` on
``"cpu"`` never does.  One card needs no process group: the one-card dry
run uses ``single_device_mesh()`` (1x1) and builds none.
"""
from __future__ import annotations

import math
from dataclasses import dataclass, field
from typing import Dict, Optional, Tuple

#: ranks of the fake process group the dry run's meshes are cut from
FAKE_WORLD = 512


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


_DEVICE_MESHES: dict = {}


def _default_group_world(device_type: str, n: int) -> int:
    """The default group's world size, made first as a ``fake`` group on
    ``"cpu"`` when the process has none."""
    import torch.distributed as dist

    if not dist.is_initialized():
        if device_type != "cpu":
            raise RuntimeError(f"a {device_type} mesh needs the caller's process group")
        from torch.testing._internal.distributed.fake_pg import FakeStore

        dist.init_process_group("fake", store=FakeStore(), rank=0,
                                world_size=max(FAKE_WORLD, n))
    return dist.get_world_size()


def device_mesh(mesh: Mesh, device_type: str = "cpu"):
    """The ``DeviceMesh`` of ``mesh`` over the first ``mesh.size`` ranks of
    the default group (see the module doc); cached per mesh and group."""
    import torch
    import torch.distributed as dist
    from torch.distributed.device_mesh import DeviceMesh

    world = _default_group_world(device_type, mesh.size)
    if world < mesh.size:
        raise ValueError(f"a {mesh.sizes} mesh needs {mesh.size} ranks, the group has {world}")
    key = (device_type, mesh.axis_names, mesh.sizes, dist.group.WORLD)
    dm = _DEVICE_MESHES.get(key)
    if dm is None:
        ranks = torch.arange(mesh.size).reshape(mesh.sizes)
        dm = _DEVICE_MESHES[key] = DeviceMesh(device_type, ranks,
                                              mesh_dim_names=mesh.axis_names)
    return dm
