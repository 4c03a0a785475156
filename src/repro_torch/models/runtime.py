"""Runtime (backend) knobs — the tunable surface of the framework.

``Runtime`` is a frozen dataclass so it is hashable and cheap to vary with
``dataclasses.replace`` (the tuner's way of moving through the space).

``tuning_db`` attaches a persistent
:class:`~repro_torch.tuning.tundb.TuningDB` of best-known kernel
configurations: the kernel dispatch layer (``repro_torch.kernels.ops``)
consults it with the actual call shapes and overrides the tile knobs below
on a hit, falling back to them on a miss.  ``None`` (the default) leaves
every code path on its heuristic defaults.  A ``TuningDB`` hashes by
identity, so the dataclass stays hashable.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import TYPE_CHECKING, Optional

import torch

if TYPE_CHECKING:  # annotation only: models must not depend on the tuning
    from repro_torch.tuning.tundb import TuningDB  # stack at import time

_DTYPES = {"bf16": torch.bfloat16, "f32": torch.float32}

#: The one validated remat vocabulary.  The tuner's search space and
#: ``Runtime`` (the executing backend) must accept exactly the same
#: choices.  Serving ignores the mode; training maps each one onto
#: ``torch.utils.checkpoint`` (models/lm.py).
REMAT_MODES = ("none", "dots", "names", "full")

#: ``attn_impl`` vocabulary: the oracle, the chunked oracle, and the
#: hand-written Hopper kernels.
ATTN_IMPLS = ("ref", "chunked", "cuda")


@dataclass(frozen=True)
class Runtime:
    # kernel implementation + tile sizes (KMP_BLOCKTIME analogue)
    attn_impl: str = "ref"  # ref | chunked | cuda
    scan_impl: str = "chunked"  # ref | chunked | cuda
    block_q: int = 512
    block_kv: int = 512
    scan_chunk: int = 128

    # memory/recompute policy
    remat: str = "none"  # one of REMAT_MODES: none | dots | names | full

    # numerics
    compute_dtype: str = "bf16"  # bf16 | f32

    # MoE
    moe_capacity_factor: float = 0.0  # 0 => use config value
    moe_groups: int = 0  # 0 => one group per sequence
    moe_impl: str = "gspmd"  # gspmd (baseline) | ep_local (expert parallel)

    # causal tile pruning in the chunked oracle (the kernels never visit a
    # dead tile in the first place)
    attn_prune: bool = False

    # python-loop variant of the chunked oracle (see kernels/ref.py)
    unroll_layers: bool = False

    # best-known kernel configs, consulted by the ops layer (see module
    # docstring); None => heuristic tile defaults above
    tuning_db: Optional["TuningDB"] = None

    def __post_init__(self):
        if self.remat not in REMAT_MODES:
            raise ValueError(
                f"unknown remat mode {self.remat!r}; one of {REMAT_MODES}")
        if self.attn_impl == "pallas":
            raise ValueError(
                "attn_impl='pallas' names the reference's TPU kernels; the "
                "hand-written kernels of this package are attn_impl='cuda'")
        if self.attn_impl not in ATTN_IMPLS:
            raise ValueError(
                f"unknown attn_impl {self.attn_impl!r}; one of {ATTN_IMPLS}")

    def dtype(self) -> torch.dtype:
        return _DTYPES[self.compute_dtype]


CPU_TEST = Runtime(compute_dtype="f32", scan_chunk=16, block_q=64, block_kv=64)
