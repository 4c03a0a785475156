"""Plain float32 reference of RWKV-6 3B as the ``rwkv6-3b`` cells serve it.

The equations are ``rwkv.py``'s (imported, not copied: the program's
blocks, time and channel mix, WKV recurrence in exact chunks, untied
head), here with the serving drivers' signature.  A recurrent model keeps
no keys or values, so ``keep`` must be None: the state is checked through
the logits of every decode step that reads it.  The products run in
float32 without TF32, as the harness's ``precision(tf32=False)`` sets
them.  Imports nothing of the program.
"""
from __future__ import annotations

from typing import Optional

import torch

from portbench.reference import rwkv
from portbench.reference.common import Products, precision


def logits(w: dict, port: dict, tokens: torch.Tensor, *, at: Optional[torch.Tensor] = None,
           products: Optional[Products] = None, keep=None) -> torch.Tensor:
    """Logits (N, len(at), vocab) in float32 of ``tokens`` (N, S) from a
    zero state, at the sequence indices ``at`` (all where None)."""
    if keep is not None:
        raise ValueError("RWKV-6 keeps no keys or values: keep must be None")
    with precision(tf32=False):
        return rwkv.logits(w, port, tokens, at=at, products=products)
