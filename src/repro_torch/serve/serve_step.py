"""Serving steps: batched prefill + single-token decode, under
``torch.no_grad()``.
"""
from __future__ import annotations

from typing import Dict

import torch

from repro_torch.kernels.ops import with_db
from repro_torch.models.model import Model
from repro_torch.models.runtime import Runtime


def make_prefill_step(model: Model, rt: Runtime, *, tuning_db=None):
    rt = with_db(rt, tuning_db)

    @torch.no_grad()
    def prefill_step(params, batch: Dict[str, torch.Tensor], cache):
        logits, _, new_cache = model.apply(
            params, batch, rt=rt, mode="prefill", cache=cache
        )
        return logits, new_cache

    return prefill_step


def make_decode_step(model: Model, rt: Runtime, *, tuning_db=None):
    rt = with_db(rt, tuning_db)

    @torch.no_grad()
    def decode_step(params, tokens: torch.Tensor, cache):
        return model.decode_step(params, tokens, cache, rt=rt)

    return decode_step


def greedy_sample(logits: torch.Tensor) -> torch.Tensor:
    return torch.argmax(logits[:, -1], dim=-1).to(torch.int32)[:, None]


def generate(model: Model, params, batch, *, rt: Runtime, cache, steps: int,
             tuning_db=None):
    """Prefill + greedy decode loop (the path of the examples and of launch/serve.py)."""
    prefill = make_prefill_step(model, rt, tuning_db=tuning_db)
    decode = make_decode_step(model, rt, tuning_db=tuning_db)
    logits, cache = prefill(params, batch, cache)
    tok = greedy_sample(logits)
    out = [tok]
    for _ in range(steps - 1):
        logits, cache = decode(params, tok, cache)
        tok = greedy_sample(logits)
        out.append(tok)
    return torch.cat(out, dim=1), cache
