"""Model facade: one object per architecture config.

Wraps the family-specific init/apply/cache functions behind a uniform
interface used by the server (and later the trainer, benchmarks and tuner):

    model = build_model(get_config("qwen2-0.5b"))
    params = model.init(gen)                      # P-tree, on gen.device
    logits, aux, _ = model.apply(values, batch, rt=rt)
    cache = model.init_cache(batch=8, cache_len=1024, device=dev)
    logits, cache = model.decode_step(values, tok, cache_values, rt=rt)

``input_specs`` (shape stand-ins for the dry run) follows with its slice.
"""
from __future__ import annotations

from typing import Dict, Optional

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models import encdec, lm
from repro_torch.models.runtime import Runtime


class Model:
    def __init__(self, cfg: ModelConfig):
        self.cfg = cfg
        self.is_encdec = cfg.encoder_layers > 0

    # -- params / cache -----------------------------------------------------
    def init(self, gen: torch.Generator, dtype=None) -> dict:
        """P-tree on ``gen.device``, drawn in f32; ``dtype`` casts each
        block as it is drawn (see ``lm.init_lm``)."""
        if self.is_encdec:
            return encdec.init_encdec(gen, self.cfg, dtype)
        return lm.init_lm(gen, self.cfg, dtype)

    def init_cache(self, batch: int, cache_len: int, device=None) -> dict:
        if self.is_encdec:
            return encdec.init_cache(self.cfg, batch, cache_len, device=device)
        return lm.init_cache(self.cfg, batch, cache_len, device=device)

    # -- compute ------------------------------------------------------------
    def apply(
        self,
        params,
        batch: Dict[str, torch.Tensor],
        *,
        rt: Runtime,
        mode: str = "full",
        cache: Optional[dict] = None,
    ):
        """Returns (logits, aux_loss, new_cache)."""
        if self.is_encdec:
            return encdec.forward(
                params, batch["tokens"], batch["encoder_embeds"],
                cfg=self.cfg, rt=rt, mode=mode, cache=cache,
            )
        return lm.forward(
            params, batch["tokens"], cfg=self.cfg, rt=rt, mode=mode,
            cache=cache, image_embeds=batch.get("image_embeds"),
        )

    def decode_step(self, params, tokens, cache, *, rt: Runtime):
        if self.is_encdec:
            return encdec.decode_step(params, tokens, cache, cfg=self.cfg, rt=rt)
        return lm.decode_step(params, tokens, cache, cfg=self.cfg, rt=rt)


def build_model(cfg: ModelConfig) -> Model:
    return Model(cfg)
