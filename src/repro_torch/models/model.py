"""Model facade: one object per architecture config.

Wraps the family-specific init/apply/cache functions behind a uniform
interface used by the server (and later the trainer, benchmarks and tuner):

    model = build_model(get_config("qwen2-0.5b"))
    params = model.init(gen)                      # P-tree, on gen.device
    logits, aux, _ = model.apply(values, batch, rt=rt)
    cache = model.init_cache(batch=8, cache_len=1024, device=dev)
    logits, cache = model.decode_step(values, tok, cache_values, rt=rt)

Encoder-decoder configs and ``input_specs`` (shape stand-ins for the
dry run) follow with their slices.
"""
from __future__ import annotations

from typing import Dict, Optional

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models import lm
from repro_torch.models.runtime import Runtime


class Model:
    def __init__(self, cfg: ModelConfig):
        if cfg.encoder_layers > 0:
            raise NotImplementedError(
                f"{cfg.name}: encoder-decoder models are not ported yet "
                "(ROADMAP.md, Queue A: remaining model families)")
        self.cfg = cfg
        self.is_encdec = False

    # -- params / cache -----------------------------------------------------
    def init(self, gen: torch.Generator) -> dict:
        return lm.init_lm(gen, self.cfg)

    def init_cache(self, batch: int, cache_len: int, device=None) -> dict:
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
        return lm.forward(
            params, batch["tokens"], cfg=self.cfg, rt=rt, mode=mode,
            cache=cache, image_embeds=batch.get("image_embeds"),
        )

    def decode_step(self, params, tokens, cache, *, rt: Runtime):
        return lm.decode_step(params, tokens, cache, cfg=self.cfg, rt=rt)


def build_model(cfg: ModelConfig) -> Model:
    return Model(cfg)
