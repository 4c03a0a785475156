"""Model facade: one object per architecture config.

Wraps the family-specific init/apply/cache functions behind a uniform
interface used by the trainer, server, dry run, benchmarks and tuner:

    model = build_model(get_config("qwen2-0.5b"))
    params = model.init(gen)                      # P-tree, on gen.device
    logits, aux, _ = model.apply(values, batch, rt=rt)
    cache = model.init_cache(batch=8, cache_len=1024, device=dev)
    logits, cache = model.decode_step(values, tok, cache_values, rt=rt)

``input_specs(shape)`` returns the shape, dtype and logical axes of every
model input — the dry run traces against stand-ins made from them,
allocating nothing.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Optional, Tuple

import torch

from repro_torch.configs.base import ModelConfig, ShapeConfig
from repro_torch.models import encdec, lm
from repro_torch.models.runtime import Runtime


@dataclass(frozen=True)
class InputSpec:
    shape: Tuple[int, ...]
    dtype: torch.dtype
    logical_axes: Tuple[Optional[str], ...]

    def make(self, device) -> torch.Tensor:
        """Zeros of this spec on ``device`` (``"meta"``: a stand-in)."""
        return torch.zeros(self.shape, dtype=self.dtype, device=device)


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

    def decode_limit(self, cache) -> Optional[int]:
        """The first position a decode step may not write into ``cache``
        (None: every layer's cache is a ring or a recurrent state)."""
        if self.is_encdec:
            return encdec.decode_limit(self.cfg, cache)
        return lm.decode_limit(self.cfg, cache)

    # -- shape stand-ins ----------------------------------------------------
    def input_specs(self, shape: ShapeConfig) -> Dict[str, InputSpec]:
        cfg = self.cfg
        B, S = shape.global_batch, shape.seq_len
        specs: Dict[str, InputSpec] = {}
        if shape.kind == "decode":
            specs["tokens"] = InputSpec((B, 1), torch.int32, ("batch", None))
        else:
            specs["tokens"] = InputSpec((B, S), torch.int32, ("batch", None))
        if shape.kind == "train":
            specs["targets"] = InputSpec((B, S), torch.int32, ("batch", None))
        if cfg.family == "vlm" and shape.kind != "decode":
            specs["image_embeds"] = InputSpec(
                (B, cfg.num_frontend_tokens, cfg.d_model), torch.bfloat16,
                ("batch", None, None))
        if self.is_encdec and shape.kind != "decode":
            specs["encoder_embeds"] = InputSpec(
                (B, cfg.encoder_seq_len, cfg.d_model), torch.bfloat16,
                ("batch", None, None))
        return specs


def build_model(cfg: ModelConfig) -> Model:
    return Model(cfg)
