"""Unified decoder-only LM.  This slice serves the dense family (attention
mixer, dense MLP); the other mixers and MLP kinds raise until their slice.

Layer stacks follow the *repeating period* of the layer plan
(configs/base.py:layer_period): per-period-position parameters are stacked
along a leading ``layers`` dim, as in the reference package, and walked
with a python loop (eager PyTorch has no scan to compile).

Three entry points: ``forward`` (full / prefill), ``decode_step`` and
``init_cache``.  The cache is updated in place and handed back;
``cache["pos"]`` is a host integer.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.models import layers as L
from repro_torch.models.params import P, dense_init, stack_layer_params, tree_map
from repro_torch.models.runtime import Runtime
from repro_torch.models.layers import shard_hint

MIXER_INIT = {
    "attn": L.init_attention,
}


def _not_ported(what: str, kind: str):
    return NotImplementedError(
        f"{what} kind {kind!r} is not ported yet (ROADMAP.md, Queue A: "
        "remaining model families)")


def _init_block(gen, cfg: ModelConfig, mixer_kind: str, mlp_kind: str) -> dict:
    if mixer_kind not in MIXER_INIT:
        raise _not_ported("mixer", mixer_kind)
    if cfg.rwkv is not None:
        raise _not_ported("mlp", "rwkv_cmix")
    if mlp_kind == "moe":
        raise _not_ported("mlp", mlp_kind)
    return {
        "norm1": L.init_rmsnorm(cfg.d_model, device=gen.device),
        "mixer": MIXER_INIT[mixer_kind](gen, cfg),
        "norm2": L.init_rmsnorm(cfg.d_model, device=gen.device),
        "mlp": L.init_mlp(gen, cfg),
    }


def init_lm(gen: torch.Generator, cfg: ModelConfig) -> dict:
    """Returns a P-tree (values + logical axes), f32, on the generator's
    device.  Same tree structure, shapes and distributions as the reference
    package; the random numbers themselves differ."""
    plan = cfg.layer_plan()
    period = cfg.layer_period()
    n_periods = cfg.num_layers // period

    params = {
        "embed": dense_init(gen, (cfg.padded_vocab, cfg.d_model),
                            ("vocab", "embed"), fan_in=cfg.d_model),
        "final_norm": L.init_rmsnorm(cfg.d_model, device=gen.device),
    }
    if not cfg.tie_embeddings:
        params["head"] = dense_init(gen, (cfg.d_model, cfg.padded_vocab),
                                    ("embed", "vocab"), fan_in=cfg.d_model)

    blocks = {}
    for pos in range(period):
        mixer_kind, mlp_kind = plan[pos]
        per_period = [
            _init_block(gen, cfg, mixer_kind, mlp_kind)
            for _ in range(n_periods)
        ]
        blocks[f"pos{pos}"] = stack_layer_params(per_period)
    params["blocks"] = blocks
    return params


def _block_apply(
    block, x, *, cfg: ModelConfig, rt: Runtime, mixer_kind: str, mlp_kind: str,
    mode: str, cache: Optional[dict], pos: Optional[int],
) -> Tuple[torch.Tensor, float, Optional[dict]]:
    """Pre-norm residual block.  Returns (x, aux_loss, new_cache)."""
    use_rope = cfg.attn_period == 0  # hybrids carry no explicit PE
    h = L.rmsnorm(block["norm1"], x, cfg.norm_eps, rt)
    mixer_cache = cache.get("mixer") if cache else None
    new_cache = {}
    if mixer_kind == "attn":
        h, mc = L.attention_apply(block["mixer"], h, cfg=cfg, rt=rt, mode=mode,
                                  cache=mixer_cache, pos=pos, use_rope=use_rope)
    elif mixer_kind in ("mla", "mamba", "rwkv"):
        raise _not_ported("mixer", mixer_kind)
    else:
        raise ValueError(mixer_kind)
    x = x + h
    if mc is not None:
        new_cache["mixer"] = mc

    h = L.rmsnorm(block["norm2"], x, cfg.norm_eps, rt)
    if cfg.rwkv is not None:
        raise _not_ported("mlp", "rwkv_cmix")
    if mlp_kind == "moe":
        raise _not_ported("mlp", mlp_kind)
    h = L.mlp_apply(block["mlp"], h, cfg=cfg, rt=rt)
    x = x + h
    return x, 0.0, (new_cache or None)


def _embed(params, tokens, cfg, rt, image_embeds=None):
    x = F.embedding(tokens, params["embed"]).to(rt.dtype())
    if image_embeds is not None:
        n = image_embeds.shape[1]
        x = torch.cat([image_embeds.to(x.dtype), x[:, n:]], dim=1)
    return shard_hint(x, ("batch", None, "embed_act"))


def _head(params, x, cfg, rt):
    x = L.rmsnorm(params["final_norm"], x, cfg.norm_eps, rt)
    w = params.get("head")
    if w is None:
        w = params["embed"].T
    logits = x.to(rt.dtype()) @ w.to(rt.dtype())
    return shard_hint(logits, ("batch", None, "vocab"))


def _walk_periods(params, cache_layers, x, *, cfg, rt, mode, pos):
    """Apply every layer in order: period by period, position by position.
    ``a[i]`` of a stacked leaf is a view, so the cache slices handed to the
    blocks alias the stacked cache and are updated in place."""
    plan = cfg.layer_plan()
    period = cfg.layer_period()
    n_periods = cfg.num_layers // period
    aux = 0.0
    for i in range(n_periods):
        for pos_i in range(period):
            mixer_kind, mlp_kind = plan[pos_i]
            key = f"pos{pos_i}"
            block = tree_map(lambda a: a[i], params["blocks"][key])
            c = (tree_map(lambda a: a[i], cache_layers[key])
                 if cache_layers else None)
            x, aux_i, _ = _block_apply(
                block, x, cfg=cfg, rt=rt, mixer_kind=mixer_kind,
                mlp_kind=mlp_kind, mode=mode, cache=c, pos=pos,
            )
            aux = aux + aux_i
    return x, aux


def forward(
    params,
    tokens: torch.Tensor,  # (B, S) integer
    *,
    cfg: ModelConfig,
    rt: Runtime,
    mode: str = "full",  # full | prefill
    cache: Optional[dict] = None,
    image_embeds: Optional[torch.Tensor] = None,
) -> Tuple[torch.Tensor, torch.Tensor, Optional[dict]]:
    """Returns (logits, aux_loss, new_cache).

    mode="full":    logits for every position.
    mode="prefill": logits for the LAST position only + the cache, filled
                    in place.
    """
    if mode not in ("full", "prefill"):
        raise ValueError(f"forward mode must be 'full' or 'prefill', got {mode!r}")
    if mode == "prefill" and cache is None:
        raise ValueError("mode='prefill' needs a cache (Model.init_cache)")
    x = _embed(params, tokens, cfg, rt, image_embeds)
    cache_layers = cache["layers"] if (cache is not None and mode == "prefill") else None
    x, aux = _walk_periods(params, cache_layers, x, cfg=cfg, rt=rt, mode=mode, pos=None)

    new_cache = None
    if mode == "prefill":
        new_cache = {"pos": int(tokens.shape[1]), "layers": cache_layers}
        x = x[:, -1:]  # only last-position logits for prefill
    logits = _head(params, x, cfg, rt)
    aux = torch.as_tensor(aux, dtype=torch.float32, device=logits.device)
    return logits, aux, new_cache


def decode_step(
    params,
    tokens: torch.Tensor,  # (B, 1) integer
    cache: dict,
    *,
    cfg: ModelConfig,
    rt: Runtime,
) -> Tuple[torch.Tensor, dict]:
    """One decode token for the whole batch.  Returns (logits (B,1,V), cache);
    the cache is the one passed in, updated in place, with ``pos`` advanced."""
    pos = int(cache["pos"])
    x = _embed(params, tokens, cfg, rt)
    x, _ = _walk_periods(params, cache["layers"], x, cfg=cfg, rt=rt,
                         mode="decode", pos=pos)
    logits = _head(params, x, cfg, rt)
    return logits, {"pos": pos + 1, "layers": cache["layers"]}


# ---------------------------------------------------------------------------
# Cache construction (P-tree, like params)
# ---------------------------------------------------------------------------


def init_cache(cfg: ModelConfig, batch: int, cache_len: int, device=None) -> dict:
    plan = cfg.layer_plan()
    period = cfg.layer_period()
    n_periods = cfg.num_layers // period

    def cache_for(mixer_kind):
        if mixer_kind != "attn":
            raise _not_ported("mixer", mixer_kind)
        return {"mixer": L.init_attention_cache(cfg, batch, cache_len, device=device)}

    layer_caches = {}
    for pos_i in range(period):
        mixer_kind, _ = plan[pos_i]
        per = [cache_for(mixer_kind) for _ in range(n_periods)]
        layer_caches[f"pos{pos_i}"] = stack_layer_params(per)
    return {"pos": P(0, ()), "layers": layer_caches}
