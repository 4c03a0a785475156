"""Encoder-decoder transformer (Whisper-style) with a stubbed conv frontend.

The audio frontend is a stub, as in the reference package: the caller
hands in precomputed mel-frame embeddings ``encoder_embeds (B, T_enc, D)``.
LayerNorm + GELU + attention projections per Whisper; positional encoding
is sinusoidal for both stacks.

Attention goes through ``ops``: the encoder's self-attention is not causal,
the decoder's self-attention is causal with a KV cache, and its
cross-attention reads the encoder's K/V (``ops.attention`` over all
``T_enc`` keys in the parallel modes, ``ops.decode_attention`` with
``lengths = T_enc`` in decode).  The caches are updated in place and
``pos`` is a host integer, as in ``models/lm.py``.
"""
from __future__ import annotations

import math
from typing import Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.kernels import ops
from repro_torch.models import layers as L
from repro_torch.models.lm import cast_tree
from repro_torch.models.params import (P, dense_init, stack_layer_params, tree_leaves,
                                      tree_map, zeros_init)
from repro_torch.models.runtime import Runtime


def sinusoids(length: int, channels: int) -> np.ndarray:
    assert channels % 2 == 0
    log_timescale = np.log(10_000.0) / (channels // 2 - 1)
    inv = np.exp(-log_timescale * np.arange(channels // 2))
    t = np.arange(length)[:, None] * inv[None, :]
    return np.concatenate([np.sin(t), np.cos(t)], axis=1).astype(np.float32)


def _pos_enc(positions: torch.Tensor, channels: int) -> torch.Tensor:
    half = channels // 2
    log_timescale = math.log(10_000.0) / (half - 1)
    inv = torch.exp(-log_timescale * torch.arange(half, dtype=torch.float32,
                                                  device=positions.device))
    t = positions.float()[..., None] * inv
    return torch.cat([torch.sin(t), torch.cos(t)], dim=-1)


def _init_enc_block(gen, cfg: ModelConfig) -> dict:
    dev = gen.device
    return {
        "norm1": L.init_layernorm(cfg.d_model, device=dev),
        "attn": L.init_attention(gen, cfg),
        "norm2": L.init_layernorm(cfg.d_model, device=dev),
        "mlp": L.init_mlp(gen, cfg),
    }


def _init_dec_block(gen, cfg: ModelConfig) -> dict:
    dev = gen.device
    return {
        "norm1": L.init_layernorm(cfg.d_model, device=dev),
        "self_attn": L.init_attention(gen, cfg),
        "norm_c": L.init_layernorm(cfg.d_model, device=dev),
        "cross_attn": L.init_attention(gen, cfg),
        "norm2": L.init_layernorm(cfg.d_model, device=dev),
        "mlp": L.init_mlp(gen, cfg),
    }


def init_encdec(gen: torch.Generator, cfg: ModelConfig, dtype=None) -> dict:
    """P-tree on the generator's device, the reference's structure (the
    decoder's head is the embedding, tied).  ``dtype`` as in
    ``lm.init_lm``."""
    dev = gen.device
    return {
        "embed": cast_tree(dense_init(gen, (cfg.padded_vocab, cfg.d_model),
                                      ("vocab", "embed"), fan_in=cfg.d_model), dtype),
        "enc_blocks": stack_layer_params(
            [cast_tree(_init_enc_block(gen, cfg), dtype) for _ in range(cfg.encoder_layers)]),
        "enc_norm": cast_tree(L.init_layernorm(cfg.d_model, device=dev), dtype),
        "dec_blocks": stack_layer_params(
            [cast_tree(_init_dec_block(gen, cfg), dtype) for _ in range(cfg.num_layers)]),
        "final_norm": cast_tree(L.init_layernorm(cfg.d_model, device=dev), dtype),
    }


def _layers(stacked):
    """The per-layer slices of a stacked tree (views, unbound once)."""
    parts = tree_map(lambda a: a.unbind(0), stacked)
    n = len(tree_leaves(stacked)[0])
    return [tree_map(lambda a: a[i], parts) for i in range(n)]


def encode(params, encoder_embeds: torch.Tensor, *, cfg: ModelConfig, rt: Runtime):
    """encoder_embeds (B, T_enc, D), the stub frontend's output."""
    B, T, D = encoder_embeds.shape
    pos = torch.arange(T, device=encoder_embeds.device)
    x = encoder_embeds.to(rt.dtype()) + _pos_enc(pos, D).to(rt.dtype())
    for blk in _layers(params["enc_blocks"]):
        h, _ = L.attention_apply(
            blk["attn"], L.layernorm(blk["norm1"], x, cfg.norm_eps),
            cfg=cfg, rt=rt, mode="full", use_rope=False, causal=False,
        )
        x = x + h
        x = x + L.mlp_apply(blk["mlp"], L.layernorm(blk["norm2"], x, cfg.norm_eps),
                            cfg=cfg, rt=rt)
    return L.layernorm(params["enc_norm"], x, cfg.norm_eps)


def _cross_kv(blk, enc_out, rt):
    p = blk["cross_attn"]
    xc = enc_out.to(rt.dtype())
    k = L._project(xc, p["wk"], p.get("bk"), rt)
    v = L._project(xc, p["wv"], p.get("bv"), rt)
    return k, v


def _cross_attend(blk, x, k, v, *, cfg, rt, mode):
    """Decoder queries against the encoder's K/V.  In decode the K/V are
    the cache's (bf16): read in the type they are stored in, as the
    decoder's self-attention reads its cache (widening is exact)."""
    p = blk["cross_attn"]
    q = L._project(x.to(rt.dtype()), p["wq"], p.get("bq"), rt)
    if mode == "decode":
        lengths = torch.full((x.shape[0],), k.shape[1], dtype=torch.int32, device=x.device)
        out = ops.decode_attention(q[:, 0], k, v, lengths,
                                   impl=rt.attn_impl, block_kv=rt.block_kv,
                                   db=rt.tuning_db)[:, None]
    else:
        out = ops.attention(q, k.to(rt.dtype()), v.to(rt.dtype()),
                            causal=False, impl=rt.attn_impl,
                            block_q=rt.block_q, block_kv=rt.block_kv,
                            unroll=rt.unroll_layers, db=rt.tuning_db)
    B, S = out.shape[:2]
    h, dh, d = p["wo"].shape
    out = torch.matmul(out.reshape(B, S, h * dh), L._dt(p["wo"], rt).reshape(h * dh, d))
    return out.to(x.dtype)


def forward(
    params,
    tokens: torch.Tensor,  # (B, S) decoder tokens
    encoder_embeds: torch.Tensor,  # (B, T_enc, D)
    *,
    cfg: ModelConfig,
    rt: Runtime,
    mode: str = "full",  # full | prefill
    cache: Optional[dict] = None,
) -> Tuple[torch.Tensor, torch.Tensor, Optional[dict]]:
    """Returns (logits, aux_loss (0), new_cache); ``prefill`` fills the
    cache in place (self-attention K/V, and the cross K/V of every layer)
    and returns the last position's logits."""
    if mode not in ("full", "prefill"):
        raise ValueError(f"forward mode must be 'full' or 'prefill', got {mode!r}")
    if mode == "prefill" and cache is None:
        raise ValueError("mode='prefill' needs a cache (Model.init_cache)")
    B, S = tokens.shape
    enc_out = encode(params, encoder_embeds, cfg=cfg, rt=rt)

    x = F.embedding(tokens, params["embed"]).to(rt.dtype())
    x = x + _pos_enc(torch.arange(S, device=tokens.device), cfg.d_model).to(x.dtype)
    caches = _layers(cache["layers"]) if mode == "prefill" else None
    for i, blk in enumerate(_layers(params["dec_blocks"])):
        c = caches[i] if caches else None
        h, _ = L.attention_apply(
            blk["self_attn"], L.layernorm(blk["norm1"], x, cfg.norm_eps),
            cfg=cfg, rt=rt, mode=mode, cache=c["self"] if c else None,
            use_rope=False, causal=True,
        )
        x = x + h
        ck, cv = _cross_kv(blk, enc_out, rt)
        x = x + _cross_attend(blk, L.layernorm(blk["norm_c"], x, cfg.norm_eps),
                              ck, cv, cfg=cfg, rt=rt, mode="full")
        x = x + L.mlp_apply(blk["mlp"], L.layernorm(blk["norm2"], x, cfg.norm_eps),
                            cfg=cfg, rt=rt)
        if c:
            c["cross"]["k"].copy_(ck)
            c["cross"]["v"].copy_(cv)

    new_cache = None
    if mode == "prefill":
        new_cache = {"pos": int(S), "layers": cache["layers"]}
        x = x[:, -1:]
    x = L.layernorm(params["final_norm"], x, cfg.norm_eps)
    logits = x.to(rt.dtype()) @ params["embed"].T.to(rt.dtype())
    return logits, torch.zeros((), dtype=torch.float32, device=logits.device), new_cache


def decode_step(params, tokens: torch.Tensor, cache: dict, *, cfg: ModelConfig,
                rt: Runtime) -> Tuple[torch.Tensor, dict]:
    """One decode token for the whole batch; the cache is updated in place
    and handed back with ``pos`` advanced."""
    pos = int(cache["pos"])
    B = tokens.shape[0]
    x = F.embedding(tokens, params["embed"]).to(rt.dtype())
    x = x + _pos_enc(torch.full((B, 1), pos, device=tokens.device), cfg.d_model).to(x.dtype)
    for blk, c in zip(_layers(params["dec_blocks"]), _layers(cache["layers"])):
        h, _ = L.attention_apply(
            blk["self_attn"], L.layernorm(blk["norm1"], x, cfg.norm_eps),
            cfg=cfg, rt=rt, mode="decode", cache=c["self"], pos=pos,
            use_rope=False, causal=True,
        )
        x = x + h
        x = x + _cross_attend(blk, L.layernorm(blk["norm_c"], x, cfg.norm_eps),
                              c["cross"]["k"], c["cross"]["v"], cfg=cfg, rt=rt,
                              mode="decode")
        x = x + L.mlp_apply(blk["mlp"], L.layernorm(blk["norm2"], x, cfg.norm_eps),
                            cfg=cfg, rt=rt)
    x = L.layernorm(params["final_norm"], x, cfg.norm_eps)
    logits = x.to(rt.dtype()) @ params["embed"].T.to(rt.dtype())
    return logits, {"pos": pos + 1, "layers": cache["layers"]}


def init_cache(cfg: ModelConfig, batch: int, cache_len: int, device=None) -> dict:
    """Self-attention K/V of ``cache_len`` slots and the cross K/V of all
    ``encoder_seq_len`` frames, bf16, stacked over the decoder's layers.
    The cross K/V have the KV heads that prefill writes into them (the
    reference allocates query heads and replaces the buffers with
    prefill's KV-head arrays; the two agree where heads == KV heads, as in
    whisper-base)."""
    h, dh = cfg.num_kv_heads, cfg.resolved_head_dim
    axes = ("batch", "cache_seq", "kv_heads", "head")
    per = []
    for _ in range(cfg.num_layers):
        per.append({
            "self": L.init_attention_cache(cfg, batch, cache_len, device=device),
            "cross": {
                "k": zeros_init((batch, cfg.encoder_seq_len, h, dh), axes,
                                dtype=torch.bfloat16, device=device),
                "v": zeros_init((batch, cfg.encoder_seq_len, h, dh), axes,
                                dtype=torch.bfloat16, device=device),
            },
        })
    return {"pos": P(0, ()), "layers": stack_layer_params(per)}
