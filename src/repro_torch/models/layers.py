"""Neural layers for the model zoo (plain functions on tensors, P-tree params).

Every mixer implements three modes:
  * ``full``    — forward over the whole sequence (no cache)
  * ``prefill`` — full forward that additionally fills the decode cache
  * ``decode``  — one-token step consuming + updating the cache

Apply functions take plain value trees (see models/params.py) and a
``Runtime`` for backend knobs.  All matmuls run in ``rt.dtype()``;
softmax statistics in fp32.

Ported so far: RMSNorm, RoPE, GQA attention (optionally sliding-window)
and the dense MLP.  MLA, MoE, Mamba, RWKV and LayerNorm follow with their
model families.

Two things differ from the reference package on purpose:

* the KV cache is updated **in place** and handed back (the reference's
  arrays are immutable; its decode step donates the cache to the same
  effect).  The returned cache holds what the reference's holds.
* ``pos`` is a host integer, so the ring-buffer slot and the valid length
  cost no device round trip.
"""
from __future__ import annotations

import functools
from typing import Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.kernels import ops
from repro_torch.models.params import dense_init, ones_init, zeros_init
from repro_torch.models.runtime import Runtime


def _dt(x: torch.Tensor, rt: Runtime) -> torch.Tensor:
    """Cast to the compute dtype; a no-op for a tree that was cast once
    (launch/serve.py does that), so no per-step copy of a weight is made."""
    return x.to(rt.dtype())


def shard_hint(x, axes):
    """One card: a sharding hint is the identity."""
    return x


# ---------------------------------------------------------------------------
# Norms
# ---------------------------------------------------------------------------


def init_rmsnorm(d: int, device=None) -> dict:
    return {"scale": ones_init((d,), (None,), device=device)}


def rmsnorm(p, x, eps: float, rt: Runtime) -> torch.Tensor:
    """Through the RMSNorm kernel when the runtime selects the kernels
    (``attn_impl="cuda"``), else the oracle.  The reference package always
    takes its oracle here; see ROADMAP.md, Queue C."""
    impl = "cuda" if rt.attn_impl == "cuda" else "ref"
    return ops.rmsnorm(x, p["scale"], eps, impl=impl, db=rt.tuning_db)


# ---------------------------------------------------------------------------
# RoPE
# ---------------------------------------------------------------------------


def rope_tables(positions: torch.Tensor, dh: int, theta: float):
    """cos / sin of the rotation angles, fp32, shaped (B or 1, S, 1, dh/2);
    positions (S,) or (B, S)."""
    half = dh // 2
    freqs = theta ** (-torch.arange(half, dtype=torch.float32,
                                    device=positions.device) / half)
    ang = positions.to(torch.float32)[..., None] * freqs  # (..., S, half)
    cos, sin = torch.cos(ang), torch.sin(ang)
    if cos.dim() == 2:  # (S, half) -> broadcast over batch
        cos, sin = cos[None], sin[None]
    return cos[:, :, None, :], sin[:, :, None, :]


@functools.lru_cache(maxsize=8)
def _rope_tables_at(first: int, count: int, batch: int, dh: int, theta: float,
                    device: torch.device):
    """Tables for positions ``first .. first+count-1`` (``batch == 0``: shared
    by the batch, as in prefill) or for every sequence at ``first`` (decode).
    Every layer of a step asks for the same tables; eager PyTorch would
    otherwise recompute them, a dozen small launches each time."""
    if batch:
        positions = torch.full((batch, 1), first, device=device)
    else:
        positions = torch.arange(first, first + count, device=device)
    return rope_tables(positions, dh, theta)


def apply_rope(x: torch.Tensor, positions: torch.Tensor, theta: float,
               tables=None) -> torch.Tensor:
    """x (B, S, H, dh) rotate-half RoPE; positions (S,) or (B, S), or
    ``tables`` made by ``rope_tables`` for them."""
    half = x.shape[-1] // 2
    cos, sin = tables if tables is not None else rope_tables(positions, x.shape[-1], theta)
    xf1, xf2 = x[..., :half].float(), x[..., half:].float()
    return torch.cat(
        [xf1 * cos - xf2 * sin, xf1 * sin + xf2 * cos], dim=-1
    ).to(x.dtype)


# ---------------------------------------------------------------------------
# GQA attention (optionally sliding-window)
# ---------------------------------------------------------------------------


def init_attention(gen: torch.Generator, cfg: ModelConfig) -> dict:
    d, h, k_, dh = cfg.d_model, cfg.num_heads, cfg.num_kv_heads, cfg.resolved_head_dim
    dev = gen.device
    p = {
        "wq": dense_init(gen, (d, h, dh), ("embed", "heads", "head"), fan_in=d),
        "wk": dense_init(gen, (d, k_, dh), ("embed", "kv_heads", "head"), fan_in=d),
        "wv": dense_init(gen, (d, k_, dh), ("embed", "kv_heads", "head"), fan_in=d),
        "wo": dense_init(gen, (h, dh, d), ("heads", "head", "embed"), fan_in=h * dh),
    }
    if cfg.qkv_bias:
        p["bq"] = zeros_init((h, dh), ("heads", "head"), device=dev)
        p["bk"] = zeros_init((k_, dh), ("kv_heads", "head"), device=dev)
        p["bv"] = zeros_init((k_, dh), ("kv_heads", "head"), device=dev)
    return p


def init_attention_cache(cfg: ModelConfig, batch: int, cache_len: int,
                         device=None) -> dict:
    """bf16 whatever the compute dtype, as in the reference."""
    k_, dh = cfg.num_kv_heads, cfg.resolved_head_dim
    L = min(cache_len, cfg.sliding_window) if cfg.sliding_window else cache_len
    axes = ("batch", "cache_seq", "kv_heads", "head")
    return {
        "k": zeros_init((batch, L, k_, dh), axes, dtype=torch.bfloat16, device=device),
        "v": zeros_init((batch, L, k_, dh), axes, dtype=torch.bfloat16, device=device),
    }


def _project(x, w, b, rt: Runtime):
    """(B,S,D) x (D,h,k) -> (B,S,h,k), plus bias."""
    d, h, k = w.shape
    out = torch.matmul(x, _dt(w, rt).reshape(d, h * k)).reshape(*x.shape[:-1], h, k)
    return out if b is None else out + _dt(b, rt)


def attention_apply(
    p,
    x: torch.Tensor,  # (B, S, D)
    *,
    cfg: ModelConfig,
    rt: Runtime,
    mode: str,
    cache: Optional[dict] = None,
    pos: Optional[int] = None,  # decode position (host integer)
    use_rope: bool = True,
    causal: bool = True,
    kv_override: Optional[Tuple[torch.Tensor, torch.Tensor]] = None,  # cross-attn
) -> Tuple[torch.Tensor, Optional[dict]]:
    B, S, D = x.shape
    xc = _dt(x, rt)

    q = _project(xc, p["wq"], p.get("bq"), rt)
    if kv_override is None:
        k = _project(xc, p["wk"], p.get("bk"), rt)
        v = _project(xc, p["wv"], p.get("bv"), rt)
    else:
        k, v = kv_override

    new_cache = None
    if mode in ("full", "prefill"):
        if use_rope and kv_override is None:
            tables = _rope_tables_at(0, S, 0, q.shape[-1], cfg.rope_theta, x.device)
            q = apply_rope(q, None, cfg.rope_theta, tables)
            k = apply_rope(k, None, cfg.rope_theta, tables)
        q = shard_hint(q, ("batch", None, "heads", None))
        out = ops.attention(
            q, k, v,
            causal=causal,
            window=cfg.sliding_window if causal else None,
            impl=rt.attn_impl,
            block_q=rt.block_q,
            block_kv=rt.block_kv,
            unroll=rt.unroll_layers,
            prune=rt.attn_prune,
            db=rt.tuning_db,
        )
        if mode == "prefill" and kv_override is None:
            new_cache = _fill_kv_cache(cfg, cache, k, v)
    else:  # decode: S == 1
        assert cache is not None and pos is not None
        pos = int(pos)
        if use_rope:
            tables = _rope_tables_at(pos, 1, B, q.shape[-1], cfg.rope_theta, x.device)
            q = apply_rope(q, None, cfg.rope_theta, tables)
            k = apply_rope(k, None, cfg.rope_theta, tables)
        ck, cv = cache["k"], cache["v"]
        L = ck.shape[1]
        slot = pos % L if cfg.sliding_window else pos
        if not 0 <= slot < L:
            raise IndexError(f"decode position {pos} is outside the cache of {L} slots")
        ck[:, slot] = k[:, 0].to(ck.dtype)
        cv[:, slot] = v[:, 0].to(cv.dtype)
        lengths = torch.full((B,), min(pos + 1, L), dtype=torch.int32, device=x.device)
        # the cache is read in the type it is stored in: widening bf16 to
        # the compute dtype is exact and is left to the callee
        out = ops.decode_attention(
            q[:, 0], ck, cv, lengths,
            impl=rt.attn_impl, block_kv=rt.block_kv, db=rt.tuning_db,
        )[:, None]
        new_cache = {"k": ck, "v": cv}

    h, dh, d = p["wo"].shape
    out = torch.matmul(out.reshape(B, S, h * dh), _dt(p["wo"], rt).reshape(h * dh, d))
    return out.to(x.dtype), new_cache


def _fill_kv_cache(cfg, cache, k, v):
    """Write prefill K/V into the cache buffer (in place) with ring alignment."""
    S = k.shape[1]
    ck, cv = cache["k"], cache["v"]
    L = ck.shape[1]
    if S >= L:
        slots = torch.arange(S - L, S, device=k.device) % L
        ck[:, slots] = k[:, S - L:].to(ck.dtype)
        cv[:, slots] = v[:, S - L:].to(cv.dtype)
    else:
        ck[:, :S] = k.to(ck.dtype)
        cv[:, :S] = v.to(cv.dtype)
    return {"k": ck, "v": cv}


# ---------------------------------------------------------------------------
# Dense MLP (SwiGLU or GELU)
# ---------------------------------------------------------------------------


def init_mlp(gen: torch.Generator, cfg: ModelConfig) -> dict:
    d, f = cfg.d_model, cfg.d_ff
    if cfg.act == "gelu":
        return {
            "w_up": dense_init(gen, (d, f), ("embed", "ff"), fan_in=d),
            "w_down": dense_init(gen, (f, d), ("ff", "embed"), fan_in=f),
        }
    return {
        "w_gate": dense_init(gen, (d, f), ("embed", "ff"), fan_in=d),
        "w_up": dense_init(gen, (d, f), ("embed", "ff"), fan_in=d),
        "w_down": dense_init(gen, (f, d), ("ff", "embed"), fan_in=f),
    }


def mlp_apply(p, x, *, cfg: ModelConfig, rt: Runtime) -> torch.Tensor:
    xc = _dt(x, rt)
    if "w_gate" in p:
        g = F.silu(xc @ _dt(p["w_gate"], rt))
        u = xc @ _dt(p["w_up"], rt)
        h = shard_hint(g * u, ("batch", None, "ff"))
    else:
        # tanh form, the reference's default
        h = F.gelu(xc @ _dt(p["w_up"], rt), approximate="tanh")
        h = shard_hint(h, ("batch", None, "ff"))
    return (h @ _dt(p["w_down"], rt)).to(x.dtype)
