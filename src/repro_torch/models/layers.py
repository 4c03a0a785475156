"""Neural layers for the model zoo (plain functions on tensors, P-tree params).

Every mixer implements three modes:
  * ``full``    — forward over the whole sequence (no cache)
  * ``prefill`` — full forward that additionally fills the decode cache
  * ``decode``  — one-token step consuming + updating the cache

Apply functions take plain value trees (see models/params.py) and a
``Runtime`` for backend knobs.  All matmuls run in ``rt.dtype()``;
softmax statistics in fp32.

Every mixer and MLP kind of the reference is here: RMSNorm and LayerNorm,
RoPE, GQA attention (optionally sliding-window), MLA, the dense MLP, the
capacity-dispatched MoE, Mamba-1 and RWKV-6's time and channel mix.

Two things differ from the reference package on purpose:

* every cache (KV buffers, latent buffers, recurrent states) is updated
  **in place** and handed back (the reference's arrays are immutable; its
  decode step donates the cache to the same effect).  The returned cache
  holds what the reference's holds.
* ``pos`` is a host integer, so the ring-buffer slot and the valid length
  cost no device round trip.
"""
from __future__ import annotations

import functools
import math
from typing import Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.kernels import ops
from repro_torch.kernels.ref import gla_scan_chunked_ref, ssm_scan_chunked_ref
from repro_torch.models.params import P, dense_init, ones_init, zeros_init
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


def init_layernorm(d: int, device=None) -> dict:
    return {"scale": ones_init((d,), (None,), device=device),
            "bias": zeros_init((d,), (None,), device=device)}


def layernorm(p, x, eps: float) -> torch.Tensor:
    """Plain PyTorch, fp32 statistics, as in the reference (which has no
    kernel for it)."""
    xf = x.float()
    mu = xf.mean(-1, keepdim=True)
    var = ((xf - mu) ** 2).mean(-1, keepdim=True)
    y = (xf - mu) * torch.rsqrt(var + eps)
    return (y * p["scale"] + p["bias"]).to(x.dtype)


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
# MLA — multi-head latent attention (MiniCPM3 / DeepSeek-V2 style)
# ---------------------------------------------------------------------------


def init_mla(gen: torch.Generator, cfg: ModelConfig) -> dict:
    m = cfg.mla
    d, h = cfg.d_model, cfg.num_heads
    qk_head = m.qk_nope_head_dim + m.qk_rope_head_dim
    dev = gen.device
    return {
        "wq_a": dense_init(gen, (d, m.q_lora_rank), ("embed", "lora"), fan_in=d),
        "q_norm": init_rmsnorm(m.q_lora_rank, device=dev),
        "wq_b": dense_init(gen, (m.q_lora_rank, h, qk_head),
                           ("lora", "heads", "head"), fan_in=m.q_lora_rank),
        "wkv_a": dense_init(gen, (d, m.kv_lora_rank + m.qk_rope_head_dim),
                            ("embed", "lora"), fan_in=d),
        "kv_norm": init_rmsnorm(m.kv_lora_rank, device=dev),
        "wkv_b": dense_init(
            gen, (m.kv_lora_rank, h, m.qk_nope_head_dim + m.v_head_dim),
            ("lora", "heads", "head"), fan_in=m.kv_lora_rank),
        "wo": dense_init(gen, (h, m.v_head_dim, d), ("heads", "head", "embed"),
                         fan_in=h * m.v_head_dim),
    }


def init_mla_cache(cfg: ModelConfig, batch: int, cache_len: int, device=None) -> dict:
    """The compressed latent and the shared rotary key, bf16, as in the
    reference."""
    m = cfg.mla
    return {
        "ckv": zeros_init((batch, cache_len, m.kv_lora_rank),
                          ("batch", "cache_seq", "lora"), dtype=torch.bfloat16,
                          device=device),
        "krope": zeros_init((batch, cache_len, m.qk_rope_head_dim),
                            ("batch", "cache_seq", "head"), dtype=torch.bfloat16,
                            device=device),
    }


def _head_project(x, w, rt: Runtime):
    """(B,S,r) x (r,h,k) -> (B,S,h,k)."""
    r, h, k = w.shape
    return torch.matmul(x, _dt(w, rt).reshape(r, h * k)).reshape(*x.shape[:-1], h, k)


def mla_apply(
    p, x, *, cfg: ModelConfig, rt: Runtime, mode: str,
    cache: Optional[dict] = None, pos: Optional[int] = None,
) -> Tuple[torch.Tensor, Optional[dict]]:
    """Expanded attention over the heads in ``full`` / ``prefill`` (through
    ``ops.attention``, head dims ``dn + dr`` for Q/K and ``dv`` for V);
    absorbed attention in the latent space in ``decode``, on the oracle as
    the reference pins it (the latent key, ``kv_lora_rank + dr`` wide, is
    wider than the decode kernel's head dims)."""
    m = cfg.mla
    B, S, D = x.shape
    dn, dr = m.qk_nope_head_dim, m.qk_rope_head_dim
    scale = (dn + dr) ** -0.5
    xc = _dt(x, rt)

    q_lat = rmsnorm(p["q_norm"], xc @ _dt(p["wq_a"], rt), cfg.norm_eps, rt)
    q = _head_project(_dt(q_lat, rt), p["wq_b"], rt)
    q_nope, q_rope = q[..., :dn], q[..., dn:]

    kv_a = xc @ _dt(p["wkv_a"], rt)
    ckv = rmsnorm(p["kv_norm"], kv_a[..., : m.kv_lora_rank], cfg.norm_eps, rt)
    k_rope = kv_a[..., m.kv_lora_rank:]  # (B, S, dr) shared across heads

    if mode in ("full", "prefill"):
        tables = _rope_tables_at(0, S, 0, dr, cfg.rope_theta, x.device)
        q_rope = apply_rope(q_rope, None, cfg.rope_theta, tables)
        k_rope_r = apply_rope(k_rope[:, :, None, :], None, cfg.rope_theta, tables)
        # expanded (naive) attention for the parallel modes
        kv = _head_project(_dt(ckv, rt), p["wkv_b"], rt)
        k_nope, v = kv[..., :dn], kv[..., dn:]
        k = torch.cat([k_nope, k_rope_r.expand(*k_nope.shape[:3], dr)], dim=-1)
        qq = torch.cat([q_nope, q_rope], dim=-1)
        out = ops.attention(
            qq, k, v, causal=True, scale=scale,
            impl=rt.attn_impl, block_q=rt.block_q, block_kv=rt.block_kv,
            unroll=rt.unroll_layers, prune=rt.attn_prune, db=rt.tuning_db,
        )
        new_cache = None
        if mode == "prefill":
            cache["ckv"][:, :S] = ckv.to(cache["ckv"].dtype)
            cache["krope"][:, :S] = k_rope_r[:, :, 0].to(cache["krope"].dtype)
            new_cache = {"ckv": cache["ckv"], "krope": cache["krope"]}
    else:  # decode — absorbed latent-space attention (the point of MLA)
        pos = int(pos)
        ck, kr = cache["ckv"], cache["krope"]
        if not 0 <= pos < ck.shape[1]:
            raise IndexError(f"decode position {pos} is outside the cache of "
                             f"{ck.shape[1]} slots")
        tables = _rope_tables_at(pos, 1, B, dr, cfg.rope_theta, x.device)
        q_rope = apply_rope(q_rope, None, cfg.rope_theta, tables)
        k_rope_r = apply_rope(k_rope[:, :, None, :], None, cfg.rope_theta, tables)[:, :, 0]
        ck[:, pos] = ckv[:, 0].to(ck.dtype)
        kr[:, pos] = k_rope_r[:, 0].to(kr.dtype)
        new_cache = {"ckv": ck, "krope": kr}
        wkv_b = _dt(p["wkv_b"], rt)
        w_k, w_v = wkv_b[..., :dn], wkv_b[..., dn:]
        # absorb the key expansion into the query: q_eff (B, H, r + dr)
        q_eff = torch.cat(
            [torch.einsum("bhk,rhk->bhr", q_nope[:, 0], w_k), q_rope[:, 0]], dim=-1)
        keys = torch.cat([_dt(ck, rt), _dt(kr, rt)], dim=-1)[:, :, None, :]
        vals = _dt(ck, rt)[:, :, None, :]
        lengths = torch.full((B,), pos + 1, dtype=torch.int32, device=x.device)
        o_lat = ops.decode_attention(q_eff, keys, vals, lengths, scale=scale,
                                     impl="ref")  # latent kv: the oracle
        out = torch.einsum("bhr,rhv->bhv", o_lat, w_v)[:, None]

    h, dv, d = p["wo"].shape
    out = torch.matmul(out.reshape(B, S, h * dv), _dt(p["wo"], rt).reshape(h * dv, d))
    return out.to(x.dtype), new_cache


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


# ---------------------------------------------------------------------------
# Mixture of Experts (GShard-style grouped capacity dispatch)
# ---------------------------------------------------------------------------


def init_moe(gen: torch.Generator, cfg: ModelConfig) -> dict:
    m = cfg.moe
    d, f, e = cfg.d_model, m.d_expert, m.num_experts
    return {
        "router": dense_init(gen, (d, e), ("embed", "experts"), fan_in=d),
        "w_gate": dense_init(gen, (e, d, f), ("experts", "embed", "ff"), fan_in=d),
        "w_up": dense_init(gen, (e, d, f), ("experts", "embed", "ff"), fan_in=d),
        "w_down": dense_init(gen, (e, f, d), ("experts", "ff", "embed"), fan_in=f),
    }


MOE_IMPLS = ("gspmd", "ep_local")


def moe_apply(p, x, *, cfg: ModelConfig, rt: Runtime) -> Tuple[torch.Tensor, torch.Tensor]:
    """Returns (out, aux_loss).  ``rt.moe_impl``: ``"gspmd"`` is the
    grouped capacity dispatch below.  ``"ep_local"`` (expert parallelism
    over a mesh's model axis) needs sharding rules, and one card has none,
    so it takes the same path, as the reference does when no rules are
    active."""
    if rt.moe_impl not in MOE_IMPLS:
        raise ValueError(f"unknown moe_impl {rt.moe_impl!r}; one of {MOE_IMPLS}")
    return _moe_apply_gspmd(p, x, cfg=cfg, rt=rt)


def moe_capacity(cfg: ModelConfig, rt: Runtime, tokens_per_group: int) -> int:
    """Slots per expert and group: ceil(capacity_factor * T * K / E)."""
    m = cfg.moe
    cf = rt.moe_capacity_factor or m.capacity_factor
    return max(1, int(math.ceil(cf * tokens_per_group * m.top_k / m.num_experts)))


def moe_route(p, x, *, cfg: ModelConfig, rt: Runtime):
    """Router, top-k and capacity ranks of the tokens of ``x`` (B, S, D)
    in groups of ``rt.moe_groups`` (0: one group a sequence): returns the
    grouped tokens in the compute dtype (G, T, D), the renormalised top-k
    weights and experts (G, T, K), the Switch aux loss, the capacity C,
    and ``keep`` (G, T, K): whether the slot fits in its expert's
    capacity (a slot that does not goes to the overflow slot and counts
    for nothing)."""
    m = cfg.moe
    B, S, D = x.shape
    E, K = m.num_experts, m.top_k
    G = rt.moe_groups or B
    T = (B * S) // G
    xc = _dt(x.reshape(G, T, D), rt)

    logits = (xc @ _dt(p["router"], rt)).float()  # (G, T, E)
    probs = torch.softmax(logits, dim=-1)
    top_p, top_i = torch.topk(probs, K, dim=-1)  # (G, T, K)
    top_p = top_p / torch.clamp(top_p.sum(-1, keepdim=True), min=1e-9)

    # aux load-balance loss (Switch): E * mean(frac_tokens * frac_probs)
    frac_probs = probs.mean(dim=(0, 1))  # (E,)
    frac_tokens = F.one_hot(top_i[..., 0], E).float().mean(dim=(0, 1))
    aux = E * torch.sum(frac_probs * frac_tokens)

    C = moe_capacity(cfg, rt, T)
    # rank of each (token, slot) within its expert, group-local, exclusive
    oh = F.one_hot(top_i, E).reshape(G, T * K, E)
    ranks = torch.cumsum(oh, dim=1) - oh
    rank_of = torch.sum(ranks * oh, dim=-1).reshape(G, T, K)
    keep = rank_of < C
    return xc, top_p, top_i, aux, C, rank_of, keep


def _moe_apply_gspmd(p, x, *, cfg: ModelConfig, rt: Runtime):
    """Capacity dispatch: each kept (token, slot) is scatter-added into its
    expert's row of a (G, E*C + 1, D) buffer (the last row is the overflow
    slot), the experts' SwiGLU runs on the buffer, and each slot's output
    is gathered back and weighted."""
    E = cfg.moe.num_experts
    B, S, D = x.shape
    xc, top_p, top_i, aux, C, rank_of, keep = moe_route(p, x, cfg=cfg, rt=rt)
    G, T, K = top_i.shape

    dump = E * C  # overflow slot
    dest = torch.where(keep, top_i * C + rank_of, dump).reshape(G, T * K, 1)

    # dispatch: slot (t, k) carries token t
    buf = torch.zeros((G, E * C + 1, D), dtype=xc.dtype, device=x.device)
    buf.scatter_add_(1, dest.expand(G, T * K, D), xc.repeat_interleave(K, dim=1))
    buf = buf[:, : E * C].reshape(G, E, C, D)

    # expert FFN (SwiGLU)
    g = F.silu(torch.einsum("gecd,edf->gecf", buf, _dt(p["w_gate"], rt)))
    u = torch.einsum("gecd,edf->gecf", buf, _dt(p["w_up"], rt))
    y = torch.einsum("gecf,efd->gecd", g * u, _dt(p["w_down"], rt))

    # combine: gather each slot's output, weight, sum over k
    y_flat = torch.cat([y.reshape(G, E * C, D), y.new_zeros((G, 1, D))], dim=1)
    gathered = torch.gather(y_flat, 1, dest.expand(G, T * K, D)).reshape(G, T, K, D)
    w = (top_p * keep).to(y.dtype)
    out = torch.einsum("gtkd,gtk->gtd", gathered, w)
    return out.reshape(B, S, D).to(x.dtype), aux


# ---------------------------------------------------------------------------
# Mamba-1 block (Jamba's SSM mixer)
# ---------------------------------------------------------------------------


def init_mamba(gen: torch.Generator, cfg: ModelConfig) -> dict:
    mc = cfg.mamba
    d = cfg.d_model
    d_in = mc.expand * d
    dtr = mc.resolved_dt_rank(d)
    N = mc.d_state
    dev = gen.device
    # S4D-real A init: A[d, n] = n + 1 (A = -exp(A_log)); computed, not drawn
    A = torch.arange(1, N + 1, dtype=torch.float32, device=dev).expand(d_in, N)
    return {
        "in_proj": dense_init(gen, (d, 2 * d_in), ("embed", "ff"), fan_in=d),
        "conv_w": dense_init(gen, (mc.d_conv, d_in), (None, "ff"), fan_in=mc.d_conv),
        "conv_b": zeros_init((d_in,), ("ff",), device=dev),
        "x_proj": dense_init(gen, (d_in, dtr + 2 * N), ("ff", None), fan_in=d_in),
        "dt_w": dense_init(gen, (dtr, d_in), (None, "ff"), fan_in=dtr),
        "dt_b": P(torch.log(torch.expm1(torch.full((d_in,), 0.01, device=dev))), ("ff",)),
        "A_log": P(torch.log(A), ("ff", None)),
        "D": ones_init((d_in,), ("ff",), device=dev),
        "out_proj": dense_init(gen, (d_in, d), ("ff", "embed"), fan_in=d_in),
    }


def init_mamba_cache(cfg: ModelConfig, batch: int, device=None) -> dict:
    """f32 states, as in the reference."""
    mc = cfg.mamba
    d_in = mc.expand * cfg.d_model
    return {
        "conv": zeros_init((batch, mc.d_conv - 1, d_in), ("batch", None, "state"),
                           device=device),
        "h": zeros_init((batch, d_in, mc.d_state), ("batch", "state", None),
                        device=device),
    }


def mamba_apply(
    p, x, *, cfg: ModelConfig, rt: Runtime, mode: str,
    cache: Optional[dict] = None, pos: Optional[int] = None,
) -> Tuple[torch.Tensor, Optional[dict]]:
    """``full`` runs the selective scan through ``ops.ssm_scan`` (the K4
    kernel under ``scan_impl="cuda"``); ``prefill`` takes the chunked
    oracle, which also returns the final state (the kernel returns none);
    ``decode`` is one recurrence step."""
    mc = cfg.mamba
    B, S, D = x.shape
    d_in = mc.expand * cfg.d_model
    dtr = mc.resolved_dt_rank(cfg.d_model)
    N = mc.d_state
    xc = _dt(x, rt)
    xz = xc @ _dt(p["in_proj"], rt)  # (B, S, 2*d_in)
    xs, z = xz[..., :d_in], xz[..., d_in:]

    conv_w = _dt(p["conv_w"], rt)  # (d_conv, d_in)
    if mode in ("full", "prefill"):
        xpad = torch.cat([xs.new_zeros((B, mc.d_conv - 1, d_in)), xs], dim=1)
        xconv = sum(
            xpad[:, i: i + S] * conv_w[i][None, None] for i in range(mc.d_conv)
        ) + _dt(p["conv_b"], rt)
    else:
        xpad = torch.cat([_dt(cache["conv"], rt), xs], dim=1)  # (B, d_conv, d_in)
        xconv = torch.einsum("bcd,cd->bd", xpad, conv_w)[:, None] + _dt(p["conv_b"], rt)
    xconv = F.silu(xconv)

    xdbl = xconv @ _dt(p["x_proj"], rt)
    dt_raw, Bc, Cc = xdbl[..., :dtr], xdbl[..., dtr: dtr + N], xdbl[..., dtr + N:]
    dt = F.softplus(dt_raw @ _dt(p["dt_w"], rt) + _dt(p["dt_b"], rt))
    A = -torch.exp(p["A_log"].float())

    new_cache = None
    if mode == "full":
        y = ops.ssm_scan(xconv, dt, A, Bc, Cc, p["D"],
                         impl=rt.scan_impl, chunk=rt.scan_chunk, db=rt.tuning_db)
    elif mode == "prefill":
        y, h_final = ssm_scan_chunked_ref(xconv, dt, A, Bc, Cc, p["D"],
                                          chunk=rt.scan_chunk)
        conv_state = torch.cat([xs.new_zeros((B, mc.d_conv - 1, d_in)), xs],
                               dim=1)[:, -(mc.d_conv - 1):]
        cache["conv"].copy_(conv_state)
        cache["h"].copy_(h_final)
        new_cache = cache
    else:  # decode: one recurrence step
        h = cache["h"].float()  # (B, d_in, N)
        dtt, xt = dt[:, 0].float(), xconv[:, 0].float()
        Bt, Ct = Bc[:, 0].float(), Cc[:, 0].float()
        h = torch.exp(dtt[..., None] * A[None]) * h + (dtt * xt)[..., None] * Bt[:, None]
        y = (torch.einsum("bdn,bn->bd", h, Ct) + xt * p["D"].float())[:, None]
        conv_state = torch.cat([cache["conv"], xs.to(cache["conv"].dtype)], dim=1)[:, 1:]
        cache["conv"].copy_(conv_state)
        cache["h"].copy_(h)
        new_cache = cache

    y = _dt(y, rt) * F.silu(z)
    out = y @ _dt(p["out_proj"], rt)
    return out.to(x.dtype), new_cache


# ---------------------------------------------------------------------------
# RWKV-6 "Finch" time-mix + channel-mix
# ---------------------------------------------------------------------------


def init_rwkv_tmix(gen: torch.Generator, cfg: ModelConfig) -> dict:
    rc = cfg.rwkv
    d = cfg.d_model
    H = d // rc.head_size
    dev = gen.device
    return {
        "mu": zeros_init((5, d), (None, None), device=dev),  # ddlerp mix for w,k,v,r,g
        "mix_w1": dense_init(gen, (d, 5 * rc.mix_lora), ("embed", None), fan_in=d,
                             scale=0.1),
        "mix_w2": dense_init(gen, (5, rc.mix_lora, d), (None, None, "embed"),
                             fan_in=rc.mix_lora, scale=0.1),
        "w_lora1": dense_init(gen, (d, rc.decay_lora), ("embed", None), fan_in=d,
                              scale=0.1),
        "w_lora2": dense_init(gen, (rc.decay_lora, d), (None, "embed"),
                              fan_in=rc.decay_lora, scale=0.1),
        # computed, not drawn: a decay bias ramp from -6 to -1
        "w_bias": P(-6.0 + 5.0 * (torch.arange(d, dtype=torch.float32, device=dev)
                                  / max(d - 1, 1)), ("embed",)),
        "wr": dense_init(gen, (d, d), ("embed", "heads"), fan_in=d),
        "wk": dense_init(gen, (d, d), ("embed", "heads"), fan_in=d),
        "wv": dense_init(gen, (d, d), ("embed", "heads"), fan_in=d),
        "wg": dense_init(gen, (d, d), ("embed", "heads"), fan_in=d),
        "wo": dense_init(gen, (d, d), ("heads", "embed"), fan_in=d),
        "u": dense_init(gen, (H, rc.head_size), ("heads", None), fan_in=1, scale=0.5),
        "ln_x": init_layernorm(d, device=dev),
    }


def init_rwkv_cmix(gen: torch.Generator, cfg: ModelConfig) -> dict:
    d, f = cfg.d_model, cfg.d_ff
    dev = gen.device
    return {
        "mu_k": zeros_init((d,), (None,), device=dev),
        "mu_r": zeros_init((d,), (None,), device=dev),
        "wk": dense_init(gen, (d, f), ("embed", "ff"), fan_in=d),
        "wv": dense_init(gen, (f, d), ("ff", "embed"), fan_in=f),
        "wr": dense_init(gen, (d, d), ("embed", None), fan_in=d),
    }


def init_rwkv_cache(cfg: ModelConfig, batch: int, device=None) -> dict:
    """f32 states, as in the reference."""
    rc = cfg.rwkv
    d = cfg.d_model
    H = d // rc.head_size
    return {
        "x_tmix": zeros_init((batch, d), ("batch", None), device=device),
        "x_cmix": zeros_init((batch, d), ("batch", None), device=device),
        "S": zeros_init((batch, H, rc.head_size, rc.head_size),
                        ("batch", "heads", None, None), device=device),
    }


def _token_shift(x, x_prev_last):
    """The previous token of every position, (B, S, D): the cache's last
    token (or zeros) before the first."""
    first = (x.new_zeros(x[:, :1].shape) if x_prev_last is None
             else x_prev_last[:, None].to(x.dtype))
    return torch.cat([first, x[:, :-1]], dim=1)


def rwkv_tmix_apply(
    p, x, *, cfg: ModelConfig, rt: Runtime, mode: str,
    cache: Optional[dict] = None,
) -> Tuple[torch.Tensor, Optional[dict]]:
    """``full`` runs the wkv scan through ``ops.gla_scan`` (the K5 kernel
    under ``scan_impl="cuda"``); ``prefill`` takes the chunked oracle, which
    also returns the final state; ``decode`` is one recurrence step."""
    rc = cfg.rwkv
    B, S, D = x.shape
    hs = rc.head_size
    H = D // hs
    xc = _dt(x, rt)

    x_last = cache["x_tmix"] if cache is not None else None
    dx = _token_shift(xc, x_last) - xc

    # data-dependent ddlerp for the five streams
    mix_base = xc + dx * _dt(p["mu"], rt)[:, None, None]  # (5, B, S, D)
    lora = torch.tanh(xc @ _dt(p["mix_w1"], rt)).reshape(B, S, 5, rc.mix_lora)
    lora = torch.einsum("bsfm,fmd->fbsd", lora, _dt(p["mix_w2"], rt))
    xw, xk, xv, xr, xg = [mix_base[i] + dx * lora[i] for i in range(5)]

    r = (xr @ _dt(p["wr"], rt)).reshape(B, S, H, hs)
    k = (xk @ _dt(p["wk"], rt)).reshape(B, S, H, hs)
    v = (xv @ _dt(p["wv"], rt)).reshape(B, S, H, hs)
    g = F.silu(xg @ _dt(p["wg"], rt))

    w_raw = (torch.tanh(xw @ _dt(p["w_lora1"], rt)) @ _dt(p["w_lora2"], rt)
             + _dt(p["w_bias"], rt))
    w = torch.exp(-torch.exp(w_raw.float())).reshape(B, S, H, hs)
    u = p["u"].float()

    new_cache = None
    if mode == "full":
        y = ops.gla_scan(r, k, v, w.to(r.dtype), u.to(r.dtype),
                         impl=rt.scan_impl, chunk=rt.scan_chunk, db=rt.tuning_db)
    elif mode == "prefill":
        y, S_final = gla_scan_chunked_ref(r, k, v, w.to(r.dtype), u.to(r.dtype),
                                          chunk=rt.scan_chunk)
        cache["x_tmix"].copy_(xc[:, -1])
        cache["S"].copy_(S_final)
        new_cache = cache
    else:  # decode: one recurrence step
        Sst = cache["S"].float()  # (B, H, hs, hs)
        rt_, kt, vt = (a[:, 0].float() for a in (r, k, v))
        wt = w[:, 0]
        bonus = torch.einsum("bhk,hk,bhk->bh", rt_, u, kt)
        y = (torch.einsum("bhk,bhkv->bhv", rt_, Sst) + bonus[..., None] * vt)[:, None]
        cache["S"].copy_(wt[..., None] * Sst + kt[..., None] * vt[:, :, None, :])
        cache["x_tmix"].copy_(xc[:, 0])
        new_cache = cache
        y = y.to(r.dtype)

    y = layernorm(p["ln_x"], y.reshape(B, S, D), 1e-5)  # per-layer output norm (ln_x)
    out = (_dt(y, rt) * g) @ _dt(p["wo"], rt)
    return out.to(x.dtype), new_cache


def rwkv_cmix_apply(
    p, x, *, cfg: ModelConfig, rt: Runtime, mode: str,
    cache: Optional[dict] = None,
) -> Tuple[torch.Tensor, Optional[dict]]:
    xc = _dt(x, rt)
    x_last = cache["x_cmix"] if cache is not None else None
    dx = _token_shift(xc, x_last) - xc
    xk = xc + dx * _dt(p["mu_k"], rt)
    xr = xc + dx * _dt(p["mu_r"], rt)
    k = torch.square(torch.relu(xk @ _dt(p["wk"], rt)))
    kv = k @ _dt(p["wv"], rt)
    out = torch.sigmoid(xr @ _dt(p["wr"], rt)) * kv
    new_cache = None
    if cache is not None:
        cache["x_cmix"].copy_(xc[:, -1])
        new_cache = cache
    return out.to(x.dtype), new_cache
