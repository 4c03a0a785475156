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
* a decode ``pos`` is either a host integer (the eager step: the
  ring-buffer slot and the valid length cost no device round trip) or a
  0-d integer tensor on the cache's device (the compiled step of
  ``serve/serve_step.py``, as the reference's ``cache["pos"]``): then the
  slot, the cache write, the lengths and the RoPE tables are computed on
  the device (``DevicePosition``) and nothing is read back to the host.
"""
from __future__ import annotations

import dataclasses
import functools
import math
from typing import Optional, Tuple

import torch
import torch.nn.functional as F
from torch.distributed.tensor import DTensor

from repro_torch.configs.base import ModelConfig
from repro_torch.distributed import sharding as _sharding
from repro_torch.distributed.sharding import shard_hint
from repro_torch.kernels import ops
from repro_torch.kernels.ref import gla_scan_chunked_ref, ssm_scan_chunked_ref
from repro_torch.models.params import P, dense_init, ones_init, zeros_init
from repro_torch.models.runtime import Runtime


def _dt(x: torch.Tensor, rt: Runtime) -> torch.Tensor:
    """Cast to the compute dtype; a no-op for a tree that was cast once
    (launch/serve.py does that), so no per-step copy of a weight is made."""
    return x.to(rt.dtype())


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


def _rope_tables_at(first: int, count: int, batch: int, dh: int, theta: float,
                    device: torch.device):
    """Tables for positions ``first .. first+count-1`` (``batch == 0``: shared
    by the batch, as in prefill) or for every sequence at ``first`` (decode).
    Every layer of a step asks for the same tables; eager PyTorch would
    otherwise recompute them, a dozen small launches each time.  Stand-ins
    on ``meta`` (the dry run's trace) are not cached, so that a trace does
    not depend on what was traced before it or beside it."""
    if device.type == "meta":
        return _rope_tables_uncached(first, count, batch, dh, theta, device)
    return _rope_tables_cached(first, count, batch, dh, theta, device)


def _rope_tables_uncached(first, count, batch, dh, theta, device):
    if batch:
        positions = torch.full((batch, 1), first, device=device)
    else:
        positions = torch.arange(first, first + count, device=device)
    return rope_tables(positions, dh, theta)


_rope_tables_cached = functools.lru_cache(maxsize=8)(_rope_tables_uncached)


class DevicePosition:
    """A decode position held on the device (a 0-d integer tensor) and the
    values every layer of one step derives from it, each made once a step
    and only on the device: no ``int()``, ``.item()`` or ``.cpu()``.

    The memo lives only as long as the step that made it.  Values made
    while a CUDA graph captures come from the graph's private pool, which
    every replay overwrites, so they must not outlive the capture; the
    host-keyed ``_rope_tables_cached`` never sees a tensor position."""

    def __init__(self, pos: torch.Tensor):
        if pos.dim() != 0 or pos.dtype.is_floating_point or pos.dtype == torch.bool:
            raise TypeError(f"a device position is a 0-d integer tensor, got "
                            f"{pos.dtype} of shape {tuple(pos.shape)}")
        self.t = pos
        self._memo = {}

    def _made(self, key, make):
        if key not in self._memo:
            self._memo[key] = make()
        return self._memo[key]

    def rope_tables(self, batch: int, dh: int, theta: float):
        """``_rope_tables_at(pos, 1, batch, ...)``'s tables, from the device."""
        return self._made(("rope", batch, dh, theta),
                          lambda: rope_tables(self.t.expand(batch, 1), dh, theta))

    def slot(self, length: int, ring: bool) -> torch.Tensor:
        """The cache slot as a (1,) int64 index: ``pos % length`` for a ring."""
        return self._made(("slot", length, ring), lambda: (
            torch.remainder(self.t, length) if ring else self.t).reshape(1).long())

    def lengths(self, batch: int, length: int) -> torch.Tensor:
        """``min(pos + 1, length)`` for every sequence, (batch,) int32."""
        return self._made(("lengths", batch, length), lambda: torch.clamp(
            self.t + 1, max=length).to(torch.int32).expand(batch).contiguous())


def device_position(pos):
    """``pos`` as a decode branch takes it: a host integer as ``int``; a 0-d
    tensor, or a ``DevicePosition`` already made for this step, as a
    ``DevicePosition``."""
    if isinstance(pos, DevicePosition):
        return pos
    if isinstance(pos, torch.Tensor):
        return DevicePosition(pos)
    return int(pos)


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


def _split_heads(out, h: int, k: int):
    """(..., h*k) -> (..., h, k).  On a mesh the flat dim is laid out as
    the heads are first (replicated where ``h`` does not divide), so that
    the split never cuts a head."""
    axes = ("batch",) + (None,) * (out.dim() - 2) + ("heads",)
    out = shard_hint(out, axes, (*out.shape[:-1], h))
    return out.reshape(*out.shape[:-1], h, k)


def _flat_heads(w, rt: Runtime):
    """(d, h, k) -> (d, h*k) in the compute dtype; on a mesh laid out as
    its heads (so that its gradient folds back into them too)."""
    d, h, k = w.shape
    return shard_hint(_dt(w, rt).reshape(d, h * k), (None, "heads"), (d, h))


def _out_project(out, w, rt: Runtime):
    """(B,S,h,k) x (h,k,d) -> (B,S,d): the heads' outputs and the output
    weight flattened, each laid out as its heads on a mesh."""
    h, k, d = w.shape
    B, S = out.shape[:2]
    flat = shard_hint(out.reshape(B, S, h * k), ("batch", None, "heads"), (B, S, h))
    w2 = shard_hint(_dt(w, rt).reshape(h * k, d), ("heads", None), (h, d))
    return torch.matmul(flat, w2)


def _project(x, w, b, rt: Runtime):
    """(B,S,D) x (D,h,k) -> (B,S,h,k), plus bias."""
    _, h, k = w.shape
    out = _split_heads(torch.matmul(x, _flat_heads(w, rt)), h, k)
    return out if b is None else out + _dt(b, rt)


def attention_apply(
    p,
    x: torch.Tensor,  # (B, S, D)
    *,
    cfg: ModelConfig,
    rt: Runtime,
    mode: str,
    cache: Optional[dict] = None,
    pos=None,  # decode position: host integer, 0-d tensor or DevicePosition
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
        out = _attention(
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
        pos = device_position(pos)
        ck, cv = cache["k"], cache["v"]
        L = ck.shape[1]
        on_device = isinstance(pos, DevicePosition)
        if use_rope:
            tables = (pos.rope_tables(B, q.shape[-1], cfg.rope_theta) if on_device else
                      _rope_tables_at(pos, 1, B, q.shape[-1], cfg.rope_theta, x.device))
            q = apply_rope(q, None, cfg.rope_theta, tables)
            k = apply_rope(k, None, cfg.rope_theta, tables)
        if on_device:  # the bound is the caller's (the compiled step checks it on the host)
            slot = pos.slot(L, bool(cfg.sliding_window))
        else:
            slot = pos % L if cfg.sliding_window else pos
            if not 0 <= slot < L:
                raise IndexError(f"decode position {pos} is outside the cache of {L} slots")
        _write_seq(ck, slot, k[:, :1])
        _write_seq(cv, slot, v[:, :1])
        lengths = (pos.lengths(B, L) if on_device else
                   torch.full((B,), min(pos + 1, L), dtype=torch.int32, device=x.device))
        # the cache is read in the type it is stored in: widening bf16 to
        # the compute dtype is exact and is left to the callee
        out = _decode_attention(
            q[:, 0], ck, cv, lengths,
            impl=rt.attn_impl, block_kv=rt.block_kv, db=rt.tuning_db,
        )[:, None]
        new_cache = {"k": ck, "v": cv}

    out = _out_project(out, p["wo"], rt)
    return out.to(x.dtype), new_cache


def _fill_kv_cache(cfg, cache, k, v):
    """Write prefill K/V into the cache buffer (in place) with ring alignment."""
    S = k.shape[1]
    ck, cv = cache["k"], cache["v"]
    L = ck.shape[1]
    if S >= L:
        # slot (S - L + i) % L holds position S - L + i: the tail, rolled
        k, v = k[:, S - L:], v[:, S - L:]
        if S % L:
            k, v = torch.roll(k, S % L, dims=1), torch.roll(v, S % L, dims=1)
    _write_seq(ck, 0, k)
    _write_seq(cv, 0, v)
    return {"k": ck, "v": cv}


def _attention(q, k, v, **kw):
    """``ops.attention``.  On a mesh the region runs on each device's shards
    (``local_map``): the batch as the rules lay it out, the query heads on
    the model axis where they divide it (and meet the KV groups at a
    shard's edge), and each shard with the KV heads its query heads read —
    the KV heads arrive whole and are sliced here, as GSPMD slices them."""
    if not isinstance(q, DTensor):
        return ops.attention(q, k, v, **kw)
    from torch.distributed.tensor import Replicate, Shard

    rules = _sharding._ACTIVE.rules
    dm = rules.device_mesh
    H, K = q.shape[2], k.shape[2]
    group = H // K
    q_pl = list(rules.placements_for(("batch", None, "heads", None), q.shape))
    heads = [i for i, p in enumerate(q_pl) if isinstance(p, Shard) and p.dim == 2]
    n = math.prod(dm.size(i) for i in heads)
    if heads and (H // n) % group and group % (H // n):
        for i in heads:  # a shard's heads would straddle a KV group: replicate them
            q_pl[i] = Replicate()
        heads, n = [], 1
    kv_pl = tuple(p if isinstance(p, Shard) and p.dim == 0 else Replicate() for p in q_pl)
    h_loc = H // n

    def local(ql, kl, vl):
        if heads:
            shard = dm.get_local_rank(dm.mesh_dim_names[heads[0]])
            lo, hi = shard * h_loc // group, ((shard + 1) * h_loc - 1) // group + 1
            kl, vl = kl[:, :, lo:hi], vl[:, :, lo:hi]
        return ops.attention(ql, kl, vl, **kw)

    q_pl = tuple(q_pl)
    return _sharding.local_region(local, (q_pl,), (q_pl, kv_pl, kv_pl), (q, k, v), dm)


def _decode_attention(q, k, v, lengths, **kw):
    """``ops.decode_attention``.  A cache placed by KV heads and whole along
    the sequence (``cache_shard="heads"``) is attended shard-local under
    ``local_map``: each device its own KV heads and their query heads.
    A cache sharded along the sequence takes DTensor's propagation."""
    if isinstance(k, DTensor):
        from torch.distributed.tensor import Replicate, Shard

        pl = tuple(k.placements)
        on = lambda d: [isinstance(p, Shard) and p.dim == d for p in pl]
        if any(on(2)) and not any(on(1)):
            q_pl = tuple(p if b else Shard(1) if h else Replicate()
                         for p, b, h in zip(pl, on(0), on(2)))
            len_pl = tuple(p if b else Replicate() for p, b in zip(pl, on(0)))
            return _sharding.local_region(
                lambda *a: ops.decode_attention(*a, **kw), (q_pl,),
                (q_pl, pl, pl, len_pl), (q, k, v, lengths), k.device_mesh)
    return ops.decode_attention(q, k, v, lengths, **kw)


def _write_seq(buf, start, value) -> None:
    """``buf[:, start:start + n] = value`` in place, ``n = value.shape[1]``
    (a cache write along its sequence dim).  ``start`` may be a (1,) int64
    index on ``buf``'s device (``DevicePosition.slot``, ``n == 1``): the
    write is then an ``index_copy_`` and the host reads nothing.  A
    ``buf`` placed on a mesh (a DTensor whose sequence dim may be sharded)
    is written shard by shard: ``value`` is laid out as ``buf`` is but
    whole along the sequence, and each device copies the part of the range
    that its shard holds."""
    n = value.shape[1]
    if isinstance(start, torch.Tensor):
        if isinstance(buf, DTensor):
            raise NotImplementedError("a device-held decode position on a mesh-placed cache")
        buf.index_copy_(1, start, value.to(buf.dtype))
        return
    if not isinstance(buf, DTensor):
        buf[:, start:start + n] = value.to(buf.dtype)
        return
    from torch.distributed.tensor import Replicate, Shard
    from torch.distributed.tensor._utils import compute_local_shape_and_global_offset

    mesh, pl = buf.device_mesh, tuple(buf.placements)
    whole = [Replicate() if isinstance(p, Shard) and p.dim == 1 else p for p in pl]
    if not isinstance(value, DTensor):
        value = DTensor.from_local(value, mesh, [Replicate()] * mesh.ndim, run_check=False)
    v = value.to(buf.dtype).redistribute(mesh, whole).to_local()
    local = buf.to_local()
    first = compute_local_shape_and_global_offset(buf.shape, mesh, pl)[1][1]
    lo, hi = max(start, first), min(start + n, first + local.shape[1])
    if lo < hi:
        local[:, lo - first:hi - first] = v[:, lo - start:hi - start]


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
    _, h, k = w.shape
    return _split_heads(torch.matmul(x, _flat_heads(w, rt)), h, k)


def mla_apply(
    p, x, *, cfg: ModelConfig, rt: Runtime, mode: str,
    cache: Optional[dict] = None, pos=None,
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
        out = _attention(
            qq, k, v, causal=True, scale=scale,
            impl=rt.attn_impl, block_q=rt.block_q, block_kv=rt.block_kv,
            unroll=rt.unroll_layers, prune=rt.attn_prune, db=rt.tuning_db,
        )
        new_cache = None
        if mode == "prefill":
            _write_seq(cache["ckv"], 0, ckv)
            _write_seq(cache["krope"], 0, k_rope_r[:, :, 0])
            new_cache = {"ckv": cache["ckv"], "krope": cache["krope"]}
    else:  # decode — absorbed latent-space attention (the point of MLA)
        pos = device_position(pos)
        ck, kr = cache["ckv"], cache["krope"]
        on_device = isinstance(pos, DevicePosition)
        if on_device:  # the bound is the caller's (the compiled step checks it on the host)
            tables = pos.rope_tables(B, dr, cfg.rope_theta)
            slot = pos.slot(ck.shape[1], False)
        else:
            if not 0 <= pos < ck.shape[1]:
                raise IndexError(f"decode position {pos} is outside the cache of "
                                 f"{ck.shape[1]} slots")
            tables = _rope_tables_at(pos, 1, B, dr, cfg.rope_theta, x.device)
            slot = pos
        q_rope = apply_rope(q_rope, None, cfg.rope_theta, tables)
        k_rope_r = apply_rope(k_rope[:, :, None, :], None, cfg.rope_theta, tables)[:, :, 0]
        _write_seq(ck, slot, ckv[:, :1])
        _write_seq(kr, slot, k_rope_r[:, :1])
        new_cache = {"ckv": ck, "krope": kr}
        wkv_b = _dt(p["wkv_b"], rt)
        w_k, w_v = wkv_b[..., :dn], wkv_b[..., dn:]
        # absorb the key expansion into the query: q_eff (B, H, r + dr)
        q_eff = torch.cat(
            [torch.einsum("bhk,rhk->bhr", q_nope[:, 0], w_k), q_rope[:, 0]], dim=-1)
        keys = torch.cat([_dt(ck, rt), _dt(kr, rt)], dim=-1)[:, :, None, :]
        vals = _dt(ck, rt)[:, :, None, :]
        # in range, min(pos + 1, slots) is pos + 1
        lengths = (pos.lengths(B, ck.shape[1]) if on_device else
                   torch.full((B,), pos + 1, dtype=torch.int32, device=x.device))
        o_lat = ops.decode_attention(q_eff, keys, vals, lengths, scale=scale,
                                     impl="ref")  # latent kv: the oracle
        out = torch.einsum("bhr,rhv->bhv", o_lat, w_v)[:, None]

    out = _out_project(out, p["wo"], rt)
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
    """Returns (out, aux_loss).

    rt.moe_impl:
      * ``"gspmd"`` (paper-faithful baseline): grouped capacity dispatch as
        a scatter into per-expert buffers and a gather back; on a mesh,
        DTensor's sharding propagation decides the collectives.
      * ``"ep_local"`` (beyond-paper): explicit expert parallelism under
        ``local_map`` — activations replicated across the model axis, each
        shard dispatches only to its local E/tp experts (no communication)
        and the combine is a single sum all-reduce of the (B, S, D) output
        in the compute dtype.  It needs active rules with a ``"model"``
        axis that divides the experts; otherwise ``"gspmd"`` runs, as in
        the reference.
    """
    if rt.moe_impl not in MOE_IMPLS:
        raise ValueError(f"unknown moe_impl {rt.moe_impl!r}; one of {MOE_IMPLS}")
    if rt.moe_impl == "ep_local" and _ep_rules_available(cfg):
        return _moe_apply_ep(p, x, cfg=cfg, rt=rt)
    return _moe_apply_gspmd(p, x, cfg=cfg, rt=rt)


def _ep_rules_available(cfg: ModelConfig) -> bool:
    rules = getattr(_sharding._ACTIVE, "rules", None)
    if rules is None or "model" not in rules.mesh.axis_names:
        return False
    return cfg.moe.num_experts % int(rules.mesh.shape["model"]) == 0


class _SumOverModel(torch.autograd.Function):
    """The expert-parallel combine: the sum of each model shard's partial
    output (the reference's ``psum``).  Its result is the same on every
    shard, so each shard's gradient is the result's gradient itself."""

    @staticmethod
    def forward(ctx, t, group):
        import torch.distributed._functional_collectives as funcol

        return funcol.wait_tensor(funcol.all_reduce(t, "sum", group))

    @staticmethod
    def backward(ctx, g):
        return g, None


def _moe_apply_ep(p, x, *, cfg: ModelConfig, rt: Runtime):
    """Expert-parallel MoE (see ``moe_apply``).  Tokens are grouped a
    sequence a group (G = local batch, T = S), as in the reference."""
    rules = _sharding._ACTIVE.rules
    mesh, dm = rules.mesh, rules.device_mesh
    tp = int(mesh.shape["model"])
    E, K = cfg.moe.num_experts, cfg.moe.top_k
    E_loc = E // tp
    B, S, D = x.shape
    rt_ep = dataclasses.replace(rt, moe_groups=0)

    def local_moe(xl, router, w_gate, w_up, w_down):
        # xl: (B_loc, S, D), replicated across "model"; w_*: (E_loc, ...)
        Bl = xl.shape[0]
        xg, top_p, top_i, aux, C, rank_of, keep = moe_route(
            {"router": router}, xl, cfg=cfg, rt=rt_ep)
        G = xg.shape[0]
        shard = dm.get_local_rank("model") if dm is not None else 0
        mine = keep & ((top_i // E_loc) == shard)  # the expert lives on this shard
        dump = E_loc * C
        dest = torch.where(mine, (top_i % E_loc) * C + rank_of, dump).reshape(G, S * K, 1)

        buf = torch.zeros((G, E_loc * C + 1, D), dtype=xg.dtype, device=xg.device)
        buf.scatter_add_(1, dest.expand(G, S * K, D), xg.repeat_interleave(K, dim=1))
        buf = buf[:, : E_loc * C].reshape(G, E_loc, C, D)

        g = F.silu(torch.einsum("gecd,edf->gecf", buf, _dt(w_gate, rt)))
        u = torch.einsum("gecd,edf->gecf", buf, _dt(w_up, rt))
        y = torch.einsum("gecf,efd->gecd", g * u, _dt(w_down, rt))

        y_flat = torch.cat([y.reshape(G, E_loc * C, D), y.new_zeros((G, 1, D))], dim=1)
        gathered = torch.gather(y_flat, 1, dest.expand(G, S * K, D)).reshape(G, S, K, D)
        out = torch.einsum("gtkd,gtk->gtd", gathered, (top_p * mine).to(y.dtype))
        if dm is not None:  # one sum all-reduce over "model", in the compute dtype
            out = _SumOverModel.apply(out, dm.get_group("model"))
        return out.reshape(Bl, S, D), aux

    args = (x, p["router"], p["w_gate"], p["w_up"], p["w_down"])
    if not rules.distributed:  # one device: nothing to place (a group's all-reduce stays)
        out, aux = local_moe(*args)
        return out.to(x.dtype), aux

    from torch.distributed.tensor import Replicate

    batch_axes = ("pod", "data") if "pod" in mesh.axis_names else ("data",)
    x_pl = _sharding.placements(
        (batch_axes if B % rules._axis_size(batch_axes) == 0 else None,), mesh)
    rep = tuple(Replicate() for _ in mesh.axis_names)
    experts = _sharding.placements(("model",), mesh)
    out, aux = _sharding.local_region(local_moe, (x_pl, rep),
                                      (x_pl, rep, experts, experts, experts), args, dm)
    if not isinstance(x, DTensor):  # plain tensors in (the same on every rank): plain out
        out, aux = out.full_tensor(), aux.to_local()
    return out.to(x.dtype), aux


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
    buf = _sharding.placed_zeros((G, E * C + 1, D), ("batch", None, None),
                                 dtype=xc.dtype, device=x.device)
    buf.scatter_add_(1, dest.expand(G, T * K, D), xc.repeat_interleave(K, dim=1))
    buf = buf[:, : E * C].reshape(G, E, C, D)
    buf = shard_hint(buf, ("batch", "experts", None, None))

    # expert FFN (SwiGLU)
    g = F.silu(torch.einsum("gecd,edf->gecf", buf, _dt(p["w_gate"], rt)))
    u = torch.einsum("gecd,edf->gecf", buf, _dt(p["w_up"], rt))
    h = shard_hint(g * u, ("batch", "experts", None, "ff"))
    y = torch.einsum("gecf,efd->gecd", h, _dt(p["w_down"], rt))
    y = shard_hint(y, ("batch", "experts", None, None))

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
    cache: Optional[dict] = None, pos=None,
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
    lora = torch.tanh(xc @ _dt(p["mix_w1"], rt))
    lora = shard_hint(lora, ("batch", None, None)).reshape(B, S, 5, rc.mix_lora)
    lora = torch.einsum("bsfm,fmd->fbsd", lora, _dt(p["mix_w2"], rt))
    xw, xk, xv, xr, xg = [mix_base[i] + dx * lora[i] for i in range(5)]

    r = _split_heads(xr @ _dt(p["wr"], rt), H, hs)
    k = _split_heads(xk @ _dt(p["wk"], rt), H, hs)
    v = _split_heads(xv @ _dt(p["wv"], rt), H, hs)
    g = F.silu(xg @ _dt(p["wg"], rt))

    w_raw = (torch.tanh(xw @ _dt(p["w_lora1"], rt)) @ _dt(p["w_lora2"], rt)
             + _dt(p["w_bias"], rt))
    w = _split_heads(torch.exp(-torch.exp(w_raw.float())), H, hs)
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
