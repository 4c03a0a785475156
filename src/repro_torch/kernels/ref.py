"""Pure-PyTorch oracles for the hand-written kernels.

These are the semantic ground truth: each kernel in this package is held
against the function here across shape/dtype sweeps on the card, and these
in turn are held against the reference package's oracles on the CPU.  They
are also the ``impl="ref"`` path of the model zoo.

Oracles for the scan kernels (Mamba selective scan, RWKV-6 wkv) arrive with
the slice that ports those kernels.
"""
from __future__ import annotations

from typing import Optional

import torch

NEG_INF = float("-inf")


# ---------------------------------------------------------------------------
# Attention
# ---------------------------------------------------------------------------


def _expand_kv(k: torch.Tensor, num_heads: int) -> torch.Tensor:
    """(B, S, K, dh) -> (B, S, H, dh) by repeating each kv head H//K times."""
    n_kv = k.shape[2]
    if n_kv == num_heads:
        return k
    assert num_heads % n_kv == 0, (num_heads, n_kv)
    return torch.repeat_interleave(k, num_heads // n_kv, dim=2)


def _position_mask(q_pos, k_pos, *, causal: bool, window: Optional[int],
                   offset: int) -> torch.Tensor:
    """(Sq, Sk) bool mask from (Sq, 1) / (1, Sk) integer positions."""
    if causal:
        # standard convention: query i attends kv j iff j <= i + (Sk - Sq)
        mask = k_pos <= (q_pos + offset)
        if window is not None:
            mask = mask & (k_pos > (q_pos + offset - window))
    else:
        mask = torch.ones((q_pos.shape[0], k_pos.shape[1]), dtype=torch.bool,
                          device=q_pos.device)
        if window is not None:
            mask = mask & ((k_pos - q_pos).abs() < window)
    return mask


def _masked_softmax_pv(s, mask, v, out_dtype):
    """Safe softmax of fp32 scores (B,H,Sq,Sk) under ``mask`` then PV:
    fully masked rows give exact zeros, not NaNs; ``p`` is cast to
    ``v.dtype`` before the product."""
    s = torch.where(mask, s, NEG_INF)
    m = s.amax(dim=-1, keepdim=True)
    m = torch.where(torch.isfinite(m), m, 0.0)
    p = torch.exp(s - m)
    p = torch.where(mask, p, 0.0)
    denom = p.sum(dim=-1, keepdim=True)
    p = p / denom.clamp_min(1e-30)
    out = torch.einsum("bhqk,bkhd->bqhd", p.to(v.dtype), v)
    return out.to(out_dtype)


def attention_ref(
    q: torch.Tensor,  # (B, Sq, H, dh)
    k: torch.Tensor,  # (B, Sk, K, dh)
    v: torch.Tensor,  # (B, Sk, K, dv)
    *,
    causal: bool = True,
    window: Optional[int] = None,
    scale: Optional[float] = None,
    kv_length: Optional[torch.Tensor] = None,  # (B,) valid kv positions
) -> torch.Tensor:
    """Softmax attention with GQA, optional causal/sliding-window masking.

    Softmax statistics in fp32 regardless of input dtype.
    """
    B, Sq, H, dh = q.shape
    Sk = k.shape[1]
    k = _expand_kv(k, H)
    v = _expand_kv(v, H)
    scale = scale if scale is not None else dh ** -0.5

    # fp32 accumulation of the scores whatever the input type
    s = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) * scale

    q_pos = torch.arange(Sq, device=q.device)[:, None]
    k_pos = torch.arange(Sk, device=q.device)[None, :]
    mask = _position_mask(q_pos, k_pos, causal=causal, window=window,
                          offset=Sk - Sq)[None, None]
    if kv_length is not None:
        mask = mask & (k_pos[None, None] < kv_length[:, None, None, None])
    return _masked_softmax_pv(s, mask, v, q.dtype)


def attention_chunked_ref(
    q: torch.Tensor,  # (B, Sq, H, dh)
    k: torch.Tensor,  # (B, Sk, K, dh)
    v: torch.Tensor,  # (B, Sk, K, dv)
    *,
    causal: bool = True,
    window: Optional[int] = None,
    scale: Optional[float] = None,
    block_q: int = 512,
    unroll: bool = False,
    prune: bool = False,
) -> torch.Tensor:
    """Memory-efficient attention (Rabe–Staats style): loop over query
    blocks, materializing only (B, H, block_q, Sk) scores.

    ``prune=True`` (with ``unroll=True``, as in the reference): slice each
    query block's K/V to the causally-/window-reachable range, the
    oracle-level analogue of the kernel's tile bounds.  Eager PyTorch has no
    scan, so ``unroll`` only gates ``prune``: both settings run the same
    python loop."""
    B, Sq, H, dh = q.shape
    Sk = k.shape[1]
    k = _expand_kv(k, H)
    v = _expand_kv(v, H)
    scale = scale if scale is not None else dh ** -0.5
    block_q = min(block_q, Sq)
    k_pos = torch.arange(Sk, device=q.device)[None, :]
    offset = Sk - Sq

    outs = []
    for q0 in range(0, Sq, block_q):
        q1 = min(q0 + block_q, Sq)
        lo, hi = 0, Sk
        if unroll and prune and causal:
            hi = min(Sk, q0 + block_q + offset)
            if window is not None:
                lo = max(0, q0 + offset - window + 1)
            hi = max(hi, lo + 1)
        q_pos = torch.arange(q0, q1, device=q.device)[:, None]
        mask = _position_mask(q_pos, k_pos[:, lo:hi], causal=causal,
                              window=window, offset=offset)[None, None]
        s = torch.einsum("bqhd,bkhd->bhqk", q[:, q0:q1].float(),
                         k[:, lo:hi].float()) * scale
        outs.append(_masked_softmax_pv(s, mask, v[:, lo:hi], q.dtype))
    return torch.cat(outs, dim=1)


def decode_attention_ref(
    q: torch.Tensor,  # (B, H, dh)  — one new token per sequence
    k: torch.Tensor,  # (B, Smax, K, dh) ring/linear KV cache
    v: torch.Tensor,  # (B, Smax, K, dh)
    lengths: torch.Tensor,  # (B,) number of valid cache positions
    *,
    scale: Optional[float] = None,
) -> torch.Tensor:
    """The cache may be stored narrower than the query (bf16 cache, f32
    query): it is widened to ``q.dtype`` first, which is exact."""
    out = attention_ref(
        q[:, None], k.to(q.dtype), v.to(q.dtype), causal=False, scale=scale,
        kv_length=lengths,
    )
    return out[:, 0]


# ---------------------------------------------------------------------------
# RMSNorm
# ---------------------------------------------------------------------------


def _row_dot(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """sum(a*b, -1) accumulated in fp32."""
    return (a.float() * b.float()).sum(dim=-1)


class _RMSNormRef(torch.autograd.Function):
    """fp32 only in the reductions: ``inv`` and ``scale`` are rounded to
    ``x.dtype`` and the products run in that type, forward and backward."""

    @staticmethod
    def forward(ctx, x, scale, eps):
        var = _row_dot(x, x) / x.shape[-1]
        inv = torch.rsqrt(var + eps)
        ctx.save_for_backward(x, scale, inv)
        return x * inv.to(x.dtype)[..., None] * scale.to(x.dtype)

    @staticmethod
    def backward(ctx, gy):
        x, scale, inv = ctx.saved_tensors
        D = x.shape[-1]
        gxs = gy * scale.to(gy.dtype)  # dL/dxhat, in compute dtype
        rowdot = _row_dot(gxs, x)
        coef = (inv ** 3 * rowdot / D).to(x.dtype)
        dx = inv.to(x.dtype)[..., None] * gxs - coef[..., None] * x
        xhat_g = (gy * inv.to(gy.dtype)[..., None]).float() * x.float()
        dscale = xhat_g.reshape(-1, D).sum(dim=0).to(scale.dtype)
        return dx, dscale, None


def rmsnorm_ref(x: torch.Tensor, scale: torch.Tensor,
                eps: float = 1e-5) -> torch.Tensor:
    return _RMSNormRef.apply(x, scale, eps)
