"""Pure-PyTorch oracles for the hand-written kernels.

These are the semantic ground truth: each kernel in this package is held
against the function here across shape/dtype sweeps on the card, and these
in turn are held against the reference package's oracles on the CPU.  They
are also the ``impl="ref"`` path of the model zoo.
"""
from __future__ import annotations

from typing import Optional, Tuple

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
    query): it is widened to ``q.dtype`` first, which is exact.

    ``attention_ref`` of the one query token, with the query heads grouped
    by KV head instead of the cache repeated to every query head: the same
    products and sums, without an H/K-fold copy of the cache (at a 32k
    cache of batch 128 that copy would be 7.5 GB a layer in bf16)."""
    B, H, dh = q.shape
    _, Smax, K, dv = v.shape
    G = H // K
    scale = scale if scale is not None else dh ** -0.5
    k, v = k.to(q.dtype), v.to(q.dtype)
    s = torch.einsum("bkgd,bskd->bkgs", q.float().reshape(B, K, G, dh),
                     k.float()) * scale
    mask = (torch.arange(Smax, device=q.device)[None, :]
            < lengths.to(q.device)[:, None])[:, None, None, :]
    s = torch.where(mask, s, NEG_INF)
    m = s.amax(dim=-1, keepdim=True)
    m = torch.where(torch.isfinite(m), m, 0.0)
    p = torch.where(mask, torch.exp(s - m), 0.0)
    p = p / p.sum(dim=-1, keepdim=True).clamp_min(1e-30)
    out = torch.einsum("bkgs,bskd->bkgd", p.to(v.dtype), v)
    return out.reshape(B, H, dv).to(q.dtype)


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


# ---------------------------------------------------------------------------
# Mamba-1 selective scan
# ---------------------------------------------------------------------------


def ssm_scan_ref(
    x: torch.Tensor,  # (B, S, D)   pre-activation ssm input
    dt: torch.Tensor,  # (B, S, D)  softplus'd timestep
    A: torch.Tensor,  # (D, N)      negative (continuous-time) state matrix
    B_in: torch.Tensor,  # (B, S, N)
    C_in: torch.Tensor,  # (B, S, N)
    D_skip: torch.Tensor,  # (D,)
    h0: Optional[torch.Tensor] = None,  # (B, D, N)
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Naive sequential selective scan.  Returns (y (B,S,D), h_final (B,D,N)).

    h_t = exp(dt_t * A) * h_{t-1} + (dt_t * x_t) outer B_t
    y_t = (h_t @ C_t) + D * x_t
    """
    Bb, S, D = x.shape
    N = A.shape[1]
    xf, dtf = x.float(), dt.float()
    Bf, Cf, Af = B_in.float(), C_in.float(), A.float()
    h = (torch.zeros((Bb, D, N), device=x.device) if h0 is None else h0.float())
    ys = []
    for t in range(S):
        dA = torch.exp(dtf[:, t, :, None] * Af[None])  # (B, D, N)
        dBx = (dtf[:, t] * xf[:, t])[..., None] * Bf[:, t, None, :]
        h = dA * h + dBx
        ys.append(torch.einsum("bdn,bn->bd", h, Cf[:, t]))
    y = torch.stack(ys, dim=1) + xf * D_skip.float()[None, None]
    return y.to(x.dtype), h


def _ssm_associative_scan(loga: torch.Tensor, b: torch.Tensor):
    """Inclusive scan over dim 1 of ``h_t = exp(loga_t) h_{t-1} + b_t``
    pairs, combining an earlier segment ``(a1, b1)`` with a later one
    ``(a2, b2)`` into ``(a1 + a2, exp(min(a2, 0)) b1 + b2)`` — the
    reference's combine, in log(T) doubling steps (Hillis–Steele)."""
    T, off = loga.shape[1], 1
    while off < T:
        a_cur, b_cur = loga[:, off:], b[:, off:]
        b = torch.cat([b[:, :off],
                       torch.exp(torch.clamp(a_cur, max=0.0)) * b[:, :-off] + b_cur], 1)
        loga = torch.cat([loga[:, :off], loga[:, :-off] + a_cur], 1)
        off *= 2
    return loga, b


def ssm_scan_chunked_ref(
    x, dt, A, B_in, C_in, D_skip, h0=None, *, chunk: int = 128
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Chunked (work-efficient) selective scan: associative scan within a
    chunk, sequential carry across chunks.  Same semantics as ssm_scan_ref
    but with materialization bounded by the chunk size."""
    Bb, S, D = x.shape
    N = A.shape[1]
    chunk = min(chunk, S)
    pad = (-S) % chunk
    if pad:  # dt = 0 on the padded steps leaves the state unchanged
        x, dt, B_in, C_in = (torch.nn.functional.pad(a, (0, 0, 0, pad))
                             for a in (x, dt, B_in, C_in))
    Sp = x.shape[1]
    nc = Sp // chunk
    xf = x.float().reshape(Bb, nc, chunk, D)
    dtf = dt.float().reshape(Bb, nc, chunk, D)
    Bf = B_in.float().reshape(Bb, nc, chunk, N)
    Cf = C_in.float().reshape(Bb, nc, chunk, N)
    Af = A.float()
    h = (torch.zeros((Bb, D, N), device=x.device) if h0 is None else h0.float())
    ys = []
    for c in range(nc):
        xc, dtc, Bc, Cc = xf[:, c], dtf[:, c], Bf[:, c], Cf[:, c]
        dA = dtc[..., None] * Af[None, None]  # (B,T,D,N) log decay
        dBx = (dtc * xc)[..., None] * Bc[:, :, None, :]  # (B,T,D,N)
        loga, b = _ssm_associative_scan(dA, dBx)
        hs = torch.exp(loga) * h[:, None] + b  # carry-in state + chunk inputs
        ys.append(torch.einsum("btdn,btn->btd", hs, Cc))
        h = hs[:, -1]
    y = torch.stack(ys, dim=1).reshape(Bb, Sp, D)[:, :S]
    y = y + x.float()[:, :S] * D_skip.float()[None, None]
    return y.to(x.dtype), h


# ---------------------------------------------------------------------------
# RWKV-6 gated-linear-attention (wkv) scan
# ---------------------------------------------------------------------------


def gla_scan_ref(
    r: torch.Tensor,  # (B, S, H, dk) receptance
    k: torch.Tensor,  # (B, S, H, dk)
    v: torch.Tensor,  # (B, S, H, dv)
    w: torch.Tensor,  # (B, S, H, dk) per-channel decay in (0, 1)
    u: torch.Tensor,  # (H, dk)       current-token bonus
    h0: Optional[torch.Tensor] = None,  # (B, H, dk, dv)
) -> Tuple[torch.Tensor, torch.Tensor]:
    """RWKV-6 recurrence (fla convention):

    y_t = r_t @ (S_{t-1} + (u * k_t) ⊗ v_t)
    S_t = diag(w_t) S_{t-1} + k_t ⊗ v_t
    """
    B, S, H, dk = r.shape
    dv = v.shape[-1]
    rf, kf, vf, wf = (a.float() for a in (r, k, v, w))
    uf = u.float()
    St = (torch.zeros((B, H, dk, dv), device=r.device) if h0 is None else h0.float())
    ys = []
    for t in range(S):
        rt, kt, vt, wt = rf[:, t], kf[:, t], vf[:, t], wf[:, t]
        bonus = torch.einsum("bhk,hk,bhk->bh", rt, uf, kt)
        ys.append(torch.einsum("bhk,bhkv->bhv", rt, St) + bonus[..., None] * vt)
        St = wt[..., None] * St + kt[..., None] * vt[:, :, None, :]
    y = torch.stack(ys, dim=1)  # (B, S, H, dv)
    return y.to(r.dtype), St


def gla_scan_chunked_ref(
    r, k, v, w, u, h0=None, *, chunk: int = 64
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Chunked-quadratic GLA: O(S/C * C^2) intra-chunk attention with decay
    products + O(S/C) cross-chunk state carry.  Matmul-friendly form used by
    the model for training/prefill."""
    B, S, H, dk = r.shape
    dv = v.shape[-1]
    chunk = min(chunk, S)
    pad = (-S) % chunk
    if pad:
        zpad = lambda a: torch.nn.functional.pad(a, (0, 0, 0, 0, 0, pad))
        r, k, v = zpad(r), zpad(k), zpad(v)
        w = torch.nn.functional.pad(w, (0, 0, 0, 0, 0, pad), value=1.0)
    Sp = r.shape[1]
    nc = Sp // chunk
    shp = lambda a, d: a.float().reshape(B, nc, chunk, H, d)
    rf, kf, wf = shp(r, dk), shp(k, dk), shp(w, dk)
    vf = shp(v, dv)
    uf = u.float()
    St = (torch.zeros((B, H, dk, dv), device=r.device) if h0 is None else h0.float())

    logw = torch.log(torch.clamp(wf, min=1e-30))  # (B,nc,T,H,dk)
    cum = torch.cumsum(logw, dim=2)  # inclusive cumulative log-decay
    tri = torch.tril(torch.ones((chunk, chunk), dtype=torch.bool, device=r.device),
                     diagonal=-1)  # (t, s): s < t
    ys = []
    for c in range(nc):
        rc, kc, vc, cumc, logwc = rf[:, c], kf[:, c], vf[:, c], cum[:, c], logw[:, c]
        total = cumc[:, -1]  # (B,H,dk) chunk total log decay
        excl = cumc - logwc  # exclusive cumulative log-decay c_{t-1}
        r_dec = rc * torch.exp(excl)  # r_t * prod_{j<t} w_j
        k_dec = kc * torch.exp(total[:, None] - cumc)  # k decayed to chunk end
        # intra-chunk attention in masked diff-then-exp form: the exponents
        # of kept (s < t) entries are <= 0, so strong decays never overflow
        diff = excl[:, :, None] - cumc[:, None]  # (B,T,S,H,dk)
        diff = torch.where(tri[None, :, :, None, None], diff, NEG_INF)
        att = torch.einsum("bthk,bshk,btshk->bhts", rc, kc, torch.exp(diff))
        bonus = torch.einsum("bthk,hk,bthk->bht", rc, uf, kc)
        y = torch.einsum("bhts,bshv->bthv", att, vc)
        y = y + bonus.permute(0, 2, 1)[..., None] * vc
        y = y + torch.einsum("bthk,bhkv->bthv", r_dec, St)  # cross-chunk
        St = torch.exp(total)[..., None] * St + torch.einsum("bthk,bthv->bhkv", k_dec, vc)
        ys.append(y)
    y = torch.stack(ys, dim=1).reshape(B, Sp, H, dv)[:, :S]
    return y.to(r.dtype), St
