"""Decode attention — CUDA C++ kernels for Hopper (csrc/decode_attention.cu).

Replaces the TPU kernel ``_decode_kernel`` / ``decode_attention`` of the
reference package (src/repro/kernels/decode_attention.py).  The source file
says what bounds the kernel on this card and what its two paths do about
it; this module is the wrapper: it checks the tensors, picks the path
(``route``, from the inputs' types and shapes alone), lowers ``block_kv`` to
what that path can run, plans the work, launches on PyTorch's current
stream and counts the launch.  ``decode_attention_plain`` is the same
function in plain PyTorch: the CPU path, and what both kernels are held
against on the card.

* ``"fma"`` (``decode_kernel``): an fp32 query over an fp32 or bf16 cache,
  and bf16 at head widths or groups the tensor cores do not take.
  ``block_kv`` is the cache rows a block keeps in flight, 8 threads each.
  The cache axis is split over blocks (flash-decoding) in one launch:
  ``split_count(B, K, Smax, block_kv, sms)`` asks for two blocks per SM at
  most, ``floor(2 * sms / (B * K))``, so that they run in one wave, and no
  more splits than trips of ``block_kv`` rows in ``Smax``; each split takes
  ``ceil(lengths[b] / n_splits)`` rows of its sequence.
* ``"mma"`` (``decode_kernel_mma``): a bf16 query over a bf16 cache, ``dh``
  a multiple of 16 up to 128 and ``H / K`` up to 16.  ``block_kv`` is the
  rows a ring stage holds; every warp streams its stages through its own
  ring, the group on the tensor cores.  The cache axis is split as the
  ``"fma"`` kernel splits it (``split_rows``), ``mma_split_count`` splits a
  call from shapes alone; a block takes one split of ``mma_heads(K)`` heads.
  ``decode_attention_bf16_plain`` repeats its arithmetic (the splits, the
  warps' stages, P as bf16 hi + lo) in plain PyTorch.

Both read shapes only, never ``lengths`` (which stays on the device).  The
cache splits of the last call are kept in ``decode_attention.last_splits``;
every launch of either kernel counts in ``decode_attention.launches``, those
of the second also in ``decode_attention_bf16.launches``.

The cache may be stored narrower than the query (a bf16 cache under an
fp32 query): the kernel widens it in registers, which is exact.
"""
from __future__ import annotations

import ctypes
import math
from typing import Optional

import torch

from repro_torch.kernels import _build
from repro_torch.kernels._tiles import clamp_tile, last_dim_contiguous, pad_head_dim, sm_count

NEG_INF = float("-inf")

_TPR = 8  # threads per cache row in the kernel
MIN_BLOCK_KV = 32 // _TPR  # one warp
MAX_BLOCK_KV = 512 // _TPR  # the kernel is compiled for 512 threads at most
MAX_SMEM_BYTES = 232448

# the tensor-core kernel
MMA_WARPS = 4       # warps a block, each streaming on its own
MMA_STAGES = 4      # ring stages a warp
MMA_BLOCK_KV = (16, 64)  # rows a stage: powers of two in this range
MMA_MAX_GROUP = 16  # query heads a KV head: the 16 rows of an m16n8k16 tile
MMA_MIN_BLOCKS = 2  # the kernel's __launch_bounds__: registers for 2 blocks an SM
SMEM_PER_SM = 233472
SMEM_PER_BLOCK_RESERVED = 1024
PARTIAL_SHARE = 0.02  # the partials' bytes at most this share of the cache's

_DTYPE_CODE = {
    (torch.float32, torch.float32): 0,
    (torch.bfloat16, torch.bfloat16): 1,
    (torch.float32, torch.bfloat16): 2,
}
_ARGTYPES = ([ctypes.c_void_p] * 7 + [ctypes.c_int] * 6
             + [ctypes.c_longlong] * 10 + [ctypes.c_float, ctypes.c_int, ctypes.c_int,
                                           ctypes.c_void_p])
_MMA_ARGTYPES = ([ctypes.c_void_p] * 7 + [ctypes.c_int] * 5 + [ctypes.c_longlong] * 10
                 + [ctypes.c_float, ctypes.c_int, ctypes.c_int, ctypes.c_void_p])
_FN = None
_MMA_FN = None
_COUNTERS: dict = {}  # device index -> zeroed int32 buffer of the split merge


def route(dtype=None, dh: int = 64, group: int = 1) -> str:
    """The kernel that takes a call with a query of ``dtype`` (``None``:
    float32; a bf16 query comes with a bf16 cache): ``"mma"`` for bf16 at
    ``dh`` a multiple of 16 up to 128 and ``group`` (``H / K``) up to 16,
    else ``"fma"``."""
    if dtype == torch.bfloat16 and dh % 16 == 0 and 16 <= dh <= 128 and group <= MMA_MAX_GROUP:
        return "mma"
    return "fma"


def _group_chunk(group: int) -> int:
    return 1 if group == 1 else (4 if group <= 4 else 8)


def smem_bytes(block_kv: int, dh: int, group: int) -> int:
    """Dynamic shared memory of one block of ``decode_kernel``: the group's
    queries and accumulators, one trip's V rows and scores, and (m, l,
    rescale) per head."""
    dhp, gc = pad_head_dim(dh, "decode attention"), _group_chunk(group)
    return (2 * gc * dhp + block_kv * dhp + gc * block_kv + 3 * gc) * 4


def mma_smem_bytes(block_kv: int, dh: int) -> int:
    """Dynamic shared memory of one block of ``decode_kernel_mma``: every
    warp's ring of K and V stages (bf16 rows with 16 bytes of padding) and
    its (acc, m, l) of 16 heads, where a head's warps combine."""
    dhp = pad_head_dim(dh, "decode attention")
    return MMA_WARPS * (MMA_STAGES * 2 * block_kv * (dhp + 8) * 2 + MMA_MAX_GROUP * (dhp + 2) * 4)


def mma_heads(K: int) -> int:
    """KV heads one block of ``decode_kernel_mma`` takes: gcd(K, 4), each
    with ``MMA_WARPS / mma_heads(K)`` warps."""
    return math.gcd(K, MMA_WARPS)


def mma_resident(block_kv: int, dh: int) -> int:
    """Blocks of ``decode_kernel_mma`` one SM holds at once: by shared
    memory, and at most the 2 its launch bounds keep registers for."""
    smem = mma_smem_bytes(block_kv, dh)
    return max(0, min(SMEM_PER_SM // (smem + SMEM_PER_BLOCK_RESERVED), MMA_MIN_BLOCKS))


def feasible(config: dict, shapes: dict, dtype=None) -> bool:
    """Whether ``config`` (``block_kv``) can launch at ``shapes`` (``dh``,
    ``H``, ``K``) for a query of ``dtype`` (``None``: float32): the routed
    kernel's compiled stages (``"mma"``), thread and shared-memory limits of
    one block."""
    bkv = int(config["block_kv"])
    dh, group = int(shapes["dh"]), int(shapes["H"]) // int(shapes["K"])
    if route(dtype, dh, group) == "mma":
        lo, hi = MMA_BLOCK_KV
        return (lo <= bkv <= hi and not bkv & (bkv - 1)
                and mma_smem_bytes(bkv, dh) <= MAX_SMEM_BYTES)
    return (MIN_BLOCK_KV <= bkv <= MAX_BLOCK_KV
            and smem_bytes(bkv, dh, group) <= MAX_SMEM_BYTES)


def effective_config(block_kv: int, H: int, K: int, dh: int, dtype=None) -> dict:
    """The ``block_kv`` a request runs with: a power of two, not above the
    request, feasible for the kernel the call routes to (a request below
    that kernel's smallest is raised to it, so a record made for the other
    kernel is clamped, never refused)."""
    shapes = {"H": H, "K": K, "dh": dh}
    floor = MMA_BLOCK_KV[0] if route(dtype, dh, H // K) == "mma" else MIN_BLOCK_KV
    return {"block_kv": clamp_tile(
        "block_kv", block_kv, lambda t: feasible({"block_kv": t}, shapes, dtype),
        floor=floor)}


def split_count(B: int, K: int, Smax: int, block_kv: int, sms: int) -> int:
    """Cache splits of one ``decode_kernel`` call: about two blocks per SM,
    and no more, so that the splits run in one wave (the kernel fits two
    blocks an SM): ``floor(2 * sms / (B * K))``; but at least one trip of
    ``block_kv`` rows a split (at most ``ceil(Smax / block_kv)``), and at
    least 1."""
    want = 2 * sms // max(B * K, 1)
    cap = -(-max(Smax, 1) // block_kv)
    return max(1, min(want, cap))


def split_rows(lengths: torch.Tensor, n_splits: int) -> torch.Tensor:
    """Rows of each split, per sequence: ``ceil(lengths / n_splits)``; split
    ``s`` takes ``[s * r, min((s + 1) * r, length))``."""
    return (lengths + n_splits - 1) // n_splits


def mma_split_count(B: int, K: int, Smax: int, group: int, dh: int, block_kv: int,
                    sms: int) -> int:
    """Cache splits of one ``decode_kernel_mma`` call (a block a split of
    ``mma_heads(K)`` heads): as many as fill one wave at the kernel's
    residency, ``floor(sms * mma_resident / (B * K / mma_heads(K)))``; but at
    least a stage a warp a split (at most ``ceil(Smax / (warps * block_kv))``,
    ``warps`` the ``MMA_WARPS / mma_heads(K)`` warps of a head), partials
    (``group * (dh + 2)`` floats a split of each sequence and KV head) at most
    ``PARTIAL_SHARE`` of the cache's bytes, and at least 1.  Split ``s`` takes
    the rows of ``split_rows``."""
    heads = mma_heads(K)
    blocks = B * (K // heads)
    want = sms * max(1, mma_resident(block_kv, dh)) // max(blocks, 1)
    cap = -(-max(Smax, 1) // (MMA_WARPS // heads * block_kv))
    # partials B*K*n*group*(dh+2)*4 bytes against the cache's 2*B*Smax*K*dh*2
    share = int(PARTIAL_SHARE * Smax * dh // (group * (dh + 2)))
    return max(1, min(want, cap, share))


def decode_attention_plain(
    q: torch.Tensor,  # (B, H, dh)
    k: torch.Tensor,  # (B, Smax, K, dh)
    v: torch.Tensor,  # (B, Smax, K, dh)
    lengths: torch.Tensor,  # (B,)
    *,
    scale: Optional[float] = None,
    n_splits: int = 1,
) -> torch.Tensor:
    """One query token against the cache in plain PyTorch, fp32 throughout,
    GQA by index; rows at or past ``lengths[b]`` are masked and an empty
    cache gives exact zeros.  With ``n_splits > 1`` the rows are cut as the
    kernel cuts them (``split_rows``), each split gives its own ``(m, l,
    acc)`` and the splits are merged with the kernel's rescaling; one split
    is the unsplit arithmetic (its merge multiplies by 1)."""
    B, H, dh = q.shape
    _, Smax, K, _ = k.shape
    G = H // K
    scale = scale if scale is not None else dh ** -0.5
    qf = q.float().reshape(B, K, G, dh)
    s = torch.einsum("bkgd,bskd->bkgs", qf, k.float()) * scale
    lengths = lengths.to(q.device).clamp(0, Smax)
    pos = torch.arange(Smax, device=q.device)[None, :]
    # split of each row (rows past the length fall in no split)
    which = pos // split_rows(lengths, n_splits).clamp(min=1)[:, None]
    valid = pos < lengths[:, None]
    parts = []
    for sp in range(n_splits):
        mask = (valid & (which == sp))[:, None, None, :]
        ss = torch.where(mask, s, NEG_INF)
        m = ss.amax(dim=-1, keepdim=True)
        m_safe = torch.where(m == NEG_INF, 0.0, m)
        p = torch.where(mask, torch.exp(ss - m_safe), 0.0)
        parts.append((m, p.sum(dim=-1, keepdim=True),
                      torch.einsum("bkgs,bskd->bkgd", p, v.float())))
    # the merge: every split rescaled to the largest maximum
    mx = torch.stack([m for m, _, _ in parts]).amax(dim=0)
    l_all = acc_all = 0.0
    for m, l, acc in parts:
        a = torch.where(m == NEG_INF, 0.0, torch.exp(m - mx))
        l_all = l_all + l * a
        acc_all = acc_all + acc * a
    alive = l_all > 0
    out = torch.where(alive, acc_all / torch.where(alive, l_all, 1.0), 0.0)
    return out.reshape(B, H, v.shape[-1]).to(q.dtype)


def _hi_lo(p: torch.Tensor):
    """``p`` as the kernel feeds it to the tensor cores: ``hi = bf16(p)``,
    ``lo = bf16(p - hi)``, both widened back."""
    hi = p.to(torch.bfloat16).float()
    return hi, (p - hi).to(torch.bfloat16).float()


def decode_attention_bf16_plain(
    q: torch.Tensor,  # (B, H, dh)
    k: torch.Tensor,  # (B, Smax, K, dh)
    v: torch.Tensor,  # (B, Smax, K, dh)
    lengths: torch.Tensor,  # (B,)
    *,
    scale: Optional[float] = None,
    block_kv: int = 512,
    sms: int = 132,
) -> torch.Tensor:
    """``decode_kernel_mma``'s arithmetic in plain PyTorch (fp32, the inputs
    as they are, on their device): the splits of ``mma_split_count`` at
    ``sms`` SMs, each split's rows dealt in stages of ``block_kv`` rows to the
    head's warps in turn, each warp's stages in base-2 online softmax with
    ``P V`` as ``hi V + lo V`` (``_hi_lo``), the warps combined, then the
    splits in their order.  The output has the query's type (a float32 query
    gives the f32 result before the kernel's rounding to bf16)."""
    B, H, dh = q.shape
    _, Smax, K, _ = k.shape
    G = H // K
    dev = q.device
    scale = scale if scale is not None else dh ** -0.5
    qscale = torch.tensor(scale, dtype=torch.float32) * torch.tensor(math.log2(math.e),
                                                                     dtype=torch.float32)
    bkv = effective_config(block_kv, H, K, dh, torch.bfloat16)["block_kv"]
    wph = MMA_WARPS // mma_heads(K)
    n = mma_split_count(B, K, Smax, G, dh, bkv, sms)
    lens = lengths.to(dev).long().clamp(0, Smax)
    per = split_rows(lens, n)
    rb = torch.minimum(torch.arange(n, device=dev)[None] * per[:, None], lens[:, None])
    re = torch.minimum(rb + per[:, None], lens[:, None])[:, :, None]  # (B, n, 1): a split's end
    qf = q.float().reshape(B, K, G, dh)
    bi = torch.arange(B, device=dev)[:, None, None, None]
    # per (sequence, split, warp, KV head, head): the warp's running state
    m = torch.full((B, n, wph, K, G), NEG_INF, device=dev)
    l = torch.zeros(B, n, wph, K, G, device=dev)
    acc = torch.zeros(B, n, wph, K, G, dh, device=dev)
    for j in range(-(-int(per.max()) // (wph * bkv)) if B else 0):
        r0 = rb[:, :, None] + (j * wph + torch.arange(wph, device=dev)) * bkv  # (B, n, wph)
        rows = r0[..., None] + torch.arange(bkv, device=dev)  # (B, n, wph, bkv)
        live = (rows < re[..., None])[:, :, :, None, None, :]
        kt, vt = (x[bi, rows.clamp(max=Smax - 1)].float() for x in (k, v))
        s = torch.einsum("bkgd,bnwrkd->bnwkgr", qf, kt) * qscale
        s = torch.where(live, s, NEG_INF)
        m_new = torch.maximum(m, s.amax(dim=-1))
        m_safe = torch.where(m_new == NEG_INF, 0.0, m_new)
        alpha = torch.exp2(m - m_safe)  # a stage past a warp's end leaves its state as it was
        p = torch.exp2(s - m_safe[..., None])
        l = l * alpha + p.sum(dim=-1)
        hi, lo = _hi_lo(p)
        acc = (acc * alpha[..., None] + torch.einsum("bnwkgr,bnwrkd->bnwkgd", hi, vt)
               + torch.einsum("bnwkgr,bnwrkd->bnwkgd", lo, vt))
        m = m_new
    # the head's warps combined
    mx = m.amax(dim=2, keepdim=True)
    a = torch.where(m == NEG_INF, 0.0, torch.exp2(m - mx))
    l, acc, m = (a * l).sum(dim=2), (a[..., None] * acc).sum(dim=2), mx[:, :, 0]
    if n == 1:
        out = acc[:, 0] * torch.where(l > 0, 1.0 / torch.where(l > 0, l, 1.0), 0.0)[:, 0, ..., None]
    else:  # the splits merged: weights 2^(m_s - M) / L
        M = m.amax(dim=1, keepdim=True)
        e = torch.where(m == NEG_INF, 0.0, torch.exp2(m - M))
        L = (e * l).sum(dim=1, keepdim=True)
        w = e * torch.where(L > 0, 1.0 / torch.where(L > 0, L, 1.0), 0.0)
        out = (w[..., None] * acc).sum(dim=1)
    return out.reshape(B, H, dh).to(q.dtype)


def _fn():
    global _FN
    if _FN is None:
        fn = _build.load("decode_attention").decode_attention_fwd
        fn.argtypes = _ARGTYPES
        fn.restype = ctypes.c_int
        _FN = fn
    return _FN


def _mma_fn():
    global _MMA_FN
    if _MMA_FN is None:
        fn = _build.load("decode_attention").decode_attention_mma_fwd
        fn.argtypes = _MMA_ARGTYPES
        fn.restype = ctypes.c_int
        _MMA_FN = fn
    return _MMA_FN


def _counters(dev: torch.device, n: int) -> torch.Tensor:
    """The device's merge counters (all zero between launches), grown to at
    least ``n``.  A graph captures the buffer a call used, so it must exist
    before the capture: growing it while capturing raises."""
    idx = dev.index if dev.index is not None else torch.cuda.current_device()
    buf = _COUNTERS.get(idx)
    if buf is None or buf.numel() < n:
        if torch.cuda.is_current_stream_capturing():
            raise RuntimeError("decode attention: the split-merge counters must be "
                               "allocated before CUDA-graph capture; run one call eagerly first")
        buf = _COUNTERS[idx] = torch.zeros(max(n, 4096), dtype=torch.int32, device=dev)
    return buf


def _check(q, k, v, lengths):
    if q.dim() != 3 or k.dim() != 4 or v.shape != k.shape:
        raise ValueError("decode_attention: q must be (B, H, dh) and k, v "
                         f"(B, Smax, K, dh); got {tuple(q.shape)}, "
                         f"{tuple(k.shape)}, {tuple(v.shape)}")
    B, H, dh = q.shape
    Bk, Smax, K, dhk = k.shape
    if (Bk, dhk) != (B, dh) or K < 1 or H % K or lengths.shape != (B,):
        raise ValueError(f"decode_attention: shapes do not fit: q {tuple(q.shape)}, "
                         f"k {tuple(k.shape)}, lengths {tuple(lengths.shape)}")


def _check_card(q, k, v, lengths):
    if q.device.type != "cuda":
        raise RuntimeError(f"decode attention kernel: unsupported device {q.device}")
    if _DTYPE_CODE.get((q.dtype, k.dtype)) is None or v.dtype != k.dtype:
        raise TypeError("decode attention kernel: supported (query, cache) types are "
                        "(f32, f32), (bf16, bf16), (f32, bf16); got "
                        f"{q.dtype}, {k.dtype}, {v.dtype}")
    if not (k.device == v.device == lengths.device == q.device):
        raise RuntimeError("decode attention kernel: tensors lie on different devices")


def _launch_mma(q, k, v, lengths, scale: float, block_kv: int) -> tuple:
    """``decode_kernel_mma`` on bf16 CUDA tensors that ``route`` sends there
    (checked by the caller); counts the launch in
    ``decode_attention_bf16.launches`` and returns ``(out, n_splits)``."""
    B, H, dh = q.shape
    _, Smax, K, _ = k.shape
    q, k, v = (last_dim_contiguous(t) for t in (q, k, v))
    for t in (k, v):  # cp.async reads 16 bytes a copy: every cache row starts on 16 bytes
        if t.data_ptr() % 16 or any(st % 8 for st in t.stride()[:3]):
            raise ValueError("decode attention kernel: the tensor-core path needs the K and V "
                             f"rows on 16 bytes; got strides {t.stride()}")
    lengths = lengths.to(torch.int32).contiguous()
    n_splits = mma_split_count(B, K, Smax, H // K, dh, block_kv, sm_count(q.device))
    out = torch.empty((B, H, dh), dtype=q.dtype, device=q.device)
    part = cnt = None
    if n_splits > 1:
        part = torch.empty((B, K, n_splits, H // K, dh + 2), dtype=torch.float32,
                           device=q.device)
        cnt = _counters(q.device, B * K)
    with torch.cuda.device(q.device):
        err = _mma_fn()(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), lengths.data_ptr(), out.data_ptr(),
            None if part is None else part.data_ptr(), None if cnt is None else cnt.data_ptr(),
            B, H, K, dh, Smax,
            q.stride(0), q.stride(1),
            k.stride(0), k.stride(1), k.stride(2),
            v.stride(0), v.stride(1), v.stride(2),
            out.stride(0), out.stride(1),
            scale, block_kv, n_splits, torch.cuda.current_stream().cuda_stream)
    _build.check(err, "decode_attention (tensor cores)")
    decode_attention_bf16.launches += 1
    decode_attention_bf16.last_config = {"block_kv": block_kv}
    return out, n_splits


def decode_attention_bf16(
    q: torch.Tensor,  # (B, H, dh) bf16
    k: torch.Tensor,  # (B, Smax, K, dh) bf16
    v: torch.Tensor,  # (B, Smax, K, dh) bf16
    lengths: torch.Tensor,  # (B,) integer
    *,
    scale: Optional[float] = None,
    block_kv: int = 512,
) -> torch.Tensor:
    """The tensor-core path alone (what ``decode_attention`` takes for the
    inputs ``route`` sends to ``"mma"``; others raise).  CUDA tensors go
    through ``decode_kernel_mma`` (or raise), counted in ``launches``; CPU
    tensors take ``decode_attention_plain``."""
    _check(q, k, v, lengths)
    B, H, dh = q.shape
    K = k.shape[2]
    if route(q.dtype, dh, H // K) != "mma" or k.dtype != torch.bfloat16:
        raise ValueError("decode_attention_bf16: takes a bf16 query and cache, dh a multiple of "
                         f"16 up to 128 and up to {MMA_MAX_GROUP} query heads a KV head; got "
                         f"{q.dtype}, {k.dtype}, dh {dh}, {H // K} heads a KV head")
    scale = float(scale) if scale is not None else dh ** -0.5
    cfg = effective_config(block_kv, H, K, dh, q.dtype)
    decode_attention_bf16.last_config = cfg
    if q.device.type == "cpu":
        return decode_attention_plain(q, k, v, lengths, scale=scale)
    _check_card(q, k, v, lengths)
    return _launch_mma(q, k, v, lengths, scale, cfg["block_kv"])[0]


def decode_attention(
    q: torch.Tensor,  # (B, H, dh)
    k: torch.Tensor,  # (B, Smax, K, dh)
    v: torch.Tensor,  # (B, Smax, K, dh)
    lengths: torch.Tensor,  # (B,) integer
    *,
    scale: Optional[float] = None,
    block_kv: int = 512,
) -> torch.Tensor:
    """(B,H,dh) x (B,Smax,K,dh) cache + (B,) lengths -> (B,H,dh).  CUDA
    tensors go through the kernel ``route`` picks (or raise); CPU tensors
    take ``decode_attention_plain``."""
    _check(q, k, v, lengths)
    B, H, dh = q.shape
    _, Smax, K, _ = k.shape
    scale = float(scale) if scale is not None else dh ** -0.5
    cfg = effective_config(block_kv, H, K, dh, q.dtype)
    decode_attention.last_config = cfg
    if q.device.type == "cpu":
        decode_attention.last_splits = 1
        return decode_attention_plain(q, k, v, lengths, scale=scale)
    _check_card(q, k, v, lengths)
    if route(q.dtype, dh, H // K) == "mma":
        out, decode_attention.last_splits = _launch_mma(q, k, v, lengths, scale, cfg["block_kv"])
        decode_attention.launches += 1
        return out
    q, k, v = (last_dim_contiguous(t) for t in (q, k, v))
    lengths = lengths.to(torch.int32).contiguous()
    out = torch.empty((B, H, dh), dtype=q.dtype, device=q.device)
    n_splits = split_count(B, K, Smax, cfg["block_kv"], sm_count(q.device))
    decode_attention.last_splits = n_splits
    part = cnt = None
    if n_splits > 1:
        part = torch.empty((B, H, n_splits, dh + 2), dtype=torch.float32, device=q.device)
        cnt = _counters(q.device, B * K)
    with torch.cuda.device(q.device):
        err = _fn()(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), lengths.data_ptr(),
            out.data_ptr(), None if part is None else part.data_ptr(),
            None if cnt is None else cnt.data_ptr(), _DTYPE_CODE[(q.dtype, k.dtype)],
            B, H, K, dh, Smax,
            q.stride(0), q.stride(1),
            k.stride(0), k.stride(1), k.stride(2),
            v.stride(0), v.stride(1), v.stride(2),
            out.stride(0), out.stride(1),
            scale, cfg["block_kv"], n_splits,
            torch.cuda.current_stream().cuda_stream)
    _build.check(err, "decode_attention")
    decode_attention.launches += 1
    return out


#: launches of either CUDA kernel since the count was last set to 0
decode_attention.launches = 0
#: the tiles the last call ran with (after clamping)
decode_attention.last_config = None
#: the cache splits of the last call (1 on the CPU)
decode_attention.last_splits = None
#: launches of the tensor-core kernel since the count was last set to 0
decode_attention_bf16.launches = 0
#: the stage rows the last call ran with (after clamping)
decode_attention_bf16.last_config = None
