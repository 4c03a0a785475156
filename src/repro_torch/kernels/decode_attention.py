"""Decode attention — CUDA C++ kernel for Hopper (csrc/decode_attention.cu).

Replaces the TPU kernel ``_decode_kernel`` / ``decode_attention`` of the
reference package (src/repro/kernels/decode_attention.py).  The source file
says what bounds the kernel on this card and what its design does about it;
this module is the wrapper: it checks the tensors, lowers ``block_kv`` (the
cache rows a block keeps in flight, 8 threads each) to what a block can
run, picks the number of cache splits, launches on PyTorch's current stream
and counts the launch.  ``decode_attention_plain`` is the same arithmetic in
plain PyTorch: the CPU path, and what the kernel is held against on the
card.

The cache axis is split over blocks (flash-decoding) in one launch:
``split_count(B, K, Smax, block_kv, sms)`` asks for two blocks per SM at
most, ``floor(2 * sms / (B * K))``, so that they run in one wave, and no
more splits than trips of ``block_kv`` rows in ``Smax``.  It reads shapes
only, never ``lengths`` (which stays on the device); each split takes
``ceil(lengths[b] / n_splits)`` rows of its sequence.  The count a call ran
with is kept in ``decode_attention.last_splits``.

The cache may be stored narrower than the query (a bf16 cache under an
fp32 query): the kernel widens it in registers, which is exact.
"""
from __future__ import annotations

import ctypes
from typing import Optional

import torch

from repro_torch.kernels import _build
from repro_torch.kernels._tiles import clamp_tile, last_dim_contiguous, pad_head_dim, sm_count

NEG_INF = float("-inf")

_TPR = 8  # threads per cache row in the kernel
MIN_BLOCK_KV = 32 // _TPR  # one warp
MAX_BLOCK_KV = 512 // _TPR  # the kernel is compiled for 512 threads at most
MAX_SMEM_BYTES = 232448

_DTYPE_CODE = {
    (torch.float32, torch.float32): 0,
    (torch.bfloat16, torch.bfloat16): 1,
    (torch.float32, torch.bfloat16): 2,
}
_ARGTYPES = ([ctypes.c_void_p] * 7 + [ctypes.c_int] * 6
             + [ctypes.c_longlong] * 10 + [ctypes.c_float, ctypes.c_int, ctypes.c_int,
                                           ctypes.c_void_p])
_FN = None
_COUNTERS: dict = {}  # device index -> zeroed int32 buffer of the split merge


def _group_chunk(group: int) -> int:
    return 1 if group == 1 else (4 if group <= 4 else 8)


def smem_bytes(block_kv: int, dh: int, group: int) -> int:
    """Dynamic shared memory of one block: the group's queries and
    accumulators, one trip's V rows and scores, and (m, l, rescale) per
    head."""
    dhp, gc = pad_head_dim(dh, "decode attention"), _group_chunk(group)
    return (2 * gc * dhp + block_kv * dhp + gc * block_kv + 3 * gc) * 4


def feasible(config: dict, shapes: dict, dtype=None) -> bool:
    """Whether ``config`` (``block_kv``) can launch at ``shapes`` (``dh``,
    ``H``, ``K``): thread and shared-memory limits of one block."""
    bkv = int(config["block_kv"])
    group = int(shapes["H"]) // int(shapes["K"])
    return (MIN_BLOCK_KV <= bkv <= MAX_BLOCK_KV
            and smem_bytes(bkv, int(shapes["dh"]), group) <= MAX_SMEM_BYTES)


def effective_config(block_kv: int, H: int, K: int, dh: int) -> dict:
    shapes = {"H": H, "K": K, "dh": dh}
    return {"block_kv": clamp_tile(
        "block_kv", block_kv, lambda t: feasible({"block_kv": t}, shapes),
        floor=MIN_BLOCK_KV)}


def split_count(B: int, K: int, Smax: int, block_kv: int, sms: int) -> int:
    """Cache splits of one call: about two blocks per SM, and no more, so
    that the splits run in one wave (the kernel fits two blocks an SM):
    ``floor(2 * sms / (B * K))``; but at least one trip of ``block_kv`` rows
    a split (at most ``ceil(Smax / block_kv)``), and at least 1."""
    want = 2 * sms // max(B * K, 1)
    cap = -(-max(Smax, 1) // block_kv)
    return max(1, min(want, cap))


def split_rows(lengths: torch.Tensor, n_splits: int) -> torch.Tensor:
    """Rows of each split, per sequence: ``ceil(lengths / n_splits)``; split
    ``s`` takes ``[s * r, min((s + 1) * r, length))``."""
    return (lengths + n_splits - 1) // n_splits


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


def _fn():
    global _FN
    if _FN is None:
        fn = _build.load("decode_attention").decode_attention_fwd
        fn.argtypes = _ARGTYPES
        fn.restype = ctypes.c_int
        _FN = fn
    return _FN


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
    tensors go through the kernel (or raise); CPU tensors take
    ``decode_attention_plain``."""
    if q.dim() != 3 or k.dim() != 4 or v.shape != k.shape:
        raise ValueError("decode_attention: q must be (B, H, dh) and k, v "
                         f"(B, Smax, K, dh); got {tuple(q.shape)}, "
                         f"{tuple(k.shape)}, {tuple(v.shape)}")
    B, H, dh = q.shape
    Bk, Smax, K, dhk = k.shape
    if (Bk, dhk) != (B, dh) or K < 1 or H % K or lengths.shape != (B,):
        raise ValueError(f"decode_attention: shapes do not fit: q {tuple(q.shape)}, "
                         f"k {tuple(k.shape)}, lengths {tuple(lengths.shape)}")
    scale = float(scale) if scale is not None else dh ** -0.5
    cfg = effective_config(block_kv, H, K, dh)
    decode_attention.last_config = cfg
    if q.device.type == "cpu":
        decode_attention.last_splits = 1
        return decode_attention_plain(q, k, v, lengths, scale=scale)
    if q.device.type != "cuda":
        raise RuntimeError(f"decode attention kernel: unsupported device {q.device}")
    code = _DTYPE_CODE.get((q.dtype, k.dtype))
    if code is None or v.dtype != k.dtype:
        raise TypeError("decode attention kernel: supported (query, cache) types are "
                        "(f32, f32), (bf16, bf16), (f32, bf16); got "
                        f"{q.dtype}, {k.dtype}, {v.dtype}")
    if not (k.device == v.device == lengths.device == q.device):
        raise RuntimeError("decode attention kernel: tensors lie on different devices")
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
            None if cnt is None else cnt.data_ptr(), code, B, H, K, dh, Smax,
            q.stride(0), q.stride(1),
            k.stride(0), k.stride(1), k.stride(2),
            v.stride(0), v.stride(1), v.stride(2),
            out.stride(0), out.stride(1),
            scale, cfg["block_kv"], n_splits,
            torch.cuda.current_stream().cuda_stream)
    _build.check(err, "decode_attention")
    decode_attention.launches += 1
    return out


#: launches of the CUDA kernel since the count was last set to 0
decode_attention.launches = 0
#: the tiles the last call ran with (after clamping)
decode_attention.last_config = None
#: the cache splits the last call ran with (1 on the CPU)
decode_attention.last_splits = None
