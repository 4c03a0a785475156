"""Decode attention — CUDA C++ kernel for Hopper (csrc/decode_attention.cu).

Replaces the TPU kernel ``_decode_kernel`` / ``decode_attention`` of the
reference package (src/repro/kernels/decode_attention.py).  The source file
says what bounds the kernel on this card and what its design does about it;
this module is the wrapper: it checks the tensors, lowers ``block_kv`` (the
cache rows a block keeps in flight, 8 threads each) to what a block can
run, launches on PyTorch's current stream and counts the launch.
``decode_attention_plain`` is the same arithmetic in plain PyTorch: the CPU
path, and what the kernel is held against on the card.

The cache may be stored narrower than the query (a bf16 cache under an
fp32 query): the kernel widens it in registers, which is exact.
"""
from __future__ import annotations

import ctypes
from typing import Optional

import torch

from repro_torch.kernels import _build
from repro_torch.kernels._tiles import clamp_tile, last_dim_contiguous, pad_head_dim

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
_ARGTYPES = ([ctypes.c_void_p] * 5 + [ctypes.c_int] * 6
             + [ctypes.c_longlong] * 10 + [ctypes.c_float, ctypes.c_int,
                                           ctypes.c_void_p])
_FN = None


def _group_chunk(group: int) -> int:
    return 1 if group == 1 else (4 if group <= 4 else 8)


def smem_bytes(block_kv: int, dh: int, group: int) -> int:
    """Dynamic shared memory of one block: the group's queries and one
    (m, l, acc) per warp and head for the final merge."""
    dhp, gc = pad_head_dim(dh, "decode attention"), _group_chunk(group)
    nwarps = block_kv * _TPR // 32
    return (gc * dhp + nwarps * gc * (2 + dhp)) * 4


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


def decode_attention_plain(
    q: torch.Tensor,  # (B, H, dh)
    k: torch.Tensor,  # (B, Smax, K, dh)
    v: torch.Tensor,  # (B, Smax, K, dh)
    lengths: torch.Tensor,  # (B,)
    *,
    scale: Optional[float] = None,
) -> torch.Tensor:
    """One query token against the cache in plain PyTorch, fp32 throughout,
    GQA by index; rows at or past ``lengths[b]`` are masked and an empty
    cache gives exact zeros."""
    B, H, dh = q.shape
    _, Smax, K, _ = k.shape
    G = H // K
    scale = scale if scale is not None else dh ** -0.5
    qf = q.float().reshape(B, K, G, dh)
    s = torch.einsum("bkgd,bskd->bkgs", qf, k.float()) * scale
    mask = (torch.arange(Smax, device=q.device)[None, :]
            < lengths.to(q.device)[:, None])[:, None, None, :]
    s = torch.where(mask, s, NEG_INF)
    m = s.amax(dim=-1, keepdim=True)
    m_safe = torch.where(m == NEG_INF, 0.0, m)
    p = torch.where(mask, torch.exp(s - m_safe), 0.0)
    l = p.sum(dim=-1, keepdim=True)
    acc = torch.einsum("bkgs,bskd->bkgd", p, v.float())
    alive = l > 0
    out = torch.where(alive, acc / torch.where(alive, l, 1.0), 0.0)
    return out.reshape(B, H, v.shape[-1]).to(q.dtype)


def _fn():
    global _FN
    if _FN is None:
        fn = _build.load("decode_attention").decode_attention_fwd
        fn.argtypes = _ARGTYPES
        fn.restype = ctypes.c_int
        _FN = fn
    return _FN


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
    with torch.cuda.device(q.device):
        err = _fn()(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), lengths.data_ptr(),
            out.data_ptr(), code, B, H, K, dh, Smax,
            q.stride(0), q.stride(1),
            k.stride(0), k.stride(1), k.stride(2),
            v.stride(0), v.stride(1), v.stride(2),
            out.stride(0), out.stride(1),
            scale, cfg["block_kv"],
            torch.cuda.current_stream().cuda_stream)
    _build.check(err, "decode_attention")
    decode_attention.launches += 1
    return out


#: launches of the CUDA kernel since the count was last set to 0
decode_attention.launches = 0
#: the tiles the last call ran with (after clamping)
decode_attention.last_config = None
