"""Flash attention forward — CUDA C++ kernel for Hopper (csrc/flash_attention.cu).

Replaces the TPU kernel ``_flash_kernel`` / ``flash_attention`` of the
reference package (src/repro/kernels/flash_attention.py).  The source file
says what bounds the kernel on this card and what its design does about it;
this module is the wrapper: it checks the tensors, lowers the tile request
to what a block can hold, launches on PyTorch's current stream and counts
the launch.  ``flash_attention_plain`` is the same tiled online-softmax
arithmetic in plain PyTorch: the CPU path, and what the kernel is held
against on the card.
"""
from __future__ import annotations

import ctypes
from typing import Optional

import torch

from repro_torch.kernels import _build
from repro_torch.kernels._tiles import clamp_tile, last_dim_contiguous, pad_head_dim

NEG_INF = float("-inf")

#: what one block may use (Hopper: 227 KB of dynamic shared memory).  The
#: fp32 kernel runs one thread per query row and is compiled for 256 at most;
#: the bf16 tensor-core kernel runs a warp per 16 query rows, 8 warps at most.
MAX_SMEM_BYTES = 232448
MAX_BLOCK_Q = 256
MAX_BLOCK_Q_MMA = 128
_KC = 8  # keys per softmax update in the fp32 kernel: its smallest K/V tile
_KCH = 32  # the same for the tensor-core kernel

_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}
_ARGTYPES = ([ctypes.c_void_p] * 4 + [ctypes.c_int] * 8
             + [ctypes.c_longlong] * 12 + [ctypes.c_float]
             + [ctypes.c_int] * 4 + [ctypes.c_void_p])
_FN = None


def uses_tensor_cores(block_q: int, dtype) -> bool:
    """bf16 inputs at 16 or more query rows per block take the mma kernel;
    everything else the fp32 FMA kernel."""
    return dtype == torch.bfloat16 and block_q >= 16


def smem_bytes(block_kv: int, dh: int, dv: int, *, mma: bool = False) -> int:
    """Dynamic shared memory of one block: the K and V tiles, fp32 for the
    FMA kernel, bf16 with 16 bytes of row padding for the tensor-core one."""
    name = "flash attention"
    dhp, dvp = pad_head_dim(dh, name), pad_head_dim(dv, name)
    if mma:
        return max(block_kv, _KCH) * (dhp + 8 + dvp + 8) * 2
    return max(block_kv, _KC) * (dhp + dvp) * 4


def feasible(config: dict, shapes: dict, dtype=None) -> bool:
    """Whether ``config`` (``block_q``, ``block_kv``) can launch at
    ``shapes`` (``dh`` and optionally ``dv``) for inputs of ``dtype``
    (``None``: float32): thread and shared-memory limits of one block."""
    dh = int(shapes["dh"])
    dv = int(shapes.get("dv", dh))
    bq, bkv = int(config["block_q"]), int(config["block_kv"])
    mma = uses_tensor_cores(bq, dtype)
    return (1 <= bq <= (MAX_BLOCK_Q_MMA if mma else MAX_BLOCK_Q)
            and smem_bytes(bkv, dh, dv, mma=mma) <= MAX_SMEM_BYTES)


def effective_config(block_q: int, block_kv: int, Sq: int, Sk: int,
                     dh: int, dv: int, dtype=None) -> dict:
    """The tiles a request runs with: powers of two, not above the request,
    not above the padded sequence, and feasible."""
    shapes = {"dh": dh, "dv": dv}
    bq = clamp_tile(
        "block_q", block_q,
        lambda t: feasible({"block_q": t, "block_kv": 1}, shapes, dtype),
        cap=max(Sq, 1))
    bkv = clamp_tile(
        "block_kv", block_kv,
        lambda t: feasible({"block_q": bq, "block_kv": t}, shapes, dtype),
        cap=max(Sk, 1))
    return {"block_q": bq, "block_kv": bkv}


def flash_attention_plain(
    q: torch.Tensor,  # (B, Sq, H, dh)
    k: torch.Tensor,  # (B, Sk, K, dh)
    v: torch.Tensor,  # (B, Sk, K, dv)
    *,
    causal: bool = True,
    window: Optional[int] = None,
    scale: Optional[float] = None,
    block_kv: int = 128,
) -> torch.Tensor:
    """Tiled online-softmax attention in plain PyTorch, fp32 throughout:
    GQA by index (no expansion of K/V), one pass over KV tiles carrying
    ``m / l / acc``, exact zeros for rows that attend nothing."""
    B, Sq, H, dh = q.shape
    _, Sk, K, _ = k.shape
    dv = v.shape[-1]
    G = H // K
    scale = scale if scale is not None else dh ** -0.5
    dev = q.device
    qf = q.float().reshape(B, Sq, K, G, dh)
    q_pos = torch.arange(Sq, device=dev)[:, None]
    offset = Sk - Sq
    m = torch.full((B, K, G, Sq), NEG_INF, device=dev)
    l = torch.zeros((B, K, G, Sq), device=dev)
    acc = torch.zeros((B, K, G, Sq, dv), device=dev)
    for k0 in range(0, Sk, block_kv):
        kt = k[:, k0:k0 + block_kv].float()
        vt = v[:, k0:k0 + block_kv].float()
        k_pos = torch.arange(k0, k0 + kt.shape[1], device=dev)[None, :]
        if causal:
            mask = k_pos <= q_pos + offset
            if window is not None:
                mask = mask & (k_pos > q_pos + offset - window)
        elif window is not None:
            mask = (k_pos - q_pos).abs() < window
        else:
            mask = torch.ones((Sq, kt.shape[1]), dtype=torch.bool, device=dev)
        s = torch.einsum("bqkgd,bskd->bkgqs", qf, kt) * scale
        s = torch.where(mask, s, NEG_INF)
        m_next = torch.maximum(m, s.amax(dim=-1))
        m_safe = torch.where(m_next == NEG_INF, 0.0, m_next)
        alpha = torch.exp(m - m_safe)
        p = torch.where(mask, torch.exp(s - m_safe[..., None]), 0.0)
        l = l * alpha + p.sum(dim=-1)
        acc = acc * alpha[..., None] + torch.einsum("bkgqs,bskd->bkgqd", p, vt)
        m = m_next
    alive = l > 0
    out = torch.where(alive[..., None], acc / torch.where(alive, l, 1.0)[..., None], 0.0)
    # (B, K, G, Sq, dv) -> (B, Sq, H, dv)
    return out.permute(0, 3, 1, 2, 4).reshape(B, Sq, H, dv).to(q.dtype)


def _fn():
    global _FN
    if _FN is None:
        fn = _build.load("flash_attention").flash_attention_fwd
        fn.argtypes = _ARGTYPES
        fn.restype = ctypes.c_int
        _FN = fn
    return _FN


def flash_attention(
    q: torch.Tensor,  # (B, Sq, H, dh)
    k: torch.Tensor,  # (B, Sk, K, dh)
    v: torch.Tensor,  # (B, Sk, K, dv)
    *,
    causal: bool = True,
    window: Optional[int] = None,
    scale: Optional[float] = None,
    block_q: int = 128,
    block_kv: int = 128,
) -> torch.Tensor:
    """(B,Sq,H,dh) x (B,Sk,K,dh) x (B,Sk,K,dv) -> (B,Sq,H,dv).  CUDA tensors
    go through the kernel (or raise); CPU tensors take
    ``flash_attention_plain``."""
    if q.dim() != 4 or k.dim() != 4 or v.dim() != 4:
        raise ValueError("flash_attention: q, k, v must be (B, S, heads, dim)")
    B, Sq, H, dh = q.shape
    Bk, Sk, K, dhk = k.shape
    dv = v.shape[-1]
    if (Bk, dhk) != (B, dh) or v.shape[:3] != k.shape[:3] or K < 1 or H % K:
        raise ValueError(f"flash_attention: shapes do not fit: q {tuple(q.shape)}, "
                         f"k {tuple(k.shape)}, v {tuple(v.shape)}")
    if window is not None and window < 1:
        raise ValueError(f"window must be positive, got {window}")
    scale = float(scale) if scale is not None else dh ** -0.5
    cfg = effective_config(block_q, block_kv, Sq, Sk, dh, dv, q.dtype)
    flash_attention.last_config = cfg
    if q.device.type == "cpu":
        return flash_attention_plain(q, k, v, causal=causal, window=window,
                                     scale=scale, block_kv=cfg["block_kv"])
    if q.device.type != "cuda":
        raise RuntimeError(f"flash attention kernel: unsupported device {q.device}")
    if not (q.dtype == k.dtype == v.dtype) or q.dtype not in _DTYPE_CODE:
        raise TypeError("flash attention kernel: q, k, v must share float32 or "
                        f"bfloat16, got {q.dtype}, {k.dtype}, {v.dtype}")
    if k.device != q.device or v.device != q.device:
        raise RuntimeError("flash attention kernel: tensors lie on different devices")
    q, k, v = (last_dim_contiguous(t) for t in (q, k, v))
    out = torch.empty((B, Sq, H, dv), dtype=q.dtype, device=q.device)
    with torch.cuda.device(q.device):
        code = _fn()(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
            _DTYPE_CODE[q.dtype], B, Sq, Sk, H, K, dh, dv,
            q.stride(0), q.stride(1), q.stride(2),
            k.stride(0), k.stride(1), k.stride(2),
            v.stride(0), v.stride(1), v.stride(2),
            out.stride(0), out.stride(1), out.stride(2),
            scale, int(bool(causal)), int(window) if window is not None else 0,
            cfg["block_q"], cfg["block_kv"],
            torch.cuda.current_stream().cuda_stream)
    _build.check(code, "flash_attention")
    flash_attention.launches += 1
    return out


#: launches of the CUDA kernel since the count was last set to 0
flash_attention.launches = 0
#: the tiles the last call ran with (after clamping)
flash_attention.last_config = None
