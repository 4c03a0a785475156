"""Flash attention forward — CUDA C++ kernels for Hopper (csrc/flash_attention.cu).

Replaces the TPU kernel ``_flash_kernel`` / ``flash_attention`` of the
reference package (src/repro/kernels/flash_attention.py).  The source file
says what bounds the kernels on this card and what each design does about
it; this module is the wrapper: it picks the kernel (``route``), checks the
tensors, lowers the tile request to what that kernel can hold, launches on
PyTorch's current stream and counts the launch.  ``flash_attention_plain``
is the same tiled online-softmax arithmetic in plain PyTorch: the CPU path,
and what the kernels are held against on the card.

Which kernel takes a call (``route``):

* ``"wgmma"`` — bf16 at ``block_q`` 64 or 128, ``dh == dv`` a multiple of
  16 up to 128, and tensors TMA can read (16-byte aligned base, strides of
  8 elements): warpgroup MMA fed by TMA through an mbarrier ring;
  ``block_kv`` 16..128.
* ``"mma"`` — every other bf16 call at ``block_q`` 16..128: ``mma.sync``
  tensor-core kernel.
* ``"tiled"`` — float32 at ``block_q`` 16..64: register-tiled FMA kernel
  with ``cp.async`` staging; ``block_kv`` 16..64.
* ``"fma"`` — ``block_q`` below 16, either type: one thread per query row.

A request is clamped to the largest power of two that the routed kernel can
launch (``effective_config``); the routing is between kernels of the port,
and a call the routed kernel cannot take raises.
"""
from __future__ import annotations

import ctypes
from typing import Optional

import torch

from repro_torch.kernels import _build
from repro_torch.kernels._tiles import clamp_tile, last_dim_contiguous, pad_head_dim

NEG_INF = float("-inf")

#: what one block may use (Hopper: 227 KB of dynamic shared memory), and the
#: tiles each kernel is compiled for
MAX_SMEM_BYTES = 232448
MAX_BLOCK_Q = 256        # "fma": one thread per query row
MAX_BLOCK_Q_MMA = 128    # "mma": a warp per 16 query rows, 8 warps at most
WGMMA_BLOCK_Q = (64, 128)  # "wgmma": one or two warpgroups of 64 rows
WGMMA_BLOCK_KV = (16, 128)  # "wgmma": K/V tile rows, powers of two in this range
TILED_BLOCK = (16, 64)   # "tiled": block_q and block_kv, powers of two in this range
_KC = 8  # keys per softmax update in the "fma" kernel: its smallest K/V tile
_KCH = 32  # the same for the "mma" kernel

_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}
_KERNEL_CODE = {"fma": 0, "mma": 1, "wgmma": 2, "tiled": 3}
_TMA_ENCODE_FAILED = 10000
_ARGTYPES = ([ctypes.c_void_p] * 4 + [ctypes.c_int] * 8
             + [ctypes.c_longlong] * 12 + [ctypes.c_float]
             + [ctypes.c_int] * 5 + [ctypes.c_void_p])
_FN = None


def route(block_q: int, dtype=None, dh: int = 64, dv: Optional[int] = None,
          tma_ok: bool = True) -> str:
    """The kernel that takes a call: ``"wgmma"``, ``"mma"``, ``"tiled"`` or
    ``"fma"`` (see the module docstring).  ``dtype`` None is float32;
    ``tma_ok`` says whether the tensors are aligned as TMA needs."""
    dv = dh if dv is None else dv
    if block_q < 16:
        return "fma"
    if dtype != torch.bfloat16:
        return "tiled"
    if (block_q in WGMMA_BLOCK_Q and dh == dv and dh % 16 == 0 and dh <= 128
            and tma_ok):
        return "wgmma"
    return "mma"


def uses_tensor_cores(block_q: int, dtype) -> bool:
    """bf16 inputs at 16 or more query rows per block run on the tensor
    cores (the ``wgmma`` or the ``mma.sync`` kernel, see ``route``);
    everything else on the FMA units."""
    return dtype == torch.bfloat16 and block_q >= 16


def tma_aligned(*tensors: torch.Tensor) -> bool:
    """Whether TMA can read each (B, S, heads, d) tensor in place: a 16-byte
    aligned base and, in every dim of size > 1, a stride of a multiple of 8
    elements (16 bytes)."""
    for t in tensors:
        if t.data_ptr() % 16:
            return False
        for n, st in zip(t.shape[:3], t.stride()[:3]):
            if n > 1 and (st <= 0 or st % 8):
                return False
    return True


def smem_bytes(block_kv: int, dh: int, dv: int, *, kernel: str = "fma",
               block_q: int = 64) -> int:
    """Dynamic shared memory of one block of ``kernel``: the K and V tiles
    (fp32 for "fma", bf16 with 16 bytes of row padding for "mma"; Q and a
    ring of 2-4 stages of swizzled bf16 tiles for "wgmma"; Q, two stages of
    padded fp32 tiles and P for "tiled").  Head dims are padded to the
    compiled width of the larger of the two."""
    dp = pad_head_dim(max(dh, dv), "flash attention")
    if kernel == "mma":
        return max(block_kv, _KCH) * 2 * (dp + 8) * 2
    if kernel == "wgmma":
        # Q, barriers and alignment slack, then as many K/V stages (2..4) as
        # leave room for a second block on the SM
        nch = 1 if dp <= 64 else 2
        fixed, stage = 1024 + block_q * nch * 128 + 72, 2 * nch * block_kv * 128
        return fixed + max(2, min(4, (MAX_SMEM_BYTES // 2 - fixed) // stage)) * stage
    if kernel == "tiled":
        return (block_q * (dp + 4) + 4 * block_kv * (dp + 4) + block_q * (block_kv + 4)) * 4
    return max(block_kv, _KC) * 2 * dp * 4


def _tile_limits(kernel: str):
    """(smallest, largest) block_q and block_kv a kernel is compiled for."""
    if kernel == "wgmma":
        return WGMMA_BLOCK_Q, WGMMA_BLOCK_KV
    if kernel == "tiled":
        return TILED_BLOCK, TILED_BLOCK
    if kernel == "mma":
        return (16, MAX_BLOCK_Q_MMA), (1, None)
    return (1, MAX_BLOCK_Q), (1, None)


def feasible(config: dict, shapes: dict, dtype=None) -> bool:
    """Whether ``config`` (``block_q``, ``block_kv``) can launch at
    ``shapes`` (``dh``, optionally ``dv`` and ``tma_ok``) for inputs of
    ``dtype`` (``None``: float32): the routed kernel's compiled tiles,
    thread and shared-memory limits of one block."""
    dh = int(shapes["dh"])
    dv = int(shapes.get("dv", dh))
    bq, bkv = int(config["block_q"]), int(config["block_kv"])
    kernel = route(bq, dtype, dh, dv, bool(shapes.get("tma_ok", True)))
    (q_lo, q_hi), (kv_lo, kv_hi) = _tile_limits(kernel)
    if kernel in ("wgmma", "tiled") and (bq & (bq - 1) or bkv & (bkv - 1)):
        return False  # compiled for powers of two only
    return (q_lo <= bq <= q_hi and kv_lo <= bkv and (kv_hi is None or bkv <= kv_hi)
            and smem_bytes(bkv, dh, dv, kernel=kernel, block_q=bq) <= MAX_SMEM_BYTES)


def effective_config(block_q: int, block_kv: int, Sq: int, Sk: int,
                     dh: int, dv: int, dtype=None, tma_ok: bool = True) -> dict:
    """The tiles a request runs with: powers of two, not above the request,
    not above the padded sequence, and feasible for the kernel the query
    tile routes to (a ``block_kv`` below that kernel's smallest tile is
    raised to it)."""
    shapes = {"dh": dh, "dv": dv, "tma_ok": tma_ok}

    def kv_floor(bq):
        return _tile_limits(route(bq, dtype, dh, dv, tma_ok))[1][0]

    bq = clamp_tile(
        "block_q", block_q,
        lambda t: feasible({"block_q": t, "block_kv": kv_floor(t)}, shapes, dtype),
        cap=max(Sq, 1))
    floor = kv_floor(bq)
    bkv = clamp_tile(
        "block_kv", block_kv,
        lambda t: feasible({"block_q": bq, "block_kv": t}, shapes, dtype),
        cap=max(Sk, 1), floor=floor)
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
    q, k, v = (last_dim_contiguous(t) for t in (q, k, v))
    tma_ok = tma_aligned(q, k, v)
    cfg = effective_config(block_q, block_kv, Sq, Sk, dh, dv, q.dtype, tma_ok)
    kernel = route(cfg["block_q"], q.dtype, dh, dv, tma_ok)
    flash_attention.last_config = cfg
    flash_attention.last_kernel = kernel
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
            cfg["block_q"], cfg["block_kv"], _KERNEL_CODE[kernel],
            torch.cuda.current_stream().cuda_stream)
    if code >= _TMA_ENCODE_FAILED:
        raise RuntimeError(f"flash attention kernel: cuTensorMapEncodeTiled failed with "
                           f"CUresult {code - _TMA_ENCODE_FAILED}")
    _build.check(code, f"flash_attention ({kernel})")
    flash_attention.launches += 1
    return out


#: launches of the CUDA kernel since the count was last set to 0
flash_attention.launches = 0
#: the tiles the last call ran with (after clamping)
flash_attention.last_config = None
#: the kernel the last call routed to (see ``route``)
flash_attention.last_kernel = None
