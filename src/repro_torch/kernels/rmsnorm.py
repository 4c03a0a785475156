"""Fused RMSNorm — Triton kernel for Hopper.

Replaces the TPU kernel ``_rmsnorm_kernel`` / ``rmsnorm`` of the reference
package (src/repro/kernels/rmsnorm.py): ``y = x * rsqrt(mean(x², -1) + eps)
* scale`` with everything in fp32 and one rounding at the store.

Bound on this card: bytes.  Each element is read once and written once and
takes about four operations, far below the card's operations-per-byte
line, and nothing is reused between rows.  The design therefore only has to
move each byte once, in wide coalesced accesses: one program per
``block_rows`` rows keeps its whole ``(block_rows, next_pow2(D))`` tile in
registers, reduces each row across the warp, and stores once.  The ragged
last block and the columns past ``D`` are masked, nothing is padded by a
copy.  Triton generates the 16-byte loads and the warp reduction that a
CUDA C++ version would spell out by hand.

The tile must fit the registers of one program: ``block_rows *
next_pow2(D) <= MAX_TILE_ELEMS`` (32 fp32 values per thread at 8 warps).
A larger ``block_rows`` request is lowered, see ``effective_config``.
"""
from __future__ import annotations

import torch

from repro_torch.kernels._tiles import clamp_tile, pow2_ceil

#: elements one program may hold (8 warps x 32 lanes x 32 registers)
MAX_TILE_ELEMS = 8192

_KERNEL = None


def rmsnorm_plain(x: torch.Tensor, scale: torch.Tensor,
                  eps: float = 1e-5) -> torch.Tensor:
    """The kernel's arithmetic in plain PyTorch: fp32 throughout, rounded
    once."""
    xf = x.float()
    var = (xf * xf).mean(dim=-1, keepdim=True)
    return (xf * torch.rsqrt(var + eps) * scale.float()).to(x.dtype)


def feasible(config: dict, shapes: dict, dtype=None) -> bool:
    """Whether ``config`` (``block_rows``) can launch at ``shapes`` (``D``):
    the program's tile must fit its registers."""
    block_d = pow2_ceil(int(shapes["D"]))
    return int(config["block_rows"]) * block_d <= MAX_TILE_ELEMS


def effective_config(block_rows: int, rows: int, D: int) -> dict:
    return {"block_rows": clamp_tile(
        "block_rows", block_rows,
        lambda t: feasible({"block_rows": t}, {"D": D}), cap=max(rows, 1))}


def _kernel():
    """The ``@triton.jit`` function, made at first launch: ``triton`` is
    imported here and not when the module is, so that the module imports on
    a machine without it."""
    global _KERNEL, triton, tl
    if _KERNEL is not None:
        return _KERNEL
    import triton
    import triton.language as tl

    @triton.jit
    def _rmsnorm_fwd(x_ptr, s_ptr, o_ptr, rows, D, stride_x, stride_o, eps,
                     BLOCK_ROWS: tl.constexpr, BLOCK_D: tl.constexpr):
        pid = tl.program_id(0)
        r = pid * BLOCK_ROWS + tl.arange(0, BLOCK_ROWS)
        c = tl.arange(0, BLOCK_D)
        cmask = c < D
        mask = (r < rows)[:, None] & cmask[None, :]
        r64 = r.to(tl.int64)
        x = tl.load(x_ptr + r64[:, None] * stride_x + c[None, :],
                    mask=mask, other=0.0).to(tl.float32)
        var = tl.sum(x * x, axis=1) / D
        inv = 1.0 / tl.sqrt(var + eps)
        s = tl.load(s_ptr + c, mask=cmask, other=0.0).to(tl.float32)
        y = x * inv[:, None] * s[None, :]
        tl.store(o_ptr + r64[:, None] * stride_o + c[None, :],
                 y.to(o_ptr.dtype.element_ty), mask=mask)

    _KERNEL = _rmsnorm_fwd
    return _KERNEL


def rmsnorm(
    x: torch.Tensor,  # (..., D)
    scale: torch.Tensor,  # (D,)
    eps: float = 1e-5,
    *,
    block_rows: int = 256,
) -> torch.Tensor:
    """RMSNorm over the last dimension.  A CUDA tensor goes through the
    Triton kernel (or raises); a CPU tensor takes ``rmsnorm_plain``."""
    D = x.shape[-1]
    if scale.shape != (D,):
        raise ValueError(f"scale must have shape ({D},), got {tuple(scale.shape)}")
    rows = x.numel() // max(D, 1)
    cfg = effective_config(block_rows, rows, D)
    rmsnorm.last_config = cfg
    if x.device.type == "cpu":
        return rmsnorm_plain(x, scale, eps)
    if x.device.type != "cuda":
        raise RuntimeError(f"rmsnorm kernel: unsupported device {x.device}")
    if x.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"rmsnorm kernel: unsupported dtype {x.dtype}")
    if scale.device != x.device:
        raise RuntimeError("rmsnorm kernel: x and scale lie on different devices")
    xr = x.reshape(-1, D)
    if xr.stride(-1) != 1:
        xr = xr.contiguous()
    scale = scale.contiguous()
    out = torch.empty((rows, D), dtype=x.dtype, device=x.device)
    if rows == 0:
        return out.reshape(x.shape)
    br = cfg["block_rows"]
    block_d = pow2_ceil(D)
    num_warps = min(8, max(1, br * block_d // 1024))
    with torch.cuda.device(x.device):
        _kernel()[((rows + br - 1) // br,)](
            xr, scale, out, rows, D, xr.stride(0), out.stride(0), float(eps),
            BLOCK_ROWS=br, BLOCK_D=block_d, num_warps=num_warps)
    rmsnorm.launches += 1
    return out.reshape(x.shape)


#: launches of the Triton kernel since the count was last set to 0
rmsnorm.launches = 0
#: the tiles the last call ran with (after clamping)
rmsnorm.last_config = None
