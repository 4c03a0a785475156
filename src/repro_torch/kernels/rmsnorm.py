"""Fused RMSNorm — Triton kernel for Hopper.

Replaces the TPU kernel ``_rmsnorm_kernel`` / ``rmsnorm`` of the reference
package (src/repro/kernels/rmsnorm.py): ``y = x * rsqrt(mean(x², -1) + eps)
* scale`` with everything in fp32 and one rounding at the store.

Bound on this card: bytes.  Each element is read once and written once and
takes about four operations, far below the card's operations-per-byte
line, and nothing is reused between rows.  So the kernel only has to keep
enough bytes in flight on every SM, in wide coalesced accesses.  The card,
not the tile knob, sets the launch geometry (``geometry``):

* the grid is one wave at most (``RESIDENT`` programs on each SM) and, when
  there are rows enough, never less: a program holds ``tile_rows`` rows at
  a time, few enough that the row tiles fill the wave, and strides over the
  tiles (a persistent grid).  ``block_rows`` (the reference's knob) only
  bounds ``tile_rows``; no choice of it leaves SMs idle.  Its choices
  start at 8 rows, and the register cap (``MAX_TILE_ELEMS // chunk``) and
  the wave rule (``rows // wave``) bind first unless D <= 256 and rows
  fill 16 waves (8448 rows on 132 SMs): elsewhere, at rows=4096 and at
  every D > 256 among them, every choice gives the same launch;
* the loop over a program's tiles is software-pipelined (``STAGES``): the
  loads of its next tile are in flight while it reduces the current one;
* a row of up to ``MAX_CHUNK`` columns is held whole in registers, one
  power-of-two tile masked past ``D``; a wider row is walked in
  ``n_chunks`` chunks of ``MAX_CHUNK``, read twice (once for the sum of
  squares, once to scale and store; the second read finds it in L1 / L2).
  The masked lanes of a round-up cost little, the bound being bytes, and a
  second read costs more: exact chunks (7 x 128 for 896) lose to one masked
  tile of 1024, while at 2560 three chunks of 1024 beat one masked tile of
  4096 (``python -m repro_torch.benchmarks.rmsnorm_chunking``; PERF.md).

The ragged last tile and the columns past ``D`` are masked, nothing is
padded by a copy.  Triton generates the 16-byte loads and the warp
reduction that a CUDA C++ version would spell out by hand.
"""
from __future__ import annotations

import torch

from repro_torch.kernels._tiles import clamp_tile, pow2_ceil, pow2_floor, sm_count

#: values of one (tile_rows, chunk) tile a program loads at once, unless a
#: single row is wider (16 fp32 registers a thread at 8 warps)
MAX_TILE_ELEMS = 4096
#: widest chunk (a row held whole), and most chunks a row (so the widest row)
MAX_CHUNK = 1024
MAX_CHUNKS = 32
MAX_D = MAX_CHUNK * MAX_CHUNKS
#: programs one wave counts on each SM, and the depth of the tile pipeline
RESIDENT = 4
STAGES = 2
#: the pipeline stages a tile's loads in shared memory (a chunked row's
#: twice): a tile of more bytes runs unpipelined
MAX_STAGED_BYTES = 32 * 1024

_KERNEL = None


def rmsnorm_plain(x: torch.Tensor, scale: torch.Tensor,
                  eps: float = 1e-5) -> torch.Tensor:
    """The kernel's arithmetic in plain PyTorch: fp32 throughout, rounded
    once."""
    xf = x.float()
    var = (xf * xf).mean(dim=-1, keepdim=True)
    return (xf * torch.rsqrt(var + eps) * scale.float()).to(x.dtype)


def col_chunks(D: int):
    """``(chunk, n_chunks)``: a row is walked in ``n_chunks`` chunks of
    ``chunk`` columns, a power of two: one chunk (the row, masked) up to
    ``MAX_CHUNK`` columns, chunks of ``MAX_CHUNK`` above."""
    chunk = min(pow2_ceil(D), MAX_CHUNK)
    return chunk, -(-D // chunk)


def geometry(rows: int, D: int, block_rows: int, sms: int, itemsize: int = 4) -> dict:
    """What a launch runs with, from the shapes, the element size and the
    SM count: the chunking of a row, ``tile_rows`` (rows a program holds at
    once: at most ``block_rows``, as many as a tile's registers allow, and
    few enough that the tiles fill a wave of ``sms * RESIDENT`` programs),
    the number of tiles, the grid (at most one wave, each program striding
    over the tiles), the pipeline's stages and the warps of a program."""
    chunk, n_chunks = col_chunks(D)
    wave = sms * RESIDENT
    tile = pow2_floor(max(1, min(block_rows, MAX_TILE_ELEMS // chunk, rows // wave)))
    tiles = -(-rows // tile)
    staged = tile * chunk * n_chunks * (1 if n_chunks == 1 else 2) * itemsize
    staged = staged <= MAX_STAGED_BYTES
    return {"chunk": chunk, "n_chunks": n_chunks, "tile_rows": tile, "tiles": tiles,
            "grid": min(tiles, wave), "wave": wave, "stages": STAGES if staged else 1,
            "num_warps": min(8, max(1, tile * chunk // 256))}


def feasible(config: dict, shapes: dict, dtype=None) -> bool:
    """Whether ``config`` (``block_rows``) can launch at ``shapes`` (``D``):
    a row must fit ``MAX_CHUNKS`` chunks."""
    return int(config["block_rows"]) >= 1 and int(shapes["D"]) <= MAX_D


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
    def _rmsnorm_fwd(x_ptr, s_ptr, o_ptr, rows, D, stride_x, stride_o, eps, n_tiles,
                     TILE_ROWS: tl.constexpr, CHUNK: tl.constexpr,
                     N_CHUNKS: tl.constexpr, STAGES: tl.constexpr):
        c = tl.arange(0, CHUNK)
        for t in tl.range(tl.program_id(0), n_tiles, tl.num_programs(0),
                          num_stages=STAGES):
            r = t * TILE_ROWS + tl.arange(0, TILE_ROWS)
            rmask = r < rows
            r64 = r.to(tl.int64)
            x_row = x_ptr + r64[:, None] * stride_x
            o_row = o_ptr + r64[:, None] * stride_o
            if N_CHUNKS == 1:
                cmask = c < D
                m = rmask[:, None] & cmask[None, :]
                x = tl.load(x_row + c[None, :], mask=m, other=0.0).to(tl.float32)
                inv = 1.0 / tl.sqrt(tl.sum(x * x, axis=1) / D + eps)
                s = tl.load(s_ptr + c, mask=cmask, other=0.0).to(tl.float32)
                y = x * inv[:, None] * s[None, :]
                tl.store(o_row + c[None, :], y.to(o_ptr.dtype.element_ty), mask=m)
            else:
                ssq = tl.zeros((TILE_ROWS,), dtype=tl.float32)
                for j in tl.static_range(N_CHUNKS):
                    cc = j * CHUNK + c
                    m = rmask[:, None] & (cc < D)[None, :]
                    x = tl.load(x_row + cc[None, :], mask=m, other=0.0,
                                eviction_policy="evict_last").to(tl.float32)
                    ssq += tl.sum(x * x, axis=1)
                inv = 1.0 / tl.sqrt(ssq / D + eps)
                for j in tl.static_range(N_CHUNKS):
                    cc = j * CHUNK + c
                    cmask = cc < D
                    m = rmask[:, None] & cmask[None, :]
                    x = tl.load(x_row + cc[None, :], mask=m, other=0.0,
                                eviction_policy="evict_first").to(tl.float32)
                    s = tl.load(s_ptr + cc, mask=cmask, other=0.0).to(tl.float32)
                    y = x * inv[:, None] * s[None, :]
                    tl.store(o_row + cc[None, :], y.to(o_ptr.dtype.element_ty), mask=m)

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
        rmsnorm.last_geometry = None
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
    g = geometry(rows, D, cfg["block_rows"], sm_count(x.device), x.element_size())
    rmsnorm.last_geometry = g
    with torch.cuda.device(x.device):
        _kernel()[(g["grid"],)](
            xr, scale, out, rows, D, xr.stride(0), out.stride(0), float(eps), g["tiles"],
            TILE_ROWS=g["tile_rows"], CHUNK=g["chunk"], N_CHUNKS=g["n_chunks"],
            STAGES=g["stages"], num_warps=g["num_warps"])
    rmsnorm.launches += 1
    return out.reshape(x.shape)


#: launches of the Triton kernel since the count was last set to 0
rmsnorm.launches = 0
#: the tiles the last call ran with (after clamping)
rmsnorm.last_config = None
#: the launch geometry of the last call (``geometry``); None on the CPU path
rmsnorm.last_geometry = None
