"""RWKV-6 wkv scan — CUDA C++ kernel for Hopper (csrc/gla_scan.cu).

Replaces the TPU kernel ``_gla_kernel`` / ``gla_scan`` of the reference
package (src/repro/kernels/gla_scan.py).  The source file says what bounds
the kernel on this card and what its design does about it; this module is
the wrapper: it checks the tensors, lowers ``chunk`` to what a block can
stage, chooses the split, launches on PyTorch's current stream and counts
the launch.
``gla_scan_plain`` is the same per-step recurrence in plain PyTorch: the
CPU path, and what the kernel is held against on the card.

The knob is the reference's ``chunk``: here the steps of ``r``/``k``/``w``
staged in shared memory at a time (double-buffered).  What the wrapper
chooses itself, from the shapes and the SM count (``split``), is how the
state is cut: 8 rows of a column a lane (``lanes_for``) and the columns a
block owns (``block_cols``), so that one call puts at least two blocks on
every SM.  ``gla_scan.last_split`` records the choice.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build
from repro_torch.kernels._tiles import clamp_tile, lane_index, reduce_lanes, sm_count

MAX_SMEM_BYTES = 232448
#: the key dims the kernel is instantiated for (dk is padded up to one)
KEY_PADS = (8, 16, 32, 64, 128)
#: rows of the state a lane keeps, per instantiation (lanes = padded dk / this)
LANE_ROWS = (4, 8)
#: columns of the state a thread keeps (``CT`` in the source)
THREAD_COLS = 4
#: columns of the state a block may own, and threads a block may have
COL_CHOICES = (64, 32, 16, 8)
MAX_THREADS = 512
#: shared memory of one SM, and what the runtime reserves for each block
SMEM_PER_SM = 233472
SMEM_PER_BLOCK_RESERVED = 1024

_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}
_ARGTYPES = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 9 + [ctypes.c_void_p]
_FN = None


def pad_key_dim(dk: int) -> int:
    for p in KEY_PADS:
        if dk <= p:
            return p
    raise ValueError(f"gla_scan kernel: key dim dk={dk} > {KEY_PADS[-1]} is not supported")


def lanes_for(dk: int, few_warps: bool = False) -> int:
    """Lanes a column of the state is split over: 8 rows a lane, or 4 when
    its SM would hold ``few_warps`` of the block (twice the warps to hide
    latency with)."""
    return max(1, pad_key_dim(dk) // (4 if few_warps else 8))


def smem_bytes(chunk: int, dk: int, cols: int = COL_CHOICES[-1]) -> int:
    """Dynamic shared memory of one block: ``r``, ``k``, ``w`` and the
    block's ``cols`` columns of ``v`` for ``chunk`` steps, double-buffered
    in fp32 (in bf16 one bf16 buffer and its fp32 copy, 3/4 of that)."""
    return 2 * chunk * (3 * pad_key_dim(dk) + cols) * 4


def resident(chunk: int, dk: int, cols: int, lanes: int) -> int:
    """Blocks of this split one SM holds at once, by shared memory, threads
    and registers (at most 128 a thread)."""
    threads = -(-cols // THREAD_COLS * lanes // 32) * 32
    return max(0, min(SMEM_PER_SM // (smem_bytes(chunk, dk, cols) + SMEM_PER_BLOCK_RESERVED),
                      2048 // threads, 65536 // (128 * threads), 32))


def block_cols(B: int, H: int, dk: int, dv: int, sms: int, chunk: int) -> int:
    """Columns of the state one block owns.  Every block walks the whole
    sequence, so a second wave of blocks doubles the time: the rule takes
    the fewest waves (blocks over what the SMs hold at once, ``resident``),
    then a block on every SM (``blocks >= sms``), then the fewest blocks
    (the least re-staging of r/k/w).  Only splits that launch are
    considered: no more columns than ``dv`` needs, than ``MAX_THREADS``
    allow, or than fit the block's shared memory at this ``chunk``.

    The second key, a block on every SM, is a rule, not a measured time:
    on an H100 at RWKV-6 3B's width (B=2, H=40, dk=dv=64) and chunk 64 it
    picks 160 blocks of 32 columns, and one block a head (80 blocks of 64
    columns, also one wave) ran faster.  Ranking the splits of one wave by
    their measured time is open work."""
    lanes = lanes_for(dk)
    cap = min(MAX_THREADS * THREAD_COLS // lanes, max(8, 1 << max(0, dv - 1).bit_length()))
    fits = [c for c in COL_CHOICES
            if c <= cap and smem_bytes(chunk, dk, c) <= MAX_SMEM_BYTES] or [COL_CHOICES[-1]]

    def key(c):
        blocks = B * H * -(-dv // c)
        waves = -(-blocks // (max(1, resident(chunk, dk, c, lanes)) * sms))
        return waves, blocks < sms, blocks

    return min(fits, key=key)


def split(B: int, H: int, dk: int, dv: int, sms: int, chunk: int) -> dict:
    """What one call launches: lanes a column, columns a block, blocks and
    threads a block (a pure function of the shapes, the SM count and the
    staging depth).  A block that would be one warp, or that its SM holds
    alone, gets twice the lanes (``lanes_for``), so that the SM has twice
    the warps."""
    cols = block_cols(B, H, dk, dv, sms, chunk)
    lanes = lanes_for(dk)
    few = cols // THREAD_COLS * lanes <= 32 or resident(chunk, dk, cols, lanes) < 2
    lanes = lanes_for(dk, few_warps=few)
    return {"lanes": lanes, "cols": cols, "blocks": B * H * -(-dv // cols),
            "threads": -(-cols // THREAD_COLS * lanes // 32) * 32}


def feasible(config: dict, shapes: dict, dtype=None) -> bool:
    """Whether ``config`` (``chunk``) can launch at ``shapes`` (``dk``,
    ``dv``): the staged steps must fit one block's shared memory at the
    fewest columns a block may own (``block_cols`` never picks more than
    fit)."""
    dk, dv = int(shapes["dk"]), int(shapes["dv"])
    chunk = int(config["chunk"])
    return (1 <= dk <= KEY_PADS[-1] and dv >= 1 and chunk >= 1
            and smem_bytes(chunk, dk) <= MAX_SMEM_BYTES)


def effective_config(chunk: int, S: int, dk: int, dv: int) -> dict:
    """The ``chunk`` a request runs with: a power of two, not above the
    request, not above the padded sequence, and feasible."""
    shapes = {"dk": dk, "dv": dv}
    return {"chunk": clamp_tile("chunk", chunk, lambda t: feasible({"chunk": t}, shapes),
                                cap=max(S, 1))}


def gla_scan_plain(r, k, v, w, u, *, lanes: int = 1) -> torch.Tensor:
    """The kernel's recurrence in plain PyTorch, one step at a time, zero
    initial state, fp32 throughout, rounded once to ``r.dtype``; the output
    of a step uses the state before its update.  With ``lanes > 1`` the key
    dim is cut as the kernel cuts it (``lane_index``): each lane's partial
    ``sum_i r_i (S_ij + u_i k_i v_j)`` over its rows, summed as the kernel
    sums a thread's ``THREAD_COLS`` columns (``reduce_lanes``)."""
    B, S, H, dk = r.shape
    dv = v.shape[-1]
    rf, kf, vf, wf, uf = (a.float() for a in (r, k, v, w, u))
    if lanes > 1:  # pad the key dim with r = k = w = u = 0, as the kernel stages it
        pad = pad_key_dim(dk) - dk
        rf, kf, wf, uf = (torch.nn.functional.pad(a, (0, pad)) for a in (rf, kf, wf, uf))
        rows = lane_index(pad_key_dim(dk), lanes).to(r.device)
    st = torch.zeros((B, H, rf.shape[-1], dv), device=r.device)
    y = torch.empty((B, S, H, dv), device=r.device)
    for t in range(S):
        rt, kt, vt = rf[:, t], kf[:, t], vf[:, t]
        if lanes > 1:
            q = st + (uf * kt)[..., None] * vt[:, :, None, :]
            parts = (rt[..., None] * q)[:, :, rows].sum(dim=3)  # (B, H, lanes, dv)
            # a thread's THREAD_COLS columns are summed over its lanes together
            parts = torch.nn.functional.pad(parts, (0, -dv % THREAD_COLS)).movedim(2, 0)
            parts = parts.unflatten(-1, (-1, THREAD_COLS)).movedim(-1, 1)  # (lanes, CT, B, H, groups)
            y[:, t] = reduce_lanes(parts, THREAD_COLS).movedim(0, -1).flatten(-2)[..., :dv]
        else:
            bonus = (rt * uf * kt).sum(dim=-1)
            y[:, t] = (rt[..., None] * st).sum(dim=2) + bonus[..., None] * vt
        st = wf[:, t, :, :, None] * st + kt[..., None] * vt[:, :, None, :]
    return y.to(r.dtype)


def _fn():
    global _FN
    if _FN is None:
        fn = _build.load("gla_scan").gla_scan_fwd
        fn.argtypes = _ARGTYPES
        fn.restype = ctypes.c_int
        _FN = fn
    return _FN


def resident_blocks(dtype, dk: int, chunk: int, lanes: int, cols: int) -> int:
    """Blocks of a launch with this split that one SM holds at once (CUDA's
    occupancy query for the instantiated kernel; launches nothing)."""
    fn = _build.load("gla_scan").gla_scan_occupancy
    fn.argtypes = [ctypes.c_int] * 5 + [ctypes.POINTER(ctypes.c_int)]
    out = ctypes.c_int(0)
    _build.check(fn(_DTYPE_CODE[dtype], dk, chunk, lanes, cols, ctypes.byref(out)),
                 "gla_scan occupancy")
    return out.value


def _launch(r, k, v, w, u, cfg: dict, lanes: int, cols: int, stream: int) -> torch.Tensor:
    """Allocate the output and launch the kernel on ``stream`` with the
    given split (``lanes`` a column, ``cols`` columns a block)."""
    r, k, v, w = (t.contiguous() for t in (r, k, v, w))
    u = u.float().contiguous()
    B, S, H, dk = r.shape
    y = torch.empty_like(v)
    err = _fn()(r.data_ptr(), k.data_ptr(), v.data_ptr(), w.data_ptr(), u.data_ptr(),
                y.data_ptr(), _DTYPE_CODE[r.dtype], B, S, H, dk, v.shape[-1],
                cfg["chunk"], lanes, cols, stream)
    _build.check(err, "gla_scan")
    return y


def gla_scan(
    r: torch.Tensor,  # (B, S, H, dk)
    k: torch.Tensor,  # (B, S, H, dk)
    v: torch.Tensor,  # (B, S, H, dv)
    w: torch.Tensor,  # (B, S, H, dk) decay in (0, 1)
    u: torch.Tensor,  # (H, dk)
    *,
    chunk: int = 128,
) -> torch.Tensor:
    """Returns y (B, S, H, dv) in ``r.dtype``.  Zero initial state.  CUDA
    tensors go through the kernel (or raise); CPU tensors take
    ``gla_scan_plain``.  On the card the wrapper chooses the split
    (``split``: lanes a column, columns a block, from the shapes and the SM
    count) and records it in ``gla_scan.last_split``."""
    if r.dim() != 4 or k.shape != r.shape or w.shape != r.shape or v.dim() != 4 \
            or v.shape[:3] != r.shape[:3] or u.shape != (r.shape[2], r.shape[3]):
        raise ValueError("gla_scan: r, k, w must be (B, S, H, dk), v (B, S, H, dv), "
                         f"u (H, dk); got {tuple(r.shape)}, {tuple(k.shape)}, "
                         f"{tuple(v.shape)}, {tuple(w.shape)}, {tuple(u.shape)}")
    B, S, H, dk = r.shape
    cfg = effective_config(chunk, S, dk, v.shape[-1])
    gla_scan.last_config = cfg
    if r.device.type == "cpu":
        gla_scan.last_split = None
        return gla_scan_plain(r, k, v, w, u)
    if r.device.type != "cuda":
        raise RuntimeError(f"gla_scan kernel: unsupported device {r.device}")
    if r.dtype not in _DTYPE_CODE or not (r.dtype == k.dtype == v.dtype == w.dtype):
        raise TypeError("gla_scan kernel: r, k, v, w must share float32 or bfloat16, "
                        f"got {r.dtype}, {k.dtype}, {v.dtype}, {w.dtype}")
    if any(t.device != r.device for t in (k, v, w, u)):
        raise RuntimeError("gla_scan kernel: tensors lie on different devices")
    sp = split(B, H, dk, v.shape[-1], sm_count(r.device), cfg["chunk"])
    gla_scan.last_split = sp
    with torch.cuda.device(r.device):
        y = _launch(r, k, v, w, u, cfg, sp["lanes"], sp["cols"],
                    torch.cuda.current_stream().cuda_stream)
    gla_scan.launches += 1
    return y


#: launches of the CUDA kernel since the count was last set to 0
gla_scan.launches = 0
#: the knobs the last call ran with (after clamping)
gla_scan.last_config = None
#: the split the last call launched (``split``); None on the CPU path
gla_scan.last_split = None
