"""Mamba-1 selective scan — CUDA C++ kernel for Hopper (csrc/ssm_scan.cu).

Replaces the TPU kernel ``_ssm_kernel`` / ``ssm_scan`` of the reference
package (src/repro/kernels/ssm_scan.py).  The source file says what bounds
the kernel on this card and what its design does about it; this module is
the wrapper: it checks the tensors, lowers the knobs to what a block can
run, launches on PyTorch's current stream and counts the launch.
``ssm_scan_plain`` is the same per-step recurrence in plain PyTorch: the
CPU path, and what the kernel is held against on the card.

The knobs are the reference's, so that TuningDB records keep their
meaning: ``block_d`` channels (one thread each) per block, and ``chunk``
steps of ``B``/``C`` staged in shared memory at a time.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build
from repro_torch.kernels._tiles import clamp_tile

MAX_SMEM_BYTES = 232448
#: the state sizes the kernel is instantiated for (N is padded up to one)
STATE_PADS = (4, 8, 16, 32, 64)

_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}
_ARGTYPES = [ctypes.c_void_p] * 7 + [ctypes.c_int] * 7 + [ctypes.c_void_p]
_FN = None


def pad_state(N: int) -> int:
    for p in STATE_PADS:
        if N <= p:
            return p
    raise ValueError(f"ssm_scan kernel: state size N={N} > {STATE_PADS[-1]} "
                     "is not supported")


def max_threads(N: int) -> int:
    """Threads a block may have: each keeps 2 * pad_state(N) registers of
    state and of ``A``'s row (``MaxThreads`` in the source)."""
    np_ = pad_state(N)
    return 1024 if np_ <= 8 else (512 if np_ <= 16 else 256)


def smem_bytes(chunk: int, N: int) -> int:
    """Dynamic shared memory of one block: ``B_t`` and ``C_t`` of ``chunk``
    steps, fp32."""
    return 2 * chunk * pad_state(N) * 4


def feasible(config: dict, shapes: dict, dtype=None) -> bool:
    """Whether ``config`` (``chunk``, ``block_d``) can launch at ``shapes``
    (``N``): thread, register and shared-memory limits of one block."""
    N = int(shapes["N"])
    if not 1 <= N <= STATE_PADS[-1]:
        return False
    chunk, block_d = int(config["chunk"]), int(config["block_d"])
    return (chunk >= 1 and 1 <= block_d <= max_threads(N)
            and smem_bytes(chunk, N) <= MAX_SMEM_BYTES)


def effective_config(chunk: int, block_d: int, S: int, D: int, N: int) -> dict:
    """The knobs a request runs with: powers of two, not above the request,
    not above the padded extent, and feasible."""
    shapes = {"N": N}
    c = clamp_tile("chunk", chunk,
                   lambda t: feasible({"chunk": t, "block_d": 1}, shapes), cap=max(S, 1))
    bd = clamp_tile("block_d", block_d,
                    lambda t: feasible({"chunk": c, "block_d": t}, shapes), cap=max(D, 1))
    return {"chunk": c, "block_d": bd}


def ssm_scan_plain(x, dt, A, B_in, C_in, D_skip) -> torch.Tensor:
    """The kernel's recurrence in plain PyTorch, one step at a time, zero
    initial state, fp32 throughout, rounded once to ``x.dtype``."""
    Bb, S, D = x.shape
    xf, dtf = x.float(), dt.float()
    Bf, Cf, Af = B_in.float(), C_in.float(), A.float()
    h = torch.zeros((Bb, D, A.shape[1]), device=x.device)
    y = torch.empty((Bb, S, D), device=x.device)
    for t in range(S):
        h = torch.exp(dtf[:, t, :, None] * Af) * h \
            + (dtf[:, t] * xf[:, t])[..., None] * Bf[:, t, None, :]
        y[:, t] = (h * Cf[:, t, None, :]).sum(dim=-1)
    return (y + D_skip.float() * xf).to(x.dtype)


def _fn():
    global _FN
    if _FN is None:
        fn = _build.load("ssm_scan").ssm_scan_fwd
        fn.argtypes = _ARGTYPES
        fn.restype = ctypes.c_int
        _FN = fn
    return _FN


def _launch(x, dt, A, B_in, C_in, D_skip, cfg: dict, stream: int) -> torch.Tensor:
    """Allocate the output and launch the kernel on ``stream``."""
    x, dt, B_in, C_in = (t.contiguous() for t in (x, dt, B_in, C_in))
    A, D_skip = A.float().contiguous(), D_skip.float().contiguous()
    Bb, S, D = x.shape
    y = torch.empty_like(x)
    err = _fn()(x.data_ptr(), dt.data_ptr(), A.data_ptr(), B_in.data_ptr(),
                C_in.data_ptr(), D_skip.data_ptr(), y.data_ptr(), _DTYPE_CODE[x.dtype],
                Bb, S, D, A.shape[1], cfg["chunk"], cfg["block_d"], stream)
    _build.check(err, "ssm_scan")
    return y


def ssm_scan(
    x: torch.Tensor,  # (B, S, D)
    dt: torch.Tensor,  # (B, S, D)
    A: torch.Tensor,  # (D, N)
    B_in: torch.Tensor,  # (B, S, N)
    C_in: torch.Tensor,  # (B, S, N)
    D_skip: torch.Tensor,  # (D,)
    *,
    chunk: int = 128,
    block_d: int = 256,
) -> torch.Tensor:
    """Returns y (B, S, D) in ``x.dtype``.  Zero initial state.  CUDA
    tensors go through the kernel (or raise); CPU tensors take
    ``ssm_scan_plain``."""
    if x.dim() != 3 or dt.shape != x.shape or A.dim() != 2 or D_skip.dim() != 1:
        raise ValueError("ssm_scan: x, dt must be (B, S, D), A (D, N), D_skip (D,); got "
                         f"{tuple(x.shape)}, {tuple(dt.shape)}, {tuple(A.shape)}, "
                         f"{tuple(D_skip.shape)}")
    Bb, S, D = x.shape
    N = A.shape[1]
    if A.shape[0] != D or D_skip.shape[0] != D or B_in.shape != (Bb, S, N) \
            or C_in.shape != (Bb, S, N):
        raise ValueError(f"ssm_scan: shapes do not fit: x {tuple(x.shape)}, A "
                         f"{tuple(A.shape)}, B {tuple(B_in.shape)}, C {tuple(C_in.shape)}")
    cfg = effective_config(chunk, block_d, S, D, N)
    ssm_scan.last_config = cfg
    if x.device.type == "cpu":
        return ssm_scan_plain(x, dt, A, B_in, C_in, D_skip)
    if x.device.type != "cuda":
        raise RuntimeError(f"ssm_scan kernel: unsupported device {x.device}")
    if x.dtype not in _DTYPE_CODE or not (x.dtype == dt.dtype == B_in.dtype == C_in.dtype):
        raise TypeError("ssm_scan kernel: x, dt, B, C must share float32 or bfloat16, "
                        f"got {x.dtype}, {dt.dtype}, {B_in.dtype}, {C_in.dtype}")
    if any(t.device != x.device for t in (dt, A, B_in, C_in, D_skip)):
        raise RuntimeError("ssm_scan kernel: tensors lie on different devices")
    with torch.cuda.device(x.device):
        y = _launch(x, dt, A, B_in, C_in, D_skip, cfg,
                    torch.cuda.current_stream().cuda_stream)
    ssm_scan.launches += 1
    return y


#: launches of the CUDA kernel since the count was last set to 0
ssm_scan.launches = 0
#: the knobs the last call ran with (after clamping)
ssm_scan.last_config = None
