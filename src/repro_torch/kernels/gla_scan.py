"""RWKV-6 wkv scan — CUDA C++ kernel for Hopper (csrc/gla_scan.cu).

Replaces the TPU kernel ``_gla_kernel`` / ``gla_scan`` of the reference
package (src/repro/kernels/gla_scan.py).  The source file says what bounds
the kernel on this card and what its design does about it; this module is
the wrapper: it checks the tensors, lowers ``chunk`` to what a block can
stage, launches on PyTorch's current stream and counts the launch.
``gla_scan_plain`` is the same per-step recurrence in plain PyTorch: the
CPU path, and what the kernel is held against on the card.

The knob is the reference's ``chunk``: here the steps of ``r``/``k``/``w``
and of the block's columns of ``v`` staged in shared memory at a time.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build
from repro_torch.kernels._tiles import clamp_tile

MAX_SMEM_BYTES = 232448
#: the key dims the kernel is instantiated for (dk is padded up to one)
KEY_PADS = (8, 16, 32, 64, 128)

_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}
_ARGTYPES = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 7 + [ctypes.c_void_p]
_FN = None


def pad_key_dim(dk: int) -> int:
    for p in KEY_PADS:
        if dk <= p:
            return p
    raise ValueError(f"gla_scan kernel: key dim dk={dk} > {KEY_PADS[-1]} is not supported")


def block_cols(dk: int, dv: int) -> int:
    """Columns of the state one block owns, a thread each: a thread keeps
    ``pad_key_dim(dk)`` state values in registers (``MaxThreads`` in the
    source), so a wider ``dv`` is split over blocks."""
    dkp = pad_key_dim(dk)
    return min(dv, 1024 if dkp <= 32 else (512 if dkp <= 64 else 256))


def smem_bytes(chunk: int, dk: int, dv: int) -> int:
    """Dynamic shared memory of one block: ``r``, ``k``, ``w``, the block's
    columns of ``v`` and the bonus of ``chunk`` steps, and ``u``, fp32."""
    dkp = pad_key_dim(dk)
    return (chunk * (3 * dkp + block_cols(dk, dv) + 1) + dkp) * 4


def feasible(config: dict, shapes: dict, dtype=None) -> bool:
    """Whether ``config`` (``chunk``) can launch at ``shapes`` (``dk``,
    ``dv``): the staged steps must fit one block's shared memory."""
    dk, dv = int(shapes["dk"]), int(shapes["dv"])
    chunk = int(config["chunk"])
    return (1 <= dk <= KEY_PADS[-1] and dv >= 1 and chunk >= 1
            and smem_bytes(chunk, dk, dv) <= MAX_SMEM_BYTES)


def effective_config(chunk: int, S: int, dk: int, dv: int) -> dict:
    """The ``chunk`` a request runs with: a power of two, not above the
    request, not above the padded sequence, and feasible."""
    shapes = {"dk": dk, "dv": dv}
    return {"chunk": clamp_tile("chunk", chunk, lambda t: feasible({"chunk": t}, shapes),
                                cap=max(S, 1))}


def gla_scan_plain(r, k, v, w, u) -> torch.Tensor:
    """The kernel's recurrence in plain PyTorch, one step at a time, zero
    initial state, fp32 throughout, rounded once to ``r.dtype``; the output
    of a step uses the state before its update."""
    B, S, H, dk = r.shape
    rf, kf, vf, wf, uf = (a.float() for a in (r, k, v, w, u))
    st = torch.zeros((B, H, dk, v.shape[-1]), device=r.device)
    y = torch.empty((B, S, H, v.shape[-1]), device=r.device)
    for t in range(S):
        rt, kt, vt = rf[:, t], kf[:, t], vf[:, t]
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


def _launch(r, k, v, w, u, cfg: dict, stream: int) -> torch.Tensor:
    """Allocate the output and launch the kernel on ``stream``."""
    r, k, v, w = (t.contiguous() for t in (r, k, v, w))
    u = u.float().contiguous()
    B, S, H, dk = r.shape
    y = torch.empty_like(v)
    err = _fn()(r.data_ptr(), k.data_ptr(), v.data_ptr(), w.data_ptr(), u.data_ptr(),
                y.data_ptr(), _DTYPE_CODE[r.dtype], B, S, H, dk, v.shape[-1],
                cfg["chunk"], stream)
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
    ``gla_scan_plain``."""
    if r.dim() != 4 or k.shape != r.shape or w.shape != r.shape or v.dim() != 4 \
            or v.shape[:3] != r.shape[:3] or u.shape != (r.shape[2], r.shape[3]):
        raise ValueError("gla_scan: r, k, w must be (B, S, H, dk), v (B, S, H, dv), "
                         f"u (H, dk); got {tuple(r.shape)}, {tuple(k.shape)}, "
                         f"{tuple(v.shape)}, {tuple(w.shape)}, {tuple(u.shape)}")
    B, S, H, dk = r.shape
    cfg = effective_config(chunk, S, dk, v.shape[-1])
    gla_scan.last_config = cfg
    if r.device.type == "cpu":
        return gla_scan_plain(r, k, v, w, u)
    if r.device.type != "cuda":
        raise RuntimeError(f"gla_scan kernel: unsupported device {r.device}")
    if r.dtype not in _DTYPE_CODE or not (r.dtype == k.dtype == v.dtype == w.dtype):
        raise TypeError("gla_scan kernel: r, k, v, w must share float32 or bfloat16, "
                        f"got {r.dtype}, {k.dtype}, {v.dtype}, {w.dtype}")
    if any(t.device != r.device for t in (k, v, w, u)):
        raise RuntimeError("gla_scan kernel: tensors lie on different devices")
    with torch.cuda.device(r.device):
        y = _launch(r, k, v, w, u, cfg, torch.cuda.current_stream().cuda_stream)
    gla_scan.launches += 1
    return y


#: launches of the CUDA kernel since the count was last set to 0
gla_scan.launches = 0
#: the knobs the last call ran with (after clamping)
gla_scan.last_config = None
