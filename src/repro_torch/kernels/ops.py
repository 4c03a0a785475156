"""Public kernel API: implementation dispatch and TuningDB consult.

``impl``:
  * ``"ref"``    — pure-PyTorch oracle (differentiable).
  * ``"cuda"``   — the hand-written Hopper kernel (CUDA C++ or Triton).  A
                   CUDA tensor launches it or raises; a CPU tensor takes the
                   kernel's plain PyTorch version, for the CPU tests.
  * ``"chunked"``— chunked oracle form.

Kernel forward passes pair with an oracle-recompute backward
(``_ref_vjp``): the standard remat-style pairing that keeps the graph
differentiable while the forward hot-spot runs the hand-written kernel.

Eager PyTorch has no trace time, so ``_tuned`` is reached on every call.
The resolved config is memoised per ``(db, kernel, dims, defaults)``: the
steady-state cost is one dict lookup and the DB is consulted once per
distinct call shape.  Building a step anew (``serve_step._with_db``) drops
the memo of its DB, so records added since are picked up then, never in
the middle of a step's life.
"""
from __future__ import annotations

import functools
import weakref
from typing import Optional

import torch

from repro_torch.kernels import decode_attention as _decode_mod
from repro_torch.kernels import flash_attention as _flash_mod
from repro_torch.kernels import gla_scan as _gla_mod
from repro_torch.kernels import rmsnorm as _rms_mod
from repro_torch.kernels import ssm_scan as _ssm_mod
from repro_torch.kernels import ref

_VALID_IMPLS = ("ref", "cuda", "chunked")

_MEMO: "weakref.WeakKeyDictionary" = weakref.WeakKeyDictionary()


def _check_impl(impl: str) -> None:
    if impl == "pallas":
        raise ValueError("impl='pallas' names the reference's TPU kernels; "
                         "this package's hand-written kernels are impl='cuda'")
    if impl not in _VALID_IMPLS:
        raise ValueError(f"unknown impl {impl!r}; one of {_VALID_IMPLS}")


def forget_tuned(db=None) -> None:
    """Drop the memoised configs of ``db`` (of every DB when ``None``)."""
    if db is None:
        _MEMO.clear()
    else:
        _MEMO.pop(db, None)


def _tuned(db, kernel: str, dims: dict, defaults: dict) -> dict:
    """Best-known tile config for this kernel at these call shapes, else
    the caller's heuristic defaults.  ``db=None`` — the default everywhere —
    returns ``defaults`` untouched and consults nothing."""
    if db is None:
        return defaults
    memo = _MEMO.setdefault(db, {})
    key = (kernel, tuple(sorted(dims.items())), tuple(sorted(defaults.items())))
    hit = memo.get(key)
    if hit is None:
        cfg = db.kernel_config(kernel, dims)
        hit = memo[key] = (defaults if not cfg else
                           {k: int(cfg.get(k, v)) for k, v in defaults.items()})
    return hit


class _RefVJP(torch.autograd.Function):
    """Kernel forward, reference-recompute backward."""

    @staticmethod
    def forward(ctx, kernel_fn, ref_fn, *args):
        ctx.ref_fn = ref_fn
        ctx.save_for_backward(*args)
        return kernel_fn(*args)

    @staticmethod
    def backward(ctx, g):
        args = [a.detach().requires_grad_(a.is_floating_point())
                for a in ctx.saved_tensors]
        with torch.enable_grad():
            out = ctx.ref_fn(*args)
        wanted = [a for a, need in zip(args, ctx.needs_input_grad[2:]) if need]
        grads = iter(torch.autograd.grad(out, wanted, g, allow_unused=True))
        return (None, None, *(next(grads) if need else None
                              for need in ctx.needs_input_grad[2:]))


def _ref_vjp(kernel_fn, ref_fn):
    def fn(*args):
        if torch.is_grad_enabled() and any(a.requires_grad for a in args):
            return _RefVJP.apply(kernel_fn, ref_fn, *args)
        return kernel_fn(*args)

    return fn


# ---------------------------------------------------------------------------
# Attention
# ---------------------------------------------------------------------------


def attention(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    *,
    causal: bool = True,
    window: Optional[int] = None,
    scale: Optional[float] = None,
    impl: str = "ref",
    block_q: int = 128,
    block_kv: int = 128,
    unroll: bool = False,
    prune: bool = False,
    db=None,
) -> torch.Tensor:
    """(B,Sq,H,dh) x (B,Sk,K,dh) -> (B,Sq,H,dv)."""
    _check_impl(impl)
    if impl == "ref":
        return ref.attention_ref(q, k, v, causal=causal, window=window, scale=scale)
    B, Sq, H, dh = q.shape
    _, Sk, K, _ = k.shape
    t = _tuned(db, "flash_attention",
               {"B": B, "Sq": Sq, "Sk": Sk, "H": H, "K": K, "dh": dh},
               {"block_q": block_q, "block_kv": block_kv})
    block_q, block_kv = t["block_q"], t["block_kv"]
    if impl == "chunked":
        return ref.attention_chunked_ref(
            q, k, v, causal=causal, window=window, scale=scale,
            block_q=block_q, unroll=unroll, prune=prune,
        )
    kernel_fn = functools.partial(
        _flash_mod.flash_attention, causal=causal, window=window, scale=scale,
        block_q=block_q, block_kv=block_kv,
    )
    ref_fn = functools.partial(
        ref.attention_ref, causal=causal, window=window, scale=scale
    )
    return _ref_vjp(kernel_fn, ref_fn)(q, k, v)


def decode_attention(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    lengths: torch.Tensor,
    *,
    scale: Optional[float] = None,
    impl: str = "ref",
    block_kv: int = 512,
    db=None,
) -> torch.Tensor:
    """(B,H,dh) x (B,Smax,K,dh) cache + (B,) lengths -> (B,H,dh).  The cache
    may be bf16 under an fp32 query."""
    _check_impl(impl)
    if impl in ("ref", "chunked"):
        return ref.decode_attention_ref(q, k, v, lengths, scale=scale)
    B, H, dh = q.shape
    _, Smax, K, _ = k.shape
    block_kv = _tuned(db, "decode_attention",
                      {"B": B, "H": H, "K": K, "dh": dh, "Smax": Smax},
                      {"block_kv": block_kv})["block_kv"]
    return _decode_mod.decode_attention(
        q, k, v, lengths, scale=scale, block_kv=block_kv
    )


# ---------------------------------------------------------------------------
# RMSNorm
# ---------------------------------------------------------------------------


def rmsnorm(
    x: torch.Tensor,
    scale: torch.Tensor,
    eps: float = 1e-5,
    *,
    impl: str = "ref",
    block_rows: int = 256,
    db=None,
) -> torch.Tensor:
    _check_impl(impl)
    if impl in ("ref", "chunked"):
        return ref.rmsnorm_ref(x, scale, eps)
    rows = 1
    for d in x.shape[:-1]:
        rows *= int(d)
    block_rows = _tuned(db, "rmsnorm", {"rows": rows, "D": x.shape[-1]},
                        {"block_rows": block_rows})["block_rows"]
    kernel_fn = functools.partial(_rms_mod.rmsnorm, eps=eps, block_rows=block_rows)
    ref_fn = functools.partial(ref.rmsnorm_ref, eps=eps)
    return _ref_vjp(kernel_fn, ref_fn)(x, scale)


# ---------------------------------------------------------------------------
# Scans
# ---------------------------------------------------------------------------


def ssm_scan(
    x: torch.Tensor,
    dt: torch.Tensor,
    A: torch.Tensor,
    B_in: torch.Tensor,
    C_in: torch.Tensor,
    D_skip: torch.Tensor,
    *,
    impl: str = "chunked",
    chunk: int = 128,
    block_d: int = 256,
    db=None,
) -> torch.Tensor:
    """Selective scan, zero init state.  Returns y (B,S,D)."""
    _check_impl(impl)
    if impl == "ref":
        return ref.ssm_scan_ref(x, dt, A, B_in, C_in, D_skip)[0]
    B, S, D = x.shape
    t = _tuned(db, "ssm_scan",
               {"B": B, "S": S, "D": D, "N": A.shape[-1]},
               {"chunk": chunk, "block_d": block_d})
    chunk, block_d = t["chunk"], t["block_d"]
    if impl == "chunked":
        return ref.ssm_scan_chunked_ref(x, dt, A, B_in, C_in, D_skip, chunk=chunk)[0]
    kernel_fn = functools.partial(_ssm_mod.ssm_scan, chunk=chunk, block_d=block_d)
    ref_fn = lambda *a: ref.ssm_scan_chunked_ref(*a, chunk=chunk)[0]
    return _ref_vjp(kernel_fn, ref_fn)(x, dt, A, B_in, C_in, D_skip)


def gla_scan(
    r: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    w: torch.Tensor,
    u: torch.Tensor,
    *,
    impl: str = "chunked",
    chunk: int = 64,
    db=None,
) -> torch.Tensor:
    """RWKV-6 wkv scan, zero init state.  Returns y (B,S,H,dv)."""
    _check_impl(impl)
    if impl == "ref":
        return ref.gla_scan_ref(r, k, v, w, u)[0]
    B, S, H, dk = k.shape
    chunk = _tuned(db, "gla_scan",
                   {"B": B, "S": S, "H": H, "dk": dk, "dv": v.shape[-1]},
                   {"chunk": chunk})["chunk"]
    if impl == "chunked":
        return ref.gla_scan_chunked_ref(r, k, v, w, u, chunk=chunk)[0]
    kernel_fn = functools.partial(_gla_mod.gla_scan, chunk=chunk)
    ref_fn = lambda *a: ref.gla_scan_chunked_ref(*a, chunk=chunk)[0]
    return _ref_vjp(kernel_fn, ref_fn)(r, k, v, w, u)
