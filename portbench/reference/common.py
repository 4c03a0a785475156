"""What the plain references share: float32 norms, rotary embedding, the
product policy (float32, or the controls' lower precisions) and the
precision switches of the card.

Imports nothing of the program (``portbench/tests`` checks it)."""
from __future__ import annotations

import contextlib

import torch

FP8_MAX = 448.0  # the largest finite float8_e4m3fn


def fp8(x: torch.Tensor) -> torch.Tensor:
    """``x`` rounded through float8 e4m3 with one scale for the tensor (its
    absolute maximum onto 448), back in float32."""
    x = x.float()
    scale = x.abs().amax().clamp(min=1e-30) / FP8_MAX
    return (x / scale).to(torch.float8_e4m3fn).float() * scale


class Products:
    """The matrix products of a reference: ``mm(a, b)`` in float32, or with
    both operands rounded through float8 first (``precision="fp8"``, the
    control of a bfloat16 cell), and ``cache(t)`` the stored keys and values
    read the same way.  TF32, the control of a float32 cell, is a switch of
    the card (``precision(tf32=True)``), not of these products."""

    def __init__(self, precision: str = "f32"):
        if precision not in ("f32", "fp8"):
            raise ValueError(precision)
        self.low = precision == "fp8"

    def mm(self, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
        if self.low:
            return fp8(a) @ fp8(b)
        return a.float() @ b.float()

    def cache(self, t: torch.Tensor) -> torch.Tensor:
        return fp8(t) if self.low else t.float()


@contextlib.contextmanager
def precision(tf32: bool = False):
    """float32 products on the card without TF32 (or with it, for the
    control), put back as they were on exit."""
    old = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = tf32
    torch.backends.cudnn.allow_tf32 = tf32
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = old


def rmsnorm(x: torch.Tensor, scale: torch.Tensor, eps: float) -> torch.Tensor:
    x = x.float()
    return x * torch.rsqrt(x.pow(2).mean(-1, keepdim=True) + eps) * scale.float()


def layernorm(x: torch.Tensor, scale, bias, eps: float) -> torch.Tensor:
    x = x.float()
    mu = x.mean(-1, keepdim=True)
    var = (x - mu).pow(2).mean(-1, keepdim=True)
    return (x - mu) * torch.rsqrt(var + eps) * scale.float() + bias.float()


def rope(x: torch.Tensor, positions: torch.Tensor, theta: float) -> torch.Tensor:
    """Rotate-half rotary embedding of ``x`` (N, S, heads, dh) at integer
    ``positions`` (S,)."""
    half = x.shape[-1] // 2
    freqs = theta ** (-torch.arange(half, dtype=torch.float64, device=x.device) / half)
    ang = (positions.to(torch.float64)[:, None] * freqs).float()
    cos, sin = torch.cos(ang)[None, :, None], torch.sin(ang)[None, :, None]
    a, b = x[..., :half].float(), x[..., half:].float()
    return torch.cat([a * cos - b * sin, a * sin + b * cos], dim=-1)
