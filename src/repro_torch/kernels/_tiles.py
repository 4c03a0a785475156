"""What the kernel wrappers share: tile-request handling and tensor checks."""
from __future__ import annotations

from typing import Callable


def pow2_floor(n: int) -> int:
    """Largest power of two <= n (n >= 1)."""
    return 1 << (int(n).bit_length() - 1)


def pow2_ceil(n: int) -> int:
    """Smallest power of two >= n (n >= 1)."""
    return 1 << max(0, int(n) - 1).bit_length()


def check_request(name: str, value) -> int:
    """A tile request must be a positive integer; anything else raises."""
    if isinstance(value, bool) or not isinstance(value, int) or value < 1:
        raise ValueError(f"{name} must be a positive integer, got {value!r}")
    return value


def clamp_tile(name: str, request, ok: Callable[[int], bool], *,
               cap: int = 0, floor: int = 1) -> int:
    """Lower a tile request to the largest power of two that is not above
    it, not above ``cap`` (when given: the padded extent of the data) and
    for which ``ok`` holds.  A request below the kernel's smallest tile is
    raised to ``floor``.  Raises when even ``floor`` is not feasible."""
    t = pow2_floor(check_request(name, request))
    if cap:
        t = min(t, pow2_ceil(cap))
    t = max(t, floor)
    while t > floor and not ok(t):
        t //= 2
    if not ok(t):
        raise ValueError(f"no feasible {name} for this shape (tried down to {t})")
    return t


def pad_head_dim(d: int, kernel: str) -> int:
    """The head dim the CUDA kernels are instantiated for: ``d`` rounded up
    to 16, 32, 64 or 128."""
    for p in (16, 32, 64, 128):
        if d <= p:
            return p
    raise ValueError(f"{kernel} kernel: head dim {d} > 128 is not supported")


def last_dim_contiguous(t):
    """The kernels take any strides but a unit one in the last dimension."""
    return t if t.stride(-1) == 1 else t.contiguous()
