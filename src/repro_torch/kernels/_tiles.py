"""What the kernel wrappers share: tile-request handling, tensor checks,
the SM count, and the scans' lane split as their plain versions repeat it."""
from __future__ import annotations

from typing import Callable, Dict

_SMS: Dict[int, int] = {}


def sm_count(dev) -> int:
    """Streaming multiprocessors of a CUDA device (memoised): what the
    wrappers' split rules fill."""
    import torch

    idx = dev.index if dev.index is not None else torch.cuda.current_device()
    if idx not in _SMS:
        _SMS[idx] = torch.cuda.get_device_properties(idx).multi_processor_count
    return _SMS[idx]


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


def lane_index(padded: int, lanes: int):
    """Which of ``padded`` state rows each of ``lanes`` lanes keeps in the
    scan kernels, ``(lanes, padded / lanes)``: lane ``l`` keeps rows
    ``4 (lanes m + l) + q`` (``q < 4``), so that the lanes of one column read
    neighbouring 16-byte words."""
    import torch

    m, q = torch.arange(padded // lanes // 4)[:, None], torch.arange(4)[None, :]
    return torch.stack([(4 * (lanes * m + lane) + q).reshape(-1) for lane in range(lanes)])


def reduce_lanes(parts, ct: int = 1):
    """The kernels' sum over lanes, ``parts`` ``(lanes, ct, ...)`` ->
    ``(ct, ...)``, in their order: a reduce-scatter over the lanes lane ^
    off (off = lanes/2 .. 1) -- while a lane holds more than one of its
    ``ct`` columns, a round halves them (a lane keeps one half and adds its
    partner's share of it) -- then butterfly rounds, ``x + shfl_xor(x,
    off)``.  With ``ct`` 1 it is a butterfly."""
    import torch

    lanes = parts.shape[0]
    a = parts.clone()
    lane = torch.arange(lanes, device=parts.device)
    first = [0] * lanes
    n, off = ct, lanes // 2
    while off:
        if n > 1:
            half = n // 2
            hi = ((lane & off) != 0).view(-1, *([1] * (a.dim() - 1)))
            send = torch.where(hi, a[:, :half], a[:, half:n])
            keep = torch.where(hi, a[:, half:n], a[:, :half])
            a[:, :half] = keep + send[lane ^ off]
            first = [f + (half if lo & off else 0) for lo, f in enumerate(first)]
            n = half
        else:
            a[:, 0] = a[:, 0] + a[lane ^ off, 0]
        off //= 2
    out = torch.empty_like(parts[0])
    for lo in range(lanes):
        out[first[lo]:first[lo] + n] = a[lo, :n]
    return out
