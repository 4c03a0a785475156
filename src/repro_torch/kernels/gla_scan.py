"""RWKV-6 wkv scan — CUDA C++ kernel for Hopper (csrc/gla_scan.cu).

Replaces the TPU kernel ``_gla_kernel`` / ``gla_scan`` of the reference
package (src/repro/kernels/gla_scan.py).  The source file says what bounds
the kernel on this card and what its design does about it; this module is
the wrapper: it checks the tensors, lowers ``chunk`` to what a block can
stage, chooses the split, launches on PyTorch's current stream and counts
the launch.
``gla_scan_plain`` is the same per-step recurrence in plain PyTorch: the
CPU path, and what the kernel is held against on the card.

The decay ``w`` may be float32 beside bfloat16 ``r``, ``k``, ``v`` (the
kernel ``gla_state_kernel``): a decay near 1 does not survive bf16
(0.9975 becomes 0.9961, and the error compounds along the sequence).
``gla_scan_state`` is that kernel with the state after the last token
stored, f32, into a buffer the caller hands in (the served prefill's
cache); its launches count in ``gla_scan_state.launches``, apart from the
training forward's ``gla_scan.launches``.

The knob is the reference's ``chunk``: here the steps of ``r``/``k``/``w``
staged in shared memory at a time (double-buffered).  What the wrapper
chooses itself, from the shapes and the SM count (``split``), is how the
state is cut: 8 rows of a column a lane (``lanes_for``) and the columns a
block owns (``block_cols``), so that one call puts at least two blocks on
every SM.  ``gla_scan.last_split`` records the choice.

``gla_scan_bwd`` is the gradient (csrc/gla_scan_bwd.cu, three kernels a
call: the states at the chunks' boundaries, every (batch, head, chunk)
tile, the ordered sum of ``du``); ``gla_scan_bwd_plain`` is its arithmetic
in plain PyTorch.  Its chunk (``bwd_chunk``) follows from the shapes alone.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build
from repro_torch.kernels._tiles import clamp_tile, lane_index, pow2_ceil, reduce_lanes, sm_count

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
_STATE_ARGTYPES = [ctypes.c_void_p] * 7 + [ctypes.c_int] * 9 + [ctypes.c_void_p]
_FN = None
_STATE_FN = None

#: the gradient's kernels take dk and dv up to this; a tile at most this many tokens
BWD_MAX_DIM = 128
BWD_MAX_CHUNK = 32
#: below this the decay's log is clamped (the chunked oracle's ``clamp``)
MIN_DECAY = 1e-30
_BWD_ARGTYPES = [ctypes.c_void_p] * 14 + [ctypes.c_int] * 7 + [ctypes.c_void_p]
_BWD_FN = None


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


def state_chunk(B: int, H: int, dk: int, dv: int, sms: int, chunk: int) -> int:
    """The staging depth ``gla_scan_state`` runs with: of the powers of two
    up to ``chunk`` (the request, as ``effective_config`` clamps it), the
    one whose split (``split``) puts its blocks on the SMs in the fewest
    waves (``resident`` blocks an SM), the deepest among those.  A served
    prefill has many more blocks than SMs, and a shallower staging holds
    more of them on an SM: on an H100 at B=64, S=2,048, H=40, dk=dv=64,
    bf16, one call took 14.06 ms at 128 (one block an SM, 39 waves), 5.92
    at 16, 5.82 at 32 (PERF.md).  The training forward (``gla_scan``) keeps
    the request as it is."""
    best = None
    c = chunk
    while c >= 1:
        if feasible({"chunk": c}, {"dk": dk, "dv": dv}):
            sp = split(B, H, dk, dv, sms, c)
            waves = -(-sp["blocks"] // (max(1, resident(c, dk, sp["cols"], sp["lanes"])) * sms))
            if best is None or waves < best[0]:
                best = (waves, c)
        c //= 2
    return chunk if best is None else best[1]


def gla_scan_plain(r, k, v, w, u, *, lanes: int = 1, final_state: bool = False):
    """The kernel's recurrence in plain PyTorch, one step at a time, zero
    initial state, fp32 throughout, rounded once to ``r.dtype``; the output
    of a step uses the state before its update.  With ``lanes > 1`` the key
    dim is cut as the kernel cuts it (``lane_index``): each lane's partial
    ``sum_i r_i (S_ij + u_i k_i v_j)`` over its rows, summed as the kernel
    sums a thread's ``THREAD_COLS`` columns (``reduce_lanes``).  With
    ``final_state`` it returns ``(y, state)``, the state after the last
    token (B, H, dk, dv) in f32, as ``gla_scan_state`` stores it."""
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
    if final_state:
        return y.to(r.dtype), st[:, :, :dk]
    return y.to(r.dtype)


def _check_shapes(what, r, k, v, w, u, dy=None):
    if r.dim() != 4 or k.shape != r.shape or w.shape != r.shape or v.dim() != 4 \
            or v.shape[:3] != r.shape[:3] or u.shape != (r.shape[2], r.shape[3]) \
            or (dy is not None and dy.shape != v.shape):
        raise ValueError(f"{what}: r, k, w must be (B, S, H, dk), v{'' if dy is None else ' and dy'}"
                         f" (B, S, H, dv), u (H, dk); got {tuple(r.shape)}, {tuple(k.shape)}, "
                         f"{tuple(v.shape)}, {tuple(w.shape)}, {tuple(u.shape)}"
                         + ("" if dy is None else f", {tuple(dy.shape)}"))


def _check_card(what, r, *rest, w32: bool = False):
    """A CUDA launch's tensors (``rest``: k, v, w, u and maybe dy) lie on one
    card; r, k, v (and dy) share float32 or bfloat16, and w is of their
    type or float32 (only float32 where ``w32``)."""
    if r.device.type != "cuda":
        raise RuntimeError(f"{what} kernel: unsupported device {r.device}")
    typed = [r, *rest[:2], *rest[4:]]
    w = rest[2]
    if r.dtype not in _DTYPE_CODE or any(t.dtype != r.dtype for t in typed):
        raise TypeError(f"{what} kernel: r, k, v{', dy' if len(rest) > 4 else ''} must share "
                        f"float32 or bfloat16, got {', '.join(str(t.dtype) for t in typed)}")
    if w.dtype != torch.float32 and (w32 or w.dtype != r.dtype):
        raise TypeError(f"{what} kernel: w must be float32{'' if w32 else ' or of the type of r'}, "
                        f"got {w.dtype} beside {r.dtype}")
    if any(t.device != r.device for t in rest):
        raise RuntimeError(f"{what} kernel: tensors lie on different devices")


def _fn():
    global _FN
    if _FN is None:
        fn = _build.load("gla_scan").gla_scan_fwd
        fn.argtypes = _ARGTYPES
        fn.restype = ctypes.c_int
        _FN = fn
    return _FN


def _state_fn():
    global _STATE_FN
    if _STATE_FN is None:
        fn = _build.load("gla_scan").gla_scan_state_fwd
        fn.argtypes = _STATE_ARGTYPES
        fn.restype = ctypes.c_int
        _STATE_FN = fn
    return _STATE_FN


def resident_blocks(dtype, dk: int, chunk: int, lanes: int, cols: int, *,
                    state_kernel: bool = False) -> int:
    """Blocks of a launch with this split that one SM holds at once (CUDA's
    occupancy query for the instantiated kernel, ``gla_state_kernel`` where
    ``state_kernel``; launches nothing)."""
    fn = _build.load("gla_scan").gla_scan_occupancy
    fn.argtypes = [ctypes.c_int] * 6 + [ctypes.POINTER(ctypes.c_int)]
    out = ctypes.c_int(0)
    _build.check(fn(_DTYPE_CODE[dtype], int(state_kernel), dk, chunk, lanes, cols,
                    ctypes.byref(out)), "gla_scan occupancy")
    return out.value


def _launch(r, k, v, w, u, cfg: dict, lanes: int, cols: int, stream: int,
            state=None) -> torch.Tensor:
    """Allocate the output and launch the kernel on ``stream`` with the
    given split (``lanes`` a column, ``cols`` columns a block):
    ``gla_state_kernel`` where ``w`` is float32 beside bfloat16 or a
    ``state`` buffer is given (the state after the last token goes there),
    else ``gla_kernel``."""
    r, k, v, w = (t.contiguous() for t in (r, k, v, w))
    u = u.float().contiguous()
    B, S, H, dk = r.shape
    y = torch.empty_like(v)
    args = (_DTYPE_CODE[r.dtype], B, S, H, dk, v.shape[-1], cfg["chunk"], lanes, cols, stream)
    if state is None and w.dtype == r.dtype:
        err = _fn()(r.data_ptr(), k.data_ptr(), v.data_ptr(), w.data_ptr(), u.data_ptr(),
                    y.data_ptr(), *args)
    else:
        err = _state_fn()(r.data_ptr(), k.data_ptr(), v.data_ptr(), w.data_ptr(), u.data_ptr(),
                          y.data_ptr(), None if state is None else state.data_ptr(), *args)
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
    ``gla_scan_plain``.  ``w`` is of ``r``'s type or float32 (then the
    launch is ``gla_state_kernel``'s, storing no state).  On the card the
    wrapper chooses the split (``split``: lanes a column, columns a block,
    from the shapes and the SM count) and records it in
    ``gla_scan.last_split``."""
    _check_shapes("gla_scan", r, k, v, w, u)
    B, S, H, dk = r.shape
    cfg = effective_config(chunk, S, dk, v.shape[-1])
    gla_scan.last_config = cfg
    if r.device.type == "cpu":
        gla_scan.last_split = None
        return gla_scan_plain(r, k, v, w, u)
    _check_card("gla_scan", r, k, v, w, u)
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


def gla_scan_state(
    r: torch.Tensor,  # (B, S, H, dk)
    k: torch.Tensor,  # (B, S, H, dk)
    v: torch.Tensor,  # (B, S, H, dv)
    w: torch.Tensor,  # (B, S, H, dk) decay in (0, 1), float32
    u: torch.Tensor,  # (H, dk)
    state: torch.Tensor,  # (B, H, dk, dv) float32, written
    *,
    chunk: int = 128,
) -> torch.Tensor:
    """``gla_scan`` with the state after the last token written into
    ``state`` (contiguous float32, e.g. the served cache's ``S``; no copy
    follows on the card).  Zero initial state; ``w`` float32 beside ``r``,
    ``k``, ``v`` in float32 or bfloat16.  Returns y in ``r.dtype``.  CUDA
    tensors launch ``gla_state_kernel`` (counted in
    ``gla_scan_state.launches``) at the staging depth ``state_chunk``
    picks, at most ``chunk``, or raise; CPU tensors take
    ``gla_scan_plain(..., final_state=True)``."""
    _check_shapes("gla_scan_state", r, k, v, w, u)
    B, S, H, dk = r.shape
    dv = v.shape[-1]
    if state.shape != (B, H, dk, dv) or state.dtype != torch.float32 \
            or not state.is_contiguous():
        raise ValueError(f"gla_scan_state: state must be contiguous float32 {(B, H, dk, dv)}, "
                         f"got {state.dtype} {tuple(state.shape)}")
    cfg = effective_config(chunk, S, dk, dv)
    if r.device.type == "cpu":
        gla_scan_state.last_config, gla_scan_state.last_split = cfg, None
        y, st = gla_scan_plain(r, k, v, w, u, final_state=True)
        state.copy_(st)
        return y
    _check_card("gla_scan_state", r, k, v, w, u, w32=True)
    if state.device != r.device:
        raise RuntimeError("gla_scan_state kernel: the state lies on another device")
    sms = sm_count(r.device)
    cfg = {"chunk": state_chunk(B, H, dk, dv, sms, cfg["chunk"])}
    gla_scan_state.last_config = cfg
    sp = split(B, H, dk, dv, sms, cfg["chunk"])
    gla_scan_state.last_split = sp
    with torch.cuda.device(r.device):
        y = _launch(r, k, v, w, u, cfg, sp["lanes"], sp["cols"],
                    torch.cuda.current_stream().cuda_stream, state=state)
    gla_scan_state.launches += 1
    return y


#: launches that stored the final state since the count was last set to 0
gla_scan_state.launches = 0
gla_scan_state.last_config = None
gla_scan_state.last_split = None


# ---------------------------------------------------------------------------
# the gradient
# ---------------------------------------------------------------------------


def bwd_smem_bytes(chunk: int, dk: int, dv: int) -> int:
    """Shared memory of one tile of the gradient (``tile_floats`` in the
    source): two (chunk, dv) arrays and the chunk's start state and end
    gradient, rows read as 16-byte words (stride 4 mod 8); ten (chunk, dk)
    arrays, read down their columns (odd stride); two (chunk, chunk) pair
    arrays, u and the bonus; f32.  The chunk rule reads it; the launch
    refuses (cudaErrorInvalidValue) a tile that would not fit."""
    ks = dk if dk % 2 else dk + 1
    d4 = -(-dv // 4) * 4
    vs = d4 if d4 % 8 else d4 + 4
    return 4 * (2 * chunk * vs + 2 * dk * vs + 10 * chunk * ks + 2 * chunk * (chunk + 1)
                + dk + chunk)


def bwd_chunk(S: int, dk: int, dv: int) -> int:
    """Tokens of one tile of the gradient: a power of two up to
    ``BWD_MAX_CHUNK`` and not above ``S`` rounded up to a power of two; the
    largest at which two tiles share an SM's shared memory, unless that is
    below 16, then the largest at which one tile fits (16 at dk = dv = 64,
    8 at 128).  At dk = dv = 64 on an H100 one call took 1.61 ms at 16
    tokens, 2.93 ms at 32 (one tile an SM) and 2.01 ms at 8 (PERF.md)."""
    sizes = [c for c in (BWD_MAX_CHUNK >> i for i in range(BWD_MAX_CHUNK.bit_length()))
             if c <= pow2_ceil(max(S, 1))]
    per_sm = lambda c: SMEM_PER_SM // (bwd_smem_bytes(c, dk, dv) + SMEM_PER_BLOCK_RESERVED)  # noqa: E731
    two = next((c for c in sizes if per_sm(c) >= 2), 1)
    if two >= min(16, sizes[0]):
        return two
    return next(c for c in sizes if bwd_smem_bytes(c, dk, dv) <= MAX_SMEM_BYTES)


def gla_scan_bwd_plain(r, k, v, w, u, dy, *, chunk: int = 0):
    """The gradient kernels' arithmetic in plain PyTorch, f32 throughout
    (f64 for f64 inputs): returns ``(dr, dk, dv, dw, du)``, the first four
    in the inputs' types, ``du`` in ``u``'s.  ``chunk`` (default
    ``bwd_chunk``) cuts the sequence as the kernels do; every chunk is
    computed at once, the carried states by a loop over the chunks (the
    kernels walk them token by token)."""
    B, S, H, dk = r.shape
    dv = v.shape[-1]
    C = chunk or bwd_chunk(S, dk, dv)
    nc = -(-S // C)
    pad = nc * C - S
    ft = torch.promote_types(r.dtype, torch.float32)
    seq = lambda a, fill=0.0: torch.nn.functional.pad(  # noqa: E731
        a.to(ft), (0, 0, 0, 0, 0, pad), value=fill).reshape(B, nc, C, H, -1).permute(0, 3, 1, 2, 4)
    R, K, V, DY, W = seq(r), seq(k), seq(v), seq(dy), seq(w, 1.0)  # (B, H, nc, C, d)
    uf = u.to(ft)[None, :, None, None, :]
    cum = torch.log2(W.clamp(min=MIN_DECAY)).cumsum(3)  # log2 decay through token t
    exc = torch.nn.functional.pad(cum[..., :-1, :], (0, 0, 1, 0))  # ... through t - 1
    end = cum[..., -1:, :]
    # the carried states: S at each chunk's start, G after each chunk's end
    kt = K * torch.exp2(end - cum)  # k decayed to the chunk's end
    own_s = torch.einsum("bhnsk,bhnsv->bhnkv", kt, V)
    own_g = torch.einsum("bhntk,bhntv->bhnkv", R * torch.exp2(exc), DY)
    S0, GE = torch.empty_like(own_s), torch.empty_like(own_g)
    st, g = torch.zeros_like(own_s[:, :, 0]), torch.zeros_like(own_g[:, :, 0])
    carry = torch.exp2(end[..., 0, :])[..., None]  # (B, H, nc, dk, 1)
    for c in range(nc):
        S0[:, :, c] = st
        st = carry[:, :, c] * st + own_s[:, :, c]
        GE[:, :, nc - 1 - c] = g
        g = carry[:, :, nc - 1 - c] * g + own_g[:, :, nc - 1 - c]
    # the pairs s < t inside a chunk
    tri = torch.ones(C, C, dtype=torch.bool, device=r.device).tril(-1)[..., None]
    E = torch.exp2((exc[..., :, None, :] - cum[..., None, :, :]).masked_fill(~tri, -torch.inf))
    P = torch.einsum("bhnsv,bhntv->bhnts", V, DY)  # P[t, s] = v_s . dy_t
    pd = torch.diagonal(P, dim1=-2, dim2=-1)[..., None]  # v_t . dy_t
    A = torch.einsum("bhntk,bhnsk,bhntsk->bhnts", R, K, E)
    bonus = (R * uf * K).sum(-1, keepdim=True)
    Y = torch.einsum("bhnkv,bhntv->bhntk", S0, DY)  # the start state read by dy_t
    X = torch.einsum("bhnkv,bhnsv->bhnsk", GE, V)  # the end gradient read by v_s
    before, after = torch.exp2(exc), torch.exp2(end - cum)
    dR = before * Y + torch.einsum("bhntsk,bhnsk,bhnts->bhntk", E, K, P) + uf * pd * K
    dK = after * X + torch.einsum("bhntsk,bhntk,bhnts->bhnsk", E, R, P) + uf * pd * R
    dV = (torch.einsum("bhnsk,bhnkv->bhnsv", kt, GE) + torch.einsum("bhnts,bhntv->bhnsv", A, DY)
          + bonus * DY)
    # the decay, w_m left out of each pair's product (the source's note):
    # alpha[m, t] = r_t exp2(exc_t - cum_m), t > m; beta[m, s] = k_s exp2(exc_m - cum_s), s < m
    idx = torch.arange(C, device=r.device)
    later, earlier = (idx[None, :] > idx[:, None])[..., None], (idx[None, :] < idx[:, None])[..., None]
    alpha = R[..., None, :, :] * torch.exp2(
        (exc[..., None, :, :] - cum[..., :, None, :]).masked_fill(~later, -torch.inf))
    beta = K[..., None, :, :] * torch.exp2(
        (exc[..., :, None, :] - cum[..., None, :, :]).masked_fill(~earlier, -torch.inf))
    Z = torch.einsum("bhnmsk,bhnts->bhnmtk", beta, P)  # the chunk's own state before m, read by dy_t
    cross = (S0 * GE).sum(-1)[..., None, :]
    dW = ((alpha * (before[..., :, None, :] * Y[..., None, :, :] + Z)).sum(-2)
          + after * (beta * X[..., None, :, :]).sum(-2) + before * after * cross)
    du = (R * K * pd).sum(dim=(0, 2, 3))
    back = lambda a, like: a.permute(0, 2, 3, 1, 4).reshape(B, nc * C, H, -1)[:, :S].to(like.dtype)  # noqa: E731
    return back(dR, r), back(dK, k), back(dV, v), back(dW, w), du.to(u.dtype)


def _bwd_fn():
    global _BWD_FN
    if _BWD_FN is None:
        fn = _build.load("gla_scan_bwd").gla_scan_bwd
        fn.argtypes = _BWD_ARGTYPES
        fn.restype = ctypes.c_int
        _BWD_FN = fn
    return _BWD_FN


def _launch_bwd(r, k, v, w, u, dy, chunk: int, stream: int):
    """Allocate the gradients and the scratch (the boundary states and the
    partial ``du``: ``torch.empty``, so a captured graph keeps them in its
    pool) and launch the three kernels on ``stream`` with ``chunk`` tokens
    a tile."""
    r, k, v, w, dy = (t.contiguous() for t in (r, k, v, w, dy))
    u = u.float().contiguous()
    B, S, H, dk = r.shape
    dv = v.shape[-1]
    nc = -(-S // chunk)
    f32 = dict(dtype=torch.float32, device=r.device)
    states = torch.empty((2, B, H, nc, dk, dv), **f32)
    du_part = torch.empty((B, nc, H, dk), **f32)
    du = torch.empty((H, dk), **f32)
    dr, dk_, dw, dv_ = (torch.empty_like(t) for t in (r, k, w, v))
    err = _bwd_fn()(r.data_ptr(), k.data_ptr(), v.data_ptr(), w.data_ptr(), u.data_ptr(),
                    dy.data_ptr(), dr.data_ptr(), dk_.data_ptr(), dv_.data_ptr(), dw.data_ptr(),
                    du.data_ptr(), states[0].data_ptr(), states[1].data_ptr(),
                    du_part.data_ptr(), _DTYPE_CODE[r.dtype], B, S, H, dk, dv, chunk, stream)
    _build.check(err, "gla_scan_bwd")
    return dr, dk_, dv_, dw, du


def gla_scan_bwd(r, k, v, w, u, dy):
    """``(dr, dk, dv, dw, du)`` of ``gla_scan`` at these inputs for the
    output's gradient ``dy``: the first four in the inputs' types, ``du``
    in ``u``'s.  CUDA tensors go through the three kernels of
    csrc/gla_scan_bwd.cu (or raise); CPU tensors take
    ``gla_scan_bwd_plain``.  The chunk follows from the shapes
    (``bwd_chunk``); ``gla_scan_bwd.last_chunk`` records it."""
    _check_shapes("gla_scan_bwd", r, k, v, w, u, dy)
    B, S, H, dk = r.shape
    dv = v.shape[-1]
    chunk = bwd_chunk(S, dk, dv)
    gla_scan_bwd.last_chunk = chunk
    if r.device.type == "cpu":
        return gla_scan_bwd_plain(r, k, v, w, u, dy, chunk=chunk)
    _check_card("gla_scan_bwd", r, k, v, w, u, dy)
    if dk > BWD_MAX_DIM or dv > BWD_MAX_DIM:
        raise ValueError(f"gla_scan_bwd kernel: dk={dk}, dv={dv}; at most {BWD_MAX_DIM} each")
    # an f32 decay beside bf16 operands: the kernels run in f32 throughout,
    # the gradients go back in each input's type
    x = [t.to(w.dtype) for t in (r, k, v, w, u, dy)]
    with torch.cuda.device(r.device):
        out = _launch_bwd(*x, chunk, torch.cuda.current_stream().cuda_stream)
    gla_scan_bwd.launches += 1
    return (*(g.to(t.dtype) for g, t in zip(out[:4], (r, k, v, w))), out[4].to(u.dtype))


#: calls that launched the gradient's kernels since the count was last set to 0
gla_scan_bwd.launches = 0
#: the tokens a tile of the last call (``bwd_chunk``)
gla_scan_bwd.last_chunk = None
