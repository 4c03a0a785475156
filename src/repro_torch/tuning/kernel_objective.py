"""Kernel-autotuning objective — tune the package's own hand-written kernels.

The paper tunes a real framework backend; this module closes the same
loop for the kernels of ``repro_torch.kernels``: the search space is the
tile/grid knobs each kernel actually takes (``block_q``, ``block_kv``,
``block_rows``, ``chunk``, ``block_d``), the measurement is the shared
variance-adaptive :class:`~repro_torch.tuning.evaluator.WallClockEvaluator`
loop, and the product is a best-known config per (kernel, shape bucket,
hardware) persisted in :class:`~repro_torch.tuning.tundb.TuningDB` by
``repro_torch.benchmarks.kernel_sweep``.

The kernel runs through the public ``repro_torch.kernels.ops`` dispatch
with ``impl="cuda"`` on the evaluator's ``device`` (``"cuda"`` by default:
the hand-written kernel; ``"cpu"`` takes each kernel's plain PyTorch
version, which is what the CPU tests exercise — its timings rank nothing).

The names, default shapes, knobs and search spaces are the reference
package's, so a sweep here and there explore the same points.  Two rules
are stricter than the kernels' wrappers:

* A point that the kernel module's ``feasible()`` rejects (more threads or
  shared memory than a block can have) scores ``-inf`` with an ``error``
  meta before anything is launched.  The wrappers lower such a request to
  a feasible tile, which would hide from the tuner that the point it asked
  for never ran.
* Point hygiene mirrors ``config_from_point``: a point key that is not a
  knob of the targeted kernel raises ``ValueError`` — a typo'd dim must
  never silently tune nothing.

The reference's host-level knobs (``host_devices``, ``xla_flags``) and its
fresh-subprocess harness are not ported yet (ROADMAP A6).
"""
from __future__ import annotations

import math
from typing import Dict, Optional, Tuple

from repro_torch.tuning.objective import Evaluator


def _pow2_choices(lo: int, hi: int) -> "list[int]":
    v, out = lo, []
    while v <= hi:
        out.append(v)
        v *= 2
    return out or [lo]


# ---------------------------------------------------------------------------
# Kernel registry: shapes, tunable knobs, search space, step builders
# ---------------------------------------------------------------------------


class KernelSpec:
    """One tunable kernel: its call-shape dims, knob names with the ``ops``
    defaults, search space, feasibility test and step builder."""

    def __init__(self, name: str, shape: Dict[str, int], defaults: Dict[str, int],
                 space_fn, build_fn, examples_fn, feasible_fn, effective_fn):
        self.name = name
        self.shape = dict(shape)
        self.defaults = dict(defaults)
        self.knobs = tuple(defaults)
        self._space_fn = space_fn
        self._build_fn = build_fn
        self._examples_fn = examples_fn
        self._feasible_fn = feasible_fn
        self._effective_fn = effective_fn

    def space(self, shape: Optional[Dict[str, int]] = None) -> "list[dict]":
        return self._space_fn(dict(self.shape if shape is None else shape))

    def config(self, point: Dict) -> Dict[str, int]:
        """The full knob set of ``point`` (the ``ops`` defaults for knobs it
        leaves out); a key that is no knob raises."""
        stray = sorted(k for k in point if k not in self.knobs)
        if stray:
            raise ValueError(
                f"point keys {stray} are not knobs of kernel "
                f"{self.name!r} (knobs: {sorted(self.knobs)})")
        return {k: int(point.get(k, v)) for k, v in self.defaults.items()}

    def feasible(self, shape: Dict[str, int], point: Dict) -> bool:
        return bool(self._feasible_fn(shape, self.config(point)))

    def effective(self, shape: Dict[str, int], point: Dict) -> Dict[str, int]:
        """The knobs the kernel's wrapper runs ``point`` with (clamped)."""
        return self._effective_fn(shape, self.config(point))

    def build(self, shape: Dict[str, int], point: Dict, device: str):
        """-> (step_fn, args, examples_per_step) for WallClockEvaluator."""
        step, args = self._build_fn(shape, self.config(point), device)
        return step, args, float(self._examples_fn(shape))


def _gen(device: str):
    import torch

    gen = torch.Generator(device=device)
    gen.manual_seed(0)
    return gen


def _randn(gen, *shape):
    import torch

    return torch.randn(shape, generator=gen, device=gen.device, dtype=torch.float32)


def _attn_space(s):
    return [
        {"name": "block_q", "type": "cat",
         "choices": _pow2_choices(8, max(8, s["Sq"]))},
        {"name": "block_kv", "type": "cat",
         "choices": _pow2_choices(8, max(8, s["Sk"]))},
    ]


def _flash_feasible(s, c):
    from repro_torch.kernels import flash_attention as m

    return m.feasible(c, {"dh": s["dh"]})


def _flash_effective(s, c):
    from repro_torch.kernels import flash_attention as m

    return m.effective_config(c["block_q"], c["block_kv"], s["Sq"], s["Sk"], s["dh"], s["dh"])


def _build_flash(s, c, device):
    from repro_torch.kernels import ops

    gen = _gen(device)
    q = _randn(gen, s["B"], s["Sq"], s["H"], s["dh"])
    k = _randn(gen, s["B"], s["Sk"], s["K"], s["dh"])
    v = _randn(gen, s["B"], s["Sk"], s["K"], s["dh"])

    def step(q, k, v):
        return ops.attention(q, k, v, causal=True, impl="cuda",
                             block_q=c["block_q"], block_kv=c["block_kv"])

    return step, (q, k, v)


def _decode_space(s):
    return [{"name": "block_kv", "type": "cat",
             "choices": _pow2_choices(8, max(8, s["Smax"]))}]


def _decode_feasible(s, c):
    from repro_torch.kernels import decode_attention as m

    return m.feasible(c, {"H": s["H"], "K": s["K"], "dh": s["dh"]})


def _decode_effective(s, c):
    from repro_torch.kernels import decode_attention as m

    return m.effective_config(c["block_kv"], s["H"], s["K"], s["dh"])


def _build_decode(s, c, device):
    import torch

    from repro_torch.kernels import ops

    gen = _gen(device)
    q = _randn(gen, s["B"], s["H"], s["dh"])
    k = _randn(gen, s["B"], s["Smax"], s["K"], s["dh"])
    v = _randn(gen, s["B"], s["Smax"], s["K"], s["dh"])
    lengths = torch.full((s["B"],), s["Smax"] // 2, dtype=torch.int32, device=device)

    def step(q, k, v, lengths):
        return ops.decode_attention(q, k, v, lengths, impl="cuda", block_kv=c["block_kv"])

    return step, (q, k, v, lengths)


def _rms_space(s):
    return [{"name": "block_rows", "type": "cat",
             "choices": _pow2_choices(8, max(8, s["rows"]))}]


def _rms_feasible(s, c):
    from repro_torch.kernels import rmsnorm as m

    return m.feasible(c, {"D": s["D"]})


def _rms_effective(s, c):
    from repro_torch.kernels import rmsnorm as m

    return m.effective_config(c["block_rows"], s["rows"], s["D"])


def _build_rms(s, c, device):
    import torch

    from repro_torch.kernels import ops

    x = _randn(_gen(device), s["rows"], s["D"])
    scale = torch.ones((s["D"],), dtype=torch.float32, device=device)

    def step(x, scale):
        return ops.rmsnorm(x, scale, impl="cuda", block_rows=c["block_rows"])

    return step, (x, scale)


def _ssm_space(s):
    return [
        {"name": "chunk", "type": "cat",
         "choices": _pow2_choices(8, max(8, s["S"]))},
        {"name": "block_d", "type": "cat",
         "choices": _pow2_choices(8, max(8, s["D"]))},
    ]


def _ssm_feasible(s, c):
    from repro_torch.kernels import ssm_scan as m

    return m.feasible(c, {"N": s["N"]})


def _ssm_effective(s, c):
    from repro_torch.kernels import ssm_scan as m

    return m.effective_config(c["chunk"], c["block_d"], s["S"], s["D"], s["N"])


def _build_ssm(s, c, device):
    import torch

    from repro_torch.kernels import ops

    gen = _gen(device)
    B, S, D, N = s["B"], s["S"], s["D"], s["N"]
    x = _randn(gen, B, S, D)
    dt = torch.nn.functional.softplus(_randn(gen, B, S, D))
    A = -torch.exp(_randn(gen, D, N))
    B_in = _randn(gen, B, S, N)
    C_in = _randn(gen, B, S, N)
    D_skip = torch.ones((D,), dtype=torch.float32, device=device)

    def step(x, dt, A, B_in, C_in, D_skip):
        return ops.ssm_scan(x, dt, A, B_in, C_in, D_skip, impl="cuda",
                            chunk=c["chunk"], block_d=c["block_d"])

    return step, (x, dt, A, B_in, C_in, D_skip)


def _gla_space(s):
    return [{"name": "chunk", "type": "cat",
             "choices": _pow2_choices(8, max(8, s["S"]))}]


def _gla_feasible(s, c):
    from repro_torch.kernels import gla_scan as m

    return m.feasible(c, {"dk": s["dk"], "dv": s["dv"]})


def _gla_effective(s, c):
    from repro_torch.kernels import gla_scan as m

    return m.effective_config(c["chunk"], s["S"], s["dk"], s["dv"])


def _build_gla(s, c, device):
    import torch

    from repro_torch.kernels import ops

    gen = _gen(device)
    B, S, H, dk, dv = s["B"], s["S"], s["H"], s["dk"], s["dv"]
    r = _randn(gen, B, S, H, dk)
    k = _randn(gen, B, S, H, dk)
    v = _randn(gen, B, S, H, dv)
    w = torch.exp(-torch.exp(_randn(gen, B, S, H, dk)))
    u = _randn(gen, H, dk)

    def step(r, k, v, w, u):
        return ops.gla_scan(r, k, v, w, u, impl="cuda", chunk=c["chunk"])

    return step, (r, k, v, w, u)


#: tiny default shapes (cheap anywhere); real-timing sweeps pass production
#: shapes explicitly.  ``defaults`` are the ``kernels.ops`` defaults.
KERNELS: Dict[str, KernelSpec] = {
    "flash_attention": KernelSpec(
        "flash_attention",
        {"B": 2, "Sq": 64, "Sk": 64, "H": 2, "K": 2, "dh": 16},
        {"block_q": 128, "block_kv": 128}, _attn_space, _build_flash,
        lambda s: s["B"] * s["Sq"], _flash_feasible, _flash_effective),
    "decode_attention": KernelSpec(
        "decode_attention",
        {"B": 2, "H": 2, "K": 2, "dh": 16, "Smax": 64},
        {"block_kv": 512}, _decode_space, _build_decode,
        lambda s: s["B"], _decode_feasible, _decode_effective),
    "rmsnorm": KernelSpec(
        "rmsnorm",
        {"rows": 128, "D": 128},
        {"block_rows": 256}, _rms_space, _build_rms,
        lambda s: s["rows"], _rms_feasible, _rms_effective),
    "ssm_scan": KernelSpec(
        "ssm_scan",
        {"B": 2, "S": 64, "D": 32, "N": 8},
        {"chunk": 128, "block_d": 256}, _ssm_space, _build_ssm,
        lambda s: s["B"] * s["S"], _ssm_feasible, _ssm_effective),
    "gla_scan": KernelSpec(
        "gla_scan",
        {"B": 2, "S": 64, "H": 2, "dk": 16, "dv": 16},
        {"chunk": 64}, _gla_space, _build_gla,
        lambda s: s["B"] * s["S"], _gla_feasible, _gla_effective),
}


def kernel_space(kernel: str, shape: Optional[Dict[str, int]] = None,
                 *, host_knobs: bool = False) -> "list[dict]":
    """SearchSpace dims for one kernel.  ``host_knobs=True`` (the
    reference's subprocess-measured host knobs) is not ported yet."""
    if host_knobs:
        raise NotImplementedError(
            "host knobs and their fresh-subprocess harness are not ported yet "
            "(ROADMAP.md, Queue A, A6)")
    return KERNELS[kernel].space(shape)


# ---------------------------------------------------------------------------
# Evaluator
# ---------------------------------------------------------------------------


class KernelTuneEvaluator(Evaluator):
    """Measured throughput (examples/s) of one kernel at one shape.

    Implements the evaluator protocol incl. fidelity by delegating to
    :class:`~repro_torch.tuning.evaluator.WallClockEvaluator`; a
    full-fidelity call is byte-identical to a plain call (golden-trace
    contract).  Inputs are drawn on ``device`` from a ``torch.Generator``
    seeded 0, in float32 (the reference's builders' type).
    """

    supports_fidelity = True

    def __init__(self, kernel: str, shape: Optional[Dict[str, int]] = None,
                 *, warmup: int = 1, iters: int = 3, adaptive: bool = True,
                 rel_halfwidth: float = 0.2, device: str = "cuda"):
        if kernel not in KERNELS:
            raise ValueError(
                f"unknown kernel {kernel!r}; one of {sorted(KERNELS)}")
        self.kernel = kernel
        self.spec = KERNELS[kernel]
        self.shape = dict(self.spec.shape if shape is None else shape)
        self.device = device
        from repro_torch.tuning.evaluator import WallClockEvaluator

        self._wall = WallClockEvaluator(
            self._make_step, warmup=warmup, iters=iters, adaptive=adaptive,
            rel_halfwidth=rel_halfwidth)

    def _make_step(self, point: Dict):
        return self.spec.build(self.shape, point, self.device)

    def __call__(self, point: Dict,
                 fidelity: Optional[float] = None) -> Tuple[float, dict]:
        if not self.spec.feasible(self.shape, point):  # raises on stray keys
            return -math.inf, {
                "error": f"infeasible: {self.kernel} cannot launch "
                         f"{self.spec.config(point)} at {self.shape}",
                "kernel": self.kernel}
        try:
            value, meta = self._wall(point, fidelity=fidelity)
        except ValueError:
            raise  # point-hygiene errors must surface, not score -inf
        except Exception as e:  # a failed launch = failed run
            return -math.inf, {"error": f"{type(e).__name__}: {e}"}
        return value, dict(meta, kernel=self.kernel)
