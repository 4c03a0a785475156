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

Two measurement modes, as in the reference:

* **in-process** (default) — the kernel runs through ``ops`` in this
  process.
* **subprocess** — for the *host-level* knobs, the paper's own Table 1
  thread knobs as PyTorch spells them: ``intra_op_threads``
  (``OMP_NUM_THREADS`` and ``torch.set_num_threads``) and
  ``inter_op_threads`` (``torch.set_num_interop_threads``, which PyTorch
  takes only before its first inter-op work).  A live process cannot
  change them for good, so a point carrying one is measured by a fresh
  ``python -m repro_torch.tuning.kernel_objective '<payload>'`` (an exec,
  not a fork: CUDA initialises cleanly in the child) on the device the
  parent measures on.  The child reports the thread counts it ran with,
  so a knob that did not take shows in the meta.  ``KMP_BLOCKTIME`` is no
  knob here: PyTorch's wheels run on GNU OpenMP, which does not read it.
  The reference's host knobs (``host_devices``, ``xla_flags``) are XLA's.
"""
from __future__ import annotations

import json
import math
import os
import subprocess
import sys
import time
from typing import Dict, Optional, Tuple

from repro_torch.tuning.objective import Evaluator

#: host-level knobs (subprocess-only; see module docstring)
HOST_KNOBS = ("intra_op_threads", "inter_op_threads")


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
    """SearchSpace dims for one kernel (optionally + host-level knobs).

    ``host_knobs=True`` appends the thread knobs (choices up to the CPU
    count, the reference's rule for ``host_devices``); those points require
    an evaluator with ``allow_subprocess=True``.
    """
    dims = KERNELS[kernel].space(shape)
    if host_knobs:
        ncpu = os.cpu_count() or 1
        dims += [
            {"name": "intra_op_threads", "type": "cat",
             "choices": [n for n in (1, 2, 4, 8) if n <= ncpu] or [1]},
            {"name": "inter_op_threads", "type": "cat",
             "choices": [n for n in (1, 2, 4) if n <= ncpu] or [1]},
        ]
    return dims


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

    Points carrying host knobs (``HOST_KNOBS``) are measured in a fresh
    subprocess — iff ``allow_subprocess=True``; otherwise they raise,
    because a live process cannot re-size its thread pools.
    """

    supports_fidelity = True

    def __init__(self, kernel: str, shape: Optional[Dict[str, int]] = None,
                 *, warmup: int = 1, iters: int = 3, adaptive: bool = True,
                 rel_halfwidth: float = 0.2, device: str = "cuda",
                 allow_subprocess: bool = False, timeout: float = 300.0):
        if kernel not in KERNELS:
            raise ValueError(
                f"unknown kernel {kernel!r}; one of {sorted(KERNELS)}")
        self.kernel = kernel
        self.spec = KERNELS[kernel]
        self.shape = dict(self.spec.shape if shape is None else shape)
        self.device = device
        self.allow_subprocess = allow_subprocess
        self.timeout = float(timeout)
        self._harness = dict(warmup=warmup, iters=iters, adaptive=adaptive,
                             rel_halfwidth=rel_halfwidth)
        from repro_torch.tuning.evaluator import WallClockEvaluator

        self._wall = WallClockEvaluator(
            self._make_step, warmup=warmup, iters=iters, adaptive=adaptive,
            rel_halfwidth=rel_halfwidth)

    def _make_step(self, point: Dict):
        return self.spec.build(self.shape, point, self.device)

    def __call__(self, point: Dict,
                 fidelity: Optional[float] = None) -> Tuple[float, dict]:
        host = {k: point[k] for k in HOST_KNOBS if k in point}
        if host:
            if not self.allow_subprocess:
                raise ValueError(
                    f"point carries host knobs {sorted(host)} but this "
                    "evaluator was built with allow_subprocess=False — "
                    "thread pools cannot be re-sized inside a live process; "
                    "build KernelTuneEvaluator(..., allow_subprocess=True)")
            tile = {k: v for k, v in point.items() if k not in HOST_KNOBS}
            self.spec.config(tile)  # a typo'd key raises here, not in the child
            return self._call_subprocess(tile, host, fidelity)
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

    # -- subprocess harness (host knobs) -------------------------------------
    def _call_subprocess(self, tile: Dict, host: Dict,
                         fidelity: Optional[float]) -> Tuple[float, dict]:
        payload = {"kernel": self.kernel, "shape": self.shape, "point": tile,
                   "fidelity": fidelity, "device": self.device, "host": host,
                   **self._harness}
        env = dict(os.environ)
        if "intra_op_threads" in host:
            env["OMP_NUM_THREADS"] = str(int(host["intra_op_threads"]))
        src = os.path.dirname(os.path.dirname(os.path.dirname(
            os.path.abspath(__file__))))
        env["PYTHONPATH"] = src + os.pathsep + env.get("PYTHONPATH", "")
        t0 = time.perf_counter()
        proc = subprocess.run(
            [sys.executable, "-m", "repro_torch.tuning.kernel_objective",
             json.dumps(payload)],
            capture_output=True, text=True, env=env, timeout=self.timeout)
        wall = time.perf_counter() - t0
        if proc.returncode != 0:
            return -math.inf, {"error": proc.stderr.strip()[-2000:],
                               "kernel": self.kernel, "host": host,
                               "child_seconds": wall}
        out = json.loads(proc.stdout.strip().splitlines()[-1])
        return float(out["value"]), dict(out["meta"], host=host, child_seconds=wall)


def _apply_host_knobs(host: Dict) -> Dict[str, object]:
    """Set the thread knobs in this (fresh) process before any parallel
    work, and report what PyTorch runs with afterwards."""
    import torch

    if "inter_op_threads" in host:  # only before the first inter-op work
        torch.set_num_interop_threads(int(host["inter_op_threads"]))
    if "intra_op_threads" in host:
        torch.set_num_threads(int(host["intra_op_threads"]))
    return {"intra_op_threads": torch.get_num_threads(),
            "inter_op_threads": torch.get_num_interop_threads(),
            "OMP_NUM_THREADS": os.environ.get("OMP_NUM_THREADS")}


def main(argv=None) -> int:
    """Subprocess entry: measure one payload, print one JSON line.

    ``python -m repro_torch.tuning.kernel_objective '<payload json>'`` where
    payload = {kernel, shape, point, fidelity, device, host, warmup, iters,
    adaptive, rel_halfwidth}.  ``OMP_NUM_THREADS`` is the *caller's* job (set
    in this process's environment before torch starts its pool); the
    thread counts are set here first, before anything is measured, and the
    counts PyTorch then reports go into the meta as ``threads``.
    """
    argv = sys.argv[1:] if argv is None else argv
    payload = json.loads(argv[0])
    threads = _apply_host_knobs(payload.get("host") or {})
    ev = KernelTuneEvaluator(
        payload["kernel"], payload.get("shape"),
        warmup=int(payload.get("warmup", 1)),
        iters=int(payload.get("iters", 3)),
        adaptive=bool(payload.get("adaptive", True)),
        rel_halfwidth=float(payload.get("rel_halfwidth", 0.2)),
        device=payload.get("device", "cuda"),
    )
    value, meta = ev(payload.get("point") or {},
                     fidelity=payload.get("fidelity"))
    print(json.dumps({"value": value, "meta": dict(meta, threads=threads)}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
