"""The paper's thread knobs, measured in a fresh process (ROADMAP A6).

``kernel_space(host_knobs=True)`` appends ``intra_op_threads`` and
``inter_op_threads``; a point carrying one is measured by a child
``python -m repro_torch.tuning.kernel_objective`` that sets the counts
before any parallel work and reports what PyTorch then runs with.  On the
CPU the children measure K1's plain version.
"""
import json
import math
import os
import subprocess
import sys

import pytest

from repro_torch.tuning import kernel_objective as ko
from repro_torch.tuning.kernel_objective import HOST_KNOBS, KernelTuneEvaluator, kernel_space

SHAPE = {"rows": 64, "D": 64}


def test_host_knob_dims():
    ncpu = os.cpu_count() or 1
    dims = {d["name"]: d for d in kernel_space("rmsnorm", host_knobs=True)}
    assert set(dims) == {"block_rows", *HOST_KNOBS}
    assert dims["intra_op_threads"]["choices"] == [n for n in (1, 2, 4, 8) if n <= ncpu]
    assert dims["inter_op_threads"]["choices"] == [n for n in (1, 2, 4) if n <= ncpu]
    for name in ko.KERNELS:  # every kernel's tile dims come first, unchanged
        assert kernel_space(name, host_knobs=True)[:-2] == kernel_space(name)


@pytest.mark.parametrize("knob", HOST_KNOBS)
def test_host_knob_point_raises_without_subprocess(knob):
    ev = KernelTuneEvaluator("rmsnorm", SHAPE, device="cpu")
    with pytest.raises(ValueError, match="allow_subprocess=True"):
        ev({"block_rows": 8, knob: 1})


def test_typo_key_raises_before_any_child(monkeypatch):
    monkeypatch.setattr(subprocess, "run", lambda *a, **k: pytest.fail("a child ran"))
    ev = KernelTuneEvaluator("rmsnorm", SHAPE, device="cpu", allow_subprocess=True)
    with pytest.raises(ValueError, match="not knobs"):
        ev({"block_row": 8, "intra_op_threads": 1})
    with pytest.raises(ValueError, match="not knobs"):
        ev({"intra_op_thread": 1})


def test_children_take_the_thread_counts():
    ev = KernelTuneEvaluator("rmsnorm", SHAPE, device="cpu", iters=2, allow_subprocess=True)
    for n in (1, 2):
        value, meta = ev({"block_rows": 8, "intra_op_threads": n, "inter_op_threads": n})
        assert math.isfinite(value) and value > 0, meta
        assert meta["threads"] == {"intra_op_threads": n, "inter_op_threads": n,
                                   "OMP_NUM_THREADS": str(n)}
        assert meta["host"] == {"intra_op_threads": n, "inter_op_threads": n}
        assert meta["kernel"] == "rmsnorm" and meta["child_seconds"] > 0


def test_failing_child_scores_minus_inf_with_its_stderr():
    # a thread count PyTorch refuses: the child dies before measuring
    ev = KernelTuneEvaluator("rmsnorm", SHAPE, device="cpu", allow_subprocess=True)
    value, meta = ev({"block_rows": 8, "intra_op_threads": 0})
    assert value == -math.inf
    assert "Traceback" in meta["error"] and "set_num_threads" in meta["error"]
    assert meta["host"] == {"intra_op_threads": 0}


def test_child_imports_no_jax():
    payload = {"kernel": "rmsnorm", "shape": SHAPE, "point": {"block_rows": 8},
               "device": "cpu", "host": {"intra_op_threads": 1}, "iters": 2}
    code = ("import json, sys; from repro_torch.tuning.kernel_objective import main; "
            f"main([{json.dumps(json.dumps(payload))}]); "
            "print(json.dumps(sorted(m for m in sys.modules if m == 'jax' "
            "or m.startswith(('jax.', 'jaxlib', 'repro.')) or m == 'repro')))")
    src = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "src")
    env = dict(os.environ, PYTHONPATH=src, OMP_NUM_THREADS="1")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         env=env, timeout=120)
    assert out.returncode == 0, out.stderr
    lines = out.stdout.strip().splitlines()
    assert json.loads(lines[-1]) == []
    assert math.isfinite(json.loads(lines[-2])["value"])
