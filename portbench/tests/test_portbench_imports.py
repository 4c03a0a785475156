"""Nothing the benchmark runs loads JAX or the JAX package (whole top-level
names: ``repro_torch`` is not ``repro``), and the references load nothing
of the program.  Each check runs in a fresh interpreter."""
import json
import re
import subprocess
import sys

import pytest

from portbench import harness, spec

REFERENCES = sorted(p.stem for p in (spec.ROOT / "portbench/reference").glob("*.py")
                    if p.stem != "__init__")


def _loaded(code: str) -> list:
    prog = (f"import sys\nsys.path[:0] = [{str(spec.ROOT / 'src')!r}, {str(spec.ROOT)!r}]\n"
            f"{code}\nimport json\nprint(json.dumps(sorted(sys.modules)))")
    out = subprocess.run([sys.executable, "-c", prog], capture_output=True, text=True,
                         timeout=300, check=True)
    return json.loads(out.stdout.strip().splitlines()[-1])


def test_forbidden_names_are_compared_whole():
    assert harness.forbidden_modules(["repro_torch", "repro_torch.models", "jaxtyping"]) == []
    assert harness.forbidden_modules(["repro", "repro.core", "jax.numpy", "flax"]) == [
        "flax", "jax.numpy", "repro", "repro.core"]


def test_the_harness_and_every_driver_load_no_jax():
    drivers = sorted(p.stem for p in (spec.ROOT / "portbench/drivers").glob("*.py"))
    metrics = sorted(p.stem for p in (spec.ROOT / "portbench/metrics").glob("*.py"))
    code = ("from portbench import harness, spec, calibrate\n"
            f"for d in {drivers!r}: spec.driver(d)\n"
            f"for m in {metrics!r}: spec.metric(m)\n"
            "import repro_torch.serve.serve_step, repro_torch.train.train_step\n"
            "import repro_torch.launch.serve, repro_torch.launch.train\n")
    assert harness.forbidden_modules(_loaded(code)) == []


@pytest.mark.parametrize("name", REFERENCES)
def test_a_reference_loads_nothing_of_the_program(name):
    loaded = _loaded(f"from portbench.reference import {name}")
    tops = {m.split(".")[0] for m in loaded}
    assert not tops & {"repro_torch", "repro", "jax", "jaxlib", "flax"}
    assert not any(m.startswith("portbench.") and not m.startswith("portbench.reference")
                   and m != "portbench.seeds" for m in loaded), loaded


def test_a_run_imports_no_fault_and_no_calibration():
    """``run.py`` and the harness never import the planted faults or the
    calibration."""
    for f in ("run.py", "harness.py"):
        text = (spec.ROOT / "portbench" / f).read_text()
        assert not re.search(r"^\s*(from|import) .*\b(faults|calibrate)\b", text, re.M), f
