"""The port stands alone: it imports neither jax nor the reference package,
and it calls no library attention / norm in place of its kernels."""
import pathlib
import subprocess
import sys

import pytest

ROOT = pathlib.Path(__file__).resolve().parents[1]
PKG = ROOT / "src" / "repro_torch"

MODULES = sorted(
    ".".join(p.relative_to(ROOT / "src").with_suffix("").parts)
    for p in PKG.rglob("*.py") if p.name != "__init__.py"
)

_PROBE = """
import importlib, sys
sys.path.insert(0, {src!r})
sys.path.insert(0, {root!r})
for name in {names!r}:
    importlib.import_module(name)
bad = sorted(m for m in sys.modules
             if m == "jax" or m.startswith("jax.") or m == "jaxlib"
             or m == "repro" or m.startswith("repro."))
assert not bad, bad
assert "triton" not in sys.modules
print("clean", len({names!r}))
"""


#: the paper's experiment (workloads, Fig. 5 / Fig. 6 / Table 2, the
#: quickstart) and the host-knob child's module
PAPER_MODULES = ("repro_torch.benchmarks.workloads", "repro_torch.benchmarks.fig5_tuning_curves",
                 "repro_torch.benchmarks.fig6_exhaustive",
                 "repro_torch.benchmarks.table2_exploration",
                 "repro_torch.examples.quickstart", "repro_torch.tuning.kernel_objective")


def _probe(names):
    code = _PROBE.format(src=str(ROOT / "src"), root=str(ROOT), names=names)
    return subprocess.run([sys.executable, "-c", code], capture_output=True,
                          text=True, cwd=str(ROOT))


def test_port_has_the_expected_modules():
    for must in ("repro_torch.kernels.ops", "repro_torch.kernels.flash_attention",
                 "repro_torch.kernels.decode_attention", "repro_torch.kernels.rmsnorm",
                 "repro_torch.kernels._build", "repro_torch.models.lm",
                 "repro_torch.models.convert", "repro_torch.serve.serve_step",
                 "repro_torch.launch.serve", "repro_torch.tuning.tundb",
                 "repro_torch.tuning.cache", "repro_torch.configs.registry",
                 "repro_torch.kernels.ssm_scan", "repro_torch.kernels.gla_scan",
                 "repro_torch.tuning.objective", "repro_torch.tuning.evaluator",
                 "repro_torch.tuning.kernel_objective", "repro_torch.tuning.executor",
                 "repro_torch.tuning.remote", "repro_torch.tuning.protocol",
                 "repro_torch.tuning.fidelity", "repro_torch.tuning.schedulers.asha",
                 "repro_torch.tuning.schedulers.base", "repro_torch.tuning.schedulers.hyperband",
                 "repro_torch.tuning.schedulers.pbt", "repro_torch.core.space",
                 "repro_torch.core.observation", "repro_torch.core.history",
                 "repro_torch.core.engine", "repro_torch.core.random_search",
                 "repro_torch.core.exhaustive", "repro_torch.core.genetic",
                 "repro_torch.core.neldermead", "repro_torch.core.tuner",
                 "repro_torch.benchmarks.kernel_sweep", "repro_torch.core.gp",
                 "repro_torch.core.bayesopt", "repro_torch.tuning.corpus",
                 "repro_torch.checkpoint.checkpointer", "repro_torch.launch.worker",
                 "repro_torch.launch.service", "repro_torch.benchmarks.transfer_smoke",
                 "repro_torch.benchmarks.service_smoke",
                 "repro_torch.benchmarks.perf_iterations",
                 "repro_torch.optim.optimizer", "repro_torch.data.pipeline",
                 "repro_torch.runtime.fault_tolerance", "repro_torch.train.train_step",
                 "repro_torch.train.trainer", "repro_torch.launch.train",
                 "repro_torch.models.layers", "repro_torch.models.encdec",
                 *PAPER_MODULES):
        assert must in MODULES


def test_every_port_module_imports_without_jax_or_reference():
    out = _probe(MODULES + ["repro_torch", "repro_torch.kernels",
                            "repro_torch.models", "repro_torch.configs",
                            "repro_torch.core", "repro_torch.tuning.schedulers"])
    assert out.returncode == 0, out.stderr
    assert out.stdout.startswith("clean")


@pytest.mark.parametrize("name", PAPER_MODULES)
def test_paper_module_imports_without_jax_or_reference(name):
    out = _probe([name])
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "clean 1"


def test_chip_smoke_imports_without_jax_or_reference_and_does_no_work():
    out = _probe(["chip_smoke"])
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "clean 1"  # nothing printed at import


def test_chip_smoke_fails_without_a_card():
    import torch
    if torch.cuda.is_available():
        pytest.skip("a card is present: the script would run in full")
    out = subprocess.run([sys.executable, str(ROOT / "chip_smoke.py")],
                         capture_output=True, text=True, cwd=str(ROOT))
    assert out.returncode != 0
    assert '"ok"' not in out.stdout


@pytest.mark.parametrize("needle", ["scaled_dot_product_attention",
                                    "torch.compile", "F.rms_norm", "rms_norm(",
                                    "import jax", "from jax", "from repro.",
                                    "import repro."])
def test_port_sources_do_not_mention(needle):
    hits = [str(p.relative_to(ROOT)) for p in PKG.rglob("*")
            if p.suffix in (".py", ".cu", ".cuh") and needle in p.read_text()]
    assert hits == []


def test_cuda_sources_are_there_and_plain_c():
    for stem in ("flash_attention", "decode_attention", "ssm_scan", "gla_scan"):
        text = (PKG / "kernels" / "csrc" / f"{stem}.cu").read_text()
        assert 'extern "C"' in text and "cudaGetLastError" in text
        assert "torch/" not in text and "ATen" not in text
