"""Build and load the CUDA C++ kernels: ``nvcc`` by hand, ``ctypes`` to bind.

Each source under ``csrc/`` exposes a plain C interface (no PyTorch
headers, so a build takes seconds) and becomes one shared library

    <build dir>/<stem>-<content hash>.so

built at first use.  The hash covers the source text and the compiler
flags, so an edited source builds anew and a stale library is never
loaded.  ``build_all`` starts one ``nvcc`` per source at the same time.

The build directory is ``$REPRO_TORCH_BUILD_DIR`` if set, else ``build/``
at the root of the checkout (listed in ``.gitignore``).

Every exported C function returns ``cudaGetLastError()`` as an ``int``;
``check`` turns a non-zero code into a ``RuntimeError``.  Nothing here
falls back to another implementation: a failed build raises with the
compiler's output.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import pathlib
import shutil
import subprocess
from typing import Dict, Iterable, Optional

CSRC = pathlib.Path(__file__).resolve().parent / "csrc"

NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
)

#: every CUDA source of the package (stem -> file under csrc/)
SOURCES = {
    "flash_attention": "flash_attention.cu",
    "decode_attention": "decode_attention.cu",
    "ssm_scan": "ssm_scan.cu",
    "gla_scan": "gla_scan.cu",
    "gla_scan_bwd": "gla_scan_bwd.cu",
}

_LIBS: Dict[str, ctypes.CDLL] = {}


def build_dir() -> pathlib.Path:
    env = os.environ.get("REPRO_TORCH_BUILD_DIR")
    if env:
        return pathlib.Path(env)
    # src/repro_torch/kernels/_build.py -> checkout root
    return pathlib.Path(__file__).resolve().parents[3] / "build"


def find_nvcc() -> str:
    for cand in (os.environ.get("NVCC"),
                 shutil.which("nvcc"),
                 os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"),
                              "bin", "nvcc")):
        if cand and os.path.isfile(cand):
            return cand
    raise RuntimeError(
        "nvcc not found (looked at $NVCC, PATH, $CUDA_HOME/bin and "
        "/usr/local/cuda/bin): the CUDA kernels of repro_torch are built "
        "from source at first use and need the CUDA toolkit")


def _lib_path(stem: str) -> pathlib.Path:
    src = CSRC / SOURCES[stem]
    h = hashlib.sha256()
    h.update(src.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return build_dir() / f"{stem}-{h.hexdigest()[:16]}.so"


def _start_build(stem: str, out: pathlib.Path, extra_flags=()):
    out.parent.mkdir(parents=True, exist_ok=True)
    tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
    cmd = [find_nvcc(), *NVCC_FLAGS, *extra_flags, "-o", str(tmp),
           str(CSRC / SOURCES[stem])]
    proc = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True)
    return proc, tmp, cmd


def _finish_build(stem, proc, tmp, cmd, out) -> str:
    log, _ = proc.communicate()
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(
            f"nvcc failed for {SOURCES[stem]} (exit {proc.returncode}):\n"
            f"$ {' '.join(cmd)}\n{log}")
    os.replace(tmp, out)  # atomic: a concurrent loader never sees a torn file
    return log


def build_all(stems: Optional[Iterable[str]] = None, *,
              extra_flags=()) -> Dict[str, str]:
    """Build every library that is missing, all compilers started together.
    Returns ``{stem: compiler output}`` for the ones built now."""
    todo = []
    for stem in (SOURCES if stems is None else stems):
        out = _lib_path(stem)
        if not out.exists():
            todo.append((stem, out, *_start_build(stem, out, extra_flags)))
    return {stem: _finish_build(stem, proc, tmp, cmd, out)
            for stem, out, proc, tmp, cmd in todo}


def load(stem: str) -> ctypes.CDLL:
    """The shared library of one source, built now if it is not there."""
    lib = _LIBS.get(stem)
    if lib is None:
        build_all([stem])
        lib = _LIBS[stem] = ctypes.CDLL(str(_lib_path(stem)))
    return lib


def check(code: int, what: str) -> None:
    """Raise on a non-zero ``cudaError_t`` returned by a launch."""
    if code != 0:
        raise RuntimeError(
            f"{what}: CUDA launch failed with cudaError {code} (the kernel "
            "did not run; too many threads or too much shared memory for "
            "this configuration?)")
