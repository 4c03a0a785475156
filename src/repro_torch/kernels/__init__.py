"""Hand-written Hopper kernels for the compute hot-spots, with pure-PyTorch
oracles.

Layout per kernel: ``<name>.py`` (wrapper, plain version, launch counter),
``csrc/<name>.cu`` for the CUDA C++ ones, ``ops.py`` (impl dispatch +
TuningDB consult), ``ref.py`` (oracles), ``_build.py`` (nvcc + ctypes).
"""
from repro_torch.kernels import ops, ref

__all__ = ["ops", "ref"]
