"""PyTorch / CUDA port of the ``repro`` tuning framework for one NVIDIA H100.

Same sub-package layout as the JAX reference package (``configs``,
``kernels``, ``models``, ``serve``, ``tuning``, ``launch``) so every module
has a findable counterpart.  This package imports ``torch`` and never
``jax`` nor anything of ``repro``.
"""
