"""Hand-written Hopper kernels for the 5G pipeline.

``fft4.py`` and ``matmul.py`` each hold one CUDA kernel's wrapper (with
its launch counter) beside its plain PyTorch version; ``ops.py`` the
public wrappers; ``ref.py`` the plain oracles; ``_build.py`` compiles
``csrc/*.cu`` with ``nvcc`` at first use.
"""
