"""Hand-written Hopper kernels: the 5G pipeline's FFT stage and matmul,
and the Fig. 5/6 benchmark kernels' dot product and AXPY.

``fft4.py``, ``matmul.py``, ``dotp.py`` and ``axpy.py`` hold the CUDA
kernels' wrappers (with their launch counters) beside their plain
PyTorch versions; ``ops.py`` the public wrappers; ``ref.py`` the plain
oracles; ``_build.py`` compiles ``csrc/*.cu`` with ``nvcc`` at first
use.
"""
