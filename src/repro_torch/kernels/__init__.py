"""Hand-written Hopper kernels: the 5G pipeline's FFT stage and matmul,
the Fig. 5/6 benchmark kernels' dot product, AXPY, DCT and Conv2D, the
C library's ``powf`` for the Pareto straggler model, and the LM's
flash attention (with the hybrid family's sliding window) and the SSM
family's selective scan.

``fft4.py``, ``matmul.py``, ``dotp.py``, ``axpy.py``, ``dct.py``,
``conv2d.py``, ``powf.py``, ``flash_attn.py`` and ``ssm_scan.py`` hold
the CUDA kernels' wrappers (with their launch counters) beside their
plain versions;
``ops.py`` the public wrappers; ``ref.py`` the plain PyTorch oracles;
``_build.py`` compiles ``csrc/*.cu`` with ``nvcc`` (and the host helper
``csrc/powf_host.c`` with the host's C compiler) at first use.
"""
