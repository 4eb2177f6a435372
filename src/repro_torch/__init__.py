"""PyTorch/CUDA port of the TeraPool barrier-synchronization system.

A second package beside the JAX reference ``repro``, with the same
layout and module names: ``core/`` holds the cycle-level barrier
simulator (plain and degradation-tolerant), the sweeps, the tuner and
the Fig. 7 5G application as batched torch ops; ``kernels/`` holds the
hand-written Hopper (``sm_90a``) CUDA kernels that execute the 5G
pipeline and the Fig. 5/6 benchmark kernels, each beside its plain
PyTorch version.  The package imports torch and numpy only.

Entry points take ``device=`` and default to ``"cuda"``; without a
CUDA device they raise instead of falling back to the CPU.
"""
from ._device import resolve_device

__all__ = ["resolve_device"]
