"""PyTorch/CUDA port of the TeraPool barrier-synchronization system.

A second package beside the JAX reference ``repro``, with the same
layout and module names: ``core/`` holds the cycle-level barrier
simulator, the Fig. 4a sweep and the Fig. 7 5G application as batched
torch ops; ``kernels/`` holds the hand-written Hopper (``sm_90a``) CUDA
kernels that execute the 5G pipeline, each beside its plain PyTorch
version.  The package imports torch and numpy only.

Entry points take ``device=`` and default to ``"cuda"``; without a
CUDA device they raise instead of falling back to the CPU.
"""
from ._device import resolve_device

__all__ = ["resolve_device"]
