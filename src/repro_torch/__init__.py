"""PyTorch/CUDA port of the TeraPool barrier-synchronization system.

A second package beside the JAX reference ``repro``, with the same
layout and module names: ``core/`` holds the cycle-level barrier
simulator (plain and degradation-tolerant), the sweeps, the tuner and
the Fig. 7 5G application as batched torch ops; ``kernels/`` holds the
hand-written Hopper (``sm_90a``) CUDA kernels that execute the 5G
pipeline, the Fig. 5/6 benchmark kernels and the LM's prefill
attention, each beside its plain PyTorch version; ``models/``,
``configs/`` and ``launch/`` hold the LM serving path of the dense
family.  The package imports torch and numpy only.

Entry points take ``device=`` and default to ``"cuda"``; without a
CUDA device they raise instead of falling back to the CPU.
"""
from ._device import resolve_device

__all__ = ["resolve_device"]
