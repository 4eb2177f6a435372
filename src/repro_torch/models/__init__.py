"""Model definitions (port of ``repro.models``): configs, layers, GQA
attention (with the sliding window), multi-head latent attention
(``mla``), the mixture of experts (``moe``), the Mamba-1 block (``ssm``)
and the stacks of every family.  ``loss_fn`` (training) waits for its
slice; ``convert`` carries the reference's parameters and caches over."""
from . import attention, layers, mla, moe, ssm, transformer
from .config import (SHAPES, SHAPES_BY_NAME, ModelConfig, ShapeCell,
                     applicable_shapes, skip_reason)
from .transformer import forward, init_caches, init_params, param_defs

__all__ = [
    "SHAPES", "SHAPES_BY_NAME", "ModelConfig", "ShapeCell",
    "applicable_shapes", "attention", "forward", "init_caches",
    "init_params", "layers", "mla", "moe", "param_defs", "skip_reason",
    "ssm", "transformer",
]
