"""Model definitions (port of ``repro.models``): configs, layers, GQA
attention (with the sliding window), multi-head latent attention
(``mla``), the mixture of experts (``moe``), the Mamba-1 block (``ssm``),
the stacks of every family and their training loss (``loss_fn``);
``convert`` carries the reference's parameters, caches and optimizer
state over."""
from . import attention, layers, mla, moe, ssm, transformer
from .config import (SHAPES, SHAPES_BY_NAME, ModelConfig, ShapeCell,
                     applicable_shapes, skip_reason)
from .transformer import (forward, init_caches, init_params, loss_fn,
                          param_defs)

__all__ = [
    "SHAPES", "SHAPES_BY_NAME", "ModelConfig", "ShapeCell",
    "applicable_shapes", "attention", "forward", "init_caches",
    "init_params", "layers", "loss_fn", "mla", "moe", "param_defs",
    "skip_reason",
    "ssm", "transformer",
]
