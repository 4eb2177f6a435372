"""Model definitions (port of ``repro.models``): configs, layers, GQA
attention, multi-head latent attention (``mla``), the mixture of experts
(``moe``) and the dense, encoder and MoE stacks.  ``loss_fn`` (training)
and the SSM module wait for their slices; ``convert`` carries the
reference's parameters and caches over."""
from . import attention, layers, mla, moe, transformer
from .config import (SHAPES, SHAPES_BY_NAME, ModelConfig, ShapeCell,
                     applicable_shapes, skip_reason)
from .transformer import forward, init_caches, init_params, param_defs

__all__ = [
    "SHAPES", "SHAPES_BY_NAME", "ModelConfig", "ShapeCell",
    "applicable_shapes", "attention", "forward", "init_caches",
    "init_params", "layers", "mla", "moe", "param_defs", "skip_reason",
    "transformer",
]
