"""Model definitions (port of ``repro.models``): configs, layers and the
dense/encoder stacks.  ``loss_fn`` and the MLA, MoE and SSM modules wait
for their slices; ``convert`` carries the reference's parameters over."""
from . import attention, layers, transformer
from .config import (SHAPES, SHAPES_BY_NAME, ModelConfig, ShapeCell,
                     applicable_shapes, skip_reason)
from .transformer import forward, init_caches, init_params, param_defs

__all__ = [
    "SHAPES", "SHAPES_BY_NAME", "ModelConfig", "ShapeCell",
    "applicable_shapes", "attention", "forward", "init_caches",
    "init_params", "layers", "param_defs", "skip_reason", "transformer",
]
