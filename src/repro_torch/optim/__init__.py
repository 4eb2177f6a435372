"""Optimizers with the reference's state layouts (port of
``repro.optim``)."""
from . import quant
from .adamw import (OptConfig, global_norm_sq, init, schedule, state_defs,
                    update)

__all__ = ["OptConfig", "global_norm_sq", "init", "quant", "schedule",
           "state_defs", "update"]
