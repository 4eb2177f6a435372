"""Atomic checkpointing (port of ``repro.checkpoint``)."""
from .ckpt import latest_step, prune, restore, save

__all__ = ["latest_step", "prune", "restore", "save"]
