"""Deterministic synthetic data pipeline (port of ``repro.data``)."""
from .pipeline import DataConfig, SyntheticLM, batch_for_model

__all__ = ["DataConfig", "SyntheticLM", "batch_for_model"]
