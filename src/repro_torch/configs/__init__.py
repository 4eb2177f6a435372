"""Architecture registry: one module per architecture (port of
``repro.configs``; the modules are the reference's data, copied).

``get(name)`` returns the full published config; ``get_smoke(name)``
returns a reduced same-family config for CPU tests (small widths, few
experts, tiny vocab).  The paper's machine configuration
(``repro.configs.terapool``) waits for the collectives slice, which it
imports.
"""
from __future__ import annotations

import importlib
from typing import Dict, List

from ..models.config import ModelConfig

ARCH_IDS: List[str] = [
    "qwen3_4b",
    "nemotron_4_340b",
    "codeqwen15_7b",
    "yi_34b",
    "internvl2_76b",
    "hymba_1_5b",
    "hubert_xlarge",
    "falcon_mamba_7b",
    "moonshot_v1_16b_a3b",
    "deepseek_v3_671b",
]

# CLI-facing ids (dashes) -> module names (underscores).
ALIASES: Dict[str, str] = {i.replace("_", "-"): i for i in ARCH_IDS}
ALIASES.update({
    "qwen3-4b": "qwen3_4b",
    "nemotron-4-340b": "nemotron_4_340b",
    "codeqwen1.5-7b": "codeqwen15_7b",
    "yi-34b": "yi_34b",
    "internvl2-76b": "internvl2_76b",
    "hymba-1.5b": "hymba_1_5b",
    "hubert-xlarge": "hubert_xlarge",
    "falcon-mamba-7b": "falcon_mamba_7b",
    "moonshot-v1-16b-a3b": "moonshot_v1_16b_a3b",
    "deepseek-v3-671b": "deepseek_v3_671b",
})


def _module(name: str):
    mod = ALIASES.get(name, name)
    if mod not in ARCH_IDS:
        raise KeyError(f"unknown architecture {name!r}; "
                       f"available: {sorted(ALIASES)}")
    return importlib.import_module(f".{mod}", __package__)


def get(name: str) -> ModelConfig:
    return _module(name).CONFIG


def get_smoke(name: str) -> ModelConfig:
    return _module(name).SMOKE


def all_configs() -> Dict[str, ModelConfig]:
    return {i: get(i) for i in ARCH_IDS}
