"""The ``lm_train_hybrid`` section of
``src/repro_torch/reference_values.json``: ``lm_train_ssm``'s three steps
(``tests/test_torch_lm_train_ssm_values.py``, the same batches,
micro-batches, optimizer and variants) on the Hymba-1.5B smoke config,
the hybrid family: attention of 5 query heads on one KV
head of width 8 under a causal sliding window of 16, beside a Mamba-1
path, in each of two layers.  ``chip_smoke.py``'s ``lm_train`` phase
holds the card (the windowed attention's backward and the scan's) to it
without importing JAX.

    PYTHONPATH=src JAX_PLATFORMS=cpu python tests/test_torch_lm_train_hybrid_values.py

rewrites the section (~50 s on the CPU).  The tests below recompute it
with JAX, and hold the port's CPU run to it at ``lm_train_ssm``'s ``TOL``.
"""
import json

import test_torch_lm_train_ssm_values as ssm
from repro_torch import configs
from torch_threads import one_torch_thread  # noqa: F401 (autouse)

SECTION = "lm_train_hybrid"
ARCH = "hymba_1_5b"


def test_section_matches_jax():
    """The stored runs are what the JAX package computes now."""
    assert ssm.load(SECTION) == json.loads(json.dumps(ssm.section(ARCH)))


def test_section_matches_port():
    """The port's train step on the CPU holds to the stored values."""
    cfg = configs.get_smoke(ssm.load(SECTION)["arch"])
    assert cfg.family == "hybrid" and cfg.attn_window > 0
    ssm.port_gaps(SECTION)


if __name__ == "__main__":
    ssm.write(SECTION, ARCH)
