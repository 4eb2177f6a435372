"""Falcon-Mamba-7B [arXiv:2410.05355; pure Mamba-1, attention-free].

Attention-sharding aspects of the paper's technique are inapplicable
(DESIGN.md §Arch-applicability): TP shards the SSM channel dimension
(d_inner) instead; the hierarchical gradient-sync schedules apply
unchanged.  O(1)-state decode qualifies the arch for ``long_500k``.
"""
from ..models.config import ModelConfig

CONFIG = ModelConfig(
    name="falcon-mamba-7b", family="ssm",
    n_layers=64, d_model=4096, vocab_size=65024,
    ssm_state=16, d_conv=4, expand=2, d_ff=0,
    micro_batches=8,
)

SMOKE = ModelConfig(
    name="falcon-mamba-7b-smoke", family="ssm",
    n_layers=2, d_model=64, vocab_size=256, ssm_state=8,
    d_conv=4, expand=2, d_ff=0, micro_batches=1,
)
