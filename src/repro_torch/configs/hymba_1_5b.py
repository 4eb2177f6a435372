"""Hymba-1.5B [arXiv:2411.13676; hybrid parallel attention + Mamba heads].

Hymba fuses attention and SSM heads in the SAME layer (parallel paths,
learned mixing).  We model all attention as sliding-window (w=1024) —
the sub-quadratic mixer is what qualifies this arch for the
``long_500k`` cell; the few global-attention layers of the release
checkpoint and the meta-tokens are noted as simplifications in
DESIGN.md.
"""
from ..models.config import ModelConfig

CONFIG = ModelConfig(
    name="hymba-1.5b", family="hybrid",
    n_layers=32, d_model=1600, n_heads=25, n_kv_heads=5, head_dim=64,
    d_ff=5504, vocab_size=32001, ssm_state=16, attn_window=1024,
    rope_theta=1e4, micro_batches=8,
)

SMOKE = ModelConfig(
    name="hymba-1.5b-smoke", family="hybrid",
    n_layers=2, d_model=64, n_heads=5, n_kv_heads=1, head_dim=8,
    d_ff=128, vocab_size=256, ssm_state=8, attn_window=16,
    attn_chunk=16, micro_batches=1,
)
