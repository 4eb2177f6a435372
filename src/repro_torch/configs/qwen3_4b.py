"""Qwen3-4B [hf:Qwen/Qwen3-8B family; dense GQA + qk_norm]."""
from ..models.config import ModelConfig

CONFIG = ModelConfig(
    name="qwen3-4b", family="dense",
    n_layers=36, d_model=2560, n_heads=32, n_kv_heads=8, head_dim=128,
    d_ff=9728, vocab_size=151936, qk_norm=True, rope_theta=1e6,
    micro_batches=8,
)

SMOKE = ModelConfig(
    name="qwen3-4b-smoke", family="dense",
    n_layers=2, d_model=64, n_heads=4, n_kv_heads=2, head_dim=16,
    d_ff=128, vocab_size=256, qk_norm=True, attn_chunk=32,
    micro_batches=1,
)
