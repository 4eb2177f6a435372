"""CodeQwen1.5-7B [hf:Qwen/CodeQwen1.5-7B; qwen1.5 arch, MHA + qkv bias]."""
from ..models.config import ModelConfig

CONFIG = ModelConfig(
    name="codeqwen1.5-7b", family="dense",
    n_layers=32, d_model=4096, n_heads=32, n_kv_heads=32, head_dim=128,
    d_ff=13440, vocab_size=92416, qkv_bias=True, rope_theta=1e6,
    micro_batches=8,
)

SMOKE = ModelConfig(
    name="codeqwen1.5-7b-smoke", family="dense",
    n_layers=2, d_model=64, n_heads=4, n_kv_heads=4, head_dim=16,
    d_ff=128, vocab_size=256, qkv_bias=True, attn_chunk=32,
    micro_batches=1,
)
