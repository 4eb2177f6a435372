"""Yi-34B [arXiv:2403.04652; llama-arch GQA]."""
from ..models.config import ModelConfig

CONFIG = ModelConfig(
    name="yi-34b", family="dense",
    n_layers=60, d_model=7168, n_heads=56, n_kv_heads=8, head_dim=128,
    d_ff=20480, vocab_size=64000, rope_theta=5e6,
    micro_batches=8, seq_shard_acts=True,
)

SMOKE = ModelConfig(
    name="yi-34b-smoke", family="dense",
    n_layers=2, d_model=64, n_heads=7, n_kv_heads=1, head_dim=8,
    d_ff=128, vocab_size=256, attn_chunk=32, micro_batches=1,
)
