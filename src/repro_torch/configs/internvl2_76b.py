"""InternVL2-76B [arXiv:2404.16821; InternViT frontend + LLaMA-70B-class
text backbone].

The vision frontend is a STUB per the assignment: ``input_specs()``
supplies precomputed patch embeddings (256 tokens) that are spliced in
front of the token stream; only the transformer backbone is modeled.
"""
from ..models.config import ModelConfig

CONFIG = ModelConfig(
    name="internvl2-76b", family="dense",
    n_layers=80, d_model=8192, n_heads=64, n_kv_heads=8, head_dim=128,
    d_ff=28672, vocab_size=128256, rope_theta=5e5,
    frontend="vision", n_frontend_tokens=256,
    micro_batches=8, fsdp_serve=True, serve_2d_tp=True, seq_shard_acts=True,
)

SMOKE = ModelConfig(
    name="internvl2-76b-smoke", family="dense",
    n_layers=2, d_model=64, n_heads=4, n_kv_heads=2, head_dim=16,
    d_ff=128, vocab_size=256, frontend="vision", n_frontend_tokens=8,
    attn_chunk=32, micro_batches=1,
)
