"""Moonshot-v1-16B-A3B [hf:moonshotai/Moonlight-16B-A3B; MoE 64e top-6].

Moonlight-style: leading dense layer, 64 routed experts (top-6) +
2 shared experts, GQA(kv=16 == MHA at 16 heads).
"""
from ..models.config import ModelConfig

CONFIG = ModelConfig(
    name="moonshot-v1-16b-a3b", family="moe",
    n_layers=48, d_model=2048, n_heads=16, n_kv_heads=16, head_dim=128,
    d_ff=11264, d_ff_expert=1408, vocab_size=163840,
    n_experts=64, top_k=6, n_shared_experts=2, n_dense_layers=1,
    rope_theta=5e4, micro_batches=8,
)

SMOKE = ModelConfig(
    name="moonshot-v1-16b-a3b-smoke", family="moe",
    n_layers=3, d_model=64, n_heads=4, n_kv_heads=4, head_dim=16,
    d_ff=128, d_ff_expert=32, vocab_size=256,
    n_experts=8, top_k=2, n_shared_experts=2, n_dense_layers=1,
    attn_chunk=32, micro_batches=1,
)
