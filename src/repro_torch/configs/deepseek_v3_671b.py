"""DeepSeek-V3-671B [arXiv:2412.19437; MLA + 1 shared / 256 routed
top-8 MoE + MTP].

Memory plan for 256 x 16 GiB (train_4k): bf16 params 5.2 GiB/chip +
int8 first moment 2.6 GiB + factored second moment (~0) + bf16 grad
accumulation 5.2 GiB; MLA latent decode cache is sequence-sharded.
"""
from ..models.config import ModelConfig

CONFIG = ModelConfig(
    name="deepseek-v3-671b", family="moe",
    n_layers=61, d_model=7168, n_heads=128, n_kv_heads=128, head_dim=128,
    d_ff=18432, d_ff_expert=2048, vocab_size=129280,
    n_experts=256, top_k=8, n_shared_experts=1, n_dense_layers=3,
    use_mla=True, q_lora_rank=1536, kv_lora_rank=512,
    qk_nope_dim=128, qk_rope_dim=64, v_head_dim=128,
    use_mtp=True, rope_theta=1e4,
    micro_batches=8, fsdp_serve=True, serve_2d_tp=True, seq_shard_acts=True,
    master_dtype="bfloat16", moment_dtype="int8",
    factored_second_moment=True, grad_accum_dtype="bfloat16",
)

SMOKE = ModelConfig(
    name="deepseek-v3-671b-smoke", family="moe",
    n_layers=3, d_model=64, n_heads=4, n_kv_heads=4, head_dim=16,
    d_ff=128, d_ff_expert=32, vocab_size=256,
    n_experts=8, top_k=2, n_shared_experts=1, n_dense_layers=1,
    use_mla=True, q_lora_rank=32, kv_lora_rank=16,
    qk_nope_dim=16, qk_rope_dim=8, v_head_dim=16,
    use_mtp=True, attn_chunk=32, micro_batches=1,
    master_dtype="bfloat16", moment_dtype="int8",
    factored_second_moment=True, grad_accum_dtype="bfloat16",
)
