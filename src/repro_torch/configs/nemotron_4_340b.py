"""Nemotron-4-340B [arXiv:2402.16819; dense GQA + squared-ReLU].

Memory plan for 256 x 16 GiB (train_4k): ZeRO-3 over ``data`` x TP over
``model`` => bf16 params 2.7 GiB/chip + int8 channel-quantized moments
2.7 GiB + bf16 grad accumulation 2.7 GiB + seq-sharded rematerialized
activations at 16 grad-accumulation microbatches.
"""
from ..models.config import ModelConfig

CONFIG = ModelConfig(
    name="nemotron-4-340b", family="dense",
    n_layers=96, d_model=18432, n_heads=96, n_kv_heads=8, head_dim=192,
    d_ff=73728, vocab_size=256000, act="relu2", rope_theta=1e4,
    micro_batches=16, fsdp_serve=True, serve_2d_tp=True, seq_shard_acts=True,
    master_dtype="bfloat16", moment_dtype="int8",
    grad_accum_dtype="bfloat16",
)

SMOKE = ModelConfig(
    name="nemotron-4-340b-smoke", family="dense",
    n_layers=2, d_model=64, n_heads=8, n_kv_heads=2, head_dim=8,
    d_ff=256, vocab_size=256, act="relu2", attn_chunk=32,
    micro_batches=1, moment_dtype="int8", grad_accum_dtype="bfloat16",
)
