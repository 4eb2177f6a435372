"""HuBERT-XLarge [arXiv:2106.07447; audio encoder, w2v2 backbone].

Encoder-only: bidirectional attention, no decode shapes.  The conv
waveform frontend is a STUB: ``input_specs()`` provides precomputed
frame embeddings (B, S, d_model); the head predicts the 504-class
cluster vocabulary (masked-prediction training).
"""
from ..models.config import ModelConfig

CONFIG = ModelConfig(
    name="hubert-xlarge", family="encoder",
    n_layers=48, d_model=1280, n_heads=16, n_kv_heads=16, head_dim=80,
    d_ff=5120, vocab_size=504, frontend="audio",
    micro_batches=8,
)

SMOKE = ModelConfig(
    name="hubert-xlarge-smoke", family="encoder",
    n_layers=2, d_model=64, n_heads=4, n_kv_heads=4, head_dim=16,
    d_ff=128, vocab_size=32, frontend="audio", attn_chunk=32,
    micro_batches=1,
)
