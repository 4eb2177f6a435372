"""Model/config schema for every supported architecture family (port of
``repro.models.config``).

One dataclass covers the families: dense GQA transformers, MoE (incl.
MLA + MTP), pure SSM (Mamba-1), hybrid attention+SSM, and encoder-only
backbones with stub modality frontends.  The fields, defaults and shape
cells equal the reference's; the sharding knobs are kept so a config
reads the same in both packages, though one device uses none of them.
The port runs every family and both frontends on one device.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Optional, Tuple


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str                     # dense | moe | ssm | hybrid | encoder
    n_layers: int
    d_model: int
    vocab_size: int

    # --- attention ---
    n_heads: int = 0
    n_kv_heads: int = 0
    head_dim: int = 0               # 0 -> d_model // n_heads
    qk_norm: bool = False
    qkv_bias: bool = False
    attn_window: int = 0            # 0 -> full attention; else sliding window
    rope_theta: float = 1e6
    causal: bool = True             # False for encoder-only

    # --- MLP ---
    d_ff: int = 0
    act: str = "swiglu"             # swiglu | relu2

    # --- MoE ---
    n_experts: int = 0
    n_shared_experts: int = 0
    top_k: int = 0
    d_ff_expert: int = 0
    n_dense_layers: int = 0         # leading dense layers (DeepSeek: 3)
    capacity_factor: float = 1.25
    router_aux_weight: float = 0.01

    # --- MLA (DeepSeek) ---
    use_mla: bool = False
    q_lora_rank: int = 0
    kv_lora_rank: int = 0
    qk_nope_dim: int = 0
    qk_rope_dim: int = 0
    v_head_dim: int = 0

    # --- SSM (Mamba-1) ---
    ssm_state: int = 0
    d_conv: int = 4
    expand: int = 2
    dt_rank: int = 0                # 0 -> ceil(d_model / 16)

    # --- extras ---
    use_mtp: bool = False           # multi-token-prediction head
    mtp_loss_weight: float = 0.1
    frontend: str = "none"          # none | vision | audio (stub embeddings)
    n_frontend_tokens: int = 0      # prepended embedding positions (vision)
    tie_embeddings: bool = False

    # --- numerics / compile shape ---
    param_dtype: str = "bfloat16"
    compute_dtype: str = "bfloat16"
    scan_layers: bool = True
    remat: bool = True
    attn_chunk: int = 1024          # flash-style block size (q and kv)

    # Mesh axes that shard the batch dim of activations (decode under
    # 2D-TP replicates activations instead: set to ()), and the axes
    # that shard activation feature dims (2D-TP: ("model", "data")).
    batch_axes: Tuple[str, ...] = ("pod", "data")
    tp_axes: Tuple[str, ...] = ("model",)

    # --- distribution knobs (per-arch defaults; overridable per run) ---
    fsdp_train: bool = True         # ZeRO-3 sharding of params over `data`
    fsdp_serve: bool = False        # gather-per-layer serving (huge models)
    serve_2d_tp: bool = False       # serve with TP over (model x data):
                                    # weights fully sharded, no per-layer
                                    # gathers (decode perf iteration)
    seq_shard_acts: bool = False    # Megatron-SP carry sharding: only the
                                    # >=70B archs need it (scan-carry HBM)
    moe_parallel: str = "ep"        # ep | tp
    micro_batches: int = 8          # grad-accumulation steps per train_step
    grad_accum_dtype: str = "float32"
    # optimizer state layout (distributed-optimization tricks)
    master_dtype: str = "float32"   # float32 | bfloat16 ("none" == bf16)
    moment_dtype: str = "float32"   # float32 | bfloat16 | int8
    factored_second_moment: bool = False

    def __post_init__(self):
        if self.family not in ("dense", "moe", "ssm", "hybrid", "encoder"):
            raise ValueError(f"unknown family {self.family!r}")
        if self.family != "ssm" and self.n_heads <= 0:
            raise ValueError("attention families need n_heads")
        if self.head_dim == 0 and self.n_heads:
            object.__setattr__(self, "head_dim", self.d_model // self.n_heads)
        if self.dt_rank == 0 and (self.family in ("ssm", "hybrid")):
            object.__setattr__(self, "dt_rank",
                               math.ceil(self.d_model / 16))
        if self.family == "encoder":
            object.__setattr__(self, "causal", False)

    # ------------------------------------------------------------------
    @property
    def d_inner(self) -> int:
        """Mamba inner width."""
        return self.expand * self.d_model

    @property
    def n_rep(self) -> int:
        """GQA repetition factor."""
        return self.n_heads // max(self.n_kv_heads, 1)

    @property
    def has_attention(self) -> bool:
        return self.family != "ssm"

    @property
    def has_ssm(self) -> bool:
        return self.family in ("ssm", "hybrid")

    @property
    def is_moe(self) -> bool:
        return self.n_experts > 0

    @property
    def n_moe_layers(self) -> int:
        return self.n_layers - self.n_dense_layers if self.is_moe else 0

    # ------------------------------------------------------------------
    def param_count(self) -> int:
        """Total parameter count (exact, matches param_defs)."""
        from . import transformer  # local import to avoid cycle
        from .layers import tree_leaves
        return sum(math.prod(d.shape)
                   for d in tree_leaves(transformer.param_defs(self)))

    def active_param_count(self) -> int:
        """Active parameters per token (MoE: routed top-k + shared)."""
        if not self.is_moe:
            return self.param_count()
        total = self.param_count()
        # Remove inactive routed experts.
        expert = 3 * self.d_model * self.d_ff_expert
        inactive = (self.n_experts - self.top_k) * expert * self.n_moe_layers
        return total - inactive


@dataclasses.dataclass(frozen=True)
class ShapeCell:
    """One (architecture x input-shape) dry-run cell."""

    name: str                       # train_4k | prefill_32k | ...
    kind: str                       # train | prefill | decode
    seq_len: int
    global_batch: int

    @property
    def tokens(self) -> int:
        return self.seq_len * self.global_batch


SHAPES: Tuple[ShapeCell, ...] = (
    ShapeCell("train_4k", "train", 4096, 256),
    ShapeCell("prefill_32k", "prefill", 32768, 32),
    ShapeCell("decode_32k", "decode", 32768, 128),
    ShapeCell("long_500k", "decode", 524288, 1),
)

SHAPES_BY_NAME = {s.name: s for s in SHAPES}


def applicable_shapes(cfg: ModelConfig) -> Tuple[ShapeCell, ...]:
    """Which of the four shape cells an architecture actually runs
    (DESIGN.md §4): encoder-only archs have no decode; ``long_500k``
    needs a sub-quadratic token mixer."""
    out = []
    for s in SHAPES:
        if cfg.family == "encoder" and s.kind == "decode":
            continue
        if (s.name == "long_500k"
                and not (cfg.has_ssm or cfg.attn_window > 0)):
            continue
        out.append(s)
    return tuple(out)


def skip_reason(cfg: ModelConfig, shape: ShapeCell) -> Optional[str]:
    if cfg.family == "encoder" and shape.kind == "decode":
        return "encoder-only: no autoregressive decode step"
    if shape.name == "long_500k" and not (cfg.has_ssm or cfg.attn_window):
        return "full quadratic attention: 524k-token decode infeasible"
    return None
