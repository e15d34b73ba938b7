"""Unified model configuration (torch twin of ``repro.configs.base``).

Same fields and defaults as the JAX package's ``ModelConfig``; only
``cdtype`` differs, naming a ``torch`` dtype instead of a ``jnp`` one.
"""
from __future__ import annotations

import dataclasses

import torch


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str                      # transformer | moe | hybrid | ssm | encoder | vlm
    n_layers: int
    d_model: int
    vocab: int

    # attention
    n_heads: int = 0
    n_kv_heads: int = 0
    head_dim: int = 0                # 0 -> d_model // n_heads
    rope_theta: float = 10_000.0
    sliding_window: int = 0          # 0 -> full attention
    global_every: int = 0            # gemma3: every k-th layer is global
    causal: bool = True

    # mlp
    d_ff: int = 0
    mlp_type: str = "swiglu"         # swiglu | geglu | gelu (non-gated)

    # MoE
    n_experts: int = 0
    n_shared_experts: int = 0
    top_k: int = 0
    moe_d_ff: int = 0
    moe_every: int = 1
    first_dense: int = 0
    capacity_factor: float = 1.0
    router_type: str = "softmax"

    # MLA
    use_mla: bool = False
    q_lora_rank: int = 0
    kv_lora_rank: int = 0
    qk_nope_dim: int = 0
    qk_rope_dim: int = 0
    v_head_dim: int = 0

    # MTP
    mtp_depth: int = 0

    # SSM
    ssm_state: int = 0
    ssm_heads: int = 0
    ssm_head_dim: int = 64
    ssm_groups: int = 1
    ssm_chunk: int = 256
    conv_width: int = 4
    expand: int = 2
    attn_every: int = 0

    # VLM / encoder frontends
    n_prefix: int = 0
    frontend_dim: int = 0

    # numerics
    dtype: str = "bfloat16"
    rms_eps: float = 1e-6
    tie_embeddings: bool = False
    norm_type: str = "rms"
    use_bias: bool = False
    use_qk_norm: bool = False

    # SPARQLe quantized serving
    w_bits: int = 4
    kv_bits: int = 4

    @property
    def hd(self) -> int:
        return self.head_dim or (self.d_model // max(1, self.n_heads))

    @property
    def d_inner(self) -> int:
        return self.expand * self.d_model

    @property
    def cdtype(self) -> torch.dtype:
        return torch.bfloat16 if self.dtype == "bfloat16" else torch.float32

    def replace(self, **kw) -> "ModelConfig":
        return dataclasses.replace(self, **kw)


@dataclasses.dataclass(frozen=True)
class ShapeConfig:
    """One assigned input-shape cell."""
    name: str
    seq_len: int
    global_batch: int
    kind: str                        # train | prefill | decode

    @property
    def is_decode(self) -> bool:
        return self.kind == "decode"


SHAPES = {
    "train_4k": ShapeConfig("train_4k", 4_096, 256, "train"),
    "prefill_32k": ShapeConfig("prefill_32k", 32_768, 32, "prefill"),
    "decode_32k": ShapeConfig("decode_32k", 32_768, 128, "decode"),
    "long_500k": ShapeConfig("long_500k", 524_288, 1, "decode"),
}

# smoke-test shape (CPU, reduced configs)
SMOKE_SHAPE = ShapeConfig("smoke", 64, 2, "train")
