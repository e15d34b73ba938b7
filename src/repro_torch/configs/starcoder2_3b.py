"""starcoder2-3b [arXiv:2402.19173; hf]: 30L d=3072 24H (GQA kv=2)
d_ff=12288 vocab=49152 — GQA, RoPE, layernorm+bias, non-gated GELU MLP."""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="starcoder2-3b",
    family="transformer",
    n_layers=30,
    d_model=3072,
    n_heads=24,
    n_kv_heads=2,
    d_ff=12288,
    vocab=49152,
    rope_theta=999_999.0,
    mlp_type="gelu",
    norm_type="layer",
    use_bias=True,
)

SMOKE = CONFIG.replace(
    n_layers=2, d_model=64, n_heads=4, n_kv_heads=2, head_dim=16,
    d_ff=128, vocab=512)
