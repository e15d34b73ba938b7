"""yi-6b [arXiv:2403.04652; hf]: 32L d=4096 32H (GQA kv=4) d_ff=11008
vocab=64000 — llama-arch GQA, SwiGLU, RMSNorm."""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="yi-6b",
    family="transformer",
    n_layers=32,
    d_model=4096,
    n_heads=32,
    n_kv_heads=4,
    d_ff=11008,
    vocab=64000,
    rope_theta=5_000_000.0,
)

SMOKE = CONFIG.replace(
    n_layers=2, d_model=64, n_heads=4, n_kv_heads=2, head_dim=16,
    d_ff=128, vocab=512)
