"""granite-8b [arXiv:2405.04324; hf]: 36L d=4096 32H (GQA kv=8)
d_ff=14336 vocab=49152 — llama-arch code model (SwiGLU, RMSNorm, tied)."""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="granite-8b",
    family="transformer",
    n_layers=36,
    d_model=4096,
    n_heads=32,
    n_kv_heads=8,
    d_ff=14336,
    vocab=49152,
    rope_theta=10_000.0,
    tie_embeddings=True,
)

SMOKE = CONFIG.replace(
    n_layers=2, d_model=64, n_heads=4, n_kv_heads=2, head_dim=16,
    d_ff=128, vocab=512)
