"""gemma3-27b [hf:google/gemma-3-*-pt]: 62L d=5376 32H (GQA kv=16)
d_ff=21504 vocab=262144 — 5:1 local:global attention (1024 sliding window,
global layers at rope theta 1M), qk-norm, GeGLU, tied embeddings, 128k ctx.
``long_500k`` runs: 5/6 of layers are sliding-window (sub-quadratic); the
1-in-6 global layers are O(L) per decoded token."""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="gemma3-27b",
    family="transformer",
    n_layers=62,
    d_model=5376,
    n_heads=32,
    n_kv_heads=16,
    head_dim=128,
    d_ff=21504,
    vocab=262_144,
    rope_theta=10_000.0,          # local layers; global layers use 1e6
    sliding_window=1024,
    global_every=6,               # 5 local : 1 global
    mlp_type="geglu",
    use_qk_norm=True,
    tie_embeddings=True,
)

SMOKE = CONFIG.replace(
    n_layers=6, global_every=3, sliding_window=16,
    d_model=64, n_heads=4, n_kv_heads=2, head_dim=16, d_ff=128, vocab=512)
