"""paligemma-3b [arXiv:2407.07726; hf]: 18L d=2048 8H (GQA kv=1)
d_ff=16384 vocab=257216 — SigLIP vision tower + gemma-2b decoder. The
vision tower is a stub: the batch carries 256 precomputed patch
embeddings (B, 256, d_model), which are prefixed to the token sequence
with a prefix-LM (bidirectional-prefix) mask. Full attention."""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="paligemma-3b",
    family="vlm",
    n_layers=18,
    d_model=2048,
    n_heads=8,
    n_kv_heads=1,
    head_dim=256,
    d_ff=16384,
    vocab=257_216,
    rope_theta=10_000.0,
    mlp_type="geglu",
    tie_embeddings=True,
    n_prefix=256,
)

SMOKE = CONFIG.replace(
    n_layers=2, d_model=64, n_heads=4, n_kv_heads=1, head_dim=16,
    d_ff=128, vocab=512, n_prefix=4)
