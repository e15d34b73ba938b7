"""mamba2-2.7b [arXiv:2405.21060]: 64L d=2560 vocab=50280 ssm_state=128 —
attention-free SSD (state-space duality). d_inner = 2*2560 = 5120, 80 heads
of dim 64, 1 B/C group, conv width 4, tied embeddings."""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="mamba2-2.7b",
    family="ssm",
    n_layers=64,
    d_model=2560,
    n_heads=0,
    vocab=50280,
    ssm_state=128,
    ssm_head_dim=64,
    ssm_groups=1,
    ssm_chunk=256,
    conv_width=4,
    expand=2,
    tie_embeddings=True,
)

SMOKE = CONFIG.replace(
    n_layers=2, d_model=64, vocab=512, ssm_state=16, ssm_head_dim=16,
    ssm_chunk=16)
