"""jamba-v0.1-52b [arXiv:2403.19887; hf]: 32L d=4096 32H (GQA kv=8)
d_ff=14336 vocab=65536, MoE 16e top-2 — Mamba+attention 1:7 interleave,
MoE every 2nd layer. The Mamba mixer is realized with the SSD block
(Mamba-1's selective scan is the head_dim-1 special case of SSD; the
hybrid structure is what Jamba contributes)."""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="jamba-v0.1-52b",
    family="hybrid",
    n_layers=32,
    d_model=4096,
    n_heads=32,
    n_kv_heads=8,
    d_ff=14336,
    vocab=65536,
    n_experts=16,
    top_k=2,
    moe_d_ff=14336,
    moe_every=2,
    attn_every=8,
    ssm_state=16,
    ssm_head_dim=64,
    ssm_groups=1,
    conv_width=4,
    expand=2,
)

SMOKE = CONFIG.replace(
    n_layers=8, attn_every=8, d_model=64, n_heads=4, n_kv_heads=2,
    head_dim=16, d_ff=128, moe_d_ff=128, vocab=512, n_experts=4, top_k=2,
    ssm_state=16, ssm_head_dim=16, ssm_chunk=16)
