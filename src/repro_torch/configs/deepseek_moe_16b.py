"""deepseek-moe-16b [arXiv:2401.06066; hf]: 28L d=2048 16H vocab=102400,
fine-grained MoE: 2 shared + 64 routed top-6 (expert d_ff=1408), first
layer dense (d_ff 10944). MHA (kv=16). Full attention -> long_500k skip."""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="deepseek-moe-16b",
    family="moe",
    n_layers=28,
    d_model=2048,
    n_heads=16,
    n_kv_heads=16,
    vocab=102_400,
    d_ff=10944,                  # leading dense layer
    n_experts=64,
    n_shared_experts=2,
    top_k=6,
    moe_d_ff=1408,
    moe_every=1,
    first_dense=1,
    router_type="softmax",
)

SMOKE = CONFIG.replace(
    n_layers=3, first_dense=1, d_model=64, n_heads=4, n_kv_heads=4,
    head_dim=16, d_ff=128, moe_d_ff=32, n_experts=8, n_shared_experts=2,
    top_k=2, vocab=512)
