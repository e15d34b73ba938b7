"""deepseek-v3-671b [arXiv:2412.19437; hf]: 61L d=7168 128H vocab=129280,
MoE 1 shared + 256 routed top-8 (expert d_ff=2048, per the assignment's
d_ff), MLA (q_lora 1536, kv_lora 512, qk 128+64 nope+rope, v 128),
first 3 layers dense (d_ff 18432, per the HF config), sigmoid router,
MTP depth 1. Full attention -> ``long_500k`` skipped."""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="deepseek-v3-671b",
    family="moe",
    n_layers=61,
    d_model=7168,
    n_heads=128,
    n_kv_heads=128,
    vocab=129_280,
    d_ff=18432,                  # the 3 leading dense layers
    n_experts=256,
    n_shared_experts=1,
    top_k=8,
    moe_d_ff=2048,               # assignment's d_ff = expert width
    moe_every=1,
    first_dense=3,
    router_type="sigmoid",
    use_mla=True,
    q_lora_rank=1536,
    kv_lora_rank=512,
    qk_nope_dim=128,
    qk_rope_dim=64,
    v_head_dim=128,
    mtp_depth=1,
)

SMOKE = CONFIG.replace(
    n_layers=3, first_dense=1, d_model=64, n_heads=4, n_kv_heads=4,
    d_ff=128, moe_d_ff=64, n_experts=8, top_k=2, vocab=512,
    q_lora_rank=32, kv_lora_rank=32, qk_nope_dim=16, qk_rope_dim=8,
    v_head_dim=16, mtp_depth=1)
