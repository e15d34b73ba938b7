"""hubert-xlarge [arXiv:2106.07447]: 48L d=1280 16H d_ff=5120 vocab=504 —
encoder-only audio transformer (w2v2 arch). The conv feature extractor is a
stub: the batch carries precomputed frame embeddings ``frames`` (B, S,
d_model). Attention is bidirectional and there is no decode step, so the
model trains (``launch/train.py``'s step, ``models/model.py``'s
``forward``) and serves nothing."""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="hubert-xlarge",
    family="encoder",
    n_layers=48,
    d_model=1280,
    n_heads=16,
    n_kv_heads=16,
    d_ff=5120,
    vocab=504,
    causal=False,
    mlp_type="gelu",
    norm_type="layer",
    use_bias=True,
    frontend_dim=1280,
)

SMOKE = CONFIG.replace(
    n_layers=2, d_model=64, n_heads=4, n_kv_heads=4, head_dim=16,
    d_ff=128, vocab=56, frontend_dim=64)
