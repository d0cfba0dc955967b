"""Zamba2-2.7B [arXiv:2411.15242; hf]: Mamba-2 backbone + shared attn."""
from ..models.config import ModelConfig

CONFIG = ModelConfig(
    name="zamba2-2.7b", family="hybrid", n_layers=54, d_model=2560,
    vocab=32000, ssm_state=64, ssm_heads=80, ssm_head_dim=64,
    ssm_conv=4, ssm_expand=2,
    n_heads=32, n_kv_heads=32, head_dim=80, d_ff=10240,
    activation="gelu", shared_attn_every=6)

SMOKE = CONFIG.with_(n_layers=4, d_model=64, vocab=256, ssm_state=16,
                     ssm_heads=4, ssm_head_dim=32, n_heads=4,
                     n_kv_heads=4, head_dim=16, d_ff=128,
                     shared_attn_every=2, remat=False)
