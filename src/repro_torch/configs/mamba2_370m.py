"""Mamba2-370M [arXiv:2405.21060]: attention-free SSD."""
from ..models.config import ModelConfig

CONFIG = ModelConfig(
    name="mamba2-370m", family="ssm", n_layers=48, d_model=1024,
    vocab=50280, vocab_pad=152, ssm_state=128, ssm_heads=32, ssm_head_dim=64,
    ssm_conv=4, ssm_expand=2)

SMOKE = CONFIG.with_(vocab_pad=0, n_layers=2, d_model=64, vocab=256, ssm_state=16,
                     ssm_heads=4, ssm_head_dim=32, remat=False)
