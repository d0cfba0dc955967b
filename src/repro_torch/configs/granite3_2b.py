"""Granite-3.0-2B [hf:ibm-granite/granite-3.0-2b-base]: dense GQA."""
from ..models.config import ModelConfig

CONFIG = ModelConfig(
    name="granite-3-2b", family="dense", n_layers=40, d_model=2048,
    n_heads=32, n_kv_heads=8, head_dim=64, d_ff=8192, vocab=49155, vocab_pad=13,
    activation="swiglu")

SMOKE = CONFIG.with_(vocab_pad=0, n_layers=2, d_model=64, n_heads=4, n_kv_heads=2,
                     head_dim=16, d_ff=128, vocab=251, remat=False)
