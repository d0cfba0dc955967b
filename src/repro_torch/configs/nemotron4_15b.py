"""Nemotron-4-15B [arXiv:2402.16819]: dense GQA, squared-ReLU FFN."""
from ..models.config import ModelConfig

CONFIG = ModelConfig(
    name="nemotron-4-15b", family="dense", n_layers=32, d_model=6144,
    n_heads=48, n_kv_heads=8, head_dim=128, d_ff=24576, vocab=256000,
    activation="squared_relu")

SMOKE = CONFIG.with_(n_layers=2, d_model=64, n_heads=4, n_kv_heads=2,
                     head_dim=16, d_ff=128, vocab=256, remat=False)
