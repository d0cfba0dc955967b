"""StarCoder2-15B [arXiv:2402.19173; hf]: dense GQA decoder."""
from ..models.config import ModelConfig

CONFIG = ModelConfig(
    name="starcoder2-15b", family="dense", n_layers=40, d_model=6144,
    n_heads=48, n_kv_heads=4, head_dim=128, d_ff=24576, vocab=49152,
    activation="gelu", rope_theta=1e5)

SMOKE = CONFIG.with_(n_layers=2, d_model=64, n_heads=4, n_kv_heads=2,
                     head_dim=16, d_ff=128, vocab=256, remat=False)
