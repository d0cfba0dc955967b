"""Qwen2-72B [arXiv:2407.10671; hf]: dense GQA with QKV bias."""
from ..models.config import ModelConfig

CONFIG = ModelConfig(
    fsdp=True,  # params exceed per-chip HBM at TP=16: ZeRO-3 shard
    name="qwen2-72b", family="dense", n_layers=80, d_model=8192,
    n_heads=64, n_kv_heads=8, head_dim=128, d_ff=29568, vocab=152064,
    activation="swiglu", qkv_bias=True, rope_theta=1e6)

SMOKE = CONFIG.with_(n_layers=2, d_model=64, n_heads=4, n_kv_heads=2,
                     head_dim=16, d_ff=128, vocab=256, remat=False)
