"""Llama-4 Maverick 400B-A17B [hf:meta-llama]: interleaved MoE, 128e
top-1 + shared expert, early fusion (text backbone here; the vision
frontend is stubbed per the assignment)."""
from ..models.config import ModelConfig

CONFIG = ModelConfig(
    fsdp=True,  # params exceed per-chip HBM at TP=16: ZeRO-3 shard
    name="llama4-maverick-400b-a17b", family="moe", n_layers=48,
    d_model=5120, n_heads=40, n_kv_heads=8, head_dim=128, d_ff=8192,
    vocab=202048, activation="swiglu", n_experts=128, top_k=1,
    moe_layer_period=2, shared_expert=True)

SMOKE = CONFIG.with_(n_layers=2, d_model=64, n_heads=4, n_kv_heads=2,
                     head_dim=16, d_ff=128, vocab=256, n_experts=4,
                     top_k=1, moe_layer_period=2, remat=False)
