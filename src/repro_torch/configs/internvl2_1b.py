"""InternVL2-1B [arXiv:2404.16821; hf]: Qwen2-0.5B LM backbone; the
InternViT frontend is a STUB (input_specs() provides precomputed patch
embeddings prepended to the text sequence)."""
from ..models.config import ModelConfig

CONFIG = ModelConfig(
    name="internvl2-1b", family="vlm", n_layers=24, d_model=896,
    n_heads=14, n_kv_heads=2, head_dim=64, d_ff=4864, vocab=151655, vocab_pad=9,
    activation="swiglu", qkv_bias=True, rope_theta=1e6,
    frontend_tokens=256)

SMOKE = CONFIG.with_(vocab_pad=0, n_layers=2, d_model=64, n_heads=4, n_kv_heads=2,
                     head_dim=16, d_ff=128, vocab=256, frontend_tokens=8,
                     remat=False)
