"""MusicGen-medium [arXiv:2306.05284; hf]: decoder over EnCodec tokens.

The EnCodec frontend is a STUB: input_specs() provides precomputed
4-codebook token frames; the model sums per-codebook embeddings and
emits 4 per-codebook heads (delay-pattern handling lives in the data
pipeline, not the backbone)."""
from ..models.config import ModelConfig

CONFIG = ModelConfig(
    name="musicgen-medium", family="audio", n_layers=48, d_model=1536,
    n_heads=24, n_kv_heads=24, head_dim=64, d_ff=6144, vocab=2048,
    activation="gelu", n_codebooks=4)

SMOKE = CONFIG.with_(n_layers=2, d_model=64, n_heads=4, n_kv_heads=4,
                     head_dim=16, d_ff=128, vocab=64, n_codebooks=2,
                     remat=False)
