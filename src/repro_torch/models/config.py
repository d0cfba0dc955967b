"""Unified model configuration covering all assigned architecture
families (dense / ssm / hybrid / moe / audio / vlm backbones)."""
from __future__ import annotations

import dataclasses
from typing import Optional


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str                   # dense | ssm | hybrid | moe | audio | vlm
    n_layers: int
    d_model: int
    vocab: int
    # pad embedding/lm_head rows so the vocab shards over the model axis
    # (Megatron-style); logits for pad columns are masked in the loss
    vocab_pad: int = 0
    # attention (unused for pure ssm)
    n_heads: int = 0
    n_kv_heads: int = 0
    head_dim: int = 0
    qkv_bias: bool = False
    rope_theta: float = 1e4
    sliding_window: Optional[int] = None   # SWA (Mixtral)
    # ffn
    d_ff: int = 0
    activation: str = "swiglu"    # swiglu | squared_relu | gelu
    # moe
    n_experts: int = 0
    top_k: int = 0
    capacity_factor: float = 1.25
    moe_layer_period: int = 1     # every k-th layer is MoE (Llama-4: 2)
    shared_expert: bool = False   # Llama-4 shared expert
    # ssm (mamba-2)
    ssm_state: int = 0
    ssm_heads: int = 0
    ssm_head_dim: int = 0
    ssm_conv: int = 4
    ssm_expand: int = 2
    # hybrid (zamba-2): one shared attention block every k ssm blocks
    shared_attn_every: int = 0
    # modality frontend stub (audio/vlm): prefix embeddings length
    n_codebooks: int = 0          # musicgen: embeddings summed, heads split
    frontend_tokens: int = 0      # internvl: number of patch embeddings
    # numerics / compile
    dtype: str = "bfloat16"
    remat: bool = True
    unroll: bool = False  # unroll layer scan (dry-run cost extrapolation)
    fsdp: bool = False    # additionally shard params over data axes (ZeRO-3)
    # which attention positions shard over "model": set by mesh rules
    tie_embeddings: bool = False

    @property
    def padded_vocab(self) -> int:
        return self.vocab + self.vocab_pad

    @property
    def qk_dim(self) -> int:
        return self.n_heads * self.head_dim

    @property
    def kv_dim(self) -> int:
        return self.n_kv_heads * self.head_dim

    @property
    def d_inner(self) -> int:
        return self.ssm_expand * self.d_model

    def with_(self, **kw) -> "ModelConfig":
        return dataclasses.replace(self, **kw)

    # ------------------------------------------------------------------
    # analytic parameter / FLOP counts (roofline §MODEL_FLOPS)
    # ------------------------------------------------------------------
    def param_count(self) -> int:
        d, f, v, L = self.d_model, self.d_ff, self.vocab, self.n_layers
        n = 0
        n += v * d                          # embed
        if not self.tie_embeddings:
            n += d * v                      # lm_head
        if self.n_codebooks:
            n += (self.n_codebooks - 1) * v * d  # extra codebook embeds
            n += (self.n_codebooks - 1) * d * v  # extra heads
        per_attn = d * self.qk_dim + 2 * d * self.kv_dim + self.qk_dim * d
        if self.qkv_bias:
            per_attn += self.qk_dim + 2 * self.kv_dim
        ffn_mults = 3 if self.activation == "swiglu" else 2
        per_ffn = ffn_mults * d * f
        per_norms = 2 * d
        if self.family in ("dense", "audio", "vlm"):
            n += L * (per_attn + per_ffn + per_norms)
        elif self.family == "moe":
            n_moe = L // self.moe_layer_period
            n_dense = L - n_moe
            n += L * (per_attn + per_norms)
            n += n_dense * per_ffn
            n += n_moe * (self.n_experts * per_ffn
                          + (per_ffn if self.shared_expert else 0)
                          + d * self.n_experts)   # router
        elif self.family == "ssm":
            n += L * (self._ssm_block_params() + d)
        elif self.family == "hybrid":
            n += L * (self._ssm_block_params() + d)
            n += per_attn + per_ffn + per_norms  # one shared block
        n += d                               # final norm
        return n

    def _ssm_block_params(self) -> int:
        d, di, ns, h = (self.d_model, self.d_inner, self.ssm_state,
                        self.ssm_heads)
        in_proj = d * (2 * di + 2 * ns + h)   # x, z, B, C, dt
        conv = self.ssm_conv * (di + 2 * ns)
        out_proj = di * d
        extra = h + h + di                    # A, D, dt_bias/gate-norm
        return in_proj + conv + out_proj + extra

    def active_param_count(self) -> int:
        """Per-token active parameters (MoE: top_k + shared expert)."""
        if self.family != "moe":
            return self.param_count()
        d, f, L = self.d_model, self.d_ff, self.n_layers
        ffn_mults = 3 if self.activation == "swiglu" else 2
        per_ffn = ffn_mults * d * f
        n_moe = L // self.moe_layer_period
        dense_total = self.param_count() - n_moe * (
            self.n_experts * per_ffn
            + (per_ffn if self.shared_expert else 0))
        return dense_total + n_moe * per_ffn * (
            self.top_k + (1 if self.shared_expert else 0))

    def model_flops(self, tokens: int, training: bool = True) -> float:
        """6·N·D (training) or 2·N·D (inference forward)."""
        mult = 6 if training else 2
        return mult * self.active_param_count() * tokens
