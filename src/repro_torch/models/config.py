"""Model configuration shared by every architecture family (a copy of
``repro.models.config``, which the port does not import).

One dataclass covers the 10 assigned architectures; family-specific knobs are
optional fields. Exact values live in ``repro_torch/configs/<id>.py``; smoke tests
use ``reduced()`` scaled-down clones of the same family.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

__all__ = ["ModelConfig"]


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str  # dense | moe | ssm | hybrid | encdec | vlm
    num_layers: int
    d_model: int
    num_heads: int
    kv_heads: int
    d_ff: int
    vocab: int
    head_dim: Optional[int] = None  # default d_model // num_heads

    # dense-transformer options
    qkv_bias: bool = False  # qwen1.5
    logit_softcap: Optional[float] = None  # gemma2 (50.0 attn, 30.0 final)
    final_softcap: Optional[float] = None
    sliding_window: Optional[int] = None  # local-attention window
    local_global_pattern: bool = False  # gemma2: alternate local/global layers
    tie_embeddings: bool = True
    post_norms: bool = False  # gemma2 sandwich norms
    scale_embedding: bool = False  # gemma: embed × sqrt(d_model)
    residual_scale: float = 1.0  # minicpm depth-scaled residuals
    rope_theta: float = 10_000.0
    norm_eps: float = 1e-6
    act: str = "silu"  # silu | gelu

    # MoE
    num_experts: int = 0
    top_k: int = 0
    moe_capacity_factor: float = 1.25
    dense_residual: bool = False  # arctic: dense FFN in parallel with MoE
    dense_residual_ff: int = 0

    # SSM (mamba2 SSD)
    ssm_state: int = 0
    ssm_heads: int = 0
    ssm_head_dim: int = 0
    ssm_chunk: int = 256
    conv_width: int = 4
    expand: int = 2

    # hybrid (recurrentgemma): layer pattern unit, e.g. ("rec","rec","attn")
    block_pattern: Tuple[str, ...] = ()
    lru_width: Optional[int] = None

    # encoder-decoder (whisper)
    encoder_layers: int = 0
    encoder_seq: int = 1500  # 30 s of audio at 50 Hz after conv stub

    # VLM (paligemma)
    vision_tokens: int = 0  # prefix length of stub patch embeddings
    vision_dim: int = 0  # SigLIP output dim fed through projector stub

    # serving: KV cache dtype ("bfloat16" | "int8" — int8 stores a per
    # (layer, batch, pos, head) bf16 scale; ~2x cache HBM reduction)
    kv_cache_dtype: str = "bfloat16"

    # vocab padding: embedding rows padded so the vocab dim shards evenly;
    # padded logits are masked to -inf before loss/softmax (MaxText-style)
    pad_vocab_multiple: int = 256

    # training-time policy knobs (overridable per run)
    remat: bool = True
    scan_layers: bool = True
    fsdp: bool = False  # shard params and optimizer state over data (ZeRO-3-ish)
    adam_dtype: str = "bfloat16"  # moment dtype; "float32" for small models
    grad_accum_dtype: str = "float32"  # bf16 halves the per-microbatch FSDP
    # gradient all-reduce + accumulator HBM (arctic: 3.0 TB/chip/step -> 1.5)
    microbatches: int = 1

    def __post_init__(self):
        if self.head_dim is None:
            object.__setattr__(self, "head_dim", self.d_model // self.num_heads)

    @property
    def padded_vocab(self) -> int:
        m = max(self.pad_vocab_multiple, 1)
        return ((self.vocab + m - 1) // m) * m

    @property
    def is_attention_free(self) -> bool:
        return self.family == "ssm"

    @property
    def supports_long_context(self) -> bool:
        """True if serving 500k context is sub-quadratic (SSM / hybrid with
        local-window attention only)."""
        return self.family in ("ssm", "hybrid")

    def replace(self, **kw) -> "ModelConfig":
        return dataclasses.replace(self, **kw)

    # ---- parameter counting (for roofline MODEL_FLOPS = 6·N·D) ----

    def param_count(self) -> int:
        """Total parameter count (embedding included once when tied)."""
        d, ff, L = self.d_model, self.d_ff, self.num_layers
        hd = self.head_dim
        emb = self.vocab * d if self.tie_embeddings else 2 * self.vocab * d
        per_layer = 0
        if self.family == "ssm":
            d_in = self.expand * d
            per_layer = (
                d * (2 * d_in + 2 * self.ssm_state + self.ssm_heads)  # in_proj
                + self.conv_width * (d_in + 2 * self.ssm_state)
                + self.ssm_heads  # A_log
                + self.ssm_heads  # D
                + d_in * d  # out_proj
                + 2 * d  # norms
            )
            return emb + L * per_layer + d
        attn = d * (self.num_heads * hd) + 2 * d * (self.kv_heads * hd) + (
            self.num_heads * hd
        ) * d
        if self.family == "moe":
            ffp = self.num_experts * 3 * d * ff
            if self.dense_residual:
                ffp += 3 * d * self.dense_residual_ff
            ffp += d * self.num_experts  # router
        else:
            nm = 3 if self.act == "silu" else 2
            ffp = nm * d * ff
        per_layer = attn + ffp + 2 * d
        total = emb + L * per_layer + d
        if self.family == "hybrid":
            # recurrent blocks replace attention with RG-LRU temporal mix
            pat = self.block_pattern or ("rec", "rec", "attn")
            frac_rec = pat.count("rec") / len(pat)
            w = self.lru_width or d
            rec = 2 * d * w + 2 * w * self.conv_width + 4 * w + w * d
            total += int(L * frac_rec * (rec - attn))
        if self.family == "encdec":
            enc_layer = attn + 2 * d * ff + 2 * d
            total += self.encoder_layers * enc_layer + L * attn  # + cross-attn
        return int(total)

    def active_param_count(self) -> int:
        """Activated parameters per token (MoE: top_k experts only)."""
        if self.family != "moe":
            return self.param_count()
        d, ff, L = self.d_model, self.d_ff, self.num_layers
        hd = self.head_dim
        emb = self.vocab * d
        attn = d * (self.num_heads * hd) + 2 * d * (self.kv_heads * hd) + (
            self.num_heads * hd
        ) * d
        ffp = self.top_k * 3 * d * ff + d * self.num_experts
        if self.dense_residual:
            ffp += 3 * d * self.dense_residual_ff
        return int(emb + L * (attn + ffp + 2 * d) + d)
