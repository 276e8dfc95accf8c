"""arctic-480b [moe] — 128 experts top-2 PLUS parallel dense residual FFN
(dense-MoE hybrid) [hf:Snowflake/snowflake-arctic-base]."""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="arctic-480b", family="moe",
    num_layers=35, d_model=7168, num_heads=56, kv_heads=8,
    d_ff=4864, vocab=32_000,
    num_experts=128, top_k=2, moe_capacity_factor=1.25,
    dense_residual=True, dense_residual_ff=4864,
    fsdp=True, microbatches=4, grad_accum_dtype="bfloat16",
)

REDUCED = CONFIG.replace(
    name="arctic-480b-reduced", num_layers=2, d_model=64, num_heads=4,
    kv_heads=2, d_ff=96, vocab=256, num_experts=4, top_k=2,
    dense_residual_ff=96, fsdp=False, microbatches=1,
)
