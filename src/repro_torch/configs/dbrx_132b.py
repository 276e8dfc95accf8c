"""dbrx-132b [moe] — 16 experts top-4 fine-grained [hf:databricks/dbrx-base]."""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="dbrx-132b", family="moe",
    num_layers=40, d_model=6144, num_heads=48, kv_heads=8,
    d_ff=10752, vocab=100_352,
    num_experts=16, top_k=4, moe_capacity_factor=1.25,
    fsdp=True, microbatches=8, grad_accum_dtype="bfloat16",
)

REDUCED = CONFIG.replace(
    name="dbrx-132b-reduced", num_layers=2, d_model=64, num_heads=4,
    kv_heads=2, d_ff=96, vocab=256, num_experts=4, top_k=2, fsdp=False,
    microbatches=1,
)
