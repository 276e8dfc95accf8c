"""qwen1.5-32b [dense] — QKV bias, 64L wide [hf:Qwen/Qwen1.5-*]."""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="qwen1.5-32b", family="dense",
    num_layers=64, d_model=5120, num_heads=40, kv_heads=40,
    d_ff=27392, vocab=152_064, qkv_bias=True, rope_theta=1_000_000.0,
    fsdp=True, microbatches=8, grad_accum_dtype="bfloat16",
    kv_cache_dtype="int8",
)

REDUCED = CONFIG.replace(
    name="qwen1.5-32b-reduced", num_layers=4, d_model=64, num_heads=4,
    kv_heads=4, d_ff=192, vocab=256, fsdp=False, microbatches=1,
)
