"""qwen1.5-4b [dense] — QKV bias, MHA 20q/20kv [hf:Qwen/Qwen1.5-*]."""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="qwen1.5-4b", family="dense",
    num_layers=40, d_model=2560, num_heads=20, kv_heads=20,
    d_ff=6912, vocab=151_936, qkv_bias=True, rope_theta=1_000_000.0,
    microbatches=8,
)

REDUCED = CONFIG.replace(
    name="qwen1.5-4b-reduced", num_layers=4, d_model=64, num_heads=4,
    kv_heads=4, d_ff=128, vocab=256, microbatches=1,
)
