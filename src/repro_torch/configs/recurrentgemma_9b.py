"""recurrentgemma-9b [hybrid] — RG-LRU + local attention, (rec,rec,attn)
pattern, MQA kv=1, window 2048 [arXiv:2402.19427]."""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="recurrentgemma-9b", family="hybrid",
    num_layers=38, d_model=4096, num_heads=16, kv_heads=1, head_dim=256,
    d_ff=12288, vocab=256_000,
    block_pattern=("rec", "rec", "attn"), lru_width=4096,
    sliding_window=2048, conv_width=4, scale_embedding=True,
    microbatches=8,
)

REDUCED = CONFIG.replace(
    name="recurrentgemma-9b-reduced", num_layers=6, d_model=64, num_heads=4,
    kv_heads=1, head_dim=16, d_ff=128, vocab=256, lru_width=64,
    sliding_window=16, microbatches=1,
)
