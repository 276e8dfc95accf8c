"""gemma2-2b [dense] — local+global alternating attention, logit softcaps,
sandwich norms, GQA 8q/4kv, head_dim 256 [arXiv:2408.00118; hf]."""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="gemma2-2b", family="dense",
    num_layers=26, d_model=2304, num_heads=8, kv_heads=4, head_dim=256,
    d_ff=9216, vocab=256_000,
    sliding_window=4096, local_global_pattern=True,
    logit_softcap=50.0, final_softcap=30.0,
    post_norms=True, scale_embedding=True, tie_embeddings=True,
    microbatches=8,
)

REDUCED = CONFIG.replace(
    name="gemma2-2b-reduced", num_layers=4, d_model=64, num_heads=4,
    kv_heads=2, head_dim=16, d_ff=128, vocab=256, sliding_window=16,
    microbatches=1,
)
