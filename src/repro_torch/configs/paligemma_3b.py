"""paligemma-3b [vlm] — SigLIP patch embeddings (stub) prefixed to a
gemma-style decoder, prefix-bidirectional masking, MQA kv=1
[arXiv:2407.07726]."""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="paligemma-3b", family="vlm",
    num_layers=18, d_model=2048, num_heads=8, kv_heads=1, head_dim=256,
    d_ff=16384, vocab=257_216, scale_embedding=True,
    vision_tokens=256, vision_dim=1152,
    microbatches=8,
)

REDUCED = CONFIG.replace(
    name="paligemma-3b-reduced", num_layers=3, d_model=64, num_heads=4,
    kv_heads=1, head_dim=16, d_ff=128, vocab=256, vision_tokens=8,
    vision_dim=24, microbatches=1,
)
