"""whisper-medium [audio/encdec] — 24+24 layers, conv frontend stubbed to
precomputed frame embeddings (B, 1500, d) [arXiv:2212.04356]."""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="whisper-medium", family="encdec",
    num_layers=24, d_model=1024, num_heads=16, kv_heads=16,
    d_ff=4096, vocab=51_865, act="gelu",
    encoder_layers=24, encoder_seq=1500,
    microbatches=4,
)

REDUCED = CONFIG.replace(
    name="whisper-medium-reduced", num_layers=3, d_model=64, num_heads=4,
    kv_heads=4, d_ff=128, vocab=256, encoder_layers=2, encoder_seq=16,
    microbatches=1,
)
