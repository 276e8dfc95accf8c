"""mamba2-780m [ssm] — SSD, attention-free, d_state=128 [arXiv:2405.21060]."""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="mamba2-780m", family="ssm",
    num_layers=48, d_model=1536, num_heads=1, kv_heads=1, d_ff=0,
    vocab=50_280, ssm_state=128, ssm_heads=48, ssm_head_dim=64,
    ssm_chunk=256, expand=2, conv_width=4,
    microbatches=4,
)

REDUCED = CONFIG.replace(
    name="mamba2-780m-reduced", num_layers=4, d_model=64, ssm_state=16,
    ssm_heads=4, ssm_head_dim=32, ssm_chunk=16, vocab=256, microbatches=1,
)
