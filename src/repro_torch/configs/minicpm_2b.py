"""minicpm-2b [dense] — llama-like, depth-scaled residuals (scale_depth=1.4),
WSD schedule (``repro.train.optimizer``) [arXiv:2404.06395]."""
import math
from repro_torch.models.config import ModelConfig

_L = 40

CONFIG = ModelConfig(
    name="minicpm-2b", family="dense",
    num_layers=_L, d_model=2304, num_heads=36, kv_heads=36,
    d_ff=5760, vocab=122_753,
    residual_scale=1.4 / math.sqrt(_L), scale_embedding=True,
    microbatches=8,
)

REDUCED = CONFIG.replace(
    name="minicpm-2b-reduced", num_layers=4, d_model=72, num_heads=4,
    kv_heads=4, d_ff=144, vocab=256,
    residual_scale=1.4 / math.sqrt(4), microbatches=1,
)
