"""Flash attention: dispatch, the forward kernel (K6), its autograd
``FlashAttention`` and the plain versions."""

from repro_torch.kernels.flash_attention.flash_attention import (
    FlashAttention,
    FlashPlan,
    HEAD_DIMS,
    LAUNCHES,
    WGMMA_PLANS,
    check_flash_inputs,
    flash_attention_kernel,
    flash_plan,
    reset_launch_counts,
)
from repro_torch.kernels.flash_attention.ops import BACKENDS, flash_attention
from repro_torch.kernels.flash_attention.ref import (
    ROW_RMS_BOUND,
    flash_attention_ref,
    flash_row_rms,
    flash_within_tolerance,
)

__all__ = [
    "BACKENDS",
    "FlashAttention",
    "FlashPlan",
    "HEAD_DIMS",
    "LAUNCHES",
    "ROW_RMS_BOUND",
    "WGMMA_PLANS",
    "check_flash_inputs",
    "flash_attention",
    "flash_attention_kernel",
    "flash_attention_ref",
    "flash_plan",
    "flash_row_rms",
    "flash_within_tolerance",
    "reset_launch_counts",
]
