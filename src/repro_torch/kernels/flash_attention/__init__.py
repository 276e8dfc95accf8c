"""Forward flash attention for the dense serving path: dispatch, kernel
(K6) and plain versions."""

from repro_torch.kernels.flash_attention.flash_attention import (
    HEAD_DIMS,
    LAUNCHES,
    check_flash_inputs,
    flash_attention_kernel,
    reset_launch_counts,
)
from repro_torch.kernels.flash_attention.ops import BACKENDS, flash_attention
from repro_torch.kernels.flash_attention.ref import flash_attention_ref

__all__ = [
    "BACKENDS",
    "HEAD_DIMS",
    "LAUNCHES",
    "check_flash_inputs",
    "flash_attention",
    "flash_attention_kernel",
    "flash_attention_ref",
    "reset_launch_counts",
]
