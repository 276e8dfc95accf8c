"""Fused masked block-SpGEMM for the matrix lane: dispatch, kernel, plain
versions."""

from repro_torch.kernels.masked_spgemm.masked_spgemm import (
    LAUNCHES,
    masked_spgemm_chunked,
    masked_spgemm_kernel,
    reset_launch_counts,
)
from repro_torch.kernels.masked_spgemm.ops import BACKENDS, masked_spgemm_counts
from repro_torch.kernels.masked_spgemm.ref import masked_spgemm_ref

__all__ = [
    "BACKENDS",
    "LAUNCHES",
    "masked_spgemm_chunked",
    "masked_spgemm_counts",
    "masked_spgemm_kernel",
    "masked_spgemm_ref",
    "reset_launch_counts",
]
