"""Fused masked block-SpGEMM for the matrix lane: dispatch, kernel, plain
versions."""

from repro_torch.kernels.masked_spgemm.masked_spgemm import (
    LAUNCHES,
    WGMMA_BLOCKS,
    launch_order,
    masked_spgemm_chunked,
    masked_spgemm_gathered,
    masked_spgemm_gathered_chunked,
    masked_spgemm_kernel,
    reset_launch_counts,
)
from repro_torch.kernels.masked_spgemm.ops import (
    BACKENDS,
    masked_spgemm_counts,
    masked_spgemm_gathered_counts,
)
from repro_torch.kernels.masked_spgemm.ref import masked_spgemm_ref

__all__ = [
    "BACKENDS",
    "LAUNCHES",
    "WGMMA_BLOCKS",
    "launch_order",
    "masked_spgemm_chunked",
    "masked_spgemm_counts",
    "masked_spgemm_gathered",
    "masked_spgemm_gathered_chunked",
    "masked_spgemm_gathered_counts",
    "masked_spgemm_kernel",
    "masked_spgemm_ref",
    "reset_launch_counts",
]
