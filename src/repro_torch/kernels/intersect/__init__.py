"""Batched sorted-list set intersection: dispatch, kernels, plain versions."""

from repro_torch.kernels.intersect._launch import LAUNCHES, reset_launch_counts
from repro_torch.kernels.intersect.bitmap import (
    BITMAP_MAX_BITS,
    intersect_counts_bitmap,
    intersect_counts_bitmap_kernel,
    intersect_counts_bitmap_ref,
    intersect_matches_bitmap,
)
from repro_torch.kernels.intersect.intersect import (
    intersect_counts_broadcast,
    intersect_counts_kernel,
)
from repro_torch.kernels.intersect.ops import (
    STRATEGIES,
    available_strategies,
    choose_mask_strategy,
    choose_strategy,
    intersect_counts,
    intersect_counts_csr,
    intersect_matches,
    intersect_matches_both,
    packed_bits,
    resolve_mask_strategy,
    resolve_strategy,
)
from repro_torch.kernels.intersect.probe import (
    intersect_counts_probe,
    intersect_counts_probe_csr,
    intersect_counts_probe_csr_kernel,
    intersect_counts_probe_kernel,
    probe_csr_rows,
)
from repro_torch.kernels.intersect.ref import (
    intersect_counts_probe_ref,
    intersect_counts_ref,
)

__all__ = [
    "BITMAP_MAX_BITS",
    "LAUNCHES",
    "STRATEGIES",
    "available_strategies",
    "choose_mask_strategy",
    "choose_strategy",
    "intersect_counts",
    "intersect_counts_bitmap",
    "intersect_counts_bitmap_kernel",
    "intersect_counts_bitmap_ref",
    "intersect_counts_broadcast",
    "intersect_counts_csr",
    "intersect_counts_kernel",
    "intersect_counts_probe",
    "intersect_counts_probe_csr",
    "intersect_counts_probe_csr_kernel",
    "intersect_counts_probe_kernel",
    "intersect_counts_probe_ref",
    "intersect_counts_ref",
    "intersect_matches",
    "intersect_matches_bitmap",
    "intersect_matches_both",
    "packed_bits",
    "probe_csr_rows",
    "reset_launch_counts",
    "resolve_mask_strategy",
    "resolve_strategy",
]
