"""TRUST-style per-vertex hash probe for the hash lane: dense and compact
table builds, dispatch, kernel (K5) and plain versions."""

from repro_torch.kernels.hash_tc.build import (
    CompactHashTable,
    build_compact_hash_table,
    build_hash_table,
    compact_hash_table,
    expand_hash_table,
    hash_table_depth,
)
from repro_torch.kernels.hash_tc.ops import (
    BACKENDS,
    hash_num_buckets,
    hash_probe_compact_counts,
    hash_probe_counts,
)
from repro_torch.kernels.hash_tc.probe import (
    LAUNCHES,
    check_compact_inputs,
    check_probe_inputs,
    hash_probe_compact_chunked,
    hash_probe_compact_kernel,
    hash_probe_counts_chunked,
    hash_probe_kernel,
    probe_row_ends,
    reset_launch_counts,
)
from repro_torch.kernels.hash_tc.ref import (
    hash_probe_compact_ref,
    hash_probe_counts_ref,
)

__all__ = [
    "BACKENDS",
    "CompactHashTable",
    "LAUNCHES",
    "build_compact_hash_table",
    "build_hash_table",
    "check_compact_inputs",
    "check_probe_inputs",
    "compact_hash_table",
    "expand_hash_table",
    "hash_num_buckets",
    "hash_probe_compact_chunked",
    "hash_probe_compact_counts",
    "hash_probe_compact_kernel",
    "hash_probe_compact_ref",
    "hash_probe_counts",
    "hash_probe_counts_chunked",
    "hash_probe_counts_ref",
    "hash_probe_kernel",
    "hash_table_depth",
    "probe_row_ends",
    "reset_launch_counts",
]
