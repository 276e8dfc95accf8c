"""TRUST-style per-vertex hash-table probe for the hash lane: table build,
dispatch, kernel (K5) and plain versions."""

from repro_torch.kernels.hash_tc.build import build_hash_table, hash_table_depth
from repro_torch.kernels.hash_tc.ops import (
    BACKENDS,
    hash_num_buckets,
    hash_probe_counts,
)
from repro_torch.kernels.hash_tc.probe import (
    LAUNCHES,
    check_probe_inputs,
    hash_probe_counts_chunked,
    hash_probe_kernel,
    reset_launch_counts,
)
from repro_torch.kernels.hash_tc.ref import hash_probe_counts_ref

__all__ = [
    "BACKENDS",
    "LAUNCHES",
    "build_hash_table",
    "check_probe_inputs",
    "hash_num_buckets",
    "hash_probe_counts",
    "hash_probe_counts_chunked",
    "hash_probe_counts_ref",
    "hash_probe_kernel",
    "hash_table_depth",
    "reset_launch_counts",
]
