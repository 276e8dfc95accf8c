"""Dispatch for the TRUST-style per-vertex hash-table counting core.

The port of ``repro.kernels.hash_tc.ops``. The hash lane's count stage is a
membership problem: for forward edge (u, v), how many of v's oriented
neighbours appear in u's oriented neighbour list? The intersect package
answers it by merging two sorted arrays; this package probes a per-vertex
hash table, comparing each probe with its chain:

    backend    core                                   notes
    --------   ------------------------------------   ------------------------
    "kernel"   ``hash_probe_compact_kernel``          K5 on CUDA tensors; the
                                                      plain torch version
                                                      (``hash_probe_compact_
                                                      chunked``) on CPU ones
    "ref"      ``hash_probe_compact_ref``             chain-blind oracle

``hash_probe_compact_counts`` takes the lane's form: the compact table
(``CompactHashTable``, each chain at its real length) and each row's end
(``probe_row_ends``). ``hash_probe_counts`` keeps the reference's dense
(n, B, D) form with the same backends (``hash_probe_kernel`` compacts the
table on the card; ``hash_probe_counts_ref`` is its oracle).

A CUDA tensor never falls back: a failed build or launch raises. The
reference's padding of E to the Pallas tile height is not needed: the
kernel takes any E.

Sentinel rules (shared with the rest of the port): candidate rows are the
bucket machinery's ``v_lists`` — in-row padding n + 1, whole padding rows
-2, with ``src`` carrying 0 on padding rows; dense table padding is -1.
Only values in [0, n) probe, so no sentinel combination can match.

Table sizing: ``hash_num_buckets`` picks B = next-pow2(width) (≥ 8), a
load factor ≤ 1 for a full row; the planner reads the longest chain from
the compact build and rounds it to a power of two (the reference's D).
"""

from __future__ import annotations

import torch

from repro_torch.kernels.hash_tc.build import (
    CompactHashTable,
    build_compact_hash_table,
    build_hash_table,
    hash_table_depth,
)
from repro_torch.kernels.hash_tc.probe import (
    hash_probe_compact_kernel,
    hash_probe_kernel,
    probe_row_ends,
)
from repro_torch.kernels.hash_tc.ref import (
    hash_probe_compact_ref,
    hash_probe_counts_ref,
)

__all__ = [
    "BACKENDS",
    "build_compact_hash_table",
    "build_hash_table",
    "hash_num_buckets",
    "hash_probe_compact_counts",
    "hash_probe_counts",
    "hash_table_depth",
    "probe_row_ends",
]

BACKENDS = ("kernel", "ref")


def hash_num_buckets(width: int) -> int:
    """Bucket count for a table serving rows of ``width``: next pow2, ≥ 8."""
    return max(8, 1 << max(0, int(width) - 1).bit_length())


def hash_probe_counts(w_lists: torch.Tensor, src: torch.Tensor,
                      table: torch.Tensor, *,
                      backend: str = "kernel") -> torch.Tensor:
    """Per-edge hash-probe counts. (E, W) probes × (n, B, D) → (E,).

    Args:
      w_lists: (E, W) int32 candidate rows (sorted N⁺(dst) lists; in-row
        sentinel n + 1, whole padding rows -2).
      src: (E,) int32 anchor vertex per row (padding rows carry 0).
      table: (n, B, D) int32 per-vertex hash table from
        ``build_hash_table``; B must be a power of two.
      backend: "kernel" | "ref" (see the module docstring).

    Returns:
      (E,) int32 — per-edge count of candidates present in ``table[src]``
      (= |N⁺(dst) ∩ N⁺(src)| when fed the planner's oriented rows).

    Raises:
      ValueError: unknown backend, or bad inputs (``"kernel"``).
      RuntimeError: the kernel did not build or launch.
    """
    if backend == "kernel":
        return hash_probe_kernel(w_lists, src, table)
    if backend == "ref":
        return hash_probe_counts_ref(w_lists, src, table)
    raise ValueError(f"unknown backend {backend!r}; expected one of {BACKENDS}")


def hash_probe_compact_counts(w_lists: torch.Tensor, src: torch.Tensor,
                              row_end: torch.Tensor,
                              compact: CompactHashTable, *,
                              backend: str = "kernel") -> torch.Tensor:
    """Per-edge hash-probe counts against the compact table. (E, W) probes
    up to their row ends × the anchors' chains → (E,).

    Args:
      w_lists: (E, W) int32 candidate rows (in-row sentinel n + 1, whole
        padding rows -2).
      src: (E,) int32 anchor vertex per row (padding rows carry 0).
      row_end: (E,) int32 row ends from ``probe_row_ends``.
      compact: ``CompactHashTable`` from ``build_compact_hash_table``.
      backend: "kernel" | "ref" (see the module docstring).

    Returns:
      (E,) int32 — per-edge count of candidates present in the anchor's
      chains (= |N⁺(dst) ∩ N⁺(src)| when fed the planner's oriented rows).

    Raises:
      ValueError: unknown backend, or bad inputs (``"kernel"``).
      RuntimeError: the kernel did not build or launch.
    """
    if backend == "kernel":
        return hash_probe_compact_kernel(w_lists, src, row_end, compact)
    if backend == "ref":
        return hash_probe_compact_ref(w_lists, src, row_end, compact)
    raise ValueError(f"unknown backend {backend!r}; expected one of {BACKENDS}")
