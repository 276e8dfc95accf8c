"""Broadcast-compare set intersection (the ``broadcast`` strategy).

K1 of the port: ``intersect_counts_kernel`` launches the CUDA kernel of
``csrc/intersect.cu`` that replaces the TPU kernel ``_intersect_kernel`` /
``intersect_counts_pallas`` of ``repro/kernels/intersect/intersect.py``:
``broadcast_reg_kernel`` for W < 64 (every width the ``auto`` cost model
gives this strategy; rows held in registers by groups of lanes, 16-byte
loads where W % 4 == 0 and both arrays are 16-byte aligned), and the slab
kernel ``broadcast_counts_kernel`` for wider rows, which only a forced
strategy sends. ``intersect_counts_broadcast`` is its plain torch version:
the same O(W²) compare, in row chunks that bound the (rows, W, W) compare
tensor.

The function reads no order: each row's count of all equal (u[j], v[k])
pairs, for any rows, unsorted and with duplicates counted pair by pair,
as the TPU kernel computes it.
"""

from __future__ import annotations

import torch

from repro_torch.kernels.intersect import _launch

__all__ = ["intersect_counts_broadcast", "intersect_counts_kernel"]

# compare elements materialized per chunk of the plain version
_CHUNK_ELEMS = 1 << 24


def intersect_counts_broadcast(u_lists: torch.Tensor,
                               v_lists: torch.Tensor) -> torch.Tensor:
    """Plain torch broadcast compare: (E,) int32 count of equal pairs per
    row of two (E, W) int32 arrays."""
    e, w = u_lists.shape
    out = torch.empty(e, dtype=torch.int32, device=u_lists.device)
    step = max(1, _CHUNK_ELEMS // max(w * w, 1))
    for s in range(0, e, step):
        uc, vc = u_lists[s:s + step], v_lists[s:s + step]
        out[s:s + step] = (uc[:, :, None] == vc[:, None, :]).sum(
            dim=(1, 2), dtype=torch.int32)
    return out


def intersect_counts_kernel(u_lists: torch.Tensor,
                            v_lists: torch.Tensor) -> torch.Tensor:
    """Per-row count of equal pairs: K1 on a CUDA tensor, the plain version
    on a CPU tensor.

    Args:
      u_lists, v_lists: (E, W) int32, contiguous; any E and W, and any
        rows: unsorted, with duplicates (each equal pair counts once).
        The engine's disjoint padding sentinels never match.

    Returns:
      (E,) int32 counts.

    Raises:
      ValueError: bad inputs (see ``_launch.check_lists``) or a device that
        is neither CPU nor CUDA.
      RuntimeError: the kernel did not build or launch.
    """
    _launch.check_lists(u_lists, v_lists)
    if u_lists.device.type == "cpu":
        return intersect_counts_broadcast(u_lists, v_lists)
    return _launch.launch_counts("broadcast", u_lists, v_lists)
