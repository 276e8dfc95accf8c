"""Reference implementations for batched sorted-neighbour-list intersection.

``intersect_counts_ref`` is the semantic oracle (``backend="ref"``): the
O(E·W²) broadcast compare, strategy-independent. Every strategy must agree
with it exactly on in-range ids.

``intersect_counts_probe_ref`` is a numpy cross-check for the probe paths
(per-row ``np.searchsorted``), sharing no code with them. The bitmap
reference lives in bitmap.py beside its masking contract.
"""

from __future__ import annotations

import numpy as np
import torch

__all__ = ["intersect_counts_probe_ref", "intersect_counts_ref"]


def intersect_counts_ref(u_lists: torch.Tensor, v_lists: torch.Tensor) -> torch.Tensor:
    """O(W²) broadcast-compare oracle: (E,) int32 count of equal pairs
    ``u[e, i] == v[e, j]`` (the intersection size when rows are strictly
    increasing apart from disjoint padding sentinels)."""
    eq = u_lists[:, :, None] == v_lists[:, None, :]
    return eq.sum(dim=(1, 2), dtype=torch.int32)


def intersect_counts_probe_ref(u_lists, v_lists) -> np.ndarray:
    """Numpy per-row binary-search reference for the probe paths.

    Returns:
      (E,) int32 numpy array — count of u elements found in the v row.
    """
    u = np.asarray(u_lists)
    v = np.asarray(v_lists)
    out = np.zeros(u.shape[0], dtype=np.int32)
    for e in range(u.shape[0]):
        pos = np.clip(np.searchsorted(v[e], u[e]), 0, v.shape[1] - 1)
        out[e] = int((v[e][pos] == u[e]).sum())
    return out
