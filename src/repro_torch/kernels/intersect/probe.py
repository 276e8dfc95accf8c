"""Binary-probe set intersection (the ``probe`` strategy).

Count the u elements whose lower bound in the sorted v row holds an equal
value (each duplicate in u counted). K2 of the port:
``intersect_counts_probe_kernel`` launches the CUDA kernel
``probe_merge_kernel`` (``csrc/intersect.cu``), which replaces the TPU
kernel ``_probe_kernel`` / ``intersect_counts_probe_pallas`` of
``repro/kernels/intersect/probe.py``. It computes the same function by a
merge-path walk of both rows (u wins ties, so the v cursor sits at each
taken u element's lower bound), skips rows whose id ranges cannot meet
without loading them, and pipelines the rest through shared memory; both
rows must be sorted ascending. ``intersect_counts_probe`` is its plain
torch version: ``torch.searchsorted`` plus a gather, in row chunks.
"""

from __future__ import annotations

import torch

from repro_torch.kernels.intersect import _launch

__all__ = ["intersect_counts_probe", "intersect_counts_probe_kernel",
           "probe_matches"]

# elements of u searched per chunk of the plain version
_CHUNK_ELEMS = 1 << 24


def probe_matches(u_lists: torch.Tensor, v_lists: torch.Tensor) -> torch.Tensor:
    """(E, W) bool: which u elements occur in their sorted v row (lower
    bound in v, then an equality test). One chunk's worth: callers bound E."""
    w = u_lists.shape[1]
    pos = torch.searchsorted(v_lists, u_lists, out_int32=True).clamp_(max=w - 1)
    return torch.gather(v_lists, 1, pos.long()) == u_lists


def intersect_counts_probe(u_lists: torch.Tensor,
                           v_lists: torch.Tensor) -> torch.Tensor:
    """Plain torch probe: (E,) int32 count of u elements found in the
    sorted v row, for two (E, W) int32 arrays."""
    e, w = u_lists.shape
    out = torch.zeros(e, dtype=torch.int32, device=u_lists.device)
    if w == 0:
        return out
    step = max(1, _CHUNK_ELEMS // w)
    for s in range(0, e, step):
        out[s:s + step] = probe_matches(u_lists[s:s + step],
                                        v_lists[s:s + step]).sum(
            dim=1, dtype=torch.int32)
    return out


def intersect_counts_probe_kernel(u_lists: torch.Tensor,
                                  v_lists: torch.Tensor) -> torch.Tensor:
    """Per-row probe counts: K2 on a CUDA tensor, the plain version on a
    CPU tensor.

    Args:
      u_lists, v_lists: (E, W) int32, contiguous, rows sorted ascending
        (u as well as v: the kernel merges, and an unsorted u row gets a
        wrong count) with disjoint padding sentinels; any E and W, any
        4-byte-aligned start (16-byte-aligned rows take 16-byte copies).

    Returns:
      (E,) int32 counts.

    Raises:
      ValueError: bad inputs or an unsupported device.
      RuntimeError: the kernel did not build or launch.
    """
    _launch.check_lists(u_lists, v_lists)
    if u_lists.device.type == "cpu":
        return intersect_counts_probe(u_lists, v_lists)
    return _launch.launch_counts("probe", u_lists, v_lists)
