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

K2's second form reads each row pair straight from the forward-oriented
CSR at its real length: ``intersect_counts_probe_csr_kernel`` launches
``probe_csr_kernel`` on a bucket's endpoints (``src``, ``dst``) and the CSR
(``row_ptr``, ``col``); ``intersect_counts_probe_csr`` is its plain
version, which gathers the padded rows (``probe_csr_rows``) and probes
them as above.
"""

from __future__ import annotations

import torch

from repro_torch.kernels.intersect import _launch

__all__ = ["intersect_counts_probe", "intersect_counts_probe_csr",
           "intersect_counts_probe_csr_kernel", "intersect_counts_probe_kernel",
           "probe_csr_rows", "probe_matches"]

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


def probe_csr_rows(row_ptr: torch.Tensor, col: torch.Tensor,
                   src: torch.Tensor, dst: torch.Tensor, width: int):
    """The padded (E, width) int32 (u, v) rows of the edges (src, dst) of
    a forward CSR with ``n = len(row_ptr) - 1`` rows: u[e] is N⁺(src[e]),
    v[e] is N⁺(dst[e]), each its first ``width`` ids, padded with the
    in-row sentinels n (u) and n + 1 (v), the layout of a prepped bucket's
    real rows."""
    n = int(row_ptr.shape[0]) - 1
    lanes = torch.arange(width, device=row_ptr.device)

    def side(ends, fill):
        ends = ends.long()
        start = row_ptr[ends].long()
        length = row_ptr[ends + 1].long() - start
        keep = lanes < length[:, None]
        if col.numel() == 0:  # no row holds an id
            return torch.full(keep.shape, fill, dtype=torch.int32,
                              device=keep.device)
        idx = torch.where(keep, start[:, None] + lanes, 0)
        return torch.where(keep, col[idx], fill).to(torch.int32)

    return side(src, n), side(dst, n + 1)


def intersect_counts_probe_csr(row_ptr: torch.Tensor, col: torch.Tensor,
                               src: torch.Tensor, dst: torch.Tensor,
                               width: int) -> torch.Tensor:
    """Plain torch form of K2 on the forward CSR: (E,) int32 count of
    N⁺(src) ids found in N⁺(dst), each row cut to its first ``width`` ids;
    the padded rows (``probe_csr_rows``) probed in row chunks."""
    e = int(src.shape[0])
    out = torch.zeros(e, dtype=torch.int32, device=src.device)
    step = max(1, _CHUNK_ELEMS // max(int(width), 1))
    for s in range(0, e, step):
        u, v = probe_csr_rows(row_ptr, col, src[s:s + step], dst[s:s + step],
                              width)
        out[s:s + step] = intersect_counts_probe(u, v)
    return out


def intersect_counts_probe_csr_kernel(row_ptr: torch.Tensor,
                                      col: torch.Tensor, src: torch.Tensor,
                                      dst: torch.Tensor,
                                      width: int) -> torch.Tensor:
    """Per-edge probe counts read from the forward CSR: K2's CSR form on
    CUDA tensors, the plain version on CPU tensors.

    Args:
      row_ptr: (n + 1,) int32 row offsets of the forward CSR.
      col: int32 ids, each row ``col[row_ptr[x]:row_ptr[x + 1]]`` sorted
        ascending with each id once, as a simple graph's forward rows are
        (slots past ``row_ptr[n]`` are never read).
      src, dst: (E,) int32 endpoints of the rows to count, in [0, n); a
        bucket's real rows only (its padding rows carry 0, whose CSR row
        is no padding).
      width: the bucket width; each row is cut to its first ``width`` ids.

    Returns:
      (E,) int32 counts.

    Raises:
      ValueError: bad inputs or an unsupported device.
      RuntimeError: the kernel did not build or launch.
    """
    _launch.check_csr_rows(row_ptr, col, src, dst, width)
    if row_ptr.device.type == "cpu":
        return intersect_counts_probe_csr(row_ptr, col, src, dst, width)
    return _launch.launch_csr_counts(row_ptr, col, src, dst, width)
