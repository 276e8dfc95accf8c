"""The plain reference of an exact triangle count, in torch (any device).

It works from the CSR the harness handed to the program, and from nothing
the program made. Each undirected edge is oriented from the endpoint of
lower (degree, id) to the higher one, so that a triangle's three vertices
x < y < z in that order give the forward edges x → y, x → z and y → z.
For every vertex u and every pair v < w of its forward neighbours, the
pair closes a triangle iff {v, w} is an edge, which a binary search of the
sorted edge keys decides. Each triangle is found once, at its lowest
vertex, and credited to the forward edge (u, v).

``count`` sums those per-edge counts in int64. ``count_float32`` is the
control: the same counts accumulated one by one in float32, the precision
below the configuration's int64. Past 2**24 a float32 total can no longer
add 1, so on the benchmark's graphs it is not exact.
"""

from __future__ import annotations

import numpy as np
import torch

__all__ = ["count", "count_float32", "forward_edge_counts"]

# vertex pairs a chunk tests at once: 8 int64 arrays of this length
_CHUNK_PAIRS = 1 << 25


def forward_edge_counts(row_ptr: np.ndarray, col_idx: np.ndarray,
                        device: torch.device,
                        chunk_pairs: int = _CHUNK_PAIRS) -> torch.Tensor:
    """The triangles credited to each forward edge, (E_fwd,) int64 on
    ``device``, in (source, destination) order."""
    rp = torch.as_tensor(np.asarray(row_ptr, dtype=np.int64)).to(device)
    ci = torch.as_tensor(np.asarray(col_idx, dtype=np.int64)).to(device)
    n = rp.numel() - 1
    deg = rp[1:] - rp[:-1]
    src = torch.repeat_interleave(torch.arange(n, device=device), deg)
    ds, dd = deg[src], deg[ci]
    fwd = (ds < dd) | ((ds == dd) & (src < ci))
    fs, fd = src[fwd], ci[fwd]  # rows stay sorted by destination id
    del rp, ci, deg, src, ds, dd, fwd
    e = fs.numel()
    counts = torch.zeros(e, dtype=torch.int64, device=device)
    if e == 0:
        return counts
    keys = torch.sort(torch.minimum(fs, fd) * n + torch.maximum(fs, fd)).values
    fdeg = torch.bincount(fs, minlength=n)
    first_of_row = torch.cumsum(fdeg, 0) - fdeg
    # the forward edges after this one in its row: its partners
    partners = fdeg[fs] - 1 - (torch.arange(e, device=device) - first_of_row[fs])
    del fdeg, first_of_row
    ends = torch.cumsum(partners, 0)
    a, done = 0, 0
    while a < e:
        b = int(torch.searchsorted(
            ends, torch.tensor([done + chunk_pairs], device=device),
            right=True)[0])
        b = min(max(b, a + 1), e)
        p = partners[a:b]
        total = int(ends[b - 1]) - done
        if total:
            edge = torch.repeat_interleave(
                torch.arange(a, b, device=device), p, output_size=total)
            before = torch.repeat_interleave(torch.cumsum(p, 0) - p, p,
                                             output_size=total)
            other = edge + 1 + (torch.arange(total, device=device) - before)
            del before
            want = fd[edge] * n + fd[other]  # v < w: rows are sorted
            del other
            at = torch.searchsorted(keys, want).clamp_(max=keys.numel() - 1)
            hit = keys[at] == want
            del at, want
            counts[a:b] += torch.bincount(edge[hit] - a, minlength=b - a)
            del edge, hit
        done += total
        a = b
    return counts


def count(row_ptr: np.ndarray, col_idx: np.ndarray,
          device: torch.device) -> int:
    """The exact triangle count of the CSR graph."""
    return int(forward_edge_counts(row_ptr, col_idx, device).sum())


def count_float32(row_ptr: np.ndarray, col_idx: np.ndarray,
                  device: torch.device) -> int:
    """The control: the per-edge counts added one after another into a
    float32 total (``numpy.cumsum`` adds in order)."""
    per_edge = forward_edge_counts(row_ptr, col_idx, device)
    if per_edge.numel() == 0:
        return 0
    acc = np.cumsum(per_edge.cpu().numpy().astype(np.float32),
                    dtype=np.float32)
    return int(acc[-1])
