"""DIMACS10's random geometric graph ``rgg_n_2_<log2_n>_s0``.

``2**log2_n`` points are drawn uniformly in the unit square, and two points
are joined where their Euclidean distance is below
``radius_factor · sqrt(ln n / n)`` (DIMACS10 uses 0.55, which leaves the
graph almost connected). Pairs are found through a grid of square cells at
least that wide, so each point is compared only with the points of its own
cell and of the cells beside it. Vertices are numbered cell by cell, row by
row, so that neighbours have near ids.

Params: ``log2_n``, ``radius_factor``. ``variant`` relabels the vertices by
a random permutation; the triangles stay the graph's.
"""

from __future__ import annotations

import math
from typing import Any, Dict, Tuple

import torch

from tcbench.generators import edges_to_csr, seeded

# candidate pairs tested at once
_CHUNK_PAIRS = 1 << 26
# the cells a point is compared with: its own (later points only) and the
# four that follow it, so that each pair of cells is visited once
_OFFSETS = ((0, 0), (1, 0), (-1, 1), (0, 1), (1, 1))


def radius(n: int, factor: float) -> float:
    return float(factor) * math.sqrt(math.log(n) / n)


def make(params: Dict[str, Any], seed: int, device: torch.device,
         variant: int = 0) -> Tuple[int, torch.Tensor, torch.Tensor]:
    n = 1 << int(params["log2_n"])
    r = radius(n, params["radius_factor"])
    side = max(1, int(1.0 / r))  # cells per side, each at least r wide
    xy = torch.rand((2, n), dtype=torch.float64,
                    generator=seeded(seed, "rgg.points", device),
                    device=device)
    cell = (xy * side).long().clamp_(max=side - 1)
    cid = cell[1] * side + cell[0]
    cid, order = torch.sort(cid, stable=True)
    x, y = xy[0][order], xy[1][order]
    cx, cy = cell[0][order], cell[1][order]
    del xy, cell, order
    per_cell = torch.bincount(cid, minlength=side * side)
    start = torch.zeros(side * side + 1, dtype=torch.int64, device=device)
    torch.cumsum(per_cell, 0, out=start[1:])
    del per_cell
    r2 = r * r
    src, dst = [], []
    for dx, dy in _OFFSETS:
        nx, ny = cx + dx, cy + dy
        ok = (nx >= 0) & (nx < side) & (ny < side)
        nc = torch.where(ok, ny * side + nx, 0)
        lo = torch.where(ok, start[nc], 0)
        hi = torch.where(ok, start[nc + 1], 0)
        if dx == 0 and dy == 0:  # own cell: the points after this one
            lo = torch.arange(n, device=device) + 1
        many = (hi - lo).clamp_(min=0)
        del nx, ny, ok, nc, hi
        ends = torch.cumsum(many, 0)
        a, done = 0, 0
        while a < n:
            b = int(torch.searchsorted(
                ends, torch.tensor([done + _CHUNK_PAIRS], device=device),
                right=True)[0])
            b = min(max(b, a + 1), n)
            p = many[a:b]
            total = int(ends[b - 1]) - done
            if total:
                i = torch.repeat_interleave(
                    torch.arange(a, b, device=device), p, output_size=total)
                first = torch.repeat_interleave(
                    lo[a:b] - (torch.cumsum(p, 0) - p), p,
                    output_size=total)
                j = first + torch.arange(total, device=device)
                del first
                near = (x[i] - x[j]).square_() + (y[i] - y[j]).square_() < r2
                src.append(i[near])
                dst.append(j[near])
                del i, j, near
            done += total
            a = b
        del lo, many, ends
    del x, y, cx, cy, cid, start
    src, dst = torch.cat(src), torch.cat(dst)
    if variant:
        perm = torch.randperm(n, generator=seeded(seed, f"rgg.perm.{variant}",
                                                  device), device=device)
        src, dst = perm[src], perm[dst]
    return (n,) + edges_to_csr(src, dst, n)
