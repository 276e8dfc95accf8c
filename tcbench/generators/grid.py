"""A road-like mesh: a side × side grid, a diagonal in every unit square,
and leaf spurs.

Every vertex joins its right and lower neighbours, and with ``diagonals``
its lower-right one, which makes 2·(side − 1)² triangles. Then
``int(side² · spur_fraction)`` leaves are hung, each on a grid vertex drawn
uniformly with replacement: degree-1 vertices, in no triangle, that a
2-core peel removes.

Params: ``side``, ``diagonals``, ``spur_fraction``. ``variant`` hangs the
leaves on other vertices; the triangles stay the grid's.
"""

from __future__ import annotations

from typing import Any, Dict, Tuple

import torch

from tcbench.generators import edges_to_csr, seeded


def make(params: Dict[str, Any], seed: int, device: torch.device,
         variant: int = 0) -> Tuple[int, torch.Tensor, torch.Tensor]:
    side = int(params["side"])
    n_grid = side * side
    vid = torch.arange(n_grid, dtype=torch.int64, device=device).view(side, side)
    pairs = [(vid[:, :-1], vid[:, 1:]), (vid[:-1, :], vid[1:, :])]
    if params.get("diagonals", True):
        pairs.append((vid[:-1, :-1], vid[1:, 1:]))
    src = [s.reshape(-1) for s, _ in pairs]
    dst = [d.reshape(-1) for _, d in pairs]
    k = int(n_grid * float(params.get("spur_fraction", 0.0)))
    if k:
        src.append(torch.randint(
            0, n_grid, (k,), generator=seeded(seed, f"grid.spurs.{variant}",
                                              device), device=device))
        dst.append(n_grid + torch.arange(k, dtype=torch.int64, device=device))
    n = n_grid + k
    return (n,) + edges_to_csr(torch.cat(src), torch.cat(dst), n)
