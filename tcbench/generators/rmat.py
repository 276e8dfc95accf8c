"""Graph500's Kronecker (R-MAT) graph, with Graph500's random relabelling.

``edge_factor · 2**scale`` edges are drawn. Each picks, at every one of the
``scale`` levels, a quadrant of the adjacency matrix with probabilities
a, b, c and d = 1 − a − b − c: b sets the level's bit of the destination,
c that of the source, d both. The vertex ids are then relabelled by a
random permutation, as Graph500's generator does, so that an id says
nothing of a vertex's degree. Repeated edges and self loops are dropped
when the graph is made simple.

Params: ``scale``, ``edge_factor``, ``a``, ``b``, ``c``, ``permute``.
``variant`` draws another permutation of the same edges.
"""

from __future__ import annotations

from typing import Any, Dict, Tuple

import torch

from tcbench.generators import edges_to_csr, seeded


def make(params: Dict[str, Any], seed: int, device: torch.device,
         variant: int = 0) -> Tuple[int, torch.Tensor, torch.Tensor]:
    scale = int(params["scale"])
    a, b, c = float(params["a"]), float(params["b"]), float(params["c"])
    n = 1 << scale
    m = n * int(params["edge_factor"])
    r = torch.rand((scale, m), generator=seeded(seed, "rmat.edges", device),
                   device=device)
    ab, abc = a + b, a + b + c
    bit = torch.ones((scale, 1), dtype=torch.int64, device=device) \
        << torch.arange(scale, device=device).unsqueeze(1)
    src = ((r >= ab).long() * bit).sum(0)
    dst = ((((r >= a) & (r < ab)) | (r >= abc)).long() * bit).sum(0)
    del r
    if params.get("permute", True):
        perm = torch.randperm(
            n, generator=seeded(seed, f"rmat.perm.{variant}", device),
            device=device)
        src, dst = perm[src], perm[dst]
    return (n,) + edges_to_csr(src, dst, n)
