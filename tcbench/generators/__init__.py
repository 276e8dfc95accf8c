"""Frozen input generators, in torch on the device that runs the cell.

Each module here is named by a configuration's ``"generator"`` key and
defines ``make(params, seed, device, variant=0) -> (n, row_ptr, col_idx)``:
the undirected simple graph as an int32 CSR on ``device`` (both directions
of every edge, no self loop, each row sorted). ``variant`` redraws only the
randomness that leaves the triangle count as it is (a relabelling, or where
leaves hang), so every variant of one seed has the seed's count.

They are copies, kept here so that a change to the program cannot change
the benchmark's inputs.
"""

from __future__ import annotations

import hashlib
from typing import Tuple

import torch

__all__ = ["edges_to_csr", "seeded"]


def seeded(seed: int, stream: str, device: torch.device) -> torch.Generator:
    """A generator on ``device`` for one named stream of one seed. Any
    whole number is a seed: it is hashed with the stream's name into 64
    bits."""
    h = hashlib.blake2b(f"{int(seed)}:{stream}".encode(), digest_size=8)
    gen = torch.Generator(device=device)
    gen.manual_seed(int.from_bytes(h.digest(), "little") >> 1)
    return gen


def edges_to_csr(src: torch.Tensor, dst: torch.Tensor,
                 n: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """Symmetrise an int64 edge list, drop self loops and repeats, and
    return (row_ptr, col_idx) as int32 on the edges' device."""
    keep = src != dst
    src, dst = src[keep], dst[keep]
    keys = torch.unique(torch.cat([src * n + dst, dst * n + src]))
    rows = torch.div(keys, n, rounding_mode="floor")
    col_idx = (keys - rows * n).to(torch.int32)
    row_ptr = torch.zeros(n + 1, dtype=torch.int64, device=src.device)
    torch.cumsum(torch.bincount(rows, minlength=n), 0, out=row_ptr[1:])
    return row_ptr.to(torch.int32), col_idx
