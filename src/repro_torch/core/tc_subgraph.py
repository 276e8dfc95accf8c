"""Subgraph-matching triangle counting: FILTER, RECONSTRUCT, JOIN.

FILTER: candidate vertices must meet the triangle query's degree (≥ 2)
and label constraints. Iterated to its fixed point that is a 2-core peel,
run on the device with one host sync a round
(``repro_torch.core.prep.peel_to_two_core_device``); it is what wins on
mesh-like graphs, where leaf cascades collapse.

RECONSTRUCT: the surviving vertex mask reforms the induced subgraph (on
the device with the original ids kept, or renumbered on the host).

JOIN: candidate edges are joined under the triangle's intersection rule,
|N(u) ∩ N(v)| over the survivors, through the same bucketed set-
intersection kernels as the intersection lane (K1–K3). The join's ordered
embeddings are 6 per triangle (``meta["num_embeddings"]``).

This module registers the ``"subgraph"`` lane; the front door is
``TriangleCounter(g, CountOptions(algorithm="subgraph"))``.
``subgraph_match_triangle`` counts labeled triangle queries, whose
per-query candidate-edge masks keep them one-shot.
"""

from __future__ import annotations

from typing import Tuple, Union

import numpy as np
import torch

from repro_torch.graphs.device import resolve_device
from repro_torch.graphs.formats import (
    Graph,
    bucket_edges_by_degree,
    csr_to_padded_neighbors,
    induced_subgraph,
)
from repro_torch.core.engine import get_executable, plan_triangle_count
from repro_torch.core.prep import _two_core_peel, peel_to_two_core
from repro_torch.core.registry import register_algorithm
from repro_torch.kernels.intersect.ops import resolve_strategy

__all__ = ["peel_to_two_core", "subgraph_match_triangle",
           "triangle_count_subgraph"]


def _planner(g: Graph, options, *, device, mesh=None):
    """Registry planner: CountOptions → subgraph-lane TrianglePlan (a mesh
    is ignored)."""
    return plan_triangle_count(g, "subgraph", device=device,
                               **options.plan_kwargs("subgraph"))


register_algorithm("subgraph", _planner)


def triangle_count_subgraph(
    g: Graph,
    *,
    backend: str = "kernel",
    return_stats: bool = False,
    device: Union[None, str, torch.device] = None,
):
    """Deprecated shim: the exact count by filter (2-core peel), reform and
    join.

    Use ``TriangleCounter(g, CountOptions(algorithm="subgraph", ...))``;
    its ``CountResult.meta`` carries what ``return_stats=True`` returns
    here. Returns an int, or ``(int, stats dict)`` with
    ``return_stats=True``.
    """
    from repro_torch.core.api import TriangleCounter, warn_deprecated
    from repro_torch.core.options import CountOptions

    warn_deprecated(
        "triangle_count_subgraph(g, ...)",
        'TriangleCounter(g, CountOptions(algorithm="subgraph", ...)).count()',
    )
    opts = CountOptions(algorithm="subgraph", backend=backend)
    result = TriangleCounter(g, opts, device=device).count()
    if return_stats:
        meta = result.meta
        stats = dict(
            vertices_pruned=meta["vertices_pruned"],
            prune_fraction=meta["prune_fraction"],
            edges_after=meta["edges_after"],
            edges_before=meta["edges_before"],
            num_embeddings=meta["num_embeddings"],
        )
        return result.count, stats
    return result.count


def subgraph_match_triangle(
    g: Graph,
    labels: np.ndarray,
    query_labels: Tuple[int, int, int],
    *,
    backend: str = "kernel",
    device: Union[None, str, torch.device] = None,
) -> int:
    """Count the embeddings of a labeled triangle query.

    Args:
      g: undirected simple ``Graph``.
      labels: (n,) integer vertex labels.
      query_labels: (q0, q1, q2).
      backend: "kernel" | "ref" per-bucket execution path.
      device: where the buckets are counted; None means the CUDA device
        (see ``resolve_device``).

    Returns:
      The number of ordered embeddings (u, v, w) with labels (q0, q1, q2)
      and {u, v}, {v, w}, {u, w} ∈ E.
    """
    device = resolve_device(device)
    labels = np.asarray(labels)
    q0, q1, q2 = query_labels
    if g.m_directed == 0:
        return 0
    # candidates: a query label, then the 2-core of the induced graph
    cand = np.isin(labels, list(query_labels))
    src, dst = g.edge_endpoints()
    alive = _two_core_peel(torch.from_numpy(src), torch.from_numpy(dst),
                           torch.from_numpy(cand), n=g.n).numpy()
    sub, old_ids = induced_subgraph(g, alive)
    if sub.m_directed == 0:
        return 0
    sl = labels[old_ids]
    # candidate edges for query edge (q0, q1); the join keeps w labeled q2
    s_src, s_dst = sub.edge_endpoints()
    e_keep = (sl[s_src] == q0) & (sl[s_dst] == q1)
    if not e_keep.any():
        return 0
    buckets = bucket_edges_by_degree(s_src[e_keep], s_dst[e_keep], sub.degrees)
    q2_ok = sl == q2
    total = 0
    for b in buckets:
        nbrs = csr_to_padded_neighbors(sub, pad_to=b["width"], fill=sub.n)
        u_lists = nbrs[b["src"]].copy()
        v_lists = nbrs[b["dst"]].copy()
        # non-q2 neighbours become the u sentinel, so they never match
        valid = (u_lists < sub.n) & q2_ok[np.clip(u_lists, 0, sub.n - 1)]
        u_lists[~valid] = sub.n
        # the probe kernel merges sorted rows: the sentinels move to each
        # row's tail (n is above every real id), which keeps every count
        u_lists.sort(axis=1)
        v_lists[v_lists == sub.n] = sub.n + 1
        strat, bits = resolve_strategy(b["width"], sub.n + 2)
        run = get_executable("intersection", backend, tuple(u_lists.shape),
                             strategy=strat, bitmap_bits=bits)
        total += int(run(torch.from_numpy(u_lists).to(device),
                         torch.from_numpy(v_lists).to(device)))
    return total
