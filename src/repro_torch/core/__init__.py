"""Triangle counting: options, registry, plan/execute engine (tiled
stages under a device budget, stacked graph batches), the five counting
lanes (intersection, subgraph, matrix, hash, bfs), the edge lane (edge
support, k-truss, truss decomposition: ``TrussPlan``), the dynamic lane
(``DynamicTriangleCounter`` / ``DynamicPlan``), the host listing oracles,
front door."""

from repro_torch.core.options import CountOptions, DEFAULT_WIDTHS
from repro_torch.core.registry import (
    available_algorithms,
    choose_algorithm,
    get_algorithm,
    register_algorithm,
)
from repro_torch.core.engine import (
    DynamicPlan,
    GraphBatch,
    TrianglePlan,
    TrussPlan,
    cache_info,
    clear_caches,
    executable_cache_info,
    plan_bfs_count,
    plan_dynamic_count,
    plan_edge_support,
    plan_hash_count,
    plan_triangle_count,
    set_cache_limit,
)
from repro_torch.core.api import (
    CountResult,
    CounterSession,
    DynamicTriangleCounter,
    TriangleCounter,
)
from repro_torch.core.listing import (
    clustering_coefficients,
    edge_support,
    enumerate_triangles,
    k_truss,
    transitivity,
    triangles_per_vertex,
)
from repro_torch.graphs.device import GraphTooLargeError
from repro_torch.graphs.formats import EdgeUpdate, normalize_edge_updates
from repro_torch.kernels.intersect.ops import available_strategies
from repro_torch.core.prep import (
    build_tile_schedule,
    choose_block,
    peel_to_two_core,
)
from repro_torch.core.tc_subgraph import subgraph_match_triangle
from repro_torch.core.oracle import (
    edge_support_forward_scipy,
    k_truss_forward_scipy,
    triangle_count_brute,
    triangle_count_forward_cpu,
    triangle_count_forward_scipy,
    triangle_count_scipy,
    truss_decomposition_forward_scipy,
)
from repro_torch.core import prep

__all__ = [
    "CountOptions",
    "CountResult",
    "CounterSession",
    "DEFAULT_WIDTHS",
    "DynamicPlan",
    "DynamicTriangleCounter",
    "EdgeUpdate",
    "GraphBatch",
    "GraphTooLargeError",
    "TriangleCounter",
    "TrianglePlan",
    "TrussPlan",
    "available_algorithms",
    "available_strategies",
    "build_tile_schedule",
    "cache_info",
    "choose_block",
    "choose_algorithm",
    "clear_caches",
    "clustering_coefficients",
    "edge_support",
    "edge_support_forward_scipy",
    "enumerate_triangles",
    "executable_cache_info",
    "get_algorithm",
    "k_truss",
    "k_truss_forward_scipy",
    "normalize_edge_updates",
    "peel_to_two_core",
    "plan_bfs_count",
    "plan_dynamic_count",
    "plan_edge_support",
    "plan_hash_count",
    "plan_triangle_count",
    "prep",
    "register_algorithm",
    "set_cache_limit",
    "subgraph_match_triangle",
    "transitivity",
    "triangle_count_brute",
    "triangle_count_forward_cpu",
    "triangle_count_forward_scipy",
    "triangle_count_scipy",
    "triangles_per_vertex",
    "truss_decomposition_forward_scipy",
]
