"""Triangle counting: options, registry, plan/execute engine (tiled
stages under a device budget, stacked graph batches), the five lanes
(intersection, subgraph, matrix, hash, bfs), front door."""

from repro_torch.core.options import CountOptions, DEFAULT_WIDTHS
from repro_torch.core.registry import (
    available_algorithms,
    choose_algorithm,
    get_algorithm,
    register_algorithm,
)
from repro_torch.core.engine import (
    GraphBatch,
    TrianglePlan,
    cache_info,
    clear_caches,
    executable_cache_info,
    plan_bfs_count,
    plan_hash_count,
    plan_triangle_count,
    set_cache_limit,
)
from repro_torch.core.api import CountResult, CounterSession, TriangleCounter
from repro_torch.core.prep import (
    build_tile_schedule,
    choose_block,
    peel_to_two_core,
)
from repro_torch.core.tc_subgraph import subgraph_match_triangle
from repro_torch.core.oracle import (
    triangle_count_brute,
    triangle_count_forward_cpu,
    triangle_count_forward_scipy,
    triangle_count_scipy,
)
from repro_torch.core import prep

__all__ = [
    "CountOptions",
    "CountResult",
    "CounterSession",
    "DEFAULT_WIDTHS",
    "GraphBatch",
    "TriangleCounter",
    "TrianglePlan",
    "available_algorithms",
    "build_tile_schedule",
    "cache_info",
    "choose_block",
    "choose_algorithm",
    "clear_caches",
    "executable_cache_info",
    "get_algorithm",
    "peel_to_two_core",
    "plan_bfs_count",
    "plan_hash_count",
    "plan_triangle_count",
    "prep",
    "register_algorithm",
    "set_cache_limit",
    "subgraph_match_triangle",
    "triangle_count_brute",
    "triangle_count_forward_cpu",
    "triangle_count_forward_scipy",
    "triangle_count_scipy",
]
