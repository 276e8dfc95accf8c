"""Triangle counting: options, registry, plan/execute engine (tiled
stages under a device budget, stacked graph batches), the five counting
lanes (intersection, subgraph, matrix, hash, bfs), the edge lane (edge
support, k-truss, truss decomposition: ``TrussPlan``), the dynamic lane
(``DynamicTriangleCounter`` / ``DynamicPlan``), the host listing oracles,
front door, the measured ``algorithm="auto"`` chooser (calibration tables,
``CountOptions(chooser="measured")``), the sharded lanes over a
``torch.distributed`` ``DeviceMesh`` (``"intersection_distributed"``,
``"matrix_distributed"``, sharded edge support) and the deprecated one-shot
``triangle_count_*`` shims."""

from repro_torch.core.options import CHOOSERS, CountOptions, DEFAULT_WIDTHS
from repro_torch.core.registry import (
    available_algorithms,
    choose_algorithm,
    get_algorithm,
    register_algorithm,
    set_auto_chooser,
)
from repro_torch.core.engine import (
    DISTRIBUTED_ALGORITHMS,
    STRATEGIES,
    DynamicPlan,
    GraphBatch,
    TrianglePlan,
    TrussPlan,
    cache_info,
    choose_strategy,
    clear_caches,
    clear_executable_cache,
    executable_cache_info,
    mesh_cache_component,
    plan_bfs_count,
    plan_dynamic_count,
    plan_edge_support,
    plan_hash_count,
    plan_triangle_count,
    resolve_strategy,
    set_cache_limit,
)
from repro_torch.core.calibrate import (
    CalibrationTable,
    analytic_seed,
    calibrate,
    choose_measured,
    install_measured_chooser,
    load_table,
    save_table,
    set_default_table,
)
from repro_torch.core.api import (
    CountResult,
    CounterSession,
    DynamicTriangleCounter,
    TriangleCounter,
    graph_fingerprint,
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
from repro_torch.core.tc_intersection import (
    prepare_intersection_buckets,
    triangle_count_intersection,
)
from repro_torch.core.tc_matrix import triangle_count_matrix
from repro_torch.core.distributed import (
    triangle_count_intersection_distributed,
    triangle_count_matrix_distributed,
)
from repro_torch.core.tc_subgraph import (
    subgraph_match_triangle,
    triangle_count_subgraph,
)
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
    "CHOOSERS",
    "CalibrationTable",
    "CountOptions",
    "CountResult",
    "CounterSession",
    "DEFAULT_WIDTHS",
    "DISTRIBUTED_ALGORITHMS",
    "DynamicPlan",
    "DynamicTriangleCounter",
    "EdgeUpdate",
    "GraphBatch",
    "GraphTooLargeError",
    "STRATEGIES",
    "TriangleCounter",
    "TrianglePlan",
    "TrussPlan",
    "analytic_seed",
    "available_algorithms",
    "available_strategies",
    "build_tile_schedule",
    "cache_info",
    "calibrate",
    "choose_block",
    "choose_algorithm",
    "choose_measured",
    "choose_strategy",
    "clear_caches",
    "clear_executable_cache",
    "clustering_coefficients",
    "edge_support",
    "edge_support_forward_scipy",
    "enumerate_triangles",
    "executable_cache_info",
    "get_algorithm",
    "graph_fingerprint",
    "install_measured_chooser",
    "k_truss",
    "k_truss_forward_scipy",
    "load_table",
    "mesh_cache_component",
    "normalize_edge_updates",
    "peel_to_two_core",
    "plan_bfs_count",
    "plan_dynamic_count",
    "plan_edge_support",
    "plan_hash_count",
    "plan_triangle_count",
    "prep",
    "prepare_intersection_buckets",
    "register_algorithm",
    "resolve_strategy",
    "save_table",
    "set_auto_chooser",
    "set_cache_limit",
    "set_default_table",
    "subgraph_match_triangle",
    "transitivity",
    "triangle_count_brute",
    "triangle_count_forward_cpu",
    "triangle_count_forward_scipy",
    "triangle_count_intersection",
    "triangle_count_intersection_distributed",
    "triangle_count_matrix",
    "triangle_count_matrix_distributed",
    "triangle_count_scipy",
    "triangle_count_subgraph",
    "triangles_per_vertex",
    "truss_decomposition_forward_scipy",
]
