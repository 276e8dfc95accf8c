"""Graph containers, generators, datasets and device prep."""

from repro_torch.graphs.formats import (
    Graph,
    bucket_edges_by_degree,
    csr_to_padded_neighbors,
    edges_to_csr,
    graph_from_arrays,
    orient_forward,
)
from repro_torch.graphs.device import (
    DEFAULT_SHAPE_POLICY,
    DeviceCSR,
    DeviceGraph,
    GraphTooLargeError,
    ShapePolicy,
    fits_int32_pair_keys,
    resolve_device,
    resolve_edge_key_mode,
)
from repro_torch.graphs.generators import (
    complete_graph,
    erdos_renyi_graph,
    grid_graph,
    path_graph,
    rmat_graph,
    star_graph,
    watts_strogatz_graph,
)
from repro_torch.graphs.datasets import DATASETS, available_datasets, load_dataset

__all__ = [
    "DATASETS",
    "DEFAULT_SHAPE_POLICY",
    "DeviceCSR",
    "DeviceGraph",
    "Graph",
    "GraphTooLargeError",
    "ShapePolicy",
    "available_datasets",
    "bucket_edges_by_degree",
    "complete_graph",
    "csr_to_padded_neighbors",
    "edges_to_csr",
    "erdos_renyi_graph",
    "fits_int32_pair_keys",
    "graph_from_arrays",
    "grid_graph",
    "load_dataset",
    "orient_forward",
    "path_graph",
    "resolve_device",
    "resolve_edge_key_mode",
    "rmat_graph",
    "star_graph",
    "watts_strogatz_graph",
]
