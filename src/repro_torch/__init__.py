"""PyTorch/CUDA port of the triangle-counting system in ``repro``.

The paper's three formulations and two further lanes run end to end:
numpy ``Graph`` → device prep in torch → hand-written CUDA kernels for
Hopper, built with ``nvcc`` at first use → ``TriangleCounter(g).count()``.
The intersection lane (and the subgraph lane after its 2-core peel, and
the bfs lane after its level orientation) counts per-bucket set
intersections (``csrc/intersect.cu``); the matrix lane runs a fused masked
block-SpGEMM over a tile schedule (``csrc/masked_spgemm.cu``); the hash
lane probes a per-vertex hash table (``csrc/hash_probe.cu``). The edge lane
(``TriangleCounter(g).edge_support()`` / ``k_truss(k)`` /
``truss_decomposition()``) and dynamic sessions
(``DynamicTriangleCounter``) work over packed undirected-edge keys on the
device; the dynamic recount runs the intersection kernels.
``CountOptions(chooser="measured")`` resolves ``algorithm="auto"`` through
a calibration table timed on the card (``repro_torch.core.calibrate``),
and ``repro_torch.serve.TriangleService`` serves concurrent requests over
the stacked batch launches. Entry points run on the CUDA device unless
they are given ``device="cpu"``, where each kernel's plain torch version
runs instead. The package imports neither JAX nor ``repro``.
"""

from repro_torch.core import (
    CountOptions,
    CountResult,
    DynamicTriangleCounter,
    TriangleCounter,
)
from repro_torch.graphs import EdgeUpdate, Graph, graph_from_arrays

__all__ = ["CountOptions", "CountResult", "DynamicTriangleCounter",
           "EdgeUpdate", "Graph", "TriangleCounter", "graph_from_arrays"]
