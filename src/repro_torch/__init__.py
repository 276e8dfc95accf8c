"""PyTorch/CUDA port of the triangle-counting system in ``repro``.

The intersection lane runs end to end: numpy ``Graph`` → device prep in
torch → per-bucket set intersection through hand-written CUDA kernels for
Hopper (``csrc/intersect.cu``, built with ``nvcc`` at first use) →
``TriangleCounter(g).count()``. Entry points run on the CUDA device unless
they are given ``device="cpu"``, where each kernel's plain torch version
runs instead. The package imports neither JAX nor ``repro``.
"""

from repro_torch.core import CountOptions, CountResult, TriangleCounter
from repro_torch.graphs import Graph, graph_from_arrays

__all__ = ["CountOptions", "CountResult", "Graph", "TriangleCounter",
           "graph_from_arrays"]
