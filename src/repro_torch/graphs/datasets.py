"""Dataset registry mirroring the paper's Table 1 (the port's copy of
``repro.graphs.datasets``).

The paper benchmarks six graphs (coAuthorsCiteseer, coPapersDBLP,
road_central, soc-LJ, cit-Patents, com-Orkut) spanning scale-free ('rs') and
mesh-like ('rm') topologies. Offline we register synthetic analogues with the
same topology class and (scaled-down) degree skew, so every benchmark keyed to
a Table-1 row has a concrete runnable graph here. Scale factors chosen for a
single-core CPU budget; the generators accept larger scales unchanged.
"""

from __future__ import annotations

from typing import Dict

from repro_torch.graphs.formats import Graph
from repro_torch.graphs import generators as gen

# name -> (factory, topology_class, paper_analogue)
DATASETS: Dict[str, dict] = {
    "coauthors-like": dict(
        factory=lambda: gen.rmat_graph(13, edge_factor=7, seed=1, name="coauthors-like"),
        type="rs",
        analogue="coAuthorsCiteseer (227K v, 1.6M e, scale-free)",
    ),
    "copapers-like": dict(
        factory=lambda: gen.rmat_graph(14, edge_factor=28, seed=2, name="copapers-like"),
        type="rs",
        analogue="coPapersDBLP (540K v, 30M e, scale-free, dense communities)",
    ),
    "road-like": dict(
        factory=lambda: gen.grid_graph(160, diagonals=True, spur_fraction=0.35,
                                       seed=3, name="road-like"),
        type="rm",
        analogue="road_central (14M v, 34M e, mesh-like, max degree 8)",
    ),
    "soclj-like": dict(
        factory=lambda: gen.rmat_graph(15, edge_factor=14, seed=4, name="soclj-like"),
        type="rs",
        analogue="soc-LiveJournal (4.8M v, 138M e, scale-free, max degree 20K)",
    ),
    "citpatents-like": dict(
        factory=lambda: gen.rmat_graph(14, edge_factor=4, a=0.45, b=0.22, c=0.22,
                                       seed=5, name="citpatents-like"),
        type="rs",
        analogue="cit-Patents (3.8M v, 33M e, low clustering)",
    ),
    "orkut-like": dict(
        factory=lambda: gen.rmat_graph(14, edge_factor=38, seed=6, name="orkut-like"),
        type="rs",
        analogue="com-Orkut (3.1M v, 234M e, scale-free, max degree 33K)",
    ),
    # small smoke-scale entries used by fast tests
    "tiny-rmat": dict(
        factory=lambda: gen.rmat_graph(8, edge_factor=8, seed=7, name="tiny-rmat"),
        type="rs",
        analogue="(test fixture)",
    ),
    "tiny-grid": dict(
        factory=lambda: gen.grid_graph(16, seed=8, name="tiny-grid"),
        type="rm",
        analogue="(test fixture)",
    ),
}


def available_datasets() -> list:
    """Sorted names of every registered dataset (the Table-1 analogues plus
    the tiny test fixtures)."""
    return sorted(DATASETS)


def load_dataset(name: str) -> Graph:
    """Build the registered dataset ``name``.

    Raises:
      ValueError: unknown name — the message lists every available dataset
        (a bare ``KeyError`` on a typo helped nobody).
    """
    try:
        spec = DATASETS[name]
    except KeyError:
        raise ValueError(
            f"unknown dataset {name!r}; available: "
            f"{', '.join(available_datasets())}"
        ) from None
    return spec["factory"]()
