"""The port's host graph layer equals the reference bit for bit.

Generators (same seeds ⇒ same edge arrays), the Table-1 dataset registry,
the CSR format conversions and the host oracles of ``repro_torch`` against
those of ``repro``.
"""

import numpy as np
import pytest

from torch_reference import ref  # noqa: F401

from repro_torch.core import oracle as port_oracle
from repro_torch.graphs import datasets as port_datasets
from repro_torch.graphs import formats as port_formats
from repro_torch.graphs import generators as port_gen

GENERATOR_CASES = [
    ("rmat_graph", (8,), dict(edge_factor=8, seed=7)),
    ("rmat_graph", (10,), dict(edge_factor=4, a=0.45, b=0.22, c=0.22, seed=5)),
    ("grid_graph", (12,), dict(seed=3)),
    ("grid_graph", (9,), dict(diagonals=False, spur_fraction=0.0)),
    ("erdos_renyi_graph", (200,), dict(avg_degree=6.0, seed=2)),
    ("watts_strogatz_graph", (100,), dict(k=6, p=0.2, seed=4)),
    ("complete_graph", (7,), {}),
    ("star_graph", (9,), {}),
    ("path_graph", (11,), {}),
]


def assert_same_graph(a, b):
    assert a.n == b.n
    assert a.name == b.name
    assert a.row_ptr.dtype == b.row_ptr.dtype and a.col_idx.dtype == b.col_idx.dtype
    np.testing.assert_array_equal(a.row_ptr, b.row_ptr)
    np.testing.assert_array_equal(a.col_idx, b.col_idx)


@pytest.mark.parametrize("fn,args,kwargs", GENERATOR_CASES,
                         ids=[f"{c[0]}{c[1]}" for c in GENERATOR_CASES])
def test_generators_match_reference(ref, fn, args, kwargs):
    assert_same_graph(getattr(port_gen, fn)(*args, **kwargs),
                      getattr(ref.generators, fn)(*args, **kwargs))


def test_dataset_registry_matches_reference(ref):
    assert port_datasets.available_datasets() == ref.datasets.available_datasets()
    for name, spec in port_datasets.DATASETS.items():
        assert spec["type"] == ref.datasets.DATASETS[name]["type"]
        assert spec["analogue"] == ref.datasets.DATASETS[name]["analogue"]
    with pytest.raises(ValueError) as port_err:
        port_datasets.load_dataset("nope")
    with pytest.raises(ValueError) as ref_err:
        ref.datasets.load_dataset("nope")
    assert str(port_err.value) == str(ref_err.value)


@pytest.mark.parametrize("name", sorted(port_datasets.DATASETS))
def test_datasets_match_reference(ref, name):
    assert_same_graph(port_datasets.load_dataset(name),
                      ref.datasets.load_dataset(name))


def test_formats_match_reference(ref):
    rng = np.random.default_rng(11)
    # dirty edge list: self loops, duplicates, both directions
    src = rng.integers(0, 40, size=300)
    dst = rng.integers(0, 40, size=300)
    g_port = port_formats.edges_to_csr(src, dst, n=45, name="dirty")
    g_ref = ref.formats.edges_to_csr(src, dst, n=45, name="dirty")
    assert_same_graph(g_port, g_ref)
    assert_same_graph(port_formats.orient_forward(g_port),
                      ref.formats.orient_forward(g_ref))
    for pad_to, fill in ((None, None), (3, None), (16, -7)):
        np.testing.assert_array_equal(
            port_formats.csr_to_padded_neighbors(g_port, pad_to, fill),
            ref.formats.csr_to_padded_neighbors(g_ref, pad_to, fill))
    s, d = g_port.edge_endpoints()
    for widths in ((8, 32), (2, 4)):
        pb = port_formats.bucket_edges_by_degree(s, d, g_port.degrees, widths)
        rb = ref.formats.bucket_edges_by_degree(s, d, g_ref.degrees, widths)
        assert [b["width"] for b in pb] == [b["width"] for b in rb]
        for x, y in zip(pb, rb):
            np.testing.assert_array_equal(x["src"], y["src"])
            np.testing.assert_array_equal(x["dst"], y["dst"])


def test_graph_from_arrays_carries_reference_graph(ref):
    g_ref = ref.generators.rmat_graph(7, edge_factor=6, seed=3)
    g = port_formats.graph_from_arrays(g_ref.n, g_ref.row_ptr, g_ref.col_idx,
                                       g_ref.name)
    assert_same_graph(g, g_ref)
    assert g.m_undirected == g_ref.m_undirected
    assert g.max_degree == g_ref.max_degree
    with pytest.raises(ValueError, match="row_ptr"):
        port_formats.graph_from_arrays(g_ref.n + 1, g_ref.row_ptr, g_ref.col_idx)
    with pytest.raises(ValueError, match="row_ptr"):
        port_formats.graph_from_arrays(g_ref.n, g_ref.row_ptr, g_ref.col_idx[:-1])


@pytest.mark.parametrize("fn", ["triangle_count_scipy", "triangle_count_brute",
                                "triangle_count_forward_cpu"])
def test_oracles_match_reference(ref, fn):
    for args in ((7, dict(edge_factor=6, seed=3)), (6, dict(edge_factor=10, seed=9))):
        g_ref = ref.generators.rmat_graph(args[0], **args[1])
        g = port_gen.rmat_graph(args[0], **args[1])
        want = getattr(ref.oracle, fn)(g_ref)
        assert getattr(port_oracle, fn)(g) == want
        assert port_oracle.triangle_count_forward_scipy(g) == want
