"""The frozen generators and the plain reference, on the CPU.

The reference must give the closed forms, agree with the program's CPU
path on small seeded graphs, and its float32 control must fail where a
count passes 2**24.
"""

from __future__ import annotations

import math

import numpy as np
import pytest
import torch

from tcbench.generators import edges_to_csr, grid, rgg, rmat, seeded
from tcbench.references import triangles

CPU = torch.device("cpu")
RMAT = {"scale": 8, "edge_factor": 16, "a": 0.57, "b": 0.19, "c": 0.19,
        "permute": True}


def _csr(src, dst, n):
    rp, ci = edges_to_csr(torch.as_tensor(src, dtype=torch.int64),
                          torch.as_tensor(dst, dtype=torch.int64), n)
    return rp.numpy(), ci.numpy()


def _complete(n):
    i, j = np.triu_indices(n, 1)
    return _csr(i, j, n)


@pytest.mark.parametrize("n", [3, 4, 7, 30])
def test_complete_graph_closed_form(n):
    assert triangles.count(*_complete(n), CPU) == math.comb(n, 3)


@pytest.mark.parametrize("side", [2, 3, 17])
def test_grid_closed_form(side):
    n, rp, ci = grid.make({"side": side, "diagonals": True,
                           "spur_fraction": 0.35}, 5, CPU)
    assert n == side * side + int(side * side * 0.35)
    assert triangles.count(rp.numpy(), ci.numpy(), CPU) == 2 * (side - 1) ** 2


def test_grid_without_diagonals_has_none():
    _, rp, ci = grid.make({"side": 9, "diagonals": False,
                           "spur_fraction": 0.2}, 5, CPU)
    assert triangles.count(rp.numpy(), ci.numpy(), CPU) == 0


@pytest.mark.parametrize("n", [1, 2, 50])
def test_star_and_empty_have_none(n):
    rp, ci = _csr(np.zeros(n - 1), np.arange(1, n), n)
    assert triangles.count(rp, ci, CPU) == 0
    rp, ci = _csr(np.zeros(0), np.zeros(0), n)
    assert triangles.count(rp, ci, CPU) == 0


def test_csr_is_simple_and_sorted():
    rp, ci = _csr([0, 1, 1, 2, 2, 3], [1, 0, 1, 3, 3, 2], 5)
    assert rp.tolist() == [0, 1, 2, 3, 4, 4]
    assert ci.tolist() == [1, 0, 3, 2]
    assert rp.dtype == np.int32 and ci.dtype == np.int32


def test_small_chunks_give_the_same_count():
    _, rp, ci = rmat.make(RMAT, 3, CPU)
    whole = triangles.forward_edge_counts(rp.numpy(), ci.numpy(), CPU)
    tiny = triangles.forward_edge_counts(rp.numpy(), ci.numpy(), CPU,
                                         chunk_pairs=1000)
    assert torch.equal(whole, tiny) and int(whole.sum()) > 0


@pytest.mark.parametrize("seed", [0, 1, 2**31 + 11])
def test_generators_repeat_and_variants_keep_the_count(seed):
    for mod, params in ((rmat, RMAT), (grid, {"side": 12, "diagonals": True,
                                              "spur_fraction": 0.35})):
        n, rp, ci = mod.make(params, seed, CPU)
        n2, rp2, ci2 = mod.make(params, seed, CPU)
        assert n == n2 and torch.equal(rp, rp2) and torch.equal(ci, ci2)
        n3, rp3, ci3 = mod.make(params, seed, CPU, variant=1)
        assert n3 == n and int(rp3[-1]) == int(rp[-1])
        assert not torch.equal(ci3, ci)
        assert triangles.count(rp3.numpy(), ci3.numpy(), CPU) == \
            triangles.count(rp.numpy(), ci.numpy(), CPU)


@pytest.mark.parametrize("seed", [0, 7])
def test_reference_agrees_with_the_program_on_the_cpu(seed):
    from repro_torch.core.api import TriangleCounter
    from repro_torch.graphs import graph_from_arrays
    cases = [(rmat, RMAT, "auto"),
             (grid, {"side": 24, "diagonals": True, "spur_fraction": 0.35},
              "subgraph")]
    for mod, params, algorithm in cases:
        n, rp, ci = mod.make(params, seed, CPU)
        want = triangles.count(rp.numpy(), ci.numpy(), CPU)
        g = graph_from_arrays(n, rp.numpy(), ci.numpy())
        got = TriangleCounter(g, device="cpu", algorithm=algorithm).count()
        assert got.count == want


@pytest.mark.parametrize("seed", [0, 2**31 + 17])
def test_rgg_matches_every_pair_tested(seed):
    """The cell grid finds exactly the pairs closer than the radius that a
    test of all pairs finds, and the reference counts its triangles as a
    dense cube of the adjacency matrix does."""
    log2_n = 9
    n, rp, ci = rgg.make({"log2_n": log2_n, "radius_factor": 0.55}, seed,
                         CPU)
    xy = torch.rand((2, n), dtype=torch.float64,
                    generator=seeded(seed, "rgg.points", CPU))
    r = rgg.radius(n, 0.55)
    d2 = (xy[0][:, None] - xy[0][None]) ** 2 + \
        (xy[1][:, None] - xy[1][None]) ** 2
    adj = d2 < r * r
    adj.fill_diagonal_(False)
    assert int(rp[-1]) == int(adj.sum())
    degrees = torch.sort(adj.sum(1)).values
    assert torch.equal(torch.sort((rp[1:] - rp[:-1]).long()).values, degrees)
    a = adj.double()
    want = int(torch.trace(a @ a @ a).item()) // 6
    assert triangles.count(rp.numpy(), ci.numpy(), CPU) == want > 0
    n2, rp2, ci2 = rgg.make({"log2_n": log2_n, "radius_factor": 0.55}, seed,
                            CPU, variant=1)
    assert triangles.count(rp2.numpy(), ci2.numpy(), CPU) == want


def test_the_float32_control_fails_past_2_to_the_24():
    n = 470  # C(470, 3) = 17,193,540 > 2**24
    assert math.comb(n, 3) > 2**24
    control = triangles.count_float32(*_complete(n), CPU)
    assert control != math.comb(n, 3)


def test_the_float32_control_is_exact_below_2_to_the_24():
    assert triangles.count_float32(*_complete(40), CPU) == math.comb(40, 3)
