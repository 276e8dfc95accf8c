"""The port's matrix lane equals the reference's, bit for bit.

The host layer (``to_block_sparse``, ``degree_order_permutation``,
``apply_permutation``, ``choose_block``) and the tile schedule
(``build_tile_schedule``: the three heavy-first (T, B, B) stacks and their
stats, and the unique tiles and indices the lane holds) against
``repro``'s; the plain version of K4 against the reference's
one-shot einsum, its chunked path and the Pallas kernel in interpret mode,
with tolerance 0 (0/1 tiles: every partial is an exact integer); matrix-lane
counts against the reference's plan and scipy; ``auto`` on a small dense
graph; the per-vertex sidecar; and the exact int64 sum past 2²⁴.
"""

import math

import numpy as np
import pytest
import torch

from torch_reference import ref  # noqa: F401

from repro_torch.core import TriangleCounter, plan_triangle_count, triangle_count_scipy
from repro_torch.core import prep as port_prep
from repro_torch.core.engine import get_executable
from repro_torch.graphs import formats as port_formats
from repro_torch.graphs import generators as port_gen
from repro_torch.graphs.datasets import load_dataset
from repro_torch.graphs.formats import edges_to_csr
from repro_torch.kernels.masked_spgemm import (
    LAUNCHES,
    masked_spgemm_chunked,
    masked_spgemm_counts,
    masked_spgemm_kernel,
    masked_spgemm_ref,
)

CPU = "cpu"

GRAPHS = {
    "tiny-rmat": lambda: load_dataset("tiny-rmat"),
    "tiny-grid": lambda: load_dataset("tiny-grid"),
    "rmat9": lambda: port_gen.rmat_graph(9, 8),
    "clique40": lambda: port_gen.complete_graph(40),
}


def _ref_graph(ref, g):
    return ref.formats.Graph(n=g.n, row_ptr=g.row_ptr, col_idx=g.col_idx,
                             name=g.name)


def _tiles(t, b, seed):
    """Random 0/1 (T, B, B) float32 L, U, A stacks, density 0.02–0.5."""
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(3):
        dens = rng.uniform(0.02, 0.5, size=(t, 1, 1))
        out.append((rng.random((t, b, b)) < dens).astype(np.float32))
    return out


@pytest.mark.parametrize("block", [8, 32])
@pytest.mark.parametrize("part", ["full", "lower", "upper"])
@pytest.mark.parametrize("name", list(GRAPHS))
def test_block_sparse_matches_reference(ref, name, part, block):
    g = GRAPHS[name]()
    got = port_formats.to_block_sparse(g, block=block, part=part)
    want = ref.formats.to_block_sparse(_ref_graph(ref, g), block=block, part=part)
    assert (got.n, got.block, got.grid) == (want.n, want.block, want.grid)
    for field in ("block_row", "block_col", "blocks"):
        a, w = getattr(got, field), getattr(want, field)
        assert a.dtype == w.dtype, field
        np.testing.assert_array_equal(a, w, err_msg=field)
    np.testing.assert_array_equal(got.to_dense(), want.to_dense())


@pytest.mark.parametrize("name", list(GRAPHS) + ["star", "road-like"])
def test_permutation_and_block_choice_match_reference(ref, name):
    g = port_gen.star_graph(20) if name == "star" else \
        load_dataset(name) if name == "road-like" else GRAPHS[name]()
    rg = _ref_graph(ref, g)
    perm = port_formats.degree_order_permutation(g)
    np.testing.assert_array_equal(perm, ref.formats.degree_order_permutation(rg))
    assert perm.dtype == np.int32
    got = port_formats.apply_permutation(g, perm)
    want = ref.formats.apply_permutation(rg, perm)
    np.testing.assert_array_equal(got.row_ptr, want.row_ptr)
    np.testing.assert_array_equal(got.col_idx, want.col_idx)
    assert port_prep.choose_block(g) == ref.prep.choose_block(rg)


@pytest.mark.parametrize("block", [8, 16, "auto"])
@pytest.mark.parametrize("name", list(GRAPHS))
def test_tile_schedule_matches_reference(ref, name, block):
    g = GRAPHS[name]()
    b = port_prep.choose_block(g) if block == "auto" else block
    got = port_prep.build_tile_schedule(g, block=b)
    want = ref.prep.build_tile_schedule(_ref_graph(ref, g), block=b)
    assert got[3] == want[3]
    for a, w in zip(got[:3], want[:3]):
        assert a.dtype == np.float32 and a.shape == w.shape
        np.testing.assert_array_equal(a, np.asarray(w))
    # the unique tiles on the device, gathered through the triple indices,
    # give the same stacks
    sched = port_prep.tile_schedule(g, block=b)
    l_blocks, u_blocks, li, ui, ai = sched.to_device(CPU)
    for tiles, idx, w in ((l_blocks, li, got[0]), (u_blocks, ui, got[1]),
                          (u_blocks, ai, got[2])):
        np.testing.assert_array_equal(tiles[idx.long()].float().numpy(), w)


def test_tile_schedule_without_permutation_matches_reference(ref):
    g = GRAPHS["rmat9"]()
    got = port_prep.build_tile_schedule(g, block=32, permute=False)
    want = ref.prep.build_tile_schedule(_ref_graph(ref, g), block=32,
                                        permute=False)
    assert got[3] == want[3]
    for a, w in zip(got[:3], want[:3]):
        np.testing.assert_array_equal(a, np.asarray(w))


@pytest.mark.parametrize("b", [8, 16, 48])
@pytest.mark.parametrize("t", [1, 5, 9])
def test_plain_k4_matches_reference_exactly(ref, t, b):
    l_np, u_np, a_np = _tiles(t, b, seed=t * 100 + b)
    l, u, a = (torch.from_numpy(x) for x in (l_np, u_np, a_np))
    got = masked_spgemm_kernel(l, u, a)  # a CPU tensor: the plain version
    assert got.dtype == torch.float32 and got.shape == (t,)
    want = [
        ref.msref.masked_spgemm_ref(l_np, u_np, a_np),
        ref.msops._masked_spgemm_chunked(l_np, u_np, a_np),
        ref.mskernel.masked_spgemm_pallas(l_np, u_np, a_np, tile_triples=1,
                                          interpret=True),
    ]
    for w in want:  # tolerance 0
        np.testing.assert_array_equal(got.numpy(), np.asarray(w))
    for other in (masked_spgemm_chunked(l, u, a), masked_spgemm_ref(l, u, a),
                  masked_spgemm_counts(l, u, a, backend="ref")):
        assert torch.equal(other, got)
    # integer partials: sum(A ∘ (L @ U)) in exact int64 arithmetic
    exact = np.einsum("tij,tij->t", a_np.astype(np.int64),
                      l_np.astype(np.int64) @ u_np.astype(np.int64))
    np.testing.assert_array_equal(got.numpy().astype(np.int64), exact)


def test_k4_inputs_are_checked():
    l, u, a = (torch.from_numpy(x) for x in _tiles(3, 8, seed=0))
    assert masked_spgemm_kernel(l[:0], u[:0], a[:0]).shape == (0,)
    with pytest.raises(ValueError, match="float32"):
        masked_spgemm_kernel(l.double(), u.double(), a.double())
    with pytest.raises(ValueError, match="of one shape"):
        masked_spgemm_kernel(l, u[:2], a)
    with pytest.raises(ValueError, match="of one shape"):
        masked_spgemm_kernel(l[:, :4], u[:, :4], a[:, :4])
    with pytest.raises(ValueError, match="contiguous"):
        masked_spgemm_kernel(l.transpose(1, 2), u, a)
    with pytest.raises(ValueError, match="unknown backend"):
        masked_spgemm_counts(l, u, a, backend="pallas")
    # CPU tensors never launch either route
    assert LAUNCHES == {"masked_spgemm": 0, "masked_spgemm_wgmma": 0}


@pytest.mark.parametrize("backend", ["kernel", "ref"])
@pytest.mark.parametrize("block", [8, 16, "auto"])
@pytest.mark.parametrize("name", list(GRAPHS))
def test_matrix_counts_match_reference_and_scipy(ref, name, block, backend):
    g = GRAPHS[name]()
    tc = TriangleCounter(g, device=CPU, algorithm="matrix", block=block,
                         backend=backend)
    got = tc.count()
    want = ref.api.TriangleCounter(
        _ref_graph(ref, g),
        ref.options.CountOptions(algorithm="matrix", block=block)).count()
    assert got.count == want.count == triangle_count_scipy(g)
    assert got.algorithm == "matrix" and got.bucket_strategies is None
    for k in ("num_triples", "a_tiles", "l_tiles", "u_tiles", "grid", "block",
              "tile_flops", "permute"):
        assert got.meta[k] == want.meta[k], k
    t = got.meta["num_triples"]
    assert tc.plan.shape_keys == ([(t, got.meta["block"], got.meta["block"])]
                                  if t else [])


def test_auto_picks_matrix_on_small_dense_graph(ref):
    g = port_gen.complete_graph(64)
    assert ref.registry.choose_algorithm(_ref_graph(ref, g)) == "matrix"
    res = TriangleCounter(g, device=CPU).count()
    assert res.algorithm == "matrix" and res.count == math.comb(64, 3)


def test_matrix_vertex_counts_go_through_the_sidecar(ref):
    g = GRAPHS["tiny-rmat"]()
    tc = TriangleCounter(g, device=CPU, algorithm="matrix")
    with pytest.raises(NotImplementedError, match="algorithm='matrix'"):
        tc.plan.triangles_per_vertex()
    t = tc.triangles_per_vertex()
    want = ref.api.TriangleCounter(
        _ref_graph(ref, g), ref.options.CountOptions(algorithm="matrix"))
    np.testing.assert_array_equal(t, want.triangles_per_vertex())
    assert int(t.sum()) == 3 * triangle_count_scipy(g)


def test_matrix_sum_is_exact_past_2_24():
    # eight all-ones 128-tiles give 128³ = 2²¹ each; three more give 1 each:
    # 2²⁴ + 3, which a float32 running sum rounds away
    b = 128
    ones = torch.ones(8, b, b)
    unit = torch.zeros(3, b, b)
    unit[:, 0, 0] = 1.0
    l = torch.cat([ones, unit])
    partials = masked_spgemm_kernel(l, l.clone(), l.clone())
    total32 = torch.zeros((), dtype=torch.float32)
    for p in partials:
        total32 += p
    assert int(total32) != 2 ** 24 + 3
    # the matrix lane's launch on the gathered form: two unique bf16 tiles
    # (all ones, a single 1) read through the triple indices
    blocks = torch.stack([ones[0], unit[0]]).bfloat16()
    idx = torch.tensor([0] * 8 + [1] * 3, dtype=torch.int32)
    fn = get_executable("matrix", "kernel", tuple(l.shape))
    total = fn(blocks, blocks, blocks, idx, idx, idx)
    assert total.dtype == torch.int64 and int(total) == 2 ** 24 + 3
    # and end to end: C(512, 3) = 22,238,720 > 2²⁴ through auto → matrix
    g = port_gen.complete_graph(512)
    res = TriangleCounter(g, device=CPU).count()
    assert res.algorithm == "matrix" and res.meta["num_triples"] == 20
    assert res.count == math.comb(512, 3) == 22_238_720


def test_matrix_lane_on_graphs_without_triples():
    for g in (edges_to_csr([], [], n=5), edges_to_csr([], [], n=0),
              port_gen.path_graph(10), port_gen.star_graph(9)):
        plan = plan_triangle_count(g, "matrix", device=CPU)
        assert plan.count() == 0 == triangle_count_scipy(g)
        assert plan.num_stages == (1 if plan.meta["num_triples"] else 0)
