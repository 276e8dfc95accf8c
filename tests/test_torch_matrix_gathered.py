"""K4's gathered form against the reference, bit for bit.

The matrix lane holds the schedule's unique tiles and the (T,) int32
triple indices on the card, not the (T, B, B) stacks. Held here, on the
CPU: ``masked_spgemm_gathered``'s plain version against the reference's
one-shot einsum, its chunked path and the Pallas kernel in interpret mode
on the same stacks gathered in numpy (tolerance 0: 0/1 tiles give exact
integer partials, in bf16 as in float32); ``TileSchedule.to_device`` against
the reference's stacks; the gathered wrapper's input checks; the launch
order; and ``WGMMA_BLOCKS`` against the tile edges the CUDA source builds.
"""

import re
from pathlib import Path

import numpy as np
import pytest
import torch

from torch_reference import ref  # noqa: F401

from repro_torch.core import plan_triangle_count
from repro_torch.core import prep as port_prep
from repro_torch.core.engine import get_executable
from repro_torch.graphs import generators as port_gen
from repro_torch.graphs.datasets import load_dataset
from repro_torch.kernels.masked_spgemm import (
    LAUNCHES,
    WGMMA_BLOCKS,
    launch_order,
    masked_spgemm_gathered,
    masked_spgemm_gathered_chunked,
    masked_spgemm_gathered_counts,
    masked_spgemm_ref,
)

CPU = "cpu"
SOURCE = (Path(__file__).resolve().parents[1] / "src" / "repro_torch" / "csrc"
          / "masked_spgemm.cu")

GRAPHS = {
    "tiny-rmat": lambda: load_dataset("tiny-rmat"),
    "tiny-grid": lambda: load_dataset("tiny-grid"),
    "rmat9": lambda: port_gen.rmat_graph(9, 8),
    "clique40": lambda: port_gen.complete_graph(40),
}


def _ref_graph(ref, g):
    return ref.formats.Graph(n=g.n, row_ptr=g.row_ptr, col_idx=g.col_idx,
                             name=g.name)


def _case(t, b, seed):
    """Small pools of random 0/1 float32 (n, B, B) tiles (density 0.02–0.5,
    the last L tile and the last U tile all ones) and (T,) int32 indices
    into them with repeats; U doubles as the A pool, as on the main path."""
    rng = np.random.default_rng(seed)

    def pool(n):
        dens = rng.uniform(0.02, 0.5, size=(n, 1, 1))
        tiles = (rng.random((n, b, b)) < dens).astype(np.float32)
        tiles[-1] = 1.0
        return tiles

    l_blocks, u_blocks = pool(3), pool(4)
    li = rng.integers(0, 3, size=t).astype(np.int32)
    ui = rng.integers(0, 4, size=t).astype(np.int32)
    ai = rng.integers(0, 4, size=t).astype(np.int32)
    if t:
        li[0], ui[0], ai[0] = 2, 3, 3  # all-ones: B³
    return l_blocks, u_blocks, li, ui, ai


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("b", [8, 16, 48, 128])
@pytest.mark.parametrize("t", [0, 1, 5, 9])
def test_gathered_plain_matches_reference_exactly(ref, t, b, dtype):
    l_np, u_np, li, ui, ai = _case(t, b, seed=t * 1000 + b)
    stacks = (l_np[li], u_np[ui], u_np[ai])  # gathered in numpy
    l_blocks = torch.from_numpy(l_np).to(dtype)
    u_blocks = torch.from_numpy(u_np).to(dtype)
    idx = [torch.from_numpy(x) for x in (li, ui, ai)]
    got = masked_spgemm_gathered(l_blocks, u_blocks, u_blocks, *idx)
    assert got.dtype == torch.float32 and got.shape == (t,)
    want = [ref.msref.masked_spgemm_ref(*stacks),
            ref.msops._masked_spgemm_chunked(*stacks)]
    if t:  # the Pallas kernel's grid needs a step
        want.append(ref.mskernel.masked_spgemm_pallas(*stacks, tile_triples=1,
                                                      interpret=True))
    for w in want:  # tolerance 0
        np.testing.assert_array_equal(got.numpy(), np.asarray(w))
    order = launch_order(idx[0], idx[2])
    for other in (
            masked_spgemm_gathered_chunked(l_blocks, u_blocks, u_blocks, *idx),
            masked_spgemm_gathered(l_blocks, u_blocks, u_blocks, *idx,
                                   order=order),
            masked_spgemm_gathered_counts(l_blocks, u_blocks, u_blocks, *idx,
                                          backend="ref"),
            masked_spgemm_ref(*(torch.from_numpy(x) for x in stacks))):
        assert torch.equal(other, got)
    exact = np.einsum("tij,tij->t", stacks[2].astype(np.int64),
                      stacks[0].astype(np.int64) @ stacks[1].astype(np.int64))
    np.testing.assert_array_equal(got.numpy().astype(np.int64), exact)
    if t:
        assert int(got[0]) == b ** 3  # the all-ones triple
    assert LAUNCHES == {"masked_spgemm": 0, "masked_spgemm_wgmma": 0}


@pytest.mark.parametrize("block", ["auto", 16])
@pytest.mark.parametrize("permute", [True, False])
@pytest.mark.parametrize("name", list(GRAPHS))
def test_to_device_gathers_the_reference_stacks(ref, name, permute, block):
    g = GRAPHS[name]()
    b = port_prep.choose_block(g) if block == "auto" else block
    sched = port_prep.tile_schedule(g, block=b, permute=permute)
    l_blocks, u_blocks, li, ui, ai = sched.to_device(CPU)
    want_dtype = torch.bfloat16 if b in WGMMA_BLOCKS else torch.float32
    assert l_blocks.dtype == u_blocks.dtype == want_dtype
    assert l_blocks.shape == (len(sched.l_blocks), b, b)
    assert u_blocks.shape == (len(sched.u_blocks), b, b)
    for idx, n in ((li, len(l_blocks)), (ui, len(u_blocks)),
                   (ai, len(u_blocks))):
        assert idx.dtype == torch.int32 and idx.shape == (sched.num_triples,)
        assert sched.num_triples == 0 or 0 <= int(idx.min()) <= int(idx.max()) < n
    got = (l_blocks[li.long()].float(), u_blocks[ui.long()].float(),
           u_blocks[ai.long()].float())
    want = ref.prep.build_tile_schedule(_ref_graph(ref, g), block=b,
                                        permute=permute)
    port = port_prep.build_tile_schedule(g, block=b, permute=permute)
    for a, w, p in zip(got, want[:3], port[:3]):
        np.testing.assert_array_equal(a.numpy(), np.asarray(w))
        np.testing.assert_array_equal(a.numpy(), p)


def test_to_device_checks_indices_once():
    sched = port_prep.tile_schedule(GRAPHS["rmat9"](), block=32)
    sched.a_index = sched.a_index.copy()
    sched.a_index[-1] = len(sched.u_blocks)
    with pytest.raises(ValueError, match=r"a_index outside \[0, "):
        sched.to_device(CPU)
    sched.a_index[-1] = -1
    with pytest.raises(ValueError, match="a_index outside"):
        sched.to_device(CPU)


def test_gathered_inputs_are_checked():
    l_np, u_np, li, ui, ai = _case(5, 8, seed=3)
    l, u = torch.from_numpy(l_np), torch.from_numpy(u_np)
    i, j, k = (torch.from_numpy(x) for x in (li, ui, ai))
    assert masked_spgemm_gathered(l, u, u, i[:0], j[:0], k[:0]).shape == (0,)
    with pytest.raises(ValueError, match="all float32 or all bfloat16"):
        masked_spgemm_gathered(l.double(), u.double(), u.double(), i, j, k)
    with pytest.raises(ValueError, match="all float32 or all bfloat16"):
        masked_spgemm_gathered(l, u.bfloat16(), u, i, j, k)
    with pytest.raises(ValueError, match="of one B"):
        masked_spgemm_gathered(l[:, :4, :4], u, u, i, j, k)
    with pytest.raises(ValueError, match="of one B"):
        masked_spgemm_gathered(l[0], u, u, i, j, k)
    with pytest.raises(ValueError, match="int32 vectors of one T"):
        masked_spgemm_gathered(l, u, u, i.long(), j, k)
    with pytest.raises(ValueError, match="int32 vectors of one T"):
        masked_spgemm_gathered(l, u, u, i, j[:3], k)
    with pytest.raises(ValueError, match="int32 vectors of one T"):
        masked_spgemm_gathered(l, u, u, i, j, k, order=i[:2])
    with pytest.raises(ValueError, match="contiguous"):
        masked_spgemm_gathered(l.transpose(1, 2), u, u, i, j, k)
    with pytest.raises(ValueError, match="contiguous"):
        masked_spgemm_gathered(l, u, u, torch.stack([i, i], 1)[:, 0], j, k)
    with pytest.raises(ValueError, match="must be torch tensors"):
        masked_spgemm_gathered(l_np, u, u, i, j, k)
    with pytest.raises(ValueError, match="different devices"):
        masked_spgemm_gathered(l, u, u.to("meta"), i, j, k)
    with pytest.raises(ValueError, match="unknown backend"):
        masked_spgemm_gathered_counts(l, u, u, i, j, k, backend="pallas")
    assert LAUNCHES == {"masked_spgemm": 0, "masked_spgemm_wgmma": 0}


def test_launch_order_sorts_by_a_then_l_stably():
    rng = np.random.default_rng(5)
    li = torch.from_numpy(rng.integers(0, 6, size=500).astype(np.int32))
    ai = torch.from_numpy(rng.integers(0, 9, size=500).astype(np.int32))
    order = launch_order(li, ai)
    assert order.dtype == torch.int32 and order.shape == (500,)
    assert torch.equal(torch.sort(order).values, torch.arange(500, dtype=torch.int32))
    want = sorted(range(500), key=lambda t: (int(ai[t]), int(li[t])))  # stable
    assert order.tolist() == want
    assert launch_order(li[:0], ai[:0]).shape == (0,)


def test_wgmma_blocks_match_the_source():
    src = SOURCE.read_text()
    entry = src[src.index('extern "C" int tc_masked_spgemm_wgmma'):]
    cases = tuple(int(x) for x in re.findall(r"case (\d+):", entry))
    instances = tuple(int(x) for x in re.findall(r"launch_wgmma<(\d+)>", entry))
    assert cases == instances == WGMMA_BLOCKS


@pytest.mark.parametrize("name", ["clique40", "tiny-grid"])
def test_matrix_plan_holds_the_gathered_form(name):
    g = GRAPHS[name]()
    plan = plan_triangle_count(g, "matrix", device=CPU)
    (stage,) = plan.stages
    l_blocks, u_blocks, a_blocks, li, ui, ai, order = stage.args
    b = plan.meta["block"]
    t = plan.meta["num_triples"]
    assert a_blocks is u_blocks and stage.shape_key == (t, b, b)
    assert l_blocks.dtype == (torch.bfloat16 if b in WGMMA_BLOCKS
                              else torch.float32)
    assert torch.equal(order, launch_order(li, ai))
    assert plan.meta["tile_bytes"] == sum(
        x.numel() * x.element_size()
        for x in (l_blocks, u_blocks, li, ui, ai, order))
    assert plan.meta["tile_bytes"] < 3 * t * b * b * 4 or t < 4  # under the stacks
    fn = get_executable("matrix", "kernel", stage.shape_key)
    assert int(fn(*stage.args)) == int(fn(*stage.args[:6])) == plan.count()
