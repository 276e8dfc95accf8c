"""The port's CUDA kernels against their plain torch versions, on the card,
the five lanes on the card against scipy, the LM's prefill (dense, moe,
vlm with its prefix, the int8 cache) through the flash kernel against its
plain attention path, the encdec, ssm and hybrid models on the card
against the CPU, K6's autograd Function (its gradients against the chunked
path's in each mask mode, the bare kernel refusing inputs that require
grad) and one microbatched backward of each family, the
triangle service and the measured chooser on the card, the sharded
lanes on a world-1 NCCL group and on 4 gloo ranks sharing the card, and
sharded training: each model rank's local-head K6 call against the
unsharded call's heads, and one step on a (1, 1) mesh of a world-1 NCCL
group against the one-card step.

Marked ``cuda``: each test decides at run time whether a CUDA device is
present and skips with a reason if not, so this file collects the same
tests everywhere. Run on a machine with an H100 (or any sm_90a card):

    PYTHONPATH=src python -m pytest -m cuda tests/test_torch_cuda.py
"""

import json
import math

import numpy as np
import pytest
import torch

import hash_rows
import intersect_rows
import probe_csr_rows
import probe_rows

from repro_torch.core import (TriangleCounter, subgraph_match_triangle,
                              triangle_count_scipy)
from repro_torch.graphs import complete_graph, load_dataset, rmat_graph
from repro_torch.kernels.intersect import (
    LAUNCHES,
    intersect_counts_bitmap,
    intersect_counts_bitmap_kernel,
    intersect_counts_broadcast,
    intersect_counts_kernel,
    intersect_counts_probe,
    intersect_counts_probe_csr,
    intersect_counts_probe_csr_kernel,
    intersect_counts_probe_kernel,
    intersect_counts_ref,
    reset_launch_counts,
)
from repro_torch.kernels import flash_attention as fa
from repro_torch.kernels import hash_tc as ht
from repro_torch.kernels import masked_spgemm as ms

pytestmark = pytest.mark.cuda

SHAPES = [(1, 8), (255, 8), (257, 32), (1000, 100), (4097, 128), (333, 512),
          (129, 1000), (77, 1024), (64, 1500), (9, 8200)]


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    return torch.device("cuda")


def lists(e: int, w: int, seed: int):
    """Sorted unique ids below n = 3·w + 50 with sentinels n / n + 1 and a
    few whole padding rows (-1 / -2)."""
    rng = np.random.default_rng(seed)
    n = 3 * w + 50

    def side(fill):
        rows = np.sort(rng.random((e, n)).argsort(axis=1)[:, :w], axis=1)
        rows = rows.astype(np.int32)
        deg = rng.integers(0, w + 1, size=e)
        rows[np.arange(w)[None, :] >= deg[:, None]] = fill
        return rows

    u, v = side(n), side(n + 1)
    pad = e // 10
    if pad:
        u[-pad:], v[-pad:] = -1, -2
    return u, v


@pytest.mark.parametrize("e,w", SHAPES)
def test_kernels_equal_plain_versions(cuda, e, w):
    u_np, v_np = lists(e, w, seed=e + w)
    u, v = torch.from_numpy(u_np).to(cuda), torch.from_numpy(v_np).to(cuda)
    pairs = [
        (intersect_counts_kernel(u, v), intersect_counts_broadcast(u, v)),
        (intersect_counts_probe_kernel(u, v), intersect_counts_probe(u, v)),
    ]
    for bits in (32, (3 * w + 52 + 31) // 32 * 32, 65536):  # low, id range, cap
        pairs.append((intersect_counts_bitmap_kernel(u, v, num_bits=bits),
                      intersect_counts_bitmap(u, v, num_bits=bits)))
    torch.cuda.synchronize()
    for k, p in pairs:
        assert k.dtype == torch.int32 and k.device.type == "cuda"
        assert torch.equal(k, p)
    assert torch.equal(pairs[0][0], intersect_counts_ref(u.cpu(), v.cpu()).to(cuda))


def test_launch_counters_and_input_checks(cuda):
    u, v = (torch.from_numpy(a).to(cuda) for a in lists(100, 16, seed=1))
    reset_launch_counts()
    intersect_counts_kernel(u, v)
    intersect_counts_probe_kernel(u, v)
    intersect_counts_bitmap_kernel(u, v, num_bits=128)
    intersect_counts_kernel(u[:0], v[:0])  # empty: no launch
    row_ptr, col = (x.to(cuda) for x in probe_csr_rows.edge_csr(
        {0: [1, 2], 1: [2]}, 3))
    ends = torch.tensor([0, 1], dtype=torch.int32, device=cuda)
    assert intersect_counts_probe_csr_kernel(row_ptr, col, ends, ends.flip(0),
                                             4).tolist() == [1, 1]
    intersect_counts_probe_csr_kernel(row_ptr, col, ends[:0], ends[:0], 4)
    assert LAUNCHES == {"broadcast": 1, "probe": 1, "bitmap": 1,
                        "probe_csr": 1}
    with pytest.raises(ValueError, match="int32"):
        intersect_counts_kernel(u.long(), v.long())
    with pytest.raises(ValueError, match="but v_lists on"):
        intersect_counts_probe_kernel(u, v.cpu())


@pytest.mark.parametrize("case", probe_rows.CARD_CASES,
                         ids=["{}-{}x{}".format(*c) for c in probe_rows.CARD_CASES])
def test_probe_kernel_on_row_families(cuda, case):
    """K2 equals its plain version exactly (tolerance 0) on every family of
    ``probe_rows``, one launch a call, both on the rows as allocated and on
    a view that starts mid-allocation (the 4-byte copy route)."""
    name, e, w = case
    u_np, v_np = probe_rows.tiled(name, e, w, seed=e + w)
    u, v = torch.from_numpy(u_np).to(cuda), torch.from_numpy(v_np).to(cuda)
    want = intersect_counts_probe(u, v)
    reset_launch_counts()
    got = intersect_counts_probe_kernel(u, v)
    torch.cuda.synchronize()
    assert LAUNCHES["probe"] == 1
    assert got.dtype == torch.int32 and torch.equal(got, want)
    uo, vo = probe_rows.offset_view(u), probe_rows.offset_view(v)
    assert uo.data_ptr() % 16 and uo.is_contiguous()
    assert torch.equal(intersect_counts_probe_kernel(uo, vo), want)
    assert LAUNCHES["probe"] == 2
    if e * w <= 1 << 16:
        assert torch.equal(want.cpu(), intersect_counts_probe(u.cpu(), v.cpu()))


def test_probe_kernel_empty_launches_nothing(cuda):
    u, v = (torch.from_numpy(a).to(cuda) for a in probe_rows.family("random", 40, 512))
    reset_launch_counts()
    out = intersect_counts_probe_kernel(u[:0], v[:0])
    assert out.shape == (0,) and LAUNCHES["probe"] == 0


@pytest.mark.parametrize("width", [1, 5, 33, 128, 512, 1024, 8192, 10000])
def test_probe_csr_kernel_on_rows_to_the_edge(cuda, width):
    """K2's CSR form equals ``np.intersect1d`` on the rows of
    ``probe_csr_rows.row_cases`` (empty rows, disjoint and touching
    ranges, rows past the width; at 10000 ids N⁺(src) is longer than a
    warp's table and is built and probed in pieces of 2048), with the
    pairs repeated past one sweep of
    the persistent grid, and on the CSR copied to start 1, 2 and 3 ints
    past a 16-byte boundary."""
    rows, n, pairs = probe_csr_rows.row_cases(width, seed=width)
    want = probe_csr_rows.numpy_counts(rows, pairs, width)
    assert list(want[:7]) == probe_csr_rows.FIXED_COUNTS
    row_ptr, col = (x.to(cuda) for x in probe_csr_rows.edge_csr(rows, n))
    reps = max(1, 400_000 // len(pairs)) if width <= 1024 else 4
    src = torch.tensor([a for a, _ in pairs] * reps, dtype=torch.int32,
                       device=cuda)
    dst = torch.tensor([b for _, b in pairs] * reps, dtype=torch.int32,
                       device=cuda)
    want_all = torch.from_numpy(np.tile(want, reps)).to(cuda)
    reset_launch_counts()
    for k in (0, 1, 2, 3):
        c = probe_csr_rows.offset_copy(col, k) if k else col
        got = intersect_counts_probe_csr_kernel(row_ptr, c, src, dst, width)
        torch.cuda.synchronize()
        assert got.dtype == torch.int32 and torch.equal(got, want_all), k
    assert LAUNCHES["probe_csr"] == 4 and LAUNCHES["probe"] == 0


@pytest.mark.parametrize("scale", [16, 17])
def test_probe_csr_kernel_on_rmat_probe_buckets(cuda, scale):
    """On an R-MAT's probe buckets K2's CSR form equals its plain version
    and the padded K2, row by row, on the CSR as allocated and copied to
    start off a 16-byte boundary; the bucket's padding rows are never
    handed to it."""
    from repro_torch.core import prep
    from repro_torch.graphs.device import DeviceGraph

    g = rmat_graph(scale, 16, seed=1)
    dg = DeviceGraph.from_graph(g, device=cuda)
    buckets = prep.prepare_intersection_buckets_device(dg)
    fwd = dg.forward()
    probes = [b for b in buckets if b.width >= 64]
    assert {128, 512} <= {b.width for b in probes}
    for b in probes:
        e = b.edges
        src, dst = b.src[:e], b.dst[:e]
        padded = intersect_counts_probe_kernel(b.u_lists, b.v_lists)
        plain = intersect_counts_probe_csr(fwd.row_ptr.cpu(), fwd.dst.cpu(),
                                           src.cpu(), dst.cpu(), b.width)
        for k in (0, 1, 3):
            col = probe_csr_rows.offset_copy(fwd.dst, k) if k else fwd.dst
            got = intersect_counts_probe_csr_kernel(fwd.row_ptr, col, src,
                                                    dst, b.width)
            torch.cuda.synchronize()
            assert torch.equal(got.cpu(), plain), (b.shape, k)
        assert torch.equal(padded[:e].cpu(), plain), b.shape
        assert not padded[e:].any()


def test_count_takes_the_csr_route_and_tiled_the_padded(cuda):
    """Across one ``count()`` of a resident session each probe bucket runs
    K2's CSR form once and the padded K2 never; a plan whose probe buckets
    are all tiled runs the padded K2 on each chunk and the CSR form never."""
    from repro_torch.core.engine import CsrProbeLaunch, _TiledStage

    g = rmat_graph(16, 16, seed=1)
    tc = TriangleCounter(g)
    want = tc.count().count
    probes = sum(isinstance(st.executable, CsrProbeLaunch)
                 for st in tc.plan.stages)
    assert probes >= 2
    reset_launch_counts()
    assert tc.count().count == want == triangle_count_scipy(g)
    assert LAUNCHES["probe_csr"] == probes and LAUNCHES["probe"] == 0
    tiled = TriangleCounter(g, max_device_bytes=1 << 22)
    chunks = sum(st.num_chunks for st in tiled.plan.stages
                 if isinstance(st, _TiledStage) and st.strategy == "probe")
    assert chunks and not any(isinstance(st.executable, CsrProbeLaunch)
                              for st in tiled.plan.stages)
    reset_launch_counts()
    assert tiled.count().count == want
    assert LAUNCHES["probe"] == chunks and LAUNCHES["probe_csr"] == 0
    np.testing.assert_array_equal(tc.triangles_per_vertex(),
                                  tiled.triangles_per_vertex())


def _on_card(cuda, make, case):
    name, e, w = case
    u_np, v_np, bits = intersect_rows.tiled(make, name, e, w, seed=e + w)
    return (torch.from_numpy(u_np).to(cuda), torch.from_numpy(v_np).to(cuda),
            bits)


@pytest.mark.parametrize("case", intersect_rows.CARD_CASES,
                         ids=["{}-{}x{}".format(*c) for c in intersect_rows.CARD_CASES])
def test_broadcast_kernel_on_row_families(cuda, case):
    """K1 equals its plain version exactly (tolerance 0) on every family of
    ``intersect_rows`` (unsorted rows, duplicates, any int32 id, W from 1 to
    63, E past one sweep of the persistent grid), one launch a call, on the
    rows as allocated (the 16-byte route where W % 4 == 0) and on a view
    that starts mid-allocation (the 4-byte route)."""
    u, v, _ = _on_card(cuda, intersect_rows.family, case)
    want = intersect_counts_broadcast(u, v)
    reset_launch_counts()
    got = intersect_counts_kernel(u, v)
    torch.cuda.synchronize()
    assert LAUNCHES["broadcast"] == 1
    assert got.dtype == torch.int32 and torch.equal(got, want)
    uo, vo = probe_rows.offset_view(u), probe_rows.offset_view(v)
    assert uo.data_ptr() % 16 and uo.is_contiguous()
    assert torch.equal(intersect_counts_kernel(uo, vo), want)
    assert LAUNCHES["broadcast"] == 2


@pytest.mark.parametrize("case", intersect_rows.CARD_CASES
                         + intersect_rows.BITMAP_WIDE_CASES,
                         ids=["{}-{}x{}".format(*c) for c in intersect_rows.CARD_CASES
                              + intersect_rows.BITMAP_WIDE_CASES])
def test_bitmap_kernel_on_row_families(cuda, case):
    """K3 equals its plain version exactly on the same families (v's equal
    ids adjacent, as the plain packer needs) and on its wide rows, at the
    family's capacity (a wide row's clear zeroes the whole bitmap) and at
    the 65536-bit cap (8 KB a warp; rows of 257 to 511 ids walk v again to
    clear), aligned and mid-allocation."""
    u, v, bits = _on_card(cuda, intersect_rows.bitmap_family, case)
    uo, vo = probe_rows.offset_view(u), probe_rows.offset_view(v)
    for nb in (bits, 1 << 16):
        want = intersect_counts_bitmap(u, v, num_bits=nb)
        reset_launch_counts()
        for a, b in ((u, v), (uo, vo)):
            got = intersect_counts_bitmap_kernel(a, b, num_bits=nb)
            torch.cuda.synchronize()
            assert got.dtype == torch.int32 and torch.equal(got, want), nb
        assert LAUNCHES["bitmap"] == 2


@pytest.mark.parametrize("query", [(0, 0, 0), (0, 1, 2), (1, 1, 0), (2, 0, 1)])
def test_labeled_queries_on_card_match_cpu(cuda, query):
    """``subgraph_match_triangle`` on the card: the R-MAT's width-128 and
    width-512 buckets are wider than the bitmap (n + 2 > W), so they go to
    K2 with u rows whose ids without the third label were dropped in place.
    The card equals the CPU's plain path and the ``ref`` oracle."""
    g = rmat_graph(10, 8, seed=3)
    labels = (np.zeros(g.n, np.int64) if query == (0, 0, 0)
              else np.random.default_rng(7).integers(0, 3, size=g.n))
    reset_launch_counts()
    got = subgraph_match_triangle(g, labels, query, device=cuda)
    assert LAUNCHES["probe"] > 0
    cpu = torch.device("cpu")
    assert got > 0
    assert got == subgraph_match_triangle(g, labels, query, device=cpu)
    assert got == subgraph_match_triangle(g, labels, query, backend="ref",
                                          device=cpu)
    if query == (0, 0, 0):
        assert got == 6 * triangle_count_scipy(g)


@pytest.mark.parametrize("strategy", ["auto", "broadcast", "probe", "bitmap"])
def test_counter_on_card_matches_scipy(cuda, strategy):
    for g in (load_dataset("tiny-rmat"), rmat_graph(10, 8, seed=3)):
        reset_launch_counts()
        tc = TriangleCounter(g, algorithm="intersection", strategy=strategy)
        assert tc.count() == triangle_count_scipy(g)
        assert sum(LAUNCHES.values()) == tc.plan.num_stages
        np.testing.assert_array_equal(
            tc.triangles_per_vertex(),
            TriangleCounter(g, algorithm="intersection", device="cpu")
            .triangles_per_vertex())


def test_spans_on_the_card(cuda):
    """Under a CUDA profiler each stage's span holds its one ``tc.launch``,
    the profiler sees the kernels, and the spans add no launch counter."""
    from torch.profiler import ProfilerActivity, profile

    g = rmat_graph(12, 8, seed=2)
    tc = TriangleCounter(g, algorithm="intersection")
    want = tc.count().count
    before = dict(LAUNCHES)
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        got = tc.count().count
    events = list(prof.profiler.kineto_results.events())
    cpu = torch.autograd.DeviceType.CPU
    spans = [(e.start_ns(), e.start_ns() + e.duration_ns(), e.name())
             for e in events if e.device_type() == cpu
             and e.is_user_annotation() and e.name().startswith("tc.")]
    launches = [x for x in spans if x[2] == "tc.launch"]
    stages = [x for x in spans if x[2].startswith("tc.stage")]
    assert got == want == triangle_count_scipy(g)
    assert set(LAUNCHES) == set(before)
    assert sum(LAUNCHES[k] - before[k] for k in LAUNCHES) == len(launches) \
        == len(stages) == tc.plan.num_stages
    assert all(sum(s[0] <= x[0] and x[1] <= s[1] for x in launches) == 1
               for s in stages)
    assert [x[2] for x in spans].count("tc.sync") == 1
    assert any(e.device_type() != cpu and not e.is_user_annotation()
               for e in events)


def tiles(t: int, b: int, seed: int):
    """Random 0/1 (T, B, B) float32 L, U, A stacks, density 0.02–0.5."""
    rng = np.random.default_rng(seed)
    return [(rng.random((t, b, b)) < rng.uniform(0.02, 0.5, size=(t, 1, 1)))
            .astype(np.float32) for _ in range(3)]


@pytest.mark.parametrize("b", [1, 8, 16, 33, 48, 100, 128, 129, 256])
@pytest.mark.parametrize("t", [1, 7, 300])
def test_masked_spgemm_kernel_equals_plain_version(cuda, t, b):
    l, u, a = (torch.from_numpy(x).to(cuda) for x in tiles(t, b, seed=t * 1000 + b))
    ms.reset_launch_counts()
    got = ms.masked_spgemm_kernel(l, u, a)
    want = ms.masked_spgemm_chunked(l, u, a)
    torch.cuda.synchronize()
    assert got.dtype == torch.float32 and got.device.type == "cuda"
    assert torch.equal(got, want)  # tolerance 0: exact integer partials
    assert torch.equal(got.cpu(), ms.masked_spgemm_ref(l.cpu(), u.cpu(), a.cpu()))
    # float32 stacks take the CUDA-core route
    assert ms.LAUNCHES == {"masked_spgemm": 1, "masked_spgemm_wgmma": 0}


def test_masked_spgemm_kernel_checks_inputs(cuda):
    l, u, a = (torch.from_numpy(x).to(cuda) for x in tiles(3, 8, seed=1))
    ms.reset_launch_counts()
    assert ms.masked_spgemm_kernel(l[:0], u[:0], a[:0]).shape == (0,)
    # T = 0 launches nothing
    assert ms.LAUNCHES == {"masked_spgemm": 0, "masked_spgemm_wgmma": 0}
    with pytest.raises(ValueError, match="float32"):
        ms.masked_spgemm_kernel(l.half(), u.half(), a.half())
    with pytest.raises(ValueError, match="different devices"):
        ms.masked_spgemm_kernel(l, u.cpu(), a)
    big = torch.zeros(1, 257, 257, device=cuda)
    with pytest.raises(ValueError, match="MAX_BLOCK"):
        ms.masked_spgemm_kernel(big, big, big)


def gathered_case(t: int, b: int, seed: int, dev):
    """bf16 pools of random 0/1 (n, B, B) tiles (density 0.02–0.5) with an
    all-ones tile and four single-corner tiles, and (T,) int32 indices into
    them with repeats: triple 0 is all ones (B³), triples 1-4 mask an
    all-ones product by one corner each (B apiece)."""
    rng = np.random.default_rng(seed)
    pool = (rng.random((9, b, b)) < rng.uniform(0.02, 0.5, size=(9, 1, 1)))
    pool = pool.astype(np.float32)
    pool[0] = 1.0
    for c, (i, j) in enumerate(((0, 0), (0, b - 1), (b - 1, 0), (b - 1, b - 1))):
        pool[1 + c] = 0.0
        pool[1 + c, i, j] = 1.0
    idx = [rng.integers(0, 9, size=t).astype(np.int32) for _ in range(3)]
    for k in range(min(t, 5)):  # (L, U, A) = (ones, ones, ones / corner k)
        idx[0][k], idx[1][k], idx[2][k] = 0, 0, k
    blocks = torch.from_numpy(pool).to(dev).bfloat16()
    return blocks, [torch.from_numpy(x).to(dev) for x in idx]


@pytest.mark.parametrize("b", ms.WGMMA_BLOCKS)
@pytest.mark.parametrize("t", [1, 7, 300])
def test_masked_spgemm_wgmma_equals_plain_version(cuda, t, b):
    blocks, idx = gathered_case(t, b, seed=t + b, dev=cuda)
    ms.reset_launch_counts()
    got = ms.masked_spgemm_gathered(blocks, blocks, blocks, *idx)
    ordered = ms.masked_spgemm_gathered(blocks, blocks, blocks, *idx,
                                        order=ms.launch_order(idx[0], idx[2]))
    want = ms.masked_spgemm_gathered_chunked(blocks, blocks, blocks, *idx)
    torch.cuda.synchronize()
    assert got.dtype == torch.float32 and got.device.type == "cuda"
    assert torch.equal(got, want) and torch.equal(ordered, want)  # tolerance 0
    assert int(got[0]) == b ** 3
    assert got[1:5].tolist() == [float(b)] * min(t - 1, 4)
    stacks = [blocks.index_select(0, i).float() for i in idx]
    library = (torch.bmm(blocks[idx[0].long()], blocks[idx[1].long()])
               * blocks[idx[2].long()]).sum((1, 2), dtype=torch.float32)
    assert torch.equal(got, ms.masked_spgemm_ref(*stacks))
    assert torch.equal(got, library)
    assert ms.LAUNCHES == {"masked_spgemm": 0, "masked_spgemm_wgmma": 2}


def test_masked_spgemm_wgmma_refuses_other_blocks(cuda):
    blocks, idx = gathered_case(5, 64, seed=1, dev=cuda)
    ms.reset_launch_counts()
    with pytest.raises(ValueError, match="WGMMA_BLOCKS"):
        ms.masked_spgemm_gathered(blocks, blocks, blocks, *idx)
    # the same tiles in float32 take the CUDA-core route
    got = ms.masked_spgemm_gathered(*[blocks.float()] * 3, *idx)
    assert torch.equal(got, ms.masked_spgemm_gathered_chunked(
        blocks, blocks, blocks, *idx))
    assert ms.LAUNCHES == {"masked_spgemm": 1, "masked_spgemm_wgmma": 0}


def test_matrix_lane_counts_through_the_wgmma_route(cuda):
    ms.reset_launch_counts()
    tc = TriangleCounter(complete_graph(512), algorithm="matrix")
    for _ in range(3):
        assert tc.count() == math.comb(512, 3)
    (stage,) = tc.plan.stages
    assert stage.args[0].dtype == torch.bfloat16
    assert ms.LAUNCHES == {"masked_spgemm": 0, "masked_spgemm_wgmma": 3}


@pytest.mark.parametrize("block", ["auto", 16, 32, 128, 200])
def test_matrix_lane_on_card_matches_scipy(cuda, block):
    for g in (load_dataset("tiny-rmat"), load_dataset("tiny-grid"),
              rmat_graph(10, 8, seed=3)):
        ms.reset_launch_counts()
        tc = TriangleCounter(g, algorithm="matrix", block=block)
        res = tc.count()
        assert res == triangle_count_scipy(g)
        # bf16 tiles at a B of the tensor-core route, float32 otherwise
        route = ("masked_spgemm_wgmma" if res.meta["block"] in ms.WGMMA_BLOCKS
                 else "masked_spgemm")
        assert ms.LAUNCHES[route] == sum(ms.LAUNCHES.values()) \
            == tc.plan.num_stages
        np.testing.assert_array_equal(  # through the filtered sidecar
            tc.triangles_per_vertex(),
            TriangleCounter(g, algorithm="intersection", device="cpu")
            .triangles_per_vertex())
    res = TriangleCounter(complete_graph(512)).count()  # past 2^24
    assert res.algorithm == "matrix" and res.count == math.comb(512, 3)


@pytest.mark.parametrize("prep_backend", ["device", "host"])
def test_subgraph_lane_on_card_matches_scipy(cuda, prep_backend):
    for g in (load_dataset("tiny-grid"), load_dataset("road-like"),
              rmat_graph(10, 8, seed=3)):
        reset_launch_counts()
        tc = TriangleCounter(g, algorithm="subgraph", prep_backend=prep_backend)
        res = tc.count()
        assert res.count == triangle_count_scipy(g)
        assert sum(LAUNCHES.values()) == tc.plan.num_stages
        cpu = TriangleCounter(g, algorithm="subgraph", device="cpu",
                              prep_backend=prep_backend)
        assert res.meta["vertices_pruned"] == cpu.count().meta["vertices_pruned"]
        np.testing.assert_array_equal(tc.triangles_per_vertex(),
                                      cpu.triangles_per_vertex())
    assert TriangleCounter(load_dataset("road-like")).algorithm == "subgraph"


def hash_case(e: int, w: int, seed: int):
    """Sorted unique (n, w) neighbour rows below n = max(2w, 64) (in-row
    padding n), (E,) anchors, and (E, W) candidates drawn from those rows
    (sentinel n + 1, a tenth of the rows whole padding -2)."""
    rng = np.random.default_rng(seed)
    n = max(2 * w, 64)
    nbrs = np.full((n, w), n, dtype=np.int32)
    keys = rng.random((n, n)).argsort(axis=1)[:, :w]
    for r, d in enumerate(rng.integers(0, w + 1, size=n)):
        nbrs[r, :d] = np.sort(keys[r, :d])
    src = rng.integers(0, n, size=e).astype(np.int32)
    cand = nbrs[rng.integers(0, n, size=e)].copy()
    cand[cand == n] = n + 1
    cand[e - e // 10:] = -2
    return nbrs, src, cand


@pytest.mark.parametrize("bd", [(8, 1), (8, 2), (32, 8), (512, 64)])
@pytest.mark.parametrize("w", [1, 8, 33, 512])
@pytest.mark.parametrize("e", [1, 7, 1000, 4097])
def test_hash_probe_kernel_equals_plain_version(cuda, e, w, bd):
    nbrs, src, cand = hash_case(e, w, seed=e * 1000 + w)
    table = ht.build_hash_table(torch.from_numpy(nbrs).to(cuda),
                                num_buckets=bd[0], depth=bd[1])
    w_t, s_t = torch.from_numpy(cand).to(cuda), torch.from_numpy(src).to(cuda)
    ht.reset_launch_counts()
    got = ht.hash_probe_kernel(w_t, s_t, table)
    want = ht.hash_probe_counts_chunked(w_t, s_t, table)
    torch.cuda.synchronize()
    assert got.dtype == torch.int32 and got.device.type == "cuda"
    assert torch.equal(got, want)  # tolerance 0: integer counts
    assert ht.LAUNCHES == {"hash_probe": 1}
    # the structure-blind oracle holds an (E, B·D, W) compare: small cases
    if bd[1] >= ht.hash_table_depth(torch.from_numpy(nbrs), bd[0]) \
            and e * w * bd[0] * bd[1] <= 1 << 24:
        assert torch.equal(got.cpu(), ht.hash_probe_counts_ref(
            w_t.cpu(), s_t.cpu(), table.cpu()))


def test_hash_probe_kernel_checks_inputs(cuda):
    nbrs, src, cand = hash_case(50, 8, seed=1)
    table = ht.build_hash_table(torch.from_numpy(nbrs).to(cuda),
                                num_buckets=8, depth=4)
    w_t, s_t = torch.from_numpy(cand).to(cuda), torch.from_numpy(src).to(cuda)
    ht.reset_launch_counts()
    assert ht.hash_probe_kernel(w_t[:0], s_t[:0], table).shape == (0,)
    assert ht.LAUNCHES == {"hash_probe": 0}  # E = 0 launches nothing
    with pytest.raises(ValueError, match="int32"):
        ht.hash_probe_kernel(w_t.long(), s_t, table)
    with pytest.raises(ValueError, match="one device"):
        ht.hash_probe_kernel(w_t, s_t.cpu(), table)
    with pytest.raises(ValueError, match="power of two"):
        ht.hash_probe_kernel(w_t, s_t, table[:, :6].contiguous())
    with pytest.raises(ValueError, match="contiguous"):
        ht.hash_probe_kernel(w_t[:, ::2], s_t, table)


@pytest.mark.parametrize("offset", [False, True], ids=["aligned", "offset"])
@pytest.mark.parametrize("family,e,w,b", hash_rows.CARD_CASES)
def test_hash_compact_kernel_on_families(cuda, family, e, w, b, offset):
    c = hash_rows.case(family, e, w, b, seed=e + w + b)
    w_t, s_t, r_t, compact = hash_rows.tensors(c, cuda, offset=offset)
    ht.reset_launch_counts()
    got = ht.hash_probe_compact_kernel(w_t, s_t, r_t, compact)
    want = ht.hash_probe_compact_chunked(w_t, s_t, r_t, compact)
    torch.cuda.synchronize()
    assert got.dtype == torch.int32 and got.device.type == "cuda"
    assert torch.equal(got, want)  # tolerance 0: integer counts
    assert ht.LAUNCHES == {"hash_probe": 1}
    on_cpu = ht.CompactHashTable(compact.chain_ptr.cpu(),
                                 compact.chain_vals.cpu(), compact.num_buckets)
    assert torch.equal(got.cpu(), ht.hash_probe_compact_chunked(
        w_t.cpu(), s_t.cpu(), r_t.cpu(), on_cpu))


@pytest.mark.parametrize("family", ["holes", "wide"])
@pytest.mark.parametrize("e,w", [(7, 8), (1000, 33), (3000, 512)])
def test_hash_dense_entry_on_dense_tables(cuda, family, e, w):
    c = hash_rows.case(family, e, w, 32, seed=e + w)
    w_t = hash_rows.offset_view(torch.from_numpy(c["cand"]).to(cuda)) \
        if e % 2 else torch.from_numpy(c["cand"]).to(cuda)
    s_t = torch.from_numpy(c["src"]).to(cuda)
    table = torch.from_numpy(c["dense"]).to(cuda)
    ht.reset_launch_counts()
    got = ht.hash_probe_kernel(w_t, s_t, table)
    want = ht.hash_probe_counts_chunked(w_t, s_t, table)
    torch.cuda.synchronize()
    assert torch.equal(got, want)
    assert ht.LAUNCHES == {"hash_probe": 1}


def test_hash_compact_kernel_checks_inputs(cuda):
    c = hash_rows.case("built", 50, 8, 8, seed=1)
    w_t, s_t, r_t, compact = hash_rows.tensors(c, cuda)
    ht.reset_launch_counts()
    assert ht.hash_probe_compact_kernel(w_t[:0], s_t[:0], r_t[:0],
                                        compact).shape == (0,)
    assert ht.LAUNCHES == {"hash_probe": 0}  # E = 0 launches nothing
    with pytest.raises(ValueError, match="one device"):
        ht.hash_probe_compact_kernel(w_t, s_t, r_t.cpu(), compact)
    with pytest.raises(ValueError, match="one device"):
        ht.hash_probe_compact_kernel(w_t, s_t, r_t, compact._replace(
            chain_vals=compact.chain_vals.cpu()))
    with pytest.raises(ValueError, match="int32"):
        ht.hash_probe_compact_kernel(w_t, s_t, r_t.long(), compact)
    assert ht.LAUNCHES == {"hash_probe": 0}


@pytest.mark.parametrize("algorithm", ["hash", "bfs"])
def test_hash_and_bfs_lanes_on_card_match_scipy(cuda, algorithm):
    for g in (load_dataset("tiny-rmat"), load_dataset("tiny-grid"),
              rmat_graph(10, 8, seed=3)):
        reset_launch_counts()
        ht.reset_launch_counts()
        tc = TriangleCounter(g, algorithm=algorithm)
        assert tc.count() == triangle_count_scipy(g)
        launches = ht.LAUNCHES["hash_probe"] if algorithm == "hash" \
            else sum(LAUNCHES.values())
        assert launches == tc.plan.num_stages
        cpu = TriangleCounter(g, algorithm=algorithm, device="cpu")
        assert cpu.count().meta["bucket_shapes"] == tc.plan.meta["bucket_shapes"]
        np.testing.assert_array_equal(tc.triangles_per_vertex(),
                                      cpu.triangles_per_vertex())


# K6: (b, s, t, hq, hkv, hd, dtype, causal, window, cap)
FLASH_CASES = [
    (1, 1, 1, 1, 1, 64, torch.float32, True, None, None),
    (2, 64, 64, 4, 2, 64, torch.float32, True, None, None),
    (1, 100, 100, 8, 4, 256, torch.bfloat16, True, 33, 50.0),
    (2, 300, 300, 8, 4, 256, torch.bfloat16, True, 64, 50.0),
    (1, 1000, 1000, 20, 20, 128, torch.float32, True, None, None),
    (1, 777, 777, 36, 36, 64, torch.float32, True, None, None),
    (1, 257, 129, 4, 1, 128, torch.float16, False, None, 30.0),
    (1, 40, 100, 8, 1, 64, torch.float32, True, 16, None),    # S < T
    (1, 200, 50, 4, 2, 64, torch.float32, True, 20, None),    # rows with no key
    (1, 200, 50, 4, 2, 64, torch.float32, False, 10, 50.0),
    (2, 96, 96, 16, 2, 128, torch.bfloat16, False, None, None),  # G = 8
    (1, 512, 512, 8, 4, 256, torch.bfloat16, True, 128, 50.0),
    # the tensor-core kernel at each head dim and 16-bit type: G = 5
    # (qwen1.5-32b's grouping), ragged S and T
    (1, 333, 301, 10, 2, 64, torch.bfloat16, True, None, None),
    (1, 333, 301, 10, 2, 64, torch.float16, True, 77, 50.0),
    (1, 201, 267, 5, 1, 128, torch.bfloat16, False, None, 30.0),
    (1, 201, 267, 5, 1, 128, torch.float16, True, 50, None),
    (2, 150, 97, 10, 2, 256, torch.bfloat16, True, 40, 50.0),
    (2, 150, 97, 10, 2, 256, torch.float16, False, 20, 50.0),  # rows with no key
    # the layer shapes of the served qwen1.5-32b (G = 1), dbrx-132b (G = 6)
    # and arctic-480b (G = 7) prefills
    (2, 512, 512, 40, 40, 128, torch.bfloat16, True, None, None),
    (2, 256, 256, 48, 8, 128, torch.bfloat16, True, None, None),
    (2, 256, 256, 56, 8, 128, torch.bfloat16, True, None, None),
    # whisper-medium's layers at batch 4, prompt 64 (head dim 64, 16/16):
    # the encoder (not causal, T = 1500), the decoder's causal self-
    # attention, its cross-attention (S = 64, T = 1500) and a decode
    # step's one-query cross-attention, bf16 and fp32
    *[(4, s_, t_, 16, 16, 64, dt_, c_, None, None)
      for dt_ in (torch.bfloat16, torch.float32)
      for s_, t_, c_ in ((1500, 1500, False), (64, 64, True),
                         (64, 1500, False), (1, 1500, False))],
    # recurrentgemma-9b's local attention: MQA 16/1 at head dim 256,
    # causal, window 2048 over a 4096-token prompt
    (2, 4096, 4096, 16, 1, 256, torch.bfloat16, True, 2048, None),
    # the key split (``flash_plan`` cuts each block's keys into parts where
    # few blocks walk a long range, merged by log-sum-exp): S·G <= 64 over
    # a long T (8 parts each), causal with parts past the diagonal and
    # empty ones (4 parts), a window (4 parts), rows with no valid key (2
    # parts), whisper-medium's decode step at batch 1 (6 parts), bf16 and
    # fp16
    (2, 40, 3000, 8, 8, 128, torch.bfloat16, False, None, None),
    (1, 3, 2000, 12, 4, 64, torch.float16, False, None, 50.0),
    (1, 1, 5000, 16, 16, 128, torch.float16, False, None, None),
    (1, 1024, 1024, 1, 1, 64, torch.bfloat16, True, None, None),
    (1, 1024, 1024, 2, 1, 128, torch.float16, True, 600, None),
    (1, 1000, 600, 2, 1, 64, torch.bfloat16, True, 50, None),
    (1, 1000, 600, 2, 1, 64, torch.float16, False, 40, 30.0),
    (1, 1, 1500, 16, 16, 64, torch.bfloat16, False, None, None),
]


@pytest.mark.parametrize("b,s,t,hq,hkv,hd,dtype,causal,window,cap",
                         FLASH_CASES)
def test_flash_kernel_equals_plain_version(cuda, b, s, t, hq, hkv, hd, dtype,
                                           causal, window, cap):
    gen = torch.Generator(device=cuda).manual_seed(s * 31 + t + hd)
    q = torch.randn(b, s, hq, hd, generator=gen, device=cuda).to(dtype)
    k = torch.randn(b, t, hkv, hd, generator=gen, device=cuda).to(dtype)
    v = torch.randn(b, t, hkv, hd, generator=gen, device=cuda).to(dtype)
    fa.reset_launch_counts()
    got = fa.flash_attention_kernel(q, k, v, causal=causal, window=window,
                                    cap=cap)
    want = fa.flash_attention_ref(q, k, v, causal=causal, window=window,
                                  cap=cap)
    torch.cuda.synchronize()
    assert fa.LAUNCHES == {"flash_attention": 1}
    assert got.dtype == dtype and got.shape == q.shape
    # fp32: 1e-4; 16-bit: one output rounding plus the slack of P rounded
    # to the input type before P·V (K6's numeric contract)
    ok, err = fa.flash_within_tolerance(got, want, q, k, v, causal=causal,
                                        window=window, cap=cap)
    assert ok, err
    if dtype != torch.float32:
        rows = fa.flash_row_rms(got, q, k, v, causal=causal, window=window,
                                cap=cap)
        assert float(rows.max()) <= fa.ROW_RMS_BOUND[dtype], float(rows.max())


# K6 with a bidirectional prefix: (b, s, hq, hkv, hd, dtype, window, cap,
# prefix), causal as the VLM's prefill
FLASH_PREFIX_CASES = [
    (2, 512, 8, 1, 256, torch.bfloat16, None, None, 256),  # paligemma layer
    (1, 333, 4, 2, 64, torch.float32, None, None, 100),    # ragged, P % 32
    (1, 200, 8, 1, 128, torch.float32, 16, 50.0, 47),      # window + prefix
    (1, 100, 4, 2, 64, torch.bfloat16, None, None, 100),   # P = S
    (1, 100, 4, 2, 64, torch.float32, 8, None, 300),       # P > S
    (1, 700, 8, 1, 256, torch.bfloat16, 64, 50.0, 130),    # two intervals
    (1, 257, 10, 2, 128, torch.float16, None, 30.0, 65),   # ragged, P % 64
]


@pytest.mark.parametrize("b,s,hq,hkv,hd,dtype,window,cap,prefix",
                         FLASH_PREFIX_CASES)
def test_flash_kernel_with_prefix_equals_plain_version(cuda, b, s, hq, hkv,
                                                       hd, dtype, window, cap,
                                                       prefix):
    gen = torch.Generator(device=cuda).manual_seed(s * 7 + prefix)
    q = torch.randn(b, s, hq, hd, generator=gen, device=cuda).to(dtype)
    k = torch.randn(b, s, hkv, hd, generator=gen, device=cuda).to(dtype)
    v = torch.randn(b, s, hkv, hd, generator=gen, device=cuda).to(dtype)
    kw = dict(causal=True, window=window, cap=cap, prefix_len=prefix)
    fa.reset_launch_counts()
    got = fa.flash_attention_kernel(q, k, v, **kw)
    want = fa.flash_attention_ref(q, k, v, **kw)
    torch.cuda.synchronize()
    assert fa.LAUNCHES == {"flash_attention": 1}
    ok, err = fa.flash_within_tolerance(got, want, q, k, v, **kw)
    assert ok, err
    if dtype != torch.float32:
        rows = fa.flash_row_rms(got, q, k, v, **kw)
        assert float(rows.max()) <= fa.ROW_RMS_BOUND[dtype], float(rows.max())
    # prefix_len = 0 is the kernel without a prefix, bit for bit
    kw0 = dict(causal=True, window=window, cap=cap)
    assert torch.equal(fa.flash_attention_kernel(q, k, v, prefix_len=0, **kw0),
                       fa.flash_attention_kernel(q, k, v, **kw0))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_quantize_kv_on_card_equals_cpu(cuda, dtype):
    """The int8 quantizer on the card gives the CPU's values and scales bit
    for bit (both divide; a division by a Python number on the card would
    multiply by its reciprocal)."""
    from repro_torch.models import layers as L

    gen = torch.Generator(device=cuda).manual_seed(7)
    x = (torch.randn(2, 300, 8, 128, generator=gen, device=cuda)
         * torch.rand(2, 300, 8, 1, generator=gen, device=cuda) * 9).to(dtype)
    x[0, :5] = 0  # the 1e-6 floor
    q, scale = L.quantize_kv(x)
    qh, sh = L.quantize_kv(x.cpu())
    assert torch.equal(q.cpu(), qh) and torch.equal(scale.cpu(), sh)
    back = L.dequantize_kv(q, scale, torch.float32)
    assert bool(((back - x.float()).abs() <= scale.float()[..., None]).all())


@pytest.mark.parametrize("arch", ["paligemma-3b", "arctic-480b", "dbrx-132b",
                                  "qwen1.5-32b"])
def test_new_families_prefill_through_flash_kernel(cuda, arch):
    """The vlm (prefix), moe and int8-cache models on the card: K6 once a
    layer, logits and caches as the chunked plain path's (fp32 weights,
    head_dim 64 for the kernel)."""
    from repro_torch.models.registry import get_reduced_config
    from repro_torch.models.transformer import TransformerLM

    cfg = get_reduced_config(arch).replace(d_model=128, head_dim=64)
    model = TransformerLM(cfg, device=cuda, dtype=torch.float32)
    model.init(torch.Generator(device=cuda).manual_seed(0))
    gen = torch.Generator(device=cuda).manual_seed(1)
    batch = {"tokens": torch.randint(0, cfg.vocab, (2, 40), device=cuda,
                                     generator=gen)}
    if cfg.family == "vlm":
        batch["patches"] = torch.randn(2, cfg.vision_tokens, cfg.vision_dim,
                                       device=cuda, generator=gen)
    max_len = cfg.vision_tokens + 48
    fa.reset_launch_counts()
    lk, ck = model.prefill(batch, max_len)
    assert fa.LAUNCHES["flash_attention"] == cfg.num_layers
    dk, _ = model.decode_step(ck, batch["tokens"][:, :1])
    model.attn_backend = "chunked"
    lp, cp = model.prefill(batch, max_len)
    dp, _ = model.decode_step(cp, batch["tokens"][:, :1])
    assert fa.LAUNCHES["flash_attention"] == cfg.num_layers
    torch.testing.assert_close(lk, lp, rtol=1e-4, atol=1e-4)
    if cfg.kv_cache_dtype == "int8":
        # k and v that differ in their last bits may quantize one step apart
        # (and the decode then reads that step), as against the reference
        off = (ck["k"].int() - cp["k"].int()).abs()
        assert int(off.max()) <= 1 and float((off > 0).float().mean()) <= 1e-3
    else:
        torch.testing.assert_close(ck["k"], cp["k"], rtol=1e-4, atol=1e-4)
        torch.testing.assert_close(dk, dp, rtol=1e-4, atol=1e-4)


def test_attention_dispatch_takes_non_causal_calls_of_any_length(cuda):
    """``layers.attention`` launches K6 for a non-causal call without a
    window whatever S and T (whisper's encoder and cross-attention), reads
    no position then, and still raises for a non-causal finite window
    (R10), a causal S != T and padded keys."""
    from repro_torch.models import layers as L

    gen = torch.Generator(device=cuda).manual_seed(3)
    q = torch.randn(2, 7, 4, 64, generator=gen, device=cuda)
    k, v = (torch.randn(2, 300, 2, 64, generator=gen, device=cuda)
            for _ in range(2))
    fa.reset_launch_counts()
    got = L.attention(q, k, v, causal=False)
    shifted = L.attention(q, k, v, causal=False,
                          q_pos=torch.arange(100, 107, device=cuda),
                          k_pos=torch.arange(300, device=cuda))
    assert fa.LAUNCHES["flash_attention"] == 2
    want = fa.flash_attention_ref(q, k, v, causal=False)
    for out in (got, shifted):
        ok, err = fa.flash_within_tolerance(out, want, q, k, v, causal=False)
        assert ok, err
    plain = L.attention(q, k, v, causal=False, backend="chunked")
    torch.testing.assert_close(got, plain, rtol=1e-4, atol=1e-4)
    with pytest.raises(NotImplementedError, match="R10"):
        L.attention(q, k, v, causal=False, window=16)
    with pytest.raises(NotImplementedError):
        L.attention(q, k, v)  # causal with S != T
    with pytest.raises(NotImplementedError, match="padded keys"):
        L.attention(q, k, v, causal=False,
                    k_pos=torch.arange(300, device=cuda) - 1)
    assert fa.LAUNCHES["flash_attention"] == 2


@pytest.mark.parametrize("arch", ["whisper-medium", "mamba2-780m",
                                  "recurrentgemma-9b"])
def test_own_model_families_on_card_equal_cpu(cuda, arch):
    """The encdec, ssm and hybrid models (reduced, fp32; whisper's and the
    hybrid's head_dim 64 for the kernel) on the card against the same
    weights on the CPU: prefill logits and every cache leaf, then four
    decode steps (the hybrid's ring wraps), within ``MODEL_TOL`` of
    ``tests/test_torch_lm.py``; K6 launched once an encoder layer and twice
    a decoder layer in whisper's prefill and once a decoder layer a decode
    step, once an attention block in the hybrid's prefill, never in
    mamba2's."""
    from repro_torch.models.registry import get_model, get_reduced_config

    cfg = get_reduced_config(arch)
    if cfg.family != "ssm":
        cfg = cfg.replace(d_model=128, head_dim=64)
    model = get_model(cfg, device=cuda, dtype=torch.float32)
    model.init(torch.Generator(device=cuda).manual_seed(0))
    host = get_model(cfg, device="cpu", dtype=torch.float32)
    host.load_state_dict({k: t.cpu() for k, t in model.state_dict().items()})
    gen = torch.Generator().manual_seed(1)
    b, s, steps = 2, 40, 4
    batch = {"tokens": torch.randint(0, cfg.vocab, (b, s), generator=gen)}
    if cfg.family == "encdec":
        batch["frames"] = torch.randn(b, cfg.encoder_seq, cfg.d_model,
                                      generator=gen)
    feed = torch.randint(0, cfg.vocab, (steps, b, 1), generator=gen)
    tol = dict(rtol=2e-4, atol=2e-4)

    def leaves(cache):
        if "blocks" in cache:
            return [t for block in cache["blocks"] for t in block]
        return [t for key, t in sorted(cache.items()) if key != "pos"]

    fa.reset_launch_counts()
    lk, ck = model.prefill({k: t.to(cuda) for k, t in batch.items()}, s + 8)
    prefill_launches = fa.LAUNCHES["flash_attention"]
    lh, chost = host.prefill(batch, s + 8)
    torch.testing.assert_close(lk.cpu(), lh, **tol)
    for a, h in zip(leaves(ck), leaves(chost), strict=True):
        torch.testing.assert_close(a.cpu(), h, **tol)
    fa.reset_launch_counts()
    for i in range(steps):
        dk, ck = model.decode_step(ck, feed[i].to(cuda))
        dh, chost = host.decode_step(chost, feed[i])
        torch.testing.assert_close(dk.cpu(), dh, **tol)
    decode_launches = fa.LAUNCHES["flash_attention"]
    for a, h in zip(leaves(ck), leaves(chost), strict=True):
        torch.testing.assert_close(a.cpu(), h, **tol)
    if cfg.family == "encdec":
        assert prefill_launches == cfg.encoder_layers + 2 * cfg.num_layers
        assert decode_launches == steps * cfg.num_layers
    elif cfg.family == "hybrid":
        assert prefill_launches == model.kinds.count("attn")
        assert decode_launches == 0
    else:
        assert prefill_launches == decode_launches == 0


# K6's autograd Function on the card, through ``layers.attention``: one
# mask mode each (b, s, t, hq, hkv, hd, causal, window, cap, prefix)
FLASH_GRAD_MODES = [
    (1, 300, 300, 8, 4, 256, True, 128, 50.0, 0),   # gemma2: window, cap
    (2, 200, 200, 8, 1, 256, True, None, None, 64),  # paligemma: prefix
    (2, 150, 150, 16, 16, 64, False, None, None, 0),  # whisper encoder
    (2, 40, 150, 16, 16, 64, False, None, None, 0),   # whisper cross
    (1, 300, 300, 16, 1, 256, True, 100, None, 0),   # the hybrid, MQA
    (1, 257, 257, 4, 2, 128, True, None, 30.0, 0),
]


@pytest.mark.parametrize("mode", FLASH_GRAD_MODES)
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_flash_attention_function_gradients_on_card(cuda, mode, dtype):
    """``attention(backend="kernel")`` with inputs that require grad runs
    K6 once forward (within its contract) through ``FlashAttention``, and
    its dq, dk and dv equal autograd through ``backend="chunked"`` on the
    same inputs: the backward is that scan's gradient (1e-5 relative)."""
    from repro_torch.models import layers as L

    b, s, t, hq, hkv, hd, causal, window, cap, prefix = mode
    gen = torch.Generator(device=cuda).manual_seed(s + t + hd)
    q0 = torch.randn(b, s, hq, hd, generator=gen, device=cuda).to(dtype)
    k0, v0 = (torch.randn(b, t, hkv, hd, generator=gen,
                          device=cuda).to(dtype) for _ in range(2))
    dout = torch.randn(b, s, hq, hd, generator=gen, device=cuda).to(dtype)
    kw = dict(causal=causal, window=L.NO_WINDOW if window is None else window,
              cap=cap, prefix_len=prefix)
    grads = {}
    for backend in ("kernel", "chunked"):
        ins = [x.clone().requires_grad_() for x in (q0, k0, v0)]
        fa.reset_launch_counts()
        out = L.attention(*ins, backend=backend, **kw)
        assert out.requires_grad
        assert fa.LAUNCHES["flash_attention"] == (backend == "kernel")
        if backend == "kernel":
            fkw = dict(causal=causal, window=window, cap=cap,
                       prefix_len=prefix)
            ok, err = fa.flash_within_tolerance(
                out.detach(), fa.flash_attention_ref(q0, k0, v0, **fkw),
                q0, k0, v0, **fkw)
            assert ok, err
        grads[backend] = torch.autograd.grad(out, ins, dout)
        assert fa.LAUNCHES["flash_attention"] == (backend == "kernel")
    for g, w in zip(grads["kernel"], grads["chunked"]):
        assert g.dtype == dtype and bool(torch.isfinite(g).all())
        torch.testing.assert_close(g.float(), w.float(), rtol=1e-5,
                                   atol=1e-5 * float(w.float().abs().max()))


def test_bare_flash_kernel_refuses_inputs_that_require_grad(cuda):
    gen = torch.Generator(device=cuda).manual_seed(0)
    q, k, v = (torch.randn(1, 64, 2, 64, generator=gen, device=cuda)
               for _ in range(3))
    fa.reset_launch_counts()
    with pytest.raises(RuntimeError, match="forward only"):
        fa.flash_attention_kernel(q.requires_grad_(), k, v)
    assert fa.LAUNCHES["flash_attention"] == 0
    with torch.no_grad():
        fa.flash_attention_kernel(q, k, v)
    assert fa.LAUNCHES["flash_attention"] == 1


@pytest.mark.parametrize("arch", ["gemma2-2b", "dbrx-132b", "paligemma-3b",
                                  "whisper-medium", "mamba2-780m",
                                  "recurrentgemma-9b"])
def test_apply_train_backward_on_card(cuda, arch):
    """One microbatched gradient of each family on the card (reduced, fp32
    weights, head_dim 64 for the kernel, remat on): every parameter gets a
    finite gradient with a norm above 0; K6 launches twice an attention
    layer (the forward and the remat's recompute); the loss and the
    gradients within 1e-3 of the chunked path's on the card (fp32, K6's
    forward in another summation order; with the reduced dbrx-132b's bf16
    accumulators, where values a few fp32 ulp apart round to neighbouring
    bf16 values, 2⁻⁶ of a leaf's largest value)."""
    from repro_torch.models.registry import get_model, get_reduced_config
    from repro_torch.train import data, train_step

    cfg = get_reduced_config(arch)
    if cfg.family != "ssm":
        cfg = cfg.replace(d_model=128, head_dim=64)
    model = get_model(cfg, device=cuda, dtype=torch.float32)
    model.init(torch.Generator(device=cuda).manual_seed(0))
    batch = {k: torch.from_numpy(v).to(cuda) for k, v in data.make_batch(
        cfg, data.SyntheticDataConfig(4, 41), 0).items()}
    attn = {"encdec": cfg.encoder_layers + 2 * cfg.num_layers,
            "ssm": 0, "hybrid": getattr(model, "kinds", []).count("attn")
            }.get(cfg.family, cfg.num_layers)
    results = {}
    for backend in ("kernel", "chunked"):
        if cfg.family != "ssm":
            model.attn_backend = backend
        fa.reset_launch_counts()
        grads, metrics = train_step.make_grad_fn(
            model, cfg, microbatches=2)(batch)
        torch.cuda.synchronize()
        launches = fa.LAUNCHES["flash_attention"]
        assert launches == (2 * 2 * attn if backend == "kernel" else 0)
        results[backend] = grads, metrics
    grads, metrics = results["kernel"]
    assert set(grads) == {n for n, _ in model.named_parameters()}
    for name, g in grads.items():
        assert bool(torch.isfinite(g).all()) and float(g.norm()) > 0, name
    plain, pm = results["chunked"]
    torch.testing.assert_close(metrics["xent"], pm["xent"], rtol=1e-4,
                               atol=0)
    tol = 2.0 ** -6 if cfg.grad_accum_dtype == "bfloat16" else 1e-3
    for name, g in grads.items():
        w = plain[name].float()
        assert float((g.float() - w).abs().max()) <= tol * float(
            w.abs().max()), name


def test_flash_kernel_checks_inputs(cuda):
    q = torch.zeros(1, 8, 4, 64, device=cuda)
    k = torch.zeros(1, 8, 2, 64, device=cuda)
    with pytest.raises(ValueError, match="head dim"):
        fa.flash_attention_kernel(q[..., :32], k[..., :32], k[..., :32])
    with pytest.raises(ValueError, match="one device"):
        fa.flash_attention_kernel(q, k.cpu(), k)
    # strided inputs are copied, not refused
    qs = torch.zeros(1, 8, 4, 128, device=cuda)[..., ::2]
    assert fa.flash_attention_kernel(qs, k, k).shape == (1, 8, 4, 64)


def test_prefill_through_flash_kernel_matches_plain_path(cuda):
    from repro_torch.models import layers as L
    from repro_torch.models.registry import get_reduced_config
    from repro_torch.models.transformer import TransformerLM

    cfg = get_reduced_config("gemma2-2b").replace(
        d_model=128, num_heads=4, kv_heads=2, head_dim=64)
    model = TransformerLM(cfg, device=cuda, dtype=torch.float32)
    model.init(torch.Generator(device=cuda).manual_seed(0))
    tokens = torch.randint(0, cfg.vocab, (2, 40), device=cuda,
                           generator=torch.Generator(device=cuda).manual_seed(1))
    fa.reset_launch_counts()
    lk, ck = model.prefill({"tokens": tokens}, 48)
    assert fa.LAUNCHES["flash_attention"] == cfg.num_layers
    model.attn_backend = "chunked"
    lp, cp = model.prefill({"tokens": tokens}, 48)
    assert fa.LAUNCHES["flash_attention"] == cfg.num_layers
    torch.testing.assert_close(lk, lp, rtol=1e-4, atol=1e-4)
    torch.testing.assert_close(ck["k"], cp["k"], rtol=1e-4, atol=1e-4)
    pos = torch.arange(8, device=cuda)
    q = torch.zeros(1, 8, 4, 64, device=cuda)
    # a bidirectional prefix runs the kernel
    fa.reset_launch_counts()
    assert L.attention(q, q[:, :, :2], q[:, :, :2], q_pos=pos, k_pos=pos,
                       prefix_len=3).shape == q.shape
    assert fa.LAUNCHES["flash_attention"] == 1
    # given positions are checked; shifted ones are not the prefill case
    with pytest.raises(NotImplementedError):
        L.attention(q, q[:, :, :2], q[:, :, :2], q_pos=pos + 1, k_pos=pos + 1)
    fa.reset_launch_counts()
    assert L.attention(q, q[:, :, :2], q[:, :, :2], q_pos=pos,
                       k_pos=pos).shape == q.shape
    assert fa.LAUNCHES["flash_attention"] == 1
    with pytest.raises(NotImplementedError):
        L.attention(q, q[:, :, :2], q[:, :, :2], q_pos=pos, k_pos=pos - 1)


@pytest.mark.parametrize("prep_backend", ["device", "host"])
@pytest.mark.parametrize("strategy", ["auto", "broadcast", "probe", "bitmap"])
def test_tiled_equals_resident_on_card(cuda, strategy, prep_backend):
    from repro_torch.core.engine import _TiledStage

    g = rmat_graph(10, 8, seed=3)
    kw = dict(algorithm="intersection", strategy=strategy,
              prep_backend=prep_backend)
    resident = TriangleCounter(g, **kw)
    want = resident.count()
    reset_launch_counts()
    tiled = TriangleCounter(g, max_device_bytes=1 << 15, **kw)
    res = tiled.count()
    assert res == want == triangle_count_scipy(g)
    chunks = [st for st in tiled.plan.stages if isinstance(st, _TiledStage)]
    assert res.meta["num_chunks"] >= 2 and chunks
    # one launch per resident stage and per chunk of each tiled stage
    assert sum(LAUNCHES.values()) == res.meta["num_chunks"] + sum(
        not isinstance(st, _TiledStage) for st in tiled.plan.stages)
    for st in chunks:  # the host side is pinned; nothing of it is resident
        assert all(x.is_pinned() for c in st.chunks for x in c)
        assert all(x.is_pinned() for c in st.vertex_chunks for x in c)
        assert st.args == ()
    for _ in range(3):
        assert tiled.count() == res.count
    np.testing.assert_array_equal(tiled.triangles_per_vertex(),
                                  resident.triangles_per_vertex())


def test_chunked_prep_on_card_equals_cpu(cuda):
    from repro_torch.core import prep

    g = rmat_graph(10, 8, seed=3)
    budget = 1 << 14
    got = prep.prepare_intersection_buckets_device(g, device=cuda,
                                                   max_device_bytes=budget)
    want = prep.prepare_intersection_buckets_device(g, device="cpu")
    assert any(prep.bucket_is_tiled(b.e_pad, b.width, budget) for b in got)
    for gb, wb in zip(got, want, strict=True):
        tiled = prep.bucket_is_tiled(gb.e_pad, gb.width, budget)
        for name in ("u_lists", "v_lists", "src", "dst"):
            a = getattr(gb, name)
            assert (a.device.type == "cpu" and a.is_pinned()) if tiled \
                else a.device.type == "cuda"
            assert torch.equal(a.cpu(), getattr(wb, name))


def test_tiled_matrix_on_card(cuda):
    from repro_torch.core.engine import _TiledStage

    g = rmat_graph(10, 16, seed=2)
    want = TriangleCounter(g, algorithm="matrix").count()
    ms.reset_launch_counts()
    tiled = TriangleCounter(g, algorithm="matrix",
                            max_device_bytes=3 * 128 * 128 * 4 * 8)
    res = tiled.count()
    assert res.meta["block"] == 128
    assert res == want == triangle_count_scipy(g)
    (st,) = tiled.plan.stages
    assert isinstance(st, _TiledStage) and st.chunk_rows == 8
    assert res.meta["num_chunks"] == st.num_chunks >= 2
    assert ms.LAUNCHES == {"masked_spgemm": 0,
                           "masked_spgemm_wgmma": st.num_chunks}
    assert all(x.is_pinned() for c in st.chunks for x in c)


def test_batch_equals_loop_on_card(cuda):
    from repro_torch.core import GraphBatch

    graphs = [rmat_graph(8 + s % 3, 8, seed=s) for s in range(10)] \
        + [load_dataset("tiny-rmat"), complete_graph(20)]
    session = TriangleCounter(rmat_graph(7, 8, seed=99),
                              algorithm="intersection")
    reset_launch_counts()
    res = session.count_many(graphs, batch_size=6)
    batches = {id(r.plan): r.plan for r in res}
    assert all(isinstance(b, GraphBatch) for b in batches.values())
    # one launch per width per batch
    assert sum(LAUNCHES.values()) == sum(len(b.specs)
                                         for b in batches.values())
    for g, r in zip(graphs, res):
        assert r == TriangleCounter(g, algorithm="intersection").count() \
            == triangle_count_scipy(g)
    for strategy in ("broadcast", "probe", "bitmap"):
        batch = GraphBatch.from_graphs(graphs[:4], algorithm="intersection",
                                       strategy=strategy)
        assert all(a.device.type == "cuda" for a in batch.arrays)
        assert [int(c) for c in batch.counts()] == \
            [triangle_count_scipy(g) for g in graphs[:4]]


ANALOGUES = ("coauthors-like", "road-like", "citpatents-like")


@pytest.mark.parametrize("strategy", ["auto", "broadcast", "probe", "bitmap"])
@pytest.mark.parametrize("name", ANALOGUES)
def test_edge_lane_on_card_equals_cpu(cuda, name, strategy):
    g = load_dataset(name)
    tc = TriangleCounter(g, algorithm="edge", strategy=strategy)
    cpu = TriangleCounter(g, algorithm="edge", strategy=strategy,
                          device="cpu")
    for a, b in zip(tc.edge_support(), cpu.edge_support()):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)
    assert tc.plan.edge_keys.device.type == "cuda"
    assert tc.count() == triangle_count_scipy(g)
    for k in (4, 6):
        a, b = tc.k_truss(k), cpu.k_truss(k)
        np.testing.assert_array_equal(a.col_idx, b.col_idx)
        assert tc.plan.meta["peel_rounds"] == cpu.plan.meta["peel_rounds"]


def test_truss_decomposition_on_card_equals_cpu(cuda):
    from repro_torch.core import truss_decomposition_forward_scipy

    g = rmat_graph(9, 8, seed=1)
    got = TriangleCounter(g, algorithm="edge").truss_decomposition()
    for a, b in zip(got, truss_decomposition_forward_scipy(g)):
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("key_mode", ["auto", "wide"])
@pytest.mark.parametrize("name", ("coauthors-like", "road-like"))
def test_dynamic_lane_on_card_equals_cpu(cuda, name, key_mode):
    from repro_torch.core import DynamicTriangleCounter

    g = load_dataset(name)
    rng = np.random.default_rng(0)
    kw = dict(update_batch_size=64, recount_interval=0, key_mode=key_mode)
    card = DynamicTriangleCounter(g, **kw)
    cpu = DynamicTriangleCounter(g, device="cpu", **kw)
    lo, hi = g.edge_list_unique()
    for _ in range(6):
        dels = rng.choice(lo.shape[0], 32, replace=False)
        ups = [(int(lo[i]), int(hi[i]), False) for i in dels]
        ups += [(int(a), int(b)) for a, b in rng.integers(0, g.n, (32, 2))]
        assert card.apply_updates(ups).count == cpu.apply_updates(ups).count
        np.testing.assert_array_equal(card.plan._keys.cpu().numpy(),
                                      cpu.plan._keys.numpy())
        np.testing.assert_array_equal(card.plan._rkeys.cpu().numpy(),
                                      cpu.plan._rkeys.numpy())
    reset_launch_counts()
    assert card.recount() == card.count().count \
        == triangle_count_scipy(card.snapshot())
    assert sum(LAUNCHES.values()) > 0  # the recount ran K1-K3


SERVE_KINDS = ("count", "vertex", "edge_support", "k_truss", "update")


def _serve_kinds(device, graphs, opts):
    """Every request kind through a ``TriangleService`` on ``device``; the
    served results in order, the snapshot and the CUDA devices the
    dispatcher thread's sessions were built under."""
    from repro_torch.serve import ServeConfig, TriangleService
    from repro_torch.serve import service as service_module

    seen = []

    class Recording(service_module.TriangleCounter):
        def __init__(self, *a, **kw):
            if torch.cuda.is_available():
                seen.append(torch.cuda.current_device())
            super().__init__(*a, **kw)

    svc = TriangleService(opts, config=ServeConfig(batch_window_ms=250.0,
                                                   max_batch=8),
                          device=device)
    orig = service_module.TriangleCounter
    service_module.TriangleCounter = Recording
    try:
        with svc:
            svc.warmup(graphs)
            out = {"count": [f.result(timeout=120) for f in
                             [svc.submit("count", g) for g in graphs * 2]]}
            out["vertex"] = [svc.submit("vertex", g).result(timeout=120)
                             for g in graphs]
            out["edge_support"] = [svc.submit("edge_support", g).result(
                timeout=120) for g in graphs]
            out["k_truss"] = [svc.submit("k_truss", g, k=4).result(
                timeout=120) for g in graphs]
            h = svc.open_dynamic_session(graphs[0])
            out["update"] = [svc.submit("update", handle=h, updates=u).result(
                timeout=120) for u in ([(0, 1), (1, 2), (0, 2)],
                                       [(3, 4), (0, 1, False)])]
            snap = svc.snapshot()
    finally:
        service_module.TriangleCounter = orig
    return out, snap, seen


def test_service_on_card_equals_cpu(cuda):
    from repro_torch.core import CountOptions

    graphs = [rmat_graph(8 + i % 3, 8, seed=700 + i) for i in range(4)] \
        + [load_dataset("tiny-grid")]
    opts = CountOptions(algorithm="intersection")
    last = torch.device("cuda", torch.cuda.device_count() - 1)
    gpu, snap, seen = _serve_kinds(last, graphs, opts)
    cpu, _, _ = _serve_kinds("cpu", graphs, opts)
    assert snap["counters"].get("errors", 0) == 0
    assert snap["coalesce_factor"] > 1.0
    # the dispatcher thread built every session under the service's card
    assert seen and all(d == last.index for d in seen)
    for kind in SERVE_KINDS:
        for a, b in zip(gpu[kind], cpu[kind]):
            assert a.count == b.count and a.algorithm == b.algorithm, kind
            if kind == "vertex":
                np.testing.assert_array_equal(a.value, b.value)
            elif kind == "edge_support":
                for x, y in zip(a.value, b.value):
                    np.testing.assert_array_equal(x, y)
            elif kind == "k_truss":
                np.testing.assert_array_equal(a.value.col_idx,
                                              b.value.col_idx)
    assert [r.count for r in gpu["count"]] == \
        [triangle_count_scipy(g) for g in graphs * 2]


def test_measured_chooser_on_card_dominates(cuda):
    """Two sweep graphs, every lane timed on the card: the table's pick,
    timed again, is within 2·t_best + 200 µs (the reference's tolerance in
    tests/test_auto_dominance.py), and counts exactly."""
    import importlib

    from repro_torch.core import CountOptions, calibrate, choose_measured

    cal = importlib.import_module("repro_torch.core.calibrate")
    graphs = [load_dataset("coauthors-like"), complete_graph(512)]
    table = calibrate(graphs, iters=3, warmup=1)
    assert table.device == cal.device_label()
    assert table.device != "cpu"
    for g in graphs:
        timings = table.lookup(g)
        assert set(timings) == set(cal.CHOOSER_LANES)
        pick = choose_measured(g, table)
        t_best = min(timings.values())
        fresh = cal.measure_lanes(g, [pick], iters=3, warmup=1)[pick]
        assert fresh <= 2.0 * t_best + 200e-6, (g.name, pick, fresh, t_best)
        tc = TriangleCounter(g, CountOptions(algorithm=pick))
        assert tc.count() == triangle_count_scipy(g)


# -- the sharded lanes --------------------------------------------------------

def test_sharded_lanes_on_world1_nccl_group(cuda, tmp_path):
    """One NCCL rank on the card: each sharded lane equals scipy and the
    single-card lane, and the sharded edge support the CPU's."""
    import torch.distributed as dist

    from repro_torch.launch.mesh import make_mesh

    g = load_dataset("coauthors-like")
    truth = triangle_count_scipy(g)
    torch.cuda.set_device(0)
    dist.init_process_group("nccl", store=dist.FileStore(
        str(tmp_path / "store"), 1), rank=0, world_size=1)
    try:
        mesh = make_mesh((1,), ("data",))
        reset_launch_counts()
        for strategy in ("auto", "probe", "broadcast", "bitmap"):
            tc = TriangleCounter(g, algorithm="intersection_distributed",
                                 strategy=strategy, mesh=mesh)
            assert tc.count().count == truth
            assert tc.count().meta["shard_valid"] == [
                (e,) for e in tc.count().meta["bucket_edges"]]
        assert all(LAUNCHES[s] > 0 for s in ("broadcast", "probe", "bitmap"))
        for block in (32, 128):
            assert TriangleCounter(g, algorithm="matrix_distributed",
                                   block=block, mesh=mesh).count().count \
                == TriangleCounter(g, algorithm="matrix",
                                   block=block).count().count == truth
        got = TriangleCounter(g, mesh=mesh).edge_support()
        want = TriangleCounter(g, device="cpu").edge_support()
        assert all(np.array_equal(a, b) for a, b in zip(got, want))
    finally:
        dist.destroy_process_group()


def test_sharded_lanes_on_gloo_ranks_sharing_the_card(cuda, tmp_path):
    """Four gloo ranks spawned on cuda:0: every rank's counts and supports
    equal scipy's, and K1–K4 launch in every rank process."""
    import hashlib

    import torch.multiprocessing as mp

    import torch_distributed_cases as cases
    from repro_torch.core import edge_support_forward_scipy

    g = load_dataset("coauthors-like")
    truth = triangle_count_scipy(g)
    support = hashlib.sha1(np.ascontiguousarray(np.stack(
        edge_support_forward_scipy(g)), dtype=np.int64).tobytes()).hexdigest()
    mp.start_processes(cases.card_rank, nprocs=4, start_method="spawn",
                       args=(4, str(tmp_path / "store"), str(tmp_path)))
    for r in range(4):
        out = json.loads((tmp_path / f"rank{r}.json").read_text())
        assert set(out["counts"].values()) == {truth}, out
        assert out["support"] == support
        assert all(out["launches"][k] > 0 for k in
                   ("broadcast", "probe", "bitmap", "masked_spgemm",
                    "masked_spgemm_wgmma")), out["launches"]


# chip_smoke.py phase 3x (c): gemma2-2b's layer (8 q heads, 4 kv heads, hd
# 256, bf16, cap 50) split over a model axis of 2 ((2, 2) mesh) and 4
# ((1, 4) mesh); window 4096 (its local layers) and none
@pytest.mark.parametrize("window", [4096, None], ids=["local", "global"])
@pytest.mark.parametrize("n", [2, 4])
def test_local_head_flash_calls_equal_unsharded_heads(cuda, n, window):
    """Each model rank's K6 call on its own heads (``meshctx.head_split``:
    its q heads and the kv heads they read) equals the same heads of the
    unsharded call within K6's contract (``flash_within_tolerance``,
    ``flash_row_rms``), one launch each."""
    from repro_torch.models.meshctx import head_split

    gen = torch.Generator(device=cuda).manual_seed(n)
    b, s, hq, hkv, hd = 1, 1024, 8, 4, 256
    q = torch.randn(b, s, hq, hd, generator=gen, device=cuda).bfloat16()
    k = torch.randn(b, s, hkv, hd, generator=gen, device=cuda).bfloat16()
    v = torch.randn(b, s, hkv, hd, generator=gen, device=cuda).bfloat16()
    kw = dict(causal=True, window=window, cap=50.0)
    whole = fa.flash_attention_kernel(q, k, v, **kw)
    for r in range(n):
        qs, kv = head_split(hq, hkv, n, r)
        assert len(qs) == hq // n and all(h // 2 in kv for h in qs)
        idx = torch.tensor(kv, device=cuda)
        ql = q[:, :, qs.start:qs.stop].contiguous()
        kl, vl = k.index_select(2, idx), v.index_select(2, idx)
        fa.reset_launch_counts()
        got = fa.flash_attention_kernel(ql, kl, vl, **kw)
        torch.cuda.synchronize()
        assert fa.LAUNCHES == {"flash_attention": 1}
        ok, err = fa.flash_within_tolerance(
            got, whole[:, :, qs.start:qs.stop], ql, kl, vl, **kw)
        assert ok, (r, err)
        rows = fa.flash_row_rms(got, ql, kl, vl, **kw)
        assert float(rows.max()) <= fa.ROW_RMS_BOUND[torch.bfloat16]


def test_sharded_train_step_on_world1_nccl_group(cuda, tmp_path):
    """One step of the reduced gemma2-2b (widened to d 128, head_dim 64 for
    K6; fp32, two microbatches) on a (1, 1) mesh of a world-1 NCCL group
    (``make_local_mesh``, ``shard_model_``, ``activation_mesh``) equals the
    one-card step: loss and grad norm within 1e-5, parameters within the
    reference's sharded-step tolerances (rtol 5e-4, atol 5e-5), the same
    K6 launches (two an attention layer a microbatch)."""
    import torch.distributed as dist

    from repro_torch.launch.mesh import make_local_mesh
    from repro_torch.models import layers as L
    from repro_torch.models.meshctx import activation_mesh, full_value
    from repro_torch.models.registry import get_model, get_reduced_config
    from repro_torch.train import data, optimizer, sharding, train_step

    cfg = get_reduced_config("gemma2-2b").replace(d_model=128, head_dim=64)
    opt_cfg = optimizer.AdamWConfig(peak_lr=1e-3, warmup_steps=1,
                                    moment_dtype=torch.float32)
    batch = {k: torch.from_numpy(v).to(cuda) for k, v in data.make_batch(
        cfg, data.SyntheticDataConfig(4, 65), 0).items()}

    def run(mesh):
        model = get_model(cfg, device=cuda, dtype=torch.float32)
        model.init(torch.Generator(device=cuda).manual_seed(0))
        L.trainable_(model)
        if mesh is not None:
            sharding.shard_model_(model, mesh)
        opt = optimizer.adamw_init(dict(model.named_parameters()), opt_cfg)
        step = train_step.make_train_step(model, cfg, opt_cfg, microbatches=2)
        fa.reset_launch_counts()
        with activation_mesh(mesh):
            opt, m = step(opt, batch)
        torch.cuda.synchronize()
        return ({k: float(x) for k, x in m.items()},
                {n: full_value(p.detach()) for n, p in
                 model.named_parameters()}, fa.LAUNCHES["flash_attention"])

    want, want_p, want_k6 = run(None)
    torch.cuda.set_device(0)
    dist.init_process_group("nccl", store=dist.FileStore(
        str(tmp_path / "store"), 1), rank=0, world_size=1)
    try:
        got, got_p, got_k6 = run(make_local_mesh(1))
    finally:
        dist.destroy_process_group()
    assert want_k6 == got_k6 == 2 * 2 * cfg.num_layers
    for k in ("loss", "grad_norm", "ntok"):
        np.testing.assert_allclose(got[k], want[k], rtol=1e-5, err_msg=k)
    for n, w in want_p.items():
        torch.testing.assert_close(got_p[n], w, rtol=5e-4, atol=5e-5)
