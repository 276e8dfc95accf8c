"""The hash lane's compact table and row ends against the reference.

``build_compact_hash_table`` expanded back to (n, B, D) against the
reference's ``build_hash_table`` (and its longest chain against
``hash_table_depth``); ``compact_hash_table`` of hand-made dense tables
(holes, repeated ids, out-of-range slots) and the compact plain probe and
chain-blind oracle against the reference's ``hash_probe_counts_jnp`` and
``hash_probe_counts_ref``; ``probe_row_ends`` against a numpy scan; the
int32 offset check and the input checks. The reference's Pallas K5 does not
run on the installed JAX (R3), so the jnp and ref cores stand for it. Every
value is an integer: tolerance 0.
"""

import numpy as np
import pytest
import torch

import hash_rows
from torch_reference import ref  # noqa: F401

from repro_torch.graphs.formats import csr_to_padded_neighbors, orient_forward
from repro_torch.kernels import hash_tc as ht
from repro_torch.kernels.hash_tc import build as port_build

from test_torch_hash import TABLE_GRAPHS, _jnp, _ragged


def _row_ends_np(cand: np.ndarray, n: int) -> np.ndarray:
    valid = (cand >= 0) & (cand < n)
    idx = np.arange(1, cand.shape[1] + 1)
    return np.where(valid, idx, 0).max(axis=1, initial=0).astype(np.int32)


def _masked(w_lists, row_end, n):
    """The candidates as the reference sees them: -2 at or past the row end
    and outside [0, n)."""
    pos = torch.arange(w_lists.shape[1])
    keep = (pos < row_end[:, None].long()) & (w_lists >= 0) & (w_lists < n)
    return torch.where(keep, w_lists, -2)


@pytest.mark.parametrize("name", list(TABLE_GRAPHS))
def test_compact_build_matches_reference(ref, name):
    g = TABLE_GRAPHS[name]()
    fwd = orient_forward(g)
    width = max(8, fwd.max_degree)
    nbrs = csr_to_padded_neighbors(fwd, pad_to=width)
    nb_t = torch.from_numpy(nbrs)
    for num_buckets in sorted({8, ht.hash_num_buckets(width), 2 * width}):
        compact, longest = ht.build_compact_hash_table(nb_t, num_buckets)
        assert longest == int(ref.hashbuild.hash_table_depth(_jnp(nbrs),
                                                              num_buckets))
        assert compact.num_buckets == num_buckets and compact.n == g.n
        assert compact.chain_ptr.dtype == compact.chain_vals.dtype == torch.int32
        assert compact.chain_ptr.shape == (g.n * num_buckets + 1,)
        assert int(compact.chain_ptr[-1]) == compact.chain_vals.numel() \
            == int((nbrs < g.n).sum())
        for d in sorted({1, max(1, longest), 1 << max(0, longest - 1).bit_length()}):
            rt = np.asarray(ref.hashbuild.build_hash_table(
                _jnp(nbrs), num_buckets=num_buckets, depth=d))
            np.testing.assert_array_equal(
                ht.expand_hash_table(compact, d).numpy(), rt)
        if num_buckets & (num_buckets - 1):
            continue  # the probes take power-of-two bucket counts only
        # compacting the full-depth dense table gives the same arrays
        full = ht.build_hash_table(nb_t, num_buckets=num_buckets,
                                   depth=max(1, longest))
        again = ht.compact_hash_table(full)
        assert torch.equal(again.chain_ptr, compact.chain_ptr)
        assert torch.equal(again.chain_vals, compact.chain_vals)


def test_compact_build_chunks_agree(monkeypatch):
    rng = np.random.default_rng(5)
    nbrs, _, _ = _ragged(rng, 1, 16, 60)
    nb_t = torch.from_numpy(nbrs)
    whole, longest = ht.build_compact_hash_table(nb_t, 16)
    monkeypatch.setattr(port_build, "_BUILD_CHUNK_ELEMS", 16 * 7)
    chunked, again = ht.build_compact_hash_table(nb_t, 16)
    assert again == longest
    assert torch.equal(chunked.chain_ptr, whole.chain_ptr)
    assert torch.equal(chunked.chain_vals, whole.chain_vals)


@pytest.mark.parametrize("bd", [(8, 1), (8, 2), (32, 8), (64, 16)])
@pytest.mark.parametrize("e,w", [(1, 1), (7, 8), (100, 33), (257, 64)])
def test_plain_compact_probe_matches_reference_cores(ref, e, w, bd):
    rng = np.random.default_rng(e * 100 + w)
    n = max(2 * w, 40)
    nbrs, src, cand = _ragged(rng, e, w, n)
    nb_t = torch.from_numpy(nbrs)
    table = ht.build_hash_table(nb_t, num_buckets=bd[0], depth=bd[1])
    rargs = (_jnp(cand), _jnp(src), _jnp(table))
    want = np.asarray(ref.hashprobe.hash_probe_counts_jnp(*rargs))
    w_t, s_t = torch.from_numpy(cand), torch.from_numpy(src)
    row_end = ht.probe_row_ends(w_t, n)
    # the dense table at this depth, compacted: the same counts
    compact = ht.compact_hash_table(table)
    got = ht.hash_probe_compact_chunked(w_t, s_t, row_end, compact)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(
        ht.hash_probe_compact_ref(w_t, s_t, row_end, compact).numpy(),
        np.asarray(ref.hashref.hash_probe_counts_ref(*rargs)))
    # on CPU tensors the kernel wrapper and the dispatch take the plain version
    assert torch.equal(ht.hash_probe_compact_kernel(w_t, s_t, row_end, compact),
                       got)
    assert torch.equal(ht.hash_probe_compact_counts(w_t, s_t, row_end, compact),
                       got)
    # the lane's build holds every chain whole: the reference's full depth
    built, longest = ht.build_compact_hash_table(nb_t, bd[0])
    full = ref.hashbuild.build_hash_table(_jnp(nbrs), num_buckets=bd[0],
                                          depth=max(1, longest))
    want_full = np.asarray(ref.hashprobe.hash_probe_counts_jnp(
        rargs[0], rargs[1], full))
    np.testing.assert_array_equal(
        ht.hash_probe_compact_chunked(w_t, s_t, row_end, built).numpy(),
        want_full)
    assert torch.equal(
        ht.hash_probe_compact_counts(w_t, s_t, row_end, built, backend="ref"),
        torch.from_numpy(want_full.copy()))


@pytest.mark.parametrize("family,e,w,b", hash_rows.CPU_CASES)
def test_compact_cases_match_reference(ref, family, e, w, b):
    c = hash_rows.case(family, e, w, b, seed=e + w + b)
    w_t, s_t, row_end, compact = hash_rows.tensors(c, torch.device("cpu"))
    n = compact.n
    if "dense" in c:
        dense = c["dense"]
    else:
        _, longest = ht.build_compact_hash_table(
            torch.from_numpy(c["nbrs"]), c["num_buckets"])
        dense = np.asarray(ref.hashbuild.build_hash_table(
            _jnp(c["nbrs"]), num_buckets=c["num_buckets"],
            depth=max(1, longest)))
    masked = _masked(w_t, row_end, n)
    s_clamped = s_t.clamp(0, n - 1)
    rargs = (_jnp(masked), _jnp(s_clamped), _jnp(dense))
    want = np.asarray(ref.hashprobe.hash_probe_counts_jnp(*rargs))
    got = ht.hash_probe_compact_chunked(w_t, s_t, row_end, compact)
    np.testing.assert_array_equal(got.numpy(), want)
    oracle = ht.hash_probe_compact_ref(w_t, s_t, row_end, compact)
    np.testing.assert_array_equal(
        oracle.numpy(), np.asarray(ref.hashref.hash_probe_counts_ref(*rargs)))
    if "dense" not in c:  # unique ids: the oracle counts as the probe
        assert torch.equal(oracle, got)
    # offset views change nothing on the CPU either
    w_o, s_o, r_o, _ = hash_rows.tensors(c, torch.device("cpu"), offset=True)
    assert torch.equal(ht.hash_probe_compact_kernel(w_o, s_o, r_o, compact),
                       got)


def test_compact_of_dense_keeps_counts_on_repeats(ref):
    # anchor 0's bucket 1 holds id 9 twice and bucket 3 holds 3 past a hole
    # and beside out-of-range values: the probe counts 9 once
    table = np.full((12, 8, 4), -1, dtype=np.int32)
    table[0, 1, :2] = 9
    table[0, 3, :4] = [12, -1, 3, -5]
    table[0, 5, 0] = 1 << 30
    compact = ht.compact_hash_table(torch.from_numpy(table))
    assert compact.chain_ptr[:9].tolist() == [0, 0, 2, 2, 3, 3, 3, 3, 3]
    assert compact.chain_vals.tolist() == [9, 9, 3]
    cand = torch.tensor([[9, 3, 5, 13], [-2, -2, -2, -2]], dtype=torch.int32)
    src = torch.zeros(2, dtype=torch.int32)
    row_end = ht.probe_row_ends(cand, 12)
    assert row_end.tolist() == [3, 0]
    got = ht.hash_probe_compact_chunked(cand, src, row_end, compact)
    assert got.tolist() == [2, 0]
    rargs = (_jnp(cand), _jnp(src), _jnp(table))
    np.testing.assert_array_equal(
        got.numpy(), np.asarray(ref.hashprobe.hash_probe_counts_jnp(*rargs)))
    assert ht.hash_probe_compact_ref(cand, src, row_end,
                                     compact).tolist() == [3, 0]
    np.testing.assert_array_equal(
        ht.hash_probe_compact_ref(cand, src, row_end, compact).numpy(),
        np.asarray(ref.hashref.hash_probe_counts_ref(*rargs)))


@pytest.mark.parametrize("rows,n,want", [
    ([[-2, -2, -2], [5, 6, 5]], 5, [0, 0]),            # whole padding, all >= n
    ([[1, 6, 2, 6], [6, 6, 0, 6]], 5, [3, 3]),         # valid after a sentinel
    ([[6, 6, 6, 4], [-1, 7, -3, 0]], 5, [4, 4]),       # only the last is valid
    ([[0], [5], [-1]], 5, [1, 0, 0]),                  # W = 1
    ([[3, 1, 4, 1, 5, 9, 2, 6]], 6, [7]),              # unsorted, ids past n
])
def test_probe_row_ends(rows, n, want):
    cand = torch.tensor(rows, dtype=torch.int32)
    assert ht.probe_row_ends(cand, n).tolist() == want
    np.testing.assert_array_equal(_row_ends_np(cand.numpy(), n), want)


@pytest.mark.parametrize("family", hash_rows.FAMILIES)
def test_probe_row_ends_on_families(family, monkeypatch):
    c = hash_rows.case(family, 300, 33, seed=7)
    cand = torch.from_numpy(c["cand"])
    n = max(2 * 33, 64)
    want = _row_ends_np(c["cand"], n)
    np.testing.assert_array_equal(ht.probe_row_ends(cand, n).numpy(), want)
    from repro_torch.kernels.hash_tc import probe as port_probe
    monkeypatch.setattr(port_probe, "_PROBE_CHUNK_ELEMS", 33 * 7)  # 43 chunks
    np.testing.assert_array_equal(ht.probe_row_ends(cand, n).numpy(), want)
    assert ht.probe_row_ends(cand[:0], n).shape == (0,)
    assert ht.probe_row_ends(cand[:, :0], n).tolist() == [0] * 300


def test_int32_overflow_raises(monkeypatch):
    nb_t = torch.tensor([[1, 2, 4], [2, 4, 4], [4, 4, 4], [4, 4, 4]],
                        dtype=torch.int32)  # 3 ids below n = 4
    monkeypatch.setattr(port_build, "_INT_MAX", 3)
    compact, _ = ht.build_compact_hash_table(nb_t, 8)  # 3 ids: fits
    assert compact.chain_vals.tolist() == [1, 2, 2]
    table = ht.expand_hash_table(compact, 1)
    assert ht.compact_hash_table(table).chain_vals.tolist() == [1, 2, 2]
    monkeypatch.setattr(port_build, "_INT_MAX", 2)
    with pytest.raises(ValueError, match="int32"):
        ht.build_compact_hash_table(nb_t, 8)
    with pytest.raises(ValueError, match="int32"):
        ht.compact_hash_table(table)


def test_compact_input_checks():
    nb_t = torch.tensor([[1, 2], [2, 3], [3, 4], [4, 4]], dtype=torch.int32)
    compact, _ = ht.build_compact_hash_table(nb_t, 8)
    cand = torch.zeros((4, 8), dtype=torch.int32)
    src = torch.zeros(4, dtype=torch.int32)
    end = torch.full((4,), 8, dtype=torch.int32)
    assert ht.check_compact_inputs(cand, src, end, compact) == (4, 8, 4, 8)
    bad_ptr = ht.CompactHashTable(compact.chain_ptr[:-1], compact.chain_vals, 8)
    for bad, match in (
            ((cand.long(), src, end, compact), "int32"),
            ((cand, src[:3], end, compact), "src"),
            ((cand, src, end[:3], compact), "row_end"),
            ((cand, src, end, compact._replace(num_buckets=6)), "power of two"),
            ((cand, src, end, bad_ptr), "chain_ptr"),
            ((cand, src, end, compact._replace(
                chain_vals=compact.chain_vals.long())), "int32"),
            ((cand[:, ::2], src, end[:4], compact), "contiguous"),
            ((cand[0], src, end, compact), "w_lists")):
        with pytest.raises(ValueError, match=match):
            ht.hash_probe_compact_kernel(*bad)
    with pytest.raises(ValueError, match="unknown backend"):
        ht.hash_probe_compact_counts(cand, src, end, compact, backend="jnp")
    with pytest.raises(ValueError, match="table"):
        ht.compact_hash_table(torch.zeros((4, 8), dtype=torch.int32))
    with pytest.raises(ValueError, match="power of two"):
        ht.compact_hash_table(torch.zeros((4, 6, 2), dtype=torch.int32))
    assert ht.hash_probe_compact_kernel(cand[:0], src[:0], end[:0],
                                        compact).shape == (0,)
    empty, longest = ht.build_compact_hash_table(nb_t[:0], 8)
    assert longest == 0 and empty.chain_ptr.tolist() == [0]
    assert ht.hash_probe_compact_chunked(cand, src, end,
                                         empty).tolist() == [0] * 4
