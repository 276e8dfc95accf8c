"""The port's set-intersection paths equal the reference's Pallas kernels.

Each plain torch version (and each kernel wrapper, which takes its plain
version on a CPU tensor) must exactly equal the JAX Pallas kernel run with
``interpret=True`` and the reference oracles, at W ∈ {8, 32, 64, 128, 512},
with sentinel rows and an E that is not a multiple of 256; the probe core
also on K2's row families (``probe_rows``), the broadcast and bitmap
cores on K1's and K3's (``intersect_rows``: unsorted rows, duplicates, ids
outside the bitmap's range, W from 1 to 63, each also as a view that starts
mid-allocation), the bitmap core at its id-range boundary. The strategy resolvers must agree with the
reference on a grid, errors included.
"""

import numpy as np
import pytest
import torch

import intersect_rows
import probe_rows
from torch_reference import ref  # noqa: F401

from repro_torch.kernels.intersect import (
    LAUNCHES,
    bitmap as port_bitmap,
    intersect as port_intersect,
    ops as port_ops,
    probe as port_probe,
    ref as port_ref,
)

WIDTHS = [8, 32, 64, 128, 512]
E = 300  # not a multiple of the reference's 256-row tile


def sorted_lists(w: int, e: int = E, n: int = 700, seed: int = 0):
    """(e, w) int32 u/v rows: sorted unique ids < n, in-row sentinels n
    (u) / n + 1 (v), and whole padding rows (-1 / -2) at the end."""
    rng = np.random.default_rng(seed + w)

    def side(fill):
        keys = rng.random((e, n)).argsort(axis=1)[:, :w]
        rows = np.sort(keys, axis=1).astype(np.int32)
        deg = rng.integers(0, w + 1, size=e)
        deg[:5] = w  # full rows
        rows[np.arange(w)[None, :] >= deg[:, None]] = fill
        return rows

    u, v = side(n), side(n + 1)
    v[::7] = np.where(u[::7] == n, n + 1, u[::7])  # rows sharing every id
    u[-9:], v[-9:] = -1, -2
    return u, v


def pallas(ref, u, v, strategy, **kw):
    return np.asarray(ref.ops.intersect_counts(
        u, v, strategy=strategy, backend="pallas", interpret=True, **kw))


@pytest.mark.parametrize("w", WIDTHS)
def test_broadcast_matches_pallas(ref, w):
    u, v = sorted_lists(w)
    want = pallas(ref, u, v, "broadcast")
    np.testing.assert_array_equal(want, np.asarray(ref.kref.intersect_counts_ref(u, v)))
    tu, tv = torch.from_numpy(u), torch.from_numpy(v)
    for got in (port_intersect.intersect_counts_broadcast(tu, tv),
                port_intersect.intersect_counts_kernel(tu, tv),
                port_ref.intersect_counts_ref(tu, tv),
                port_ops.intersect_counts(tu, tv, strategy="broadcast")):
        assert got.dtype == torch.int32
        np.testing.assert_array_equal(got.numpy(), want)


def _as_allocated_and_offset(u, v):
    """The pair as allocated and as views that start mid-allocation."""
    tu, tv = torch.from_numpy(u), torch.from_numpy(v)
    return ((tu, tv), (probe_rows.offset_view(tu), probe_rows.offset_view(tv)))


@pytest.mark.parametrize("case", intersect_rows.CPU_CASES,
                         ids=["{}-{}x{}".format(*c) for c in intersect_rows.CPU_CASES])
def test_broadcast_on_row_families(ref, case):
    """K1's function on its row families (``intersect_rows``): any rows,
    unsorted, with duplicates counted pair by pair and any int32 id, W from
    1 to 63, E around the rows a warp takes. The Pallas kernel in interpret
    mode and the reference oracle against the plain version and the
    wrapper (which takes it on a CPU tensor), aligned and offset."""
    name, e, w = case
    u, v, _ = intersect_rows.family(name, e, w, seed=e + w)
    want = pallas(ref, u, v, "broadcast", tile_edges=8)
    np.testing.assert_array_equal(want, np.asarray(ref.kref.intersect_counts_ref(u, v)))
    for tu, tv in _as_allocated_and_offset(u, v):
        for got in (port_intersect.intersect_counts_broadcast(tu, tv),
                    port_intersect.intersect_counts_kernel(tu, tv)):
            assert got.dtype == torch.int32
            np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("case", intersect_rows.CPU_CASES,
                         ids=["{}-{}x{}".format(*c) for c in intersect_rows.CPU_CASES])
def test_bitmap_on_row_families(ref, case):
    """K3's function on the same families, v's equal ids adjacent (the
    packer's contract) but rows otherwise unsorted: the u elements, with
    multiplicity, whose id is in [0, num_bits) and in v, at the family's
    capacity and at one word (most ids masked). The Pallas kernel in
    interpret mode and the set-based reference against the plain version
    and the wrapper, aligned and offset."""
    name, e, w = case
    u, v, bits = intersect_rows.bitmap_family(name, e, w, seed=e + w)
    for nb in sorted({bits, 32}):
        want = pallas(ref, u, v, "bitmap", bitmap_bits=nb, tile_edges=8)
        np.testing.assert_array_equal(
            want, ref.bitmap.intersect_counts_bitmap_ref(u, v, num_bits=nb))
        for tu, tv in _as_allocated_and_offset(u, v):
            for got in (port_bitmap.intersect_counts_bitmap(tu, tv, num_bits=nb),
                        port_bitmap.intersect_counts_bitmap_kernel(tu, tv,
                                                                   num_bits=nb)):
                np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("case", WIDTHS + [
    pytest.param(c, id="{}-{}x{}".format(*c)) for c in probe_rows.CPU_CASES])
def test_probe_matches_pallas(ref, case):
    """The probe strategy on the shared widths and on K2's row families
    (``probe_rows``): duplicates, touching and disjoint ranges, padding and
    mixed batches, W from 1 to 8200, E below and across 32-row batches."""
    if isinstance(case, int):
        u, v = sorted_lists(case)
        want = pallas(ref, u, v, "probe")
    else:
        name, e, w = case
        u, v = probe_rows.family(name, e, w, seed=e + w)
        want = pallas(ref, u, v, "probe", tile_edges=8)
    np.testing.assert_array_equal(want, ref.kref.intersect_counts_probe_ref(u, v))
    np.testing.assert_array_equal(want, port_ref.intersect_counts_probe_ref(u, v))
    tu, tv = torch.from_numpy(u), torch.from_numpy(v)
    for got in (port_probe.intersect_counts_probe(tu, tv),
                port_probe.intersect_counts_probe_kernel(tu, tv),
                port_ops.intersect_counts(tu, tv, strategy="probe")):
        np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("w", [1, 33, 128, 512, 8200])
def test_probe_sorted_holes_keep_counts(ref, w):
    """A labeled triangle query drops u ids in place (the sentinel n takes
    their slots) and sorts its rows again before the probe strategy, whose
    kernel merges sorted rows. The Pallas kernel searches each u element on
    its own, so it counts the rows with holes: the sorted rows must give
    the same counts, through every port path."""
    holed, u, v = probe_rows.holes(70 if w < 8192 else 9, w, seed=w)
    want = pallas(ref, holed, v, "probe", tile_edges=8)
    np.testing.assert_array_equal(want,
                                  ref.kref.intersect_counts_probe_ref(holed, v))
    assert (u[:, 1:] >= u[:, :-1]).all()
    assert w == 1 or not np.array_equal(u, holed)  # a one-id row stays sorted
    tu, tv = torch.from_numpy(u), torch.from_numpy(v)
    for got in (port_probe.intersect_counts_probe(tu, tv),
                port_probe.intersect_counts_probe_kernel(tu, tv),
                port_ops.intersect_counts(tu, tv, strategy="probe"),
                port_probe.intersect_counts_probe(torch.from_numpy(holed), tv)):
        np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("w", WIDTHS)
def test_bitmap_matches_pallas(ref, w):
    u, v = sorted_lists(w)
    tu, tv = torch.from_numpy(u), torch.from_numpy(v)
    # 704 covers every id and both sentinels; 96 masks most ids out
    for bits in (704, 96):
        want = pallas(ref, u, v, "bitmap", bitmap_bits=bits)
        np.testing.assert_array_equal(
            want, ref.bitmap.intersect_counts_bitmap_ref(u, v, num_bits=bits))
        np.testing.assert_array_equal(
            want, port_bitmap.intersect_counts_bitmap_ref(u, v, num_bits=bits))
        for got in (port_bitmap.intersect_counts_bitmap(tu, tv, num_bits=bits),
                    port_bitmap.intersect_counts_bitmap_kernel(tu, tv, num_bits=bits),
                    port_ops.intersect_counts(tu, tv, strategy="bitmap",
                                              bitmap_bits=bits)):
            np.testing.assert_array_equal(got.numpy(), want)
    # an exact-capacity bitmap agrees with the broadcast oracle
    np.testing.assert_array_equal(
        port_bitmap.intersect_counts_bitmap(tu, tv, num_bits=704).numpy(),
        port_ref.intersect_counts_ref(tu, tv).numpy())


def test_bitmap_id_range_boundary(ref):
    bits = 64
    u = np.array([[bits - 2, bits - 1, bits, bits + 1, -1],
                  [0, 31, 32, 63, 64],
                  [-3, -2, -1, 5, 6]], dtype=np.int32)
    v = np.array([[bits - 1, bits, bits + 1, bits + 2, bits + 3],
                  [0, 32, 63, 64, 65],
                  [-3, -2, 5, 6, 7]], dtype=np.int32)
    want = ref.bitmap.intersect_counts_bitmap_ref(u, v, num_bits=bits)
    np.testing.assert_array_equal(want, [1, 3, 2])
    np.testing.assert_array_equal(
        np.asarray(ref.bitmap.intersect_counts_bitmap(u, v, num_bits=bits)), want)
    tu, tv = torch.from_numpy(u), torch.from_numpy(v)
    np.testing.assert_array_equal(
        port_bitmap.intersect_counts_bitmap(tu, tv, num_bits=bits).numpy(), want)
    np.testing.assert_array_equal(
        port_bitmap.intersect_matches_bitmap(tu, tv, num_bits=bits).numpy(),
        np.asarray(ref.bitmap.intersect_matches_bitmap(u, v, num_bits=bits)))


@pytest.mark.parametrize("strategy", ["auto", "broadcast", "probe", "bitmap"])
@pytest.mark.parametrize("w", [8, 64])
def test_matches_mask_matches_reference(ref, strategy, w):
    u, v = sorted_lists(w, e=120)
    want = np.asarray(ref.ops.intersect_matches(u, v, strategy=strategy))
    got = port_ops.intersect_matches(torch.from_numpy(u), torch.from_numpy(v),
                                     strategy=strategy)
    np.testing.assert_array_equal(got.numpy(), want)


def test_auto_dispatch_matches_reference_jnp(ref):
    for w, n in ((8, 20), (32, 700), (128, 700)):
        u, v = sorted_lists(w, e=64, n=n)
        want = np.asarray(ref.ops.intersect_counts(u, v, backend="jnp"))
        got = port_ops.intersect_counts(torch.from_numpy(u), torch.from_numpy(v))
        np.testing.assert_array_equal(got.numpy(), want)
        got_ref = port_ops.intersect_counts(torch.from_numpy(u), torch.from_numpy(v),
                                            backend="ref", strategy="probe")
        np.testing.assert_array_equal(got_ref.numpy(), want)


def _outcome(fn, *args, **kw):
    try:
        return fn(*args, **kw)
    except ValueError as e:
        return ("ValueError", str(e))


RESOLVER_WIDTHS = [1, 8, 31, 32, 33, 63, 64, 100, 512, 1024, 65536, 65537]
ID_RANGES = [None, 0, 10, 32, 33, 64, 65, 2000, 4096, 4097, 65536, 65537, 10 ** 6]


@pytest.mark.parametrize("fn", ["choose_strategy", "resolve_strategy",
                                "choose_mask_strategy", "resolve_mask_strategy"])
def test_resolvers_match_reference(ref, fn):
    port_fn, ref_fn = getattr(port_ops, fn), getattr(ref.ops, fn)
    strategies = [None] if fn.startswith("choose") else \
        ["auto", "broadcast", "probe", "bitmap", "nope"]
    for w in RESOLVER_WIDTHS:
        for r in ID_RANGES:
            for s in strategies:
                kw = {} if s is None else dict(strategy=s)
                assert _outcome(port_fn, w, r, **kw) == _outcome(ref_fn, w, r, **kw), \
                    (fn, w, r, s)


def test_constants_match_reference(ref):
    assert port_ops.STRATEGIES == ref.ops.STRATEGIES
    assert port_ops.available_strategies() == ref.ops.available_strategies()
    assert port_ops.BITMAP_MAX_BITS == ref.ops.BITMAP_MAX_BITS
    assert port_ops._PROBE_MIN_WIDTH == ref.ops._PROBE_MIN_WIDTH
    for w in (1, 31, 32, 33, 512, 1000):
        assert port_ops.packed_bits(w) == ref.ops.packed_bits(w)


def test_wrappers_validate_inputs_and_never_launch_on_cpu():
    u, v = (torch.from_numpy(a) for a in sorted_lists(8, e=10))
    before = dict(LAUNCHES)
    for wrapper in (port_intersect.intersect_counts_kernel,
                    port_probe.intersect_counts_probe_kernel):
        with pytest.raises(ValueError, match="int32"):
            wrapper(u.long(), v.long())
        with pytest.raises(ValueError, match="one shape"):
            wrapper(u, v[:, :4])
        with pytest.raises(ValueError, match="contiguous"):
            wrapper(u.t().contiguous().t(), v.t().contiguous().t())
        assert wrapper(u[:0], v[:0]).shape == (0,)
    with pytest.raises(ValueError, match="multiple of 32"):
        port_bitmap.intersect_counts_bitmap_kernel(u, v, num_bits=33)
    with pytest.raises(ValueError, match="BITMAP_MAX_BITS"):
        port_bitmap.intersect_counts_bitmap_kernel(u, v, num_bits=1 << 17)
    with pytest.raises(ValueError, match="unknown backend"):
        port_ops.intersect_counts(u, v, backend="pallas")
    with pytest.raises(ValueError, match="unknown strategy"):
        port_ops.intersect_counts(u, v, strategy="merge")
    assert dict(LAUNCHES) == before  # CPU tensors take the plain versions
