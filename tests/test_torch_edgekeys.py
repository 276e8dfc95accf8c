"""Packed edge keys, edge updates and the dynamic step equal the
reference's, bit for bit.

The port's ``forward_edge_keys_device`` / ``forward_edge_keys_host``
(keys with their dtype, the slot permutation, the forward row_ptr, m),
``normalize_edge_updates`` (every spelling, duplicates, self loops, both
``ValueError``s), ``Graph.edge_list_unique``, the key-mode checkpoint, the
mask core ``intersect_matches_both``, and the dynamic lane's pieces
(``dynamic_update_step``, ``delta_update_buckets``) against the reference's
on inputs made from a numpy seed, in both key modes.
"""

import numpy as np
import pytest
import torch

from torch_reference import ref  # noqa: F401

from repro_torch.core import prep
from repro_torch.graphs import (
    EdgeUpdate,
    GraphTooLargeError,
    complete_graph,
    edges_to_csr,
    load_dataset,
    normalize_edge_updates,
    rmat_graph,
)
from repro_torch.graphs import device as dev_mod
from repro_torch.kernels.intersect.ops import intersect_matches_both

CPU = torch.device("cpu")

GRAPHS = {
    "tiny-rmat": lambda: load_dataset("tiny-rmat"),
    "tiny-grid": lambda: load_dataset("tiny-grid"),
    "rmat8": lambda: rmat_graph(8, 8, seed=3),
    "clique9": lambda: complete_graph(9),
    "empty5": lambda: edges_to_csr([], [], n=5, name="empty5"),
}


def _ref_graph(ref, g):
    return ref.formats.Graph(n=g.n, row_ptr=g.row_ptr, col_idx=g.col_idx,
                             name=g.name)


def _same(mine: torch.Tensor, theirs, what: str):
    theirs = np.asarray(theirs)
    got = mine.cpu().numpy()
    assert got.dtype == theirs.dtype, (what, got.dtype, theirs.dtype)
    np.testing.assert_array_equal(got, theirs, err_msg=what)


@pytest.mark.parametrize("key_mode", ["auto", "wide"])
@pytest.mark.parametrize("name", sorted(GRAPHS))
def test_forward_edge_keys_device_match_reference(ref, name, key_mode):
    g = GRAPHS[name]()
    mine = prep.forward_edge_keys_device(g, key_mode=key_mode, device=CPU)
    with ref.device.edge_key_context("wide" if key_mode == "wide" else "int32"):
        theirs = ref.prep.forward_edge_keys_device(_ref_graph(ref, g),
                                                   key_mode=key_mode)
        theirs = tuple(np.asarray(x) for x in theirs[:3]) + (theirs[3],)
    for what, a, b in zip(("keys", "perm", "row_ptr"), mine[:3], theirs[:3]):
        _same(a, b, f"{name} {key_mode} {what}")
    assert mine[3] == theirs[3]
    want = np.int64 if key_mode == "wide" else np.int32
    assert mine[0].cpu().numpy().dtype == want


@pytest.mark.parametrize("key_mode", ["auto", "wide"])
@pytest.mark.parametrize("name", sorted(GRAPHS))
def test_forward_edge_keys_host_match_reference(ref, name, key_mode):
    g = GRAPHS[name]()
    mine = prep.forward_edge_keys_host(g, key_mode)
    theirs = ref.prep.forward_edge_keys_host(_ref_graph(ref, g), key_mode)
    for what, a, b in zip(("keys", "perm", "row_ptr"), mine[:3], theirs[:3]):
        assert a.dtype == b.dtype, what
        np.testing.assert_array_equal(a, b, err_msg=what)
    assert mine[3] == theirs[3]


def test_key_mode_checkpoint_matches_reference(ref):
    for n in (0, 5, 46339, 46340, 1 << 20):
        for mode in ("auto", "int32", "wide"):
            try:
                want = ref.prep.check_edge_key_range(n, mode)
            except ref.device.GraphTooLargeError as e:
                with pytest.raises(GraphTooLargeError) as mine:
                    prep.check_edge_key_range(n, mode)
                assert str(mine.value) == str(e)
                continue
            assert prep.check_edge_key_range(n, mode) == want
    assert prep.check_edge_key_range(46340) == "wide"
    with pytest.raises(GraphTooLargeError, match="int64"):
        prep.check_edge_key_range(1 << 40)
    for mode in ("int32", "wide"):
        assert dev_mod.edge_key_sentinel(mode) == \
            int(ref.device.edge_key_sentinel(mode))
        assert np.dtype(str(dev_mod.edge_key_dtype(mode)).split(".")[1]) == \
            ref.device.edge_key_dtype(mode)


def test_wide_keys_on_a_graph_past_the_int32_bound(ref):
    # n = 65536 > 46339: auto resolves to int64 keys, int32 refuses
    rng = np.random.default_rng(4)
    src, dst = rng.integers(0, 1 << 16, size=(2, 3000))
    g = edges_to_csr(src, dst, n=1 << 16, name="wide16")
    keys, perm, row_ptr, m = prep.forward_edge_keys_device(g, device=CPU)
    assert keys.dtype == torch.int64 and m == g.m_undirected
    with ref.device.edge_key_context("wide"):
        theirs = ref.prep.forward_edge_keys_device(_ref_graph(ref, g))
        _same(keys, theirs[0], "wide keys")
        _same(perm, theirs[1], "wide perm")
    with pytest.raises(GraphTooLargeError, match="int32"):
        prep.forward_edge_keys_device(g, key_mode="int32", device=CPU)


@pytest.mark.parametrize("name", sorted(GRAPHS))
def test_edge_list_unique_matches_reference(ref, name):
    g = GRAPHS[name]()
    for a, b in zip(g.edge_list_unique(), _ref_graph(ref, g).edge_list_unique()):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)


UPDATE_CASES = {
    "spellings": [EdgeUpdate(3, 1), (0, 2), (4, 0, False), EdgeUpdate(2, 4, False)],
    "last_wins": [(0, 1, True), (2, 2, True), (1, 0, False), (3, 4, False),
                  (4, 3, True)],
    "self_loops_only": [(1, 1), (3, 3, False)],
    "empty": [],
}


@pytest.mark.parametrize("case", sorted(UPDATE_CASES))
def test_normalize_edge_updates_matches_reference(ref, case):
    ups = UPDATE_CASES[case]
    ref_ups = [ref.formats.EdgeUpdate(*u) if isinstance(u, EdgeUpdate) else u
               for u in ups]
    mine = normalize_edge_updates(ups, n=5)
    theirs = ref.formats.normalize_edge_updates(ref_ups, n=5)
    for a, b in zip(mine, theirs):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)


def test_normalize_edge_updates_random_streams_match_reference(ref):
    rng = np.random.default_rng(12)
    for _ in range(5):
        k = int(rng.integers(0, 200))
        ups = [(int(a), int(b), bool(f)) for a, b, f in
               zip(rng.integers(0, 20, k), rng.integers(0, 20, k),
                   rng.random(k) < 0.5)]
        for a, b in zip(normalize_edge_updates(ups, 20),
                        ref.formats.normalize_edge_updates(ups, 20)):
            np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("bad", [[(0, 9)], [(-1, 2)], [(1,)], [(1, 2, 3, 4)]])
def test_normalize_edge_updates_errors_match_reference(ref, bad):
    with pytest.raises(ValueError) as mine:
        normalize_edge_updates(bad, n=5)
    with pytest.raises(ValueError) as theirs:
        ref.formats.normalize_edge_updates(bad, n=5)
    assert str(mine.value) == str(theirs.value)


def _rows(rng, e, w, n, dense=False):
    """Sorted unique rows of ids below n, in-row sentinels n / n + 1, a few
    whole padding rows (-1 / -2)."""
    def side(fill):
        rows = np.sort(rng.random((e, n)).argsort(axis=1)[:, :w], axis=1)
        deg = rng.integers(0 if not dense else w // 2, w + 1, size=e)
        rows[np.arange(w)[None, :] >= deg[:, None]] = fill
        return rows.astype(np.int32)
    u, v = side(n), side(n + 1)
    u[-2:], v[-2:] = -1, -2
    return u, v


@pytest.mark.parametrize("strategy", ["auto", "broadcast", "probe", "bitmap"])
@pytest.mark.parametrize("e,w,n", [(9, 8, 20), (40, 32, 100), (17, 64, 300),
                                   (5, 130, 2000)])
def test_intersect_matches_both_matches_reference(ref, strategy, e, w, n):
    rng = np.random.default_rng(e * w)
    u, v = _rows(rng, e, w, n, dense=True)
    bits = None if strategy != "bitmap" else ((n + 2 + 31) // 32) * 32
    mu, mv = intersect_matches_both(torch.from_numpy(u), torch.from_numpy(v),
                                    strategy=strategy, bitmap_bits=bits)
    ru, rv = ref.ops.intersect_matches_both(u, v, strategy=strategy,
                                            bitmap_bits=bits)
    np.testing.assert_array_equal(mu.numpy(), np.asarray(ru))
    np.testing.assert_array_equal(mv.numpy(), np.asarray(rv))
    np.testing.assert_array_equal(mu.sum(1).numpy(), mv.sum(1).numpy())


def _key_state(rng, n, m, cap, mode):
    """Two sorted key orderings of m random edges, capacity cap."""
    pairs = set()
    while len(pairs) < m:
        a, b = sorted(int(x) for x in rng.integers(0, n, 2))
        if a != b:
            pairs.add((a, b))
    lo = np.array([p[0] for p in pairs], np.int64)
    hi = np.array([p[1] for p in pairs], np.int64)
    sent = dev_mod.edge_key_sentinel(mode)
    npdt = np.int64 if mode == "wide" else np.int32
    out = []
    for a, b in ((lo, hi), (hi, lo)):
        k = np.full(cap, sent, np.int64)
        k[:m] = np.sort(a * (n + 1) + b)
        out.append(k.astype(npdt))
    return out


@pytest.mark.parametrize("mode", ["int32", "wide"])
def test_dynamic_update_step_matches_reference(ref, mode):
    rng = np.random.default_rng(21)
    n, m, cap, ub, width = 40, 90, 256, 32, 64
    keys, rkeys = _key_state(rng, n, m, cap, mode)
    sent = dev_mod.edge_key_sentinel(mode)
    npdt = keys.dtype
    # half deletes of live edges (some twice-listed as absent), half inserts
    live = keys[:m].astype(np.int64)
    pick = rng.choice(live, 12, replace=False)
    lo_d, hi_d = pick // (n + 1), pick % (n + 1)
    lo_i = rng.integers(0, n - 1, 14)
    hi_i = lo_i + 1 + rng.integers(0, 3, 14)
    hi_i = np.minimum(hi_i, n - 1)
    lo = np.concatenate([lo_d, lo_i]).astype(np.int64)
    hi = np.concatenate([hi_d, hi_i]).astype(np.int64)
    ins = np.concatenate([np.zeros(12, bool), np.ones(14, bool)])
    keep = lo < hi
    lo, hi, ins = lo[keep], hi[keep], ins[keep]
    nu = lo.shape[0]
    upd = np.full(ub, sent, np.int64)
    upd[:nu] = lo * (n + 1) + hi
    rupd = np.full(ub, sent, np.int64)
    rupd[:nu] = hi * (n + 1) + lo
    uins = np.zeros(ub, bool)
    uins[:nu] = ins
    uval = np.zeros(ub, bool)
    uval[:nu] = True
    mine = dev_mod.dynamic_update_step(
        torch.from_numpy(keys), torch.from_numpy(rkeys),
        torch.from_numpy(upd.astype(npdt)), torch.from_numpy(rupd.astype(npdt)),
        torch.from_numpy(uins), torch.from_numpy(uval), n=n, width=width)
    with ref.device.edge_key_context(mode):
        import jax.numpy as jnp
        theirs = ref.device.dynamic_update_step(
            jnp.asarray(keys), jnp.asarray(rkeys), jnp.asarray(upd.astype(npdt)),
            jnp.asarray(rupd.astype(npdt)), jnp.asarray(uins),
            jnp.asarray(uval), n=n, width=width)
        theirs = [np.asarray(x) for x in theirs]
    names = ("new_keys new_rkeys eff_ins eff_del ins_skeys del_skeys "
             "old_lo_rows old_hi_rows old_lo_deg old_hi_deg new_lo_rows "
             "new_hi_rows new_lo_deg new_hi_deg stats").split()
    for what, a, b in zip(names, mine, theirs):
        _same(a, b, f"{mode} {what}")
    assert int(mine[-1][1]) > 0 and int(mine[-1][3]) > 0  # deletes took effect


@pytest.mark.parametrize("bounds", [(8,), (8, 32), (4, 8, 16, 64)])
def test_delta_update_buckets_match_reference(ref, bounds):
    rng = np.random.default_rng(sum(bounds))
    n, ub, top = 70, 24, bounds[-1]
    lo_rows, hi_rows = _rows(rng, ub, top, n)
    hi_rows[hi_rows == n + 1] = n  # anchor rows pad with n on both sides
    hi_rows[hi_rows == -2] = n
    lo_rows[lo_rows == -1] = n
    lo_deg = (lo_rows < n).sum(1).astype(np.int32)
    hi_deg = (hi_rows < n).sum(1).astype(np.int32)
    lo = rng.integers(0, n, ub).astype(np.int32)
    hi = rng.integers(0, n, ub).astype(np.int32)
    valid = rng.random(ub) < 0.8
    args = (lo_rows, hi_rows, lo_deg, hi_deg, lo, hi, valid)
    mine = prep.delta_update_buckets(*(torch.from_numpy(a) for a in args),
                                     n=n, bounds=bounds)
    theirs = ref.prep.delta_update_buckets(*args, n=n, bounds=bounds)
    assert len(mine) == len(theirs) == len(bounds)
    for (w, *arrs), (rw, *rarrs) in zip(mine, theirs):
        assert w == rw
        for a, b in zip(arrs, rarrs):
            _same(a, b, f"class {w}")
