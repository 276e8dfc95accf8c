"""The port's device prep equals the reference's, array by array.

``repro_torch.core.prep.prepare_intersection_buckets_device`` (torch, on
the CPU here) against ``repro.core.prep.prepare_intersection_buckets_device``
(jitted JAX): bucket shapes, u/v lists, endpoints and sentinels, for both
shape policies and both variants, on adversarial graphs (empty, isolated
vertices, star, clique, degree ties) and the R-MAT and grid fixtures; plus
the host twin, the CSR build, the orientation and the key-mode checkpoint.
"""

import numpy as np
import pytest
import torch

from torch_reference import ref  # noqa: F401

from repro_torch.core import prep as port_prep
from repro_torch.graphs import device as port_device
from repro_torch.graphs import generators as port_gen
from repro_torch.graphs.datasets import load_dataset
from repro_torch.graphs.formats import edges_to_csr

CPU = torch.device("cpu")


def _cycle(n):
    return edges_to_csr(np.arange(n), (np.arange(n) + 1) % n, n=n, name=f"cycle{n}")


GRAPHS = {
    "empty": lambda: edges_to_csr([], [], n=6, name="empty6"),
    "isolated": lambda: edges_to_csr([0, 1], [1, 2], n=9, name="isolated9"),
    "star": lambda: port_gen.star_graph(16),
    "clique": lambda: port_gen.complete_graph(9),
    "degree-ties": lambda: _cycle(12),
    "tiny-rmat": lambda: load_dataset("tiny-rmat"),
    "tiny-grid": lambda: load_dataset("tiny-grid"),
    "rmat9": lambda: port_gen.rmat_graph(9, 8),
}
POLICIES = {"pow2": port_device.ShapePolicy(),
            "exact": port_device.ShapePolicy("exact", 1)}


def _ref_graph(ref, g):
    return ref.formats.Graph(n=g.n, row_ptr=g.row_ptr, col_idx=g.col_idx,
                             name=g.name)


@pytest.mark.parametrize("variant", ["filtered", "full"])
@pytest.mark.parametrize("policy", sorted(POLICIES))
@pytest.mark.parametrize("name", list(GRAPHS))
def test_device_buckets_match_reference(ref, name, policy, variant):
    g = GRAPHS[name]()
    pol = POLICIES[policy]
    ref_pol = ref.device.ShapePolicy(pol.edge_rounding, pol.min_edges)
    got = port_prep.prepare_intersection_buckets_device(
        g, variant=variant, policy=pol, device=CPU)
    want = ref.prep.prepare_intersection_buckets_device(
        _ref_graph(ref, g), variant=variant, policy=ref_pol)
    assert [b.shape for b in got] == [b.shape for b in want]
    for gb, wb in zip(got, want):
        assert gb.width == wb.width and gb.edges == wb.edges
        for field in ("u_lists", "v_lists", "src", "dst"):
            a = getattr(gb, field)
            assert a.dtype == torch.int32 and a.device == CPU
            np.testing.assert_array_equal(a.numpy(), np.asarray(getattr(wb, field)),
                                          err_msg=field)
        # sentinels: whole padding rows -1 / -2; in-row u pads n, v n + 1
        e = gb.edges
        assert (gb.u_lists[e:] == -1).all() and (gb.v_lists[e:] == -2).all()
        assert not (gb.u_lists[:e] == g.n + 1).any()
        assert not (gb.v_lists[:e] == g.n).any()


@pytest.mark.parametrize("variant", ["filtered", "full"])
@pytest.mark.parametrize("name", list(GRAPHS))
def test_host_twin_matches_reference_and_device(ref, name, variant):
    g = GRAPHS[name]()
    host = port_prep.prepare_intersection_buckets_host(g, variant=variant)
    want = ref.prep.prepare_intersection_buckets_host(_ref_graph(ref, g),
                                                      variant=variant)
    dev = port_prep.prepare_intersection_buckets_device(
        g, variant=variant, policy=POLICIES["exact"], device=CPU)
    assert [b["width"] for b in host] == [b["width"] for b in want]
    assert [b["width"] for b in host] == [b.width for b in dev]
    for hb, wb, db in zip(host, want, dev):
        for field in ("u_lists", "v_lists", "src", "dst"):
            np.testing.assert_array_equal(hb[field], wb[field], err_msg=field)
            np.testing.assert_array_equal(getattr(db, field).numpy(), hb[field],
                                          err_msg=field)


def test_variant_is_validated():
    g = port_gen.complete_graph(4)
    with pytest.raises(ValueError, match="unknown variant"):
        port_prep.prepare_intersection_buckets_device(g, variant="x", device=CPU)
    with pytest.raises(ValueError, match="unknown variant"):
        port_prep.prepare_intersection_buckets_host(g, variant="x")


@pytest.mark.parametrize("name", ["clique", "tiny-rmat", "rmat9"])
def test_device_graph_matches_reference(ref, name):
    g = GRAPHS[name]()
    dg = port_device.DeviceGraph.from_graph(g, device=CPU)
    rdg = ref.device.DeviceGraph.from_graph(_ref_graph(ref, g))
    np.testing.assert_array_equal(dg.csr.col_idx.numpy(), np.asarray(rdg.csr.col_idx))
    np.testing.assert_array_equal(dg.edge_sources().numpy(),
                                  np.asarray(rdg.edge_sources()))
    f, rf = dg.forward(), rdg.forward()
    assert f.m == rf.m
    for field in ("src", "dst", "kvalid", "row_ptr", "degrees"):
        np.testing.assert_array_equal(getattr(f, field).numpy(),
                                      np.asarray(getattr(rf, field)), err_msg=field)
    for width in (4, 64):
        for oriented in (True, False):
            np.testing.assert_array_equal(
                dg.padded_neighbors(width, oriented=oriented).numpy(),
                np.asarray(rdg.padded_neighbors(width, oriented=oriented)))


def test_csr_from_edges_matches_reference(ref):
    rng = np.random.default_rng(5)
    n = 60
    key = np.unique(rng.integers(0, n, 400) * n + rng.integers(0, n, 400))
    src, dst = key // n, key % n
    perm = rng.permutation(src.shape[0])  # unsorted input
    src, dst = src[perm], dst[perm]
    valid = rng.random(src.shape[0]) < 0.8
    got = port_device.DeviceCSR.from_edges(src, dst, n, valid=valid, device=CPU)
    want = ref.device.DeviceCSR.from_edges(src, dst, n, valid=valid)
    assert got.m == want.m and got.m_pad == want.m_pad
    np.testing.assert_array_equal(got.row_ptr.numpy(), np.asarray(want.row_ptr))
    np.testing.assert_array_equal(got.col_idx.numpy(), np.asarray(want.col_idx))
    with pytest.raises(port_device.GraphTooLargeError):
        port_device.DeviceCSR.from_edges(src, dst, 46340, key_mode="int32",
                                         device=CPU)


@pytest.mark.parametrize("key_mode", ["auto", "int32", "wide", "bogus"])
def test_edge_key_mode_flip_matches_reference(ref, key_mode):
    for n in (0, 46339, 46340, 46341, 2 ** 31, 2 ** 32):
        outcomes = []
        for mod in (port_device, ref.device):
            try:
                outcomes.append(mod.resolve_edge_key_mode(n, key_mode, lane="edge"))
            except ValueError as e:  # GraphTooLargeError is a ValueError
                outcomes.append((type(e).__name__, str(e)))
        assert outcomes[0] == outcomes[1], n
        assert port_device.fits_int32_pair_keys(n) == ref.device.fits_int32_pair_keys(n)
    assert port_device.fits_int32_pair_keys(46339)
    assert not port_device.fits_int32_pair_keys(46340)
    assert issubclass(port_device.GraphTooLargeError, ValueError)


def test_shape_policy_matches_reference(ref):
    for args in ((), ("exact",), ("pow2", 16), ("exact", 3)):
        p, r = port_device.ShapePolicy(*args), ref.device.ShapePolicy(*args)
        assert p.key() == r.key()
        for c in (0, 1, 7, 8, 9, 1000, 4097):
            assert p.round_edges(c) == r.round_edges(c)
    for bad in (("nope",), ("pow2", 0), ("pow2", True)):
        with pytest.raises(ValueError) as pe:
            port_device.ShapePolicy(*bad)
        with pytest.raises(ValueError) as re_:
            ref.device.ShapePolicy(*bad)
        assert str(pe.value) == str(re_.value)
    for x in (0, 1, 2, 3, 1023, 1024, 1025):
        assert port_device.next_pow2(x) == ref.device.next_pow2(x)
