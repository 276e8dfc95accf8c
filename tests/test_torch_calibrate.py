"""The port's measured chooser equals the reference's on the CPU.

``repro_torch.core.calibrate`` against ``repro.core.calibrate``: graph
fingerprints, feature bins, ``CalibrationTable`` merges and picks from
timings the test sets (nearest-bin fallback and ties included), sidecars
read in both directions, the schema check, the corrupt-sidecar fallback,
the process-wide chooser hooks, ``CountOptions(chooser=...)``, the H100
pricing of ``launch.roofline`` (deterministic, positive, launches
nothing) and a ``calibrate`` smoke that checks structure only. No test
here compares lanes by wall clock. Also the deprecated ``triangle_count_*``
shims: the reference's warning and count.
"""

import importlib
import json
import math
import os
import sys

import numpy as np
import pytest
import torch

from torch_reference import ref  # noqa: F401

from repro_torch.core import (
    CHOOSERS,
    CalibrationTable,
    CountOptions,
    TriangleCounter,
    analytic_seed,
    available_algorithms,
    calibrate,
    choose_algorithm,
    choose_measured,
    graph_fingerprint,
    install_measured_chooser,
    load_table,
    save_table,
    set_auto_chooser,
    set_default_table,
    triangle_count_intersection,
    triangle_count_matrix,
    triangle_count_scipy,
    triangle_count_subgraph,
)
from repro_torch.core import registry
from repro_torch.graphs import (
    available_datasets,
    complete_graph,
    erdos_renyi_graph,
    grid_graph,
    load_dataset,
    path_graph,
    rmat_graph,
    star_graph,
)
from repro_torch.kernels.intersect import LAUNCHES
from repro_torch.kernels.masked_spgemm import LAUNCHES as MS_LAUNCHES
from repro_torch.kernels.hash_tc import LAUNCHES as HASH_LAUNCHES
from repro_torch.launch import roofline

# ``repro_torch.core.calibrate`` is the function the package re-exports;
# the module is reached through the import system, as in the reference
cal = importlib.import_module("repro_torch.core.calibrate")

CPU = "cpu"

GENERATED = {
    "rmat9": lambda: rmat_graph(9, 8, seed=3),
    "rmat7": lambda: rmat_graph(7, 6, seed=7, name="rmat7-sweep"),
    "clique32": lambda: complete_graph(32),
    "clique600": lambda: complete_graph(600),
    "star40": lambda: star_graph(40),
    "grid12": lambda: grid_graph(12, diagonals=True, spur_fraction=0.3,
                                 seed=4),
    "path9": lambda: path_graph(9),
    "er": lambda: erdos_renyi_graph(300, 12.0, seed=5),
    "empty": lambda: rmat_graph(3, 0, seed=0),
}


def _ref_graph(ref, g):
    return ref.formats.Graph(n=g.n, row_ptr=g.row_ptr, col_idx=g.col_idx,
                             name=g.name)


def _all_graphs():
    return [load_dataset(n) for n in available_datasets()] \
        + [f() for f in GENERATED.values()]


@pytest.fixture
def clean_chooser():
    """Restore the process-wide table and chooser after a test."""
    prev_table = cal._DEFAULT_TABLE, cal._DEFAULT_LOADED
    prev_chooser = registry._CHOOSER
    env = os.environ.get("TC_CALIB")
    yield
    cal._DEFAULT_TABLE, cal._DEFAULT_LOADED = prev_table
    registry._CHOOSER = prev_chooser
    if env is None:
        os.environ.pop("TC_CALIB", None)
    else:
        os.environ["TC_CALIB"] = env


# --- fingerprints and feature bins ------------------------------------------


@pytest.mark.parametrize("name", sorted(available_datasets()))
def test_fingerprint_and_bins_match_reference_on_datasets(ref, name):
    g = load_dataset(name)
    rg = ref.datasets.load_dataset(name)
    assert np.array_equal(g.row_ptr, rg.row_ptr)
    assert np.array_equal(g.col_idx, rg.col_idx)
    assert graph_fingerprint(g) == ref.api.graph_fingerprint(rg)
    assert cal.graph_features(g) == ref.calibrate.graph_features(rg)
    assert cal.feature_key(cal.graph_features(g)) == \
        ref.calibrate.feature_key(ref.calibrate.graph_features(rg))


@pytest.mark.parametrize("name", sorted(GENERATED))
def test_fingerprint_and_bins_match_reference_on_generators(ref, name):
    g = GENERATED[name]()
    rg = _ref_graph(ref, g)
    fp = graph_fingerprint(g)
    assert fp == ref.api.graph_fingerprint(rg)
    assert len(fp) == 32 and int(fp, 16) >= 0
    assert cal.graph_features(g) == ref.calibrate.graph_features(rg)
    key = cal.feature_key(cal.graph_features(g))
    assert key == ref.calibrate.feature_key(ref.calibrate.graph_features(rg))
    w, skew, dens = key
    assert w.startswith("w:") and int(w[2:]) >= 0
    assert skew in ("skew:low", "skew:mid", "skew:high")
    assert dens in ("dens:thin", "dens:sparse", "dens:dense")


def test_fingerprint_ignores_name_and_sees_content():
    g = rmat_graph(6, 6, seed=2)
    same = rmat_graph(6, 6, seed=2, name="other")
    assert graph_fingerprint(g) == graph_fingerprint(same)
    assert graph_fingerprint(g) != graph_fingerprint(rmat_graph(6, 6, seed=3))


# --- the table: merges and picks ---------------------------------------------

# bins the graphs below land in, and a far one for the nearest-bin fallback
_BINS = [("w:8", "skew:low", "dens:sparse"),
         ("w:128", "skew:mid", "dens:sparse"),
         ("w:32", "skew:low", "dens:dense"),
         ("w:2048", "skew:high", "dens:thin")]

# (bin index, timings, source), applied in order to both packages' tables
_RECORDS = [
    (0, {"intersection": 3e-4, "subgraph": 2e-4, "matrix": 9e-4}, "analytic"),
    (0, {"intersection": 1e-4, "subgraph": 2e-4, "hash": 5e-4}, "measured"),
    (0, {"intersection": 9e-9, "subgraph": 9e-9}, "analytic"),  # ignored
    (0, {"subgraph": 5e-5, "bfs": 7e-4}, "measured"),  # per-lane minimum
    (1, {"intersection": 4e-4, "hash": 4e-4, "matrix": 8e-4}, "measured"),
    (2, {"matrix": 1e-5, "intersection": 2e-5}, "analytic"),
    (3, {"bfs": 1e-3, "hash": 2e-3}, "measured"),
]


def _tables(ref, records=_RECORDS):
    mine = CalibrationTable(device="test")
    theirs = ref.calibrate.CalibrationTable(device="test")
    for i, timings, source in records:
        mine.record(_BINS[i], timings, source)
        theirs.record(_BINS[i], timings, source)
    return mine, theirs


def test_record_merges_like_reference(ref):
    mine, theirs = _tables(ref)
    assert mine.entries == theirs.entries
    assert mine.sources == theirs.sources
    assert mine.entries[_BINS[0]] == {"intersection": 1e-4, "subgraph": 5e-5,
                                      "hash": 5e-4, "bfs": 7e-4}
    assert mine.sources[_BINS[0]] == "measured"
    assert mine.sources[_BINS[2]] == "analytic"


def test_choose_matches_reference_with_ties_and_nearest_bin(ref):
    mine, theirs = _tables(ref)
    # a tie in bin 1 breaks lexicographically: "hash" before "intersection"
    picks = {}
    for g in _all_graphs():
        want = theirs.choose(_ref_graph(ref, g))
        assert mine.choose(g) == want, g.name
        assert mine.lookup(g) == theirs.lookup(_ref_graph(ref, g)), g.name
        assert choose_measured(g, mine) == \
            ref.calibrate.choose_measured(_ref_graph(ref, g), theirs), g.name
        picks[cal.feature_key(cal.graph_features(g))] = want
    assert picks[_BINS[1]] == "hash"
    # a bin no record visited takes its nearest bin's pick
    assert any(k not in mine.entries for k in picks)
    assert CalibrationTable(device="x").choose(rmat_graph(6, 6, seed=1)) \
        is None


def test_unregistered_lane_falls_back_to_heuristic(ref):
    g = rmat_graph(7, 6, seed=7)
    t = CalibrationTable(device="x")
    t.record(cal.feature_key(cal.graph_features(g)),
             {"no-such-lane": 1e-6}, "measured")
    rt = ref.calibrate.CalibrationTable(device="x")
    rt.record(cal.feature_key(cal.graph_features(g)),
              {"no-such-lane": 1e-6}, "measured")
    assert choose_measured(g, t) == registry._default_chooser(g) == \
        ref.calibrate.choose_measured(_ref_graph(ref, g), rt)


# --- sidecars ----------------------------------------------------------------


def test_sidecars_load_in_both_directions(ref, tmp_path):
    mine, theirs = _tables(ref)
    theirs_path = ref.calibrate.save_table(theirs,
                                           str(tmp_path / "CALIB_ref.json"))
    mine_path = save_table(mine, str(tmp_path / "CALIB_port.json"))
    from_ref = load_table(theirs_path)
    from_port = ref.calibrate.load_table(mine_path)
    assert from_ref.entries == mine.entries == from_port.entries
    assert from_ref.sources == mine.sources == from_port.sources
    assert from_ref.device == from_port.device == "test"
    a, b = json.load(open(theirs_path)), json.load(open(mine_path))
    a.pop("created_unix"), b.pop("created_unix")
    assert a == b
    for g in _all_graphs():
        assert from_ref.choose(g) == mine.choose(g) == \
            from_port.choose(_ref_graph(ref, g)), g.name


def test_bad_sidecars_raise(tmp_path):
    path = tmp_path / "CALIB_bad.json"
    path.write_text(json.dumps({"schema": 2, "device": "x", "entries": []}))
    with pytest.raises(ValueError, match="has schema 2"):
        load_table(str(path))
    path.write_text(json.dumps({"schema": 1, "device": "x", "entries": [
        {"key": ["w:8", "skew:low"], "timings": {}, "source": "measured"}]}))
    with pytest.raises(ValueError, match="malformed entry key"):
        load_table(str(path))


def test_corrupt_sidecar_falls_back_to_heuristic(clean_chooser, tmp_path):
    g = load_dataset("tiny-grid")
    for text in ("{not json", json.dumps({"schema": 99}),
                 json.dumps({"schema": 1, "entries": [{"key": ["a"]}]})):
        path = tmp_path / "CALIB_corrupt.json"
        path.write_text(text)
        os.environ["TC_CALIB"] = str(path)
        set_default_table(None)
        assert cal.get_default_table() is None
        assert choose_measured(g) == choose_algorithm(g) == "subgraph"
    os.environ["TC_CALIB"] = str(tmp_path / "CALIB_missing.json")
    set_default_table(None)
    assert choose_measured(g) == "subgraph"
    # a good sidecar at the same path is read on the next search
    t = CalibrationTable(device="x")
    t.record(cal.feature_key(cal.graph_features(g)), {"bfs": 1e-6},
             "measured")
    save_table(t, os.environ["TC_CALIB"])
    set_default_table(None)
    assert choose_measured(g) == "bfs"


# --- wiring ------------------------------------------------------------------


def test_chooser_hooks_swap_and_restore(clean_chooser):
    g = load_dataset("tiny-rmat")
    assert choose_algorithm(g) == "intersection"
    t = CalibrationTable(device="x")
    t.record(cal.feature_key(cal.graph_features(g)),
             {"hash": 1e-6, "intersection": 1e-3}, "measured")
    prev = install_measured_chooser(t)
    try:
        assert choose_algorithm(g) == "hash"
        assert TriangleCounter(g, device=CPU).algorithm == "hash"
    finally:
        assert set_auto_chooser(prev) is not registry._default_chooser
    assert choose_algorithm(g) == "intersection"
    prev = set_auto_chooser(lambda _g: "nope")
    try:
        with pytest.raises(ValueError, match="unregistered lane 'nope'"):
            choose_algorithm(g)
    finally:
        set_auto_chooser(None)
    assert registry._CHOOSER is registry._default_chooser


def test_measured_option_routes_auto_through_the_table(clean_chooser, ref):
    graphs = [load_dataset("tiny-rmat"), load_dataset("tiny-grid"),
              complete_graph(32)]
    t = CalibrationTable(device="x")
    for g, lane in zip(graphs, ("bfs", "hash", "subgraph")):
        t.record(cal.feature_key(cal.graph_features(g)),
                 {lane: 1e-6, "intersection": 1e-3}, "measured")
    prev = set_default_table(t)
    assert prev is None or isinstance(prev, CalibrationTable)
    for g, lane in zip(graphs, ("bfs", "hash", "subgraph")):
        tc = TriangleCounter(g, CountOptions(chooser="measured"), device=CPU)
        assert tc.algorithm == lane
        assert tc.count() == triangle_count_scipy(g)
        # the heuristic chooser ignores the table
        assert TriangleCounter(g, device=CPU).algorithm == \
            ref.registry.choose_algorithm(_ref_graph(ref, g))
    # count_many resolves each graph through the same table
    tc = TriangleCounter(graphs[0], CountOptions(chooser="measured"),
                         device=CPU)
    res = tc.count_many(graphs, batch_size=4)
    assert [r.algorithm for r in res] == ["bfs", "hash", "subgraph"]
    assert [int(r) for r in res] == [triangle_count_scipy(g) for g in graphs]


def test_chooser_option_validates_like_reference(ref):
    assert CHOOSERS == ref.options.CHOOSERS
    with pytest.raises(ValueError) as mine:
        CountOptions(chooser="fastest")
    with pytest.raises(ValueError) as theirs:
        ref.options.CountOptions(chooser="fastest")
    assert str(mine.value) == str(theirs.value)
    a, b = CountOptions(), CountOptions(chooser="measured")
    assert a.key() != b.key() and a.key() == CountOptions().key()
    assert b == CountOptions(chooser="measured")


def test_device_label_and_path():
    assert cal.device_label("cpu") == "cpu"
    if not torch.cuda.is_available():
        assert cal.device_label() == "cpu"
    assert cal.calib_path("d", "NVIDIA-H100") == \
        os.path.join("d", "CALIB_NVIDIA-H100.json")


# --- analytic pricing ---------------------------------------------------------


def _launch_total():
    return (sum(LAUNCHES.values()) + sum(MS_LAUNCHES.values())
            + sum(HASH_LAUNCHES.values()))


@pytest.mark.parametrize("name", ["tiny-rmat", "tiny-grid", "coauthors-like"])
def test_price_plan_deterministic_positive_launch_free(name):
    g = load_dataset(name)
    before = _launch_total()
    a = analytic_seed(g, cal.CHOOSER_LANES, CountOptions(), device=CPU)
    b = analytic_seed(g, cal.CHOOSER_LANES, CountOptions(), device=CPU)
    assert set(a) == set(cal.CHOOSER_LANES)
    assert a == b  # bit-equal floats
    for lane, t in a.items():
        assert t > 0.0 and math.isfinite(t), lane
    plan = registry.get_algorithm("matrix")(g, CountOptions(), device=CPU)
    assert cal.price_plan(plan) == cal.price_plan(plan) > 0.0
    assert _launch_total() == before


def test_stage_prices_follow_the_bound_model():
    # K1-K3: 2·E·W·4 + 4·E bytes; 2·E·W compares at 67 T/s
    c = roofline.stage_cost("intersection", (1 << 20, 8))
    assert c.bytes == 2 * (1 << 20) * 8 * 4 + 4 * (1 << 20)
    assert c.operations == 2 * (1 << 20) * 8
    assert c.seconds == c.bytes / 3.35e12 and c.bound_by == "bytes"
    # K4 on bf16 tiles: operations at 989 TFLOP/s, fp32 at 67
    k4 = roofline.stage_cost("matrix", (1000, 128, 128),
                             dtype=torch.bfloat16, resident_bytes=10 ** 6)
    assert k4.operations == 2 * 1000 * 128 ** 3
    assert k4.t_compute == k4.operations / 989e12 and k4.bound_by == \
        "operations"
    f32 = roofline.stage_cost("matrix", (1000, 128, 128),
                              dtype=torch.float32, resident_bytes=10 ** 6)
    assert f32.t_compute == k4.operations / 67e12
    # K5: a probe a slot times the mean chain length
    k5 = roofline.stage_cost("hash", (100, 8, 16, 4), resident_bytes=400,
                             table_ids=30, table_chains=10)
    assert k5.operations == 100 * 8 * 3
    # a tiled stage: the chunk's price times the chunks
    tiled = roofline.stage_cost("intersection", (1 << 10, 32), launches=7)
    one = roofline.stage_cost("intersection", (1 << 10, 32))
    assert tiled.bytes == 7 * one.bytes and tiled.launches == 7
    with pytest.raises(ValueError, match="unknown stage kind"):
        roofline.stage_cost("vertex", (1, 1))


def test_tiled_plan_priced_as_its_chunks():
    g = load_dataset("coauthors-like")
    opts = CountOptions(algorithm="intersection", max_device_bytes=1 << 16)
    tiled = registry.get_algorithm("intersection")(g, opts, device=CPU)
    chunks = tiled.meta["num_chunks"]
    assert chunks > 1
    prices = [roofline.price_stage(st) for st in tiled.stages]
    assert sum(p.launches for p in prices) >= chunks
    assert cal.price_plan(tiled) > 0.0


def test_calibrate_smoke_structure(clean_chooser, tmp_path):
    graphs = [load_dataset("tiny-rmat"), load_dataset("tiny-grid"),
              complete_graph(32)]
    table = calibrate(graphs, iters=1, warmup=0, device=CPU)
    assert table.device == "cpu" and table.schema == cal.CALIB_SCHEMA_VERSION
    assert set(table.sources.values()) == {"measured"}
    assert len(table.entries) == 3
    for timings in table.entries.values():
        assert set(timings) == set(cal.CHOOSER_LANES)
        assert all(t > 0.0 and math.isfinite(t) for t in timings.values())
    for g in graphs:
        assert choose_measured(g, table) in available_algorithms()
    # analytic entries never overwrite measured ones
    seeded = calibrate(graphs, measure=False, device=CPU, label="seed")
    assert seeded.device == "seed"
    assert set(seeded.sources.values()) == {"analytic"}
    for key in seeded.entries:
        table.record(key, seeded.entries[key], "analytic")
    assert set(table.sources.values()) == {"measured"}
    path = save_table(table, str(tmp_path / cal.calib_path(".", "cpu")))
    assert load_table(path).entries == table.entries


# --- the deprecated shims -----------------------------------------------------


_SHIMS = {
    "intersection": (triangle_count_intersection, dict(strategy="probe")),
    "matrix": (triangle_count_matrix, dict(block=32)),
    "subgraph": (triangle_count_subgraph, {}),
}


@pytest.mark.parametrize("lane", sorted(_SHIMS))
def test_shims_warn_and_count_like_reference(ref, lane):
    g = load_dataset("tiny-rmat")
    shim, kw = _SHIMS[lane]
    ref_shim = {"intersection": ref.tc_intersection.triangle_count_intersection,
                "matrix": ref.tc_matrix.triangle_count_matrix,
                "subgraph": ref.tc_subgraph.triangle_count_subgraph}[lane]
    with pytest.warns(DeprecationWarning) as mine:
        got = shim(g, device=CPU, **kw)
    with pytest.warns(DeprecationWarning) as theirs:
        want = ref_shim(_ref_graph(ref, g), **kw)
    assert isinstance(got, int)
    assert got == want == triangle_count_scipy(g)
    assert str(mine[0].message) == str(theirs[0].message)


def test_subgraph_shim_stats_like_reference(ref):
    g = grid_graph(10, diagonals=True, spur_fraction=0.4, seed=2)
    with pytest.warns(DeprecationWarning):
        got = triangle_count_subgraph(g, return_stats=True, device=CPU)
    with pytest.warns(DeprecationWarning):
        want = ref.tc_subgraph.triangle_count_subgraph(_ref_graph(ref, g),
                                                       return_stats=True)
    assert got == want


def test_prepare_intersection_buckets_like_reference(ref):
    from repro_torch.core import prepare_intersection_buckets

    g = rmat_graph(7, 6, seed=1)
    mine = prepare_intersection_buckets(g)
    theirs = ref.tc_intersection.prepare_intersection_buckets(
        _ref_graph(ref, g))
    assert len(mine) == len(theirs)
    for a, b in zip(mine, theirs):
        assert set(a) == set(b)
        for k in a:
            np.testing.assert_array_equal(np.asarray(a[k]), np.asarray(b[k]))


def test_calibrate_module_reached_through_import_system():
    assert sys.modules["repro_torch.core.calibrate"] is cal
    assert cal.calibrate is calibrate
