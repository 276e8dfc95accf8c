"""The harness on the CPU: ``BENCHMARK.json`` against the contract, the
result line, the metric readers, the roofline arithmetic, the trace
reduction, and whole runs at a small size with the timed path sound and
broken underneath.
"""

from __future__ import annotations

import dataclasses
import json
import re
import time

import pytest
import torch

from tcbench import harness, spec
from tcbench.roofline import count_bound_bytes, count_bound_seconds, peak_for
from tcbench.trace import (TraceSummary, busy_intervals, idle_gaps,
                           label_gaps, summarise, top_level)

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.\-]{1,16}$")
SOURCES = {"device_trace", "program_span", "program_counter", "host_clock"}
SMALL = {"graph500-s19": {"scale": 8, "edge_factor": 16, "a": 0.57,
                          "b": 0.19, "c": 0.19, "permute": True},
         "rgg-n24": {"log2_n": 11, "radius_factor": 0.55}}


@pytest.fixture(scope="module")
def bench():
    return spec.bench_spec()


def _line_ok(text, limit=200):
    return isinstance(text, str) and 1 <= len(text) <= limit \
        and "\n" not in text and "\t" not in text


def test_benchmark_json_keys_and_names(bench):
    assert set(bench) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    assert bench["paths"] == ["tcbench"]
    assert bench["command"][1] == "tcbench/run.py"
    assert 1 <= bench["run_seconds"] <= 51
    assert len((spec.ROOT / "BENCHMARK.json").read_bytes()) <= 64 * 1024
    names = [c["name"] for c in bench["configs"]] + \
        [w["name"] for w in bench["workloads"]] + \
        [m["name"] for m in bench["end_to_end"] + bench["per_layer"]]
    assert len(names) == len(set(names))
    assert all(NAME.match(n) for n in names)


def test_configs_and_cells_are_files(bench):
    used = set()
    for c in bench["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert _line_ok(c["source"]) and _line_ok(c["why"])
        assert c["file"] == f"tcbench/configs/{c['name']}.json"
        assert (spec.ROOT / c["file"]).is_file()
        assert all(NAME.match(k) for k in c["reduced"])
        cfg = spec.load_config(c["name"])
        assert spec.load_named("generators", cfg["generator"]) is not None
        assert spec.load_named("references", cfg["reference"]) is not None
    pairs = set()
    for w in bench["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert w["chips"] in (1, 4) and _line_ok(w["why"])
        assert w["name"] == f"{w['config']}.{w['traffic']}"
        assert (w["config"], w["traffic"]) not in pairs
        pairs.add((w["config"], w["traffic"]))
        used.add(w["config"])
        spec.load_mix(w["traffic"])
    assert used == {c["name"] for c in bench["configs"]}
    four = sum(w["chips"] == 4 for w in bench["workloads"])
    assert four <= max(1, len(bench["workloads"]) // 4)


def test_metrics_follow_the_contract(bench):
    cells = {w["name"] for w in bench["workloads"]}
    e2e = {m["name"] for m in bench["end_to_end"]}
    assert "setup_s" in e2e
    for m in bench["end_to_end"]:
        assert set(m) <= {"name", "unit", "better", "bound", "source",
                          "workloads"}
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    assert next(m for m in bench["end_to_end"]
                if m["name"] == "setup_s")["bound"] <= 0.25
    for m in bench["per_layer"]:
        assert set(m) <= {"name", "unit", "better", "source", "layer",
                          "moves", "workloads"}
        assert m["moves"] in e2e and _line_ok(m["layer"])
        assert m["source"] in SOURCES
        assert set(m.get("workloads", cells)) <= cells
        if "roofline" in m["name"]:
            assert m["name"].endswith("_roofline") and m["unit"] == "%"
    for m in bench["end_to_end"] + bench["per_layer"]:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
        assert spec.load_named("metrics", m["name"]) is not None
    for cell in cells:  # every cell: setup_s, another end-to-end, a layer
        assert len(spec.metrics_for(bench, cell, False)) >= 2
        assert spec.metrics_for(bench, cell, True)


def _run(**over):
    base = dict(
        workload="g.warm", config="g", traffic="warm", mode="resident",
        seed=1, n=9, m_undirected=1000, setup_s=12.5, window_s=2.0,
        latencies_s=[0.001 * (i + 1) for i in range(100)],
        exec_s=[0.001 * (i + 1) - 20e-6 for i in range(100)],
        prep_s=[0.4], counts=[5] * 100, lanes=["intersection"],
        launches={"intersect.probe": 200, "intersect.broadcast": 200},
        failed=0, session_peak_bytes=3 * 2**30, process_peak_bytes=4 * 2**30,
        device_kind="NVIDIA H100 80GB HBM3",
        peaks=peak_for("NVIDIA H100 80GB HBM3"),
        trace=TraceSummary(window_s=2.0, busy_s=1.5, device_ops=[["k", 1.5]],
                           idle_gaps=[["count: python", 0.5]]),
        setup_phases={"imports": 10.0}, reference=5, reference_s=0.1)
    base.update(over)
    return harness.Run(**base)


def _read(name, run):
    return spec.load_named("metrics", name).read(run)


def test_readers_on_a_fabricated_run():
    run = _run()
    assert _read("count_edges_per_s", run) == pytest.approx(1000 * 100 / 2.0)
    assert _read("count_p95_ms", run) == pytest.approx(95.05)
    assert _read("peak_gib", run) == 3.0
    assert _read("setup_s", run) == 12.5
    assert _read("api_overhead_us", run) == pytest.approx(20.0)
    assert _read("launches_per_count", run) == 4.0
    assert _read("prep_s", run) == 0.4
    assert _read("device_idle_pct", run) == pytest.approx(25.0)
    bound = count_bound_seconds(9, 1000, 3.35e12)
    assert _read("count_roofline", run) == pytest.approx(
        bound / (1.5 / 100) * 100)
    assert _read("solve_s", run) is None
    assert _read("solve_s", _run(mode="fresh")) == pytest.approx(0.0505)


def test_readers_that_find_nothing_return_none():
    run = _run(trace=None, counts=[], latencies_s=[], exec_s=[], prep_s=[],
               device_kind=None, peaks=None)
    for name in ("count_edges_per_s", "count_p95_ms", "peak_gib",
                 "api_overhead_us", "launches_per_count", "prep_s",
                 "device_idle_pct", "count_roofline"):
        assert _read(name, run) is None, name
    assert _read("count_roofline", _run(mode="fresh")) is None


def test_roofline_bytes_counted_by_hand():
    # a triangle plus a pendant vertex: n = 4, 4 undirected edges; the
    # forward CSR holds 4 ids and 5 row offsets, 4 bytes each
    assert count_bound_bytes(4, 4) == 4 * 4 + 4 * 5 == 36
    assert count_bound_seconds(4, 4, 3.35e12) == pytest.approx(36 / 3.35e12)
    # scale 18: about 16.3 MB, 4.9 us at 3.35 TB/s
    assert count_bound_seconds(262144, 3805452, 3.35e12) == pytest.approx(
        4.857e-6, rel=1e-3)
    with pytest.raises(KeyError):
        peak_for("no such card")


def test_result_line_matches_the_contract():
    run = _run()
    compared = harness.checks(run)
    dev = harness.device_record(run, 1)
    line = harness.result_line(
        harness.is_correct(run, compared), 100, 0,
        {"count_p95_ms": {"value": 95.05, "unit": "ms"}}, dev, compared,
        {"device_ops": run.trace.device_ops,
         "idle_gaps": run.trace.idle_gaps})
    assert "\n" not in line
    out = json.loads(line)
    assert list(out) == ["correct", "attempted", "failed", "metrics",
                         "device", "breakdown", "checks"]
    assert out["correct"] is True and out["attempted"] == 100
    assert out["device"]["platform"] == "gpu"
    assert out["device"]["kind"] == "NVIDIA H100 80GB HBM3"
    assert out["device"]["count"] == 1
    assert out["device"]["memory_peak_bytes"] == 4 * 2**30
    assert out["device"]["busy_s"] == 1.5 and out["device"]["window_s"] == 2.0
    assert all(len(v) <= 10 for v in out["breakdown"].values())
    assert out["checks"]["wrong_counts"] == {"value": 0, "limit": 0}
    untraced = json.loads(harness.result_line(
        True, 1, 0, {}, harness.device_record(_run(trace=None), 1), compared))
    assert "breakdown" not in untraced and "busy_s" not in untraced["device"]


def test_checks_catch_a_wrong_count_and_a_failed_call():
    wrong = _run(counts=[5] * 99 + [6])
    compared = harness.checks(wrong)
    assert compared["wrong_counts"]["value"] == 1
    assert compared["max_abs_err"]["value"] == 1
    assert not harness.is_correct(wrong, compared)
    failed = _run(failed=1)
    assert not harness.is_correct(failed, harness.checks(failed))
    empty = _run(counts=[])
    assert not harness.is_correct(empty, harness.checks(empty))


def test_the_float32_control_is_not_correct_through_the_checks():
    """The control in the program's place: K_470's per-edge counts summed
    in float32 miss C(470, 3) > 2**24, and the run's checks say so."""
    from tcbench.references import triangles
    k = 470
    rows = [[j for j in range(k) if j != i] for i in range(k)]
    row_ptr = [0]
    for r in rows:
        row_ptr.append(row_ptr[-1] + len(r))
    col_idx = [j for r in rows for j in r]
    exact = k * (k - 1) * (k - 2) // 6
    control = triangles.count_float32(row_ptr, col_idx, torch.device("cpu"))
    run = _run(counts=[control] * 3, reference=exact)
    compared = harness.checks(run)
    assert compared["max_abs_err"]["value"] == abs(control - exact) > 0
    assert compared["wrong_counts"]["value"] == 3
    assert not harness.is_correct(run, compared)


def test_each_mix_names_a_loop_that_is_a_file():
    for path in sorted((spec.BENCH_DIR / "mixes").glob("*.json")):
        mix = spec.load_mix(path.stem)
        loop = spec.load_named("loops", mix["loop"])
        assert loop is not None and callable(loop.measure), path.name
    assert spec.load_named("loops", "no_such_loop") is None


def test_launch_counters_find_every_kernel_package():
    from tcbench.loop import launch_counters
    packages = {k.split(".", 1)[0] for k in launch_counters()}
    assert {"intersect", "masked_spgemm", "hash_tc"} <= packages


def test_trace_reduction():
    dev = [(10, 20, "k1"), (15, 30, "k2"), (40, 50, "k1"), (90, 120, "k2")]
    busy = busy_intervals([(s, e) for s, e, _ in dev], 0, 100)
    assert busy == [(10, 30), (40, 50), (90, 100)]
    assert idle_gaps(busy, 0, 100) == [(0, 10), (30, 40), (50, 90)]
    assert top_level([(0, 10, "a"), (2, 5, "b"), (10, 12, "c")]) == \
        [(0, 10, "a"), (10, 12, "c")]
    labels = label_gaps([(0, 10), (30, 40), (50, 90)],
                        marks=[(25, 60, "count")],
                        host_ops=[(28, 45, "aten::item"), (30, 31, "x")])
    assert labels == pytest.approx({"harness: python": 50e-9,
                                    "count: aten::item": 10e-9})
    s = summarise(dev, (0, 100), [(25, 60, "count")], [])
    assert s.window_s == pytest.approx(100e-9)
    assert s.busy_s == pytest.approx(40e-9)
    assert s.device_ops[0][0] == "k2"
    assert s.device_ops[0][1] == pytest.approx(25e-9)


def _cpu_run(config, mix="warm", seconds=0.05, traced=False, seed=2**31 + 3):
    cfg = dict(spec.load_config(config), params=SMALL[config])
    small = dict(spec.load_mix(mix), warm_seconds=0, pool=2, warm_solves=1) \
        if mix == "fresh" else dict(spec.load_mix(mix), warm_seconds=0)
    run = harness.run_cell(f"{config}.{mix}", config, cfg, mix, small, seed,
                           seconds, traced,
                           torch.device("cpu"), time.perf_counter())
    return run, harness.checks(run)


@pytest.mark.parametrize("config", sorted(SMALL))
def test_a_sound_run_is_correct(config):
    run, compared = _cpu_run(config, traced=config == "graph500-s19")
    assert harness.is_correct(run, compared), compared
    assert run.lanes == [spec.load_config(config)["expect_lane"]]
    assert run.counts and run.reference > 0


def test_a_fresh_run_is_correct():
    run, compared = _cpu_run("graph500-s19", mix="fresh", seconds=0.01)
    assert harness.is_correct(run, compared)
    assert run.mode == "fresh" and len(run.prep_s) == len(run.counts)


def _break(monkeypatch, how):
    """Break the timed path underneath the front door."""
    from repro_torch.core import api, engine
    if how == "answer_altered":
        real = api.CounterSession.count

        def count(self):
            res = real(self)
            res.count += 1
            return res
        monkeypatch.setattr(api.CounterSession, "count", count)
    elif how == "half_left_out":
        real = engine.IntersectLaunch.__call__

        def launch(self, u, v):  # each bucket: its first half, doubled
            half = (u.shape[0] + 1) // 2
            return real(self, u[:half].contiguous(), v[:half].contiguous()) * 2
        monkeypatch.setattr(engine.IntersectLaunch, "__call__", launch)
    elif how == "unchanged_state":
        def count(self):  # no kernel runs: the total stays as it started
            self.executions += 1
            return 0
        monkeypatch.setattr(engine.TrianglePlan, "count", count)
    else:
        raise ValueError(how)


@pytest.mark.parametrize("how", ["answer_altered", "half_left_out",
                                 "unchanged_state"])
@pytest.mark.parametrize("config", sorted(SMALL))
def test_a_broken_timed_path_is_not_correct(monkeypatch, config, how):
    _break(monkeypatch, how)
    run, compared = _cpu_run(config)
    assert not harness.is_correct(run, compared), (how, compared)


def test_run_exits_without_a_card_and_prints_no_result(capsys, monkeypatch):
    import sys
    from tcbench import run as cli
    if torch.cuda.is_available():
        pytest.skip("a card is present; this checks the refusal without one")
    for key in ("TORCH_EXTENSIONS_DIR", "TRITON_CACHE_DIR",
                "PYTORCH_KERNEL_CACHE_PATH"):
        monkeypatch.delenv(key, raising=False)  # restored afterwards
    monkeypatch.setattr(sys, "path", list(sys.path))
    rc = cli.main(["--workload", "graph500-s19.warm", "--seed", "1",
                   "--seconds", "1"])
    assert rc != 0
    assert capsys.readouterr().out == ""


def test_forbidden_modules_compare_whole_top_level_names(monkeypatch):
    import sys
    import types
    monkeypatch.setitem(sys.modules, "repro_torch_like", types.ModuleType("x"))
    assert "repro_torch_like" not in harness.forbidden_modules()
    monkeypatch.setitem(sys.modules, "jax.numpy", types.ModuleType("x"))
    assert "jax.numpy" in harness.forbidden_modules()


@pytest.mark.cuda
def test_a_short_cell_on_the_card():
    """On the card: one short run of each cell through the command."""
    import subprocess
    import sys
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    for cell in ("graph500-s19.warm", "rgg-n24.warm"):
        out = subprocess.run(
            [sys.executable, str(spec.BENCH_DIR / "run.py"), "--workload",
             cell, "--seed", "5", "--seconds", "1"], cwd=spec.ROOT,
            capture_output=True, text=True, timeout=300)
        assert out.returncode == 0, out.stderr[-4000:]
        line = json.loads(out.stdout.strip().splitlines()[-1])
        assert line["correct"] is True, line


def test_run_record_fields_are_what_readers_use():
    fields = {f.name for f in dataclasses.fields(harness.Run)}
    for path in (spec.BENCH_DIR / "metrics").glob("*.py"):
        for used in re.findall(r"run\.(\w+)", path.read_text()):
            assert used in fields, (path.name, used)
