"""Parity of the port's sharded lanes with the reference's, on the CPU.

``intersection_distributed``, ``matrix_distributed`` and sharded edge
support / k-truss, with the chooser's promotion to them, the deprecated
shims and ``count_many`` under a mesh, on meshes (4,) and (2, 2). The
reference runs once in a subprocess on 4 forced host devices; the port
runs once as 4 spawned gloo ranks on the CPU; both write JSON
(``tests/torch_distributed_cases.py`` holds the cases and both runners).
Each case is compared as a test of its own: counts and meta exactly, each
rank's dealt rows and tiles against the reference's shard row, supports
and truss edges by digest. The deal's pure functions are held against the
reference in this process.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import tempfile
import time
from pathlib import Path

import numpy as np
import pytest
import torch

import torch_distributed_cases as cases
from torch_reference import ref  # noqa: F401

from repro_torch import graphs
from repro_torch.core import plan_triangle_count, triangle_count_scipy
from repro_torch.core.engine import get_executable
from repro_torch.core.registry import _promote_distributed
from repro_torch.graphs.device import (_deal_chunk, deal_across_shards,
                                       deal_shard, shard_valid_counts)
from repro_torch.launch.mesh import (ProcessGroupNotInitializedError,
                                     make_mesh)

ROOT = Path(__file__).resolve().parents[1]
TESTS = Path(__file__).resolve().parent
RUN_TIMEOUT_S = 600


@pytest.fixture(scope="module")
def reference_run():
    """The reference's results on 4 forced host devices (one subprocess)."""
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "reference.json")
        env = dict(os.environ, JAX_PLATFORMS="cpu",
                   XLA_FLAGS="--xla_force_host_platform_device_count=4",
                   PYTHONPATH=os.pathsep.join(
                       [str(ROOT / "src"), str(TESTS)]
                       + [p for p in [os.environ.get("PYTHONPATH")] if p]))
        proc = subprocess.run(
            [sys.executable, str(TESTS / "torch_distributed_cases.py"), path],
            env=env, cwd=tmp, capture_output=True, text=True,
            timeout=RUN_TIMEOUT_S)
        assert proc.returncode == 0, proc.stderr[-4000:]
        with open(path) as f:
            return json.load(f)


@pytest.fixture(scope="module")
def port_run():
    """The port's results: one dict per gloo rank, spawned on the CPU and
    joined through a FileStore in a temporary directory."""
    import torch.multiprocessing as mp

    with tempfile.TemporaryDirectory() as tmp:
        ctx = mp.start_processes(
            cases.port_rank,
            args=(cases.NUM_SHARDS, os.path.join(tmp, "store"), tmp),
            nprocs=cases.NUM_SHARDS, join=False, start_method="spawn")
        deadline = time.monotonic() + RUN_TIMEOUT_S
        while not ctx.join(timeout=5):
            if time.monotonic() > deadline:
                for p in ctx.processes:
                    p.kill()
                pytest.fail(f"the gloo ranks did not finish in "
                            f"{RUN_TIMEOUT_S} s")
        out = []
        for r in range(cases.NUM_SHARDS):
            with open(os.path.join(tmp, f"rank{r}.json")) as f:
                out.append(json.load(f))
        return out


@pytest.fixture(scope="module")
def truths():
    return {n: triangle_count_scipy(cases.make_graph(graphs, n))
            for n in cases.GRAPH_NAMES}


@pytest.mark.parametrize("case", cases.COUNT_CASES)
def test_count_matches_reference(case, reference_run, port_run, truths):
    want = reference_run["counts"][case]["count"]
    assert want == truths[case.split("/")[1]]
    assert [r["counts"][case]["count"] for r in port_run] == \
        [want] * cases.NUM_SHARDS


@pytest.mark.parametrize("case", cases.COUNT_CASES)
def test_deal_meta_matches_reference(case, reference_run, port_run):
    want = reference_run["counts"][case]["meta"]
    keys = ({"tiles_per_shard"} if case.endswith("matrix_distributed")
            else {"bucket_shapes", "rows_per_shard", "bucket_strategies"})
    assert keys | {"shard_valid", "shard_work", "num_shards", "mesh"} \
        <= set(want)
    for r in port_run:
        assert r["counts"][case]["meta"] == want


@pytest.mark.parametrize("case", cases.ROW_CASES)
def test_dealt_rows_match_reference_shard(case, reference_run, port_run):
    """Each rank's (rows_per_shard, W) u and v rows, padding included,
    equal row [s] of the reference's (P, rows_per_shard, W) stacks."""
    want = reference_run["rows"][case]
    assert sorted(r["rows"][case]["shard"] for r in port_run) == \
        list(range(cases.NUM_SHARDS))
    for r in port_run:
        got = r["rows"][case]
        assert got["rows"] == want[got["shard"]]


@pytest.mark.parametrize("case", [f"{m}/{g}" for m in cases.MESHES
                                  for g in cases.GRAPH_NAMES])
def test_matrix_shard_tiles_match_reference(case, reference_run, port_run):
    """Each rank's L, U and A tiles, gathered through its re-based indices,
    equal the reference shard's dealt stacks up to its real tile count."""
    want = reference_run["tiles"][case]
    for r in port_run:
        got = r["tiles"][case]
        assert got["tiles"] == want[got["shard"]]


@pytest.mark.parametrize("case", cases.EDGE_CASES)
def test_edge_support_and_truss_match_reference(case, reference_run,
                                                port_run):
    want = reference_run["edge"][case]
    assert want["total"] == 3 * want["count"]
    assert want["key_mode"] == ("wide" if case.endswith("wide") else "int32")
    for r in port_run:
        assert r["edge"][case] == want


@pytest.mark.parametrize("case", cases.PICK_CASES)
def test_promoted_picks_match_reference(case, reference_run, port_run):
    want = reference_run["picks"][case]
    assert all(v.endswith("_distributed") for v in want.values())
    for r in port_run:
        assert r["picks"][case] == want


def test_shims_match_reference(reference_run, port_run, truths):
    want = reference_run[cases.SHIM_CASE]
    assert want == dict(counts=[truths["grid12"]] * 2, deprecations=2)
    for r in port_run:
        assert r[cases.SHIM_CASE] == want


def test_count_many_under_mesh_warns_once(reference_run, port_run, truths):
    want = reference_run[cases.MANY_CASE]
    assert want["warnings"] == 1
    assert want["counts"] == [truths[n] for n in cases.GRAPH_NAMES]
    for r in port_run:
        assert r[cases.MANY_CASE] == want


@pytest.mark.parametrize("check", cases.PORT_CHECKS)
def test_port_rank_check(check, port_run):
    """The port's own contract on every rank: one all-reduce and one host
    read a count, no launch on an empty shard, poisoned padding rows
    ignored, no new cache entry for a second plan, one miss on a reshard,
    the world mesh by default, a mesh of another device type refused, one
    vector all-reduce a support, about 1/P of the rows resident, and a
    matrix count past 2²⁴ equal to its closed form."""
    for r in port_run:
        assert r["checks"][check]["ok"], (r["rank"], r["checks"][check])


# -- in this process: the deal's pure functions and the typed errors ------

@pytest.mark.parametrize("shards", [1, 2, 3, 4, 8])
def test_shard_valid_counts_match_reference(shards, ref):
    for total in [0, 1, 2, 3, 5, 7, 8, 63, 64, 65, 1000, 1023]:
        got = shard_valid_counts(total, shards)
        want = np.asarray(ref.device.shard_valid_counts(total, shards))
        assert got.dtype == np.int32 and np.array_equal(got, want)
        assert int(got.sum()) == total


@pytest.mark.parametrize("shards", [1, 2, 3, 4])
def test_deal_across_shards_matches_reference(shards, ref):
    import jax.numpy as jnp

    rng = np.random.default_rng(shards)
    empty = deal_across_shards(torch.zeros((0, 3), dtype=torch.int32),
                               shards, 2, fill=-2)
    assert empty.shape == (shards, 2, 3) and bool((empty == -2).all())
    for total in [1, 5, 8, 13]:  # the reference cannot deal an empty array
        for rows in sorted({-(-total // shards), -(-total // shards) + 3}):
            x = rng.integers(-5, 50, size=(total, 3)).astype(np.int32)
            want = np.asarray(ref.device.deal_across_shards(
                jnp.asarray(x), shards, rows, fill=-2))
            got = deal_across_shards(torch.from_numpy(x), shards, rows,
                                     fill=-2).numpy()
            assert got.shape == want.shape and np.array_equal(got, want)
            for s in range(shards):
                assert np.array_equal(deal_shard(torch.from_numpy(x), shards,
                                                 rows, s, fill=-2).numpy(),
                                      want[s])


def test_deal_chunk_matches_reference(ref):
    for rows in [-1, 0, 1, 2, 3, 6, 12, 64, 96, 100, 128, 1000, 4096]:
        assert _deal_chunk(rows) == ref.device._deal_chunk(rows)


def test_sharded_lane_without_process_group_raises():
    """No mesh and no process group: a typed error, never a single-rank or
    CPU fallback."""
    g = graphs.complete_graph(5)
    for lane in ("intersection_distributed", "matrix_distributed"):
        with pytest.raises(ProcessGroupNotInitializedError,
                           match="init_process_group"):
            plan_triangle_count(g, lane, device="cpu")
    with pytest.raises(ProcessGroupNotInitializedError):
        make_mesh((1,), ("data",), device_type="cpu")


def test_single_rank_or_no_mesh_keeps_the_pick(ref):
    class OneRank:
        def size(self):
            return 1

    for lane in ("intersection", "matrix", "subgraph", "hash", "bfs"):
        assert _promote_distributed(lane, None) == lane
        assert _promote_distributed(lane, OneRank()) == lane
        assert ref.registry._promote_distributed(lane, None) == lane


def test_sharded_launch_needs_a_mesh():
    for lane in ("intersection_distributed", "matrix_distributed",
                 "edge_distributed"):
        with pytest.raises(ValueError, match="needs a mesh"):
            get_executable(lane, "kernel", (8, 8, 8), strategy="probe")
