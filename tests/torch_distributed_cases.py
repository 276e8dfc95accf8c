"""The sharded lanes' parity cases, run once by each side in a process of
its own (``tests/test_torch_distributed.py``).

* ``reference_main(path)`` runs the JAX package on 4 forced host devices
  (``XLA_FLAGS=--xla_force_host_platform_device_count=4``, set by the
  caller) and writes one JSON object to ``path``. It applies two shims in
  its own process only: ``jax.experimental.enable_x64 = jax.enable_x64``
  (JAX releases without ``jax.experimental.enable_x64``), and a
  ``shard_map`` patched into ``repro.core.engine`` that passes the
  reference's ``check_rep=`` on as ``check_vma=`` (JAX releases whose
  ``shard_map`` renamed it).
* ``port_rank(rank, world, store, out_dir)`` is one of ``world`` spawned
  gloo ranks of the port on the CPU, joined through a ``FileStore`` at
  ``store``; each writes ``rank<r>.json`` to ``out_dir``.

Both sides run the same cases (``COUNT_CASES``, ``ROW_CASES``,
``EDGE_CASES``, ``PICK_CASES``, ``SHIM_CASE``, ``MANY_CASE``) on the same
meshes: (4,) ``("data",)`` and (2, 2) ``("data", "model")``. Arrays are
compared through ``digest`` (sha1 of their bytes in a fixed dtype); the
port's ranks also record the checks that have no reference counterpart
(``PORT_CHECKS``). Only numpy is imported at module level, so the
reference's process imports no torch.
"""

from __future__ import annotations

import hashlib
import json
import os
import sys
import warnings

import numpy as np

MESHES = {"d4": ((4,), ("data",)), "d2x2": ((2, 2), ("data", "model"))}
NUM_SHARDS = 4
GRAPH_NAMES = ("rmat9", "grid12", "road-like")
STRATEGIES = ("auto", "probe", "broadcast")
PREPS = ("device", "host")
BLOCK = 32

COUNT_CASES = [f"{m}/{g}/intersection_distributed/{s}/{p}"
               for m in MESHES for g in GRAPH_NAMES
               for s in STRATEGIES for p in PREPS] + \
              [f"{m}/{g}/matrix_distributed" for m in MESHES
               for g in GRAPH_NAMES]
ROW_CASES = [f"{m}/{g}/{p}" for m in MESHES for g in GRAPH_NAMES
             for p in PREPS]
EDGE_GRAPHS = {"rmat9": 5, "grid12": 3}  # graph -> the k of its k-truss
EDGE_CASES = [f"{m}/{g}/{k}" for m in MESHES for g in EDGE_GRAPHS
              for k in ("auto", "wide")]
PICK_GRAPHS = GRAPH_NAMES + ("k40",)
PICK_CASES = [f"{m}/{g}" for m in MESHES for g in PICK_GRAPHS]
SHIM_CASE = "shims"
MANY_CASE = "count_many"
# the meta both sides record for every count case (the matrix lane's
# tiles_per_shard only there)
META_KEYS = ("bucket_shapes", "bucket_strategies", "bucket_edges", "edges",
             "rows_per_shard", "shard_valid", "shard_work", "num_shards",
             "mesh", "mesh_axes", "mesh_shape", "tiles_per_shard")
PORT_CHECKS = ("one_all_reduce_one_sync", "empty_shard_launches_nothing",
               "poisoned_padding", "warm_plan_no_new_entry",
               "reshard_misses_once", "world_mesh_default",
               "mesh_device_mismatch_raises", "edge_one_all_reduce",
               "resident_rows_per_shard", "matrix_past_2_24")


def digest(a, dtype) -> str:
    """sha1 of ``a``'s bytes as a C-contiguous ``dtype`` array."""
    return hashlib.sha1(np.ascontiguousarray(np.asarray(a), dtype=dtype)
                        .tobytes()).hexdigest()


def make_graph(graphs, name: str):
    """The named test graph from a package's ``graphs`` module."""
    if name == "rmat9":
        return graphs.rmat_graph(9, 8, seed=5)
    if name == "grid12":
        return graphs.grid_graph(12, seed=2)
    if name == "k40":
        return graphs.complete_graph(40)
    return graphs.load_dataset(name)


def _jsonable(x):
    if isinstance(x, dict):
        return {str(k): _jsonable(v) for k, v in x.items()}
    if isinstance(x, (list, tuple)):
        return [_jsonable(v) for v in x]
    if isinstance(x, np.integer):
        return int(x)
    if isinstance(x, np.floating):
        return float(x)
    return x


def _meta(meta: dict) -> dict:
    return {k: _jsonable(meta[k]) for k in META_KEYS if k in meta}


def _pick_table(calibrate, graphs):
    """A calibration table whose bins make the measured chooser pick hash
    on R-MAT scale 9 and matrix on the 12-grid (the others miss to the
    nearest bin)."""
    table = calibrate.CalibrationTable(device="test")
    for name, timings in (("rmat9", {"hash": 1.0, "intersection": 2.0}),
                          ("grid12", {"matrix": 0.5, "subgraph": 1.0})):
        g = make_graph(graphs, name)
        table.record(calibrate.feature_key(calibrate.graph_features(g)),
                     timings, "measured")
    return table


def _truss(plan, k: int) -> dict:
    t = plan.k_truss(k)
    su, sv = t.edge_list_unique()
    return dict(m=int(t.m_undirected), rounds=int(plan.meta["peel_rounds"]),
                edges=digest(np.stack([su, sv]), np.int64))


def _support(plan) -> dict:
    su, sv, supp = plan.edge_support()
    return dict(support=digest(supp, np.int64), total=int(np.sum(supp)),
                edges=digest(np.stack([su, sv]), np.int64),
                count=int(plan.count()),
                bucket_shapes=_jsonable(plan.meta["bucket_shapes"]),
                key_mode=plan.meta["key_mode"],
                num_shards=int(plan.meta["num_shards"]),
                mesh=_jsonable(plan.meta["mesh"]))


def _count_many(counter_cls, graphs, mesh, **kw) -> dict:
    gs = [make_graph(graphs, n) for n in GRAPH_NAMES]
    with warnings.catch_warnings(record=True) as w:
        warnings.simplefilter("always")
        res = counter_cls(gs[0], mesh=mesh, **kw).count_many(gs)
    warned = [x for x in w if issubclass(x.category, UserWarning)
              and "count_many" in str(x.message)]
    return dict(counts=[int(r.count) for r in res],
                algorithms=[r.algorithm for r in res], warnings=len(warned))


# ---------------------------------------------------------------------------
# The reference, in a process of its own on 4 forced host devices
# ---------------------------------------------------------------------------

def _reference_shims():
    import jax
    import jax.experimental

    if not hasattr(jax.experimental, "enable_x64"):
        jax.experimental.enable_x64 = jax.enable_x64
    import repro.core.engine as engine

    try:
        import inspect
        takes_rep = "check_rep" in inspect.signature(jax.shard_map).parameters
    except (AttributeError, TypeError, ValueError):
        takes_rep = True
    if not takes_rep:
        def shard_map(f, *, check_rep=None, **kw):
            if check_rep is not None:
                kw["check_vma"] = check_rep
            return jax.shard_map(f, **kw)
        engine.shard_map = shard_map


def reference_main(path: str) -> None:
    """Run every case through the JAX package and write the JSON."""
    _reference_shims()
    import jax

    import importlib

    from repro import graphs
    from repro.core import registry
    from repro.core import (TriangleCounter,
                            triangle_count_intersection_distributed,
                            triangle_count_matrix_distributed)
    from repro.core.engine import plan_edge_support, plan_triangle_count
    from repro.graphs.device import DEFAULT_SHAPE_POLICY, ShardedDeviceCSR
    from repro.launch.mesh import make_mesh

    calibrate = importlib.import_module("repro.core.calibrate")
    assert jax.device_count() == NUM_SHARDS, jax.device_count()
    meshes = {k: make_mesh(*v) for k, v in MESHES.items()}
    g = {n: make_graph(graphs, n) for n in PICK_GRAPHS}
    out = dict(counts={}, rows={}, tiles={}, edge={}, picks={})
    for case in COUNT_CASES:
        m, gname, lane, *rest = case.split("/")
        if lane == "matrix_distributed":
            plan = plan_triangle_count(g[gname], lane, mesh=meshes[m],
                                       block=BLOCK)
            l_d, u_d, a_d, valid = (np.asarray(x) for x in plan.stages[0].args)
            out["tiles"][f"{m}/{gname}"] = [
                [digest(x[s][:valid[s]], np.float32) for x in (l_d, u_d, a_d)]
                for s in range(NUM_SHARDS)]
        else:
            plan = plan_triangle_count(g[gname], lane, mesh=meshes[m],
                                       strategy=rest[0], prep_backend=rest[1])
        out["counts"][case] = dict(count=int(plan.count()),
                                   meta=_meta(plan.meta))
    for case in ROW_CASES:
        m, gname, prep = case.split("/")
        sharded = ShardedDeviceCSR.from_graph(
            g[gname], meshes[m], policy=DEFAULT_SHAPE_POLICY,
            prep_backend=prep)
        out["rows"][case] = [
            [[digest(np.asarray(b.u_lists)[s], np.int32),
              digest(np.asarray(b.v_lists)[s], np.int32)]
             for b in sharded.buckets] for s in range(NUM_SHARDS)]
    for case in EDGE_CASES:
        m, gname, km = case.split("/")
        plan = plan_edge_support(g[gname], mesh=meshes[m], key_mode=km)
        out["edge"][case] = dict(_support(plan),
                                 truss=_truss(plan, EDGE_GRAPHS[gname]))
    table = _pick_table(calibrate, graphs)
    for case in PICK_CASES:
        m, gname = case.split("/")
        out["picks"][case] = dict(
            heuristic=registry.choose_algorithm(g[gname], mesh=meshes[m]),
            measured=calibrate.choose_measured(g[gname], table,
                                               mesh=meshes[m]),
            session=TriangleCounter(g[gname], mesh=meshes[m]).algorithm)
    with warnings.catch_warnings(record=True) as w:
        warnings.simplefilter("always")
        a = triangle_count_matrix_distributed(g["grid12"], meshes["d4"],
                                              block=16)
        b = triangle_count_intersection_distributed(g["grid12"],
                                                    meshes["d2x2"])
    out[SHIM_CASE] = dict(counts=[int(a), int(b)], deprecations=len(
        [x for x in w if issubclass(x.category, DeprecationWarning)]))
    out[MANY_CASE] = _count_many(TriangleCounter, graphs, meshes["d4"])
    with open(path, "w") as f:
        json.dump(out, f)


# ---------------------------------------------------------------------------
# The port: one gloo rank on the CPU
# ---------------------------------------------------------------------------

def _poison_count(g, mesh, engine, device_mod, torch) -> int:
    """The count with every dealt padding row of this rank set to ids that
    would match (u = v = 0, 1, ...): the stages read the real rows only."""
    sharded = device_mod.ShardedDeviceCSR.from_graph(g, mesh, device="cpu")
    for b in sharded.buckets:
        ids = torch.arange(b.width, dtype=torch.int32)
        b.u_lists[b.valid:] = ids
        b.v_lists[b.valid:] = ids
    stages, _ = engine._shard_stages(sharded, "kernel", "auto", None, mesh)
    total = torch.zeros((), dtype=torch.int64)
    for st in stages:
        total += st.run()
    torch.distributed.all_reduce(total, group=engine.mesh_group(mesh))
    return int(total)


def _sync_and_reduce_counts(fn, torch):
    """(all-reduce calls, host reads of a tensor) made by ``fn()``."""
    import torch.distributed as dist

    calls = dict(all_reduce=0, host=0)
    real_reduce = dist.all_reduce

    def counting_reduce(*a, **kw):
        calls["all_reduce"] += 1
        return real_reduce(*a, **kw)

    patched = {}
    for name in ("__int__", "item", "tolist", "cpu", "numpy", "__index__"):
        real = getattr(torch.Tensor, name)

        def counting(self, *a, _real=real, **kw):
            calls["host"] += 1
            return _real(self, *a, **kw)
        patched[name] = real
        setattr(torch.Tensor, name, counting)
    dist.all_reduce = counting_reduce
    try:
        fn()
    finally:
        dist.all_reduce = real_reduce
        for name, real in patched.items():
            setattr(torch.Tensor, name, real)
    return calls


def _port_checks(rank, g, meshes, torch) -> dict:
    from repro_torch.core import TriangleCounter, engine
    from repro_torch.core.engine import (IntersectLaunch, executable_cache_info,
                                         plan_edge_support, plan_triangle_count)
    from repro_torch.core.oracle import triangle_count_scipy
    from repro_torch.graphs import complete_graph
    from repro_torch.graphs import device as device_mod

    checks = {}
    mesh = meshes["d4"]
    truth = triangle_count_scipy(g["rmat9"])
    plan = plan_triangle_count(g["rmat9"], "intersection_distributed",
                               mesh=mesh, device="cpu")
    plan.count()
    calls = []
    counts = _sync_and_reduce_counts(lambda: calls.append(plan.count()), torch)
    checks["one_all_reduce_one_sync"] = dict(
        ok=counts == dict(all_reduce=1, host=1) and calls == [truth],
        counts=counts)
    eplan = plan_edge_support(g["rmat9"], mesh=mesh, device="cpu")
    counts = _sync_and_reduce_counts(eplan.count, torch)
    checks["edge_one_all_reduce"] = dict(ok=counts["all_reduce"] == 1,
                                         counts=counts)

    # a triangle: its one bucket has 3 rows, so shard 3 has none
    small = complete_graph(3)
    launched = []
    real_call = IntersectLaunch.__call__

    def recording(self, u, v):
        launched.append(int(u.shape[0]))
        return real_call(self, u, v)

    splan = plan_triangle_count(small, "intersection_distributed", mesh=mesh,
                                device="cpu")
    IntersectLaunch.__call__ = recording
    try:
        got = splan.count()
    finally:
        IntersectLaunch.__call__ = real_call
    mine = [rows[rank] for rows in splan.meta["shard_valid"]]
    checks["empty_shard_launches_nothing"] = dict(
        ok=(launched == [r for r in mine if r]
            and got == triangle_count_scipy(small)
            and 0 in [r for rows in splan.meta["shard_valid"] for r in rows]),
        launched=launched, shard_valid=splan.meta["shard_valid"])

    checks["poisoned_padding"] = dict(
        ok=_poison_count(g["rmat9"], mesh, engine, device_mod, torch) == truth)

    before = executable_cache_info()
    again = plan_triangle_count(g["rmat9"], "intersection_distributed",
                                mesh=mesh, device="cpu")
    after = executable_cache_info()
    checks["warm_plan_no_new_entry"] = dict(
        ok=(again.count() == truth and after["misses"] == before["misses"]
            and after["size"] == before["size"]), before=before, after=after)

    p1 = plan_triangle_count(g["rmat9"], "matrix_distributed", mesh=mesh,
                             block=64, device="cpu")
    m0 = executable_cache_info()["misses"]
    p2 = plan_triangle_count(g["rmat9"], "matrix_distributed",
                             mesh=meshes["d2x2"], block=64, device="cpu")
    checks["reshard_misses_once"] = dict(
        ok=(executable_cache_info()["misses"] - m0 == 1
            and p1.count() == p2.count() == truth))

    dflt = plan_triangle_count(g["rmat9"], "intersection_distributed",
                               device="cpu")
    checks["world_mesh_default"] = dict(
        ok=(dflt.meta["mesh"] == (("data",), (NUM_SHARDS,),
                                  tuple(range(NUM_SHARDS)))
            and dflt.count() == truth), mesh=_jsonable(dflt.meta["mesh"]))

    raised = []
    for make in (lambda: TriangleCounter(g["rmat9"], mesh=mesh),
                 lambda: TriangleCounter(g["rmat9"], mesh=mesh,
                                         device="meta")):
        try:
            make()
        except ValueError as e:
            raised.append(str(e))
    checks["mesh_device_mismatch_raises"] = dict(ok=len(raised) == 2,
                                                 raised=raised)

    single = plan_triangle_count(g["road-like"], "intersection", device="cpu")
    whole = sum(st.args[0].numel() * 8 for st in single.stages)
    dealt = plan_triangle_count(g["road-like"], "intersection_distributed",
                                mesh=mesh, device="cpu").meta["shard_bytes"]
    checks["resident_rows_per_shard"] = dict(
        ok=0 < dealt <= whole // NUM_SHARDS + whole // 8, dealt=dealt,
        whole=whole)

    # past 2**24 the reference's float32 psum may round (R6): this count is
    # held against the closed form only
    big = plan_triangle_count(complete_graph(512), "matrix_distributed",
                              mesh=meshes["d2x2"], device="cpu").count()
    checks["matrix_past_2_24"] = dict(ok=big == 512 * 511 * 510 // 6 > 2**24,
                                      count=big)
    return checks


def port_rank(rank: int, world: int, store: str, out_dir: str) -> None:
    """One gloo rank of the port on the CPU: every case, then the port's
    own checks; writes ``rank<rank>.json``."""
    import torch
    import torch.distributed as dist

    torch.set_num_threads(2)
    dist.init_process_group("gloo", store=dist.FileStore(store, world),
                            rank=rank, world_size=world)
    try:
        from repro_torch import graphs
        from repro_torch.core import (TriangleCounter,
                                      triangle_count_intersection_distributed,
                                      triangle_count_matrix_distributed)
        from repro_torch.core import registry
        from repro_torch.core.engine import (plan_edge_support,
                                             plan_triangle_count)
        from repro_torch.graphs.device import (DEFAULT_SHAPE_POLICY,
                                               ShardedDeviceCSR)
        from repro_torch.launch.mesh import make_mesh
        import importlib
        calibrate = importlib.import_module("repro_torch.core.calibrate")

        meshes = {k: make_mesh(*v, device_type="cpu")
                  for k, v in MESHES.items()}
        g = {n: make_graph(graphs, n) for n in PICK_GRAPHS}
        out = dict(rank=rank, counts={}, rows={}, tiles={}, edge={},
                   picks={})
        for case in COUNT_CASES:
            m, gname, lane, *rest = case.split("/")
            kw = dict(block=BLOCK) if lane == "matrix_distributed" else \
                dict(strategy=rest[0], prep_backend=rest[1])
            plan = plan_triangle_count(g[gname], lane, mesh=meshes[m],
                                       device="cpu", **kw)
            if lane == "matrix_distributed":
                shard = plan.meta["shard"]
                tiles = [digest(np.zeros((0, BLOCK, BLOCK)), np.float32)] * 3
                if plan.stages:
                    lb, ub, ab, li, ui, ai, _ = plan.stages[0].args
                    tiles = [digest(t[i.long()].float().numpy(), np.float32)
                             for t, i in ((lb, li), (ub, ui), (ab, ai))]
                out["tiles"][f"{m}/{gname}"] = dict(shard=shard, tiles=tiles)
            out["counts"][case] = dict(count=int(plan.count()),
                                       meta=_meta(plan.meta))
        for case in ROW_CASES:
            m, gname, prep = case.split("/")
            sharded = ShardedDeviceCSR.from_graph(
                g[gname], meshes[m], device="cpu",
                policy=DEFAULT_SHAPE_POLICY, prep_backend=prep)
            out["rows"][case] = dict(shard=sharded.shard, rows=[
                [digest(b.u_lists.numpy(), np.int32),
                 digest(b.v_lists.numpy(), np.int32)]
                for b in sharded.buckets])
        for case in EDGE_CASES:
            m, gname, km = case.split("/")
            plan = plan_edge_support(g[gname], mesh=meshes[m], key_mode=km,
                                     device="cpu")
            out["edge"][case] = dict(_support(plan),
                                     truss=_truss(plan, EDGE_GRAPHS[gname]))
        table = _pick_table(calibrate, graphs)
        for case in PICK_CASES:
            m, gname = case.split("/")
            out["picks"][case] = dict(
                heuristic=registry.choose_algorithm(g[gname], mesh=meshes[m]),
                measured=calibrate.choose_measured(g[gname], table,
                                                   mesh=meshes[m]),
                session=TriangleCounter(g[gname], mesh=meshes[m],
                                        device="cpu").algorithm)
        with warnings.catch_warnings(record=True) as w:
            warnings.simplefilter("always")
            a = triangle_count_matrix_distributed(
                g["grid12"], meshes["d4"], block=16, device="cpu")
            b = triangle_count_intersection_distributed(
                g["grid12"], meshes["d2x2"], device="cpu")
        out[SHIM_CASE] = dict(counts=[int(a), int(b)], deprecations=len(
            [x for x in w if issubclass(x.category, DeprecationWarning)]))
        out[MANY_CASE] = _count_many(TriangleCounter, graphs, meshes["d4"],
                                     device="cpu")
        out["checks"] = _jsonable(_port_checks(rank, g, meshes, torch))
        with open(os.path.join(out_dir, f"rank{rank}.json"), "w") as f:
            json.dump(_jsonable(out), f)
    finally:
        dist.destroy_process_group()


def card_rank(rank: int, world: int, store: str, out_dir: str) -> None:
    """One of ``world`` gloo ranks on ``cuda:0`` (``tests/test_torch_cuda.py``):
    the sharded lanes on coauthors-like through the kernels; writes
    ``rank<rank>.json`` with the counts, the support digest and the K1–K4
    launch counters."""
    import torch
    import torch.distributed as dist

    torch.cuda.set_device(0)
    dist.init_process_group("gloo", store=dist.FileStore(store, world),
                            rank=rank, world_size=world)
    try:
        from repro_torch.core import TriangleCounter
        from repro_torch.graphs import load_dataset
        from repro_torch.kernels.intersect import LAUNCHES
        from repro_torch.kernels.masked_spgemm import LAUNCHES as MS_LAUNCHES
        from repro_torch.launch.mesh import make_mesh

        mesh = make_mesh((world,), ("data",))
        g = load_dataset("coauthors-like")
        counts = {}
        for strategy in ("auto", "bitmap"):
            counts[strategy] = TriangleCounter(
                g, algorithm="intersection_distributed", strategy=strategy,
                mesh=mesh).count().count
        for block in (32, 128):
            counts[f"matrix{block}"] = TriangleCounter(
                g, algorithm="matrix_distributed", block=block,
                mesh=mesh).count().count
        su, sv, supp = TriangleCounter(g, mesh=mesh).edge_support()
        out = dict(rank=rank, counts=counts,
                   support=digest(np.stack([su, sv, supp]), np.int64),
                   launches=dict(LAUNCHES, **MS_LAUNCHES))
        with open(os.path.join(out_dir, f"rank{rank}.json"), "w") as f:
            json.dump(out, f)
    finally:
        dist.destroy_process_group()


if __name__ == "__main__":
    reference_main(sys.argv[1])
