#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port's main path on one GPU and check it.

    python3 chip_smoke.py

Run from the root of a checkout on a machine with an NVIDIA Hopper card,
``nvcc`` and PyTorch built for CUDA. It imports ``repro_torch`` from ``src/``
(never JAX, never ``repro``), builds the CUDA kernels from
``src/repro_torch/csrc`` into ``build/repro_torch/``, and runs, in order:

1. environment: the card (and its power limit), torch/CUDA/nvcc versions
   and the kernels' build time;
2. the main path: ``TriangleCounter(rmat_graph(18, 16, seed=1))`` with
   default options (auto → intersection, buckets on the card), checked
   against the forward-DAG scipy oracle and 82,629,122, with the broadcast
   and probe kernels' launch counters read around it; per-vertex counts
   must sum to 3 × count;
3. each strategy forced in turn on every non-tiny Table-1 analogue of
   ``graphs/datasets.py``, counts against ``triangle_count_scipy`` and
   per-vertex counts against the filtered auto run; the bitmap kernel's
   counter is read around this phase, its main path;
4. each kernel against its plain torch version on the card, exactly, at
   the bucket shapes its path gave it and on ragged shapes; the kernel's
   time (CUDA events, L2 flushed before each launch), the plain version's
   time, and the bytes bound;
5. a ``{"kernels": [...]}`` line, the card's name and power limit from
   nvidia-smi, and a last line ``{"ok": true, "device": {...}}``.

Any failed check raises, so the script exits non-zero and prints no last
line. Without a CUDA device, or outside a checkout, it exits 2 at once.
"""

from __future__ import annotations

import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
SRC = ROOT / "src"

EXPECTED_SCALE18 = 82_629_122
HBM_BYTES_PER_S = 3.35e12  # H100 SXM HBM3, NVIDIA data sheet
ALU_OPS_PER_S = 67e12      # H100 SXM non-tensor 32-bit rate, NVIDIA data sheet
KERNELS = {
    "broadcast": dict(
        name="intersect_broadcast", plain="intersect_counts_broadcast",
        replaces="src/repro/kernels/intersect/intersect.py:41"),
    "probe": dict(
        name="intersect_probe", plain="intersect_counts_probe",
        replaces="src/repro/kernels/intersect/probe.py:61"),
    "bitmap": dict(
        name="intersect_bitmap", plain="intersect_counts_bitmap",
        replaces="src/repro/kernels/intersect/bitmap.py:126"),
}


T_START = time.perf_counter()


def phase(title: str) -> None:
    print(f"== [{time.perf_counter() - T_START:7.1f} s] {title}", flush=True)


def check(ok: bool, what: str) -> None:
    if not ok:
        raise RuntimeError(f"check failed: {what}")
    print(f"  ok: {what}", flush=True)


def nvidia_smi_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


def bound_ms(e: int, w: int) -> tuple:
    """Least time for one (E, W) bucket: read u and v once, write the
    counts; the compare work of a merge (2·W steps a row) against the
    card's 32-bit ALU rate. Returns (ms, "bytes" | "operations")."""
    t_bytes = (2 * e * w * 4 + 4 * e) / HBM_BYTES_PER_S * 1e3
    t_ops = (2 * e * w) / ALU_OPS_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def time_ms(torch, fn, reps: int, flush) -> float:
    """Median device time of ``fn`` from CUDA events, after two warm-up
    calls; the L2 cache is flushed (a 64 MiB write) before each call."""
    for _ in range(2):
        fn()
    times = []
    for _ in range(reps):
        flush.zero_()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def ragged_lists(np, rng, e: int, w: int, id_hi: int, pad_rows: int):
    """(E, W) int32 u/v pairs of sorted unique ids below ``id_hi`` with
    in-row sentinels n = id_hi (u) / n + 1 (v), random row lengths, and
    ``pad_rows`` whole padding rows (-1 / -2) at the end."""
    def side(fill):
        keys = rng.random((e, id_hi)).argsort(axis=1)[:, :w]
        rows = np.sort(keys, axis=1).astype(np.int32)
        deg = rng.integers(0, w + 1, size=e)
        rows[np.arange(w)[None, :] >= deg[:, None]] = fill
        return rows
    u, v = side(id_hi), side(id_hi + 1)
    if pad_rows:
        u[-pad_rows:] = -1
        v[-pad_rows:] = -2
    return u, v


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available", file=sys.stderr)
        return 2
    if not (SRC / "repro_torch" / "csrc" / "intersect.cu").is_file():
        print(f"chip_smoke: {SRC / 'repro_torch'} not found; run from the "
              f"root of a checkout", file=sys.stderr)
        return 2
    sys.path.insert(0, str(SRC))
    import numpy as np

    from repro_torch.core import (TriangleCounter, triangle_count_forward_scipy,
                                  triangle_count_scipy)
    from repro_torch.graphs import available_datasets, load_dataset, rmat_graph
    from repro_torch.kernels import _build
    from repro_torch.kernels.intersect import (
        LAUNCHES, intersect_counts_bitmap, intersect_counts_bitmap_kernel,
        intersect_counts_broadcast, intersect_counts_kernel,
        intersect_counts_probe, intersect_counts_probe_kernel,
        reset_launch_counts)

    dev = torch.device("cuda")
    kind = torch.cuda.get_device_name(0)
    smi = nvidia_smi_line()

    # -- phase 1: environment and build -----------------------------------
    phase("phase 1: environment")
    nvcc = subprocess.run([_build.find_nvcc(), "--version"], capture_output=True,
                          text=True, timeout=60, check=True).stdout.strip()
    print(f"device: {kind}; count {torch.cuda.device_count()}")
    print(f"nvidia-smi name, power.limit: {smi}")
    print(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
          f"python {sys.version.split()[0]}")
    print(f"nvcc: {nvcc.splitlines()[-1]}")
    t0 = time.perf_counter()
    lib = _build.build("intersect")
    print(f"build: {lib.relative_to(ROOT)} in {time.perf_counter() - t0:.2f} s")
    for line in lib.with_suffix(".log").read_text().splitlines():
        if "Used" in line or "spill" in line or "Compiling entry" in line:
            print(f"  ptxas: {line.strip()}")
    flush = torch.empty(64 << 20, dtype=torch.uint8, device=dev)

    # -- phase 2: the main path -------------------------------------------
    phase("phase 2: main path, TriangleCounter(rmat_graph(18, 16, seed=1))")
    t0 = time.perf_counter()
    g = rmat_graph(18, 16, seed=1)
    oracle = triangle_count_forward_scipy(g)
    print(f"graph: n={g.n} m={g.m_undirected} max_degree={g.max_degree}; "
          f"host generation + forward scipy oracle {time.perf_counter() - t0:.2f} s")
    check(oracle == EXPECTED_SCALE18, f"forward scipy oracle = {oracle}")
    torch.cuda.reset_peak_memory_stats()
    reset_launch_counts()
    tc = TriangleCounter(g)
    first = tc.count()
    warm = [tc.count() for _ in range(5)]
    t0 = time.perf_counter()
    tpv = tc.triangles_per_vertex()
    tpv_s = time.perf_counter() - t0
    main_launches = dict(LAUNCHES)
    counts_run = 1 + len(warm)
    print(f"algorithm={first.algorithm} device={tc.device} "
          f"buckets={first.meta['bucket_shapes']} "
          f"strategies={first.bucket_strategies} "
          f"edges/bucket={first.meta['bucket_edges']}")
    print(f"prep_seconds={first.prep_seconds:.4f} first count() "
          f"{first.exec_seconds:.4f} s; warm count() seconds "
          f"{[round(r.exec_seconds, 6) for r in warm]} (median "
          f"{statistics.median(r.exec_seconds for r in warm):.6f}); "
          f"triangles_per_vertex {tpv_s:.3f} s; max_memory_allocated "
          f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
    print(f"launches over {counts_run} count() + triangles_per_vertex(): "
          f"{main_launches}")
    check(first.algorithm == "intersection", "auto resolved to intersection")
    check(all(r.count == EXPECTED_SCALE18 for r in [first] + warm),
          f"count() = {first.count} every time, = oracle")
    check(main_launches["broadcast"] > 0 and main_launches["probe"] > 0,
          "broadcast and probe kernels launched by count()")
    check(int(tpv.sum()) == 3 * first.count,
          f"triangles_per_vertex().sum() = {int(tpv.sum())} = 3 × count")
    check(tpv.shape == (g.n,) and int(tpv.min()) >= 0,
          "per-vertex counts are (n,) and non-negative")
    main_stages = tc.plan.stages

    # -- phase 3: each strategy forced on the Table-1 analogues -------------
    phase("phase 3: strategies forced on the Table-1 analogues")
    reset_launch_counts()
    bitmap_stages = []
    for name in available_datasets():
        if name.startswith("tiny-"):
            continue
        d = load_dataset(name)
        truth = triangle_count_scipy(d)
        base = TriangleCounter(d, algorithm="intersection")
        base_tpv = base.triangles_per_vertex()
        line = [f"{name}: n={d.n} m={d.m_undirected} scipy={truth} "
                f"auto={base.count().bucket_strategies}"]
        for strategy in ("broadcast", "probe", "bitmap"):
            s = TriangleCounter(d, algorithm="intersection", strategy=strategy)
            c = s.count()
            check(c.count == truth, f"{name} strategy={strategy} count "
                                    f"{c.count} = scipy")
            check(bool((s.triangles_per_vertex() == base_tpv).all()),
                  f"{name} strategy={strategy} per-vertex = auto run")
            line.append(f"{strategy} {c.exec_seconds * 1e3:.3f} ms")
            if strategy == "bitmap":
                bitmap_stages += s.plan.stages
        print("  " + "; ".join(line), flush=True)
    forced_launches = dict(LAUNCHES)
    print(f"launches in phase 3: {forced_launches}")
    check(all(v > 0 for v in forced_launches.values()),
          "every kernel launched by the forced runs")

    # -- phase 4: kernels against their plain versions ----------------------
    phase("phase 4: kernels against plain torch versions")
    wrappers = {
        "broadcast": (intersect_counts_kernel, intersect_counts_broadcast),
        "probe": (intersect_counts_probe_kernel, intersect_counts_probe),
        "bitmap": (intersect_counts_bitmap_kernel, intersect_counts_bitmap),
    }
    paths = {
        "broadcast": [st for st in main_stages if st.strategy == "broadcast"],
        "probe": [st for st in main_stages if st.strategy == "probe"],
        "bitmap": bitmap_stages,
    }
    report = []
    for strategy, (kern, plain) in wrappers.items():
        entry = dict(name=KERNELS[strategy]["name"], route="cuda",
                     source="src/repro_torch/csrc/intersect.cu",
                     replaces=KERNELS[strategy]["replaces"],
                     plain=KERNELS[strategy]["plain"],
                     path=("scale-18 R-MAT count()" if strategy != "bitmap"
                           else "forced bitmap on the Table-1 analogues"),
                     launches=(main_launches if strategy != "bitmap"
                               else forced_launches)[strategy],
                     tolerance=0, max_abs_err=0, ms=0.0, plain_ms=0.0,
                     bound_ms=0.0,
                     bound_by=None, library_ms=None, shapes=[])
        yard = 0.0
        for st in paths[strategy]:
            u, v = st.args
            kw = dict(num_bits=st.bitmap_bits) if strategy == "bitmap" else {}
            k_out = kern(u, v, **kw)
            p_out = plain(u, v, **kw)
            torch.cuda.synchronize()
            err = int((k_out.long() - p_out.long()).abs().max()) if u.shape[0] else 0
            check(err == 0, f"{strategy} kernel == plain at {tuple(u.shape)} "
                            f"{kw or ''}")
            k_ms = time_ms(torch, lambda: kern(u, v, **kw), 7, flush)
            p_ms = time_ms(torch, lambda: plain(u, v, **kw), 3, flush)
            b_ms, b_by = bound_ms(*u.shape)
            shape = dict(shape=list(u.shape), ms=k_ms, plain_ms=p_ms,
                         bound_ms=b_ms, bound_by=b_by, **kw)
            if strategy == "probe":
                y_ms = time_ms(torch, lambda: torch.searchsorted(
                    v, u, out_int32=True), 3, flush)
                shape["yardstick_ms"] = y_ms
                yard += y_ms
            entry["shapes"].append(shape)
            entry["ms"] += k_ms
            entry["plain_ms"] += p_ms
            entry["bound_ms"] += b_ms
            entry["max_abs_err"] = max(entry["max_abs_err"], err)
            print(f"  {strategy} {tuple(u.shape)} {kw or ''}: kernel {k_ms:.4f} ms, "
                  f"plain {p_ms:.4f} ms, bound {b_ms:.4f} ms ({b_by})"
                  + (f", torch.searchsorted {shape['yardstick_ms']:.4f} ms"
                     if strategy == "probe" else ""), flush=True)
        # the largest shape's bound names the kernel's
        entry["bound_by"] = max(entry["shapes"], key=lambda x: x["bound_ms"])["bound_by"]
        if strategy == "probe":
            entry["yardstick"] = "torch.searchsorted(v, u, out_int32=True) " \
                                 "(positions only, not the same function)"
            entry["yardstick_ms"] = yard
        report.append(entry)

    rng = np.random.default_rng(0)
    ragged = [(1, 8, 50, 0), (255, 8, 64, 3), (257, 32, 300, 17),
              (1000, 100, 700, 1), (4097, 128, 2000, 97), (999, 257, 1500, 0),
              (333, 512, 4000, 33), (129, 1000, 5000, 5), (77, 1024, 9000, 7),
              (64, 1500, 6000, 2), (9, 8200, 20000, 1)]
    for e, w, id_hi, pad in ragged:
        u_np, v_np = ragged_lists(np, rng, e, w, id_hi, pad)
        u = torch.from_numpy(u_np).to(dev)
        v = torch.from_numpy(v_np).to(dev)
        cases = [("broadcast", {}), ("probe", {}), ("bitmap", dict(num_bits=32)),
                 ("bitmap", dict(num_bits=65536))]
        for strategy, kw in cases:
            kern, plain = wrappers[strategy]
            err = int((kern(u, v, **kw).long() - plain(u, v, **kw).long())
                      .abs().max())
            torch.cuda.synchronize()
            check(err == 0, f"ragged {strategy} ({e}, {w}) {kw or ''} "
                            f"kernel == plain")
    for entry in report:
        entry.update(max_abs_diff=entry["max_abs_err"], kernel_ms=entry["ms"])

    # -- phase 5: the result --------------------------------------------------
    phase("phase 5: result")
    print(json.dumps({"kernels": report}))
    print(f"nvidia-smi: {smi}")
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
