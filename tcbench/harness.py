"""One run of one cell: inputs from the seed, the mix's set-up and window,
the metrics, and the comparison with the plain reference.

``run_cell`` does the work on any device, so that the tests can drive a
whole run on the CPU at a small size; ``run.py`` is the command, and it
alone insists on a card.
"""

from __future__ import annotations

import dataclasses
import gc
import json
import sys
import time
from typing import Any, Dict, List, Optional

import torch

from tcbench import spec
from tcbench.roofline import PEAKS
from tcbench.trace import Trace, TraceSummary

__all__ = ["FORBIDDEN", "Run", "checks", "forbidden_modules", "result_line",
           "run_cell"]

#: Top-level modules that may not be loaded in a run's process.
FORBIDDEN = ("jax", "jaxlib", "flax", "repro")


@dataclasses.dataclass
class Run:
    """Everything a metric reader may read about one run."""

    workload: str
    config: str
    traffic: str
    mode: str
    seed: int
    n: int
    m_undirected: int
    setup_s: float
    window_s: float
    latencies_s: List[float]
    exec_s: List[float]
    prep_s: List[float]
    counts: List[int]
    lanes: List[str]
    launches: Dict[str, int]
    failed: int
    session_peak_bytes: int
    process_peak_bytes: int
    device_kind: Optional[str]
    peaks: Optional[Dict[str, float]]
    trace: Optional[TraceSummary]
    setup_phases: Dict[str, float]
    reference: Optional[int] = None
    reference_s: Optional[float] = None


def forbidden_modules() -> List[str]:
    """Loaded modules whose top-level name (before the first dot) is one
    of ``FORBIDDEN``, compared whole."""
    return sorted({name for name in sys.modules
                   if name.split(".", 1)[0] in FORBIDDEN})


def host_csr(gen, params, seed, device, variant):
    """One variant of a seed's graph, made on ``device``, as the host CSR
    (n, row_ptr, col_idx) that users hand to the program."""
    n, row_ptr, col_idx = gen.make(params, seed, device, variant)
    return n, row_ptr.cpu().numpy(), col_idx.cpu().numpy()


def run_cell(workload: str, config_name: str, config: Dict[str, Any],
             traffic: str, mix: Dict[str, Any], seed: int, seconds: float,
             traced: bool, device: torch.device, t_start: float,
             marks: Optional[Dict[str, float]] = None) -> Run:
    """Make the inputs, run the mix, read the reference; ``t_start`` is
    the ``time.perf_counter()`` at which the process began its set-up, and
    ``marks`` the ends of the set-up stages before this call."""
    marks = dict(marks or {})
    if device.type == "cuda":
        torch.empty(1, device=device)  # the card's context
        marks["card"] = time.perf_counter()
    gen = spec.load_named("generators", config["generator"])
    if gen is None:
        raise FileNotFoundError(f"no generator {config['generator']!r}")
    from repro_torch.graphs import graph_from_arrays
    params = config["params"]
    # the harness keeps its own CSR of the seed's graph for the reference;
    # the program gets copies (graph_from_arrays copies)
    n, row_ptr, col_idx = host_csr(gen, params, seed, device, 0)
    graphs: Dict[int, Any] = {}

    def make_graph(variant: int):
        if variant not in graphs:
            csr = (n, row_ptr, col_idx) if variant == 0 else \
                host_csr(gen, params, seed, device, variant)
            graphs[variant] = graph_from_arrays(*csr, name=config_name)
        return graphs[variant]

    base = make_graph(0)
    m_undirected = base.m_undirected
    cuda = device.type == "cuda"
    trace = Trace(traced, cuda)
    traffic_loop = spec.load_named("loops", mix["loop"])
    if traffic_loop is None:
        raise FileNotFoundError(f"no loop {mix['loop']!r} for mix {traffic!r}")
    win = traffic_loop.measure(mix, make_graph,
                               dict(config.get("options", {})), device,
                               seconds, trace)
    setup_s = win.setup_end - t_start
    summary = trace.summary()
    del trace
    kind = torch.cuda.get_device_name(device) if cuda else None
    process_peak = max(win.inputs_peak_bytes,
                       torch.cuda.max_memory_allocated(device) if cuda else 0)
    run = Run(
        workload=workload, config=config_name, traffic=traffic,
        mode=mix["loop"], seed=seed, n=n,
        m_undirected=m_undirected, setup_s=setup_s,
        window_s=win.window_s, latencies_s=win.latencies_s,
        exec_s=win.exec_s, prep_s=win.prep_s, counts=win.counts,
        lanes=win.lanes, launches=win.launches, failed=win.failed,
        session_peak_bytes=win.session_peak_bytes,
        process_peak_bytes=process_peak,
        device_kind=kind, peaks=PEAKS.get(kind), trace=summary,
        setup_phases=_durations(t_start, {**marks, **win.phases}))
    del win, base
    graphs.clear()
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()
    ref = spec.load_named("references", config["reference"])
    t0 = time.perf_counter()
    run.reference = ref.count(row_ptr, col_idx, device)
    run.reference_s = time.perf_counter() - t0
    return run


def _durations(t_start: float, marks: Dict[str, float]) -> Dict[str, float]:
    """Seconds of each set-up stage, from the ends that ``marks`` holds in
    order."""
    out, at = {}, t_start
    for name, end in marks.items():
        out[name] = end - at
        at = end
    return out


def checks(run: Run) -> Dict[str, Dict[str, int]]:
    """The numbers compared with the reference, each with its limit. Every
    count of the window is compared; the counts are exact, so each limit
    is 0."""
    ref = run.reference
    errs = [abs(c - ref) for c in run.counts]
    return {
        "wrong_counts": {"value": sum(e > 0 for e in errs), "limit": 0},
        "max_abs_err": {"value": max(errs, default=0), "limit": 0},
        "failed_calls": {"value": run.failed, "limit": 0},
    }


def is_correct(run: Run, compared: Dict[str, Dict[str, int]]) -> bool:
    return bool(run.counts) and all(
        c["value"] <= c["limit"] for c in compared.values())


def read_metrics(run: Run, metrics) -> Dict[str, Dict[str, Any]]:
    """Each metric's reader over ``run``; a reader that finds nothing is
    left out."""
    out = {}
    for m in metrics:
        reader = spec.load_named("metrics", m.name)
        if reader is None:
            raise FileNotFoundError(f"no reader metrics/{m.name}.py")
        value = reader.read(run)
        if value is not None:
            out[m.name] = {"value": float(value), "unit": m.unit}
    return out


def result_line(correct: bool, attempted: int, failed: int,
                metrics: Dict[str, Dict[str, Any]], device: Dict[str, Any],
                compared: Dict[str, Dict[str, int]],
                breakdown: Optional[Dict[str, list]] = None) -> str:
    """The last line of a run's standard output: one JSON object, with the
    numbers compared under ``checks``, last."""
    out: Dict[str, Any] = {"correct": bool(correct),
                           "attempted": int(attempted),
                           "failed": int(failed), "metrics": metrics,
                           "device": device}
    if breakdown is not None:
        out["breakdown"] = breakdown
    out["checks"] = compared
    return json.dumps(out)


def device_record(run: Run, count: int) -> Dict[str, Any]:
    """The result's ``device``: platform, kind, cards used, the peak of
    the process, and with a trace its busy and window seconds."""
    dev: Dict[str, Any] = {
        "platform": "gpu" if run.device_kind is not None else "cpu",
        "kind": run.device_kind or "cpu", "count": int(count),
        "memory_peak_bytes": int(run.process_peak_bytes)}
    if run.trace is not None:
        dev["busy_s"] = run.trace.busy_s
        dev["window_s"] = run.trace.window_s
        dev["timer"] = run.trace.timer
        # the clock check the idle gaps' labels rest on: least and median
        # launch-to-start lag in us, and the share of negative lags
        dev["launch_lag_us"] = run.trace.launch_lag_us
    return dev
