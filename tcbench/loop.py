"""What every traffic loop shares: the record of a window, the program's
launch counters, the session's memory peak, and the closed loop with one
client.

A mix (``mixes/<name>.json``) names its loop by its ``"loop"`` key, and the
harness runs ``loops/<loop>.py``'s ``measure(mix, make_graph, options,
device, seconds, trace) -> Window``. A loop of another shape (an open loop
at a fixed rate, several clients) is another file there.
"""

from __future__ import annotations

import dataclasses
import gc
import importlib
import pkgutil
import sys
import time
import traceback
from typing import Any, Callable, Dict, List, Tuple

import torch

from tcbench.trace import Trace

__all__ = ["Window", "closed_window", "launch_counters", "peak_since",
           "peak_start", "sync"]


@dataclasses.dataclass
class Window:
    """What a window measured (host seconds unless named otherwise)."""

    window_s: float
    latencies_s: List[float]
    exec_s: List[float]
    prep_s: List[float]
    counts: List[int]
    lanes: List[str]
    launches: Dict[str, int]
    failed: int
    setup_end: float  # time.perf_counter() when the window opened
    session_peak_bytes: int
    inputs_peak_bytes: int  # the device peak while the inputs were made
    phases: Dict[str, float]  # time.perf_counter() at the end of each stage


def launch_counters() -> Dict[str, int]:
    """A copy of every kernel launch counter of the program, by
    ``<package>.<kernel>``: the ``LAUNCHES`` of each package under
    ``repro_torch.kernels`` that has one."""
    import repro_torch.kernels as kernels
    out = {}
    for info in pkgutil.iter_modules(kernels.__path__):
        mod = importlib.import_module(f"{kernels.__name__}.{info.name}")
        for k, v in getattr(mod, "LAUNCHES", {}).items():
            out[f"{info.name}.{k}"] = int(v)
    return out


def sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def peak_start(device: torch.device) -> Tuple[int, int]:
    """Start the session's memory peak; returns what is held already and
    the peak before."""
    if device.type != "cuda":
        return 0, 0
    gc.collect()
    before = torch.cuda.max_memory_allocated(device)
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats(device)
    return torch.cuda.memory_allocated(device), before


def peak_since(device: torch.device, held: int) -> int:
    if device.type != "cuda":
        return 0
    return torch.cuda.max_memory_allocated(device) - held


def closed_window(call: Callable[[], Any], device: torch.device,
                  seconds: float, trace: Trace, keep_prep: bool,
                  prep: List[float], phases: Dict[str, float], held: int,
                  inputs_peak: int) -> Window:
    """One client calling ``call()`` back to back for ``seconds``, each
    call timed on the host from call to return. ``prep`` holds the prep
    seconds of set-up; with ``keep_prep`` each call's are added."""
    lat: List[float] = []
    exe: List[float] = []
    counts: List[int] = []
    lanes: List[str] = []
    failed = 0
    sync(device)
    launches0 = launch_counters()
    gc.collect()
    setup_end = phases["warm"] = time.perf_counter()
    trace.start()
    t0 = time.perf_counter()
    deadline = t0 + seconds
    end = t0
    while end < deadline:
        pair = trace.cuda_pair()
        with trace.mark("count"):
            if pair:
                pair[0].record()
            start = time.perf_counter()
            try:
                res = call()
            except Exception:  # a failed call is counted, and ends the window
                traceback.print_exc(file=sys.stderr)
                res = None
            end = time.perf_counter()
            if pair:
                pair[1].record()
        if res is None:
            failed += 1
            break
        lat.append(end - start)
        exe.append(float(res.exec_seconds))
        counts.append(int(res.count))
        if keep_prep:
            prep.append(float(res.prep_seconds))
        if not lanes or lanes[-1] != res.algorithm:
            lanes.append(res.algorithm)
        del res  # hold none of the program's state between calls
    trace.stop()
    launches1 = launch_counters()
    sync(device)
    return Window(
        window_s=end - t0, latencies_s=lat, exec_s=exe, prep_s=prep,
        counts=counts, lanes=lanes,
        launches={k: launches1[k] - launches0.get(k, 0) for k in launches1},
        failed=failed, setup_end=setup_end,
        session_peak_bytes=peak_since(device, held),
        inputs_peak_bytes=inputs_peak, phases=phases)
