"""Where the harness finds things: ``BENCHMARK.json``, and the files a cell,
a configuration, a mix or a metric names.

Every lookup goes by name. ``configs/<name>.json``, ``mixes/<name>.json``,
``loops/<name>.py``, ``metrics/<name>.py``, ``generators/<name>.py`` and
``references/<name>.py`` are found from the name alone, so adding one is
adding a file.
"""

from __future__ import annotations

import dataclasses
import importlib.util
import json
import re
import sys
from pathlib import Path
from types import ModuleType
from typing import Any, Dict, List, Optional

__all__ = ["BENCH_DIR", "ROOT", "Cell", "Metric", "bench_spec", "cell",
           "load_config", "load_mix", "load_named", "metrics_for"]

BENCH_DIR = Path(__file__).resolve().parent
ROOT = BENCH_DIR.parent

_NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$")


@dataclasses.dataclass(frozen=True)
class Metric:
    """One metric of ``BENCHMARK.json`` (end to end or per layer)."""

    name: str
    unit: str
    better: str
    source: str
    end_to_end: bool
    bound: Optional[float] = None
    workloads: Optional[List[str]] = None

    def applies_to(self, workload: str) -> bool:
        return self.workloads is None or workload in self.workloads


@dataclasses.dataclass(frozen=True)
class Cell:
    """A cell: one configuration under one traffic mix, on ``chips`` cards."""

    name: str
    config: str
    traffic: str
    chips: int


def _check_name(kind: str, name: str) -> str:
    if not isinstance(name, str) or not _NAME.match(name):
        raise ValueError(f"{kind} name {name!r} is not a benchmark name")
    return name


def bench_spec(root: Path = ROOT) -> Dict[str, Any]:
    """``BENCHMARK.json`` at the root of the checkout, parsed."""
    path = root / "BENCHMARK.json"
    if not path.is_file():
        raise FileNotFoundError(f"{path} not found: run from the root of a "
                                f"checkout")
    return json.loads(path.read_text())


def cell(spec: Dict[str, Any], workload: str) -> Cell:
    """The cell named ``workload``.

    Raises:
      KeyError: ``BENCHMARK.json`` has no such cell.
    """
    for w in spec["workloads"]:
        if w["name"] == workload:
            return Cell(name=w["name"], config=w["config"],
                        traffic=w["traffic"], chips=int(w["chips"]))
    raise KeyError(f"no workload {workload!r} in BENCHMARK.json; have "
                   f"{[w['name'] for w in spec['workloads']]}")


def metrics_for(spec: Dict[str, Any], workload: str,
                per_layer: bool) -> List[Metric]:
    """The metrics a run of ``workload`` reports: the end-to-end ones, or
    with ``per_layer`` the per-layer ones, each where its ``workloads``
    list names the cell or where it has none."""
    key = "per_layer" if per_layer else "end_to_end"
    out = []
    for m in spec[key]:
        metric = Metric(name=m["name"], unit=m["unit"], better=m["better"],
                        source=m["source"], end_to_end=not per_layer,
                        bound=m.get("bound"), workloads=m.get("workloads"))
        if metric.applies_to(workload):
            out.append(metric)
    return out


def _json(folder: str, name: str) -> Dict[str, Any]:
    path = BENCH_DIR / folder / f"{_check_name(folder, name)}.json"
    if not path.is_file():
        raise FileNotFoundError(f"{path} not found")
    return json.loads(path.read_text())


def load_config(name: str) -> Dict[str, Any]:
    """``configs/<name>.json``: the generator and its sizes, the session's
    options and the reference."""
    return _json("configs", name)


def load_mix(name: str) -> Dict[str, Any]:
    """``mixes/<name>.json``: a traffic mix's parameters."""
    return _json("mixes", name)


def load_named(folder: str, name: str) -> Optional[ModuleType]:
    """Import ``<folder>/<name>.py`` of the benchmark, or None if there is
    no such file. Modules are cached in ``sys.modules`` under
    ``tcbench.<folder>.<name>``."""
    path = BENCH_DIR / folder / f"{_check_name(folder, name)}.py"
    if not path.is_file():
        return None
    key = f"tcbench.{folder}.{name}"
    mod = sys.modules.get(key)
    if mod is None:
        spec = importlib.util.spec_from_file_location(key, path)
        mod = importlib.util.module_from_spec(spec)
        sys.modules[key] = mod
        spec.loader.exec_module(mod)
    return mod
