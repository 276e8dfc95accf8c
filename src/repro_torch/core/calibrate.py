"""Measured ``algorithm="auto"``: per-device calibration tables.

The port of ``repro.core.calibrate``. With five counting lanes, the shape
rules of ``registry._default_chooser`` are a guess; this module replaces
the guess with timings taken on the card:

* ``graph_features`` / ``feature_key`` reduce a graph to a coarse bin: its
  widest degree-class **bucket width**, a **degree-skew** band and a
  **density** band (the axes of the heuristic rules).
* ``calibrate`` builds a :class:`CalibrationTable` by timing the warm
  ``plan.count()`` of every lane on each graph of a sweep (best of k, prep
  excluded: a session plans once and counts many times).
* The cold start is analytic: ``analytic_seed`` prices each lane's plan
  with ``repro_torch.launch.roofline`` (the H100 bound of each stage, from
  its shape and dtypes; no kernel runs), so a table can rank lanes for a
  bin no timing has visited. Analytic entries never overwrite measured
  ones.
* Tables persist as a ``CALIB_<device>.json`` sidecar with the reference's
  schema (below), so a sidecar written by either package loads in the
  other.

Sidecar schema (``CALIB_SCHEMA_VERSION = 1``)::

    {
      "schema": 1,
      "device": "<sanitized device name>",
      "created_unix": <float>,
      "entries": [
        {"key": ["w:32", "skew:low", "dens:sparse"],
         "timings": {"intersection": 1.2e-4, "hash": 9.8e-5, ...},
         "source": "measured" | "analytic"},
        ...
      ]
    }

Wiring: ``CountOptions(chooser="measured")`` makes the front door resolve
``algorithm="auto"`` through ``choose_measured`` (exact bin, else the
nearest measured bin, else the heuristic), and
``install_measured_chooser(table)`` swaps the process-wide chooser through
``registry.set_auto_chooser``. The device name is part of the sidecar's
name, the schema version is checked on load, and a corrupt or mismatched
sidecar falls back to the heuristic: the chooser is never a crash
surface. That fallback concerns the table only. A kernel or launch error
while ``measure_lanes`` times a lane is never caught.

Where the reference's ``device`` argument of ``calibrate`` names the
label, the port's ``device`` is where the plans run (the card unless
``device="cpu"``, as at every entry point), and ``label`` overrides the
label.
"""

from __future__ import annotations

import dataclasses
import json
import os
import re
import time
from typing import Callable, Dict, Optional, Sequence, Tuple, Union

import torch

from repro_torch.core import registry
from repro_torch.core.options import CountOptions, DEFAULT_WIDTHS
from repro_torch.graphs.device import next_pow2, resolve_device

__all__ = [
    "CALIB_SCHEMA_VERSION",
    "CHOOSER_LANES",
    "CalibrationTable",
    "analytic_seed",
    "calib_path",
    "calibrate",
    "choose_measured",
    "device_label",
    "feature_key",
    "graph_features",
    "install_measured_chooser",
    "load_table",
    "measure_lanes",
    "price_plan",
    "save_table",
    "set_default_table",
]

CALIB_SCHEMA_VERSION = 1

# The single-card counting lanes the measured chooser ranks.
CHOOSER_LANES = ("intersection", "matrix", "subgraph", "hash", "bfs")

# feature-bin thresholds, shared with the heuristic rules they replace
_SKEW_BANDS = ((3.0, "low"), (12.0, "mid"), (float("inf"), "high"))
_DENSITY_BANDS = ((0.01, "thin"), (0.25, "sparse"), (float("inf"), "dense"))

Device = Union[None, str, torch.device]


def device_label(device: Device = None) -> str:
    """Sanitized identity of the device a table is valid for.

    ``torch.cuda.get_device_name`` of a CUDA device (None: the current one
    when a card is present), ``"cpu"`` for the CPU, with non-filename
    characters collapsed as the reference does. It names the
    ``CALIB_<device>.json`` sidecar, so a table is never loaded onto
    another kind of card by accident.
    """
    if device is None:
        dev = torch.device("cuda" if torch.cuda.is_available() else "cpu")
    else:
        dev = resolve_device(device)
    raw = torch.cuda.get_device_name(dev) if dev.type == "cuda" else dev.type
    return re.sub(r"[^A-Za-z0-9._-]+", "-", str(raw)).strip("-") or "unknown"


def calib_path(json_dir: str = ".", device: Optional[str] = None) -> str:
    """The sidecar path for the label ``device`` (default: the current
    device's)."""
    return os.path.join(json_dir, f"CALIB_{device or device_label()}.json")


def graph_features(g) -> dict:
    """Raw chooser features of one graph (``feature_key`` bins them).

    ``bucket_width`` is the degree-class width the widest bucket would have:
    the smallest ``DEFAULT_WIDTHS`` class covering the max degree, or the
    next power of two past the last class.
    """
    n, m, dmax = int(g.n), int(g.m_undirected), int(g.max_degree)
    avg = 2.0 * m / n if n else 0.0
    density = 2.0 * m / (n * (n - 1)) if n > 1 else 0.0
    skew = dmax / avg if avg > 0 else 0.0
    if m == 0 or dmax == 0:
        width = 0
    else:
        width = next(
            (w for w in DEFAULT_WIDTHS if dmax <= w), next_pow2(dmax)
        )
    return dict(n=n, m=m, max_degree=dmax, avg_degree=avg, density=density,
                skew=skew, bucket_width=int(width))


def _band(value: float, bands) -> str:
    for bound, name in bands:
        if value <= bound:
            return name
    return bands[-1][1]


def feature_key(feats: dict) -> Tuple[str, str, str]:
    """The bin a graph's timings are filed under:
    ``("w:<bucket_width>", "skew:<low|mid|high>", "dens:<thin|sparse|dense>")``.
    """
    return (
        f"w:{feats['bucket_width']}",
        f"skew:{_band(feats['skew'], _SKEW_BANDS)}",
        f"dens:{_band(feats['density'], _DENSITY_BANDS)}",
    )


_SKEW_ORD = {"low": 0, "mid": 1, "high": 2}
_DENS_ORD = {"thin": 0, "sparse": 1, "dense": 2}


def _key_distance(a: Tuple[str, str, str], b: Tuple[str, str, str]) -> float:
    """Ordinal distance between feature bins (the nearest-bin fallback)."""
    wa, wb = int(a[0][2:]), int(b[0][2:])
    dw = abs(max(wa, 1).bit_length() - max(wb, 1).bit_length())
    ds = abs(_SKEW_ORD[a[1][5:]] - _SKEW_ORD[b[1][5:]])
    dd = abs(_DENS_ORD[a[2][5:]] - _DENS_ORD[b[2][5:]])
    return dw + ds + dd


@dataclasses.dataclass
class CalibrationTable:
    """Per-device lane timings, keyed by feature bin.

    ``entries[key][lane]`` is the lane's seconds for that bin (the best
    seen across the calibration graphs in it); ``sources[key]`` says
    whether the bin was "measured" (timed runs) or "analytic" (the bound
    of ``launch.roofline``, the cold-start seed).
    """

    device: str
    entries: Dict[Tuple[str, str, str], Dict[str, float]] = \
        dataclasses.field(default_factory=dict)
    sources: Dict[Tuple[str, str, str], str] = \
        dataclasses.field(default_factory=dict)
    schema: int = CALIB_SCHEMA_VERSION

    def record(self, key: Tuple[str, str, str], timings: Dict[str, float],
               source: str) -> None:
        """Merge one bin's timings. Measured beats analytic; two measured
        visits keep the per-lane minimum."""
        have = self.sources.get(key)
        if have == "measured" and source == "analytic":
            return
        if have is None or (have == "analytic" and source == "measured"):
            self.entries[key] = dict(timings)
            self.sources[key] = source
            return
        merged = self.entries[key]
        for lane, t in timings.items():
            merged[lane] = min(merged.get(lane, float("inf")), float(t))

    def lookup(self, g) -> Optional[Dict[str, float]]:
        """The exact bin's timings for ``g``, or None."""
        return self.entries.get(feature_key(graph_features(g)))

    def choose(self, g) -> Optional[str]:
        """The fastest lane of ``g``'s bin (the nearest bin on a miss), or
        None when the table is empty. Ties break lexicographically."""
        if not self.entries:
            return None
        key = feature_key(graph_features(g))
        timings = self.entries.get(key)
        if timings is None:
            key = min(self.entries, key=lambda k: (_key_distance(k, key), k))
            timings = self.entries[key]
        if not timings:
            return None
        return min(sorted(timings), key=lambda lane: timings[lane])


# ---------------------------------------------------------------------------
# Analytic seeding: price plans without running them
# ---------------------------------------------------------------------------

def price_plan(plan) -> float:
    """Analytic seconds of one plan's ``count()``: the sum over its stages
    of each stage's H100 bound (``launch.roofline.price_stage``). A lower
    bound that grows with the work a lane gives the card, which is all a
    ranking needs. No kernel runs."""
    from repro_torch.launch.roofline import plan_seconds

    return plan_seconds(plan)


def _build_plan(g, lane: str, options: CountOptions, device: torch.device):
    planner = registry.get_algorithm(lane)
    return planner(g, options.replace(algorithm=lane), device=device)


def analytic_seed(g, lanes: Sequence[str] = CHOOSER_LANES,
                  options: Optional[CountOptions] = None, *,
                  device: Device = None) -> Dict[str, float]:
    """Cold-start lane prices for one graph: {lane: analytic seconds}.

    Each lane's plan is built on ``device`` (its prep runs) and priced;
    equal ``CountOptions`` give bit-equal prices.
    """
    options = options if options is not None else CountOptions()
    dev = resolve_device(device)
    return {lane: price_plan(_build_plan(g, lane, options, dev))
            for lane in lanes}


# ---------------------------------------------------------------------------
# Measurement
# ---------------------------------------------------------------------------

def measure_lanes(g, lanes: Sequence[str] = CHOOSER_LANES,
                  options: Optional[CountOptions] = None, *,
                  iters: int = 2, warmup: int = 1,
                  device: Device = None) -> Dict[str, float]:
    """Warm count seconds per lane: {lane: best of ``iters``}.

    Times ``plan.count()``, which ends in a host sync, after ``warmup``
    untimed runs; prep is excluded. Each lane's plan is dropped before the
    next is built.
    """
    options = options if options is not None else CountOptions()
    dev = resolve_device(device)
    out: Dict[str, float] = {}
    for lane in lanes:
        plan = _build_plan(g, lane, options, dev)
        for _ in range(max(0, warmup)):
            plan.count()
        best = float("inf")
        for _ in range(max(1, iters)):
            t0 = time.perf_counter()
            plan.count()
            best = min(best, time.perf_counter() - t0)
        out[lane] = best
        del plan
    return out


def calibrate(graphs: Sequence, *, lanes: Sequence[str] = CHOOSER_LANES,
              options: Optional[CountOptions] = None, iters: int = 2,
              warmup: int = 1, measure: bool = True,
              device: Device = None,
              label: Optional[str] = None) -> CalibrationTable:
    """Build a :class:`CalibrationTable` from a sweep of graphs.

    Args:
      graphs: the calibration graphs; each lands in its feature bin.
      lanes: the lanes to rank (default ``CHOOSER_LANES``).
      options: the ``CountOptions`` the plans are built with (default
        ``CountOptions()``).
      iters / warmup: the timed and untimed counts of each lane.
      measure: True times the counts (source "measured"); False prices
        the plans with ``price_plan`` (source "analytic"), and no kernel
        runs.
      device: where the plans run; None means the card (``device="cpu"``
        runs the plain versions).
      label: the table's device label; default ``device_label(device)``.
    """
    dev = resolve_device(device)
    table = CalibrationTable(device=label or device_label(dev))
    for g in graphs:
        key = feature_key(graph_features(g))
        if measure:
            timings = measure_lanes(g, lanes, options, iters=iters,
                                    warmup=warmup, device=dev)
            table.record(key, timings, "measured")
        else:
            table.record(key, analytic_seed(g, lanes, options, device=dev),
                         "analytic")
    return table


# ---------------------------------------------------------------------------
# Persistence: the CALIB_<device>.json sidecar
# ---------------------------------------------------------------------------

def save_table(table: CalibrationTable, path: str) -> str:
    """Write the sidecar (schema above); returns ``path``."""
    doc = {
        "schema": table.schema,
        "device": table.device,
        "created_unix": time.time(),
        "entries": [
            {"key": list(key), "timings": dict(table.entries[key]),
             "source": table.sources.get(key, "measured")}
            for key in sorted(table.entries)
        ],
    }
    with open(path, "w") as f:
        json.dump(doc, f, indent=1, sort_keys=True)
    return path


def load_table(path: str) -> CalibrationTable:
    """Read and validate a sidecar.

    Raises:
      ValueError: an unknown schema version or a malformed entry key (the
        default-table search catches it and falls back to the heuristic).
    """
    with open(path) as f:
        doc = json.load(f)
    if doc.get("schema") != CALIB_SCHEMA_VERSION:
        raise ValueError(
            f"calibration sidecar {path!r} has schema {doc.get('schema')!r}; "
            f"this build reads schema {CALIB_SCHEMA_VERSION}"
        )
    table = CalibrationTable(device=str(doc.get("device", "unknown")))
    for ent in doc.get("entries", []):
        key = tuple(ent["key"])
        if len(key) != 3:
            raise ValueError(f"malformed entry key {key!r} in {path!r}")
        timings = {str(k): float(v) for k, v in ent["timings"].items()}
        table.record(key, timings, str(ent.get("source", "measured")))
    return table


# ---------------------------------------------------------------------------
# Chooser wiring
# ---------------------------------------------------------------------------

_DEFAULT_TABLE: Optional[CalibrationTable] = None
_DEFAULT_LOADED = False


def set_default_table(table: Optional[CalibrationTable]
                      ) -> Optional[CalibrationTable]:
    """Install the process-wide table ``chooser="measured"`` consults.

    None clears it and re-arms the search on disk (the ``TC_CALIB`` path,
    else ``./CALIB_<device>.json``). Returns the previous table.
    """
    global _DEFAULT_TABLE, _DEFAULT_LOADED
    previous = _DEFAULT_TABLE
    _DEFAULT_TABLE = table
    _DEFAULT_LOADED = table is not None
    return previous


def get_default_table() -> Optional[CalibrationTable]:
    """The process-wide table, its sidecar loaded on first use; None when
    there is none or it cannot be read."""
    global _DEFAULT_TABLE, _DEFAULT_LOADED
    if not _DEFAULT_LOADED:
        path = os.environ.get("TC_CALIB") or calib_path(".")
        if os.path.exists(path):
            try:
                _DEFAULT_TABLE = load_table(path)
            except (ValueError, OSError, KeyError, TypeError):
                _DEFAULT_TABLE = None  # a corrupt sidecar: the heuristic
        _DEFAULT_LOADED = True
    return _DEFAULT_TABLE


def choose_measured(g, table: Optional[CalibrationTable] = None, *,
                    mesh=None) -> str:
    """Resolve ``algorithm="auto"`` through a calibration table.

    The exact bin's fastest lane, else the nearest bin's; with no table, an
    empty one or a lane name that is not registered, the heuristic
    ``registry._default_chooser``. Under a ``mesh`` of more than one rank
    the pick is promoted to its sharded lane
    (``registry._promote_distributed``). Always a registered lane.
    """
    table = table if table is not None else get_default_table()
    lane = None
    if table is not None:
        lane = table.choose(g)
        if lane is not None and lane not in registry.available_algorithms():
            lane = None
    if lane is None:
        lane = registry._default_chooser(g)
    return registry._promote_distributed(lane, mesh)


def install_measured_chooser(table: Optional[CalibrationTable] = None
                             ) -> Callable:
    """Swap the process-wide ``algorithm="auto"`` chooser for the measured
    one (for callers that never touch ``CountOptions``). Returns the
    previous chooser: pass it to ``registry.set_auto_chooser`` to restore
    it."""
    return registry.set_auto_chooser(lambda g: choose_measured(g, table))
