"""Algorithm registry + the cross-lane ``algorithm="auto"`` chooser.

The port of ``repro.core.registry``. Each lane registers a planner —
``planner(g, options, *, device, mesh=None) -> plan`` where the plan
exposes ``count()``, ``meta`` and ``prep_seconds`` — and the facade
(``repro_torch.core.api.TriangleCounter``) looks lanes up by name. The
single-card planners ignore ``mesh``.

The builtin lanes are the paper's three formulations, ``"intersection"``
(``core.engine``), ``"subgraph"`` (``core.tc_subgraph``) and ``"matrix"``
(``core.tc_matrix``), the TRUST-style ``"hash"`` and level-ordered
``"bfs"`` lanes, the ``"edge"`` lane (edge support, k-truss) and the
``"dynamic"`` lane (``core.engine``), and the sharded
``"intersection_distributed"`` / ``"matrix_distributed"`` lanes
(``core.distributed``). The default chooser is the reference's heuristic
unchanged, so ``auto`` resolves on every graph and never picks hash, bfs,
edge or dynamic: those run when they are asked for by name, or when a
chooser installed with ``set_auto_chooser`` (such as
``core.calibrate.install_measured_chooser``) picks them. With a mesh of
more than one rank, ``choose_algorithm(g, mesh=)`` promotes the pick to
its sharded lane.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, Optional

__all__ = [
    "OneShotPlan",
    "available_algorithms",
    "choose_algorithm",
    "get_algorithm",
    "register_algorithm",
    "set_auto_chooser",
]

_REGISTRY: Dict[str, Callable] = {}


def register_algorithm(name: str, planner: Callable, *,
                       overwrite: bool = False) -> None:
    """Register a lane under ``name``.

    Args:
      name: lane name ``CountOptions(algorithm=...)`` selects.
      planner: ``planner(g, options, *, device, mesh=None)`` returning a
        plan.
      overwrite: allow replacing an existing registration.
    """
    if not name or not isinstance(name, str):
        raise ValueError(f"algorithm name must be a non-empty str, got {name!r}")
    if not callable(planner):
        raise ValueError(f"planner for {name!r} must be callable")
    if not overwrite and name in _REGISTRY and _REGISTRY[name] is not planner:
        raise ValueError(f"algorithm {name!r} is already registered; "
                         f"pass overwrite=True to replace it")
    _REGISTRY[name] = planner


def _ensure_builtin() -> None:
    """Import the builtin lane modules so their registrations have run."""
    import repro_torch.core.engine  # noqa: F401  (intersection, hash, bfs, edge, dynamic)
    import repro_torch.core.distributed  # noqa: F401  (the *_distributed lanes)
    import repro_torch.core.tc_matrix  # noqa: F401  (registers "matrix")
    import repro_torch.core.tc_subgraph  # noqa: F401  (registers "subgraph")


def get_algorithm(name: str) -> Callable:
    """The registered planner for ``name``; ValueError lists what exists."""
    _ensure_builtin()
    try:
        return _REGISTRY[name]
    except KeyError:
        raise ValueError(
            f"unknown algorithm {name!r}; registered: {available_algorithms()}"
        ) from None


def available_algorithms() -> tuple:
    """Sorted names of every registered lane."""
    _ensure_builtin()
    return tuple(sorted(_REGISTRY))


@dataclasses.dataclass
class OneShotPlan:
    """The plan surface the facade consumes (``count()``, ``meta``,
    ``prep_seconds``, ``executions``) around a callable that counts from
    scratch on every ``count()``: an adapter for lanes without a
    prepared plan, as in the reference."""

    fn: Callable[[], int]
    algorithm: str
    meta: Dict[str, Any] = dataclasses.field(default_factory=dict)
    prep_seconds: float = 0.0
    executions: int = 0

    def count(self) -> int:
        out = int(self.fn())
        self.executions += 1
        return out


# The reference's thresholds: mesh-like graphs sit at max degree ≤ 10 with
# skew (max/avg degree) ≤ ~2, scale-free R-MAT graphs at skew ≥ 12, and only
# dense complete-graph fixtures reach density ≥ 0.25.
MESH_MAX_DEGREE = 12
MESH_MAX_SKEW = 3.0
DENSE_MIN_DENSITY = 0.25
DENSE_MAX_N = 512


def _default_chooser(g) -> str:
    """Pick a lane from graph shape (the reference's documented rules):

    1. **matrix** when the graph is small and dense (density ≥ 0.25,
       n ≤ 512);
    2. **subgraph** when it is mesh-like (max degree ≤ 12 and skew ≤ 3);
    3. **intersection** otherwise — the paper's overall winner (Fig. 5).

    It names the formulation only; ``choose_algorithm(g, mesh=)`` promotes
    it to a sharded lane afterwards (``_promote_distributed``).
    """
    n, m, dmax = g.n, g.m_undirected, g.max_degree
    if n < 3 or m == 0:
        return "intersection"
    avg_deg = 2.0 * m / n
    density = 2.0 * m / (n * (n - 1)) if n > 1 else 0.0
    skew = dmax / max(avg_deg, 1e-9)
    if density >= DENSE_MIN_DENSITY and n <= DENSE_MAX_N:
        return "matrix"
    if dmax <= MESH_MAX_DEGREE and skew <= MESH_MAX_SKEW:
        return "subgraph"
    return "intersection"


_CHOOSER: Callable = _default_chooser


def _promote_distributed(lane: str, mesh) -> str:
    """A pick's sharded counterpart when ``mesh`` has more than one rank.

    No mesh, or a mesh of one rank, leaves the pick as it is. "matrix"
    becomes "matrix_distributed"; every other lane (subgraph, hash and bfs
    have no sharded form) becomes "intersection_distributed", the dealt
    degree buckets, as in the reference. A sharded pick passes through.
    """
    if mesh is None or int(mesh.size()) <= 1:
        return lane
    if lane.endswith("_distributed"):
        return lane
    if lane == "matrix":
        return "matrix_distributed"
    return "intersection_distributed"


def choose_algorithm(g, mesh=None) -> str:
    """Resolve ``algorithm="auto"`` for graph ``g`` through the current
    chooser (``_default_chooser`` unless ``set_auto_chooser`` swapped it),
    promoted to its sharded lane under a ``mesh`` of more than one rank
    (``_promote_distributed``).

    Raises:
      ValueError: the chooser named a lane that is not registered.
    """
    lane = _promote_distributed(_CHOOSER(g), mesh)
    _ensure_builtin()
    if lane not in _REGISTRY:
        raise ValueError(
            f"auto chooser returned unregistered lane {lane!r}; "
            f"registered: {available_algorithms()}"
        )
    return lane


def set_auto_chooser(chooser: Optional[Callable] = None) -> Callable:
    """Override the ``algorithm="auto"`` chooser process-wide.

    Args:
      chooser: ``chooser(g) -> lane name``, or None to restore the default.

    Returns:
      The previously active chooser (so callers can restore it).
    """
    global _CHOOSER
    previous = _CHOOSER
    _CHOOSER = chooser if chooser is not None else _default_chooser
    return previous
