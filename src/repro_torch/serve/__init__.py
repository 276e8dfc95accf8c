"""``repro_torch.serve``: the concurrent triangle-counting service.

The port of ``repro.serve``. The GraphChallenge framing of the workload is
repeated counting over a stream of graphs: throughput across many inputs
is the figure of merit. This package puts the port's engine (its lanes,
the measured ``auto`` chooser, the stacked ``GraphBatch`` launches,
dynamic sessions) behind a service:

    TriangleService: accepts concurrent per-tenant requests ("count",
        "vertex", "edge_support", "k_truss", "update"), each resolved by a
        future (``repro_torch.serve.service``); on the card unless given
        ``device="cpu"``.
    ServeConfig / ServeResult: the knobs and the per-request outcome.
    RequestShed: the typed rejection (reasons SHED_QUEUE_FULL /
        SHED_DEADLINE / SHED_SHUTDOWN) raised by the futures of requests
        the admission queue sheds.
    AdmissionQueue: the bounded FIFO with compatible-take
        (``repro_torch.serve.queueing``).
    Coalescer: compatible requests grouped into one launch per width over
        a bounded prep cache (``repro_torch.serve.coalescer``).
    MetricsRegistry / LatencyStat: counters and bounded latency stats; the
        service's ``snapshot()`` folds in the engine's cache counters
        (``repro_torch.serve.metrics``).
"""

from repro_torch.serve.coalescer import Coalescer, PreppedGraph
from repro_torch.serve.metrics import LatencyStat, MetricsRegistry
from repro_torch.serve.queueing import (
    SHED_DEADLINE,
    SHED_QUEUE_FULL,
    SHED_SHUTDOWN,
    AdmissionQueue,
    RequestShed,
)
from repro_torch.serve.service import (
    KINDS,
    ServeConfig,
    ServeResult,
    TriangleService,
)

__all__ = [
    "AdmissionQueue",
    "Coalescer",
    "KINDS",
    "LatencyStat",
    "MetricsRegistry",
    "PreppedGraph",
    "RequestShed",
    "SHED_DEADLINE",
    "SHED_QUEUE_FULL",
    "SHED_SHUTDOWN",
    "ServeConfig",
    "ServeResult",
    "TriangleService",
]
