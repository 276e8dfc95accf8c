"""Run one cell traced, and put its device time and idle time down to the
program's ``tc.*`` spans.

    python3 tcbench/spanrun.py --workload graph500-s19.warm --seed 7 \\
        --seconds 10
    python3 tcbench/spanrun.py --config graph500-s19 --traffic fresh \\
        --seed 7 --seconds 10

Runs ``run.py`` as it is, with ``--trace 1``, and reduces the profiler
events its trace summary reads once more with ``tcbench.spans``. Prints
run.py's output, then one JSON line::

    {"program": {"counts", "api_self_us", "count_idle_us",
                 "count_device_ms", "busy_s", "linked", "device_by_span_s",
                 "device_by_span": [[key, s], ...],
                 "idle_by_span": [[key, s], ...],
                 "by_name": {name: {calls, total_s, self_s, device_s,
                                    idle_s}}}}

A program without spans reads ``counts`` 0 and null readings. The
benchmark's own runs do not run this.
"""

from __future__ import annotations

import json
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def main(argv=None) -> int:
    argv = list(sys.argv[1:] if argv is None else argv)
    if "--trace" not in argv:
        argv += ["--trace", "1"]
    sys.path[:0] = [str(ROOT / "src"), str(ROOT)]
    from tcbench import harness, run, spans
    from tcbench.trace import Trace

    found = []

    class SpanTrace(Trace):
        def summary(self):
            out = Trace.summary(self)
            if out is not None and out.timer == "profiler":
                ev = spans.collect(
                    self._prof.profiler.kineto_results.events())
                found.append((out.busy_s, ev.linked,
                              spans.program_spans(ev)))
            return out

    harness.Trace = SpanTrace
    rc = run.main(argv)
    for busy_s, linked, prog in found:
        print(json.dumps({"program": dict(
            counts=prog.counts, api_self_us=prog.api_self_us(),
            count_idle_us=prog.count_idle_us(),
            count_device_ms=prog.count_device_ms(), busy_s=busy_s,
            linked=linked,
            device_by_span_s=sum(prog.device_by_span.values()),
            device_by_span=prog.top("device_by_span"),
            idle_by_span=prog.top("idle_by_span"),
            by_name=prog.by_name)}), flush=True)
    return rc


if __name__ == "__main__":
    sys.exit(main())
