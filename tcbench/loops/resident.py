"""GraphChallenge's timing of a static count: one resident session, one
client calling ``count()`` back to back.

Set-up builds one ``TriangleCounter`` and prepares its plan, then counts
at least ``warm_counts`` times and for at least ``warm_seconds``, so that
the card reaches its working clocks before the window. The window calls
``count()`` on that session; the program's ``count()`` ends in its host
sync.
"""

from __future__ import annotations

import time

from tcbench.loop import closed_window, peak_start


def measure(mix, make_graph, options, device, seconds, trace):
    from repro_torch.core.api import TriangleCounter

    graph = make_graph(0)
    phases = {"inputs": time.perf_counter()}
    held, inputs_peak = peak_start(device)
    session = TriangleCounter(graph, device=device, **options)
    first = session.count()
    prep = [float(first.prep_seconds)]
    del first
    phases["session"] = time.perf_counter()
    warm_until = time.perf_counter() + float(mix.get("warm_seconds", 0))
    done = 0
    while done < int(mix["warm_counts"]) or time.perf_counter() < warm_until:
        session.count()
        done += 1
    return closed_window(session.count, device, seconds, trace, False, prep,
                         phases, held, inputs_peak)
