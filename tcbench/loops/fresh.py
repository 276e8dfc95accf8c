"""What most users pay: a new graph each solve, one client solving back to
back.

Set-up makes ``pool`` inputs, each another variant of the seed's graph (a
relabelling, or leaves hung elsewhere: the same count), and solves the
first ``warm_solves`` times. The window solves the inputs in turn, each as
a new ``TriangleCounter(g).count()`` from the host CSR, prep included.
"""

from __future__ import annotations

import time

from tcbench.loop import closed_window, peak_start


def measure(mix, make_graph, options, device, seconds, trace):
    from repro_torch.core.api import TriangleCounter

    graphs = [make_graph(v) for v in range(int(mix["pool"]))]
    phases = {"inputs": time.perf_counter()}
    held, inputs_peak = peak_start(device)
    for _ in range(int(mix["warm_solves"])):
        TriangleCounter(graphs[0], device=device, **options).count()
    turn = [0]

    def call():
        g = graphs[turn[0] % len(graphs)]
        turn[0] += 1
        return TriangleCounter(g, device=device, **options).count()

    return closed_window(call, device, seconds, trace, True, [], phases, held,
                         inputs_peak)
