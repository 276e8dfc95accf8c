"""The 95th percentile, in ms, of every call of the window, each timed on
the host from call to return (the call ends in the program's host sync)."""

import statistics


def read(run):
    if len(run.latencies_s) < 2:
        return None
    q = statistics.quantiles(run.latencies_s, n=20, method="inclusive")
    return q[18] * 1e3
