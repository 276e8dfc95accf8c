"""Seconds a solve of a new graph takes, the mean over the window:
``TriangleCounter(g).count()`` from the host CSR, prep included. Only a
mix that builds a session a call has solves."""


UNIT = "s"


def read(run):
    if run.mode != "fresh" or not run.latencies_s:
        return None
    return sum(run.latencies_s) / len(run.latencies_s)
