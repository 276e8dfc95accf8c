"""The count's share of its roofline, in %: the least time an exact count
of the input graph can take (``tcbench.roofline``: the graph read once at
the card's published HBM rate) over the device time of one count in the
traced window. Only where the window calls one resident session does all
of its device time belong to counts."""

from tcbench.roofline import count_bound_seconds


def read(run):
    tr = run.trace
    if (run.mode != "resident" or tr is None or tr.busy_s <= 0
            or not run.counts or run.peaks is None):
        return None
    per_count = tr.busy_s / len(run.counts)
    bound = count_bound_seconds(run.n, run.m_undirected,
                                run.peaks["hbm_bytes_per_s"])
    return bound / per_count * 100.0
