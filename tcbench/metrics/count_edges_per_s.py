"""Edges counted per second: the input graph's undirected edges times the
counts completed, over the whole window (GraphChallenge's rate)."""


def read(run):
    if not run.counts or run.window_s <= 0:
        return None
    return run.m_undirected * len(run.counts) / run.window_s
