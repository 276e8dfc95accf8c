"""Kernel launches of the program a count, from its launch counters
(``LAUNCHES`` of each kernel package) over the window."""


def read(run):
    if not run.counts or run.device_kind is None:
        return None
    return sum(run.launches.values()) / len(run.counts)
