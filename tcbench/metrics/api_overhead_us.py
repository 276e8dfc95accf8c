"""The front door's own cost a call, in us: the mean over the window of the
harness's span around each call, less the ``exec_seconds`` the program
reports for it (timed around the plan's replay)."""


def read(run):
    if not run.latencies_s:
        return None
    gap = sum(a - b for a, b in zip(run.latencies_s, run.exec_s))
    return gap / len(run.latencies_s) * 1e6
