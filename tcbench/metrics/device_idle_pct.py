"""The share of the traced window, in %, in which the card ran no kernel,
copy or fill."""


def read(run):
    tr = run.trace
    if tr is None or tr.window_s <= 0 or tr.busy_s <= 0:
        return None
    return (1.0 - tr.busy_s / tr.window_s) * 100.0
