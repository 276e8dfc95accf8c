"""Device memory the program's session took at its peak, in GiB:
``torch.cuda.max_memory_allocated()`` from a reset before the session is
built, less what was held then."""


def read(run):
    if run.device_kind is None:
        return None
    return run.session_peak_bytes / 2**30
