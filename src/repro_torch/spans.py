"""Named spans at the layer boundaries of the count and prep paths.

``span(name)`` is a context manager. While a ``torch.profiler`` is
recording on the calling thread it is ``record_function(name)``, so the
span lands in the profiler's trace on the same clock as the device's
kernels, copies and fills, and ``export_chrome_trace`` writes it out with
them. Otherwise it is one shared inert object: a span then costs one flag
test, and records, formats, allocates and launches nothing.

Every name starts with ``tc.``; the names are constants, or strings built
once when a plan binds its stages, so the count path formats none.

This module imports only torch, so that the kernel packages can import it
without going through ``repro_torch.core``.
"""

from __future__ import annotations

import torch
from torch.profiler import record_function

__all__ = ["span"]

_recording = torch._C._autograd._profiler_enabled


class _Inert:
    __slots__ = ()

    def __enter__(self):
        return None

    def __exit__(self, *exc):
        return False


_INERT = _Inert()


def span(name: str):
    """A context manager that marks ``name`` in a recording profiler's
    trace, or the shared inert one when no profiler records."""
    if _recording():
        return record_function(name)
    return _INERT
