"""Reference loader for the port's parity tests (``tests/test_torch_*.py``).

The JAX package ``repro`` is the reference the port is held against. On
JAX releases that dropped ``jax.experimental.enable_x64``,
``repro.graphs.device`` fails to import; the ``ref`` fixture applies the
shim ``jax.experimental.enable_x64 = jax.enable_x64`` and imports the
reference at test time, never while a module is imported, so the rest of
the suite collects exactly as it would without this file. At teardown the
fixture removes the shim and every ``repro`` module it imported, so later
tests in the same process see the reference as they would have.

Use it by importing the fixture into a test module::

    from torch_reference import ref  # noqa: F401
"""

from __future__ import annotations

import importlib
import sys
import types

import pytest

_MODULES = {
    "formats": "repro.graphs.formats",
    "generators": "repro.graphs.generators",
    "datasets": "repro.graphs.datasets",
    "device": "repro.graphs.device",
    "oracle": "repro.core.oracle",
    "prep": "repro.core.prep",
    "options": "repro.core.options",
    "registry": "repro.core.registry",
    "engine": "repro.core.engine",
    "api": "repro.core.api",
    "ops": "repro.kernels.intersect.ops",
    "kref": "repro.kernels.intersect.ref",
    "bitmap": "repro.kernels.intersect.bitmap",
    "probe": "repro.kernels.intersect.probe",
    "intersect": "repro.kernels.intersect.intersect",
    "msops": "repro.kernels.masked_spgemm.ops",
    "msref": "repro.kernels.masked_spgemm.ref",
    "mskernel": "repro.kernels.masked_spgemm.masked_spgemm",
    "tc_matrix": "repro.core.tc_matrix",
    "tc_subgraph": "repro.core.tc_subgraph",
    "hashops": "repro.kernels.hash_tc.ops",
    "hashbuild": "repro.kernels.hash_tc.build",
    "hashprobe": "repro.kernels.hash_tc.probe",
    "hashref": "repro.kernels.hash_tc.ref",
}


def _is_reference(name: str) -> bool:
    return name == "repro" or name.startswith("repro.")


@pytest.fixture(scope="module")
def ref():
    """Namespace of reference modules (``ref.generators``, ``ref.prep``,
    ``ref.ops``, ``ref.msops``, ``ref.hashops``, ``ref.tc_subgraph``, ...),
    imported under
    the enable_x64 shim."""
    import jax
    import jax.experimental

    before = set(sys.modules)
    added_shim = not hasattr(jax.experimental, "enable_x64")
    if added_shim:
        jax.experimental.enable_x64 = jax.enable_x64
    try:
        yield types.SimpleNamespace(
            **{k: importlib.import_module(v) for k, v in _MODULES.items()})
    finally:
        if added_shim:
            del jax.experimental.enable_x64
        for name in sorted(set(sys.modules) - before, reverse=True):
            if not _is_reference(name):
                continue
            mod = sys.modules.pop(name)
            parent, _, child = name.rpartition(".")
            if parent in sys.modules and getattr(sys.modules[parent], child,
                                                 None) is mod:
                delattr(sys.modules[parent], child)
