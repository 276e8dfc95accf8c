"""Reference loader for the port's parity tests (``tests/test_torch_*.py``).

The JAX package ``repro`` is the reference the port is held against. On
JAX releases that dropped ``jax.experimental.enable_x64``,
``repro.graphs.device`` fails to import; the ``ref`` fixture applies the
shim ``jax.experimental.enable_x64 = jax.enable_x64`` and imports the
reference at test time, never while a module is imported, so the rest of
the suite collects exactly as it would without this file. At teardown the
fixture removes the shim and every ``repro`` module it imported, so later
tests in the same process see the reference as they would have.

The ``lmref`` fixture does the same for the language-model scaffolding
(models, configs, serve step, flash attention, and the training modules:
data, optimizer, train step, checkpoint).

On JAX releases that dropped ``pallas.load``, the reference's Pallas flash
kernel (``repro.kernels.flash_attention``) fails while it traces. Importing
this file sets ``pl.load = lambda ref, idx: ref[idx]``, what ``pallas.load``
did for the unmasked loads the kernel makes, and leaves it for the rest of
the process. The port's test modules import this file while they are
collected, so under pytest-xdist every worker has the shim before its first
test, and the reference's own flash tests (``tests/test_kernels.py``) run
the kernel whichever worker takes them, instead of passing only when JAX's
jit cache already holds their shapes. Nothing is shimmed where JAX is
missing or still has ``pallas.load``.

Use them by importing the fixture into a test module::

    from torch_reference import ref  # noqa: F401
    from torch_reference import lmref  # noqa: F401
"""

from __future__ import annotations

import contextlib
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
    "listing": "repro.core.listing",
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
    "calibrate": "repro.core.calibrate",
    "tc_intersection": "repro.core.tc_intersection",
    "queueing": "repro.serve.queueing",
    "metrics": "repro.serve.metrics",
    "coalescer": "repro.serve.coalescer",
    "service": "repro.serve.service",
}


_LM_MODULES = {
    "config": "repro.models.config",
    "registry": "repro.models.registry",
    "layers": "repro.models.layers",
    "transformer": "repro.models.transformer",
    "encdec": "repro.models.encdec",
    "ssm": "repro.models.ssm",
    "rglru": "repro.models.rglru",
    "serve_step": "repro.train.serve_step",
    "flash": "repro.kernels.flash_attention.flash_attention",
    "flashref": "repro.kernels.flash_attention.ref",
    "flashops": "repro.kernels.flash_attention.ops",
    "data": "repro.train.data",
    "optimizer": "repro.train.optimizer",
    "train_step": "repro.train.train_step",
    "checkpoint": "repro.train.checkpoint",
}


def _shim_pallas_load() -> None:
    try:
        from jax.experimental import pallas as pl
    except ImportError:
        return
    if not hasattr(pl, "load"):
        pl.load = lambda ref, idx: ref[idx]


_shim_pallas_load()


def _is_reference(name: str) -> bool:
    return name == "repro" or name.startswith("repro.")


@contextlib.contextmanager
def _reference(modules):
    """Apply the shims, import ``modules`` and yield them as a namespace;
    afterwards remove the shims and every ``repro`` module imported."""
    import jax
    import jax.experimental

    before = set(sys.modules)
    added_shim = not hasattr(jax.experimental, "enable_x64")
    if added_shim:
        jax.experimental.enable_x64 = jax.enable_x64
    try:
        yield types.SimpleNamespace(
            **{k: importlib.import_module(v) for k, v in modules.items()})
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


@pytest.fixture(scope="module")
def ref():
    """Namespace of reference modules (``ref.generators``, ``ref.prep``,
    ``ref.ops``, ``ref.msops``, ``ref.hashops``, ``ref.tc_subgraph``,
    ``ref.calibrate``, ``ref.service``, ...), imported under the enable_x64
    shim."""
    with _reference(_MODULES) as ns:
        yield ns


@pytest.fixture(scope="module")
def lmref():
    """Namespace of the reference's LM modules (``lmref.config``,
    ``lmref.registry``, ``lmref.layers``, ``lmref.transformer``,
    ``lmref.encdec``, ``lmref.ssm``, ``lmref.rglru``, ``lmref.serve_step``, ``lmref.flash``, ``lmref.flashref``,
    ``lmref.flashops``, ``lmref.data``, ``lmref.optimizer``,
    ``lmref.train_step``, ``lmref.checkpoint``), imported under the
    enable_x64 shim (``pl.load`` is set when this file is imported)."""
    with _reference(_LM_MODULES) as ns:
        yield ns
