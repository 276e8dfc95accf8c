"""Fault tolerance and elasticity: a heartbeat, the microbatch rescale
and the auto-resuming trainer shell.

The port of ``repro.train.elastic``. Checkpoints are written atomically
every N steps (``checkpoint.py``) and the driver resumes from
``latest_step`` on boot; the data pipeline's state is one integer
(``data.py`` is step-indexed), so a resume is exact. Checkpoints do not
depend on the mesh: a restore places each leaf on the live mesh (the
sharded leaves of ``like``, or ``shardings``), so a run saved on one mesh
restarts on another, or on one card, and ``rescale_microbatches`` keeps
the global batch when the data-parallel size changes.
"""

from __future__ import annotations

import dataclasses
import json
import time
from typing import Callable, Optional

import torch

from repro_torch.train import checkpoint as ckpt

__all__ = ["Heartbeat", "ElasticTrainer", "rescale_microbatches"]


def _process_index() -> int:
    dist = torch.distributed
    return (dist.get_rank()
            if dist.is_available() and dist.is_initialized() else 0)


class Heartbeat:
    """Liveness file a watchdog polls; a stale mtime means the host is to
    be replaced. ``process`` is the ``torch.distributed`` rank, or 0."""

    def __init__(self, path: str, interval_s: float = 30.0):
        self.path = path
        self.interval_s = interval_s
        self._last = 0.0

    def beat(self, step: int) -> None:
        now = time.time()
        if now - self._last >= self.interval_s:
            with open(self.path, "w") as f:
                json.dump({"step": step, "time": now,
                           "process": _process_index()}, f)
            self._last = now


def rescale_microbatches(old_micro: int, old_dp: int, new_dp: int) -> int:
    """Preserve the global batch across a data-parallel rescale.

    Raises:
      ValueError: ``old_micro · old_dp`` is not a multiple of ``new_dp``.
    """
    total = old_micro * old_dp
    if total % new_dp:
        raise ValueError(f"{old_micro} microbatches x {old_dp} replicas do "
                         f"not split over {new_dp}")
    return total // new_dp


@dataclasses.dataclass
class ElasticTrainer:
    """Auto-resuming training-loop shell: owns the checkpoint cadence, the
    heartbeat and the restore."""

    ckpt_dir: str
    save_every: int = 100
    keep: int = 3
    heartbeat: Optional[Heartbeat] = None

    def resume_or_init(self, init_fn: Callable, like=None, shardings=None):
        """Returns (state, start_step). ``init_fn()`` builds fresh state;
        with a committed checkpoint, ``like`` (default ``init_fn()``) is
        overwritten in place by the newest one, its plain leaves placed by
        ``shardings`` where given (``checkpoint.restore_checkpoint``), and
        the start step is its ``next_step``."""
        step = ckpt.latest_step(self.ckpt_dir)
        if step is None:
            return init_fn(), 0
        like = like if like is not None else init_fn()
        state, extra = ckpt.restore_checkpoint(self.ckpt_dir, step, like,
                                               shardings)
        return state, int(extra.get("next_step", step))

    def maybe_save(self, step: int, state, *, force: bool = False) -> None:
        """Beat, and save ``state`` as ``step`` (resuming at ``step + 1``)
        when ``force`` or every ``save_every`` steps after step 0."""
        if self.heartbeat is not None:
            self.heartbeat.beat(step)
        if force or (step > 0 and step % self.save_every == 0):
            ckpt.save_checkpoint(self.ckpt_dir, step, state,
                                 extra={"next_step": step + 1}, keep=self.keep)
