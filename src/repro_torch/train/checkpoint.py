"""Fault-tolerant checkpointing: atomic, GC'd, restored in place.

The port of ``repro.train.checkpoint``, single process:

  * ATOMICITY — write to ``<dir>/tmp.<step>`` then ``os.rename`` to
    ``step_<n>`` (the commit point); a crash mid-write never corrupts the
    latest checkpoint.
  * GC — the ``keep`` most recent checkpoints are retained.
  * AUTO-RESUME — ``latest_step`` scans the directory; the train driver
    calls it on startup (``repro_torch.train.elastic``).

A state is a tree of nested mappings and named tuples (``OptState``) of
tensors. Its leaves are keyed by "/"-joined paths of the port's own names
(``params/blocks.0.attn.wq.w``, ``opt/mu/embed``, ``opt/step``) and stored
as full host numpy arrays, one ``arrays/<i>.npy`` file a leaf in key order
(the reference keeps one ``arrays.npz``, whose zip entries numpy writes
chunk by chunk with a CRC over every byte); ``manifest.json`` holds
the step, the keys, each leaf's file and torch dtype, and ``extra``. numpy
has no bf16, so a bf16 leaf is stored as its raw 16 bits (uint16) and
comes back bit for bit. ``restore_checkpoint`` copies each
stored leaf into the matching tensor of ``like`` in place (cast to its
dtype, on its device), so a model's ``state_dict()`` in ``like`` receives
the weights without a second copy on the device.
"""

from __future__ import annotations

import json
import os
import re
import shutil
from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch

__all__ = ["save_checkpoint", "restore_checkpoint", "latest_step",
           "flatten_state"]

_STEP_RE = re.compile(r"^step_(\d+)$")


def _items(node):
    if isinstance(node, torch.Tensor):
        return None
    if hasattr(node, "_asdict"):  # a named tuple (OptState)
        return node._asdict().items()
    return node.items()


def flatten_state(tree: Any, prefix: str = "") -> Dict[str, torch.Tensor]:
    """The tensors of ``tree`` by "/"-joined key path, in tree order."""
    items = _items(tree)
    if items is None:
        return {prefix: tree}
    flat: Dict[str, torch.Tensor] = {}
    for key, val in items:
        flat.update(flatten_state(val, f"{prefix}/{key}" if prefix
                                  else str(key)))
    return flat


def _host(t: torch.Tensor) -> np.ndarray:
    t = t.detach().cpu()
    if t.dtype == torch.bfloat16:  # its raw bits
        return t.view(torch.int16).numpy().view(np.uint16)
    return t.numpy()


def save_checkpoint(directory: str, step: int, tree: Any, *,
                    extra: Optional[dict] = None, keep: int = 3) -> str:
    """Write ``tree`` as ``<directory>/step_<step>`` (through
    ``tmp.<step>`` and a rename), then drop all but the ``keep`` newest
    checkpoints. Returns the checkpoint's path."""
    os.makedirs(directory, exist_ok=True)
    tmp = os.path.join(directory, f"tmp.{step}")
    final = os.path.join(directory, f"step_{step}")
    if os.path.exists(tmp):
        shutil.rmtree(tmp)
    os.makedirs(os.path.join(tmp, "arrays"))
    flat = flatten_state(tree)
    files = {}
    for i, (key, t) in enumerate(flat.items()):
        files[key] = f"arrays/{i}.npy"
        np.save(os.path.join(tmp, files[key]), _host(t))
    manifest = {"step": step, "keys": sorted(flat), "files": files,
                "dtypes": {k: str(t.dtype).replace("torch.", "")
                           for k, t in flat.items()},
                "extra": extra or {}}
    with open(os.path.join(tmp, "manifest.json"), "w") as f:
        json.dump(manifest, f)
    if os.path.exists(final):
        shutil.rmtree(final)
    os.rename(tmp, final)  # commit point
    _gc(directory, keep)
    return final


def _gc(directory: str, keep: int) -> None:
    steps = sorted(
        int(m.group(1)) for m in
        (_STEP_RE.match(d) for d in os.listdir(directory)) if m)
    for s in steps[:-keep] if keep else []:
        shutil.rmtree(os.path.join(directory, f"step_{s}"), ignore_errors=True)


def latest_step(directory: str) -> Optional[int]:
    """The newest committed step in ``directory`` (None: none, or no
    directory); a ``tmp.<step>`` left by a crash is not one."""
    if not os.path.isdir(directory):
        return None
    steps = [int(m.group(1)) for m in
             (_STEP_RE.match(d) for d in os.listdir(directory)) if m]
    return max(steps) if steps else None


@torch.no_grad()
def restore_checkpoint(directory: str, step: int, like: Any
                       ) -> Tuple[Any, dict]:
    """Restore ``step_<step>`` into the structure of ``like``: each of its
    tensors is overwritten in place with the stored leaf of the same key
    path (cast to its dtype). Returns (``like``, the manifest's
    ``extra``).

    Raises:
      KeyError: a leaf of ``like`` that the checkpoint does not hold.
      ValueError: a stored leaf of another shape.
    """
    path = os.path.join(directory, f"step_{step}")
    with open(os.path.join(path, "manifest.json")) as f:
        manifest = json.load(f)
    for key, leaf in flatten_state(like).items():
        arr = np.load(os.path.join(path, manifest["files"][key]))
        if manifest["dtypes"][key] == "bfloat16":
            t = torch.from_numpy(arr.view(np.int16)).view(torch.bfloat16)
        else:
            t = torch.from_numpy(arr)
        if tuple(t.shape) != tuple(leaf.shape):
            raise ValueError(f"{key}: stored {tuple(t.shape)}, expected "
                             f"{tuple(leaf.shape)}")
        leaf.copy_(t.to(leaf.dtype))
    return like, manifest["extra"]
