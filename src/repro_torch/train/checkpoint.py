"""Fault-tolerant checkpointing: atomic, mesh-elastic, GC'd, restored in
place.

The port of ``repro.train.checkpoint``:

  * ATOMICITY — write to ``<dir>/tmp.<step>`` then ``os.rename`` to
    ``step_<n>`` (the commit point); a crash mid-write never corrupts the
    latest checkpoint.
  * GC — the ``keep`` most recent checkpoints are retained.
  * AUTO-RESUME — ``latest_step`` scans the directory; the train driver
    calls it on startup (``repro_torch.train.elastic``).
  * MESH ELASTICITY — a sharded leaf (a ``DTensor``) is gathered to its full
    value by every rank, and rank 0 alone writes (the ranks meet at a
    barrier after the commit), so the files are byte for byte what one
    process writes and do not depend on the mesh. A restore places each
    leaf by the placements of the current mesh, so a run saved on one mesh
    resumes on another, or on one card.

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
the weights without a second copy on the device; a sharded leaf of
``like`` receives this rank's block of the stored value.
"""

from __future__ import annotations

import json
import os
import re
import shutil
from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch
import torch.distributed as dist

from repro_torch.models.meshctx import full_value
from repro_torch.train.sharding import NamedSharding, local, shard_like

__all__ = ["save_checkpoint", "restore_checkpoint", "latest_step",
           "flatten_state"]

_STEP_RE = re.compile(r"^step_(\d+)$")


def _items(node):
    if isinstance(node, (torch.Tensor, NamedSharding)):
        return None  # a leaf
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


def _writer() -> bool:
    """Whether this process writes: the only one, or rank 0."""
    return not (dist.is_available() and dist.is_initialized()) \
        or dist.get_rank() == 0


def _host(t: torch.Tensor) -> np.ndarray:
    t = t.detach().cpu()
    if t.dtype == torch.bfloat16:  # its raw bits
        return t.view(torch.int16).numpy().view(np.uint16)
    return t.numpy()


def save_checkpoint(directory: str, step: int, tree: Any, *,
                    extra: Optional[dict] = None, keep: int = 3) -> str:
    """Write ``tree`` as ``<directory>/step_<step>`` (through
    ``tmp.<step>`` and a rename), then drop all but the ``keep`` newest
    checkpoints. Returns the checkpoint's path.

    In a ``torch.distributed`` job every rank calls it: each sharded leaf
    is gathered by all (``full_value``), rank 0 writes, and all meet at a
    barrier once the checkpoint is committed."""
    final = os.path.join(directory, f"step_{step}")
    flat = flatten_state(tree)
    if not _writer():
        for t in flat.values():
            full_value(t)
        dist.barrier()
        return final
    os.makedirs(directory, exist_ok=True)
    tmp = os.path.join(directory, f"tmp.{step}")
    if os.path.exists(tmp):
        shutil.rmtree(tmp)
    os.makedirs(os.path.join(tmp, "arrays"))
    files = {}
    for i, (key, t) in enumerate(flat.items()):
        files[key] = f"arrays/{i}.npy"
        np.save(os.path.join(tmp, files[key]), _host(full_value(t)))
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
    if dist.is_available() and dist.is_initialized():
        dist.barrier()
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


def _rebuild(node, values: Dict[str, Any], prefix: str = ""):
    """``node``'s structure with each tensor leaf replaced by
    ``values[path]``."""
    items = _items(node)
    if items is None:
        return values[prefix]
    out = {k: _rebuild(v, values, f"{prefix}/{k}" if prefix else str(k))
           for k, v in items}
    return type(node)(**out) if hasattr(node, "_asdict") else out


@torch.no_grad()
def restore_checkpoint(directory: str, step: int, like: Any,
                       shardings: Any = None) -> Tuple[Any, dict]:
    """Restore ``step_<step>`` into the structure of ``like``: each of its
    tensors is overwritten in place with the stored leaf of the same key
    path (cast to its dtype); a ``DTensor`` leaf receives this rank's block
    of it, by its own placements. ``shardings`` (None, or a tree of
    ``sharding.NamedSharding`` in ``like``'s structure, a leaf missing or
    None for a tensor restored as it lies) places each plain leaf of
    ``like`` on the mesh instead: the returned tree then holds a new
    ``DTensor`` there. This is where a run changes meshes. Returns (the
    restored tree, the manifest's ``extra``).

    Raises:
      KeyError: a leaf of ``like`` that the checkpoint does not hold.
      ValueError: a stored leaf of another shape, or a ``DTensor`` leaf
        whose sharding in ``shardings`` has other placements.
    """
    path = os.path.join(directory, f"step_{step}")
    with open(os.path.join(path, "manifest.json")) as f:
        manifest = json.load(f)
    where = flatten_state(shardings) if shardings is not None else {}
    out = {}
    for key, leaf in flatten_state(like).items():
        arr = np.load(os.path.join(path, manifest["files"][key]))
        if manifest["dtypes"][key] == "bfloat16":
            t = torch.from_numpy(arr.view(np.int16)).view(torch.bfloat16)
        else:
            t = torch.from_numpy(arr)
        if tuple(t.shape) != tuple(leaf.shape):
            raise ValueError(f"{key}: stored {tuple(t.shape)}, expected "
                             f"{tuple(leaf.shape)}")
        s = where.get(key)
        if hasattr(leaf, "placements"):  # a DTensor: its block, in place
            if s is not None and tuple(s.placements) != tuple(leaf.placements):
                raise ValueError(f"{key}: sharded as {leaf.placements}, "
                                 f"asked for {s.placements}")
            t = t.to(device=leaf.device, dtype=leaf.dtype)
            block = shard_like(t, leaf.placements, leaf.device_mesh)
            local(leaf).copy_(local(block))
            out[key] = leaf
        elif s is not None:
            out[key] = shard_like(t.to(device=leaf.device), s.placements,
                                  s.mesh, dtype=leaf.dtype)
        else:
            leaf.copy_(t.to(leaf.dtype))
            out[key] = leaf
    return (_rebuild(like, out) if where else like), manifest["extra"]
