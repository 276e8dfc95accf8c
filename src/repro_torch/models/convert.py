"""Weights between the reference's parameter tree and the port's modules.

``params_from_jax`` turns the tree of ``repro.models.transformer.
TransformerLM.init`` — given as numpy arrays, the layers stacked on a
leading ``(L, ...)`` axis — into a ``TransformerLM`` state dict:
``embed``, ``blocks.<i>.<path>`` for layer i's slice of each stacked leaf
(the MoE family's ``moe.router``, ``moe.wi`` / ``wg`` / ``wo`` and arctic's
``moe.dense.*`` among them), ``final_norm.scale`` and the VLM's
``vision_proj.w``. The reference's ``(d_in, d_out)`` weight layout is kept:
nothing is transposed, and each leaf keeps its dtype (the MoE router is
fp32 in a bf16 tree). ``params_to_jax`` is its inverse.
"""

from __future__ import annotations

from collections import OrderedDict
from typing import Dict, Mapping

import numpy as np
import torch

from repro_torch.models.config import ModelConfig

__all__ = ["params_from_jax", "params_to_jax"]


def _flatten(tree: Mapping, prefix: str = ""):
    for key, val in tree.items():
        name = f"{prefix}{key}"
        if isinstance(val, Mapping):
            yield from _flatten(val, name + ".")
        else:
            yield name, val


def _tensor(x) -> torch.Tensor:
    """A torch tensor from a numpy array; ml_dtypes' bfloat16 (what JAX's
    bf16 arrays become) is reinterpreted through its 16 bits."""
    a = np.asarray(x)
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(a.view(np.uint16).copy()).view(torch.bfloat16)
    return torch.from_numpy(a.copy())


def params_from_jax(np_params: Mapping, cfg: ModelConfig
                    ) -> Dict[str, torch.Tensor]:
    """The port's state dict from the reference's parameter tree.

    Args:
      np_params: ``{"embed": (Vp, d), "layers": {...: (L, ...)},
        "final_norm": {"scale": (d,)}[, "vision_proj": {"w": (Dv, d)}]}``
        as numpy arrays (fp32, fp16 or ml_dtypes bf16).
      cfg: the model's config (its ``num_layers`` and family are checked).

    Raises:
      ValueError: a top-level key the model does not have (``vision_proj``
        outside the vlm family), or a stacked leaf whose leading axis is
        not ``num_layers``.
    """
    known = {"embed", "layers", "final_norm"}
    if cfg.family == "vlm":
        known.add("vision_proj")
    extra = set(np_params) - known
    if extra:
        raise ValueError(f"keys {sorted(extra)} are not the {cfg.family} "
                         f"model's")
    out: Dict[str, torch.Tensor] = OrderedDict()
    out["embed"] = _tensor(np_params["embed"])
    for name, leaf in _flatten(np_params["layers"]):
        arr = np.asarray(leaf)
        if arr.shape[0] != cfg.num_layers:
            raise ValueError(f"layers.{name} has leading axis {arr.shape[0]}, "
                             f"not num_layers = {cfg.num_layers}")
        for i in range(cfg.num_layers):
            out[f"blocks.{i}.{name}"] = _tensor(arr[i])
    for top in ("final_norm", "vision_proj"):
        for name, leaf in _flatten(np_params.get(top, {}), top + "."):
            out[name] = _tensor(leaf)
    return out


def params_to_jax(state_dict: Mapping[str, torch.Tensor], cfg: ModelConfig
                  ) -> Dict[str, object]:
    """The reference's parameter tree (numpy, layers stacked on a leading
    axis) from the port's state dict; bf16 tensors come back as fp32
    arrays (numpy has no bf16)."""
    def arr(t: torch.Tensor) -> np.ndarray:
        t = t.detach().cpu()
        return (t.float() if t.dtype == torch.bfloat16 else t).numpy()

    tree: Dict[str, object] = {"embed": arr(state_dict["embed"]),
                               "layers": {}, "final_norm": {}}
    per_layer: Dict[str, list] = OrderedDict()
    for name, t in state_dict.items():
        if name.startswith("blocks."):
            _, i, path = name.split(".", 2)
            per_layer.setdefault(path, [None] * cfg.num_layers)[int(i)] = arr(t)
        elif name.startswith(("final_norm.", "vision_proj.")):
            top, leaf = name.split(".", 1)
            tree.setdefault(top, {})[leaf] = arr(t)
    for path, leaves in per_layer.items():
        node = tree["layers"]
        *parents, leaf = path.split(".")
        for key in parents:
            node = node.setdefault(key, {})
        node[leaf] = np.stack(leaves)
    return tree
