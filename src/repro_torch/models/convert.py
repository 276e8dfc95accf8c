"""Weights between the reference's parameter trees and the port's modules.

``params_from_jax`` turns the tree of a reference model's ``init`` — given
as numpy arrays, stacked layers on a leading axis — into the state dict of
the port's model of the same family; ``params_to_jax`` is its inverse. The
reference's ``(d_in, d_out)`` weight layout is kept (nothing is
transposed), and so is each leaf's dtype (the MoE router, mamba's
``A_log``, ``D`` and ``dt_bias`` and the RG-LRU gates are fp32 in a bf16
tree). Per family (``_layout``):

- dense, moe, vlm (``TransformerLM``): ``layers`` (L, ...) → ``blocks.<i>``;
  ``embed``, ``final_norm`` and the VLM's ``vision_proj`` as they are.
- ssm (``MambaLM``): ``layers`` (L, ...) → ``layers.<i>``; ``embed``,
  ``final_norm``.
- encdec (``WhisperModel``): ``enc_layers`` (encoder_layers, ...) →
  ``enc_layers.<i>``, ``dec_layers`` (L, ...) → ``dec_layers.<i>``;
  ``embed``, ``dec_pos``, ``enc_norm``, ``final_norm``.
- hybrid (``GriffinLM``): ``groups.b<j>`` (G, ...) → ``blocks.<P·g + j>``
  for a pattern of P blocks, the remainder ``rem<j>`` → ``blocks.<P·G +
  j>`` (the reference's ``_layer_list`` order); ``embed``, ``final_norm``.

``opt_state_from_jax`` / ``opt_state_to_jax`` carry the reference's AdamW
state (``step``, and ``mu`` and ``nu`` shaped as the parameters) to and
from the port's ``OptState``: the moments map by the same rules as the
weights. A gradient keyed by parameter name maps back through
``params_to_jax`` as well.
"""

from __future__ import annotations

from collections import OrderedDict
from typing import Dict, List, Mapping, Optional, Tuple

import numpy as np
import torch

from repro_torch.models.config import ModelConfig

__all__ = ["opt_state_from_jax", "opt_state_to_jax", "params_from_jax",
           "params_to_jax", "reference_path"]


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


def _layout(cfg: ModelConfig) -> List[Tuple[str, object, Optional[int]]]:
    """The family's rules ``(tree prefix, port prefix, count)``: with a
    count, the tree's leaves under the prefix are stacked on a leading axis
    of that length and entry i goes to ``port(i)``; without one, the
    subtree maps to the port prefix as it is."""
    rules: List[Tuple[str, object, Optional[int]]] = [
        ("embed", "embed", None), ("final_norm", "final_norm", None)]
    if cfg.family in ("dense", "moe", "vlm"):
        rules.append(("layers", lambda i: f"blocks.{i}", cfg.num_layers))
        if cfg.family == "vlm":
            rules.append(("vision_proj", "vision_proj", None))
    elif cfg.family == "ssm":
        rules.append(("layers", lambda i: f"layers.{i}", cfg.num_layers))
    elif cfg.family == "encdec":
        rules += [("enc_layers", lambda i: f"enc_layers.{i}",
                   cfg.encoder_layers),
                  ("dec_layers", lambda i: f"dec_layers.{i}", cfg.num_layers),
                  ("dec_pos", "dec_pos", None), ("enc_norm", "enc_norm", None)]
    elif cfg.family == "hybrid":
        pat = cfg.block_pattern or ("rec", "rec", "attn")
        groups = cfg.num_layers // len(pat)
        for j in range(len(pat)):
            rules.append((f"groups.b{j}",
                          lambda g, j=j: f"blocks.{len(pat) * g + j}", groups))
        for j in range(cfg.num_layers - groups * len(pat)):
            rules.append((f"rem{j}", f"blocks.{len(pat) * groups + j}", None))
    else:
        raise ValueError(f"unknown family {cfg.family!r}")
    return rules


def _under(name: str, prefix: str) -> Optional[str]:
    """The rest of ``name`` below ``prefix`` ("" for the prefix itself), or
    None if ``name`` is not under it."""
    if name == prefix:
        return ""
    return name[len(prefix):] if name.startswith(prefix + ".") else None


def _count_name(prefix: str) -> str:
    return {"layers": "num_layers", "dec_layers": "num_layers",
            "enc_layers": "encoder_layers"}.get(
                prefix, "num_layers // len(block_pattern)")


def params_from_jax(np_params: Mapping, cfg: ModelConfig
                    ) -> Dict[str, torch.Tensor]:
    """The port's state dict from the reference's parameter tree.

    Args:
      np_params: the tree of the reference's ``init`` for ``cfg``'s family
        (see the module docstring) as numpy arrays (fp32, fp16 or
        ml_dtypes bf16).
      cfg: the model's config (its family and layer counts are checked).

    Raises:
      ValueError: a key the family's model does not have (``vision_proj``
        outside the vlm family), or a stacked leaf whose leading axis is
        not the layer count (``num_layers``, ``encoder_layers`` or the
        hybrid's group count).
    """
    rules = _layout(cfg)
    out: Dict[str, torch.Tensor] = OrderedDict()
    for name, leaf in _flatten(np_params):
        for prefix, port, count in rules:
            rest = _under(name, prefix)
            if rest is not None:
                break
        else:
            raise ValueError(f"key {name!r} is not the {cfg.family} model's "
                             f"(keys {sorted(set(np_params))})")
        if count is None:
            out[port + rest] = _tensor(leaf)
            continue
        arr = np.asarray(leaf)
        if arr.shape[0] != count:
            raise ValueError(f"{name} has leading axis {arr.shape[0]}, not "
                             f"{_count_name(prefix)} = {count}")
        for i in range(count):
            out[port(i) + rest] = _tensor(arr[i])
    return out


def _owners(cfg: ModelConfig) -> Dict[str, Tuple[str, Optional[int],
                                                   Optional[int]]]:
    """port prefix -> (tree prefix, index or None, count or None)."""
    owner = {}
    for prefix, port, count in _layout(cfg):
        if count is None:
            owner[port] = (prefix, None, None)
        else:
            for i in range(count):
                owner[port(i)] = (prefix, i, count)
    return owner


def _owner_of(name: str, owner: Mapping, cfg: ModelConfig):
    """(the longest port prefix of ``name`` that ``owner`` holds, its
    entry)."""
    parts = name.split(".")
    for n in range(len(parts), 0, -1):
        key = ".".join(parts[:n])
        if key in owner:
            return key, owner[key]
    raise ValueError(f"{name!r} is not a {cfg.family} model's parameter")


def reference_path(name: str, cfg: ModelConfig) -> Tuple[str, bool]:
    """The reference's tree path of the port's parameter ``name``, its keys
    joined by "/" (``blocks.3.attn.wq.w`` → ``layers/attn/wq/w``), and
    whether the reference stacks that leaf on a leading layer (or group)
    axis that the port's per-layer tensor lacks.

    Raises:
      ValueError: ``name`` is not a parameter of ``cfg``'s family.
    """
    key, (prefix, i, _) = _owner_of(name, _owners(cfg), cfg)
    return (prefix + name[len(key):]).replace(".", "/"), i is not None


def params_to_jax(state_dict: Mapping[str, torch.Tensor], cfg: ModelConfig
                  ) -> Dict[str, object]:
    """The reference's parameter tree (numpy, stacked layers on a leading
    axis) from the port's state dict; bf16 tensors come back as fp32
    arrays (numpy has no bf16), every other dtype as it is."""
    def arr(t: torch.Tensor) -> np.ndarray:
        t = t.detach().cpu()
        return (t.float() if t.dtype == torch.bfloat16 else t).numpy()

    owner = _owners(cfg)
    flat: Dict[str, object] = OrderedDict()
    for name, t in state_dict.items():
        key, (prefix, i, count) = _owner_of(name, owner, cfg)
        leaf = prefix + name[len(key):]
        if i is None:
            flat[leaf] = arr(t)
        else:
            flat.setdefault(leaf, [None] * count)[i] = arr(t)
    tree: Dict[str, object] = {}
    for leaf, val in flat.items():
        node = tree
        *parents, last = leaf.split(".")
        for key in parents:
            node = node.setdefault(key, {})
        node[last] = np.stack(val) if isinstance(val, list) else val
    return tree


def opt_state_from_jax(np_opt, cfg: ModelConfig):
    """The port's ``OptState`` from the reference's (``step``, ``mu``,
    ``nu``: a named tuple or mapping of numpy arrays): ``step`` a 0-d int32
    tensor, the moments dicts by ``params_from_jax``."""
    from repro_torch.train.optimizer import OptState

    get = (np_opt.__getitem__ if isinstance(np_opt, Mapping)
           else lambda k: getattr(np_opt, k))
    return OptState(
        step=torch.tensor(int(np.asarray(get("step"))), dtype=torch.int32),
        mu=dict(params_from_jax(get("mu"), cfg)),
        nu=dict(params_from_jax(get("nu"), cfg)))


def opt_state_to_jax(state, cfg: ModelConfig) -> Dict[str, object]:
    """The reference's AdamW state as a dict {``step``: int32 array,
    ``mu``, ``nu``: trees by ``params_to_jax``} (bf16 moments as fp32)."""
    return {"step": np.asarray(int(state.step), dtype=np.int32),
            "mu": params_to_jax(state.mu, cfg),
            "nu": params_to_jax(state.nu, cfg)}
