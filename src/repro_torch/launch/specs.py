"""``meta`` stand-ins for every (architecture × input shape) cell.

The port of ``repro.launch.specs``. ``input_specs(arch, shape)`` returns
the inputs the dry run (``launch.dryrun``) traces against, as tensors on
the ``meta`` device: the reference's shapes and dtypes, with no byte
allocated. The assigned shape set (LM transformers):

  train_4k     seq 4096,   global_batch 256   → train_step
  prefill_32k  seq 32768,  global_batch 32    → prefill
  decode_32k   cache 32768, global_batch 128  → decode_step (1 new token)
  long_500k    cache 524288, global_batch 1   → decode_step, sub-quadratic
                archs only (ssm / hybrid); others report a documented skip.

Modality stubs as in the reference: whisper gets precomputed frame
embeddings, paligemma precomputed patch embeddings. A decode cell's cache
is the model's own ``init_cache`` built on ``meta`` (a model on ``meta``,
``abstract_params``), in bf16 unless the config's KV cache is int8.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional

import torch

from repro_torch.models.config import ModelConfig
from repro_torch.models.registry import get_config, get_model

__all__ = ["SHAPES", "CellSpec", "abstract_params", "cell_spec",
           "input_specs", "skip_reason"]


@dataclasses.dataclass(frozen=True)
class CellSpec:
    arch: str
    shape: str
    kind: str  # train | prefill | decode
    seq_len: int
    global_batch: int


SHAPES = {
    "train_4k": dict(kind="train", seq_len=4096, global_batch=256),
    "prefill_32k": dict(kind="prefill", seq_len=32768, global_batch=32),
    "decode_32k": dict(kind="decode", seq_len=32768, global_batch=128),
    "long_500k": dict(kind="decode", seq_len=524288, global_batch=1),
}


def cell_spec(arch: str, shape: str) -> CellSpec:
    return CellSpec(arch=arch, shape=shape, **SHAPES[shape])


def skip_reason(cfg: ModelConfig, shape: str) -> Optional[str]:
    if shape == "long_500k" and not cfg.supports_long_context:
        return ("quadratic global attention at 524288 ctx — skipped per "
                "brief (run for SSM/hybrid only)")
    return None


def _meta(shape, dtype) -> torch.Tensor:
    return torch.empty(shape, dtype=dtype, device="meta")


def _batch(cfg: ModelConfig, b: int, sl: int, labels: bool
           ) -> Dict[str, torch.Tensor]:
    batch = {"tokens": _meta((b, sl), torch.int32)}
    if labels:
        batch["labels"] = _meta((b, sl), torch.int32)
    if cfg.family == "encdec":
        batch["frames"] = _meta((b, cfg.encoder_seq, cfg.d_model),
                                torch.float32)
    if cfg.family == "vlm":
        batch["patches"] = _meta((b, cfg.vision_tokens, cfg.vision_dim),
                                 torch.float32)
    return batch


def input_specs(arch: str, shape: str) -> Dict[str, object]:
    """The ``meta`` batch of the step the cell traces: tokens (and labels,
    frames, patches) of the cell's global shapes for train and prefill;
    for decode one new token (B, 1) and the model's ``init_cache`` of B
    rows and the cell's sequence length, on ``meta``."""
    cfg = get_config(arch)
    cell = cell_spec(arch, shape)
    b, sl = cell.global_batch, cell.seq_len
    if cell.kind in ("train", "prefill"):
        return _batch(cfg, b, sl, labels=cell.kind == "train")
    model = abstract_params(arch)
    return {"tokens": _meta((b, 1), torch.int32),
            "cache": model.init_cache(b, sl, torch.bfloat16)}


def abstract_params(arch: str, dtype: torch.dtype = torch.bfloat16):
    """The model of ``arch`` built on ``meta`` in ``dtype``: every parameter
    a shape and a dtype, nothing allocated (the reference's
    ``jax.eval_shape`` of ``init``)."""
    return get_model(get_config(arch), device="meta", dtype=dtype)
