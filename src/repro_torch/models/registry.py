"""Architecture registry: ``--arch <id>`` resolution for configs and models.

The port of ``repro.models.registry``. ``ARCHS`` keeps all ten names and
``get_config`` / ``get_reduced_config`` resolve the dense, moe and vlm
families, whose configurations are ported (``repro_torch/configs/``) and
which ``TransformerLM`` serves. The ssm, hybrid and encdec families raise
``NotImplementedError`` naming the ROADMAP item that ports them.
"""

from __future__ import annotations

import importlib
from typing import List

from repro_torch.models.config import ModelConfig

__all__ = ["get_config", "get_reduced_config", "get_model", "list_archs", "ARCHS"]

ARCHS = [
    "gemma2-2b",
    "qwen1.5-4b",
    "qwen1.5-32b",
    "minicpm-2b",
    "mamba2-780m",
    "arctic-480b",
    "dbrx-132b",
    "whisper-medium",
    "paligemma-3b",
    "recurrentgemma-9b",
]

# architectures of the families not yet ported, with their family
_NOT_PORTED = {
    "mamba2-780m": "ssm",
    "whisper-medium": "encdec",
    "recurrentgemma-9b": "hybrid",
}


def _not_ported(what: str, family: str) -> NotImplementedError:
    return NotImplementedError(
        f"{what}: the {family!r} family is not ported yet (ROADMAP Queue 1, "
        f"item 15); the port serves the dense, moe and vlm families")


def _module(arch: str):
    if arch in _NOT_PORTED:
        raise _not_ported(arch, _NOT_PORTED[arch])
    if arch not in ARCHS:
        raise ValueError(f"unknown arch {arch!r}; expected one of {ARCHS}")
    return importlib.import_module(
        f"repro_torch.configs.{arch.replace('-', '_').replace('.', '_')}")


def get_config(arch: str) -> ModelConfig:
    """The published configuration of ``arch`` (dense, moe and vlm
    families)."""
    return _module(arch).CONFIG


def get_reduced_config(arch: str) -> ModelConfig:
    """The same-family scale-down of ``arch`` (dense, moe and vlm
    families)."""
    return _module(arch).REDUCED


def list_archs() -> List[str]:
    return list(ARCHS)


def get_model(cfg: ModelConfig, **kw):
    """A ``TransformerLM`` for a dense, moe or vlm config (``kw`` go to its
    constructor); the ssm, hybrid and encdec families raise
    ``NotImplementedError``."""
    if cfg.family in ("dense", "moe", "vlm"):
        from repro_torch.models.transformer import TransformerLM

        return TransformerLM(cfg, **kw)
    if cfg.family in ("ssm", "hybrid", "encdec"):
        raise _not_ported(cfg.name, cfg.family)
    raise ValueError(f"unknown family {cfg.family!r}")
