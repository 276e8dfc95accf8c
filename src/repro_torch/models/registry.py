"""Architecture registry: ``--arch <id>`` resolution for configs and models.

The port of ``repro.models.registry``. ``get_config`` /
``get_reduced_config`` resolve all ten architectures of ``ARCHS``
(``repro_torch/configs/``), and ``get_model`` builds the model that serves
each family: ``TransformerLM`` (dense, moe, vlm), ``MambaLM`` (ssm),
``GriffinLM`` (hybrid) or ``WhisperModel`` (encdec).
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


def _module(arch: str):
    if arch not in ARCHS:
        raise ValueError(f"unknown arch {arch!r}; expected one of {ARCHS}")
    return importlib.import_module(
        f"repro_torch.configs.{arch.replace('-', '_').replace('.', '_')}")


def get_config(arch: str) -> ModelConfig:
    """The published configuration of ``arch``."""
    return _module(arch).CONFIG


def get_reduced_config(arch: str) -> ModelConfig:
    """The same-family scale-down of ``arch``."""
    return _module(arch).REDUCED


def list_archs() -> List[str]:
    return list(ARCHS)


def get_model(cfg: ModelConfig, **kw):
    """The model of ``cfg``'s family, as the reference's ``get_model``
    builds it; ``kw`` (``device``, ``dtype``, ``attn_backend``) go to its
    constructor."""
    if cfg.family in ("dense", "moe", "vlm"):
        from repro_torch.models.transformer import TransformerLM

        return TransformerLM(cfg, **kw)
    if cfg.family == "ssm":
        from repro_torch.models.ssm import MambaLM

        return MambaLM(cfg, **kw)
    if cfg.family == "hybrid":
        from repro_torch.models.rglru import GriffinLM

        return GriffinLM(cfg, **kw)
    if cfg.family == "encdec":
        from repro_torch.models.encdec import WhisperModel

        return WhisperModel(cfg, **kw)
    raise ValueError(f"unknown family {cfg.family!r}")
