"""Synthetic data pipeline: deterministic, seekable, shardable.

The port of ``repro.train.data``, numpy only (its own copy of the code),
with batches bit-equal to the reference's for every family:

  * determinism — batch(step) is a pure function of (seed, step), so a
    restart resumes bit-identically with no data state beyond the step,
  * seekability — a restart at another data-parallel size re-slices the
    same global batch,
  * modality stubs — encdec gets frame embeddings, vlm gets patch
    embeddings.

Token sequences are Zipf-ish draws (a vocab-heavy head) plus a positional
drift, so the loss moves during a training run instead of staying at
log V. Batches are host numpy arrays; the caller moves them to its device.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Iterator

import numpy as np

from repro_torch.models.config import ModelConfig

__all__ = ["SyntheticDataConfig", "SyntheticDataset", "make_batch"]


@dataclasses.dataclass(frozen=True)
class SyntheticDataConfig:
    batch: int
    seq_len: int
    seed: int = 0
    zipf_a: float = 1.2


def _tokens(rng: np.random.Generator, cfg: SyntheticDataConfig, vocab: int):
    # zipf draws clipped into vocab, plus a positional autocorrelation so
    # the model has something learnable (next token correlates with current)
    base = rng.zipf(cfg.zipf_a, size=(cfg.batch, cfg.seq_len)) % vocab
    drift = np.cumsum(rng.integers(0, 3, size=(cfg.batch, cfg.seq_len)), axis=1)
    return ((base + drift) % vocab).astype(np.int32)


def make_batch(model_cfg: ModelConfig, data_cfg: SyntheticDataConfig,
               step: int) -> Dict[str, np.ndarray]:
    """A pure function of (seed, step) → batch dict (host numpy):
    ``tokens`` and ``labels`` (B, seq_len − 1) int32, the labels shifted by
    one; the encdec family's ``frames`` (B, encoder_seq, d_model) and the
    vlm family's ``patches`` (B, vision_tokens, vision_dim), fp32."""
    rng = np.random.default_rng((data_cfg.seed, step))
    toks = _tokens(rng, data_cfg, model_cfg.vocab)
    batch = {
        "tokens": toks[:, :-1].copy(),
        "labels": toks[:, 1:].copy(),
    }
    if model_cfg.family == "encdec":
        batch["frames"] = rng.standard_normal(
            (data_cfg.batch, model_cfg.encoder_seq, model_cfg.d_model),
            dtype=np.float32)
    if model_cfg.family == "vlm":
        batch["patches"] = rng.standard_normal(
            (data_cfg.batch, model_cfg.vision_tokens, model_cfg.vision_dim),
            dtype=np.float32)
    return batch


class SyntheticDataset:
    """Step-indexed iterator with an explicit ``state`` (the step counter),
    so checkpoint/restore and elastic resharding are trivial."""

    def __init__(self, model_cfg: ModelConfig, data_cfg: SyntheticDataConfig,
                 start_step: int = 0):
        self.model_cfg = model_cfg
        self.data_cfg = data_cfg
        self.step = start_step

    def __iter__(self) -> Iterator[Dict[str, np.ndarray]]:
        return self

    def __next__(self) -> Dict[str, np.ndarray]:
        b = make_batch(self.model_cfg, self.data_cfg, self.step)
        self.step += 1
        return b

    @property
    def state(self) -> int:
        return self.step

    def seek(self, step: int) -> None:
        self.step = step
