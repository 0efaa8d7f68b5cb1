"""Deterministic synthetic data (port of ``repro.data.pipeline``): the
language-model stream ``SyntheticLM`` and the modality-frontend stubs.
NumPy only, with the reference's ``SeedSequence`` keys, so both packages
draw the same arrays from the same (seed, step): every batch is a pure
function of them, and a resumed run replays the stream from its step.

The LM stream is a Zipf-ish token distribution with a short "grammar" of
bigram cycles, so a small model has something to learn.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig, ShapeConfig


@dataclasses.dataclass(frozen=True)
class SyntheticLM:
    vocab_size: int
    seq_len: int
    global_batch: int
    seed: int = 0
    structure: float = 0.8   # P(next token follows the bigram cycle)

    def _rng(self, step: int, shard: int = 0) -> np.random.Generator:
        return np.random.default_rng(
            np.random.SeedSequence([self.seed, step, shard]))

    def host_local_batch(self, step: int, shard: int, num_shards: int
                         ) -> dict[str, np.ndarray]:
        """The (batch / num_shards) slice owned by ``shard``: int32
        ``tokens`` (b, t) and ``labels``, the tokens shifted left by one
        with -1 at each row's end."""
        assert self.global_batch % num_shards == 0
        b = self.global_batch // num_shards
        rng = self._rng(step, shard)
        v = self.vocab_size
        t = self.seq_len
        # bigram cycle: next = (5 * cur + 1) % v, with noise
        start = rng.integers(0, v, size=(b, 1))
        noise = rng.integers(0, v, size=(b, t))
        follow = rng.random((b, t)) < self.structure
        toks = np.empty((b, t), np.int32)
        cur = start[:, 0]
        for i in range(t):
            nxt = (5 * cur + 1) % v
            cur = np.where(follow[:, i], nxt, noise[:, i]).astype(np.int64)
            toks[:, i] = cur
        labels = np.concatenate([toks[:, 1:], toks[:, :1] * 0 - 1], axis=1)
        return {"tokens": toks, "labels": labels.astype(np.int32)}

    def global_batch_arrays(self, step: int) -> dict[str, np.ndarray]:
        return self.host_local_batch(step, 0, 1)

    def device_batch(self, step: int, device) -> dict[str, torch.Tensor]:
        """``global_batch_arrays(step)`` as int64 tensors on ``device``."""
        return {k: torch.as_tensor(v.astype(np.int64), device=device)
                for k, v in self.global_batch_arrays(step).items()}


def make_lm_data(cfg: ModelConfig, shape: ShapeConfig, seed: int = 0
                 ) -> SyntheticLM:
    return SyntheticLM(vocab_size=cfg.vocab_size, seq_len=shape.seq_len,
                       global_batch=shape.global_batch, seed=seed)


def frontend_stub(cfg: ModelConfig, batch: int, step: int, seed: int = 0
                  ) -> Optional[np.ndarray]:
    """Precomputed frontend embeddings (audio frames / image patches),
    (batch, n, d_model) fp32 standard normal; None for an LM-only config."""
    if cfg.family == "encdec":
        n = cfg.encoder_seq_len
    elif cfg.family == "vlm":
        n = cfg.num_image_tokens
    else:
        return None
    rng = np.random.default_rng(np.random.SeedSequence([seed, step, 77]))
    return rng.standard_normal((batch, n, cfg.d_model)).astype(np.float32)


def frontend_raw_stub(cfg: ModelConfig, batch: int, step: int, seed: int = 0
                      ) -> Optional[np.ndarray]:
    """Raw frontend input of a config with a conv stem: (B, H, W, C) pixels
    in [0, 1) for vision, (B, frames, 1, mels) standard-normal fbank
    features for speech; None without a stem."""
    if not cfg.conv_stem:
        return None
    h, w = cfg.frontend_hw
    c = cfg.conv_stem[0].c_in
    rng = np.random.default_rng(np.random.SeedSequence([seed, step, 78]))
    if cfg.family == "vlm":
        return rng.random((batch, h, w, c)).astype(np.float32)
    return rng.standard_normal((batch, h, w, c)).astype(np.float32)
