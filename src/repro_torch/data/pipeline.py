"""Deterministic modality-frontend inputs (port of the frontend stubs of
``repro.data.pipeline``): numpy only, the same ``SeedSequence`` keys, so
both packages draw the same arrays from the same (seed, step)."""
from __future__ import annotations

from typing import Optional

import numpy as np

from repro_torch.configs.base import ModelConfig


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
