"""Config registry of the port: ``get_config(arch_id)`` and ``reduced``.

Port of ``repro.configs``. The dense decoders (llama3-8b, qwen1.5-4b,
stablelm-12b, gemma2-9b), the MoE decoders (mixtral-8x7b, dbrx-132b), the
hybrid zamba2-1.2b, the SSM rwkv6-1.6b, the encoder-decoder
seamless-m4t-medium and the vision decoder llama-3.2-vision-90b: every
architecture of the JAX package.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

from repro_torch.configs import (dbrx_132b, gemma2_9b, llama3_8b,
                                 llama_3_2_vision_90b, mixtral_8x7b,
                                 qwen1_5_4b, rwkv6_1_6b,
                                 seamless_m4t_medium, stablelm_12b,
                                 zamba2_1_2b)
from repro_torch.configs.base import (SHAPES, SHAPES_BY_NAME, ConvSpec,
                                      ModelConfig, MoEConfig, QuantConfig,
                                      ShapeConfig)

_REGISTRY = {
    "qwen1.5-4b": qwen1_5_4b.config,
    "stablelm-12b": stablelm_12b.config,
    "gemma2-9b": gemma2_9b.config,
    "llama3-8b": llama3_8b.config,
    "dbrx-132b": dbrx_132b.config,
    "mixtral-8x7b": mixtral_8x7b.config,
    "seamless-m4t-medium": seamless_m4t_medium.config,
    "zamba2-1.2b": zamba2_1_2b.config,
    "rwkv6-1.6b": rwkv6_1_6b.config,
    "llama-3.2-vision-90b": llama_3_2_vision_90b.config,
}

ARCH_NAMES = tuple(_REGISTRY)


def get_config(name: str, *, quant: Optional[QuantConfig] = None,
               dtype: Optional[str] = None) -> ModelConfig:
    if name not in _REGISTRY:
        raise KeyError(f"unknown arch {name!r}; have {sorted(_REGISTRY)}")
    cfg = _REGISTRY[name]()
    if quant is not None:
        cfg = dataclasses.replace(cfg, quant=quant)
    if dtype is not None:
        cfg = dataclasses.replace(cfg, dtype=dtype)
    return cfg


def reduced(cfg: ModelConfig, *, layers: Optional[int] = None) -> ModelConfig:
    """Tiny same-family variant for CPU tests: few layers, small width,
    tiny vocab — the same shapes ``repro.configs.reduced`` gives."""
    from repro_torch.models.transformer import group_pattern  # lazy: cycle

    pattern_len = len(group_pattern(cfg))
    if layers is None:
        layers = pattern_len * 2 + (2 if cfg.family == "hybrid" else 0)
    kv = max(1, (4 * cfg.num_kv_heads) // cfg.num_heads)
    stem: tuple = ()
    hw: tuple = ()
    if cfg.conv_stem and cfg.family == "vlm":
        stem = (ConvSpec(kh=4, kw=4, sh=4, sw=4, c_in=3, c_out=64),)
        hw = (16, 16)
    elif cfg.conv_stem:
        stem = (ConvSpec(kh=3, kw=1, sh=2, sw=1, c_in=80, c_out=64, ph=1),
                ConvSpec(kh=3, kw=1, sh=2, sw=1, c_in=64, c_out=64, ph=1))
        hw = (96, 1)
    return dataclasses.replace(
        cfg,
        name=cfg.name + "-smoke",
        num_layers=layers,
        d_model=64,
        num_heads=4,
        num_kv_heads=kv,
        head_dim=32 if cfg.head_dim else None,
        d_ff=128,
        vocab_size=512,
        local_window=16,
        sliding_window=16 if cfg.sliding_window else None,
        encoder_layers=2 if cfg.encoder_layers else 0,
        encoder_seq_len=24 if cfg.family == "encdec" else cfg.encoder_seq_len,
        num_image_tokens=16 if cfg.family == "vlm" else 0,
        ssm_state=16 if cfg.ssm_state else 0,
        ssm_head_dim=16,
        moe=MoEConfig(num_experts=4, top_k=2) if cfg.moe else None,
        conv_stem=stem,
        frontend_hw=hw,
    )


__all__ = [
    "ARCH_NAMES", "SHAPES", "SHAPES_BY_NAME", "ConvSpec", "ModelConfig",
    "MoEConfig", "QuantConfig", "ShapeConfig", "get_config", "reduced",
]
