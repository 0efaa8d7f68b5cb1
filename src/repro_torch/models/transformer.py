"""Model assembly for the serving path (port of ``repro.models.transformer``).

Every architecture is a repeating *group pattern* of layer kinds; the port
keeps the pattern functions verbatim (``core/costs`` prices layers by them)
and holds the layers of one model as a plain per-layer list instead of the
JAX package's group-stacked leaves. The ``attn`` (self-attention + dense
MLP) and ``attn_moe`` (self-attention + MoE) layers are ported so far.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Optional

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models import attention as A
from repro_torch.models import layers as L
from repro_torch.models import mlp as M

Tensor = torch.Tensor


# ---------------------------------------------------------------------------
# Group patterns
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class LayerSpec:
    kind: str
    window: Optional[int] = None


def group_pattern(cfg: ModelConfig, role: str = "decoder") -> list[LayerSpec]:
    """Smallest repeating pattern of layers for this architecture."""
    if role == "encoder":  # encdec encoder: bidirectional self-attn blocks
        return [LayerSpec("attn")]
    if cfg.family == "encdec":  # decoder: self-attn + cross-attn every layer
        return [LayerSpec("cross_attn")]
    if cfg.family == "moe":
        return [LayerSpec("attn_moe", cfg.sliding_window)]
    if cfg.family == "ssm":
        return [LayerSpec("rwkv")]
    if cfg.family == "hybrid":
        period = cfg.attn_period or 6
        return [LayerSpec("mamba")] * (period - 1) + [LayerSpec("mamba_attn")]
    if cfg.family == "vlm":
        period = cfg.cross_attn_period or 5
        return [LayerSpec("cross_attn")] + [LayerSpec("attn")] * (period - 1)
    if cfg.local_global_period:  # gemma2: alternate local / global
        return [LayerSpec("attn", cfg.local_window), LayerSpec("attn", None)]
    return [LayerSpec("attn", cfg.sliding_window)]


def group_layout(cfg: ModelConfig, num_layers: Optional[int] = None,
                 role: str = "decoder") -> tuple[list[LayerSpec], int, int]:
    """(pattern, n_groups, n_tail): n_tail layers don't fill a full group and
    run outside the scan (e.g. zamba2's 38 = 6*6 + 2)."""
    pattern = group_pattern(cfg, role)
    n_layers = num_layers if num_layers is not None else cfg.num_layers
    n_groups = n_layers // len(pattern)
    n_tail = n_layers - n_groups * len(pattern)
    return pattern, n_groups, n_tail


# ---------------------------------------------------------------------------
# Per-layer init / apply / decode (attention + dense MLP or MoE layers)
# ---------------------------------------------------------------------------

# the queue item (ROADMAP A) that ports each other layer kind
_KIND_ITEM = {"mamba": "A5", "mamba_attn": "A5", "rwkv": "A5",
              "cross_attn": "A6"}
_PORTED = ("attn", "attn_moe")


def _require_attn(spec: LayerSpec) -> None:
    if spec.kind not in _PORTED:
        item = _KIND_ITEM.get(spec.kind)
        where = f" (ROADMAP {item})" if item else ""
        raise ValueError(f"layer kind {spec.kind!r} is not ported yet: "
                         f"attn and attn_moe only{where}")


def init_layer(gen: torch.Generator, cfg: ModelConfig, spec: LayerSpec,
               device) -> dict:
    _require_attn(spec)
    d = cfg.d_model
    p = {"norm1": L.init_norm(d, cfg.norm, device),
         "attn": A.init_attention(gen, cfg, device),
         "norm2": L.init_norm(d, cfg.norm, device)}
    if spec.kind == "attn_moe":
        p["moe"] = M.init_moe(gen, cfg, device)
    else:
        p["mlp"] = M.init_mlp(gen, cfg, device)
    if cfg.post_norm:       # gemma2: a norm on each sublayer's output
        p["post1"] = L.init_norm(d, cfg.norm, device)
        p["post2"] = L.init_norm(d, cfg.norm, device)
    return p


def init_layer_cache(cfg: ModelConfig, spec: LayerSpec, batch: int,
                     max_len: int, dtype, device) -> Any:
    """The layer's cache of ``max_len`` positions. A windowed layer whose
    window is shorter than ``max_len`` is refused: the reference sizes its
    cache at the window and drops the writes past it, and a ring buffer is
    not ported yet (ROADMAP C2)."""
    _require_attn(spec)
    if spec.window and spec.window < max_len:
        raise ValueError(
            f"windowed layer: window {spec.window} < max_len {max_len}; a "
            f"cache of {spec.window} rows would be written past its end at "
            f"position {spec.window} (ROADMAP C2: windowed caches past the "
            "window are not ported)")
    return A.init_cache(cfg, batch, max_len, dtype, device)


def _residual(x: Tensor, delta: Tensor, p: dict, cfg: ModelConfig,
              post_key: str) -> Tensor:
    if cfg.post_norm and post_key in p:
        delta = L.apply_norm(delta, p[post_key], cfg.norm)
    return x + delta


def apply_layer(x: Tensor, p: dict, cfg: ModelConfig, spec: LayerSpec, *,
                causal: bool = True) -> tuple[Tensor, Tensor]:
    """Prefill / ``forward`` of one layer. Returns (x, aux_loss): an attn
    layer's aux loss is 0, an attn_moe layer's its router's load-balance
    loss. MoE runs the scan over experts, as the reference does without a
    mesh (its capacity dispatch comes with ``dist/``, ROADMAP A10)."""
    _require_attn(spec)
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    h = L.apply_norm(x, p["norm1"], cfg.norm)
    h = A.attend(h, p["attn"], cfg, window=spec.window, causal=causal)
    x = _residual(x, h, p, cfg, "post1")
    h = L.apply_norm(x, p["norm2"], cfg.norm)
    if spec.kind == "attn_moe":
        h, aux = M.apply_moe(h, p["moe"], cfg)
    else:
        h = M.apply_mlp(h, p["mlp"], cfg)
    x = _residual(x, h, p, cfg, "post2")
    return x, aux


def decode_layer(x: Tensor, cache: Any, p: dict, cfg: ModelConfig,
                 spec: LayerSpec) -> tuple[Tensor, Any]:
    """Single-token decode step of one layer (an attn_moe layer runs the
    scan over experts and drops its aux loss)."""
    _require_attn(spec)
    h = L.apply_norm(x, p["norm1"], cfg.norm)
    h, cache = A.decode_attend(h, cache, p["attn"], cfg, window=spec.window)
    x = _residual(x, h, p, cfg, "post1")
    h = L.apply_norm(x, p["norm2"], cfg.norm)
    if spec.kind == "attn_moe":
        h, _ = M.apply_moe(h, p["moe"], cfg)
    else:
        h = M.apply_mlp(h, p["mlp"], cfg)
    return _residual(x, h, p, cfg, "post2"), cache
