"""Dense feed-forward block (port of ``repro.models.mlp``'s dense half;
the MoE experts come with their model families)."""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.models import layers as L

def _gelu(x: torch.Tensor) -> torch.Tensor:
    return F.gelu(x, approximate="tanh")      # jax.nn.gelu's default


_ACT = {"gelu": _gelu, "relu": F.relu, "silu": F.silu}


def init_mlp(gen: torch.Generator, cfg: ModelConfig, device) -> dict:
    d, ff = cfg.d_model, cfg.d_ff
    if cfg.activation in ("swiglu", "geglu"):
        return {"w_gate": L.init_linear(gen, d, ff, device),
                "w_up": L.init_linear(gen, d, ff, device),
                "w_down": L.init_linear(gen, ff, d, device)}
    return {"w_up": L.init_linear(gen, d, ff, device),
            "w_down": L.init_linear(gen, ff, d, device)}


def apply_mlp(x: torch.Tensor, p: dict, cfg: ModelConfig) -> torch.Tensor:
    if cfg.activation in ("swiglu", "geglu"):
        act = F.silu if cfg.activation == "swiglu" else _gelu
        h = act(L.project(x, p["w_gate"], cfg, "mlp.w_gate")) \
            * L.project(x, p["w_up"], cfg, "mlp.w_up")
    else:
        h = _ACT.get(cfg.activation, F.silu)(
            L.project(x, p["w_up"], cfg, "mlp.w_up"))
    return L.project(h, p["w_down"], cfg, "mlp.w_down")
