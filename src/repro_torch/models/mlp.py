"""Feed-forward blocks (port of ``repro.models.mlp``): dense (SwiGLU /
GeGLU / GELU / ReLU) and Mixture-of-Experts.

MoE: a top-k softmax router and a scan over ALL experts, every expert on
every token, its output weighted by the token's gate (zero for the
experts not selected) and summed in expert order. The expert-parallel
capacity dispatch (``dist.moe_ep``) replaces the scan under an active
mesh when ``cfg.moe_impl == "capacity"`` (``transformer.
_apply_moe_dispatch``); both share ``route`` and ``expert_ffn``.

Under a serving mesh (``dist.local_ops.use_shards``) the router is whole
on every rank and runs at the whole batch's row count (a data rank's rows
and zeros), so the gates are one rank's bit for bit. The experts are
split over "model" by expert (``serving.serving_shardings``): each rank
runs its E / model whole experts at the whole batch's row count, one
rank's cuBLAS shapes, and the experts' outputs are gathered over "model"
in one collective before the gated sum in expert order, so a step equals
one rank's bit for bit. A "model" axis that does not divide the experts
(only the dry run's 16 ranks over 8: the engine refuses it) splits each
expert over d_ff instead, as ``dist.sharding.param_specs`` does; its
``w_down`` partials are summed over "model" (``ServeShards.sum_model``),
as the dry run's fp row-parallel projections are.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.dist import constrain as C
from repro_torch.dist import local_ops
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


# ---------------------------------------------------------------------------
# Mixture of Experts
# ---------------------------------------------------------------------------

def init_moe(gen: torch.Generator, cfg: ModelConfig, device) -> dict:
    """The router {"w"} (d, E) and the fp32 expert stacks (E, d, ff),
    (E, d, ff), (E, ff, d), scaled in place (no second copy of a stack)."""
    e = cfg.moe.num_experts
    d, ff = cfg.d_model, cfg.d_ff

    def stack(shape, scale):
        return torch.randn(shape, generator=gen, dtype=torch.float32,
                           device=device).mul_(scale)

    return {"router": L.init_linear(gen, d, e, device, scale=0.02),
            "w_gate": stack((e, d, ff), d ** -0.5),
            "w_up": stack((e, d, ff), d ** -0.5),
            "w_down": stack((e, ff, d), ff ** -0.5)}


def router_topk(logits: torch.Tensor, top_k: int
                ) -> tuple[torch.Tensor, torch.Tensor]:
    """Softmax-after-top-k gates (Mixtral convention): (gates, mask), gates
    (..., E) zero outside the top k, mask = gates > 0 (a gate that
    underflows to 0 is not routed). The top k are taken in
    ``jax.lax.top_k``'s order, value descending and ties lowest index first
    (a stable sort: ``torch.topk`` promises no order for ties), so the
    softmax sums the same values in the same order."""
    vals, idx = torch.sort(logits, dim=-1, descending=True, stable=True)
    probs = torch.softmax(vals[..., :top_k], dim=-1)
    gates = torch.zeros_like(logits).scatter(-1, idx[..., :top_k], probs)
    return gates, gates > 0


def route(x: torch.Tensor, p: dict, cfg: ModelConfig
          ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(gates, mask, aux_loss): the router's logits in fp32, its top-k
    gates, and the Switch-style load-balance loss E * sum_e f_e * p_e
    (f_e the share of tokens routed to e, p_e its mean router
    probability, both over (B, T))."""
    e = cfg.moe.num_experts
    logits = L.apply_linear(x, p["router"], L.module_quant(cfg, "moe.router"),
                            path="moe.router").to(torch.float32)
    gates, mask = router_topk(logits, cfg.moe.top_k)
    probs_full = torch.softmax(logits, dim=-1)
    f = torch.mean(mask.to(torch.float32), dim=(0, 1))
    pbar = torch.mean(probs_full, dim=(0, 1))
    return gates, mask, e * torch.sum(f * pbar)


def expert_ffn(x: torch.Tensor, w_gate: torch.Tensor, w_up: torch.Tensor,
               w_down: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    """One expert's gated FFN, each projection through ``qlinear`` at its
    ``moe.*`` quant mode (SiLU for both gated activations, as the
    reference). It runs under ``calib_suspend``, as the reference's expert
    scan does: the expert roles keep dynamic activation ranges and stay
    unseen in a calibration collection; the router is calibrated."""
    act = F.silu if cfg.activation in ("swiglu", "geglu") else \
        _ACT.get(cfg.activation, F.silu)
    with L.calib_suspend():
        h = act(L.qlinear(x, w_gate.to(x.dtype), None,
                          L.module_quant(cfg, "moe.w_gate"),
                          path="moe.w_gate")) \
            * L.qlinear(x, w_up.to(x.dtype), None,
                        L.module_quant(cfg, "moe.w_up"), path="moe.w_up")
        h = C.constrain_axis(h, -1, "model")
        return L.qlinear(h, w_down.to(x.dtype), None,
                         L.module_quant(cfg, "moe.w_down"),
                         path="moe.w_down")


def apply_moe(x: torch.Tensor, p: dict, cfg: ModelConfig
              ) -> tuple[torch.Tensor, torch.Tensor]:
    """x (B, T, d) -> (y, aux_loss): every expert on every token,
    y = carry + gate_e * y_e in expert order 0..E-1. No host sync and no
    data-dependent shape, so a decode step that runs it can be captured
    as a CUDA graph. Under a serving mesh (module docstring; decode, which
    drops the aux loss) ``x`` is the rank's rows and the aux loss is 0."""
    shards = local_ops.current_shards()
    if shards is not None:
        return (_apply_moe_shards(x, p, cfg, shards),
                x.new_zeros((), dtype=torch.float32))
    gates, _, aux = route(x, p, cfg)
    y = torch.zeros_like(x)
    for e in range(cfg.moe.num_experts):
        y_e = expert_ffn(x, p["w_gate"][e], p["w_up"][e], p["w_down"][e], cfg)
        y = y + gates[..., e, None].to(x.dtype) * y_e
    return y, aux


def _apply_moe_shards(x: torch.Tensor, p: dict, cfg: ModelConfig,
                      shards) -> torch.Tensor:
    """``apply_moe``'s y on the rank's rows ``x`` and its shards of the
    experts (module docstring): the gates at the whole batch's row count,
    each expert's y_e (the rank's whole experts at the whole batch's row
    count, gathered over "model"; or with a d_ff split every expert's
    partial, summed over "model": one collective a layer either way), then
    y = y + gate_e * y_e in expert order."""
    gates = shards.at_batch_shape(lambda h: route(h, p, cfg)[0], x)

    def experts(h):         # (B, E here, T, d): each expert's (partial) y_e
        return torch.stack([expert_ffn(h, w_gate, w_up, w_down, cfg)
                            for w_gate, w_up, w_down in zip(
                                p["w_gate"], p["w_up"], p["w_down"])], dim=1)

    if p["w_down"].shape[1] == cfg.d_ff:        # whole experts
        parts = shards.gather_model(shards.at_batch_shape(experts, x), dim=1)
    else:                                       # every expert's d_ff slice
        parts = shards.sum_model(experts(x))
    y = torch.zeros_like(x)
    for e in range(cfg.moe.num_experts):
        y = y + gates[..., e, None].to(x.dtype) * parts[:, e]
    return y
