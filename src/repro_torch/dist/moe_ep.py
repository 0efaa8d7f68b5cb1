"""Expert-parallel capacity routing for MoE layers (port of
``repro.dist.moe_ep``).

The baseline ``models.mlp.apply_moe`` scans over the experts and runs
every expert on every token (E/k redundant FLOPs). This is the GShard /
Switch capacity dispatch: tokens are gathered into an (experts,
capacity, d) buffer, each expert runs only on its own tokens, and on a
mesh the expert dim is sharded so the experts compute in parallel.
Wherever no token overflows capacity the result is the dense scan's.

The placements are explicit, on the mesh handed in (not the ambient
constraint wrappers), as in the reference. The expert products stay
fp32 torch products through ``mlp.expert_ffn``, as in the scan.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.dist.constrain import _is_dtensor, _ok, _place
from repro_torch.models import mlp as M

Tensor = torch.Tensor


def _constrain(x, mesh, entries: tuple):
    """Redistribute a DTensor so each named mesh axis shards its dim, with
    per-dim divisibility guards; a plain tensor is returned as it is."""
    if not _is_dtensor(x):
        return x
    return _place(x, [name if name is not None and _ok(mesh, name, dim)
                      else None for dim, name in zip(x.shape, entries)])


def capacity_of(cfg: ModelConfig, n_tokens: int) -> int:
    """Slots an expert takes: ceil(cf * n * k / E), within [1, n]."""
    c = int(math.ceil(cfg.moe.capacity_factor * n_tokens * cfg.moe.top_k
                      / cfg.moe.num_experts))
    return max(1, min(c, n_tokens))


def dispatch_plan(mask: Tensor, capacity: int) -> tuple[Tensor, Tensor]:
    """(keep, pos) of a (n, E) routing mask: each token's slot in its
    expert's buffer, in token order (a cumsum), and whether it fits."""
    pos = torch.cumsum(mask.to(torch.int32), dim=0) - 1
    return mask & (pos < capacity), pos


def apply_moe_capacity(x: Tensor, p: dict, cfg: ModelConfig, mesh
                       ) -> tuple[Tensor, Tensor]:
    """x: (B, T, d) -> (y, aux_loss), ``mlp.apply_moe``'s semantics.

    The experts go over the "data" axis (expert parallelism reuses the DP
    axis) when E divides it, else the capacity dim does, else nothing.
    Tokens beyond an expert's capacity ``ceil(cf * n * top_k / E)`` are
    dropped (their residual passes through), as in GShard."""
    assert cfg.moe is not None
    e = cfg.moe.num_experts
    b, t, d = x.shape
    n = b * t

    gates, mask, aux = M.route(x, p, cfg)   # the shared router + aux loss
    capacity = capacity_of(cfg, n)

    xf = x.reshape(n, d)
    gates_f = gates.reshape(n, e).to(x.dtype)
    keep, pos = dispatch_plan(mask.reshape(n, e), capacity)
    disp = (keep[..., None].to(x.dtype)
            * F.one_hot(torch.where(keep, pos, torch.zeros_like(pos))
                        .to(torch.int64), capacity).to(x.dtype))  # (n, E, C)

    xe = torch.einsum("nec,nd->ecd", disp, xf)                    # (E, C, d)
    if _ok(mesh, "data", e):
        ep_entries = ("data", None, None)
    elif _ok(mesh, "data", capacity):
        ep_entries = (None, "data", None)
    else:
        ep_entries = (None, None, None)
    xe = _constrain(xe, mesh, ep_entries)

    ye = torch.stack([M.expert_ffn(xe[i], p["w_gate"][i], p["w_up"][i],
                                   p["w_down"][i], cfg) for i in range(e)])
    ye = _constrain(ye, mesh, ep_entries)

    combine = disp * gates_f[..., None]                           # (n, E, C)
    y = torch.einsum("nec,ecd->nd", combine, ye)
    return y.reshape(b, t, d).to(x.dtype), aux
