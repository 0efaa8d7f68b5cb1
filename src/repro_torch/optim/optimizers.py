"""Optimizers (AdamW, SGD with momentum), the LR schedule and global-norm
clipping (port of ``repro.optim.optimizers``), on nested dicts and lists
of tensors.

The arithmetic is the reference's, op for op in fp32: clip by the global
norm first, moments in fp32, bias correction with ``b ** step`` in fp32,
``delta = mhat / (sqrt(vhat) + 1e-8)``, decoupled weight decay on
matrices only, then ``p - lr * delta``; the LR in fp32 at ``count + 1``
(``cosine_warmup_schedule``: host scalars, so it reads the step count
once a step). Every division on tensors divides by a device tensor, so
it stays IEEE on CUDA (where torch turns division by a Python scalar into
a multiply by its reciprocal).

``update`` works in place: the params and the moments of the state it is
handed are overwritten (the reference donates them), and the returned
trees are those same tensors. Which leaves count as matrices is the
reference's decision (``ndim >= 2`` in ITS layout, where a layer group's
leaves carry a leading group axis): ``update`` takes a ``matrix`` tree of
booleans (``convert.reference_matrix_mask``), or uses each tensor's own
``ndim`` without one.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Callable, NamedTuple, Optional

import numpy as np
import torch

from repro_torch.configs.base import TrainConfig
from repro_torch.dist import compat

Tensor = torch.Tensor


def tree_leaves(tree: Any) -> list:
    """The leaves of a nested dict / list / tuple, dict keys sorted (the
    reference's flattening order); None is no leaf."""
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in tree_leaves(tree[k])]
    if isinstance(tree, (list, tuple)):
        return [x for v in tree for x in tree_leaves(v)]
    return [] if tree is None else [tree]


def tree_map(fn: Callable, tree: Any, *rest: Any) -> Any:
    """``fn`` over the leaves of ``tree`` (and the matching leaves of
    ``rest``), keeping the structure."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, v, *(r[k] for r in rest))
                for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        out = [tree_map(fn, v, *(r[i] for r in rest))
               for i, v in enumerate(tree)]
        return type(tree)(out) if isinstance(tree, tuple) else out
    return None if tree is None else fn(tree, *rest)


class AdamWState(NamedTuple):
    mu: Any
    nu: Any
    count: Tensor


class SGDState(NamedTuple):
    momentum: Any
    count: Tensor


def _f32(x: float, like: Tensor) -> Tensor:
    return torch.tensor(float(x), dtype=torch.float32, device=like.device)


def cosine_warmup_schedule(cfg: TrainConfig) -> Callable[[Any], np.float32]:
    """Cosine decay with linear warmup, plus the LR re-warmup ramps after
    budget-annealing knots (``cfg.lr_rewarmup_knots`` /
    ``cfg.anneal_warmup_steps``; off by default).

    The LR of an integer step (an int or an integer tensor) as an fp32
    scalar, computed on the host in IEEE single precision op for op as the
    reference's schedule runs op by op: true divisions, and cos(pi * prog)
    rounded to fp32 from double precision (XLA's cos is correctly rounded
    there; torch's fp32 cos is not always). The same bits on every device,
    so a resumed run on the card replays the LR exactly."""
    f = np.float32

    def lr(step) -> np.float32:
        step = f(int(step))
        warm = f(cfg.lr) * min(step / f(max(cfg.warmup_steps, 1)), f(1.0))
        prog = (step - f(cfg.warmup_steps)) / f(
            max(cfg.total_steps - cfg.warmup_steps, 1))
        prog = min(max(prog, f(0.0)), f(1.0))
        cos = f(0.5) * (f(1.0) + f(math.cos(float(f(math.pi) * prog))))
        out = warm if step < f(cfg.warmup_steps) else \
            f(cfg.lr) * (f(0.1) + f(0.9) * cos)
        if cfg.anneal_warmup_steps > 0:
            for knot in cfg.lr_rewarmup_knots:
                ramp = (step - f(knot)) / f(cfg.anneal_warmup_steps)
                ramp = min(max(ramp, f(0.0)), f(1.0))
                out = out * (ramp if step >= f(knot) else f(1.0))
        return f(out)
    return lr


def bias_correction(beta: float, step) -> np.float32:
    """1 - beta ** step in fp32: beta and the power rounded to fp32, the
    power taken in double precision (deterministic on every device; within
    an ulp of the reference's fp32 ``pow``)."""
    b = float(np.float32(beta))
    return np.float32(np.float32(1.0) - np.float32(b ** int(step)))


def clip_by_global_norm(grads: Any, max_norm: float) -> tuple[Any, Tensor]:
    """Scale ``grads`` (in place) so their global L2 norm is at most
    ``max_norm``; returns (grads, the norm before clipping)."""
    leaves = tree_leaves(grads)
    total = None
    for g in leaves:
        # a sharded leaf's sum is a collective (compat.full): the norm
        # and the scale are plain tensors, the same on every rank
        sq = compat.full(torch.sum(torch.square(g.to(torch.float32))))
        total = sq if total is None else total + sq
    gnorm = torch.sqrt(total)
    scale = torch.clamp(_f32(max_norm, gnorm)
                        / torch.clamp(gnorm, min=1e-12), max=1.0)
    torch._foreach_mul_(leaves, scale)
    return grads, gnorm


@dataclasses.dataclass(frozen=True)
class AdamW:
    cfg: TrainConfig

    def init(self, params: Any) -> AdamWState:
        z = lambda p: torch.zeros_like(p, dtype=torch.float32)
        dev = tree_leaves(params)[0].device
        return AdamWState(mu=tree_map(z, params), nu=tree_map(z, params),
                          count=torch.zeros((), dtype=torch.int32,
                                            device=dev))

    @torch.no_grad()
    def update(self, grads: Any, state: AdamWState, params: Any,
               matrix: Optional[Any] = None
               ) -> tuple[Any, AdamWState, dict]:
        c = self.cfg
        grads, gnorm = clip_by_global_norm(grads, c.grad_clip)
        step = state.count + 1
        n = int(step)
        lr = _f32(cosine_warmup_schedule(c)(n), gnorm)
        b1, b2 = c.beta1, c.beta2
        ps, gs = tree_leaves(params), tree_leaves(grads)
        ms, vs = tree_leaves(state.mu), tree_leaves(state.nu)
        mats = (tree_leaves(matrix) if matrix is not None
                else [p.ndim >= 2 for p in ps])
        gs = [g.to(torch.float32) for g in gs]
        torch._foreach_mul_(ms, b1)
        torch._foreach_add_(ms, torch._foreach_mul(gs, 1 - b1))
        torch._foreach_mul_(vs, b2)
        torch._foreach_add_(vs, torch._foreach_mul(
            torch._foreach_mul(gs, gs), 1 - b2))
        bc1 = _f32(bias_correction(b1, n), lr)
        bc2 = _f32(bias_correction(b2, n), lr)
        wd = _f32(c.weight_decay, lr)
        for p, m, v, mat in zip(ps, ms, vs, mats, strict=True):
            mhat = m / bc1
            vhat = v / bc2
            delta = mhat / (torch.sqrt(vhat) + 1e-8)
            if mat:     # decoupled weight decay on matrices only
                delta = delta + wd * p.to(torch.float32)
            p.copy_(p.to(torch.float32) - lr * delta)
        metrics = {"lr": lr, "grad_norm": gnorm}
        return params, AdamWState(state.mu, state.nu, step), metrics


@dataclasses.dataclass(frozen=True)
class SGDM:
    cfg: TrainConfig
    momentum: float = 0.9

    def init(self, params: Any) -> SGDState:
        z = lambda p: torch.zeros_like(p, dtype=torch.float32)
        dev = tree_leaves(params)[0].device
        return SGDState(momentum=tree_map(z, params),
                        count=torch.zeros((), dtype=torch.int32,
                                          device=dev))

    @torch.no_grad()
    def update(self, grads: Any, state: SGDState, params: Any,
               matrix: Optional[Any] = None
               ) -> tuple[Any, SGDState, dict]:
        c = self.cfg
        grads, gnorm = clip_by_global_norm(grads, c.grad_clip)
        step = state.count + 1
        lr = _f32(cosine_warmup_schedule(c)(int(step)), gnorm)
        ms = tree_leaves(state.momentum)
        torch._foreach_mul_(ms, self.momentum)
        torch._foreach_add_(ms, [g.to(torch.float32)
                                 for g in tree_leaves(grads)])
        for p, m in zip(tree_leaves(params), ms, strict=True):
            p.copy_(p.to(torch.float32) - lr * m)
        return params, SGDState(state.momentum, step), {"lr": lr,
                                                        "grad_norm": gnorm}


def make_optimizer(name: str, cfg: TrainConfig):
    if name == "adamw":
        return AdamW(cfg)
    if name == "sgdm":
        return SGDM(cfg)
    raise ValueError(name)
