"""GPipe-style microbatch pipelining over a mesh axis (port of
``repro.dist.pipeline``).

``pipeline_stack`` splits a stacked group of layers over the ranks of one
mesh axis (each rank owns ``n_groups / n_stages`` consecutive groups) and
streams microbatches through the stages, each step's activations passed
on by ``ppermute``. The schedule is the GPipe diagonal: at step ``t``
stage ``s`` runs microbatch ``t - s``; the ``n_stages - 1`` bubble steps
compute on values that are never written to the output, which keeps the
loop straight-line. ``ppermute`` is a ``torch.autograd.Function`` whose
backward is the reverse permutation, so the pipeline is differentiable
as the reference's is under ``jax.grad``.
"""
from __future__ import annotations

from typing import Callable

import torch
import torch.distributed as dist

from repro_torch.dist.constrain import mesh_axes


def _shift(x: torch.Tensor, group, by: int) -> torch.Tensor:
    """The tensor of the rank ``by`` places before this one on ``group``
    (cyclic), through one all-gather (no send / recv pairs to order)."""
    n = dist.get_world_size(group)
    me = dist.get_rank(group)
    flat = x.contiguous().reshape(-1)
    out = torch.empty(n * flat.numel(), dtype=x.dtype, device=x.device)
    dist.all_gather_into_tensor(out, flat, group=group)
    return out.reshape((n,) + tuple(x.shape))[(me - by) % n]


class _PPermute(torch.autograd.Function):
    """Stage s sends to s + 1 (cyclic); the backward sends each gradient
    back to the stage it came from."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return _shift(x, group, 1)

    @staticmethod
    def backward(ctx, g):
        return _shift(g, ctx.group, -1), None


class _SumOut(torch.autograd.Function):
    """The final sum over the axis that puts the last stage's outputs on
    every rank. Each rank's loss of the replicated result is the same
    loss, so the backward passes the gradient through as it is."""

    @staticmethod
    def forward(ctx, x, group):
        y = x.clone()
        dist.all_reduce(y, op=dist.ReduceOp.SUM, group=group)
        return y

    @staticmethod
    def backward(ctx, g):
        return g, None


def pipeline_stack(block: Callable, ws: torch.Tensor, x: torch.Tensor, *,
                   mesh, axis: str, n_micro: int) -> torch.Tensor:
    """Run ``block(stage_weights, h)`` as a pipeline over ``mesh[axis]``.

    ws: (n_groups, ...) stacked per-group weights, consumed in order; every
    rank holds the whole stack and runs its stage's slice, so the gradient
    of ``ws`` on a rank is nonzero at its stage only (sum it over the axis
    for the whole). x: (batch, ...) activations, the same on every rank,
    split into ``n_micro`` microbatches; stage 0 reads it. Returns the
    fold of ``block`` over all groups, on every rank of the axis."""
    n_stages = mesh.size(mesh_axes(mesh).index(axis))
    n_groups = ws.shape[0]
    if n_groups % n_stages:
        raise ValueError(f"{n_groups} groups not divisible by "
                         f"{n_stages} pipeline stages")
    batch = x.shape[0]
    if batch % n_micro:
        raise ValueError(f"batch {batch} not divisible by n_micro {n_micro}")
    per_stage = n_groups // n_stages
    mb = batch // n_micro
    group = mesh.get_group(axis)
    stage = mesh.get_local_rank(axis)
    stage_ws = ws.reshape((n_stages, per_stage) + tuple(ws.shape[1:]))[stage]
    xm = x.reshape((n_micro, mb) + tuple(x.shape[1:]))
    last = n_stages - 1
    # selects, not branches (the reference's jnp.where): every rank builds
    # the same graph, so every rank's backward runs the same collectives
    first = torch.tensor(stage == 0, device=x.device)
    is_last = torch.tensor(stage == last, device=x.device)
    buf = torch.zeros_like(xm[0])
    outs = [torch.zeros_like(xm[0]) for _ in range(n_micro)]
    for t in range(n_micro + n_stages - 1):
        inp = torch.where(first, xm[min(t, n_micro - 1)], buf)
        out = block(stage_ws, inp)
        m = t - last
        if m >= 0:  # microbatch m leaves the last stage at step t
            outs[m] = torch.where(is_last, out, outs[m])
        buf = _PPermute.apply(out, group)
    # only the last stage holds real outputs; the sum replicates them
    outs = torch.stack(outs)
    return _SumOut.apply(torch.where(is_last, outs, torch.zeros_like(outs)),
                         group).reshape(x.shape)
