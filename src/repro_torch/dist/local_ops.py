"""Local forms of ops whose DTensor rules fail or cost too much, each
written on the ranks' shards with its collective spelled out.

  * ``local_apply``: a computation independent along its sharded dims
    (attention over batch and heads) run on the shards. DTensor runs the
    attention core's einsums forward, but their backward fails on a
    non-contiguous view (torch 2.11 and 2.13).
  * ``vocab_parallel_embed``: the embedding gather from a table sharded
    over its vocab dim, as Megatron does it: each rank gathers the rows it
    holds, zeroes the others, and one all-reduce over the vocab's mesh
    axis sums them. DTensor's own rule for a vocab-sharded ``embedding``
    fails in its backward on torch 2.11 (a partial-to-masked-partial
    redistribution it does not support).
"""
from __future__ import annotations

from typing import Callable

import torch
import torch.distributed as dist

from repro_torch.dist.compat import (DTensor, Partial, Replicate,
                                     from_local, is_dtensor)
from repro_torch.dist.constrain import mesh_axes, mesh_sizes


def _wrap(local: torch.Tensor, mesh, place) -> DTensor:
    """The DTensor whose shards are ``local`` on ``place`` (evenly
    sharded dims; its global shape from the local one)."""
    shape = list(local.shape)
    sizes = list(mesh_sizes(mesh).values())
    for i, p in enumerate(place):
        if p.is_shard():
            shape[p.dim] *= sizes[i]
    return from_local(local, mesh, place, shape)


def local_apply(fn: Callable, *xs, **kwargs):
    """``fn(*xs, **kwargs)`` on the local shards of DTensors that share one
    layout, the output wrapped back with that layout. ``xs[1:]`` are
    redistributed to ``xs[0]``'s placements first (partial placements
    become replicated). Plain tensors call ``fn`` as they are."""
    if not is_dtensor(xs[0]):
        return fn(*xs, **kwargs)
    mesh = xs[0].device_mesh
    place = tuple(Replicate() if p.is_partial() else p
                  for p in xs[0].placements)
    locs = [x.redistribute(mesh, place).to_local() for x in xs]
    return _wrap(fn(*locs, **kwargs), mesh, place)


class _MaskedRows(torch.autograd.Function):
    """Rows ``tokens - lo`` of a vocab shard, zero where a token lies
    outside [lo, lo + rows), summed over ``group`` (forward). The output
    is replicated over ``group``, so each rank's gradient is the whole
    gradient of its rows: the backward scatters it into the shard with no
    collective."""

    @staticmethod
    def forward(ctx, shard, tokens, lo, group):
        rows = shard.shape[0]
        mask = (tokens >= lo) & (tokens < lo + rows)
        idx = torch.where(mask, tokens - lo, torch.zeros_like(tokens))
        out = shard[idx] * mask[..., None].to(shard.dtype)
        dist.all_reduce(out, op=dist.ReduceOp.SUM, group=group)
        ctx.save_for_backward(idx, mask)
        ctx.rows = rows
        return out

    @staticmethod
    def backward(ctx, g):
        idx, mask = ctx.saved_tensors
        grad = torch.zeros((ctx.rows, g.shape[-1]), dtype=g.dtype,
                           device=g.device)
        grad.index_add_(0, idx[mask], g[mask])
        return grad, None, None, None


def vocab_parallel_embed(table: DTensor, tokens) -> DTensor:
    """``table[tokens]`` for a DTensor table whose vocab dim (0) is
    sharded over at most one mesh axis: (B, T, d) placed as the tokens'
    batch, replicated elsewhere. Other sharded dims of the table (FSDP)
    are gathered first."""
    mesh = table.device_mesh
    axes = mesh_axes(mesh)
    vocab_at = [i for i, p in enumerate(table.placements)
                if p.is_shard() and p.dim == 0]
    table = table.redistribute(mesh, [
        p if i in vocab_at else Replicate()
        for i, p in enumerate(table.placements)])
    tok_place = (list(tokens.placements) if is_dtensor(tokens)
                 else [Replicate() for _ in axes])
    tok_local = tokens.to_local() if is_dtensor(tokens) else tokens
    # a replicated table used on batch-sharded tokens gets a gradient
    # that is partial over the batch's axes (summed by the train step's
    # redistribute to the table's placements)
    grad_place = [p if i in vocab_at
                  else (Partial() if tok_place[i].is_shard() else p)
                  for i, p in enumerate(table.placements)]
    shard = table.to_local(grad_placements=grad_place)
    if vocab_at:
        i = vocab_at[0]
        lo = mesh.get_local_rank(axes[i]) * shard.shape[0]
        out = _MaskedRows.apply(shard, tok_local, lo,
                                mesh.get_group(axes[i]))
    else:
        out = shard[tok_local]
    out_place = [p if p.is_shard() else Replicate() for p in tok_place]
    return _wrap(out, mesh, out_place)
