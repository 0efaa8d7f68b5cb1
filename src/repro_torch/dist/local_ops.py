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
  * ``ServeShards`` and ``use_shards``: decode on each rank's local shards
    of a serving mesh (``serve_engine.ServeEngine(mesh=...)``, the dry
    run's decode cells). A kernel takes no DTensor, so the model runs on
    plain local tensors (the rank's heads, its columns or K rows of each
    projection, its batch rows) and issues its collectives at named
    points: the activation quantizers' ranges (``reduce_range``), the
    row-parallel projections' int32 sums (``sum_model``), the embedding
    gather (``vocab_rows``) and the head (``gather_rows``,
    ``gather_model``). Every one is an integer sum, a min / max or a copy,
    so a step under a mesh equals the one-rank step bit for bit. The MoE
    experts are split by expert (each rank runs whole experts, their
    outputs gathered).

    The recurrent blocks (Mamba2, RWKV-6) split their state by heads. Their
    fp32 recurrence runs at one rank's shape (``place`` / ``take``: the
    rank's rows and heads at their place among zeros), since a CUDA
    contraction's order may follow the count of heads or rows it is given.

    The cross-attending families (an encoder-decoder, vision) run their
    frontend on the rank's rows (``own_rows``): the conv stem whole on
    every rank, its quantizer's range reduced over "data"; the encoder at
    the rank's heads; each cross_attn layer's source K / V projected at
    the rank's KV heads into the slot.
"""
from __future__ import annotations

import contextlib
import contextvars
import dataclasses
from typing import Any, Callable, Optional

import torch
import torch.distributed as dist

from repro_torch.dist.compat import (DTensor, Partial, Replicate,
                                     from_local, is_dtensor)
from repro_torch.dist.constrain import mesh_axes, mesh_sizes
from repro_torch.dist.sharding import _ROW


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


def _masked_rows(shard, tokens, lo, group):
    """Rows ``tokens - lo`` of a vocab shard, zero where a token lies
    outside [lo, lo + rows), summed over ``group``: one nonzero row and
    zeros, so the sum is exact. Returns (out, idx, mask)."""
    rows = shard.shape[0]
    mask = (tokens >= lo) & (tokens < lo + rows)
    idx = torch.where(mask, tokens - lo, torch.zeros_like(tokens))
    out = shard[idx] * mask[..., None].to(shard.dtype)
    dist.all_reduce(out, op=dist.ReduceOp.SUM, group=group)
    return out, idx, mask


class _MaskedRows(torch.autograd.Function):
    """Rows ``tokens - lo`` of a vocab shard, zero where a token lies
    outside [lo, lo + rows), summed over ``group`` (forward). The output
    is replicated over ``group``, so each rank's gradient is the whole
    gradient of its rows: the backward scatters it into the shard with no
    collective."""

    @staticmethod
    def forward(ctx, shard, tokens, lo, group):
        out, idx, mask = _masked_rows(shard, tokens, lo, group)
        ctx.save_for_backward(idx, mask)
        ctx.rows = shard.shape[0]
        return out

    @staticmethod
    def backward(ctx, g):
        idx, mask = ctx.saved_tensors
        grad = torch.zeros((ctx.rows, g.shape[-1]), dtype=g.dtype,
                           device=g.device)
        # every token's row, zeroed where it is another rank's (adding an
        # exact zero changes no sum; no boolean index, whose shape would
        # depend on the data)
        grad.index_add_(0, idx.reshape(-1),
                        (g * mask[..., None].to(g.dtype)).reshape(
                            -1, g.shape[-1]))
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


# ---------------------------------------------------------------------------
# Decode on the local shards of a serving mesh
# ---------------------------------------------------------------------------

_SHARDS: contextvars.ContextVar = contextvars.ContextVar(
    "repro_torch_serve_shards", default=None)
_WHOLE_ROWS: contextvars.ContextVar = contextvars.ContextVar(
    "repro_torch_whole_rows", default=False)


@dataclasses.dataclass(frozen=True)
class ServeShards:
    """One rank's place on a serving mesh with dims ("data", "model"):
    ``model`` ranks split every projection (the column-parallel ones by
    output columns, the row-parallel ones by K rows), the heads and the
    vocabulary, each holding a 1/model share; ``data`` ranks split the
    ``batch`` rows. ``kv_heads`` is the rank's count of KV heads: the
    config's KV heads over ``model`` when it divides them, else 1, taken
    from the K/V projections' gathered output (the dry run's (16, 16) mesh
    over 8 KV heads; a serve engine refuses that case). Build it with
    ``for_mesh``."""
    mesh: Any
    model: int
    data: int
    model_rank: int
    data_rank: int
    batch: int
    kv_heads: int
    kv_first: int
    kv_gather: bool
    data_group: Any = None
    # the config's head counts; a "model" axis that does not divide the
    # query heads (the dry run's reduced configs on 16 ranks) has every
    # rank gather the Q/K/V columns and run every head
    num_heads: int = 0
    num_kv_heads: int = 0

    @classmethod
    def for_mesh(cls, mesh, cfg, batch: int) -> "ServeShards":
        """The shards of ``mesh`` (dims ("data", "model"), or ("pod",
        "data", "model") with the batch over pod and data together) for
        ``cfg`` at ``batch`` global rows; raises on a layout the local
        decode cannot split evenly."""
        axes = mesh_axes(mesh)
        if axes not in (("data", "model"), ("pod", "data", "model")):
            raise ValueError(f"a serving mesh has dims ('data', 'model') "
                             f"or ('pod', 'data', 'model'), got {axes}")
        sizes = mesh_sizes(mesh)
        coord = mesh.get_coordinate()
        m, d = sizes["model"], sizes["data"]
        data_rank = coord[-2]
        rows_mesh = mesh["data"]
        if axes[0] == "pod":
            data_rank += coord[0] * d
            d *= sizes["pod"]
            rows_mesh = mesh["pod", "data"]._flatten()
        h, kh = cfg.num_heads, cfg.num_kv_heads
        if batch % d:
            raise ValueError(f"a ({d}, {m}) mesh needs the batch ({batch}) "
                             f"divisible by {d}")
        rank = int(coord[-1])
        if h % m:
            kv, first, gather = kh, 0, True
        elif kh % m == 0:
            kv, first, gather = kh // m, rank * (kh // m), False
        elif (h // kh) % (h // m) == 0:
            kv, first, gather = 1, rank * (h // m) // (h // kh), True
        else:
            raise ValueError(f"{m}-way heads split {kh} KV heads unevenly")
        return cls(mesh=mesh, model=m, data=d, model_rank=rank,
                   data_rank=int(data_rank), batch=batch, kv_heads=kv,
                   kv_first=first, kv_gather=gather,
                   data_group=rows_mesh.get_group(), num_heads=h,
                   num_kv_heads=kh)

    @property
    def rows(self) -> slice:
        """This rank's batch rows of the global batch."""
        n = self.batch // self.data
        return slice(self.data_rank * n, (self.data_rank + 1) * n)

    def local_cfg(self, cfg):
        """``cfg`` with the rank's head counts (the head dim kept), the
        config the local decode runs under."""
        return dataclasses.replace(cfg,
                                   num_heads=self.heads_here(cfg.num_heads),
                                   num_kv_heads=self.kv_heads,
                                   head_dim=cfg.resolved_head_dim)

    def kv_heads_of(self, t, hd: int):
        """The rank's KV heads (..., kv_heads, hd) of a K or V projection's
        local columns (..., cols): its own heads, or with ``kv_gather``
        every rank's columns gathered and its head picked out."""
        if not self.kv_gather:
            return t.reshape(*t.shape[:-1], self.kv_heads, hd)
        t = self.whole(t, self.num_kv_heads * hd)
        t = t.reshape(*t.shape[:-1], t.shape[-1] // hd, hd)
        return t[..., self.kv_first:self.kv_first + self.kv_heads, :]

    def _group(self, model: bool, data: bool):
        if model and data:
            return dist.group.WORLD
        return self.mesh.get_group("model") if model else self.data_group

    def reduce_range(self, lo, hi, *, model: bool, rows: bool = True):
        """The global [lo, hi] of a quantizer's input from each rank's own:
        max of (hi, -lo) over the axes that split the input (``rows``: the
        batch rows over "data", unless the head gathered them; ``model``:
        K or the heads over "model"), one all-reduce of the pair. lo, hi
        are 0-dim, or per batch row with ``rows`` False."""
        over_data = rows and self.data > 1 and not _WHOLE_ROWS.get()
        over_model = model and self.model > 1
        if not (over_data or over_model):
            return lo, hi
        pair = torch.stack([hi, -lo])
        dist.all_reduce(pair, op=dist.ReduceOp.MAX,
                        group=self._group(over_model, over_data))
        return -pair[1], pair[0]

    def sum_model(self, t):
        """``t`` summed over "model" in place (a row-parallel projection's
        int32 sums: exact in any order)."""
        if self.model > 1:
            dist.all_reduce(t, op=dist.ReduceOp.SUM,
                            group=self._group(True, False))
        return t

    def _gather(self, t, n: int, model: bool):
        parts = [torch.empty_like(t) for _ in range(n)]
        dist.all_gather(parts, t.contiguous(),
                        group=self._group(model, not model))
        return parts

    def gather_model(self, t, dim: int = -1):
        """The ranks' column shards of ``t`` joined along ``dim``."""
        if self.model == 1:
            return t
        return torch.cat(self._gather(t, self.model, True), dim=dim)

    def whole(self, t, width: int, dim: int = -1):
        """A column-parallel output of ``width`` columns along ``dim``, whole
        on every rank: the ranks' shards gathered when the rank holds
        1/model of them; a width the axis does not divide stays whole in
        the store and is returned as it is."""
        if t.shape[dim] == width:
            return t
        if t.shape[dim] * self.model != width:
            raise ValueError(f"{t.shape[dim]} columns are not a 1/"
                             f"{self.model} share of {width}")
        return self.gather_model(t, dim)

    def splits(self, heads: int) -> bool:
        """Whether ``heads`` heads (or channels) are split over "model",
        each rank holding heads / model of them; else each holds all (the
        rule of ``dist.sharding.slot_specs``)."""
        return self.model > 1 and heads % self.model == 0

    def heads_here(self, heads: int) -> int:
        """The count of ``heads`` heads this rank holds."""
        return heads // self.model if self.splits(heads) else heads

    def part(self, t, heads: int, dim: int = -1):
        """The rank's share of a whole (replicated) tensor's ``heads``
        heads along ``dim`` (a per-head or per-channel leaf such as
        ``decay_base``), or ``t`` when the heads are not split."""
        if not self.splits(heads):
            return t
        n = t.shape[dim] // self.model
        return t.narrow(dim, self.model_rank * n, n)

    def heads_of(self, t, heads: int, width: int, dim: int = -1):
        """A column-parallel output's columns of the rank's heads, of
        ``heads`` heads over ``width`` columns: the local columns when they
        are its heads (a split that falls on whole heads), else every
        rank's gathered (the heads whole on every rank)."""
        if self.splits(heads):
            return t
        return self.whole(t, width, dim)

    def k_rows(self, x, k: int):
        """The rank's ``k`` rows of a row-parallel projection's K, cut from
        a whole input ``x`` (..., k * model); ``x`` as it is when it holds
        k columns already."""
        n = x.shape[-1]
        if n == k:
            return x
        if n != k * self.model:
            raise ValueError(f"an input of {n} columns for a K shard of {k}"
                             f" on {self.model} ranks")
        return x.narrow(-1, self.model_rank * k, k)

    def _padded_rows(self, n: int) -> bool:
        return n != self.batch and not _WHOLE_ROWS.get()

    def place(self, t, dim: Optional[int] = None, heads: int = 0):
        """``t`` (the rank's batch rows and, at ``dim``, its share of
        ``heads`` heads) at its place in a zero tensor of one rank's shape:
        the whole batch's rows and every head. The rest is zeros."""
        shape, idx = list(t.shape), [slice(None)] * t.ndim
        if self._padded_rows(shape[0]):
            shape[0], idx[0] = self.batch, self.rows
        if dim is not None and self.splits(heads):
            n = shape[dim]
            shape[dim] = n * self.model
            idx[dim] = slice(self.model_rank * n, (self.model_rank + 1) * n)
        if shape == list(t.shape):
            return t
        out = t.new_zeros(shape)
        out[tuple(idx)] = t
        return out

    def take(self, t, rows: int, dim: Optional[int] = None,
             heads: int = 0):
        """The inverse of ``place``: the rank's ``rows`` batch rows and its
        share of the ``heads`` heads at ``dim`` of a one-rank-shaped
        ``t``."""
        if self._padded_rows(rows):
            t = t[self.rows]
        if dim is not None:
            t = self.part(t, heads, dim)
        return t

    def own_rows(self, t):
        """This rank's batch rows (dim 0) of ``t``, which every rank holds
        whole (a wave's frontend input)."""
        return t if self.data == 1 else t[self.rows]

    def gather_rows(self, t):
        """Every data rank's batch rows of ``t`` (dim 0), in rank order."""
        if self.data == 1:
            return t
        return torch.cat(self._gather(t, self.data, False), dim=0)

    def at_batch_shape(self, fn, x):
        """``fn(x)`` for a per-row function of the rank's batch rows ``x``,
        run on a tensor of the whole batch's row count (x, then zero rows):
        a CUDA reduction picks its order from the tensor's shape, so a
        norm over 2 rows of (2, 1, d) can round otherwise than the same
        rows of (4, 1, d), the one-rank engine's shape."""
        n = x.shape[0]
        if self.data == 1 or _WHOLE_ROWS.get() or n == self.batch:
            return fn(x)
        pad = x.new_zeros((self.batch - n,) + tuple(x.shape[1:]))
        return fn(torch.cat([x, pad]))[:n]

    def vocab_rows(self, table, tokens):
        """``table[tokens]`` from the rank's vocab shard of the table."""
        if self.model == 1:
            return table[tokens]
        lo = self.model_rank * table.shape[0]
        return _masked_rows(table, tokens, lo,
                            self._group(True, False))[0]


@contextlib.contextmanager
def use_shards(shards: Optional[ServeShards]):
    """Run the enclosed decode on ``shards``' local tensors (None: one
    rank, no collective)."""
    token = _SHARDS.set(shards)
    try:
        yield shards
    finally:
        _SHARDS.reset(token)


def current_shards() -> Optional[ServeShards]:
    """The shards of the enclosing ``use_shards``, or None."""
    return _SHARDS.get()


@contextlib.contextmanager
def whole_rows():
    """The enclosed code sees the whole batch on every rank (the head after
    ``gather_rows``): its quantizer ranges need no "data" reduction."""
    token = _WHOLE_ROWS.set(True)
    try:
        yield
    finally:
        _WHOLE_ROWS.reset(token)


def row_parallel(path: Optional[str]) -> bool:
    """Whether the projection at module ``path`` ("attn.wo", ...) is
    row-parallel: one that contracts back to d_model, its K sharded over
    "model" (``dist.sharding``'s rule)."""
    return path is not None and path.rsplit(".", 1)[-1] in _ROW
