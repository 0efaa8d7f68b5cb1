"""PartitionSpec assignment for params, decode caches and input batches
(port of ``repro.dist.sharding``), the specs' DTensor placements, and the
fleet's host-level rung sharding (``rung_shard``).

The spec functions read only the mesh's axis names and sizes
(``constrain.mesh_axes``), so they work on a ``DeviceMesh`` and on an
abstract stand-in (an object with ``axis_names`` and a ``shape`` mapping)
alike, as the reference's do.

Invariants, the reference's:
  * a mesh axis is used at most once per spec;
  * an assigned dimension is always divisible by the axis size;
  * norm / bias parameters are replicated.

The reference stacks the layers of a repeating group along a leading axis
and never shards that stack dim; the port keeps one dict per layer, so it
has no stack dim, and its spec of a layer leaf is the reference's without
the leading ``None`` (``convert.reference_layout`` restacks them).

Parameter rules follow Megatron's column / row duality: projections that
expand (wq / wk / wv / w_gate / w_up / ...) shard their output dim over
"model"; projections that contract back to d_model (wo / w_down /
out_proj) shard their input dim, so the pair needs one all-reduce. FSDP
also shards the largest free dim over "data" (ZeRO-3).
"""
from __future__ import annotations

import dataclasses
from typing import Any, Sequence

from repro_torch.configs.base import ParallelConfig
from repro_torch.dist.constrain import (_axis_size, _ok, batch_axis,
                                        mesh_axes, mesh_sizes)

# column-parallel (shard dim -1) / row-parallel (shard dim -2) parents
_ROW = {"wo", "w_down", "out_proj"}
_COL = {"wq", "wk", "wv", "w_gate", "w_up", "router", "in_proj", "wr",
        "wg", "decay_a", "decay_b", "lm_head"}
# dict keys that hold the weight under a projection parent (w_planes_*:
# the packed plane artifact, (P, K/8, N), sharded by the parent's rule)
_WEIGHT_KEYS = {"w", "w_q", "w_planes_pos", "w_planes_neg"}
# leaves that are always replicated (act_*: the activation quantizer's
# scalars; plane_shift: a rung view's dropped-low-plane count)
_REPLICATED_KEYS = {"b", "bias", "scale", "w_scale", "act_n", "act_nlvl",
                    "act_lo", "act_hi", "act_s", "act_z", "w_colsum",
                    "plane_shift"}


class PartitionSpec:
    """One mesh axis name (or a tuple of names, or None) per tensor dim:
    the port's counterpart of ``jax.sharding.PartitionSpec``. A leaf of a
    spec tree (no tuple, so tree walkers do not descend into it); it
    equals a tuple of the same entries."""

    __slots__ = ("entries",)

    def __init__(self, *entries):
        self.entries = tuple(entries)

    def __iter__(self):
        return iter(self.entries)

    def __len__(self) -> int:
        return len(self.entries)

    def __getitem__(self, i):
        return self.entries[i]

    def __eq__(self, other) -> bool:
        if isinstance(other, PartitionSpec):
            other = other.entries
        return isinstance(other, tuple) and self.entries == other

    def __hash__(self) -> int:
        return hash(self.entries)

    def __repr__(self) -> str:
        return f"P{self.entries!r}"


P = PartitionSpec


def _walk(fn, tree: Any, path: tuple = ()) -> Any:
    """``fn(path, leaf)`` over a nested dict / list / tuple; a path holds
    dict keys and list indices as strings."""
    if isinstance(tree, dict):
        return {k: _walk(fn, v, path + (str(k),)) for k, v in tree.items()}
    if hasattr(tree, "_fields"):                # a NamedTuple: by field
        return type(tree)(*(_walk(fn, getattr(tree, f), path + (f,))
                            for f in tree._fields))
    if isinstance(tree, (list, tuple)):
        return type(tree)(_walk(fn, v, path + (str(i),))
                          for i, v in enumerate(tree))
    return None if tree is None else fn(path, tree)


def greedy_spec(dims: Sequence[int], mesh) -> P:
    """Assign mesh axes (in mesh order, so "data" lands on the batch dim
    first) to the first divisible unassigned dim each."""
    entries: list[Any] = [None] * len(dims)
    for ax in mesh_axes(mesh):
        size = _axis_size(mesh, ax)
        if size <= 1:
            continue
        for i, d in enumerate(dims):
            if entries[i] is None and d % size == 0:
                entries[i] = ax
                break
    return P(*entries)


# ---------------------------------------------------------------------------
# Parameters
# ---------------------------------------------------------------------------

def _fsdp_dim(shape, entries) -> int | None:
    """Largest unassigned dim, for ZeRO sharding (the first of equals)."""
    cands = [i for i in range(len(shape)) if entries[i] is None]
    if not cands:
        return None
    return max(cands, key=lambda i: shape[i])


def param_specs(shapes: Any, mesh, par: ParallelConfig) -> Any:
    """PartitionSpec tree matching a param tree (tensors, or anything with
    a ``shape``)."""

    def rule(names, leaf):
        shape = tuple(leaf.shape)
        if len(shape) == 0:
            return P()
        leaf_key = names[-1]
        entries: list[Any] = [None] * len(shape)
        if leaf_key in _REPLICATED_KEYS or any("norm" in n for n in names):
            return P(*entries)
        parent = None
        for n in reversed(names):
            if n in _COL or n in _ROW or n == "embed":
                parent = n
                break
        is_weight = (leaf_key in _WEIGHT_KEYS or leaf_key in _COL
                     or leaf_key in _ROW or leaf_key == "table")
        if parent is None and leaf_key != "table":
            return P(*entries)
        if not is_weight or len(shape) < 2:
            return P(*entries)
        if leaf_key == "table":           # embedding: shard the vocab dim
            if _ok(mesh, "model", shape[-2]):
                entries[-2] = "model"
        elif parent in _ROW:
            if _ok(mesh, "model", shape[-2]):
                entries[-2] = "model"
        else:                             # column-parallel default
            if _ok(mesh, "model", shape[-1]):
                entries[-1] = "model"
        if par.fsdp:
            i = _fsdp_dim(shape, entries)
            if i is not None and _ok(mesh, "data", shape[i]):
                entries[i] = "data"
        return P(*entries)

    return _walk(rule, shapes)


# ---------------------------------------------------------------------------
# Decode caches / recurrent state
# ---------------------------------------------------------------------------

def cache_specs(tree: Any, mesh) -> Any:
    """Greedy specs for a decode state tree, as ``constrain.dp_model_plan``
    lays it out: batch -> "data", the first divisible later dim (the cached
    sequence) -> "model"; without a batch axis the first divisible later
    dim takes "data". The port's state is one cache per layer with no
    stack dim; scalars map to P()."""

    def rule(_, leaf):
        shape = tuple(leaf.shape)
        if len(shape) == 0:
            return P()
        entries: list[Any] = [None] * len(shape)
        if _ok(mesh, "data", shape[0]):
            entries[0] = "data"
        model_at = None
        for i in range(1, len(shape)):
            if _ok(mesh, "model", shape[i]):
                entries[i] = "model"
                model_at = i
                break
        if entries[0] is None and model_at is None:
            for i in range(1, len(shape)):
                if _ok(mesh, "data", shape[i]):
                    entries[i] = "data"
                    break
        return P(*entries)

    return _walk(rule, tree)


# the head dim of each leaf of an attention cache (models.attention's
# KVCache and QuantKVCache; the per-position quantizer rows have none) and
# of a recurrent state (ssm.SSMState.state (B, H, P, N), rwkv.RWKVState.wkv
# (B, H, hd, hd); the conv tail and the token shifts have none)
_SLOT_HEAD_DIM = {"k": 2, "v": 2, "k_planes": 3, "v_planes": 3,
                  "state": 1, "wkv": 1}
# a cross_attn layer's source K and V in a decode state, each (B, S, KH,
# hd) at the path "cross_kv/<layer>/<0 | 1>": its KV heads at dim 2
_CROSS_HEAD_DIM = 2


def _slot_head_dim(path: tuple):
    if len(path) >= 3 and path[-3] == "cross_kv":
        return _CROSS_HEAD_DIM
    return _SLOT_HEAD_DIM.get(path[-1])


def slot_specs(tree: Any, mesh) -> Any:
    """Specs of a serve engine's decode state on a serving mesh
    (``serve_engine.ServeEngine(mesh=...)``): the batch dim on "data" and
    an attention cache's KV-head dim, a cross_attn layer's source K / V
    KV-head dim, a Mamba2 state's and an RWKV wkv state's head dim on
    "model"; the quantizer rows, the conv tail and the token shifts follow
    the batch and stay whole over "model" (they are small, and every rank
    reads the whole B and C streams and the whole layer input), the
    lengths and positions are replicated. ``tree`` is a whole
    ``models.model.DecodeState`` or its ``caches``.

    This is the port's layout, not the reference's. ``cache_specs`` puts
    the cached sequence on "model" (the reference's sequence-parallel
    decode on the TPU). Split along S, each rank would hold a piece of
    every head's softmax, and the attention kernel's reduction over S
    would run in another float order on each rank, so a step would no
    longer equal one rank's bit for bit. With whole heads on each rank the
    kernel runs as it does on one rank, on fewer heads. A windowed layer's
    ring (``models.attention.is_ring``) is laid out as a full cache is:
    its rows stay whole on every rank."""

    def rule(path, leaf):
        shape = tuple(leaf.shape)
        entries: list[Any] = [None] * len(shape)
        if not shape:
            return P()
        if _ok(mesh, "data", shape[0]):
            entries[0] = "data"
        head = _slot_head_dim(path)
        if head is not None and _ok(mesh, "model", shape[head]):
            entries[head] = "model"
        return P(*entries)

    return _walk(rule, tree)


# ---------------------------------------------------------------------------
# Inputs
# ---------------------------------------------------------------------------

def input_sharding(mesh, arr_shape: Sequence[int]) -> P:
    """Batch-shard a model input with ``constrain.batch_axis``, the rule
    the model's own batch constraint uses."""
    if len(arr_shape) == 0:
        return P()
    entries: list[Any] = [None] * len(arr_shape)
    entries[0] = batch_axis(mesh, arr_shape[0])
    return P(*entries)


# ---------------------------------------------------------------------------
# Specs -> DTensor placements
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class NamedSharding:
    """A spec on a mesh (the port's counterpart of
    ``jax.sharding.NamedSharding``): ``placements`` are its DTensor
    placements, ``put`` makes a DTensor of a global value that every rank
    holds whole, each rank keeping its own shard (no collective)."""
    mesh: Any
    spec: PartitionSpec

    @property
    def placements(self) -> list:
        """One a mesh dim: Shard(d) where the spec puts that mesh axis on
        tensor dim d (alone or in a tuple, so ("pod", "data") shards one
        dim over both, pod-major), else Replicate()."""
        from repro_torch.dist.compat import Replicate, Shard
        axes = mesh_axes(self.mesh)
        out = [Replicate() for _ in axes]
        for d, entry in enumerate(self.spec):
            for n in (entry if isinstance(entry, tuple) else (entry,)):
                if n is not None:
                    out[axes.index(n)] = Shard(d)
        return out

    def local(self, value):
        """This rank's shard of the global ``value`` (a tensor or a numpy
        array): each sharded dim cut in equal parts, mesh dims in order."""
        coord = self.mesh.get_coordinate()
        sizes = list(mesh_sizes(self.mesh).values())
        for i, pl in enumerate(self.placements):
            if pl.is_shard():
                n = value.shape[pl.dim] // sizes[i]
                idx = [slice(None)] * len(value.shape)
                idx[pl.dim] = slice(coord[i] * n, (coord[i] + 1) * n)
                value = value[tuple(idx)]
        return value

    def put(self, value, device=None):
        """The DTensor of the global ``value`` on this sharding."""
        import numpy as np
        import torch

        from repro_torch.dist.compat import from_local
        dev = device if device is not None else torch.device(
            self.mesh.device_type, torch.cuda.current_device()
            if self.mesh.device_type == "cuda" else None)
        loc = self.local(value)
        if isinstance(loc, torch.Tensor):
            # a copy of this rank's shard alone: a slice along dim 0 is a
            # view, which would keep the whole global storage alive
            loc = loc.to(dev, copy=True,
                         memory_format=torch.contiguous_format)
        else:
            # a copy: ``value`` may be a read-only mapped checkpoint
            loc = torch.as_tensor(np.array(loc), device=dev)
        return from_local(loc, self.mesh, self.placements, value.shape)


def to_named(specs: Any, mesh) -> Any:
    """Map a PartitionSpec tree to NamedShardings on ``mesh``."""
    if isinstance(specs, PartitionSpec):
        return NamedSharding(mesh, specs)
    if isinstance(specs, dict):
        return {k: to_named(v, mesh) for k, v in specs.items()}
    if isinstance(specs, (list, tuple)):
        return type(specs)(to_named(v, mesh) for v in specs)
    return specs


def distribute(tree: Any, shardings: Any) -> Any:
    """Every tensor of ``tree`` as a DTensor placed by the matching
    NamedSharding of ``shardings``; every rank must hold the same global
    values (each keeps its shard, nothing is sent)."""
    if isinstance(tree, dict):
        return {k: distribute(v, shardings[k]) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(distribute(v, s)
                          for v, s in zip(tree, shardings, strict=True))
    if tree is None:
        return None
    return shardings.put(tree, tree.device)


def restack(specs: Any) -> Any:
    """A spec tree in the reference's layout, made by
    ``convert.reference_layout`` from the port's specs: each stacked leaf
    (the specs of one position of a layer group, equal by construction)
    becomes one spec with the stack dim leading and unsharded, as the
    reference's rule leaves it."""
    from repro_torch.convert import Stacked
    if isinstance(specs, Stacked):
        first = specs.parts[0]
        if any(p != first for p in specs.parts):
            raise ValueError(f"a layer group's specs differ: {specs.parts}")
        return P(None, *first)
    if isinstance(specs, dict):
        return {k: restack(v) for k, v in specs.items()}
    if isinstance(specs, (list, tuple)):
        return type(specs)(restack(v) for v in specs)
    return specs


# ---------------------------------------------------------------------------
# Fleet: rung shards (host-level sharding of the ladder)
# ---------------------------------------------------------------------------

def rung_shard(ladder_bits: Sequence[int], n_hosts: int
               ) -> dict[int, tuple[int, ...]]:
    """Assign ladder rungs to decode hosts, round-robin.

    The serving fleet's host-level rule (``serve_engine.fleet``): each
    decode host warms only its shard of the rung views, so the fleet's
    captured decode steps are flat in ladder depth x hosts rather than
    their product. Deterministic and total: every rung lands on at least
    one host and every host serves at least one rung; with more hosts than
    rungs the extra hosts replicate the ladder cyclically (capacity), with
    more rungs than hosts a host serves several rungs."""
    bits = sorted({int(b) for b in ladder_bits})
    if not bits or n_hosts <= 0:
        raise ValueError(f"need >=1 rung and >=1 host, got {bits!r} x "
                         f"{n_hosts}")
    shards: dict[int, set] = {h: set() for h in range(n_hosts)}
    for i in range(max(n_hosts, len(bits))):
        shards[i % n_hosts].add(bits[i % len(bits)])
    return {h: tuple(sorted(s)) for h, s in shards.items()}
