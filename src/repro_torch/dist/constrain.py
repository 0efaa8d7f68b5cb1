"""Mesh-aware sharding constraints (port of ``repro.dist.constrain``).

Model code calls these unconditionally; they only act when

  * a mesh is active (``with use_mesh(mesh):``, the port's counterpart of
    the reference's ``with mesh:``),
  * the tensor is a DTensor on it,
  * the named mesh axis exists and has size > 1, and
  * the constrained dimension is divisible by the axis size,

so the same forward runs unchanged on one device and over a mesh. A
constraint on a DTensor is a ``redistribute``: the mesh axes the plan
names shard their dims, and the axes it leaves out keep their placement
(JAX's unconstrained dims), so a head constraint never gathers the batch.

Axis names map to mesh dims by name; a tuple such as ("pod", "data")
means the product of those dims. The functions read only the mesh's axis
names and sizes (``mesh_axes``, ``_axis_size``), so an abstract stand-in
with ``axis_names`` and a ``shape`` mapping works in place of a
``DeviceMesh``.
"""
from __future__ import annotations

import contextlib
import contextvars
from typing import Union

Axis = Union[str, tuple, None]

_MESH: contextvars.ContextVar = contextvars.ContextVar("repro_torch_mesh",
                                                       default=None)


@contextlib.contextmanager
def use_mesh(mesh):
    """Make ``mesh`` the ambient mesh of the enclosed scope."""
    token = _MESH.set(mesh)
    try:
        yield mesh
    finally:
        _MESH.reset(token)


def _context_mesh():
    """The ambient mesh installed by ``use_mesh``, or None outside one."""
    return _MESH.get()


def mesh_axes(mesh) -> tuple:
    """The mesh's axis names, in mesh order."""
    names = getattr(mesh, "mesh_dim_names", None)
    return tuple(names if names is not None else mesh.axis_names)


def mesh_sizes(mesh) -> dict:
    """{axis name: size}: a DeviceMesh's ``shape`` is a tuple, a
    stand-in's a mapping."""
    shape = mesh.shape
    if isinstance(shape, dict):
        return dict(shape)
    return dict(zip(mesh_axes(mesh), tuple(shape)))


def _axis_size(mesh, name: Axis) -> int:
    """Product of mesh-axis sizes for a (possibly tuple) assignment; 0 when
    any named axis is missing from the mesh."""
    names = name if isinstance(name, tuple) else (name,)
    size = 1
    shape = mesh_sizes(mesh)
    for n in names:
        if n not in shape:
            return 0
        size *= shape[n]
    return size


def _ok(mesh, name: Axis, dim: int) -> bool:
    size = _axis_size(mesh, name)
    return size > 1 and dim % size == 0


def _is_dtensor(x) -> bool:
    from repro_torch.dist.compat import DTensor
    return isinstance(x, DTensor)


def constrain_spec(x, plan: dict):
    """Constrain ``x`` per ``plan`` ({dim index -> mesh axis name | None}).

    Dims not in the plan, and plan entries that fail the divisibility /
    existence checks, stay unconstrained; an empty plan, a plain tensor or
    no active mesh return ``x`` itself."""
    mesh = _context_mesh()
    if mesh is None or not _is_dtensor(x):
        return x
    entries: list[Axis] = [None] * x.ndim
    for d, name in plan.items():
        if name is None:
            continue
        d = d % x.ndim
        if _ok(mesh, name, x.shape[d]):
            entries[d] = name
    return _place(x, entries)


def _place(x, entries: list):
    """Redistribute the DTensor ``x`` so each mesh axis named in
    ``entries`` (one a dim: a name, a tuple of names or None) shards that
    dim; the axes not named keep their placement."""
    if all(e is None for e in entries):
        return x
    from repro_torch.dist.compat import Shard
    axes = mesh_axes(x.device_mesh)
    place = list(x.placements)
    for d, entry in enumerate(entries):
        for n in (entry if isinstance(entry, tuple) else (entry,)):
            if n is not None:
                place[axes.index(n)] = Shard(d)
    if tuple(place) == tuple(x.placements):
        return x
    return x.redistribute(x.device_mesh, place)


def constrain_axis(x, axis: int, name: str = "model"):
    """Constrain one dimension of ``x`` to a mesh axis (default TP)."""
    return constrain_spec(x, {axis: name})


def batch_axis(mesh, dim: int) -> Axis:
    """The data-parallel assignment for a global-batch dim: the first of
    ("pod", "data") combined, "data", "pod" that divides it, else None.
    The one definition of both the in-model constraint
    (``constrain_batch``) and the input placement
    (``sharding.input_sharding``)."""
    for cand in (("pod", "data"), "data", "pod"):
        if _ok(mesh, cand, dim):
            return cand
    return None


def constrain_batch(x):
    """Constrain the leading (batch) dim over the data-parallel axes,
    combining ("pod", "data") on multi-pod meshes when divisibility
    allows."""
    mesh = _context_mesh()
    if mesh is None:
        return x
    ax = batch_axis(mesh, x.shape[0])
    return constrain_spec(x, {0: ax}) if ax is not None else x


def dp_model_plan(batch: int, seq: int) -> tuple[Axis, Axis]:
    """The sequence-parallel decode layout: (batch axis, seq axis).

    Batch goes to "data"; the cached sequence dim goes to "model". When
    batch can't use "data" the sequence falls back to "data", so the cache
    is still distributed. (None, None) when no mesh is active."""
    mesh = _context_mesh()
    if mesh is None:
        return None, None
    batch_ax: Axis = "data" if _ok(mesh, "data", batch) else None
    if _ok(mesh, "model", seq):
        seq_ax: Axis = "model"
    elif batch_ax is None and _ok(mesh, "data", seq):
        seq_ax = "data"
    else:
        seq_ax = None
    return batch_ax, seq_ax


def split_heads(x, heads: int, head_dim: int):
    """``x`` (..., heads * head_dim) viewed as (..., heads, head_dim). A
    DTensor whose last dim is sharded over a mesh axis that does not divide
    ``heads`` (16 "model" ranks over 8 KV heads, or over a reduced
    config's 4 heads) is first gathered along that axis, so every rank
    holds whole heads: the view cannot split a head across ranks."""
    if _is_dtensor(x):
        from repro_torch.dist.compat import Replicate
        sizes = list(mesh_sizes(x.device_mesh).values())
        place = [Replicate() if p.is_shard() and p.dim % x.ndim == x.ndim - 1
                 and heads % sizes[i] else p
                 for i, p in enumerate(x.placements)]
        if tuple(place) != tuple(x.placements):
            x = x.redistribute(x.device_mesh, place)
    return x.reshape(*x.shape[:-1], heads, head_dim)
