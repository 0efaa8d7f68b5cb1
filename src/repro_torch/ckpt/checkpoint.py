"""Checkpoints with atomic commits, keep-k retention and resume (port of
``repro.ckpt.checkpoint``), in the reference's format, so either package
restores what the other wrote.

Layout:
    <dir>/step_000123/arrays.npz   — {key: array}, one .npy member a leaf
    <dir>/step_000123/meta.json    — step, config name, user metadata
    <dir>/step_000123/COMMITTED    — written last; partial dirs are ignored

Keys are the "/"-joined path of a leaf in the tree: dict keys, ``#i`` for
list positions, field names for NamedTuples. The trainer hands ``save`` its
state in the JAX package's layout (``convert.train_state_to_reference``:
the layers of each repeating group stacked along a leading axis), so the
keys are the reference's: ``params/...``, ``opt/mu/...``, ``opt/nu/...``,
``opt/count``, ``step`` and ``calib/<path>``. A stacked leaf
(``convert.Stacked``) is written part by part into its member, each part
copied off the device on its own, so no stacked copy is ever made.

``restore`` returns numpy arrays on the host in the template's structure
and reads only the keys the template has: a template without the
optimizer state (``opt=None``) leaves the moments on disk. A member
stored uncompressed (``np.savez`` and ``save`` both store) is mapped
read-only from the file rather than read through ``zipfile``.

Under a mesh a leaf may be a DTensor: ``save`` gathers each one on every
rank in turn (a collective) and rank 0 writes the file, in the same
format. ``restore(..., shardings=)`` is the elastic path: each leaf with
a ``dist.sharding.NamedSharding`` becomes a DTensor on that sharding's
mesh, each rank reading only its shard off the mapped file, so a
checkpoint saved on one mesh restores onto a mesh of another shape.
"""
from __future__ import annotations

import json
import os
import shutil
import struct
import tempfile
import zipfile
from typing import Any, Optional

import numpy as np
import torch
import torch.distributed as dist

from repro_torch.dist import compat

ARRAYS = "arrays.npz"


def _parts(leaf) -> tuple:
    """The arrays a leaf's bytes are made of, in order."""
    parts = getattr(leaf, "parts", None)
    return tuple(parts) if parts is not None else (leaf,)


def _host(a) -> np.ndarray:
    if compat.is_dtensor(a):
        a = a.full_tensor()
    if isinstance(a, torch.Tensor):
        return a.detach().contiguous().cpu().numpy()
    return np.ascontiguousarray(np.asarray(a))


def _dtype(leaf) -> np.dtype:
    first = _parts(leaf)[0]
    if isinstance(first, torch.Tensor):
        return np.dtype(str(first.dtype).removeprefix("torch."))
    return np.asarray(first).dtype


def flatten(tree: Any, prefix: str = "") -> list[tuple[str, Any]]:
    """(key, leaf) pairs of a nested dict / list / NamedTuple; None is an
    empty subtree, as in a JAX pytree."""
    if tree is None:
        return []
    if isinstance(tree, dict):
        return [pair for k in sorted(tree)
                for pair in flatten(tree[k], f"{prefix}{k}/")]
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return [pair for k in tree._fields
                for pair in flatten(getattr(tree, k), f"{prefix}{k}/")]
    if isinstance(tree, (list, tuple)):
        return [pair for i, v in enumerate(tree)
                for pair in flatten(v, f"{prefix}#{i}/")]
    return [(prefix[:-1], tree)]


def _write_npz(path: str, pairs: list) -> None:
    """``np.savez``'s format, written member by member and part by part."""
    with zipfile.ZipFile(path, mode="w", compression=zipfile.ZIP_STORED,
                         allowZip64=True) as zf:
        for key, leaf in pairs:
            shape = tuple(int(d) for d in leaf.shape)
            header = {"descr": np.lib.format.dtype_to_descr(_dtype(leaf)),
                      "fortran_order": False, "shape": shape}
            with zf.open(key + ".npy", "w", force_zip64=True) as f:
                np.lib.format.write_array_header_1_0(f, header)
                for part in _parts(leaf):
                    arr = _host(part)
                    if arr.size:
                        f.write(memoryview(arr.reshape(-1)).cast("B"))


def _may_fallback(key: str, strict) -> bool:
    """strict=True: no leaf may be missing; strict=False: any may; a tuple
    of key prefixes: only those subtrees may (everything else still
    raises, so a truncated checkpoint never passes for a resumable one)."""
    if strict is True:
        return False
    if strict is False:
        return True
    return any(key.startswith(p) for p in strict)


def _rebuild(template: Any, values: dict, prefix: str = "") -> Any:
    """``template``'s structure with ``values`` (by key) for its leaves."""
    if template is None:
        return None
    if isinstance(template, dict):
        return {k: _rebuild(v, values, f"{prefix}{k}/")
                for k, v in template.items()}
    if isinstance(template, tuple) and hasattr(template, "_fields"):
        return type(template)(*(_rebuild(getattr(template, k), values,
                                         f"{prefix}{k}/")
                                for k in template._fields))
    if isinstance(template, (list, tuple)):
        return [_rebuild(v, values, f"{prefix}#{i}/")
                for i, v in enumerate(template)]
    return values[prefix[:-1]]


def _mapped_members(path: str) -> dict:
    """{key: read-only np.memmap} of every uncompressed, non-empty .npy
    member of an .npz (the local header's name and extra fields skipped,
    the .npy header parsed); members it cannot map are left out."""
    out = {}
    with zipfile.ZipFile(path) as zf, open(path, "rb") as f:
        for info in zf.infolist():
            if info.compress_type != zipfile.ZIP_STORED or \
                    not info.filename.endswith(".npy"):
                continue
            f.seek(info.header_offset)
            local = f.read(30)
            n_name, n_extra = struct.unpack("<HH", local[26:30])
            f.seek(info.header_offset + 30 + n_name + n_extra)
            version = np.lib.format.read_magic(f)
            if version == (1, 0):
                shape, fortran, dtype = np.lib.format.read_array_header_1_0(f)
            elif version == (2, 0):
                shape, fortran, dtype = np.lib.format.read_array_header_2_0(f)
            else:
                continue
            if dtype.hasobject or not int(np.prod(shape)):
                continue
            out[info.filename[:-4]] = np.memmap(
                path, dtype=dtype, mode="r", offset=f.tell(), shape=shape,
                order="F" if fortran else "C")
    return out


def _template_value(leaf) -> np.ndarray:
    """A template leaf kept as the restored value (its init)."""
    if isinstance(leaf, torch.Tensor):
        return leaf.detach().cpu().numpy()
    return np.asarray(leaf)


def _sharded(pairs: list) -> bool:
    return any(compat.is_dtensor(p) for _, leaf in pairs
               for p in _parts(leaf))


def save(directory: str, step: int, tree: Any, *,
         meta: Optional[dict] = None, keep: int = 3) -> str:
    """Atomically write a checkpoint (temporary directory, ``COMMITTED``,
    rename); prune to the newest ``keep``. Returns its directory. With
    DTensor leaves every rank of the mesh calls it: each leaf is gathered
    in key order, rank 0 writes, and the ranks meet at a barrier."""
    final = os.path.join(directory, f"step_{step:08d}")
    pairs = flatten(tree)
    if _sharded(pairs) and dist.get_rank() != 0:
        for _, leaf in pairs:
            for part in _parts(leaf):
                if compat.is_dtensor(part):
                    part.full_tensor()
        dist.barrier()
        return final
    path = _save(directory, final, pairs, meta, step, keep)
    if _sharded(pairs):
        dist.barrier()
    return path


def _save(directory: str, final: str, pairs: list, meta, step: int,
          keep: int) -> str:
    os.makedirs(directory, exist_ok=True)
    tmp = tempfile.mkdtemp(dir=directory, prefix=".tmp_ckpt_")
    try:
        _write_npz(os.path.join(tmp, ARRAYS), pairs)
        with open(os.path.join(tmp, "meta.json"), "w") as f:
            json.dump({"step": step, **(meta or {})}, f)
        with open(os.path.join(tmp, "COMMITTED"), "w") as f:
            f.write("ok")
        if os.path.exists(final):
            shutil.rmtree(final)
        os.rename(tmp, final)
    except BaseException:
        shutil.rmtree(tmp, ignore_errors=True)
        raise
    _prune(directory, keep)
    return final


def _prune(directory: str, keep: int) -> None:
    steps = sorted(all_steps(directory))
    for s in steps[:-keep] if keep > 0 else []:
        shutil.rmtree(os.path.join(directory, f"step_{s:08d}"),
                      ignore_errors=True)


def all_steps(directory: str) -> list[int]:
    if not os.path.isdir(directory):
        return []
    out = []
    for name in os.listdir(directory):
        if name.startswith("step_") and os.path.exists(
                os.path.join(directory, name, "COMMITTED")):
            out.append(int(name.split("_")[1]))
    return sorted(out)


def latest_step(directory: str) -> Optional[int]:
    steps = all_steps(directory)
    return steps[-1] if steps else None


def restore(directory: str, step: int, template: Any,
            shardings: Optional[Any] = None, strict=True) -> Any:
    """Restore into ``template``'s structure (any tree whose leaves have a
    ``.shape``: tensors, meta tensors, numpy arrays, ``convert.Stacked``)
    as numpy arrays. ``shardings``, a tree of the template's structure
    whose leaves are ``dist.sharding.NamedSharding`` or None, puts each
    leaf that has one onto its mesh as a DTensor (this rank's shard only);
    the saving and restoring meshes may differ. ``strict`` may be a tuple
    of key prefixes (e.g. ``("calib/",)``) naming the only subtrees
    allowed to keep the template's value when the checkpoint lacks them;
    False allows any (logged), True (the default) none."""
    path = os.path.join(directory, f"step_{step:08d}")
    if not os.path.exists(os.path.join(path, "COMMITTED")):
        raise FileNotFoundError(f"no committed checkpoint at {path}")
    values = {}
    fellback = []
    npz = os.path.join(path, ARRAYS)
    mapped = _mapped_members(npz)
    with np.load(npz) as z:
        have = set(z.files)
        for key, leaf in flatten(template):
            if key not in have:
                if _may_fallback(key, strict):
                    # a state collection added after the checkpoint was
                    # written keeps its template init
                    fellback.append(key)
                    values[key] = _template_value(leaf)
                    continue
                raise KeyError(f"checkpoint missing leaf {key!r}")
            arr = mapped[key] if key in mapped else z[key]
            if tuple(arr.shape) != tuple(leaf.shape):
                raise ValueError(f"shape mismatch for {key}: ckpt "
                                 f"{arr.shape} vs template {tuple(leaf.shape)}")
            values[key] = arr
        if shardings is not None:
            placed = dict(flatten(shardings))
            for key, sh in placed.items():
                if sh is not None and key in values:
                    values[key] = sh.put(values[key])
    if fellback:
        print(f"[ckpt] {len(fellback)} leaves absent from the checkpoint "
              f"kept their template init: {fellback[:8]}"
              + (" ..." if len(fellback) > 8 else ""))
    return _rebuild(template, values)


def read_meta(directory: str, step: int) -> dict:
    with open(os.path.join(directory, f"step_{step:08d}", "meta.json")) as f:
        return json.load(f)
