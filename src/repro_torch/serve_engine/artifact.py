"""The serving artifact: one weight store and its rung views on disk (port
of ``repro.serve_engine.artifact``; the same v1 format, so each package
reads what the other writes).

On-disk layout (one directory):

    manifest.json   — magic, version, per-leaf {dtype, shape, offset,
                      nbytes} records, and the per-rung view tables
    weights.bin     — every array back to back, 64-byte-aligned offsets

The artifact holds the JAX package's layout: the layers of each position
of the group pattern stacked along a leading group axis
(``decoder/groups/layers/#i/...``). Leaf paths are "/"-joined dict keys
with ``#i`` for list positions. View leaves that alias the store (codes,
planes, scales, norms, the embedding) are stored once and recorded as
``{"ref": <store path>}``. The manifest is written last and replaced
atomically, so a directory with a readable manifest is complete; a
truncated or doctored blob fails ``load_artifact`` with ``ArtifactError``.

Dtypes are recorded by name (numpy's ``dtype.name``). The port maps the
names to torch dtypes itself and reads a 2-byte float through its integer
bytes, so it does not need numpy to know ``bfloat16``.
"""
from __future__ import annotations

import json
import os
import tempfile
from typing import Any, Optional

import numpy as np
import torch

from repro_torch import convert
from repro_torch.models import model as MD
from repro_torch.models.serving import WeightStore

ARTIFACT_MAGIC = "repro-pann-weight-store"
ARTIFACT_VERSION = 1
MANIFEST = "manifest.json"
BLOB = "weights.bin"
_ALIGN = 64

# dtype name in the manifest -> (torch dtype, numpy dtype of its bytes)
_DTYPES = {
    "float32": (torch.float32, np.float32),
    "float64": (torch.float64, np.float64),
    "float16": (torch.float16, np.float16),
    "bfloat16": (torch.bfloat16, np.int16),
    "float8_e4m3fn": (torch.float8_e4m3fn, np.uint8),
    "float8_e5m2": (torch.float8_e5m2, np.uint8),
    "int8": (torch.int8, np.int8),
    "uint8": (torch.uint8, np.uint8),
    "int16": (torch.int16, np.int16),
    "int32": (torch.int32, np.int32),
    "int64": (torch.int64, np.int64),
    "bool": (torch.bool, np.bool_),
}
_NAMES = {t: name for name, (t, _) in _DTYPES.items()}


class ArtifactError(ValueError):
    """Unreadable, foreign-version, or corrupt serving artifact."""


def _flatten(tree: Any, prefix: str = "") -> list[tuple[str, Any]]:
    """(path, leaf) pairs, dict keys sorted, ``#i`` for list positions."""
    if isinstance(tree, dict):
        return [pair for k in sorted(tree)
                for pair in _flatten(tree[k], f"{prefix}{k}/")]
    if isinstance(tree, (list, tuple)):
        return [pair for i, v in enumerate(tree)
                for pair in _flatten(v, f"{prefix}#{i}/")]
    return [(prefix[:-1], tree)]


def _unflatten(flat: dict) -> Any:
    """Rebuild nested dicts/lists from "/"-joined paths (#i = list index)."""
    root: dict = {}
    for path, leaf in flat.items():
        parts = path.split("/")
        node = root
        for part in parts[:-1]:
            node = node.setdefault(part, {})
        node[parts[-1]] = leaf

    def listify(node):
        if isinstance(node, dict):
            if node and all(k.startswith("#") for k in node):
                return [listify(node[f"#{i}"]) for i in range(len(node))]
            return {k: listify(v) for k, v in node.items()}
        return node

    return listify(root)


def _parts(leaf) -> tuple:
    """The port tensors a leaf of the restacked tree is made of."""
    return leaf.parts if isinstance(leaf, convert.Stacked) else (leaf,)


def _host_bytes(t: torch.Tensor) -> bytes:
    t = t.detach().contiguous().cpu()
    if t.element_size() == 2 and t.is_floating_point():
        t = t.view(torch.int16)
    elif t.element_size() == 1 and t.is_floating_point():
        t = t.view(torch.uint8)
    return t.numpy().tobytes()


def write_artifact(directory: str, ws: WeightStore, cfg,
                   meta: Optional[dict] = None) -> str:
    """Persist a port weight store and its rung views in the JAX package's
    layout (``cfg``'s group pattern restacks the layers); returns the
    directory. Rung keys must be JSON scalars (the engine's are bit
    widths). The blob is written leaf by leaf, copied off the device one
    layer at a time, and the manifest last."""
    os.makedirs(directory, exist_ok=True)
    offset = 0
    blob = open(os.path.join(directory, BLOB), "wb")

    def add(leaf) -> dict:
        nonlocal offset
        parts = _parts(leaf)
        pad = -offset % _ALIGN
        blob.write(b"\0" * pad)
        offset += pad
        dtype = _NAMES.get(parts[0].dtype)
        if dtype is None:
            raise ArtifactError(f"no artifact dtype name for {parts[0].dtype}")
        ent = {"dtype": dtype, "shape": list(leaf.shape), "offset": offset,
               "nbytes": 0}
        for t in parts:
            data = _host_bytes(t)
            blob.write(data)
            ent["nbytes"] += len(data)
        offset += ent["nbytes"]
        return ent

    try:
        store_flat = _flatten(convert.reference_layout(ws.store, cfg))
        by_parts = {tuple(map(id, _parts(leaf))): path
                    for path, leaf in store_flat}
        store_entries = {path: add(leaf) for path, leaf in store_flat}
        views = []
        for key, view in ws.views.items():
            leaves = {}
            for path, leaf in _flatten(convert.reference_layout(view, cfg)):
                ref = by_parts.get(tuple(map(id, _parts(leaf))))
                leaves[path] = {"ref": ref} if ref is not None else add(leaf)
            views.append({"key": key, "leaves": leaves})
    finally:
        blob.close()

    manifest = {
        "magic": ARTIFACT_MAGIC,
        "version": ARTIFACT_VERSION,
        "blob": BLOB,
        "blob_bytes": offset,
        "store": store_entries,
        "views": views,
        "meta": meta or {},
    }
    fd, tmp = tempfile.mkstemp(dir=directory, suffix=".tmp")
    try:
        with os.fdopen(fd, "w") as f:
            json.dump(manifest, f, indent=1, sort_keys=True)
        os.replace(tmp, os.path.join(directory, MANIFEST))
    except BaseException:
        try:
            os.unlink(tmp)
        except OSError:
            pass
        raise
    return directory


def _read_manifest(directory: str) -> dict:
    try:
        with open(os.path.join(directory, MANIFEST)) as f:
            m = json.load(f)
    except OSError as e:
        raise ArtifactError(f"no readable {MANIFEST} in {directory}: {e}")
    except ValueError as e:
        raise ArtifactError(f"corrupt {MANIFEST} in {directory}: {e}")
    if m.get("magic") != ARTIFACT_MAGIC:
        raise ArtifactError(f"not a serving artifact: magic "
                            f"{m.get('magic')!r}")
    if m.get("version") != ARTIFACT_VERSION:
        raise ArtifactError(
            f"artifact version {m.get('version')!r} not supported by this "
            f"loader (wants {ARTIFACT_VERSION})")
    return m


def read_meta(directory: str) -> dict:
    """The manifest's metadata block (checks the magic and the version),
    with the reference's errors."""
    try:
        with open(os.path.join(directory, MANIFEST)) as f:
            m = json.load(f)
    except (OSError, ValueError) as e:
        raise ArtifactError(f"no readable {MANIFEST} in {directory}: {e}")
    if m.get("magic") != ARTIFACT_MAGIC or \
            m.get("version") != ARTIFACT_VERSION:
        raise ArtifactError("not a loadable serving artifact")
    return dict(m.get("meta", {}))


def load_artifact(directory: str, device="cuda") -> WeightStore:
    """Map ``weights.bin`` once and return the port's ``WeightStore`` on
    ``device``: every leaf is split into the port's per-layer layout
    (``convert.weight_store_from_reference``) and copied to the device
    once, and a view leaf marked ``ref`` is the store's own device tensor.
    On the CPU the leaves stay views into the (copy-on-write) mapping.
    Raises ``ArtifactError`` on a missing or corrupt manifest, a foreign
    version, or a blob whose size or leaf bounds disagree with the
    manifest."""
    device = MD.resolve_device(device)
    m = _read_manifest(directory)
    blob_path = os.path.join(directory, m.get("blob", BLOB))
    try:
        size = os.path.getsize(blob_path)
    except OSError as e:
        raise ArtifactError(f"missing blob {blob_path}: {e}")
    if size != m["blob_bytes"]:
        raise ArtifactError(
            f"blob size mismatch: {size} bytes on disk vs "
            f"{m['blob_bytes']} in the manifest (truncated artifact?)")
    mm = np.memmap(blob_path, dtype=np.uint8, mode="c") if size else \
        np.zeros(0, np.uint8)

    def leaf_of(path: str, ent: dict) -> torch.Tensor:
        off, n = int(ent["offset"]), int(ent["nbytes"])
        if off < 0 or off + n > mm.size:
            raise ArtifactError(
                f"leaf {path!r} spans [{off}, {off + n}) outside the "
                f"{mm.size}-byte blob")
        if ent["dtype"] not in _DTYPES:
            raise ArtifactError(f"leaf {path!r}: unknown dtype "
                                f"{ent['dtype']!r}")
        dtype, carrier = _DTYPES[ent["dtype"]]
        try:
            arr = mm[off:off + n].view(carrier).reshape(ent["shape"])
        except (TypeError, ValueError) as e:
            raise ArtifactError(f"leaf {path!r} unreadable: {e}")
        return torch.from_numpy(arr).view(dtype)

    store_leaves = {p: leaf_of(p, e) for p, e in m["store"].items()}
    views = {}
    for v in m["views"]:
        leaves = {}
        for p, e in v["leaves"].items():
            if "ref" in e:
                if e["ref"] not in store_leaves:
                    raise ArtifactError(
                        f"view leaf {p!r} refs unknown store path "
                        f"{e['ref']!r}")
                if e["ref"] != p:
                    # the port's views alias the store by path
                    raise ArtifactError(
                        f"view leaf {p!r} refs another path {e['ref']!r}")
                leaves[p] = store_leaves[e["ref"]]
            elif p in store_leaves:
                raise ArtifactError(
                    f"view leaf {p!r} shadows the store's leaf of that path")
            else:
                leaves[p] = leaf_of(p, e)
        views[v["key"]] = _unflatten(leaves)
    return convert.weight_store_from_reference(
        _unflatten(store_leaves), views, None, device)


__all__ = ["ArtifactError", "load_artifact", "write_artifact"]
