"""Serving-time weight quantization: one max-budget weight store with a
zero-copy view per ladder rung (port of ``repro.models.serving``'s
``build_weight_store`` path).

Each projection weight is quantized ONCE at the largest budget any rung
asks of it (PANN Eq. 12, per-output-channel gamma), stored as int8 codes
and, for the 'packed' backend, as bit-packed planes. Every rung is a view
that references the store's tensors and adds only small per-rung device
leaves: ``plane_shift`` (the low planes its kernels skip), the view's
``w_colsum``, the activation level counts, and the ``kv_cache`` level
counts. Weight memory is therefore independent of ladder depth.

Memory at full width: the store is built module by module. Planes are
decomposed and packed one plane at a time in uint8 (never as an int32
stack of all planes), and each fp32 weight is dropped from the params
dict as soon as it is quantized.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Mapping, Optional

import torch

from repro_torch.core import pann as pann_core
from repro_torch.core import policy as pol
from repro_torch.core import quant as quant_core
from repro_torch.core.unsigned import unsigned_split
from repro_torch.kernels.pann_matmul_packed import pack_planes

Tensor = torch.Tensor

# projection parents whose "w" is PANN-quantized for serving
_QUANT_PARENTS = {
    "wq", "wk", "wv", "wo", "w_gate", "w_up", "w_down", "in_proj",
    "out_proj", "wr", "wg", "decay_a", "decay_b", "lm_head",
}

# int8 codes are clipped to +-127 = 2^7 - 1, so 7 planes reconstruct every
# rung's codes and give every rung identical plane-leaf shapes.
LADDER_PLANE_COUNT = 7


def _is_quant_parent(node: dict, trail: tuple) -> bool:
    """Does this node hold a projection weight to quantize?"""
    if "w" not in node or getattr(node["w"], "ndim", 0) < 2:
        return False
    name = trail[-1] if trail else ""
    return name in _QUANT_PARENTS or "conv_stem" in trail


@dataclasses.dataclass(frozen=True)
class ServingQuantSpec:
    """The serving-quantizer knobs of a ladder build: ``pack_planes`` adds
    the 'packed' backend's plane leaves; ``cache_bits`` (an int or a
    {rung key: bits} mapping) attaches the rungs' KV-cache leaves. The JAX
    package's frozen-calibration knob comes with the training port."""
    pack_planes: bool = False
    cache_bits: Any = None


def _planes_artifact(codes: Tensor, plane_count: int) -> dict:
    """Bit-pack the unsigned split of int8 codes (K, N) into the 'packed'
    backend's uint8 leaves (P, ceil(K/8), N), one plane at a time."""
    out = {}
    k, n = codes.shape
    for key, half in zip(("w_planes_pos", "w_planes_neg"),
                         unsigned_split(codes)):
        packed = torch.empty((plane_count, -(-k // 8), n), dtype=torch.uint8,
                             device=codes.device)
        for p in range(plane_count):
            packed[p] = pack_planes((half >> p) & 1)
        out[key] = packed
    return out


def _full(value: float, device) -> Tensor:
    return torch.full((), float(value), dtype=torch.float32, device=device)


def _cache_artifact(cache_role_bits: dict, device) -> dict:
    """Per-rung KV-cache leaves: the level count of each cache role."""
    return {f"{prefix}_nlvl": _full(quant_core.cap_levels(
                cache_role_bits[role]), device)
            for role, prefix in zip(pol.CACHE_PATHS, ("k", "v"))}


def _act_leaves(ab: int, device) -> dict:
    """Per-rung activation-quantizer leaves for one projection at b~x=ab:
    the level count 2^b~x - 1 and its kernel-facing cap min(., 127)."""
    return {"act_n": _full((1 << int(ab)) - 1, device),
            "act_nlvl": _full(quant_core.cap_levels(int(ab)), device)}


@dataclasses.dataclass(frozen=True)
class WeightStore:
    """One quantized artifact serving a whole ladder: ``store`` holds the
    big leaves (codes, planes, gamma, biases, fp passthrough leaves), and
    ``views`` maps each rung key to a decode-ready tree that references the
    store's tensors and adds the rung's small leaves."""
    store: Any
    views: dict


def _resolve_point(spec, trail) -> tuple[float, Optional[int]]:
    """One rung spec (PolicyTree / (R, b~x) / bare R) -> (R, b~x) for the
    module at ``trail``."""
    if isinstance(spec, pol.PolicyTree):
        mq = spec.lookup(pol.serving_path(trail))
        return float(mq.r), int(mq.b_x_tilde)
    if isinstance(spec, tuple):
        r, ab = spec
        return float(r), (None if ab is None else int(ab))
    return float(spec), None


def _rung_cache_role_bits(spec, cb: Optional[int]) -> Optional[dict]:
    """Per-role cache bits of one rung: explicit PolicyTree overrides win,
    ``cb`` fills the rest; None when the rung keeps the fp cache."""
    policy_cache = pol.tree_cache_bits(spec) \
        if isinstance(spec, pol.PolicyTree) else {}
    if not policy_cache and cb is None:
        return None
    default_b = cb if cb is not None else max(policy_cache.values())
    return {role: int(policy_cache.get(role, default_b))
            for role in pol.CACHE_PATHS}


def build_weight_store(params: Any, cfg, r_by_rung: Mapping[Any, Any],
                       spec: Optional[ServingQuantSpec] = None
                       ) -> WeightStore:
    """Quantize once at each module's max budget over ``r_by_rung`` (rung
    key -> R, (R, b~x) or PolicyTree) and realize every rung as a view.
    The caller hands ``params`` over: each fp32 ``w`` is popped out of it
    once quantized, which at full width is what keeps the build under the
    card's memory."""
    spec = spec or ServingQuantSpec()
    cache_bits = spec.cache_bits
    keys = list(r_by_rung)
    if not keys:
        raise ValueError("r_by_rung must name at least one rung")
    if isinstance(cache_bits, Mapping):
        missing = set(keys) - set(cache_bits)
        if missing:
            raise ValueError(
                f"cache_bits mapping must cover every rung (missing "
                f"{sorted(missing)})")
    rung_cache = {}
    for key in keys:
        cb = (cache_bits.get(key) if isinstance(cache_bits, Mapping)
              else cache_bits)
        rung_cache[key] = _rung_cache_role_bits(
            r_by_rung[key], None if cb is None else int(cb))
    cached = [k for k in keys if rung_cache[k] is not None]
    if cached and len(cached) != len(keys):
        raise ValueError("kv_cache leaves must be all-or-none across rungs")

    def quantize(node: dict, trail: tuple):
        w = node.pop("w")
        dev = w.device
        points = {k: _resolve_point(r_by_rung[k], trail) for k in keys}
        r_max = max(r for r, _ in points.values())
        w_q, gamma = pann_core.pann_quantize(w.to(torch.float32), r_max,
                                             dim=w.ndim - 2)
        del w
        codes = torch.clamp(w_q, -127, 127).to(torch.int8)
        del w_q
        shared = {"w_q": codes, "w_scale": gamma}
        if spec.pack_planes:
            shared.update(_planes_artifact(codes, LADDER_PLANE_COUNT))
        if "b" in node:
            shared["b"] = node["b"]
        views = {}
        for k in keys:
            r_mod, ab = points[k]
            sh = pann_core.view_shift(r_max, r_mod, LADDER_PLANE_COUNT - 1)
            v = dict(shared)
            v["plane_shift"] = _full(sh, dev)
            # the view's zero-point row: colsum of the codes the
            # plane-skipping kernels realize, not the stored ones
            v["w_colsum"] = torch.sum(pann_core.masked_codes(codes, sh),
                                      dim=-2, dtype=torch.int32)
            if ab is not None:
                v.update(_act_leaves(ab, dev))
            views[k] = v
        return shared, views

    def walk(node, trail=()):
        """(store_node, {rung key: view_node}); passthrough leaves are the
        SAME tensor in the store and every view."""
        if isinstance(node, dict):
            if _is_quant_parent(node, trail):
                return quantize(node, trail)
            name = trail[-1] if trail else ""
            cache_parent = (cached and name in ("attn", "shared_attn")
                            and isinstance(node.get("wk"), dict))
            dev = None
            if cache_parent:
                dev = node["wk"]["w"].device
            pairs = {k2: walk(v, trail + (k2,)) for k2, v in node.items()}
            store_n = {k2: pr[0] for k2, pr in pairs.items()}
            view_n = {k: {k2: pr[1][k] for k2, pr in pairs.items()}
                      for k in keys}
            if cache_parent:
                for k in keys:
                    view_n[k]["kv_cache"] = _cache_artifact(rung_cache[k],
                                                            dev)
            return store_n, view_n
        if isinstance(node, (list, tuple)):
            pairs = [walk(v, trail) for v in node]
            return ([pr[0] for pr in pairs],
                    {k: [pr[1][k] for pr in pairs] for k in keys})
        return node, {k: node for k in keys}

    store, views = walk(params)
    return WeightStore(store=store, views=views)
