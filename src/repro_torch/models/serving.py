"""Serving-time weight quantization (port of ``repro.models.serving``):
the single-point artifact (``quantize_params_for_serving``), one such
artifact per rung (``build_variant_cache``), one max-budget weight store
with a zero-copy view per ladder rung (``build_weight_store``), and a
view copied out as a standalone variant (``materialize_view``).

Each projection weight is quantized with PANN Eq. 12 (per-output-channel
gamma) and stored as int8 codes and, for the 'packed' backend, as
bit-packed planes. A single-point artifact packs each module at its
value-exact plane count. A weight store quantizes each module ONCE at the
largest budget any rung asks of it, packs 7 planes, and realizes every
rung as a view that references the store's tensors and adds only small
per-rung device leaves: ``plane_shift`` (the low planes its kernels
skip), the view's ``w_colsum``, the activation level counts, and the
``kv_cache`` level counts. Weight memory is therefore independent of
ladder depth.

Memory at full width: both builders go module by module. Planes are
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
from repro_torch.models import transformer as T

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
    """Every serving-quantizer knob in one object. ``policy`` or ``r`` +
    ``act_bits`` pick a single-point artifact's operating point (a ladder
    build takes its points from the rung specs and refuses these three);
    the codes are always int8. ``pack_planes`` adds the 'packed' backend's
    plane leaves, at
    ``plane_count`` planes (None: each module's value-exact count in a
    single-point artifact; a ladder store packs 7 and refuses another
    count); ``cache_bits`` (an int,
    or a {rung key: bits} mapping for a ladder) attaches the KV-cache
    leaves. ``calib`` (an EMA activation-range collection of calibrated
    training, ``core.calibrate``) freezes each seen projection role's
    range into ``act_lo``/``act_hi`` and its (s, z) into ``act_s``/``act_z``,
    and each seen cache role's (s, z) into the ``kv_cache`` leaves
    ``k_s``/``k_z``/``v_s``/``v_z``; unseen roles keep the dynamic range."""
    policy: Optional[pol.PolicyTree] = None
    r: Optional[float] = None
    act_bits: Optional[int] = None
    pack_planes: bool = False
    plane_count: Optional[int] = None
    calib: Optional[Mapping[str, Any]] = None
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


def _frozen_scale_zp(rng, n_lvl: float, device) -> tuple[Tensor, Tensor]:
    """(s, z) of a frozen range [lo, hi]: zero-extended, then
    ``affine_scale_zp`` at ``n_lvl`` levels, the reference's fp32 op
    sequence (the one the serve-time derivation runs)."""
    lo = torch.clamp(_full(rng[0], device), max=0.0)
    hi = torch.clamp(_full(rng[1], device), min=0.0)
    return quant_core.affine_scale_zp(lo, hi, _full(n_lvl, device))


def _seen_range(calib, role: str):
    """The [lo, hi] floats of a seen role of ``calib``, else None."""
    rng = calib.get(role) if calib else None
    if rng is None:
        return None
    lo, hi = (float(v) for v in rng)
    return (lo, hi) if lo <= hi else None


def _cache_artifact(cache_role_bits: dict, device, calib=None) -> dict:
    """Per-rung KV-cache leaves: the level count of each cache role and,
    when ``calib`` saw the role, its frozen quantizer scalars."""
    out = {}
    for role, prefix in zip(pol.CACHE_PATHS, ("k", "v")):
        n_lvl = quant_core.cap_levels(cache_role_bits[role])
        out[f"{prefix}_nlvl"] = _full(n_lvl, device)
        rng = _seen_range(calib, role)
        if rng is not None:
            s, z = _frozen_scale_zp(rng, n_lvl, device)
            out[f"{prefix}_s"], out[f"{prefix}_z"] = s, z
    return out


def _act_leaves(ab: int, device, trail: tuple = (), calib=None) -> dict:
    """Per-rung activation-quantizer leaves for one projection at b~x=ab:
    the level count 2^b~x - 1 and its kernel-facing cap min(., 127); when
    ``calib`` saw the module's role, its frozen range ``act_lo``/``act_hi``
    and the (s, z) derived from it at the cap, ``act_s``/``act_z``."""
    out = {"act_n": _full((1 << int(ab)) - 1, device),
           "act_nlvl": _full(quant_core.cap_levels(int(ab)), device)}
    rng = _seen_range(calib, pol.serving_path(trail))
    if rng is not None:
        out["act_lo"] = _full(rng[0], device)
        out["act_hi"] = _full(rng[1], device)
        out["act_s"], out["act_z"] = _frozen_scale_zp(
            rng, quant_core.cap_levels(int(ab)), device)
    return out


def _host_calib(calib):
    """A collection's ranges as host floats (None without one)."""
    if not calib:
        return None
    return {k: [float(v) for v in (t.detach().cpu().tolist()
                                   if isinstance(t, Tensor) else t)]
            for k, t in calib.items()}


def _cache_role_bits(policy, cache_bits) -> Optional[dict]:
    """Per-role cache bits: the policy's explicit cache-role overrides win,
    ``cache_bits`` fills the rest; None keeps the fp cache."""
    policy_cache = pol.tree_cache_bits(policy) if policy is not None else {}
    if not policy_cache and cache_bits is None:
        return None
    default_b = cache_bits if cache_bits is not None else max(
        policy_cache.values())
    return {role: int(policy_cache.get(role, default_b))
            for role in pol.CACHE_PATHS}


def quantize_params_for_serving(params: Any, cfg,
                                spec: ServingQuantSpec) -> Any:
    """The single-point serving artifact: every projection {"w"} becomes
    {"w_q", "w_scale", "w_colsum"[, "w_planes_pos", "w_planes_neg"]
    [, "act_n", "act_nlvl"][, "b"]} at the point of ``spec``: ``r`` and
    ``act_bits`` (b~x; None keeps the activations in the compute dtype
    on the float-dequant path) or each module's own point from
    ``policy``. The embedding table stays fp32. ``pack_planes`` packs
    ``plane_count`` planes, or each module's value-exact
    ``weight_storage_bits`` taken, as the reference takes it, over the
    module's codes stacked across the layer groups of ``cfg``; codes are
    clipped to the planes' +-(2^P - 1) so ``w_q`` and the planes describe
    the same weights (an encoder's layers are a stack of their own, a
    conv-stem layer stands alone). The MoE router and the stacked experts
    are no projection parents here (as in the reference) and pass through
    in fp32, the very tensors handed in. ``cache_bits`` (or a policy's
    cache-role overrides) attaches a ``kv_cache`` dict of level counts to
    every attention block. There is no ``plane_shift`` leaf: the kernels
    run at shift 0.

    The caller hands ``params`` over: each fp32 ``w`` is popped out of it
    once quantized."""
    policy, act_bits = spec.policy, spec.act_bits
    if spec.calib and act_bits is None and policy is None:
        raise ValueError(
            "freezing calibrated ranges needs an activation bit width: "
            "pass act_bits= or a policy= tree")
    calib = _host_calib(spec.calib)
    r = spec.r if spec.r is not None else cfg.quant.r
    role_bits = _cache_role_bits(policy, spec.cache_bits)
    # the reference stacks layer i of every group of a stack (the decoder's
    # "layers", an encoder's) along one axis; tail layers stand alone
    stacks = {("layers",): T.group_layout(cfg)}
    if cfg.encoder_layers:
        stacks[("encoder", "layers")] = T.group_layout(
            cfg, cfg.encoder_layers, "encoder")
    modules = []        # (artifact node, stack key) in walk order
    peak: dict = {}     # stack key -> max |code| over the stack

    def quantize(node: dict, trail: tuple, stack) -> dict:
        w = node.pop("w")
        if policy is not None:
            mq = policy.lookup(pol.serving_path(trail))
            r_mod, ab = mq.r, mq.b_x_tilde
        else:
            r_mod, ab = r, act_bits
        w_q, gamma = pann_core.pann_quantize(w.to(torch.float32),
                                             float(r_mod), dim=w.ndim - 2)
        dev = w.device
        del w
        codes = torch.clamp(w_q, -127, 127).to(torch.int8)
        del w_q
        key = (stack, trail)
        m = torch.amax(torch.abs(codes))
        peak[key] = m if key not in peak else torch.maximum(peak[key], m)
        out = {"w_q": codes, "w_scale": gamma.to(torch.float32)}
        if ab is not None:
            out.update(_act_leaves(ab, dev, trail, calib))
        if "b" in node:
            out["b"] = node["b"]
        modules.append((out, key))
        return out

    def walk(node, trail=(), stack=None):
        if isinstance(node, dict):
            if _is_quant_parent(node, trail):
                return quantize(node, trail, stack)
            name = trail[-1] if trail else ""
            wk = node.get("wk")
            cache_dev = (wk["w"].device if role_bits is not None
                         and name in ("attn", "shared_attn")
                         and isinstance(wk, dict) and "w" in wk else None)
            out = {k: walk(v, trail + (k,), stack) for k, v in node.items()}
            if cache_dev is not None:
                out["kv_cache"] = _cache_artifact(role_bits, cache_dev,
                                                  calib)
            return out
        if isinstance(node, (list, tuple)):
            if trail in stacks:
                pattern, n_groups, _ = stacks[trail]
                grouped = n_groups * len(pattern)
                return [walk(v, trail, ("group", i % len(pattern))
                             if i < grouped else ("tail", i))
                        for i, v in enumerate(node)]
            return [walk(v, trail, stack) for v in node]
        return node

    out = walk(params)
    for node, key in modules:
        codes = node.pop("w_q")
        rest = {k: node.pop(k) for k in list(node) if k != "w_scale"}
        if spec.pack_planes:
            p_cnt = (spec.plane_count if spec.plane_count is not None
                     else pann_core.weight_storage_bits(peak[key]))
            cap = (1 << min(int(p_cnt), 7)) - 1
            codes = torch.clamp(codes, -cap, cap)
        node["w_q"] = codes
        node["w_scale"] = node.pop("w_scale")
        node["w_colsum"] = torch.sum(codes, dim=-2, dtype=torch.int32)
        if spec.pack_planes:
            node.update(_planes_artifact(codes, int(p_cnt)))
        node.update(rest)
    # the recursive ``walk`` closure is a reference cycle that holds
    # ``modules``: emptied here, the artifact is freed with its last
    # caller reference, not at the next cyclic collection
    modules.clear()
    return out


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


def build_weight_store(params: Any, cfg, r_by_rung: Mapping[Any, Any],
                       spec: Optional[ServingQuantSpec] = None, *,
                       mesh=None, par=None) -> WeightStore:
    """Quantize once at each module's max budget over ``r_by_rung`` (rung
    key -> R, (R, b~x) or PolicyTree) and realize every rung as a view.
    The caller hands ``params`` over: each fp32 ``w`` is popped out of it
    once quantized, which at full width is what keeps the build under the
    card's memory. With ``mesh`` the store is quantized on the whole
    weights (gamma sums over all of K) and then placed once
    (``device_put_weight_store``)."""
    spec = spec or ServingQuantSpec()
    calib = _host_calib(spec.calib)
    unused = [f for f in ("policy", "r", "act_bits", "plane_count")
              if getattr(spec, f) is not None]
    if unused:
        raise ValueError(
            f"build_weight_store takes each rung's point from r_by_rung and "
            f"packs {LADDER_PLANE_COUNT} planes; the spec's {unused} would "
            f"be ignored")
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
        spec_k = r_by_rung[key]
        rung_cache[key] = _cache_role_bits(
            spec_k if isinstance(spec_k, pol.PolicyTree) else None,
            None if cb is None else int(cb))
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
                v.update(_act_leaves(ab, dev, trail, calib))
            views[k] = v
        return shared, views

    def walk(node, trail=()):
        """(store_node, {rung key: view_node}); passthrough leaves (norms,
        the embedding, the MoE router and experts) are the SAME tensor in
        the store and every view."""
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
                                                            dev, calib)
            return store_n, view_n
        if isinstance(node, (list, tuple)):
            pairs = [walk(v, trail) for v in node]
            return ([pr[0] for pr in pairs],
                    {k: [pr[1][k] for pr in pairs] for k in keys})
        return node, {k: node for k in keys}

    store, views = walk(params)
    if mesh is not None:
        return device_put_weight_store(WeightStore(store=store, views=views),
                                       mesh, par)
    return WeightStore(store=store, views=views)


# ---------------------------------------------------------------------------
# A store on a serving mesh
# ---------------------------------------------------------------------------

# the leaves of a projection with one entry per output column
_COLUMN_LEAVES = ("w_scale", "w_colsum", "b")


def serving_shardings(tree: Any, mesh, par=None) -> Any:
    """NamedShardings of a store or rung view on a serving mesh: the
    training params' rules (``variant_shardings``), and a column-parallel
    projection's per-column leaves (``w_scale``, ``w_colsum``, ``b``)
    sharded with its columns, where ``param_specs`` replicates them. A
    rank then holds exactly the leaves of its own columns, so the local
    decode (``dist.local_ops``) reads a whole projection of N / model
    columns, and the replicated bytes are the norms and the scalars
    alone.

    Two deviations from ``param_specs``, both in a MoE block, so that a
    mesh step equals one rank's bit for bit: the router (d, E) stays whole
    on every rank (``param_specs`` splits it over E: a column slice of an
    fp32 cuBLAS product need not equal the same columns of the whole
    product; d x E fp32 is 131 KB a layer for mixtral-8x7b), and the
    expert stacks (E, d, ff), (E, ff, d) are split over "model" by expert
    (``param_specs`` splits d_ff: an fp32 sum of d_ff partials over ranks
    is not one rank's cuBLAS order), where the axis divides E; else they
    keep ``param_specs``' d_ff split (``models.mlp.apply_moe``)."""
    from repro_torch.configs.base import ParallelConfig
    from repro_torch.dist import sharding as SH
    from repro_torch.dist.constrain import _ok
    specs = SH.param_specs(tree, mesh, par or ParallelConfig())

    def moe(block, spec):
        out = {}
        for k, v in block.items():
            if k == "router":
                out[k] = {n: SH.P(*[None] * w.ndim) for n, w in v.items()}
            elif _ok(mesh, "model", v.shape[0]):
                out[k] = SH.P("model", *[None] * (v.ndim - 1))
            else:
                out[k] = spec[k]
        return out

    def walk(node, spec):
        if isinstance(node, dict):
            out = {k: moe(v, spec[k]) if k == "moe" else walk(v, spec[k])
                   for k, v in node.items()}
            if "w_q" in node and spec["w_q"][-1] == "model":
                for k in _COLUMN_LEAVES:
                    if k in node:       # its last dim runs over the columns
                        out[k] = SH.P(*[None] * (node[k].ndim - 1),
                                      "model")
            return out
        if isinstance(node, (list, tuple)):
            return type(node)(walk(v, sp) for v, sp in zip(node, spec))
        return spec

    return SH.to_named(walk(tree, specs), mesh)


def device_put_weight_store(ws: WeightStore, mesh=None,
                            par=None) -> WeightStore:
    """Place a weight store on a serving mesh, keeping the store / view
    aliasing: each store leaf becomes ONE DTensor (``serving_shardings``;
    every rank keeps a copy of its own shard, so no view of the whole
    tensor stays alive), view leaves that alias a store leaf resolve to
    that same DTensor, and only the small per-rung leaves are placed on
    their own. Every rank passes the same whole store (quantized once on
    the whole weights). Without a mesh the store is returned as it is: the
    port builds and loads stores on their device."""
    if mesh is None:
        return ws
    from repro_torch.dist import sharding as SH
    placed = SH.distribute(ws.store, serving_shardings(ws.store, mesh, par))
    relink = {}

    def link(src, dst):
        if isinstance(src, dict):
            for k in src:
                link(src[k], dst[k])
        elif isinstance(src, (list, tuple)):
            for a, b in zip(src, dst):
                link(a, b)
        elif src is not None:
            relink[id(src)] = dst

    link(ws.store, placed)

    def put(node, sharding):
        if isinstance(node, dict):
            return {k: put(v, sharding[k]) for k, v in node.items()}
        if isinstance(node, (list, tuple)):
            return type(node)(put(v, sh) for v, sh in zip(node, sharding))
        if node is None:
            return None
        hit = relink.get(id(node))
        return hit if hit is not None else sharding.put(node, node.device)

    shardings = None
    views = {}
    for key, view in ws.views.items():
        if shardings is None:       # the views share shapes
            shardings = serving_shardings(view, mesh, par)
        views[key] = put(view, shardings)
    return WeightStore(store=placed, views=views)


def local_tree(tree: Any) -> Any:
    """A placed store or view as each rank's plain local tensors (the
    ``to_local()`` of every DTensor: views of the rank's own shards), the
    tree the local decode runs on."""
    from repro_torch.dist.compat import is_dtensor
    if isinstance(tree, dict):
        return {k: local_tree(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(local_tree(v) for v in tree)
    return tree.to_local() if is_dtensor(tree) else tree


def store_bytes(*trees: Any) -> int:
    """Bytes of the distinct storages the tensors of ``trees`` hold (a
    placed tree's local shards): a store and its views count each shared
    tensor once."""
    from repro_torch.dist.compat import is_dtensor
    seen: dict = {}

    def walk(node):
        if isinstance(node, dict):
            for v in node.values():
                walk(v)
        elif isinstance(node, (list, tuple)):
            for v in node:
                walk(v)
        elif isinstance(node, Tensor):
            t = node.to_local() if is_dtensor(node) else node
            st = t.untyped_storage()
            seen[(st.data_ptr(), t.device)] = st.nbytes()

    for tree in trees:
        walk(tree)
    return sum(seen.values())


# ---------------------------------------------------------------------------
# One variant per rung; a rung view copied out
# ---------------------------------------------------------------------------

def variant_shardings(variant: Any, mesh, par=None) -> Any:
    """NamedShardings for one quantized variant on ``mesh``: the training
    params' Megatron column / row rules (``w_q`` and the plane leaves
    follow ``w``, ``w_scale`` is replicated; ``dist.sharding``)."""
    from repro_torch.configs.base import ParallelConfig
    from repro_torch.dist import sharding as SH
    specs = SH.param_specs(variant, mesh, par or ParallelConfig())
    return SH.to_named(specs, mesh)


def _tree_copy(node: Any) -> Any:
    """The dict / list structure of ``node`` copied, its tensors shared
    (so a quantizer that pops leaves keeps the caller's tree whole)."""
    if isinstance(node, dict):
        return {k: _tree_copy(v) for k, v in node.items()}
    if isinstance(node, (list, tuple)):
        return type(node)(_tree_copy(v) for v in node)
    return node


def build_variant_cache(params: Any, cfg, r_by_rung: Mapping[Any, Any],
                        mesh=None, par=None, pack_planes: bool = False,
                        plane_count: Optional[int] = None,
                        calib: Optional[Mapping[str, Any]] = None,
                        cache_bits: Any = None,
                        spec: Optional[ServingQuantSpec] = None) -> dict:
    """One single-point artifact per operating point
    (``quantize_params_for_serving``): ``r_by_rung`` maps a rung key to R,
    to (R, b~x), or to a ``core.policy.PolicyTree``. Every variant has the
    same structure and shapes (b~x is data), so one decode step serves
    them all. With ``mesh`` each variant's leaves are DTensors placed by
    ``variant_shardings``. ``params`` is left whole (each rung quantizes
    its own copy of the tree's structure).

    ``pack_planes`` over several rungs needs a pinned ``plane_count``
    (e.g. ``LADDER_PLANE_COUNT``), so the rungs' plane leaves share
    shapes. ``cache_bits`` is an int for every rung or a {rung key: bits}
    mapping covering each. ``spec`` (a ``ServingQuantSpec``) supersedes
    the per-knob arguments. The codes are int8."""
    if spec is not None:
        pack_planes, plane_count = spec.pack_planes, spec.plane_count
        calib, cache_bits = spec.calib, spec.cache_bits
    if isinstance(cache_bits, Mapping):
        missing = set(r_by_rung) - set(cache_bits)
        if missing:
            raise ValueError(
                f"cache_bits mapping must cover every rung (missing "
                f"{sorted(missing)}): rungs with and without kv_cache "
                "leaves cannot share one pytree structure")
    if pack_planes and plane_count is None and len(r_by_rung) > 1:
        raise ValueError(
            "pack_planes over multiple rungs needs a pinned plane_count "
            "(e.g. serving.LADDER_PLANE_COUNT); per-rung value-exact plane "
            "counts give rungs different avals and break the one-compiled-"
            "decode-step invariant")
    base = ServingQuantSpec(pack_planes=pack_planes, plane_count=plane_count,
                            calib=calib)
    cache = {}
    shardings = None
    for key, rung_spec in r_by_rung.items():
        cb = (cache_bits.get(key) if isinstance(cache_bits, Mapping)
              else cache_bits)
        rq = dataclasses.replace(base,
                                 cache_bits=None if cb is None else int(cb))
        if isinstance(rung_spec, pol.PolicyTree):
            rq = dataclasses.replace(rq, policy=rung_spec)
        else:
            r, act_bits = rung_spec if isinstance(rung_spec, tuple) \
                else (rung_spec, None)
            rq = dataclasses.replace(rq, r=float(r), act_bits=act_bits)
        v = quantize_params_for_serving(_tree_copy(params), cfg, spec=rq)
        if mesh is not None:
            from repro_torch.dist import sharding as SH
            if shardings is None:     # the variants share shapes
                shardings = variant_shardings(v, mesh, par)
            v = SH.distribute(v, shardings)
        cache[key] = v
    return cache


def materialize_view(view: Any) -> Any:
    """Copy one rung view out as a standalone variant: ``w_q`` becomes the
    masked codes the plane-skipping kernels realize
    (``core.pann.masked_codes``), the plane leaves are repacked from them,
    ``w_colsum`` is their column sum and the ``plane_shift`` leaf is
    dropped. Same gamma_R scale, same bias grid, same integer dataflow:
    its decode is bit-identical to the view's."""
    def walk(node):
        if isinstance(node, dict):
            if "w_q" in node and "plane_shift" in node:
                sh = int(node["plane_shift"].reshape(-1)[0])
                masked = pann_core.masked_codes(node["w_q"], sh)
                out = {k: v for k, v in node.items() if k != "plane_shift"}
                out["w_q"] = masked.to(node["w_q"].dtype)
                out["w_colsum"] = torch.sum(masked, dim=-2,
                                            dtype=torch.int32)
                if "w_planes_pos" in node:
                    out.update(_planes_artifact(out["w_q"],
                                                LADDER_PLANE_COUNT))
                return out
            return {k: walk(v) for k, v in node.items()}
        if isinstance(node, (list, tuple)):
            return type(node)(walk(v) for v in node)
        return node

    return walk(view)
