"""Carry parameters and weight stores across from the JAX package, and
back into its layout.

The functions take nested numpy trees — the JAX package's pytrees after
``np.asarray`` on every leaf — or torch tensors, so this module imports
nothing of JAX. The JAX package stacks the layers of each repeating group
along a leading axis; the port keeps one dict per layer, so the stacked
leaves are sliced here, and ``reference_layout`` restacks them (the
serving artifact is written in the JAX package's layout).
"""
from __future__ import annotations

import dataclasses
from typing import Any

import numpy as np
import torch

from repro_torch.models import transformer as T


def _unstack(node: Any, i: int) -> Any:
    """Slice index ``i`` of the leading (group) axis of every leaf (numpy
    arrays or torch tensors)."""
    if isinstance(node, dict):
        return {k: _unstack(v, i) for k, v in node.items()}
    if isinstance(node, (list, tuple)):
        return [_unstack(v, i) for v in node]
    if isinstance(node, torch.Tensor):
        return node[i]
    return np.asarray(node)[i]


def _first_leaf(node: Any) -> Any:
    while isinstance(node, (dict, list, tuple)):
        node = next(iter(node.values())) if isinstance(node, dict) \
            else node[0]
    return node


def _unstack_layers(stack: dict, cfg, num_layers, role: str) -> list:
    """One stacked layer stack {"groups": {"layers": [...]}, "tail"} ->
    its per-layer list. The group pattern and count are read off the
    stacked tree; ``cfg``, when given, must agree with them."""
    groups = stack.get("groups", {}).get("layers", [])
    n_groups = int(_first_leaf(groups).shape[0]) if groups else 0
    tail = list(stack.get("tail", []))
    if cfg is not None:
        pattern, want_groups, n_tail = T.group_layout(cfg, num_layers, role)
        if (len(groups), n_groups, len(tail)) != (
                len(pattern) if want_groups else 0, want_groups, n_tail):
            raise ValueError(
                f"stacked {role} tree has {n_groups} groups of "
                f"{len(groups)} layers and {len(tail)} tail layers; "
                f"{cfg.name} has {want_groups} of {len(pattern)} and "
                f"{n_tail}")
    return [_unstack(groups[i], g)
            for g in range(n_groups) for i in range(len(groups))] + tail


def _port_layout(tree: dict, cfg=None) -> dict:
    """Reference layout {"decoder": {"groups": {"layers": [...]}, "tail"},
    ["encoder": {...}], ...} -> port layout {"layers": [...],
    ["encoder": {"layers": [...]}], ...}."""
    out = {k: v for k, v in tree.items() if k != "decoder"}
    out["layers"] = _unstack_layers(tree["decoder"], cfg, None, "decoder")
    if "encoder" in tree:
        out["encoder"] = {"layers": _unstack_layers(
            tree["encoder"], cfg,
            None if cfg is None else cfg.encoder_layers, "encoder")}
    return out


@dataclasses.dataclass(frozen=True)
class Stacked:
    """One leaf of the reference layout, stacked along its leading group
    axis from the port's per-layer tensors ``parts`` (kept apart: their
    bytes in order are the stacked array's)."""
    parts: tuple

    @property
    def shape(self) -> tuple:
        return (len(self.parts),) + tuple(self.parts[0].shape)


def _stack(nodes: list) -> Any:
    """Zip per-layer trees of one structure into one tree of Stacked."""
    first = nodes[0]
    if isinstance(first, dict):
        return {k: _stack([n[k] for n in nodes]) for k in first}
    if isinstance(first, (list, tuple)):
        return [_stack([n[i] for n in nodes]) for i in range(len(first))]
    return Stacked(parts=tuple(nodes))


def _stack_layers(layers: list, cfg, num_layers, role: str) -> dict:
    """A per-layer list -> the reference's stacked {"groups": {"layers":
    [...]}, "tail"}: the layers of each position of ``cfg``'s group pattern
    restacked along a leading group axis (``Stacked`` leaves), the tail
    layers as they are."""
    pattern, n_groups, n_tail = T.group_layout(cfg, num_layers, role)
    if len(layers) != n_groups * len(pattern) + n_tail:
        raise ValueError(f"{len(layers)} {role} layers; {cfg.name} has "
                         f"{n_groups * len(pattern) + n_tail}")
    out: dict = {}
    if n_groups:
        out["groups"] = {"layers": [
            _stack(layers[i:n_groups * len(pattern):len(pattern)])
            for i in range(len(pattern))]}
    if n_tail:
        out["tail"] = list(layers[n_groups * len(pattern):])
    return out


def reference_layout(tree: dict, cfg) -> dict:
    """The reverse of ``_port_layout``: port layout {"layers": [...],
    ["encoder": {"layers": [...]}], ...} -> the reference's, each stack
    restacked (``_stack_layers``)."""
    out = {k: v for k, v in tree.items() if k != "layers"}
    out["decoder"] = _stack_layers(tree["layers"], cfg, None, "decoder")
    if "encoder" in tree:
        out["encoder"] = _stack_layers(tree["encoder"]["layers"], cfg,
                                       cfg.encoder_layers, "encoder")
    return out


def _leaf(node: Any, device) -> torch.Tensor:
    """A leaf on ``device``: a torch tensor in one copy (none when it is
    there already), a numpy array through a host copy of its own."""
    if isinstance(node, torch.Tensor):
        return node.to(device)
    return torch.as_tensor(np.array(node), device=device)


def _to_torch(node: Any, device) -> Any:
    if isinstance(node, dict):
        return {k: _to_torch(v, device) for k, v in node.items()}
    if isinstance(node, (list, tuple)):
        return [_to_torch(v, device) for v in node]
    return _leaf(node, device)


def params_from_reference(np_params: dict, cfg, device) -> dict:
    """A tree in the reference's layout (numpy leaves) -> the port's
    (``repro_torch.models.model`` layout) on ``device``: the fp params of
    ``repro.models.model.init_params``, or a single-point serving artifact
    of ``repro.models.serving.quantize_params_for_serving`` (its stacked
    codes, value-exact plane leaves, act and ``kv_cache`` leaves sliced
    per layer; it has no ``plane_shift``, and the port runs it at 0)."""
    return _to_torch(_port_layout(np_params, cfg), device)


def _alias(view: Any, store: Any, device) -> Any:
    """Convert a view, taking every leaf the store also holds from the
    store (so views share the store's tensors, as in the JAX package)."""
    if isinstance(view, dict):
        out = {}
        for k, v in view.items():
            s = store.get(k) if isinstance(store, dict) else None
            if isinstance(s, torch.Tensor):
                out[k] = s
            else:
                out[k] = _alias(v, s, device)
        return out
    if isinstance(view, (list, tuple)):
        stores = store if isinstance(store, list) else [None] * len(view)
        return [_alias(v, s, device) for v, s in zip(view, stores)]
    return _leaf(view, device)


def weight_store_from_reference(np_store: dict, np_views: dict, cfg,
                                device):
    """A ``repro.models.serving.WeightStore`` (``store`` and ``views`` as
    numpy trees) -> the port's ``WeightStore`` on ``device``, with every
    view referencing the store's tensors."""
    from repro_torch.models.serving import WeightStore

    store = _to_torch(_port_layout(np_store, cfg), device)
    views = {k: _alias(_port_layout(v, cfg), store, device)
             for k, v in np_views.items()}
    return WeightStore(store=store, views=views)


# ---------------------------------------------------------------------------
# The train state (launch.steps.TrainState) across the two layouts
# ---------------------------------------------------------------------------

def _grouped(cfg, num_layers, role: str) -> int:
    """How many leading layers of a stack the reference stacks in groups."""
    pattern, n_groups, _ = T.group_layout(cfg, num_layers, role)
    return n_groups * len(pattern)


def reference_matrix_mask(params: dict, cfg) -> Any:
    """Per leaf of the port's ``params``: is it a matrix (ndim >= 2) in
    the reference's layout? A layer of a repeating group has one more
    axis there (the group axis), so its norm scales and biases count as
    matrices, as they do for the reference's AdamW weight decay; a tail
    layer's do not."""
    def mask(node, extra):
        if isinstance(node, dict):
            return {k: mask(v, extra) for k, v in node.items()}
        if isinstance(node, (list, tuple)):
            return [mask(v, extra) for v in node]
        return node.ndim + extra >= 2

    def stack(layers, n_grouped):
        return [mask(lp, 1 if i < n_grouped else 0)
                for i, lp in enumerate(layers)]

    out = {k: mask(v, 0) for k, v in params.items()
           if k not in ("layers", "encoder")}
    out["layers"] = stack(params["layers"], _grouped(cfg, None, "decoder"))
    if "encoder" in params:
        out["encoder"] = {"layers": stack(
            params["encoder"]["layers"],
            _grouped(cfg, cfg.encoder_layers, "encoder"))}
    return out


def _materialize(node: Any) -> Any:
    """Stacked and tensor leaves -> numpy arrays (host copies)."""
    if isinstance(node, dict):
        return {k: _materialize(v) for k, v in node.items()}
    if isinstance(node, (list, tuple)):
        return [_materialize(v) for v in node]
    if isinstance(node, Stacked):
        return np.stack([_materialize(p) for p in node.parts])
    if isinstance(node, torch.Tensor):
        return node.detach().cpu().numpy()
    return node


def train_state_to_reference(state, cfg, numpy: bool = False) -> dict:
    """A port ``TrainState`` -> the reference's ``TrainState`` tree as a
    dict with its field names (the checkpoint keys are the same):
    {"params", "opt": {"mu", "nu", "count"}, "step", "calib"}, params and
    moments restacked (``reference_layout``; ``Stacked`` leaves over the
    port's tensors), ``calib`` None without calibration. ``numpy=True``
    copies every leaf to the host as a numpy array (stacked)."""
    tree = {"params": reference_layout(state.params, cfg),
            "opt": {"mu": reference_layout(state.opt.mu, cfg),
                    "nu": reference_layout(state.opt.nu, cfg),
                    "count": state.opt.count},
            "step": state.step,
            "calib": dict(state.calib) if state.calib else None}
    return _materialize(tree) if numpy else tree


def _field(tree, name: str):
    return tree[name] if isinstance(tree, dict) else getattr(tree, name)


def train_state_from_reference(tree, cfg, device):
    """The reference's ``TrainState`` (a NamedTuple or a dict of its
    fields, numpy leaves: the JAX package's state after ``np.asarray`` on
    every leaf, or ``ckpt.checkpoint.restore``'s output) -> the port's
    ``launch.steps.TrainState`` on ``device``: params and AdamW moments
    sliced per layer, ``count`` and ``step`` int32, ``calib`` a dict of
    (2,) fp32 tensors (None when the state has none)."""
    from repro_torch.launch.steps import TrainState
    from repro_torch.optim.optimizers import AdamWState

    opt = _field(tree, "opt")
    calib = _field(tree, "calib")
    as_i32 = lambda a: torch.as_tensor(np.array(a, np.int32),
                                       device=device)
    return TrainState(
        params=params_from_reference(_field(tree, "params"), cfg, device),
        opt=AdamWState(
            mu=params_from_reference(_field(opt, "mu"), cfg, device),
            nu=params_from_reference(_field(opt, "nu"), cfg, device),
            count=as_i32(_field(opt, "count"))),
        step=as_i32(_field(tree, "step")),
        calib=None if calib is None else {
            k: torch.as_tensor(np.array(v, np.float32), device=device)
            for k, v in calib.items()})
