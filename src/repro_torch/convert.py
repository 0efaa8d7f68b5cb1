"""Carry parameters and weight stores across from the JAX package.

Both functions take nested numpy trees — the JAX package's pytrees after
``np.asarray`` on every leaf — so this module imports nothing of JAX. The
JAX package stacks the layers of each repeating group along a leading
axis; the port keeps one dict per layer, so the stacked leaves are sliced
here.
"""
from __future__ import annotations

from typing import Any

import numpy as np
import torch

from repro_torch.models import transformer as T


def _unstack(node: Any, i: int) -> Any:
    """Slice index ``i`` of the leading (group) axis of every leaf."""
    if isinstance(node, dict):
        return {k: _unstack(v, i) for k, v in node.items()}
    if isinstance(node, (list, tuple)):
        return [_unstack(v, i) for v in node]
    return np.asarray(node)[i]


def _port_layout(tree: dict, cfg) -> dict:
    """Reference layout {"decoder": {"groups": {"layers": [...]}, "tail"},
    ...} -> port layout {"layers": [...], ...} (numpy leaves)."""
    pattern, n_groups, n_tail = T.group_layout(cfg)
    dec = tree["decoder"]
    layers = [_unstack(dec["groups"]["layers"][i], g)
              for g in range(n_groups) for i in range(len(pattern))]
    layers += [dec["tail"][j] for j in range(n_tail)]
    out = {k: v for k, v in tree.items() if k != "decoder"}
    out["layers"] = layers
    return out


def _to_torch(node: Any, device) -> Any:
    if isinstance(node, dict):
        return {k: _to_torch(v, device) for k, v in node.items()}
    if isinstance(node, (list, tuple)):
        return [_to_torch(v, device) for v in node]
    return torch.as_tensor(np.array(node), device=device)


def params_from_reference(np_params: dict, cfg, device) -> dict:
    """``repro.models.model.init_params`` output (numpy leaves) -> the
    port's params (``repro_torch.models.model`` layout) on ``device``."""
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
    return torch.as_tensor(np.array(view), device=device)


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
