"""EMA activation-range calibration for power-aware QAT (port of
``repro.core.calibrate``).

During training the range of every projection input is observed
(per-tensor min/max, merged across the depth of the stack: module paths
are roles, so every layer of a role shares one range, as it shares one
``ModuleQuant``) and folded into an exponential moving average that lives
in the train state as its own collection:

    state.calib = {"attn.wq": tensor([lo, hi]), "mlp.w_down": ..., ...}

The QAT forward quantizes against these ranges, and export freezes them
into the serving artifact (``models.serving``), so training and serving
quantize against the same numbers.

Ranges start at the unseen sentinel [+inf, -inf]; every consumer treats
lo > hi as "use the dynamic per-tensor range" (bit-exact with the
uncalibrated path), so a role that never runs (``moe.router`` on a dense
model) stays inert. Every entry is a (2,) fp32 tensor on the state's
device; ``merge`` and ``ema_update`` are the reference's fp32 op sequences.
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.core import costs

Tensor = torch.Tensor

# module roles that are not ``layers.apply_linear`` call sites and so never
# observe activations (the depthwise conv reads no shared activation)
_NON_LINEAR_PATHS = frozenset({"ssm.conv"})

UNSEEN = (float("inf"), float("-inf"))


def calib_paths(cfg: ModelConfig) -> Tuple[str, ...]:
    """The module paths calibrated for ``cfg``: every projection role of
    the cost profile, ``lm_head`` (also when the embedding is tied: the
    unembed quantizes its input too) and, for a config with attention, the
    KV-cache roles (post-RoPE K and V, what decode writes)."""
    from repro_torch.core.policy import CACHE_PATHS
    paths = {m.path for m in costs.module_cost_profile(cfg)}
    paths.add("lm_head")
    if any(p.startswith("attn.") for p in paths):
        paths.update(CACHE_PATHS)
    return tuple(sorted(paths - _NON_LINEAR_PATHS))


def _unseen(device) -> Tensor:
    return torch.tensor(UNSEEN, dtype=torch.float32, device=device)


def init_calib(cfg: ModelConfig, device) -> Dict[str, Tensor]:
    """A fresh collection on ``device``: every role at the unseen
    sentinel."""
    return {p: _unseen(device) for p in calib_paths(cfg)}


def unseen_like(calib: Dict[str, Tensor]) -> Dict[str, Tensor]:
    """An all-unseen accumulator with ``calib``'s keys, on its device: the
    zero element of ``merge``."""
    return {p: _unseen(v.device) for p, v in calib.items()}


def seen(entry: Tensor) -> Tensor:
    """Whether a [lo, hi] entry has observed anything (lo <= hi)."""
    return entry[0] <= entry[1]


def merge(into: Dict[str, Tensor], observed: Dict[str, Tensor]
          ) -> Dict[str, Tensor]:
    """The union of two observation dicts: elementwise min lo / max hi.
    ``observed`` may cover a subset of ``into``'s keys; keys ``into`` lacks
    are ignored, so the structure stays fixed."""
    out = dict(into)
    for path, obs in observed.items():
        if path not in out:
            continue
        cur = out[path]
        out[path] = torch.stack([torch.minimum(cur[0], obs[0]),
                                 torch.maximum(cur[1], obs[1])])
    return out


def ema_update(calib: Dict[str, Tensor], observed: Optional[Dict[str, Tensor]],
               decay: float) -> Dict[str, Tensor]:
    """One EMA step of the collection, per role: an unseen observation
    keeps the current range; the first real one is adopted outright;
    after that new = decay * old + (1 - decay) * observed on [lo, hi]."""
    if observed is None:
        return calib
    out = {}
    for path, cur in calib.items():
        obs = observed.get(path)
        if obs is None:
            out[path] = cur
            continue
        d = torch.tensor(decay, dtype=torch.float32, device=cur.device)
        ema = d * cur + (1.0 - d) * obs
        new = torch.where(seen(cur), ema, obs)
        out[path] = torch.where(seen(obs), new, cur)
    return out


def describe(calib: Optional[Dict[str, Tensor]]) -> str:
    """Host-side rendering of a collection (the trainer's end-of-run log)."""
    if not calib:
        return "calibration: off"
    rows = []
    for path, entry in sorted(calib.items()):
        lo, hi = (float(v) for v in entry.detach().cpu())
        rows.append(f"  {path}: unseen" if lo > hi
                    else f"  {path}: [{lo:+.4f}, {hi:+.4f}]")
    return "\n".join(["calibration ranges:"] + rows)


def n_seen(calib: Optional[Dict[str, Tensor]]) -> int:
    """How many roles of a collection have a range."""
    if not calib:
        return 0
    return sum(bool(seen(v)) for v in calib.values())
