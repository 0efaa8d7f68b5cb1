"""RWKV-6 "Finch" block (port of ``repro.models.rwkv``): attention-free
time mixing with a data-dependent decay (arXiv:2404.05892), and the
squared-ReLU channel mix.

Time mixing keeps a per-head (hd x hd) wkv state, O(1) memory a token. The
recurrence runs token by token in the reference's op order: each step's
output reads ``s + u * kv`` *before* the update ``s <- w * s + kv``; the
decay ``w = exp(-exp(dd))`` is taken in fp32.

PANN applies to the static mixing matrices (the r/k/v/g/o projections, the
decay LoRA and the channel-mix matrices); the decay path and the
recurrence are elementwise fp32.

Under a serving mesh (``dist.local_ops.use_shards``) a rank holds its
heads of the wkv state: ``wr`` / ``wk`` / ``wv`` / ``wg`` / ``decay_b``
are column-parallel on whole 64-wide heads, ``decay_a``'s 64 LoRA columns
are gathered before ``decay_b``, the recurrence runs at one rank's shape
(the rank's heads and rows among zeros: ``ServeShards.place``), the
heads' outputs are gathered for ``ln_x`` over the whole d and ``wo``
(row-parallel) takes the rank's columns. The channel mix's ``wv`` (ff, d)
is column-parallel over its OUTPUT d (the reference's rule for the key
``wv``), so its input ``k`` is gathered before it and its output after.
The token shifts stay whole over "model".
"""
from __future__ import annotations

from typing import NamedTuple, Optional

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.dist import constrain as C
from repro_torch.dist import local_ops
from repro_torch.models import layers as L

Tensor = torch.Tensor

HEAD_DIM = 64
DECAY_RANK = 64         # the decay LoRA's inner width


class RWKVState(NamedTuple):
    wkv: Tensor       # (B, H, hd, hd) fp32
    shift_tm: Tensor  # (B, d) previous token (time mix)
    shift_cm: Tensor  # (B, d) previous token (channel mix)
    length: Tensor    # () int32


def _heads(cfg: ModelConfig) -> int:
    assert cfg.d_model % HEAD_DIM == 0
    return cfg.d_model // HEAD_DIM


def init_rwkv_time_mix(gen: torch.Generator, cfg: ModelConfig,
                       device) -> dict:
    d = cfg.d_model
    h = _heads(cfg)

    def full(shape, value):
        return torch.full(shape, value, dtype=torch.float32, device=device)

    return {
        "mu": full((5, d), 0.5),    # r, k, v, g, w token-shift mix
        "wr": L.init_linear(gen, d, d, device),
        "wk": L.init_linear(gen, d, d, device),
        "wv": L.init_linear(gen, d, d, device),
        "wg": L.init_linear(gen, d, d, device),
        # data-dependent decay: low-rank w = exp(-exp(base + tanh(x A) B))
        "decay_a": L.init_linear(gen, d, DECAY_RANK, device),
        "decay_b": L.init_linear(gen, DECAY_RANK, d, device),
        "decay_base": full((d,), -4.0),
        "bonus": full((h, HEAD_DIM), 0.0),      # per-head "u" term
        "ln_x": L.init_norm(d, "layernorm", device),
        "wo": L.init_linear(gen, d, d, device),
    }


def init_rwkv_channel_mix(gen: torch.Generator, cfg: ModelConfig,
                          device) -> dict:
    d = cfg.d_model
    return {
        "mu": torch.full((2, d), 0.5, dtype=torch.float32, device=device),
        "wk": L.init_linear(gen, d, cfg.d_ff, device),
        "wv": L.init_linear(gen, cfg.d_ff, d, device),
    }


def _token_shift(x: Tensor, prev: Tensor) -> Tensor:
    """Shifted sequence [prev, x_0, ..., x_{T-2}]. x: (B, T, d)."""
    return torch.cat([prev[:, None, :], x[:, :-1, :]], dim=1)


def _time_mix_inner(r: Tensor, k: Tensor, v: Tensor, w: Tensor, u: Tensor,
                    state: Tensor) -> tuple[Tensor, Tensor]:
    """The wkv recurrence, token by token (vectorized over B, H).

    r, k, v: (B, T, H, hd); w: (B, T, H, hd) decays in (0, 1); u: (H, hd);
    state: (B, H, hd, hd). Returns (out (B, T, H, hd), new state)."""
    outs = []
    s = state
    for t in range(r.shape[1]):
        rt, kt, vt, wt = r[:, t], k[:, t], v[:, t], w[:, t]
        kv = kt[..., :, None] * vt[..., None, :]             # (B,H,hd,hd)
        outs.append(torch.einsum("bhi,bhij->bhj", rt,
                                 s + u[None, :, :, None] * kv))
        s = wt[..., :, None] * s + kv
    return torch.stack(outs, dim=1), s


def apply_time_mix(x: Tensor, p: dict, cfg: ModelConfig,
                   state: Optional[RWKVState] = None
                   ) -> tuple[Tensor, Tensor, Tensor]:
    """x: (B, T, d) -> (y, final wkv state, last token); from ``state``
    (its wkv and shift_tm) when given, else from zeros."""
    b, t, d = x.shape
    h = _heads(cfg)
    shards = local_ops.current_shards()

    def lin(xv, w, name):
        path = f"rwkv.tm.{name}"
        y = L.apply_linear(xv, w, L.module_quant(cfg, path),
                           backend=cfg.kernel_backend, path=path)
        if shards is not None and name in ("wr", "wk", "wv", "wg",
                                           "decay_b"):
            y = shards.heads_of(y, h, d)       # the rank's heads
        return y

    prev = (x.new_zeros((b, d)) if state is None
            else state.shift_tm.to(x.dtype))
    xs = _token_shift(x, prev)
    mu = p["mu"].to(x.dtype)
    mix = [x * mu[i] + xs * (1 - mu[i]) for i in range(5)]
    hl = h if shards is None else shards.heads_here(h)
    r = C.constrain_axis(lin(mix[0], p["wr"], "wr").reshape(b, t, hl,
                                                             HEAD_DIM), 2)
    k = C.constrain_axis(lin(mix[1], p["wk"], "wk").reshape(b, t, hl,
                                                             HEAD_DIM), 2)
    v = C.constrain_axis(lin(mix[2], p["wv"], "wv").reshape(b, t, hl,
                                                             HEAD_DIM), 2)
    g = F.silu(lin(mix[3], p["wg"], "wg"))
    dlow = lin(mix[4], p["decay_a"], "decay_a")
    base = p["decay_base"]
    if shards is not None:
        dlow = shards.whole(dlow, DECAY_RANK)
        base = shards.part(base, h)
    dd = lin(torch.tanh(dlow), p["decay_b"], "decay_b") + base
    w = torch.exp(-torch.exp(dd.to(torch.float32))).reshape(b, t, hl,
                                                             HEAD_DIM)
    s0 = (x.new_zeros((b, hl, HEAD_DIM, HEAD_DIM), dtype=torch.float32)
          if state is None else state.wkv)
    rkvw = (r.to(torch.float32), k.to(torch.float32), v.to(torch.float32),
            w)
    if shards is None:
        out, s_fin = _time_mix_inner(*rkvw, p["bonus"], s0)
    else:       # at one rank's shape: the rank's rows and heads among zeros
        out, s_fin = _time_mix_inner(
            *(shards.place(a, 2, h) for a in rkvw), p["bonus"],
            shards.place(s0, 1, h))
        out, s_fin = shards.take(out, b, 2, h), shards.take(s_fin, b, 1, h)
    out = out.reshape(b, t, hl * HEAD_DIM).to(x.dtype)
    if shards is not None:      # ln_x over the whole d, then the rank's
        out = shards.part(L.apply_norm(shards.whole(out, d), p["ln_x"],
                                       "layernorm"), h)
    else:
        out = L.apply_norm(out, p["ln_x"], "layernorm")
    return lin(out * g, p["wo"], "wo"), s_fin, x[:, -1, :]


def apply_channel_mix(x: Tensor, p: dict, cfg: ModelConfig,
                      prev: Optional[Tensor] = None
                      ) -> tuple[Tensor, Tensor]:
    """x: (B, T, d) -> (y, last token); shifted in from ``prev`` (zeros
    when None)."""
    b, _, d = x.shape
    pv = x.new_zeros((b, d)) if prev is None else prev.to(x.dtype)
    xs = _token_shift(x, pv)
    mu = p["mu"].to(x.dtype)
    xk = x * mu[0] + xs * (1 - mu[0])
    k = torch.square(F.relu(L.project(xk, p["wk"], cfg, "rwkv.cm.wk")))
    shards = local_ops.current_shards()
    if shards is None:
        return L.project(k, p["wv"], cfg, "rwkv.cm.wv"), x[:, -1, :]
    # wv is column-parallel over its output d: k whole in, d gathered out
    k = shards.whole(k, cfg.d_ff)
    return shards.whole(L.project(k, p["wv"], cfg, "rwkv.cm.wv"),
                        d), x[:, -1, :]


def init_rwkv_state(cfg: ModelConfig, batch: int, dtype,
                    device) -> RWKVState:
    """Zeros; under a serving mesh the rank's heads of the wkv state."""
    h = _heads(cfg)
    shards = local_ops.current_shards()
    if shards is not None:
        h = shards.heads_here(h)
    return RWKVState(
        wkv=torch.zeros((batch, h, HEAD_DIM, HEAD_DIM), dtype=torch.float32,
                        device=device),
        shift_tm=torch.zeros((batch, cfg.d_model), dtype=dtype,
                             device=device),
        shift_cm=torch.zeros((batch, cfg.d_model), dtype=dtype,
                             device=device),
        length=torch.zeros((), dtype=torch.int32, device=device))
