"""Mamba2 (SSD) block (port of ``repro.models.ssm``): the chunked
state-space-duality scan of prefill and ``forward``, and the recurrent
single-token decode step.

Follows the minimal SSD reference (Dao & Gu 2024): a within-chunk quadratic
attention-like term plus cross-chunk recurrent state passing. Decode keeps
an explicit (H, P, N) state per sequence, O(1) a token.

PANN applies to the in/out projections (through ``layers.project``); the
selective scan is state-times-input arithmetic with no static weight and
stays in fp32, as in the reference (XLA code there, not a Pallas kernel).
The reference's op order is kept where it decides a value: the mask goes
on before ``exp``, the conv sums its taps in order from 0, the
cross-chunk recurrence emits the state *before* each chunk, and softplus
is ``logaddexp(x, 0)`` (``jax.nn.softplus``; ``F.softplus``'s threshold
of 20 is another function).

Under a serving mesh (``dist.local_ops.use_shards``) a rank holds its
heads of the state and its columns of ``in_proj`` (a split that does not
fall on head boundaries: zamba2's 8,384 columns in two halves of 4,192),
so decode gathers the projection's output over "model" (a copy), runs the
conv and the recurrence at one rank's shape (its heads and rows among
zeros: ``ServeShards.place``), gathers its heads' ``y`` for the gated
norm over the whole d_inner, and ``out_proj`` (row-parallel) takes its K
rows of the normed ``y``.
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


class SSMState(NamedTuple):
    state: Tensor      # (B, H, P, N) recurrent state, fp32
    conv: Tensor       # (B, W-1, conv_dim) causal-conv tail (pre-conv)
    length: Tensor     # () int32


def _dims(cfg: ModelConfig):
    d_inner = cfg.ssm_expand * cfg.d_model
    n_heads = d_inner // cfg.ssm_head_dim
    return d_inner, n_heads, cfg.ssm_head_dim, cfg.ssm_state


def n_heads(cfg: ModelConfig) -> int:
    """The SSM heads of a Mamba2 layer (d_inner / ssm_head_dim)."""
    return _dims(cfg)[1]


def init_ssm(gen: torch.Generator, cfg: ModelConfig, device) -> dict:
    d_inner, h, _, n = _dims(cfg)
    d = cfg.d_model
    conv_dim = d_inner + 2 * n      # x + B + C streams (single group)
    return {
        # in_proj emits [z (gate), x, B, C, dt]
        "in_proj": L.init_linear(gen, d, 2 * d_inner + 2 * n + h, device),
        "conv_w": torch.randn((cfg.ssm_conv_width, conv_dim), generator=gen,
                              dtype=torch.float32, device=device) * 0.2,
        "conv_b": torch.zeros((conv_dim,), dtype=torch.float32,
                              device=device),
        "a_log": torch.log(torch.linspace(1.0, 16.0, h, dtype=torch.float32,
                                          device=device)),
        "dt_bias": torch.zeros((h,), dtype=torch.float32, device=device),
        "d_skip": torch.ones((h,), dtype=torch.float32, device=device),
        "norm": L.init_norm(d_inner, "rmsnorm", device),
        "out_proj": L.init_linear(gen, d_inner, d, device),
    }


def _softplus(x: Tensor) -> Tensor:
    """``jax.nn.softplus``: log(exp(x) + 1) with no threshold."""
    return torch.logaddexp(x, x.new_zeros(()))


def _split_proj(zxbcdt: Tensor, cfg: ModelConfig):
    """[z, x, B, C, dt] at the reference's split indices."""
    d_inner, _, _, n = _dims(cfg)
    z, xbc, dt = torch.tensor_split(zxbcdt, [d_inner, 2 * d_inner + 2 * n],
                                    dim=-1)
    x, b_ssm, c_ssm = torch.tensor_split(xbc, [d_inner, d_inner + n], dim=-1)
    return z, x, b_ssm, c_ssm, dt


def _causal_conv(x: Tensor, w: Tensor, b: Tensor,
                 tail: Optional[Tensor] = None):
    """Depthwise causal conv along time. x: (B, T, C); w: (W, C); ``tail``
    the W-1 inputs before x (zeros when None). Returns (silu(conv + b), the
    new tail)."""
    width = w.shape[0]
    if tail is None:
        pad = x.new_zeros((x.shape[0], width - 1, x.shape[2]))
    else:
        pad = tail.to(x.dtype)
    xp = torch.cat([pad, x], dim=1)
    t = x.shape[1]
    out = sum(xp[:, i:i + t, :] * w[i][None, None, :].to(x.dtype)
              for i in range(width))
    new_tail = xp[:, -(width - 1):, :] if width > 1 else None
    return F.silu(out + b.to(x.dtype)), new_tail


def _ssd_chunked(x: Tensor, dt: Tensor, a_log: Tensor, b_ssm: Tensor,
                 c_ssm: Tensor, chunk: int = 64):
    """SSD scan. x: (B, T, H, P); dt: (B, T, H); b, c: (B, T, N).

    Returns y (B, T, H, P) and the final state (B, H, P, N), fp32. The
    reference's three-operand einsums are taken pairwise here, so no
    (B, C, L, L, H, P) intermediate is formed."""
    bsz, t, h, p_dim = x.shape
    n = b_ssm.shape[-1]
    chunk = min(chunk, t)
    assert t % chunk == 0, f"T = {t} is not a multiple of the chunk {chunk}"
    n_chunks = t // chunk
    a = -torch.exp(a_log.to(torch.float32))                  # (H,) negative
    dt = _softplus(dt.to(torch.float32))                     # (B, T, H)
    da = dt * a[None, None, :]                               # log-decay

    xr = x.reshape(bsz, n_chunks, chunk, h, p_dim)
    dtr = dt.reshape(bsz, n_chunks, chunk, h)
    dar = da.reshape(bsz, n_chunks, chunk, h)
    br = b_ssm.reshape(bsz, n_chunks, chunk, n)
    cr = c_ssm.reshape(bsz, n_chunks, chunk, n)

    cum = torch.cumsum(dar, dim=2)                           # (B, C, L, H)
    seg = cum[:, :, :, None, :] - cum[:, :, None, :, :]      # (B,C,Lq,Lk,H)
    causal = torch.tril(torch.ones((chunk, chunk), dtype=torch.bool,
                                   device=x.device))
    # mask BEFORE exp: masked entries have seg > 0 and would overflow
    seg = torch.where(causal[None, None, :, :, None], seg,
                      seg.new_full((), -1e30))
    decay = torch.exp(seg)

    # within-chunk (quadratic in chunk length only)
    scores = torch.einsum("bcln,bcmn->bclm", cr, br)[..., None] * decay
    y_diag = torch.einsum("bclmh,bcmhp->bclhp", scores * dtr[:, :, None],
                          xr)

    # per-chunk input -> state contribution
    decay_to_end = torch.exp(cum[:, :, -1:, :] - cum)        # (B, C, L, H)
    states = torch.einsum("bclnh,bclhp->bchpn",
                          br[..., None] * (dtr * decay_to_end)[:, :, :, None],
                          xr)

    # cross-chunk recurrence over the chunk index
    chunk_decay = torch.exp(cum[:, :, -1, :])                # (B, C, H)
    carry = x.new_zeros((bsz, h, p_dim, n), dtype=torch.float32)
    prev = []
    for c in range(n_chunks):
        prev.append(carry)           # emit the state *before* the chunk
        carry = carry * chunk_decay[:, c, :, None, None] + states[:, c]
    prev_states = torch.stack(prev, dim=1)                   # (B,C,H,P,N)

    # contribution of the carried-in state to each position
    decay_from_start = torch.exp(cum)                        # (B, C, L, H)
    y_off = torch.einsum("bclnh,bchpn->bclhp",
                         cr[..., None] * decay_from_start[:, :, :, None],
                         prev_states)

    y = (y_diag + y_off).reshape(bsz, t, h, p_dim)
    return y, carry


def apply_ssm(x: Tensor, p: dict, cfg: ModelConfig) -> Tensor:
    """Prefill / ``forward``. x: (B, T, d) -> (B, T, d)."""
    d_inner, h, p_dim, n = _dims(cfg)
    zxbcdt = L.project(x, p["in_proj"], cfg, "ssm.in_proj")
    z, xs, b_ssm, c_ssm, dt = _split_proj(zxbcdt, cfg)
    conv_in = torch.cat([xs, b_ssm, c_ssm], dim=-1)
    conv_out, _ = _causal_conv(conv_in, p["conv_w"], p["conv_b"])
    xs, b_ssm, c_ssm = torch.tensor_split(conv_out, [d_inner, d_inner + n],
                                          dim=-1)
    xh = C.constrain_axis(xs.reshape(*xs.shape[:-1], h, p_dim), 2)
    y, _ = _ssd_chunked(xh, dt, p["a_log"], b_ssm, c_ssm)
    y = y + p["d_skip"][None, None, :, None] * xh.to(torch.float32)
    y = y.reshape(*x.shape[:-1], d_inner).to(x.dtype)
    y = y * F.silu(z)
    y = L.apply_norm(y, p["norm"], "rmsnorm")
    return L.project(y, p["out_proj"], cfg, "ssm.out_proj")


def init_ssm_state(cfg: ModelConfig, batch: int, dtype, device) -> SSMState:
    """Zeros; under a serving mesh the rank's heads of the state."""
    d_inner, h, p_dim, n = _dims(cfg)
    shards = local_ops.current_shards()
    if shards is not None:
        h = shards.heads_here(h)
    return SSMState(
        state=torch.zeros((batch, h, p_dim, n), dtype=torch.float32,
                          device=device),
        conv=torch.zeros((batch, cfg.ssm_conv_width - 1, d_inner + 2 * n),
                         dtype=dtype, device=device),
        length=torch.zeros((), dtype=torch.int32, device=device))


def decode_ssm(x: Tensor, st: SSMState, p: dict, cfg: ModelConfig
               ) -> tuple[Tensor, SSMState]:
    """Single-token recurrent step. x: (B, 1, d). Returns (out, a NEW
    state; ``st`` is not written). Under a serving mesh x is the rank's
    rows and ``st`` its rows and heads (module docstring)."""
    d_inner, h, p_dim, n = _dims(cfg)
    zxbcdt = L.project(x, p["in_proj"], cfg, "ssm.in_proj")
    shards = local_ops.current_shards()
    b = x.shape[0]
    if shards is None:
        y, state, tail = _decode_core(zxbcdt, st.state, st.conv, p, cfg)
        y = y.reshape(b, 1, d_inner)
    else:
        zxbcdt = shards.whole(zxbcdt, 2 * d_inner + 2 * n + h)
        y, state, tail = _decode_core(
            shards.place(zxbcdt), shards.place(st.state, 1, h),
            shards.place(st.conv), p, cfg)
        y = shards.whole(shards.take(y, b, 1, h).reshape(b, 1, -1), d_inner)
        state, tail = shards.take(state, b, 1, h), shards.take(tail, b)
    z = _split_proj(zxbcdt, cfg)[0]
    y = y.to(x.dtype) * F.silu(z)
    y = L.apply_norm(y, p["norm"], "rmsnorm")
    out = L.project(y, p["out_proj"], cfg, "ssm.out_proj")
    return out, SSMState(state=state, conv=tail, length=st.length + 1)


def _decode_core(zxbcdt: Tensor, state: Tensor, tail: Tensor, p: dict,
                 cfg: ModelConfig) -> tuple[Tensor, Tensor, Tensor]:
    """The conv and the recurrence of one token: zxbcdt (B, 1, W) the
    in_proj output, ``state`` (B, H, P, N), ``tail`` the conv's pre-conv
    inputs. Returns (y (B, H, P) fp32 before the gate, the new state, the
    new tail)."""
    d_inner, h, p_dim, n = _dims(cfg)
    _, xs, b_ssm, c_ssm, dt = _split_proj(zxbcdt, cfg)
    conv_in = torch.cat([xs, b_ssm, c_ssm], dim=-1)          # (B, 1, C)
    conv_out, _ = _causal_conv(conv_in, p["conv_w"], p["conv_b"],
                               tail=tail)
    # the tail keeps the pre-conv inputs
    new_tail = torch.cat([tail, conv_in.to(tail.dtype)], dim=1)[:, 1:, :]
    xs, b_ssm, c_ssm = torch.tensor_split(conv_out, [d_inner, d_inner + n],
                                          dim=-1)
    xh = xs.reshape(xs.shape[0], h, p_dim).to(torch.float32)
    dtv = _softplus(dt[:, 0].to(torch.float32))              # (B, H)
    a = -torch.exp(p["a_log"].to(torch.float32))
    dec = torch.exp(dtv * a[None, :])                        # (B, H)
    bv = b_ssm[:, 0].to(torch.float32)                       # (B, N)
    cv = c_ssm[:, 0].to(torch.float32)
    upd = (dtv[:, :, None] * xh)[..., None] * bv[:, None, None, :]
    state = state * dec[:, :, None, None] + upd
    y = torch.einsum("bhpn,bn->bhp", state, cv)
    y = y + p["d_skip"][None, :, None] * xh
    return y, state, new_tail
