"""Model assembly for the serving path (port of ``repro.models.transformer``).

Every architecture is a repeating *group pattern* of layer kinds; the port
keeps the pattern functions verbatim (``core/costs`` prices layers by them)
and holds the layers of one model as a plain per-layer list instead of the
JAX package's group-stacked leaves. Layer kinds: ``attn``
(self-attention + dense MLP; an encoder's bidirectional blocks too, which
keep RoPE), ``attn_moe`` (self-attention + MoE), ``mamba`` (Mamba2),
``mamba_attn`` (Mamba2, then zamba2's shared attention + MLP block),
``rwkv`` (RWKV-6 time mix + channel mix) and ``cross_attn`` (self-attention,
then cross-attention to the encoder's or the image's tokens gated by
``tanh(xgate)``, then the MLP).
"""
from __future__ import annotations

import dataclasses
from typing import Any, Optional

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models import attention as A
from repro_torch.models import layers as L
from repro_torch.models import mlp as M
from repro_torch.models import rwkv as R
from repro_torch.models import ssm as S

Tensor = torch.Tensor


# ---------------------------------------------------------------------------
# Group patterns
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class LayerSpec:
    kind: str
    window: Optional[int] = None


def group_pattern(cfg: ModelConfig, role: str = "decoder") -> list[LayerSpec]:
    """Smallest repeating pattern of layers for this architecture."""
    if role == "encoder":  # encdec encoder: bidirectional self-attn blocks
        return [LayerSpec("attn")]
    if cfg.family == "encdec":  # decoder: self-attn + cross-attn every layer
        return [LayerSpec("cross_attn")]
    if cfg.family == "moe":
        return [LayerSpec("attn_moe", cfg.sliding_window)]
    if cfg.family == "ssm":
        return [LayerSpec("rwkv")]
    if cfg.family == "hybrid":
        period = cfg.attn_period or 6
        return [LayerSpec("mamba")] * (period - 1) + [LayerSpec("mamba_attn")]
    if cfg.family == "vlm":
        period = cfg.cross_attn_period or 5
        return [LayerSpec("cross_attn")] + [LayerSpec("attn")] * (period - 1)
    if cfg.local_global_period:  # gemma2: alternate local / global
        return [LayerSpec("attn", cfg.local_window), LayerSpec("attn", None)]
    return [LayerSpec("attn", cfg.sliding_window)]


def group_layout(cfg: ModelConfig, num_layers: Optional[int] = None,
                 role: str = "decoder") -> tuple[list[LayerSpec], int, int]:
    """(pattern, n_groups, n_tail): n_tail layers don't fill a full group and
    run outside the scan (e.g. zamba2's 38 = 6*6 + 2)."""
    pattern = group_pattern(cfg, role)
    n_layers = num_layers if num_layers is not None else cfg.num_layers
    n_groups = n_layers // len(pattern)
    n_tail = n_layers - n_groups * len(pattern)
    return pattern, n_groups, n_tail


# ---------------------------------------------------------------------------
# Per-layer init / apply / decode
# ---------------------------------------------------------------------------

_KINDS = ("attn", "attn_moe", "cross_attn", "mamba", "mamba_attn", "rwkv")


def _check_kind(spec: LayerSpec) -> None:
    if spec.kind not in _KINDS:
        raise ValueError(f"unknown layer kind {spec.kind!r}; have {_KINDS}")


def init_layer(gen: torch.Generator, cfg: ModelConfig, spec: LayerSpec,
               device) -> dict:
    _check_kind(spec)
    d = cfg.d_model
    p = {"norm1": L.init_norm(d, cfg.norm, device)}
    if spec.kind in ("mamba", "mamba_attn"):
        p["ssm"] = S.init_ssm(gen, cfg, device)
        return p
    if spec.kind == "rwkv":
        p["tm"] = R.init_rwkv_time_mix(gen, cfg, device)
        p["norm2"] = L.init_norm(d, cfg.norm, device)
        p["cm"] = R.init_rwkv_channel_mix(gen, cfg, device)
        return p
    p["attn"] = A.init_attention(gen, cfg, device)
    p["norm2"] = L.init_norm(d, cfg.norm, device)
    if spec.kind == "attn_moe":
        p["moe"] = M.init_moe(gen, cfg, device)
    else:
        p["mlp"] = M.init_mlp(gen, cfg, device)
    if spec.kind == "cross_attn":
        # xgate starts at 0: tanh(0) = 0, cross-attention adds nothing
        # until the gate is trained (or seeded) away from it
        p["xattn"] = A.init_attention(gen, cfg, device)
        p["norm_x"] = L.init_norm(d, cfg.norm, device)
        p["xgate"] = torch.zeros((), dtype=torch.float32, device=device)
    if cfg.post_norm:       # gemma2: a norm on each sublayer's output
        p["post1"] = L.init_norm(d, cfg.norm, device)
        p["post2"] = L.init_norm(d, cfg.norm, device)
    return p


def init_shared_attn(gen: torch.Generator, cfg: ModelConfig,
                     device) -> dict:
    """zamba2: one attention + MLP block shared by every mamba_attn
    position."""
    return {"norm1": L.init_norm(cfg.d_model, cfg.norm, device),
            "attn": A.init_attention(gen, cfg, device),
            "norm2": L.init_norm(cfg.d_model, cfg.norm, device),
            "mlp": M.init_mlp(gen, cfg, device)}


def init_layer_cache(cfg: ModelConfig, spec: LayerSpec, batch: int,
                     max_len: int, dtype, device) -> Any:
    """The layer's decode state: an attention layer's cache, a mamba
    layer's ``SSMState`` (a mamba_attn layer's paired with the shared
    block's cache of ``max_len`` positions), an rwkv layer's
    ``RWKVState``. A windowed layer's cache holds ``min(max_len, window)``
    rows, the size the reference allocates, and is a ring at any
    ``max_len`` (``models.attention.is_ring``); an unwindowed layer's
    holds ``max_len``."""
    _check_kind(spec)
    if spec.kind in ("mamba", "mamba_attn"):
        ssm = S.init_ssm_state(cfg, batch, dtype, device)
        if spec.kind == "mamba_attn":
            return (ssm, A.init_cache(cfg, batch, max_len, dtype, device))
        return ssm
    if spec.kind == "rwkv":
        return R.init_rwkv_state(cfg, batch, dtype, device)
    return A.init_cache(cfg, batch, cache_rows(spec, max_len), dtype, device)


def cache_rows(spec: LayerSpec, max_len: int) -> int:
    """Rows of an attention layer's cache: a windowed layer's ring keeps
    the last ``window`` positions."""
    return min(max_len, spec.window) if spec.window else max_len


def _residual(x: Tensor, delta: Tensor, p: dict, cfg: ModelConfig,
              post_key: str) -> Tensor:
    if cfg.post_norm and post_key in p:
        delta = L.apply_norm(delta, p[post_key], cfg.norm)
    return x + delta


def _cross(x: Tensor, h: Tensor, p: dict) -> Tensor:
    """The gated cross-attention residual x + tanh(xgate) * h."""
    return x + torch.tanh(p["xgate"]).to(x.dtype) * h


def apply_layer(x: Tensor, p: dict, cfg: ModelConfig, spec: LayerSpec, *,
                shared: Optional[dict] = None,
                cross_src: Optional[Tensor] = None,
                causal: bool = True) -> tuple[Tensor, Tensor]:
    """Prefill / ``forward`` of one layer. Returns (x, aux_loss): the aux
    loss is an attn_moe layer's router load-balance loss, else 0. MoE runs
    the scan over experts, or the capacity dispatch under a mesh
    (``_apply_moe_dispatch``). ``shared`` is
    zamba2's shared block, which every mamba_attn layer runs;
    ``cross_src`` (B, S, d) the tokens a cross_attn layer attends to (the
    layer skips its cross-attention without them, as the reference's)."""
    _check_kind(spec)
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    if spec.kind in ("mamba", "mamba_attn"):
        h = L.apply_norm(x, p["norm1"], cfg.norm)
        x = x + S.apply_ssm(h, p["ssm"], cfg)
        if spec.kind == "mamba_attn":
            assert shared is not None, "mamba_attn needs the shared block"
            h = L.apply_norm(x, shared["norm1"], cfg.norm)
            x = x + A.attend(h, shared["attn"], cfg, causal=causal)
            h = L.apply_norm(x, shared["norm2"], cfg.norm)
            x = x + M.apply_mlp(h, shared["mlp"], cfg)
        return x, aux
    if spec.kind == "rwkv":
        h = L.apply_norm(x, p["norm1"], cfg.norm)
        y, _, _ = R.apply_time_mix(h, p["tm"], cfg)
        x = x + y
        h = L.apply_norm(x, p["norm2"], cfg.norm)
        y, _ = R.apply_channel_mix(h, p["cm"], cfg)
        return x + y, aux
    h = L.apply_norm(x, p["norm1"], cfg.norm)
    h = A.attend(h, p["attn"], cfg, window=spec.window, causal=causal)
    x = _residual(x, h, p, cfg, "post1")
    if spec.kind == "cross_attn" and cross_src is not None:
        h = L.apply_norm(x, p["norm_x"], cfg.norm)
        x = _cross(x, A.attend(h, p["xattn"], cfg, kv_src=cross_src,
                               causal=False), p)
    h = L.apply_norm(x, p["norm2"], cfg.norm)
    if spec.kind == "attn_moe":
        h, aux = _apply_moe_dispatch(h, p["moe"], cfg)
    else:
        h = M.apply_mlp(h, p["mlp"], cfg)
    x = _residual(x, h, p, cfg, "post2")
    return x, aux


def _apply_moe_dispatch(h: Tensor, p: dict, cfg: ModelConfig
                        ) -> tuple[Tensor, Tensor]:
    """The dense scan, or the capacity dispatch (``dist.moe_ep``) when a
    mesh is active and the config opts in (``moe_impl == "capacity"``),
    as the reference's (an abstract stand-in mesh takes the scan)."""
    if cfg.moe_impl == "capacity":
        from repro_torch.dist.compat import DeviceMesh
        from repro_torch.dist.constrain import _context_mesh
        from repro_torch.dist.moe_ep import apply_moe_capacity
        mesh = _context_mesh()
        if isinstance(mesh, DeviceMesh):
            return apply_moe_capacity(h, p, cfg, mesh)
    return M.apply_moe(h, p, cfg)


def decode_layer(x: Tensor, cache: Any, p: dict, cfg: ModelConfig,
                 spec: LayerSpec, *, shared: Optional[dict] = None,
                 cross_kv: Optional[tuple] = None) -> tuple[Tensor, Any]:
    """Single-token decode step of one layer (an attn_moe layer runs the
    scan over experts and drops its aux loss). Attention writes its K/V
    into ``cache`` in place; a recurrent layer returns NEW state tensors
    (``SSMState``, ``RWKVState``), which a caller holding fixed buffers
    copies back (``ServeEngine``). ``cross_kv`` is a cross_attn layer's
    precomputed source (K, V)."""
    _check_kind(spec)
    if spec.kind in ("mamba", "mamba_attn"):
        ssm_state, kv = cache if spec.kind == "mamba_attn" else (cache, None)
        h = L.apply_norm(x, p["norm1"], cfg.norm)
        y, ssm_state = S.decode_ssm(h, ssm_state, p["ssm"], cfg)
        x = x + y
        if spec.kind == "mamba":
            return x, ssm_state
        assert shared is not None, "mamba_attn needs the shared block"
        h = L.apply_norm(x, shared["norm1"], cfg.norm)
        y, kv = A.decode_attend(h, kv, shared["attn"], cfg)
        x = x + y
        h = L.apply_norm(x, shared["norm2"], cfg.norm)
        return x + M.apply_mlp(h, shared["mlp"], cfg), (ssm_state, kv)
    if spec.kind == "rwkv":
        h = L.apply_norm(x, p["norm1"], cfg.norm)
        y, wkv, last_tm = R.apply_time_mix(h, p["tm"], cfg, state=cache)
        x = x + y
        h = L.apply_norm(x, p["norm2"], cfg.norm)
        y, last_cm = R.apply_channel_mix(h, p["cm"], cfg,
                                         prev=cache.shift_cm)
        return x + y, R.RWKVState(
            wkv=wkv, shift_tm=last_tm.to(cache.shift_tm.dtype),
            shift_cm=last_cm.to(cache.shift_cm.dtype),
            length=cache.length + 1)
    h = L.apply_norm(x, p["norm1"], cfg.norm)
    h, cache = A.decode_attend(h, cache, p["attn"], cfg, window=spec.window)
    x = _residual(x, h, p, cfg, "post1")
    if spec.kind == "cross_attn" and cross_kv is not None:
        h = L.apply_norm(x, p["norm_x"], cfg.norm)
        x = _cross(x, A.cross_attend_cached(h, cross_kv, p["xattn"], cfg), p)
    h = L.apply_norm(x, p["norm2"], cfg.norm)
    if spec.kind == "attn_moe":
        h, _ = M.apply_moe(h, p["moe"], cfg)
    else:
        h = M.apply_mlp(h, p["mlp"], cfg)
    return _residual(x, h, p, cfg, "post2"), cache
