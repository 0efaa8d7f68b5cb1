"""Top-level model (port of ``repro.models.model``): parameter init,
``forward`` (prefill / evaluation over whole sequences), ``encode`` (the
frontend alone) and decode (``init_decode_state``, ``decode_step``) for
every architecture.

Parameters are a plain dict: {"embed": {"table"}, "layers": [one dict per
layer], "final_norm": {"scale"[, "bias"]}, "lm_head": {"w"}}; a config with
tied embeddings has no "lm_head" and unembeds through the table, and a
hybrid config (zamba2) adds "shared_attn", the attention + MLP block every
mamba_attn layer runs. An encoder-decoder config adds "encoder":
{"layers": [...]} (bidirectional attention blocks) and "enc_norm"; a
config with a conv stem adds "conv_stem": {"s0": {"w", "b"}, ...}, each
kernel flat as (kh*kw*c_in, c_out). A weight store's views and a
single-point serving artifact have the same structure with quantized
projection leaves.

The cross-attending families take their source as ``enc_inputs``
(encoder-decoder) or ``image_embeds`` (vision): (B, S, d) stub embeddings,
or raw 4-D frontend input that runs through the conv stem first.
"""
from __future__ import annotations

from typing import Any, NamedTuple, Optional

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models import attention as A
from repro_torch.models import layers as L
from repro_torch.models import transformer as T

Tensor = torch.Tensor


def resolve_device(device) -> torch.device:
    """The device an entry point runs on. 'cuda' without a card raises: the
    CPU is used only when the caller asks for it."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "device 'cuda' requested but torch.cuda.is_available() is False; "
            "pass device='cpu' to run the plain PyTorch versions on the CPU")
    return dev


def _dtype(cfg: ModelConfig):
    return torch.bfloat16 if cfg.dtype == "bfloat16" else torch.float32


def layer_specs(cfg: ModelConfig) -> list:
    """The LayerSpec of every layer, in order (groups then tail)."""
    pattern, n_groups, n_tail = T.group_layout(cfg)
    return list(pattern) * n_groups + [pattern[i] for i in range(n_tail)]


def encoder_specs(cfg: ModelConfig) -> list:
    """The LayerSpec of every encoder layer (none without an encoder)."""
    pattern, n_groups, n_tail = T.group_layout(cfg, cfg.encoder_layers,
                                               "encoder")
    return list(pattern) * n_groups + [pattern[i] for i in range(n_tail)]


def _cross_layers(cfg: ModelConfig) -> list:
    """Per layer: does decode hand it a cross (K, V) pair? The cross_attn
    layers of the full groups; a tail layer gets none (as the
    reference's decode, whose tail loop passes no cross K/V)."""
    pattern, n_groups, _ = T.group_layout(cfg)
    grouped = n_groups * len(pattern)
    return [spec.kind == "cross_attn" and i < grouped
            for i, spec in enumerate(layer_specs(cfg))]


def init_params(cfg: ModelConfig, seed: int = 0, device="cuda") -> dict:
    """Random fp32 parameters from ``seed`` (a torch.Generator on the
    device; the values differ from the JAX package's, whose params are
    carried across with ``repro_torch.convert`` where they must match)."""
    dev = resolve_device(device)
    gen = torch.Generator(device=dev)
    gen.manual_seed(int(seed))
    params = {
        "embed": L.init_embedding(gen, cfg.padded_vocab, cfg.d_model, dev),
        "layers": [T.init_layer(gen, cfg, spec, dev)
                   for spec in layer_specs(cfg)],
        "final_norm": L.init_norm(cfg.d_model, cfg.norm, dev),
    }
    if not cfg.tie_embeddings:
        params["lm_head"] = L.init_linear(gen, cfg.d_model, cfg.padded_vocab,
                                          dev, scale=0.02)
    if cfg.family == "hybrid":
        params["shared_attn"] = T.init_shared_attn(gen, cfg, dev)
    if cfg.family == "encdec":
        params["encoder"] = {"layers": [T.init_layer(gen, cfg, spec, dev)
                                        for spec in encoder_specs(cfg)]}
        params["enc_norm"] = L.init_norm(cfg.d_model, cfg.norm, dev)
    if cfg.conv_stem:
        # dict keys, so a module's trail ends in "s{i}" and the serving
        # path resolves to the per-depth "conv.s{i}" policy role
        params["conv_stem"] = {f"s{i}": L.init_conv(gen, spec, dev)
                               for i, spec in enumerate(cfg.conv_stem)}
    return params


def _run_layers(x: Tensor, layers: list, specs: list, cfg: ModelConfig, *,
                causal: bool, shared: Optional[dict] = None,
                cross_src: Optional[Tensor] = None) -> tuple:
    """Run a stack of layers; returns (x, the summed aux loss)."""
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    for spec, lp in zip(specs, layers, strict=True):
        x, a = T.apply_layer(x, lp, cfg, spec, shared=shared,
                             cross_src=cross_src, causal=causal)
        aux = aux + a
    return x, aux


def apply_conv_stem(params: dict, cfg: ModelConfig, raw: Tensor) -> Tensor:
    """Raw frontend input through the conv stem: (B, H, W, C) pixels
    (vision) or (B, frames, 1, mels) features (speech) -> (B, tokens,
    c_out) flattened row-major over (H, W). Each layer is a conv
    projection (``layers.apply_conv``); ReLU between layers, none after
    the last."""
    x = raw
    last = len(cfg.conv_stem) - 1
    for i, spec in enumerate(cfg.conv_stem):
        x = L.apply_conv(x, params["conv_stem"][f"s{i}"], cfg, spec,
                         f"conv.s{i}")
        if i < last:
            x = torch.relu(x)
    b, h, w, c = x.shape
    return x.reshape(b, h * w, c)


def _frontend_tokens(params: dict, cfg: ModelConfig, src: Tensor) -> Tensor:
    """Raw 4-D input through the conv stem (3-D embeddings as they are),
    then, for an encoder-decoder, the bidirectional encoder stack and
    ``enc_norm``."""
    if cfg.conv_stem and src.ndim == 4:
        src = apply_conv_stem(params, cfg, src)
    src = src.to(_dtype(cfg))
    if cfg.family != "encdec":
        return src
    x, _ = _run_layers(src, params["encoder"]["layers"], encoder_specs(cfg),
                       cfg, causal=False)
    return L.apply_norm(x, params["enc_norm"], cfg.norm)


def encode(params: dict, cfg: ModelConfig, inputs: Tensor) -> Tensor:
    """The whole-sequence encode path (no cache). ``inputs``: raw 4-D
    (B, H, W, C) frontend input when the config has a conv stem, else
    (B, T, d_model) stub embeddings. Returns (B, T, d_model): for an
    encoder-decoder the stem, the encoder stack and ``enc_norm`` (the
    cross-attention source); for a vision config the stem alone (the image
    tokens its decoder cross-attends to)."""
    if cfg.conv_stem and inputs.ndim != 4:
        raise ValueError(f"conv_stem set: encode() wants raw (B, H, W, C), "
                         f"got {tuple(inputs.shape)}")
    return _frontend_tokens(params, cfg, inputs)


def cross_source(params: dict, cfg: ModelConfig,
                 enc_inputs: Optional[Tensor] = None,
                 image_embeds: Optional[Tensor] = None
                 ) -> Optional[Tensor]:
    """The tokens the decoder's cross_attn layers attend to: the encoder's
    output over ``enc_inputs`` (encoder-decoder) or ``image_embeds``
    (vision), raw 4-D input through the conv stem first; None for a
    decoder-only config (which ignores both, as the reference does)."""
    if cfg.family not in ("encdec", "vlm"):
        return None
    key = "enc_inputs" if cfg.family == "encdec" else "image_embeds"
    src = enc_inputs if cfg.family == "encdec" else image_embeds
    if src is None:
        raise ValueError(f"{cfg.family} needs its frontend: pass {key}")
    return _frontend_tokens(params, cfg, src)


class ForwardOut(NamedTuple):
    logits: Tensor
    aux_loss: Tensor
    # the observed activation ranges of a calibration pass: always None
    # until calibration is ported (ROADMAP A8)
    calib: Optional[dict] = None


def _head(x: Tensor, params: dict, cfg: ModelConfig) -> Tensor:
    """Final norm, the LM head (tied through ``unembed``, untied through
    ``project``) and the logit softcap; fp32 logits."""
    x = L.apply_norm(x, params["final_norm"], cfg.norm)
    if cfg.tie_embeddings:
        logits = L.unembed(x, params["embed"], L.module_quant(cfg, "lm_head"))
    else:
        logits = L.project(x, params["lm_head"], cfg, "lm_head")
    return L.softcap(logits.to(torch.float32), cfg.logit_softcap)


def forward(params: dict, cfg: ModelConfig, tokens: Tensor, *,
            enc_inputs: Optional[Tensor] = None,
            image_embeds: Optional[Tensor] = None,
            remat: bool = True, calib: Optional[dict] = None) -> ForwardOut:
    """tokens: (B, T) int -> logits (B, T, V) fp32, causal, through every
    layer. ``params`` are fp params (each projection through ``qlinear``
    at its quant mode) or a serving artifact or rung view (through
    ``cfg.kernel_backend``, or the legacy float dequant without one).
    ``enc_inputs`` / ``image_embeds``: the cross-attention source of an
    encoder-decoder / vision config (``cross_source``). ``remat`` is
    accepted and inert: there is no backward pass to checkpoint until
    training is ported (ROADMAP A8), which brings ``calib`` too."""
    if calib:
        raise ValueError("calib (activation-range calibration) is not "
                         "ported: it comes with training (ROADMAP A8)")
    x = L.embed(tokens, params["embed"], _dtype(cfg))
    if cfg.scale_embed:
        x = x * embed_scale(cfg)
    src = cross_source(params, cfg, enc_inputs, image_embeds)
    x, aux = _run_layers(x, params["layers"], layer_specs(cfg), cfg,
                         causal=True, shared=params.get("shared_attn"),
                         cross_src=src)
    return ForwardOut(logits=_head(x, params, cfg), aux_loss=aux)


class DecodeState(NamedTuple):
    caches: list           # one cache (or recurrent state) per layer
    # per layer, the cross (K, V) pair of a cross_attn layer (None for the
    # others); None for a config without cross-attention
    cross_kv: Optional[list]
    position: Tensor       # () int32


def project_cross(params: dict, cfg: ModelConfig,
                  src: Tensor) -> list:
    """Per layer, the (K, V) of ``src`` through a cross_attn layer's
    ``xattn`` (projected once, read by every decode step), else None."""
    return [A.project_cross_kv(src, lp["xattn"], cfg) if cross else None
            for lp, cross in zip(params["layers"], _cross_layers(cfg))]


def init_decode_state(params: dict, cfg: ModelConfig, batch: int,
                      max_len: int, *, enc_inputs: Optional[Tensor] = None,
                      image_embeds: Optional[Tensor] = None
                      ) -> DecodeState:
    """Empty caches and, for a cross-attending config, its source run
    through the frontend (``cross_source``: the stem, the encoder) and
    projected to each cross_attn layer's K/V once, at ``params``' view."""
    dev = params["embed"]["table"].device
    caches = [T.init_layer_cache(cfg, spec, batch, max_len, _dtype(cfg), dev)
              for spec in layer_specs(cfg)]
    src = cross_source(params, cfg, enc_inputs, image_embeds)
    return DecodeState(
        caches=caches,
        cross_kv=None if src is None else project_cross(params, cfg, src),
        position=torch.zeros((), dtype=torch.int32, device=dev))


def embed_scale(cfg: ModelConfig) -> float:
    """gemma2's embedding multiplier: sqrt(d_model) rounded to the compute
    dtype first, as the reference's ``jnp.asarray(d ** 0.5, dtype)``
    (a host scalar, so a captured graph holds no host-to-device copy)."""
    return torch.tensor(cfg.d_model ** 0.5, dtype=_dtype(cfg)).item()


def decode_step(params: dict, cfg: ModelConfig, state: DecodeState,
                tokens: Tensor) -> tuple[Tensor, DecodeState]:
    """tokens: (B, 1) -> (logits (B, 1, V), new state). Attention caches
    are updated in place (``models.attention``); the recurrent layers'
    states (``ssm.SSMState``, ``rwkv.RWKVState``) come back as new
    tensors in the new state."""
    dtype = _dtype(cfg)
    x = L.embed(tokens, params["embed"], dtype)
    if cfg.scale_embed:
        x = x * embed_scale(cfg)
    shared = params.get("shared_attn")
    specs = layer_specs(cfg)
    cross = state.cross_kv or [None] * len(specs)
    new_caches: list[Any] = []
    for spec, lp, cache, ckv in zip(specs, params["layers"], state.caches,
                                    cross, strict=True):
        x, c = T.decode_layer(x, cache, lp, cfg, spec, shared=shared,
                              cross_kv=ckv)
        new_caches.append(c)
    return _head(x, params, cfg), DecodeState(
        caches=new_caches, cross_kv=state.cross_kv,
        position=state.position + 1)
