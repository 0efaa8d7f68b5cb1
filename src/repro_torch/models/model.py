"""Top-level model (port of ``repro.models.model``): parameter init,
``forward`` (prefill / evaluation over whole sequences) and decode
(``init_decode_state``, ``decode_step``) for the decoder-only configs.

Parameters are a plain dict: {"embed": {"table"}, "layers": [one dict per
layer], "final_norm": {"scale"[, "bias"]}, "lm_head": {"w"}}; a config with
tied embeddings has no "lm_head" and unembeds through the table, and a
hybrid config (zamba2) adds "shared_attn", the attention + MLP block every
mamba_attn layer runs. A weight store's views and a single-point serving
artifact have the same structure with quantized projection leaves.
"""
from __future__ import annotations

from typing import Any, NamedTuple, Optional

import torch

from repro_torch.configs.base import ModelConfig
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
    return params


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
    ``remat`` is accepted and inert: there is no backward pass to
    checkpoint until training is ported (ROADMAP A8), which brings
    ``calib`` too; ``enc_inputs`` / ``image_embeds`` come with the
    encoder-decoder and vision configs (ROADMAP A6)."""
    if calib:
        raise ValueError("calib (activation-range calibration) is not "
                         "ported: it comes with training (ROADMAP A8)")
    if enc_inputs is not None or image_embeds is not None:
        raise ValueError("enc_inputs / image_embeds are not ported: they "
                         "come with the encoder-decoder and vision configs "
                         "(ROADMAP A6)")
    specs = layer_specs(cfg)
    for spec in specs:
        T._require_ported(spec)
    x = L.embed(tokens, params["embed"], _dtype(cfg))
    if cfg.scale_embed:
        x = x * embed_scale(cfg)
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    shared = params.get("shared_attn")
    for spec, lp in zip(specs, params["layers"]):
        x, a = T.apply_layer(x, lp, cfg, spec, shared=shared)
        aux = aux + a
    return ForwardOut(logits=_head(x, params, cfg), aux_loss=aux)


class DecodeState(NamedTuple):
    caches: list           # one cache (or recurrent state) per layer
    position: Tensor       # () int32


def init_decode_state(params: dict, cfg: ModelConfig, batch: int,
                      max_len: int) -> DecodeState:
    dev = params["embed"]["table"].device
    caches = [T.init_layer_cache(cfg, spec, batch, max_len, _dtype(cfg), dev)
              for spec in layer_specs(cfg)]
    return DecodeState(caches=caches,
                       position=torch.zeros((), dtype=torch.int32,
                                            device=dev))


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
    new_caches: list[Any] = []
    for spec, lp, cache in zip(layer_specs(cfg), params["layers"],
                               state.caches):
        x, c = T.decode_layer(x, cache, lp, cfg, spec, shared=shared)
        new_caches.append(c)
    return _head(x, params, cfg), DecodeState(
        caches=new_caches, position=state.position + 1)
