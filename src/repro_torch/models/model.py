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

import contextlib
import functools
from typing import Any, NamedTuple, Optional

import torch
import torch.nn.functional as F
from torch.utils import checkpoint as _ckpt

from repro_torch.configs.base import ModelConfig
from repro_torch.core import calibrate as CAL
from repro_torch.dist import constrain as C
from repro_torch.dist import local_ops
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
    carried across with ``repro_torch.convert`` where they must match).
    ``device="meta"`` gives the tree's shapes without any storage."""
    dev = resolve_device(device)
    # on "meta" (shapes only, no values) the generator lives on the host
    gen = torch.Generator(device=dev if dev.type != "meta" else "cpu")
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
                cross_src: Optional[Tensor] = None, group: int = 0,
                calib: Optional[dict] = None, remat: bool = False) -> tuple:
    """Run a stack of layers; returns (x, the summed aux loss, the observed
    activation ranges or None).

    The stack runs as the reference scans it: groups of ``group`` layers
    (the config's repeating pattern), then the tail layers. With ``calib``
    (a ``core.calibrate`` collection) each group runs under a tap of its
    own that quantizes against the collection's ranges and records what
    it sees, and the tail under one more; the observations are merged
    (min/max, so the grouping does not change them). ``remat`` wraps each
    group in ``torch.utils.checkpoint`` (non-reentrant) while grad mode
    is on: backward reruns the group, tap included, and keeps none of the
    rerun's observations.
    """
    collect = bool(calib)
    group = group or len(layers)
    n_grouped = (len(layers) // group) * group
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    obs = CAL.unseen_like(calib) if collect else None

    def run(h, aux, lps, sps):
        tap_cm = L.calib_tap(calib) if collect else contextlib.nullcontext()
        with tap_cm as tap:
            for spec, lp in zip(sps, lps, strict=True):
                h, a = T.apply_layer(h, lp, cfg, spec, shared=shared,
                                     cross_src=cross_src, causal=causal)
                aux = aux + a
        return h, aux, (tap.observed if collect else {})

    bounds = [(i, i + group) for i in range(0, n_grouped, group)]
    if n_grouped < len(layers):
        bounds.append((n_grouped, len(layers)))
    for lo, hi in bounds:
        fn = functools.partial(run, lps=layers[lo:hi], sps=specs[lo:hi])
        if remat and lo < n_grouped and torch.is_grad_enabled():
            x, aux, seen = _ckpt.checkpoint(fn, x, aux, use_reentrant=False)
        else:
            x, aux, seen = fn(x, aux)
        if collect:
            obs = CAL.merge(obs, seen)
    return x, aux, obs


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


def _frontend(params: dict, cfg: ModelConfig, src: Tensor, *,
              calib: Optional[dict] = None, remat: bool = False) -> tuple:
    """Raw 4-D input through the conv stem (3-D embeddings as they are),
    then, for an encoder-decoder, the bidirectional encoder stack and
    ``enc_norm``; returns (tokens, the encoder's observed ranges or None)."""
    if cfg.conv_stem and src.ndim == 4:
        src = apply_conv_stem(params, cfg, src)
    src = src.to(_dtype(cfg))
    if cfg.family != "encdec":
        return src, None
    pattern, _, _ = T.group_layout(cfg, cfg.encoder_layers, "encoder")
    x, _, obs = _run_layers(src, params["encoder"]["layers"],
                            encoder_specs(cfg), cfg, causal=False,
                            group=len(pattern), calib=calib, remat=remat)
    return L.apply_norm(x, params["enc_norm"], cfg.norm), obs


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
    return _frontend(params, cfg, inputs)[0]


def _cross(params: dict, cfg: ModelConfig, enc_inputs, image_embeds, *,
           calib: Optional[dict] = None, remat: bool = False) -> tuple:
    """(``cross_source``'s tokens, the encoder's observed ranges or None)."""
    if cfg.family not in ("encdec", "vlm"):
        return None, None
    key = "enc_inputs" if cfg.family == "encdec" else "image_embeds"
    src = enc_inputs if cfg.family == "encdec" else image_embeds
    if src is None:
        raise ValueError(f"{cfg.family} needs its frontend: pass {key}")
    return _frontend(params, cfg, src, calib=calib, remat=remat)


def cross_source(params: dict, cfg: ModelConfig,
                 enc_inputs: Optional[Tensor] = None,
                 image_embeds: Optional[Tensor] = None
                 ) -> Optional[Tensor]:
    """The tokens the decoder's cross_attn layers attend to: the encoder's
    output over ``enc_inputs`` (encoder-decoder) or ``image_embeds``
    (vision), raw 4-D input through the conv stem first; None for a
    decoder-only config (which ignores both, as the reference does)."""
    return _cross(params, cfg, enc_inputs, image_embeds)[0]


class ForwardOut(NamedTuple):
    logits: Tensor
    aux_loss: Tensor
    # observed activation ranges ({path: [lo, hi]}, core/calibrate.py) when
    # the caller passed a calibration collection; None otherwise
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
    encoder-decoder / vision config (``cross_source``). ``remat``
    checkpoints each layer group for backward (``_run_layers``).
    ``calib``: an EMA activation-range collection (``core.calibrate``):
    the quantizers use its ranges, and ``ForwardOut.calib`` reports the
    ranges this pass observed (the encoder's, the decoder's and the
    head's, merged)."""
    collect = bool(calib)
    x = C.constrain_batch(L.embed(tokens, params["embed"], _dtype(cfg)))
    if cfg.scale_embed:
        x = x * embed_scale(cfg)
    obs = CAL.unseen_like(calib) if collect else None
    src, enc_obs = _cross(params, cfg, enc_inputs, image_embeds,
                          calib=calib, remat=remat)
    if enc_obs is not None:
        obs = CAL.merge(obs, enc_obs)
    pattern, _, _ = T.group_layout(cfg)
    x, aux, dec_obs = _run_layers(
        x, params["layers"], layer_specs(cfg), cfg, causal=True,
        shared=params.get("shared_attn"), cross_src=src,
        group=len(pattern), calib=calib, remat=remat)
    if collect:
        obs = CAL.merge(obs, dec_obs)
        with L.calib_tap(calib) as tap:
            logits = _head(x, params, cfg)
        obs = CAL.merge(obs, tap.observed)
    else:
        logits = _head(x, params, cfg)
    return ForwardOut(logits=logits, aux_loss=aux, calib=obs)


def lm_loss(params: dict, cfg: ModelConfig, tokens: Tensor, labels: Tensor,
            *, enc_inputs=None, image_embeds=None, remat: bool = True,
            aux_weight: float = 0.01, calib: Optional[dict] = None,
            return_calib: bool = False):
    """Mean next-token NLL over the labels >= 0 (a label of -1, the end of
    each row, is masked out), plus ``aux_weight`` times the MoE
    load-balance loss. The gather clamps the -1 labels to 0 first (torch
    refuses a negative index where ``jnp.take_along_axis`` takes it); the
    mask removes them after, as the reference's does."""
    out = forward(params, cfg, tokens, enc_inputs=enc_inputs,
                  image_embeds=image_embeds, remat=remat, calib=calib)
    logp = F.log_softmax(out.logits, dim=-1)
    idx = torch.clamp(labels, min=0).to(torch.int64)
    nll = -torch.gather(logp, -1, idx[..., None])[..., 0]
    mask = (labels >= 0).to(torch.float32)
    loss = torch.sum(nll * mask) / torch.clamp(torch.sum(mask), min=1.0)
    loss = loss + aux_weight * out.aux_loss
    if return_calib:
        return loss, out.calib
    return loss


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


def frontend_cross_kv(params: dict, cfg: ModelConfig,
                      enc_inputs: Optional[Tensor] = None,
                      image_embeds: Optional[Tensor] = None
                      ) -> Optional[list]:
    """``project_cross`` of ``cross_source``: per layer the cross (K, V)
    of a frontend input, None for a decoder-only config. Under a serving
    mesh (``dist.local_ops.use_shards``) the input is the whole batch's,
    as every rank holds it: the rank's rows run through the stem (whole
    on every rank) and the encoder (the rank's heads), and each pair holds
    the rank's rows and KV heads."""
    shards = local_ops.current_shards()
    if shards is not None:
        enc_inputs, image_embeds = (None if t is None else shards.own_rows(t)
                                    for t in (enc_inputs, image_embeds))
    src = cross_source(params, cfg, enc_inputs, image_embeds)
    return None if src is None else project_cross(params, cfg, src)


def init_decode_state(params: dict, cfg: ModelConfig, batch: int,
                      max_len: int, *, enc_inputs: Optional[Tensor] = None,
                      image_embeds: Optional[Tensor] = None
                      ) -> DecodeState:
    """Empty caches and, for a cross-attending config, its source run
    through the frontend (``cross_source``: the stem, the encoder) and
    projected to each cross_attn layer's K/V once, at ``params``' view
    (``frontend_cross_kv``; under a serving mesh ``batch`` is the rank's
    rows and the frontend input the whole batch's)."""
    dev = params["embed"]["table"].device
    caches = [T.init_layer_cache(cfg, spec, batch, max_len, _dtype(cfg), dev)
              for spec in layer_specs(cfg)]
    return DecodeState(
        caches=caches,
        cross_kv=frontend_cross_kv(params, cfg, enc_inputs, image_embeds),
        position=torch.zeros((), dtype=torch.int32, device=dev))


def embed_scale(cfg: ModelConfig) -> float:
    """gemma2's embedding multiplier: sqrt(d_model) rounded to the compute
    dtype first, as the reference's ``jnp.asarray(d ** 0.5, dtype)``
    (a host scalar, so a captured graph holds no host-to-device copy)."""
    return torch.tensor(cfg.d_model ** 0.5, dtype=_dtype(cfg)).item()


def _decode_head(x: Tensor, params: dict, cfg: ModelConfig) -> Tensor:
    """``_head`` of a decode step. Under a serving mesh the batch rows are
    gathered over "data" first (every rank runs the head on the whole
    batch, as one rank does, so each output column is the one-rank
    column), each rank computes its vocab columns, and the columns are
    gathered over "model": the whole (B, 1, V) logits on every rank."""
    shards = local_ops.current_shards()
    if shards is None:
        return _head(x, params, cfg)
    with local_ops.whole_rows():
        logits = _head(shards.gather_rows(x), params, cfg)
    return shards.gather_model(logits)


def decode_step(params: dict, cfg: ModelConfig, state: DecodeState,
                tokens: Tensor) -> tuple[Tensor, DecodeState]:
    """tokens: (B, 1) -> (logits (B, 1, V), new state). Attention caches
    are updated in place (``models.attention``); the recurrent layers'
    states (``ssm.SSMState``, ``rwkv.RWKVState``) come back as new
    tensors in the new state.

    Under a serving mesh (``dist.local_ops.use_shards``: ``params`` the
    rank's shards, ``cfg`` its head counts, ``state`` its heads and batch
    rows) the tokens and the logits are the whole batch's: the step embeds
    the rank's rows (the reference's batch constraint) and gathers the
    logits (``_decode_head``)."""
    dtype = _dtype(cfg)
    shards = local_ops.current_shards()
    x = L.embed(tokens if shards is None else tokens[shards.rows],
                params["embed"], dtype)
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
    return _decode_head(x, params, cfg), DecodeState(
        caches=new_caches, cross_kv=state.cross_kv,
        position=state.position + 1)
