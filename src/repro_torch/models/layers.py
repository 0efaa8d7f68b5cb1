"""Shared layers (port of ``repro.models.layers``): norms, the embedding
gather and the tied head, logit soft-capping, the affine activation
fake-quant, ``qlinear`` (the quantization modes none / ruq / ruq_unsigned /
pann as fake-quant projections) and the projection choke point
``apply_linear``, which routes fp params through ``qlinear``, a serving
artifact through ``kernels.dispatch`` or, without a backend, through the
legacy float dequant; the activation-range calibration tap of QAT
(``calib_tap``, ``calib_suspend``); and the conv stem's layers
(``init_conv``, ``apply_conv``: im2col over the same choke point).

Parameters are plain dicts of tensors, laid out as in the JAX package so
the two can be compared leaf for leaf.
"""
from __future__ import annotations

import contextlib
from typing import Optional

import torch

from repro_torch.core import pann as pann_core
from repro_torch.core import quant
from repro_torch.dist import compat as dist_compat
from repro_torch.dist import local_ops
from repro_torch.kernels import dispatch
from repro_torch.kernels import pann_conv as _pc

Tensor = torch.Tensor


def rmsnorm(x: Tensor, scale: Tensor, eps: float = 1e-6) -> Tensor:
    var = torch.mean(torch.square(x.to(torch.float32)), dim=-1, keepdim=True)
    y = x * torch.rsqrt(var + eps)
    return (y * (1.0 + scale)).to(x.dtype)


def layernorm(x: Tensor, scale: Tensor, bias: Tensor,
              eps: float = 1e-5) -> Tensor:
    """The reference's op order: fp32 mean, biased variance,
    rsqrt(var + eps), then y * scale + bias."""
    xf = x.to(torch.float32)
    mu = torch.mean(xf, dim=-1, keepdim=True)
    var = torch.mean(torch.square(xf - mu), dim=-1, keepdim=True)
    y = (xf - mu) * torch.rsqrt(var + eps)
    return (y * scale + bias).to(x.dtype)


def apply_norm(x: Tensor, params: dict, kind: str) -> Tensor:
    shards = local_ops.current_shards()
    if shards is not None:      # a data rank's rows at the batch's shape
        return shards.at_batch_shape(
            lambda h: _apply_norm(h, params, kind), x)
    return _apply_norm(x, params, kind)


def _apply_norm(x: Tensor, params: dict, kind: str) -> Tensor:
    if kind == "layernorm":
        return layernorm(x, params["scale"], params["bias"])
    return rmsnorm(x, params["scale"])


def init_norm(d: int, kind: str, device) -> dict:
    if kind == "layernorm":
        return {"scale": torch.ones((d,), dtype=torch.float32, device=device),
                "bias": torch.zeros((d,), dtype=torch.float32,
                                    device=device)}
    return {"scale": torch.zeros((d,), dtype=torch.float32, device=device)}


def softcap(x: Tensor, cap: float) -> Tensor:
    """Gemma-2 logit soft-capping: cap * tanh(x / cap)."""
    if cap <= 0:
        return x
    return cap * torch.tanh(x / x.new_full((), float(cap)))


# ---------------------------------------------------------------------------
# Asymmetric (zero-point) activation fake-quant
# ---------------------------------------------------------------------------

def affine_act_quant(x: Tensor, bits: int):
    """x ~= s * (q - z), q unsigned in [0, 2^b - 1]. Returns (q, s, z)."""
    return quant.affine_quant_levels(x, (1 << bits) - 1)


def affine_fake_quant(x: Tensor, bits: int) -> Tensor:
    q, s, z = affine_act_quant(x, bits)
    xq = s * (q - z)
    return x + (xq - x).detach()


def affine_fake_quant_n(x: Tensor, n: Tensor) -> Tensor:
    """``affine_fake_quant`` with the level count n = 2^b - 1 given as a
    device tensor (a serving artifact's ``act_n`` leaf)."""
    xf = x.to(torch.float32)
    q, s, z = quant.affine_quant_levels(xf, n)
    return (s * (q - z)).to(x.dtype)


def affine_fake_quant_ranged(x: Tensor, bits: int, rng: Tensor) -> Tensor:
    """``affine_fake_quant`` against a calibrated range rng = [lo, hi]
    (STE); an unseen range (lo > hi) is bit-exact with
    ``affine_fake_quant``."""
    xf = x.to(torch.float32)
    q, s, z = quant.affine_from_range(xf, float((1 << bits) - 1),
                                      rng[0], rng[1])
    xq = s * (q - z)
    return xf + (xq - xf).detach()


# ---------------------------------------------------------------------------
# Activation-range calibration tap (QAT observers; core/calibrate.py)
# ---------------------------------------------------------------------------

class CalibTap:
    """An activation observer for one scope of the forward.

    While installed (``calib_tap``), every ``qlinear`` call that names its
    module path (a) records the per-tensor min/max of its input under that
    path into ``observed`` (detached: observations carry no gradient) and
    (b) quantizes against the calibrated range in ``ranges`` (the dynamic
    range while a role is unseen). ``models.model`` installs one per layer
    group, inside the function that ``torch.utils.checkpoint`` recomputes,
    and returns the observations as that function's outputs: a recompute
    during backward installs and removes a tap of its own, and its
    observations are dropped with the rest of the recomputed outputs.
    """

    __slots__ = ("ranges", "observed")

    def __init__(self, ranges):
        self.ranges = ranges or {}
        self.observed: dict[str, Tensor] = {}

    def observe(self, path: str, x: Tensor) -> None:
        with torch.no_grad():
            lo, hi = torch.aminmax(x.detach().to(torch.float32))
            rec = torch.stack([lo, hi])
            prev = self.observed.get(path)
            if prev is not None:
                rec = torch.stack([torch.minimum(prev[0], rec[0]),
                                   torch.maximum(prev[1], rec[1])])
        self.observed[path] = rec

    def range_for(self, path: str) -> Optional[Tensor]:
        rng = self.ranges.get(path)
        return None if rng is None else rng.detach()


_TAPS: list = []


@contextlib.contextmanager
def calib_tap(ranges):
    """Install an activation observer for the enclosed scope."""
    tap = CalibTap(ranges)
    _TAPS.append(tap)
    try:
        yield tap
    finally:
        _TAPS.pop()


@contextlib.contextmanager
def calib_suspend():
    """Mask the active tap for the enclosed scope. The MoE expert loop runs
    under it, as the reference's inner scan does: its projections keep
    dynamic per-tensor ranges and their roles stay unseen, so export leaves
    them dynamic too."""
    _TAPS.append(None)
    try:
        yield
    finally:
        _TAPS.pop()


def _active_tap() -> Optional[CalibTap]:
    return _TAPS[-1] if _TAPS else None


def _act_fake_quant(x: Tensor, bits: int, path: Optional[str]) -> Tensor:
    """The activation side of ``qlinear`` at 'ruq': dynamic per-tensor
    fake-quant, or observed and against the calibrated range when a tap is
    installed and the call names its module path."""
    xf = x.to(torch.float32)
    tap = _active_tap()
    if tap is not None and path is not None:
        tap.observe(path, xf)
        rng = tap.range_for(path)
        if rng is not None:
            return affine_fake_quant_ranged(xf, bits, rng)
    return affine_fake_quant(xf, bits)


# ---------------------------------------------------------------------------
# QuantLinear
# ---------------------------------------------------------------------------

def module_quant(cfg, path: str):
    """The quant spec of the module at ``path``: the global ``cfg.quant``,
    or the policy tree's entry when the config carries one."""
    if cfg.policy is None:
        return cfg.quant
    return cfg.policy.lookup(path)


def qlinear(x: Tensor, w: Tensor, b: Optional[Tensor], qc,
            path: Optional[str] = None) -> Tensor:
    """y = quant(x) @ quant(w) + b at ``qc.mode`` (a ``QuantConfig`` or a
    per-module ``policy.ModuleQuant``), every mode a fake-quant so the same
    code serves evaluation and straight-through training. x (..., d_in),
    w (d_in, d_out). 'ruq_unsigned' is numerically 'ruq' (the unsigned
    split is exact; it differs in power accounting only). ``path`` names
    the module: with a calibration tap installed its input range is
    observed and the calibrated range drives the activation quantizer;
    without one the path is inert."""
    mode = qc.mode
    dtype = x.dtype
    if mode == "none":
        y = x @ w
    elif mode in ("ruq", "ruq_unsigned"):
        wq = quant.fake_quant(w.to(torch.float32), qc.weight_bits,
                              signed=True, dim=0).to(dtype)
        xq = _act_fake_quant(x, qc.act_bits, path).to(dtype)
        y = xq @ wq
    elif mode == "pann":
        tap = _active_tap()
        rng = None
        if tap is not None and path is not None:
            tap.observe(path, x)
            rng = tap.range_for(path)
        y = pann_core.pann_qat_matmul(x, w, qc, act_range=rng)
    else:
        raise ValueError(f"unknown quant mode {mode!r}")
    if b is not None:
        y = y + b
    return y


def project(x: Tensor, p: dict, cfg, path: str) -> Tensor:
    """The one-call projection idiom: every model projection goes through
    here with the configured kernel backend."""
    return apply_linear(x, p, module_quant(cfg, path),
                        backend=cfg.kernel_backend, path=path)


def init_linear(gen: torch.Generator, d_in: int, d_out: int, device,
                bias: bool = False, scale: Optional[float] = None) -> dict:
    scale = scale if scale is not None else d_in ** -0.5
    p = {"w": torch.randn((d_in, d_out), generator=gen, dtype=torch.float32,
                          device=device) * scale}
    if bias:
        p["b"] = torch.zeros((d_out,), dtype=torch.float32, device=device)
    return p


def apply_linear(x: Tensor, p: dict, qc=None, backend: Optional[str] = None,
                 path: Optional[str] = None) -> Tensor:
    """The projection entry point. fp params ({"w"}) route through
    ``qlinear`` at ``qc``'s mode; a serving artifact ({"w_q", ...})
    through the kernel backend (``kernels.dispatch``: 'ref' | 'fused' |
    'packed'), or, when ``backend`` is None, through the legacy float
    dequant: w = w_q * w_scale, the activations fake-quantized against the
    frozen range of ``act_lo``/``act_hi``, at ``act_n`` levels over their
    own range, or not at all."""
    shards = local_ops.current_shards()
    row = shards is not None and shards.model > 1 \
        and local_ops.row_parallel(path)
    if row:     # a whole input cut to the rank's K rows
        x = shards.k_rows(x, (p["w_q"] if "w_q" in p else p["w"]).shape[0])
    if "w_q" in p and backend is not None:
        return dispatch.serving_linear(x, p, backend, path)
    b = p.get("b")
    b = None if b is None else b.to(x.dtype)
    if row:
        # a row-parallel shard's float partial product (the dry run's
        # decode on fp params): summed over "model", the bias added once
        y = _linear(x, p, qc, None, path)
        shards.sum_model(y)
        return y if b is None else y + b
    return _linear(x, p, qc, b, path)


def _linear(x: Tensor, p: dict, qc, b, path) -> Tensor:
    """``apply_linear``'s float branches: the legacy dequant of an artifact
    without a backend, or ``qlinear`` on fp params."""
    if "w_q" in p:
        w = (p["w_q"].to(torch.float32) * p["w_scale"]).to(x.dtype)
        if "act_lo" in p:
            xf = x.to(torch.float32)
            q, s, z = quant.affine_from_range(xf, p["act_n"], p["act_lo"],
                                              p["act_hi"])
            x = (s * (q - z)).to(x.dtype)
        elif "act_n" in p:
            x = affine_fake_quant_n(x, p["act_n"])
        y = x @ w
        return y if b is None else y + b
    return qlinear(x, p["w"].to(x.dtype), b, qc, path=path)


# ---------------------------------------------------------------------------
# Conv stem (modality frontend)
# ---------------------------------------------------------------------------

def init_conv(gen: torch.Generator, spec, device) -> dict:
    """One conv-stem layer, the kernel stored flat as a (kh*kw*c_in, c_out)
    matrix (``kernels.pann_conv``'s layout), so the quantizers, the weight
    store and its rung views see a linear of fan-in kh*kw*c_in; the bias
    starts at zero."""
    return {"w": torch.randn((spec.fan_in, spec.c_out), generator=gen,
                             dtype=torch.float32, device=device)
            * spec.fan_in ** -0.5,
            "b": torch.zeros((spec.c_out,), dtype=torch.float32,
                             device=device)}


def apply_conv(x: Tensor, p: dict, cfg, spec, path: str) -> Tensor:
    """Conv projection through the same choke point as every linear. x:
    (B, H, W, C) raw frontend input. A serving artifact with a backend goes
    through ``dispatch.serving_conv``; fp params through the same im2col
    (pad, patches) and ``apply_linear`` at the module's quant mode."""
    if "w_q" in p and cfg.kernel_backend is not None:
        return dispatch.serving_conv(x, p, spec, cfg.kernel_backend)
    xpad = _pc.pad_nhwc(x.to(torch.float32), spec.ph, spec.pw)
    patches = _pc.extract_patches(xpad, spec.kh, spec.kw, spec.sh, spec.sw)
    b, ho, wo, _ = patches.shape
    flat = patches.reshape(b * ho * wo, -1).to(x.dtype)
    y = apply_linear(flat, p, module_quant(cfg, path), backend=None,
                     path=path)
    return y.reshape(b, ho, wo, spec.c_out).to(x.dtype)


def init_embedding(gen: torch.Generator, vocab: int, d: int, device) -> dict:
    return {"table": torch.randn((vocab, d), generator=gen,
                                 dtype=torch.float32, device=device) * 0.02}


def embed(tokens: Tensor, p: dict, dtype) -> Tensor:
    table = p["table"].to(dtype)
    if dist_compat.is_dtensor(table):
        # the gather's local form over a vocab-sharded table
        return local_ops.vocab_parallel_embed(table, tokens)
    shards = local_ops.current_shards()
    if shards is not None:      # the rank's vocab shard of a serving mesh
        return shards.vocab_rows(table, tokens)
    return table[tokens]


def unembed(x: Tensor, p: dict, qc) -> Tensor:
    """The tied LM head: x @ table.T through ``qlinear`` at ``qc``'s mode
    (a serve engine leaves it at "none": a float matmul over the fp32
    table the weight store keeps)."""
    return qlinear(x, p["table"].t().to(x.dtype), None, qc, path="lm_head")
