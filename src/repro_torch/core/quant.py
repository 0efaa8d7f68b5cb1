"""The quantizers of the serving and fake-quant paths (port of
``repro.core.quant``): RUQ, the regular uniform quantizer (absmax scale,
integer codes) and its straight-through fake-quant, and the affine
activation quantizer (calibration bounds, (s, z) scalars, level counts,
the encode map and the whole quantizer over the tensor's own or a frozen
range), and the training quantizers: the clip-calibrated quantizer and
LSQ, the learned step size, whose step gradient is a custom backward.

Every op here is a single correctly rounded fp32 operation (max, min,
subtract, divide, round half to even, clamp), so the port and the JAX
package give the same bits on the same inputs. ``torch.round`` rounds half
to even like ``jnp.round``; ``floor(x + 0.5)`` would not. Divisors are
device tensors: on CUDA torch turns division by a Python scalar into a
multiply by its reciprocal.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import torch

Tensor = torch.Tensor


@dataclasses.dataclass(frozen=True)
class QRange:
    """Integer code range [qmin, qmax]."""
    qmin: int
    qmax: int

    @property
    def n_levels(self) -> int:
        return self.qmax - self.qmin + 1


def qrange(bits: int, signed: bool, half_range: bool = False) -> QRange:
    """Code range of a ``bits``-wide quantizer; ``half_range`` is the
    paper's App. A.4 convention for unsigned values on signed hardware,
    [0, 2^(b-1))."""
    if signed:
        return QRange(-(1 << (bits - 1)), (1 << (bits - 1)) - 1)
    if half_range:
        return QRange(0, (1 << (bits - 1)) - 1)
    return QRange(0, (1 << bits) - 1)


def _reduce_dims(x: Tensor, dim) -> tuple:
    """The dims a per-tensor (None) or per-``dim`` reduction runs over."""
    if dim is None:
        return tuple(range(x.ndim))
    if isinstance(dim, int):
        dim = (dim,)
    return tuple(d % x.ndim for d in dim)


def ruq_scale(x: Tensor, bits: int, signed: bool, dim=None,
              half_range: bool = False, eps: float = 1e-12) -> Tensor:
    """Per-tensor (``dim=None``) or per-``dim`` absmax scale (keepdim):
    ``max(amax, eps) / qmax``, amax of |x| (signed) or of relu(x)."""
    qr = qrange(bits, signed, half_range)
    dims = _reduce_dims(x, dim)
    a = torch.abs(x) if signed else torch.clamp(x, min=0.0)
    amax = torch.amax(a, dim=dims, keepdim=True)
    return torch.clamp(amax, min=eps) / amax.new_full((), float(qr.qmax))


def quantize(x: Tensor, scale: Tensor, qr: QRange) -> Tensor:
    """Reals to integer codes (round half to even, clip), float-typed."""
    return torch.clamp(torch.round(x / scale), qr.qmin, qr.qmax)


def dequantize(q: Tensor, scale: Tensor) -> Tensor:
    return q * scale


def ruq(x: Tensor, bits: int, signed: bool, dim=None,
        scale: Optional[Tensor] = None, half_range: bool = False
        ) -> Tuple[Tensor, Tensor]:
    """Quantize to integer codes, returning (float-typed codes, scale)."""
    qr = qrange(bits, signed, half_range)
    if scale is None:
        scale = ruq_scale(x, bits, signed, dim, half_range)
    return quantize(x, scale, qr), scale


def fake_quant(x: Tensor, bits: int, signed: bool, dim=None,
               scale: Optional[Tensor] = None, half_range: bool = False
               ) -> Tensor:
    """Straight-through fake quantization: the forward is
    dequant(quant(x)), the gradient w.r.t. x is the identity."""
    q, s = ruq(x, bits, signed, dim, scale, half_range)
    xq = dequantize(q, s)
    return x + (xq - x).detach()


def affine_quant_levels(x: Tensor, n, include_zero: bool = False
                        ) -> Tuple[Tensor, Tensor, Tensor]:
    """Asymmetric quantization over the tensor's own extremes:
    x ~ s * (q - z), q in [0, n]. Returns (q, s, z), q float-typed exact
    integers. ``include_zero`` extends the range to contain 0 (what the
    integer backends need); the fp fake-quant paths keep the unextended
    range."""
    lo, hi = act_range_bounds(x, include_zero=include_zero)
    return _affine_from_bounds(x, n, lo, hi)


def act_range_bounds(x: Tensor, lo: Optional[Tensor] = None,
                     hi: Optional[Tensor] = None, include_zero: bool = True
                     ) -> Tuple[Tensor, Tensor]:
    """Calibration range [lo, hi] of the affine quantizer, as 0-dim tensors
    on ``x``'s device.

    Without ``lo``/``hi``: the tensor's own extremes, optionally extended to
    contain 0. With them: the frozen range, zero-extended when seen; an
    unseen range (lo > hi) falls back to the dynamic extremes WITHOUT the
    zero extension (``repro.core.quant.act_range_bounds``).
    """
    x_lo, x_hi = torch.aminmax(x)
    if lo is None:
        if include_zero:
            x_lo = torch.clamp(x_lo, max=0.0)
            x_hi = torch.clamp(x_hi, min=0.0)
        return x_lo, x_hi
    lo = torch.as_tensor(lo, dtype=x.dtype, device=x.device)
    hi = torch.as_tensor(hi, dtype=x.dtype, device=x.device)
    use = lo <= hi
    if include_zero:
        lo = torch.clamp(lo, max=0.0)
        hi = torch.clamp(hi, min=0.0)
    return torch.where(use, lo, x_lo), torch.where(use, hi, x_hi)


def affine_scale_zp(lo: Tensor, hi: Tensor, n) -> Tuple[Tensor, Tensor]:
    """(s, z) for calibration bounds [lo, hi] and ``n`` levels:
    ``s = max((hi - lo) / n, 1e-12)``, ``z = round(-lo / s)`` — the op
    sequence of ``repro.core.quant.affine_scale_zp``."""
    s = torch.clamp((hi - lo) / n, min=1e-12)
    z = torch.round(-lo / s)
    return s, z


def cap_levels(bits: int, cap: int = 127) -> int:
    """Serving level count of a ``bits``-wide unsigned code: 2^b - 1,
    capped so codes stay int8-safe."""
    return min((1 << int(bits)) - 1, cap)


def _n_tensor(n, like: Tensor) -> Tensor:
    """A level count as a 0-dim fp32 tensor on ``like``'s device, so the
    divisions by it stay IEEE on CUDA."""
    if isinstance(n, Tensor):
        return n.to(device=like.device, dtype=torch.float32).reshape(())
    return like.new_full((), float(n), dtype=torch.float32)


def affine_encode(x: Tensor, s, z, n) -> Tensor:
    """``clip(round(x / s) + z, 0, n)`` as float-typed exact integers. The
    CUDA matmul kernels inline this op sequence (``rintf(x / s) + z``, IEEE
    division); change both or neither."""
    q = torch.round(x / s) + z
    if isinstance(n, Tensor):
        return torch.minimum(torch.clamp(q, min=0.0), n)
    return torch.clamp(q, 0.0, float(n))


def _affine_from_bounds(x: Tensor, n, lo: Tensor, hi: Tensor
                        ) -> Tuple[Tensor, Tensor, Tensor]:
    n = _n_tensor(n, x)
    s, z = affine_scale_zp(lo, hi, n)
    return affine_encode(x, s, z, n), s, z


def affine_from_range(x: Tensor, n, lo, hi, include_zero: bool = True
                      ) -> Tuple[Tensor, Tensor, Tensor]:
    """``affine_quant_levels`` against an explicit calibration range
    [lo, hi]: a seen range is zero-extended (``include_zero``), an unseen
    one (lo > hi, the calibration sentinel) falls back to the tensor's
    dynamic extremes WITHOUT the zero extension."""
    lo, hi = act_range_bounds(x, lo, hi, include_zero=include_zero)
    return _affine_from_bounds(x, n, lo, hi)


# ---------------------------------------------------------------------------
# Clip-calibrated quantization (ACIQ-style)
# ---------------------------------------------------------------------------

def _linspace(start: float, stop: float, num: int, like: Tensor) -> Tensor:
    """``num`` points over [start, stop] as ``jnp.linspace`` forms them in
    fp32: start * (1 - i/d) + stop * (i/d), the last point ``stop``."""
    d = num - 1
    step = (torch.arange(d, dtype=torch.float32, device=like.device)
            / like.new_full((), float(d), dtype=torch.float32))
    lo = like.new_full((), start, dtype=torch.float32)
    hi = like.new_full((), stop, dtype=torch.float32)
    return torch.cat([lo * (1 - step) + hi * step, hi.reshape(1)])


def calibrate_clip(x: Tensor, bits: int, signed: bool,
                   n_grid: int = 64) -> Tensor:
    """The clipping threshold c that minimizes the quantization MSE of ``x``
    over a grid of ``n_grid`` ratios of its absmax (the data-driven
    analogue of ACIQ); the quantizer then uses scale = c / qmax."""
    qr = qrange(bits, signed)
    xf = x.to(torch.float32)
    amax = torch.amax(torch.abs(xf)) if signed else \
        torch.amax(torch.clamp(xf, min=0.0))
    ratios = _linspace(0.05, 1.0, n_grid, xf)
    qdiv = xf.new_full((), float(max(-qr.qmin, qr.qmax) if signed
                                 else qr.qmax))
    mses = []
    for ratio in ratios:
        s = torch.clamp(amax * ratio / qdiv, min=1e-12)
        xq = dequantize(quantize(xf, s, qr), s)
        mses.append(torch.mean((xf - xq) ** 2))
    return amax * ratios[torch.argmin(torch.stack(mses))]


def clip_quant(x: Tensor, bits: int, signed: bool, clip: Tensor
               ) -> Tuple[Tensor, Tensor]:
    """Quantize with a pre-calibrated clip value: (codes, scale)."""
    qr = qrange(bits, signed)
    clip = torch.as_tensor(clip, dtype=torch.float32, device=x.device)
    s = torch.clamp(clip / clip.new_full((), float(qr.qmax)), min=1e-12)
    return quantize(x, s, qr), s


# ---------------------------------------------------------------------------
# LSQ — learned step size quantization (Esser et al. 2019)
# ---------------------------------------------------------------------------

class _LSQ(torch.autograd.Function):
    """The reference's ``jax.custom_vjp``: forward clip(round(x/step)) *
    step; backward ``_lsq_bwd``."""

    @staticmethod
    def forward(ctx, x, step, qmin, qmax):
        v = x / step
        q = torch.clamp(torch.round(v), qmin, qmax)
        ctx.save_for_backward(v, q)
        ctx.qmin, ctx.qmax, ctx.n = qmin, qmax, x.numel()
        ctx.step_shape = step.shape
        return q * step

    @staticmethod
    def backward(ctx, g):
        v, q = ctx.saved_tensors
        qmin, qmax = ctx.qmin, ctx.qmax
        in_range = (v >= qmin) & (v <= qmax)
        dx = torch.where(in_range, g, torch.zeros_like(g))
        # d(out)/d(step): q - v inside the range, the rails outside
        dstep_elem = torch.where(in_range, q - v, torch.clamp(v, qmin, qmax))
        grad_scale = 1.0 / torch.sqrt(g.new_full(
            (), ctx.n * float(qmax if qmax > 0 else 1), dtype=torch.float32))
        dstep = torch.sum(g * dstep_elem) * grad_scale
        return dx, dstep.reshape(ctx.step_shape), None, None


def lsq_quant(x: Tensor, step: Tensor, qmin: int, qmax: int) -> Tensor:
    """LSQ fake-quant with the paper's gradient w.r.t. the step size: the
    in-range mask passes g to x; the step gets sum(g * (q - v)) inside the
    range and the rails outside, scaled by 1/sqrt(n * qmax)."""
    return _LSQ.apply(x, step, qmin, qmax)


def lsq_init_step(x: Tensor, bits: int, signed: bool) -> Tensor:
    """LSQ step initialization: 2<|x|>/sqrt(qmax)."""
    qr = qrange(bits, signed)
    qp = max(qr.qmax, 1)
    return 2.0 * torch.mean(torch.abs(x)) / torch.sqrt(
        x.new_full((), float(qp), dtype=torch.float32))
