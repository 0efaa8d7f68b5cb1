"""Section 5: PANN weight quantization (Eq. 12), the bit-plane view of the
integer codes and the deployment forward through the planes — the
deployment subset of ``repro.core.pann`` and its fake-quant projection.

Weights are quantized with step gamma_w = ||w||_1 / (R d), and the
non-negative halves of the unsigned split are stored as binary planes,
w_q = sum_k 2^k B_k, so w_q^T x = sum_k 2^k (B_k^T x): every plane product
is an addition network (Eq. 10). A rung of the serving ladder is a view
that drops the low ``shift`` planes of the one max-R store
(``masked_codes``). ``pann_qat_matmul`` is the straight-through
fake-quant projection of the float path (``models.layers.qlinear``).
"""
from __future__ import annotations

import dataclasses
import math
from typing import Optional, Tuple

import torch

from repro_torch.core import quant
from repro_torch.core.unsigned import unsigned_split

Tensor = torch.Tensor


def pann_gamma(w: Tensor, r: float, dim=0, eps: float = 1e-12) -> Tensor:
    """gamma_w = ||w||_1 / (R d) over the fan-in dimension(s) ``dim``
    (keepdim; None: per tensor). The fp32 sum runs in torch's order, not
    XLA's, so gamma may differ from the JAX package's in the last bits."""
    dims = quant._reduce_dims(w, dim)
    d = math.prod(w.shape[a] for a in dims)
    l1 = torch.sum(torch.abs(w), dim=dims, keepdim=True)
    # a tensor divisor keeps the division IEEE on CUDA, where torch turns
    # division by a Python scalar into a multiply by its reciprocal
    return torch.clamp(l1, min=eps) / l1.new_full((), r * d)


def pann_quantize(w: Tensor, r: float, dim=0) -> Tuple[Tensor, Tensor]:
    """Eq. (12): Q(w) = round(w / gamma_w). Returns (float-typed signed
    integer codes, gamma)."""
    gamma = pann_gamma(w, r, dim)
    return torch.round(w / gamma), gamma


def pann_fake_quant(w: Tensor, r: float, dim=None) -> Tensor:
    """Straight-through fake quantization with the PANN step: the forward
    is round(w / gamma) * gamma, the gradient w.r.t. w the identity."""
    q, gamma = pann_quantize(w, r, dim)
    return w + (q * gamma - w).detach()


def additions_per_element(w_q: Tensor, dim=None) -> Tensor:
    """||w_q||_1 / d — the realized addition factor (should be ~R)."""
    dims = quant._reduce_dims(w_q, dim)
    d = math.prod(w_q.shape[a] for a in dims)
    return torch.sum(torch.abs(w_q), dim=dims) / w_q.new_full((), float(d))


def weight_storage_bits(w_q: Tensor) -> int:
    """b_R: bits needed to store |w_q| after the unsigned split."""
    m = int(torch.max(torch.abs(w_q)).item())
    return max(int(math.ceil(math.log2(m + 1))), 1) if m > 0 else 1


def bitplane_decompose(w_q_nonneg: Tensor, n_planes: Optional[int] = None
                       ) -> Tensor:
    """Non-negative integer weights -> (n_planes, *w.shape) int8 planes,
    plane k holding bit k, so that w_q = sum_k 2^k planes[k]."""
    if n_planes is None:
        n_planes = weight_storage_bits(w_q_nonneg)
    if n_planes > 8 or w_q_nonneg.is_floating_point():
        wi = w_q_nonneg.to(torch.int32)
        return torch.stack([((wi >> k) & 1).to(torch.int8)
                            for k in range(n_planes)])
    # planes 0..7 read only the low byte: shift and mask it as uint8 (a
    # quarter of the int32 path's bytes), each plane written in place
    w8 = (w_q_nonneg.view(torch.uint8) if w_q_nonneg.dtype == torch.int8
          else (w_q_nonneg & 0xFF).to(torch.uint8))
    out = torch.empty((n_planes, *w8.shape), dtype=torch.uint8,
                      device=w8.device)
    for k in range(n_planes):
        torch.bitwise_and(w8 >> k, 1, out=out[k])
    return out.view(torch.int8)


def truncate_codes(codes: Tensor, shift) -> Tensor:
    """Rung view of max-R signed codes: sign(c) * (|c| >> shift), int32.
    ``shift`` may be a 0-dim tensor (the view's data leaf)."""
    ci = codes.to(torch.int32)
    sh = torch.as_tensor(shift, device=ci.device).to(torch.int32)
    return (torch.clamp(ci, min=0) >> sh) - (torch.clamp(-ci, min=0) >> sh)


def masked_codes(codes: Tensor, shift) -> Tensor:
    """``truncate_codes(c, s) << s``: the integer weight a plane-skipping
    kernel realizes when it keeps the plane weights 2^p and skips planes
    p < shift. Dequantizes with the unchanged max-R gamma."""
    sh = torch.as_tensor(shift, device=codes.device).to(torch.int32)
    return truncate_codes(codes, sh) << sh


def view_shift(r_max: float, r: float, max_shift: int = 6) -> int:
    """Plane shift realizing budget ``r`` as a view over a max-``r_max``
    store: the power of two nearest r_max / r, clipped to the plane count."""
    if r <= 0 or r_max <= 0:
        raise ValueError(f"budgets must be positive: r_max={r_max}, r={r}")
    return int(min(max(round(math.log2(r_max / r)), 0), max_shift))


def snapped_r(r_max: float, shift: int) -> float:
    """The budget a ``shift``-plane view actually realizes: r_max / 2^s."""
    return float(r_max) / float(1 << int(shift))


def bitplane_matmul(x: Tensor, planes_pos: Tensor, planes_neg: Tensor,
                    out_dtype=torch.float32) -> Tensor:
    """y = x @ (W+ - W-) with W+- given as binary planes: per plane an
    addition-only pass, combined with powers of two — the multiplier-free
    dataflow of Eq. (10) with the Sec.-4 split of Eq. (5)-(6)."""
    n_planes = planes_pos.shape[0]
    weights = (2.0 ** torch.arange(n_planes, device=x.device)).to(out_dtype)
    y = torch.zeros(x.shape[:-1] + (planes_pos.shape[-1],), dtype=out_dtype,
                    device=x.device)
    for k in range(n_planes):
        pp = planes_pos[k].to(out_dtype)
        pn = planes_neg[k].to(out_dtype)
        y = y + weights[k] * (x @ pp - x @ pn)
    return y


@dataclasses.dataclass(frozen=True)
class PannWeights:
    """Deployment artifact: quantized signed codes and their step."""
    w_q: Tensor         # signed integer codes (float-typed)
    gamma: Tensor       # quantization step(s)
    r: float            # budget used


def pann_prepare(w: Tensor, r: float, dim=None) -> PannWeights:
    w_q, gamma = pann_quantize(w, r, dim)
    return PannWeights(w_q=w_q, gamma=gamma, r=r)


def pann_matmul_reference(x: Tensor, pw: PannWeights, act_bits: int,
                          act_signed: bool = False,
                          act_scale: Optional[Tensor] = None) -> Tensor:
    """Integer-exact PANN product: quantize the activations (RUQ), multiply
    by the quantized weights (the result of Eq. 11), rescale."""
    x_q, s_x = quant.ruq(x, act_bits, act_signed, scale=act_scale)
    y_int = x_q @ pw.w_q
    return y_int * s_x * pw.gamma.reshape(-1)


def pann_bitplane_linear(x: Tensor, pw: PannWeights, act_bits: int,
                         bias: Optional[Tensor] = None) -> Tensor:
    """Deployment forward through bit-planes — numerically identical to
    ``pann_matmul_reference`` (integer-exact), multiplier-free dataflow."""
    x_q, s_x = quant.ruq(x, act_bits, signed=False)
    pos, neg = unsigned_split(pw.w_q)
    n_planes = weight_storage_bits(pw.w_q)
    y_int = bitplane_matmul(x_q, bitplane_decompose(pos, n_planes),
                            bitplane_decompose(neg, n_planes))
    y = y_int * s_x * pw.gamma.reshape(-1)
    if bias is not None:
        y = y + bias
    return y


def pann_linear(x: Tensor, w: Tensor, bias: Optional[Tensor], r: float,
                act_bits: int, *, axis=0, qat: bool = False) -> Tensor:
    """Model-level PANN linear layer. ``qat=True``: the differentiable
    fake-quant path (STE on the weights and the activations);
    ``qat=False``: the same values through explicit integer codes (PTQ
    evaluation), ``(x_q @ (w_q * gamma)) * s_x``."""
    if qat:
        wq = pann_fake_quant(w, r, dim=axis)
        xq = quant.fake_quant(x, act_bits, signed=False)
        y = xq @ wq
    else:
        w_q, gamma = pann_quantize(w, r, dim=axis)
        x_q, s_x = quant.ruq(x, act_bits, signed=False)
        y = (x_q @ (w_q * gamma)) * s_x
    if bias is not None:
        y = y + bias
    return y


def pann_qat_matmul(x: Tensor, w: Tensor, mq,
                    act_range: Optional[Tensor] = None) -> Tensor:
    """The fake-quant (STE) PANN projection at one module's operating
    point: ``mq`` exposes ``.r`` and ``.act_bits_tilde`` (a per-module
    ``policy.ModuleQuant`` or the global ``QuantConfig``). Weights
    fake-quantize per output channel, activations affinely over their own
    per-tensor range, or against ``act_range`` = [lo, hi] when given
    (frozen calibration; an unseen range falls back to the dynamic one).
    Fake-quant runs in fp32, the product in the caller's dtype."""
    dtype = x.dtype
    wq = pann_fake_quant(w.to(torch.float32), mq.r, dim=0).to(dtype)
    xf = x.to(torch.float32)
    n = float((1 << mq.act_bits_tilde) - 1)
    if act_range is None:
        q, s, z = quant.affine_quant_levels(xf, n)
    else:
        q, s, z = quant.affine_from_range(xf, n, act_range[0], act_range[1])
    xq_val = s * (q - z)
    xq = (xf + (xq_val - xf).detach()).to(dtype)
    return xq @ wq
