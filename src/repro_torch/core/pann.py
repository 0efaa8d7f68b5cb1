"""Section 5: PANN weight quantization (Eq. 12) and the bit-plane view of
the integer codes — the serving subset of ``repro.core.pann``.

Weights are quantized with step gamma_w = ||w||_1 / (R d), and the
non-negative halves of the unsigned split are stored as binary planes,
w_q = sum_k 2^k B_k. A rung of the serving ladder is a view that drops the
low ``shift`` planes of the one max-R store (``masked_codes``).
"""
from __future__ import annotations

import math
from typing import Optional, Tuple

import torch

Tensor = torch.Tensor


def pann_gamma(w: Tensor, r: float, dim: int = 0, eps: float = 1e-12
               ) -> Tensor:
    """gamma_w = ||w||_1 / (R d) over the fan-in dimension ``dim``
    (keepdim). The fp32 sum runs in torch's order, not XLA's, so gamma may
    differ from the JAX package's in the last bits."""
    d = w.shape[dim]
    l1 = torch.sum(torch.abs(w), dim=dim, keepdim=True)
    # a tensor divisor keeps the division IEEE on CUDA, where torch turns
    # division by a Python scalar into a multiply by its reciprocal
    return torch.clamp(l1, min=eps) / l1.new_full((), r * d)


def pann_quantize(w: Tensor, r: float, dim: int = 0
                  ) -> Tuple[Tensor, Tensor]:
    """Eq. (12): Q(w) = round(w / gamma_w). Returns (float-typed signed
    integer codes, gamma)."""
    gamma = pann_gamma(w, r, dim)
    return torch.round(w / gamma), gamma


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
    wi = w_q_nonneg.to(torch.int32)
    return torch.stack([((wi >> k) & 1).to(torch.int8)
                        for k in range(n_planes)])


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
