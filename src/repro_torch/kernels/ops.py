"""The kernel API (port of ``repro.kernels.ops``): one PANN linear deployed
as "quantize, then multiply codes", the unfused path beside the serving
dispatch.

* ``quantize_act``: per-row half-range unsigned codes of activations with
  any leading dims (B7).
* ``unsigned_matmul``: the Sec.-4 W+/W- split product on int8 codes (B6).
* ``pann_pack_weights``: PANN-quantize a weight, unsigned-split it, and
  decompose both halves into bit-planes.
* ``pann_matmul``: the end-to-end PANN linear through the fused
  act-quant prologue kernel (B1) in its 'fused' or 'planes' mode, with the
  per-tensor (s, z) and the int32 ``zcol`` zero-point row of the serving
  dispatch.

The inputs' device decides: CPU tensors run the kernels' plain versions,
CUDA tensors launch the kernels or raise. Shapes are padded only where a
kernel needs it (N to a multiple of 4), and the result sliced back; the
padding runs on every device, so the CPU tests reach it.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.core import pann as pann_core
from repro_torch.core import quant
from repro_torch.core.unsigned import unsigned_split
from repro_torch.kernels import pann_matmul as _pm
from repro_torch.kernels import quantize_act as _qa
from repro_torch.kernels import unsigned_matmul as _um

Tensor = torch.Tensor

_N_MULT = 4      # the kernels' threads own 4 adjacent output columns


def _pad_to(x: Tensor, mult: int, dim: int) -> Tensor:
    """Zero-pad ``dim`` of x up to a multiple of ``mult``."""
    pad = (-x.shape[dim]) % mult
    if pad == 0:
        return x
    widths = [0, 0] * (x.ndim - dim % x.ndim)
    widths[-1] = pad
    return F.pad(x, widths)


def quantize_act(x: Tensor, bits: int = 8) -> tuple[Tensor, Tensor]:
    """Per-row unsigned activation quantization. x (..., K) float32 or
    bfloat16 -> (codes (..., K) int8, scales (..., 1) float32)."""
    lead = x.shape[:-1]
    q, s = _qa.quantize_act(x.reshape(-1, x.shape[-1]).contiguous(),
                            bits=bits)
    return q.reshape(*lead, -1), s.reshape(*lead, 1)


def unsigned_matmul(x_q: Tensor, w_q: Tensor, s_x: Tensor, s_w: Tensor
                    ) -> Tensor:
    """Sec.-4 split matmul on integer codes: x_q (M, K) int8 >= 0, w_q (K,
    N) int8, s_x (M, 1), s_w of N elements -> (M, N) float32."""
    n = w_q.shape[1]
    wp = _pad_to(w_q, _N_MULT, 1).contiguous()
    swp = _pad_to(s_w.reshape(-1).to(torch.float32), _N_MULT, 0)
    y = _um.unsigned_matmul(x_q.contiguous(), wp,
                            s_x.to(torch.float32).contiguous(), swp)
    return y[:, :n]


def pann_pack_weights(w: Tensor, r: float, dim=0) -> dict:
    """Offline packing: PANN-quantize (Eq. 12, fan-in ``dim``), unsigned
    split, bit-plane decompose. The deployment artifact of ``pann_matmul``:
    planes_pos/planes_neg (P, K, N) int8, gamma (N,) f32, n_planes, r."""
    w_q, gamma = pann_core.pann_quantize(w, r, dim)
    pos, neg = unsigned_split(w_q)
    n_planes = pann_core.weight_storage_bits(w_q)
    return {
        "planes_pos": pann_core.bitplane_decompose(pos, n_planes),
        "planes_neg": pann_core.bitplane_decompose(neg, n_planes),
        "gamma": gamma.reshape(-1),
        "n_planes": n_planes,
        "r": r,
    }


def act_operands(x: Tensor, packed: dict, act_bits: int = 8) -> tuple:
    """The B1 operands of ``pann_matmul``: (x f32, planes_pos, planes_neg,
    qparams [s, z, n, 0], gamma, zcol), N padded to a multiple of 4. (s, z)
    are the serving dispatch's include-zero range and ``affine_scale_zp``
    with levels capped at 127; zcol = z * colsum(w_q), w_q rebuilt from the
    planes."""
    xf = x.to(torch.float32).contiguous()
    pos, neg = packed["planes_pos"], packed["planes_neg"]
    n_lvl = xf.new_full((), float(quant.cap_levels(int(act_bits))))
    lo, hi = quant.act_range_bounds(xf, include_zero=True)
    s, z = quant.affine_scale_zp(lo, hi, n_lvl)
    w_q = _pm.rebuild_weight(pos, neg)
    zcol = z.to(torch.int32) * torch.sum(w_q, dim=0, dtype=torch.int32)
    qparams = torch.stack([s, z, n_lvl, torch.zeros_like(s)])
    return (xf, _pad_to(pos, _N_MULT, 2).contiguous(),
            _pad_to(neg, _N_MULT, 2).contiguous(), qparams,
            _pad_to(packed["gamma"].to(torch.float32), _N_MULT, 0),
            _pad_to(zcol, _N_MULT, 0))


def pann_matmul(x: Tensor, packed: dict, act_bits: int = 8,
                mode: str = "fused") -> Tensor:
    """End-to-end PANN linear through the fused act-quant prologue: x (M, K)
    float, ``packed`` from ``pann_pack_weights`` -> (M, N) float32. The
    activations are affine-encoded inside the kernel against one per-tensor
    (s, z); ``mode`` is 'fused' or 'planes'."""
    n = packed["planes_pos"].shape[2]
    y = _pm.pann_matmul_act(*act_operands(x, packed, act_bits), mode=mode)
    return y[:, :n]
