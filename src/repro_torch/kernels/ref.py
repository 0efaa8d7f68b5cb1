"""Oracles of the kernels (port of ``repro.kernels.ref``): the matmul and
quantizer oracles, the packed bit-plane KV-cache codec and the
decode-attention oracle.

``quantize_act_ref`` and ``decode_attention_ref`` are also the plain PyTorch
versions of their CUDA kernels (``kernels/quantize_act``,
``kernels/pann_attention``): they run on CPU tensors, and on the card they
are what the kernels are held against. Integer passes run in fp64 (torch
has no int32 matmul on CUDA); every partial sum is an integer below 2^53,
so they are exact.
"""
from __future__ import annotations

import torch

Tensor = torch.Tensor


def int_matmul(a: Tensor, b: Tensor) -> Tensor:
    """Exact integer a @ b (fp64, every partial sum below 2^53) -> int32."""
    return torch.matmul(a.double(), b.double()).to(torch.int32)


def pann_matmul_ref(x_q: Tensor, planes_pos: Tensor, planes_neg: Tensor,
                    s_x: Tensor, gamma: Tensor) -> Tensor:
    """Oracle of the bit-plane matmuls on codes: rebuild the signed integer
    weights from the planes, integer matmul, (y * s_x) * gamma in fp32."""
    # one plane at a time: a (P, K, N) int32 transient would not fit at the
    # lm_head's width
    w_q = torch.zeros(planes_pos.shape[1:], dtype=torch.int32,
                      device=planes_pos.device)
    for p in range(planes_pos.shape[0]):
        w_q += (1 << p) * (planes_pos[p].to(torch.int32)
                           - planes_neg[p].to(torch.int32))
    y = int_matmul(x_q, w_q)
    return y.to(torch.float32) * s_x * gamma.reshape(1, -1)


def quantize_act_ref(x: Tensor, bits: int = 8) -> tuple[Tensor, Tensor]:
    """Oracle of ``quantize_act``: per-row half-range unsigned codes (int8)
    and scales (M, 1) fp32, ``scale = max(amax(relu x), 1e-12) / qmax`` as
    an IEEE division (a device-tensor divisor: on CUDA torch turns division
    by a Python scalar into a multiply by its reciprocal)."""
    qmax = (1 << (bits - 1)) - 1
    xp = torch.clamp(x.to(torch.float32), min=0.0)
    amax = torch.amax(xp, dim=1, keepdim=True)
    scale = torch.clamp(amax, min=1e-12) / xp.new_full((), float(qmax))
    q = torch.clamp(torch.round(xp / scale), 0, qmax).to(torch.int8)
    return q, scale


def unsigned_matmul_ref(x_q: Tensor, w_q: Tensor, s_x: Tensor, s_w: Tensor
                        ) -> Tensor:
    """Oracle of ``unsigned_matmul``: plain signed integer matmul, then
    (y * s_x) * s_w in fp32."""
    y = int_matmul(x_q, w_q)
    return y.to(torch.float32) * s_x * s_w.reshape(1, -1)

# The cache layout pins this many bit-planes whatever the rung's cache bits
# are (unsigned affine codes are clipped to n <= 127 = 2^7 - 1).
CACHE_PLANES = 7

# Probabilities are re-quantized to this fixed-point scale for the exact
# integer PV pass: sum_s p = 1 bounds pq @ vq by about 127 * 2^14.
PROB_SCALE = float(1 << 14)

_CACHE_NEG_INF = -1e30   # matches models.attention.NEG_INF


def pack_cache_codes(codes: Tensor, n_planes: int = CACHE_PLANES) -> Tensor:
    """Pack unsigned codes (..., d) in [0, 2^n_planes) into bit-planes of 8
    bits/byte along the LAST axis: (n_planes, ..., d//8) uint8. Byte j of
    plane p holds bit p of elements 8j..8j+7, element 8j+i at bit i."""
    d = codes.shape[-1]
    if d % 8:
        raise ValueError(f"cache codec packs along head_dim; {d} % 8 != 0")
    c = codes.to(torch.int32)
    shifts = torch.arange(n_planes, dtype=torch.int32, device=c.device)
    planes = (c[None] >> shifts.reshape((n_planes,) + (1,) * c.ndim)) & 1
    bits = planes.reshape(planes.shape[:-1] + (d // 8, 8))
    weights = 1 << torch.arange(8, dtype=torch.int32, device=c.device)
    return torch.sum(bits * weights, dim=-1).to(torch.uint8)


def unpack_cache_codes(packed: Tensor) -> Tensor:
    """Inverse of :func:`pack_cache_codes`: (P, ..., d//8) uint8 ->
    (..., d) int32."""
    p = packed.shape[0]
    dev = packed.device
    bits = (packed[..., None].to(torch.int32)
            >> torch.arange(8, dtype=torch.int32, device=dev)) & 1
    bits = bits.reshape(packed.shape[:-1] + (packed.shape[-1] * 8,))
    weights = (1 << torch.arange(p, dtype=torch.int32, device=dev)).reshape(
        (p,) + (1,) * (packed.ndim - 1))
    return torch.sum(bits * weights, dim=0, dtype=torch.int32)


def _exact_int(a: Tensor) -> Tensor:
    """fp64 holding exact integers -> int32."""
    return a.to(torch.int32)


def decode_attention_ref(qq: Tensor, q_z: Tensor, q_scale: Tensor,
                         k_planes: Tensor, k_s: Tensor, k_z: Tensor,
                         v_planes: Tensor, v_s: Tensor, v_z: Tensor,
                         pos: Tensor, *, window=None, softcap: float = 0.0,
                         prob_scale: float = PROB_SCALE) -> Tensor:
    """One-token GQA decode attention read off the packed bit-plane cache.

    Shapes as in ``repro.kernels.ref.decode_attention_ref``: qq (B, K, G,
    hd) int32 affine q codes with zero point ``q_z`` (0-dim); ``q_scale`` =
    s_q * hd**-0.5 (0-dim fp32); k/v_planes (B, P, S, K, hd//8) uint8;
    k_s/k_z/v_s/v_z (B, S) fp32 rows (z integer-valued); pos 0-dim int32.

    The integer passes are exact. The fp32 epilogue is the JAX oracle's op
    sequence with one change: the softmax denominator is summed in fp64
    and rounded once to fp32, so that this function and the CUDA kernel
    (which sums in its own order) round to the same fp32 value.
    """
    b, kh, g, hd = qq.shape
    s = k_planes.shape[2]
    dev = qq.device
    kq = unpack_cache_codes(k_planes.movedim(1, 0))         # (B, S, K, hd)
    vq = unpack_cache_codes(v_planes.movedim(1, 0))
    qq = qq.to(torch.int32)
    qz = q_z.to(torch.int32)
    kz = torch.round(k_z).to(torch.int32)                   # (B, S)
    vz = torch.round(v_z).to(torch.int32)
    # exact integer QK^T with BOTH zero points corrected in the accumulator
    dots = _exact_int(torch.einsum("bkgh,bskh->bkgs", qq.double(),
                                   kq.double()))
    colsum_k = torch.sum(kq, dim=-1, dtype=torch.int32)     # (B, S, K)
    rowsum_q = torch.sum(qq, dim=-1, dtype=torch.int32)     # (B, K, G)
    kz_b = kz[:, None, None, :]
    i32 = (dots
           - qz * colsum_k.movedim(1, -1)[:, :, None, :]
           - kz_b * rowsum_q[..., None]
           + qz * kz_b * hd)
    sc = (i32.to(torch.float32) * q_scale) * k_s[:, None, None, :]
    if softcap > 0:
        cap = torch.full((), float(softcap), dtype=torch.float32, device=dev)
        sc = cap * torch.tanh(sc / cap)
    pos_b = pos.to(torch.int32).reshape(-1).expand(b)
    k_pos = torch.arange(s, dtype=torch.int32, device=dev)
    valid = k_pos[None, :] <= pos_b[:, None]                # (B, S)
    if window is not None:
        valid &= (pos_b[:, None] - k_pos[None, :]) < window
    sc = torch.where(valid[:, None, None, :], sc,
                     torch.full((), _CACHE_NEG_INF, device=dev))
    m = torch.amax(sc, dim=-1, keepdim=True)
    p = torch.exp(sc - m)
    p = p / torch.sum(p.double(), dim=-1, keepdim=True).to(torch.float32)
    # exact integer PV: probs rescaled into V's largest valid scale,
    # re-quantized at prob_scale, V zero point subtracted in-accumulator
    sv_ref = torch.clamp(torch.amax(torch.where(valid, v_s,
                                                torch.zeros_like(v_s)),
                                    dim=-1), min=1e-12)     # (B,)
    ratio = v_s / sv_ref[:, None]
    pq = torch.round(p * ratio[:, None, None, :] * prob_scale
                     ).to(torch.int32)                      # (B, K, G, S)
    pv = _exact_int(torch.einsum("bkgs,bskh->bkgh", pq.double(),
                                 vq.double()))
    corr = _exact_int(torch.einsum("bkgs,bs->bkg", pq.double(),
                                   vz.double()))
    scale = sv_ref / torch.full((), prob_scale, device=dev)
    return ((pv - corr[..., None]).to(torch.float32)
            * scale[:, None, None, None])
