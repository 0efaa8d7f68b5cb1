"""PANN bit-plane serving matmul on PACKED planes with the fused
activation-quant prologue (port of ``repro.kernels.pann_matmul_packed``:
``pann_matmul_packed_act``, backend 'packed', and the plane codec).

Layout: packed[p, k8, n] holds bit (k8*8 + j) of plane p in bit j — 2*P/8
bytes per weight for both signs. ``pann_matmul_packed_act`` launches the
CUDA kernel (``csrc/pann_matmul_packed.cu``) on CUDA tensors and runs
``pann_matmul_packed_act_plain`` on CPU tensors.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.core import quant
from repro_torch.kernels import build
from repro_torch.kernels.pann_matmul import (check_args, matmul_epilogue,
                                             ptr, rebuild_weight, split_k,
                                             stream_of)

Tensor = torch.Tensor

launches = 0     # kernel launches since the caller last reset it


def pack_planes(planes: Tensor) -> Tensor:
    """(..., K, N) {0,1} int8 -> (..., ceil(K/8), N) uint8, packing along
    the reduction axis -2 (K zero-padded to a multiple of 8); leading dims
    pass through. Built one output bit at a time in uint8, so the only
    transient is one (..., K/8, N) byte tensor."""
    *lead, k, n = planes.shape
    pad = (-k) % 8
    if pad:
        planes = F.pad(planes, (0, 0, 0, pad))
    bits = planes.to(torch.uint8).reshape(*lead, (k + pad) // 8, 8, n)
    out = torch.zeros((*lead, (k + pad) // 8, n), dtype=torch.uint8,
                      device=planes.device)
    for j in range(8):
        out |= bits[..., j, :] << j
    return out


def unpack_planes(packed: Tensor, k: int) -> Tensor:
    """Inverse of :func:`pack_planes`: (..., K8, N) uint8 -> (..., k, N)
    int8."""
    *lead, k8, n = packed.shape
    shifts = torch.arange(8, dtype=torch.uint8, device=packed.device)
    bits = (packed[..., :, None, :] >> shifts.reshape(8, 1)) & 1
    return bits.reshape(*lead, k8 * 8, n)[..., :k, :].to(torch.int8)


def pann_matmul_packed_act_plain(x: Tensor, packed_pos: Tensor,
                                 packed_neg: Tensor, qparams: Tensor,
                                 gamma: Tensor, zcol: Tensor) -> Tensor:
    """Plain PyTorch version of the kernel, on any device."""
    s, z, n_lvl, shift = qparams.unbind()
    k = x.shape[1]
    q = quant.affine_encode(x, s, z, n_lvl)
    w = rebuild_weight(unpack_planes(packed_pos, k),
                       unpack_planes(packed_neg, k), shift)
    return matmul_epilogue(q, w, s, gamma, zcol)


def _launcher():
    return build.entry("pann_matmul_packed", "pann_matmul_packed_act_launch",
                       (build.P,) * 8 + (build.I,) * 6 + (build.P,))


def pann_matmul_packed_act(x: Tensor, packed_pos: Tensor,
                           packed_neg: Tensor, qparams: Tensor,
                           gamma: Tensor, zcol: Tensor) -> Tensor:
    """x (M, K) f32 with K % 8 == 0; packed_pos/neg (P, K/8, N) uint8;
    qparams (4,) f32 [s, z, n_lvl, plane_shift]; gamma (N,) f32; zcol (N,)
    int32 -> (M, N) f32. CPU tensors run the plain version; CUDA tensors
    launch the kernel or raise."""
    if x.device.type == "cpu":
        return pann_matmul_packed_act_plain(x, packed_pos, packed_neg,
                                            qparams, gamma, zcol)
    if x.device.type != "cuda":
        raise ValueError(f"no kernel for device {x.device}")
    m, k = x.shape
    if k % 8:
        raise ValueError(f"K = {k} must be a multiple of 8")
    check_args(x, (packed_pos, packed_neg), torch.uint8, k // 8, qparams,
               gamma, zcol)
    p, _, n = packed_pos.shape
    ksplit, kchunk = split_k(m, k, n)
    y = torch.empty((m, n), dtype=torch.float32, device=x.device)
    partial = torch.empty((ksplit, m, n), dtype=torch.int32, device=x.device)
    err = _launcher()(ptr(x), ptr(packed_pos), ptr(packed_neg), ptr(qparams),
                      ptr(gamma), ptr(zcol), ptr(y), ptr(partial), m, k, n,
                      p, ksplit, kchunk, stream_of(x))
    build.check(err, "pann_matmul_packed_act")
    global launches
    launches += 1
    return y
