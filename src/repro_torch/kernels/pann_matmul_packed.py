"""PANN bit-plane matmuls on PACKED planes (port of
``repro.kernels.pann_matmul_packed``: ``pann_matmul_packed_act``, backend
'packed'; ``pann_matmul_packed``, the product on int8 codes with per-row
scales; and the plane codec).

Layout: packed[p, k8, n] holds bit (k8*8 + j) of plane p in bit j — 2*P/8
bytes per weight for both signs. Each matmul launches its CUDA kernel
(``csrc/pann_matmul_packed.cu``: the streaming decode kernel up to 8 rows,
the tensor-core tile kernel of ``csrc/pann_tc.cuh`` above) on CUDA tensors
and runs its ``*_plain`` version on CPU tensors.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.core import quant
from repro_torch.kernels import build
from repro_torch.kernels.pann_matmul import (BLOCKS_PACKED, STEP_PACKED,
                                             check_args, check_codes_args,
                                             epilogue, int_product,
                                             launch_product, meta_product)

Tensor = torch.Tensor

launches = 0                       # pann_matmul_packed_act launches
pann_matmul_packed_launches = 0    # pann_matmul_packed launches
acc_launches = 0                   # pann_matmul_packed_act_acc launches


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
    """Plain PyTorch version of the prologue kernel, on any device."""
    s, z, n_lvl, shift = qparams.unbind()
    k = x.shape[1]
    q = quant.affine_encode(x, s, z, n_lvl)
    acc = int_product(q, unpack_planes(packed_pos, k),
                      unpack_planes(packed_neg, k), shift)
    return epilogue(acc, s, gamma, zcol)


def pann_matmul_packed_act_acc_plain(x: Tensor, packed_pos: Tensor,
                                     packed_neg: Tensor,
                                     qparams: Tensor) -> Tensor:
    """Plain PyTorch version of the accumulator mode, on any device: the
    prologue kernel's exact int32 product, no epilogue."""
    s, z, n_lvl, shift = qparams.unbind()
    k = x.shape[1]
    q = quant.affine_encode(x, s, z, n_lvl)
    return int_product(q, unpack_planes(packed_pos, k),
                       unpack_planes(packed_neg, k), shift)


def pann_matmul_packed_plain(x_q: Tensor, packed_pos: Tensor,
                             packed_neg: Tensor, s_x: Tensor, gamma: Tensor,
                             zcol=None) -> Tensor:
    """Plain PyTorch version of the codes kernel, on any device."""
    k = x_q.shape[1]
    acc = int_product(x_q, unpack_planes(packed_pos, k),
                      unpack_planes(packed_neg, k))
    return epilogue(acc, s_x, gamma, zcol)


def _act_launcher():
    return build.entry("pann_matmul_packed", "pann_matmul_packed_act_launch",
                       (build.P,) * 10 + (build.I,) * 6 + (build.P,))


def _codes_launcher():
    return build.entry("pann_matmul_packed", "pann_matmul_packed_launch",
                       (build.P,) * 10 + (build.I,) * 6 + (build.P,))


def _acc_launcher():
    return build.entry("pann_matmul_packed",
                       "pann_matmul_packed_act_acc_launch",
                       (build.P,) * 8 + (build.I,) * 6 + (build.P,))


def _check_k(k: int) -> None:
    if k % 8:
        raise ValueError(f"K = {k} must be a multiple of 8")


def pann_matmul_packed_act(x: Tensor, packed_pos: Tensor,
                           packed_neg: Tensor, qparams: Tensor,
                           gamma: Tensor, zcol: Tensor,
                           params=None) -> Tensor:
    """x (M, K) f32 with K % 8 == 0; packed_pos/neg (P, K/8, N) uint8;
    qparams (4,) f32 [s, z, n_lvl, plane_shift]; gamma (N,) f32; zcol (N,)
    int32 -> (M, N) f32. CPU tensors run the plain version; CUDA tensors
    launch the kernel or raise. The launch's K split is the autotuner's
    for backend 'packed' (``autotune.params_for``), or ``params``."""
    if x.device.type == "cpu":
        return pann_matmul_packed_act_plain(x, packed_pos, packed_neg,
                                            qparams, gamma, zcol)
    if x.device.type == "meta":
        return meta_product("pann_matmul_packed_act", x,
                            (packed_pos, packed_neg))
    if x.device.type != "cuda":
        raise ValueError(f"no kernel for device {x.device}")
    _check_k(x.shape[1])
    check_args(x, (packed_pos, packed_neg), torch.uint8, x.shape[1] // 8,
               qparams, gamma, zcol)
    y = launch_product(_act_launcher(), "pann_matmul_packed_act", x,
                       (packed_pos, packed_neg), qparams, gamma, zcol,
                       step=STEP_PACKED, blocks=BLOCKS_PACKED,
                       backend="packed", params=params)
    global launches
    launches += 1
    return y


def pann_matmul_packed(x_q: Tensor, packed_pos: Tensor, packed_neg: Tensor,
                       s_x: Tensor, gamma: Tensor, zcol=None) -> Tensor:
    """x_q (M, K) int8 codes >= 0 with K % 8 == 0; packed_pos/neg (P, K/8,
    N) uint8; s_x (M, 1) f32; gamma (N,) f32; zcol (N,) int32 or None ->
    (M, N) f32. CPU tensors run the plain version; CUDA tensors launch the
    kernel or raise."""
    if x_q.device.type == "cpu":
        return pann_matmul_packed_plain(x_q, packed_pos, packed_neg, s_x,
                                        gamma, zcol)
    if x_q.device.type != "cuda":
        raise ValueError(f"no kernel for device {x_q.device}")
    _check_k(x_q.shape[1])
    check_codes_args(x_q, (packed_pos, packed_neg), torch.uint8,
                     x_q.shape[1] // 8, s_x, gamma, zcol)
    y = launch_product(_codes_launcher(), "pann_matmul_packed", x_q,
                       (packed_pos, packed_neg), s_x, gamma, zcol,
                       step=STEP_PACKED, blocks=BLOCKS_PACKED)
    global pann_matmul_packed_launches
    pann_matmul_packed_launches += 1
    return y


def pann_matmul_packed_act_acc(x: Tensor, packed_pos: Tensor,
                               packed_neg: Tensor, qparams: Tensor,
                               params=None) -> Tensor:
    """The accumulator mode of ``pann_matmul_packed_act``: the same operands
    but gamma and zcol, the (M, N) int32 product sums out and no epilogue
    (a row-parallel projection's K shard, ``kernels.dispatch``; the
    epilogue is ``pann_matmul.pann_epilogue``). CPU tensors run the plain
    version; CUDA tensors launch the kernel or raise; its K split is
    backend 'packed''s, as the whole product's."""
    if x.device.type == "cpu":
        return pann_matmul_packed_act_acc_plain(x, packed_pos, packed_neg,
                                                qparams)
    if x.device.type == "meta":
        return meta_product("pann_matmul_packed_act_acc", x,
                            (packed_pos, packed_neg), sums=True)
    if x.device.type != "cuda":
        raise ValueError(f"no kernel for device {x.device}")
    _check_k(x.shape[1])
    check_args(x, (packed_pos, packed_neg), torch.uint8, x.shape[1] // 8,
               qparams, None, None)
    sums = launch_product(_acc_launcher(), "pann_matmul_packed_act_acc", x,
                          (packed_pos, packed_neg), qparams, None, None,
                          step=STEP_PACKED, blocks=BLOCKS_PACKED,
                          backend="packed", params=params, sums=True)
    global acc_launches
    acc_launches += 1
    return sums
