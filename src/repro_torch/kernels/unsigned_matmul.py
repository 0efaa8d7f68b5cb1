"""Unsigned-split integer matmul (port of ``repro.kernels.unsigned_matmul``;
the paper's Sec. 4, Eq. 5-6):

    y[m, n] = (x_q @ W+ - x_q @ W-)[m, n] * s_x[m] * s_w[n]
    W+ = max(W, 0), W- = max(-W, 0)

on int8 codes x_q >= 0 and signed int8 weight codes in [-127, 127].
``unsigned_matmul`` launches the CUDA kernel (``csrc/unsigned_matmul.cu``)
on CUDA tensors: up to 8 rows one launch of the streaming decode block of
``csrc/pann_common.cuh`` (W+ and W- split in registers, two ``__dp4a``
products, the split-K sum and the scales in the same launch), above 8 rows
the tensor-core tile kernel of ``csrc/pann_tc.cuh`` and the epilogue
kernel. CPU tensors run ``unsigned_matmul_plain``.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import build
from repro_torch.kernels.pann_matmul import (BLOCKS_SIGNED, STEP_PLANES,
                                             split_scratch)
from repro_torch.kernels.ref import int_matmul

Tensor = torch.Tensor

launches = 0     # kernel launches since the caller last reset it


def unsigned_matmul_plain(x_q: Tensor, w_q: Tensor, s_x: Tensor,
                          s_w: Tensor) -> Tensor:
    """Plain PyTorch version of the kernel, on any device: two exact
    unsigned products, one subtraction, ((acc_p - acc_n) * s_x) * s_w."""
    w = w_q.to(torch.int32)
    acc_p = int_matmul(x_q, torch.clamp(w, min=0))
    acc_n = int_matmul(x_q, torch.clamp(-w, min=0))
    return (acc_p - acc_n).to(torch.float32) * s_x * s_w.reshape(1, -1)


def _check(x_q: Tensor, w_q: Tensor, s_x: Tensor, s_w: Tensor) -> None:
    tensors = (x_q, w_q, s_x, s_w)
    if any(t.device != x_q.device for t in tensors):
        raise ValueError("all operands must be on one device")
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError("operands must be contiguous")
    if x_q.dtype != torch.int8 or x_q.ndim != 2:
        raise ValueError(f"x_q must be (M, K) int8, got {x_q.dtype} "
                         f"{tuple(x_q.shape)}")
    m, k = x_q.shape
    if w_q.dtype != torch.int8 or w_q.ndim != 2 or w_q.shape[0] != k:
        raise ValueError(f"w_q must be ({k}, N) int8, got {w_q.dtype} "
                         f"{tuple(w_q.shape)}")
    n = w_q.shape[1]
    if n % 4:
        raise ValueError(f"N = {n} must be a multiple of 4")
    if s_x.dtype != torch.float32 or s_x.shape != (m, 1):
        raise ValueError(f"s_x must be ({m}, 1) float32")
    if s_w.dtype != torch.float32 or s_w.shape != (n,):
        raise ValueError(f"s_w must be ({n},) float32")


def _launcher():
    return build.entry("unsigned_matmul", "unsigned_matmul_launch",
                       (build.P,) * 8 + (build.I,) * 5 + (build.P,))


def unsigned_matmul(x_q: Tensor, w_q: Tensor, s_x: Tensor, s_w: Tensor
                    ) -> Tensor:
    """x_q (M, K) int8 >= 0; w_q (K, N) int8 in [-127, 127]; s_x (M, 1)
    f32; s_w (N,) f32 -> (M, N) f32. CPU tensors run the plain version;
    CUDA tensors launch the kernel or raise."""
    if x_q.device.type == "cpu":
        return unsigned_matmul_plain(x_q, w_q, s_x, s_w)
    if x_q.device.type != "cuda":
        raise ValueError(f"no kernel for device {x_q.device}")
    _check(x_q, w_q, s_x, s_w)
    m, k = x_q.shape
    n = w_q.shape[1]
    ksplit, kchunk, partial, acc, tickets = split_scratch(
        x_q, n, STEP_PLANES, BLOCKS_SIGNED)
    y = torch.empty((m, n), dtype=torch.float32, device=x_q.device)
    ptrs = [build.ptr(t) for t in (x_q, w_q, s_x, s_w, y, partial, acc,
                                   tickets)]
    err = _launcher()(*ptrs, m, k, n, ksplit, kchunk, build.stream_of(x_q))
    build.check(err, "unsigned_matmul")
    global launches
    launches += 1
    return y
