"""PANN bit-plane serving matmul with the fused activation-quant prologue
(port of ``repro.kernels.pann_matmul.pann_matmul_act``, backend 'fused').

    y[m, n] = ((q(x) @ W)[m, n] - zcol[n]) * s * gamma[n]
    q(x)    = clip(round(x / s) + z, 0, n_lvl)
    W       = sum_{p >= shift} 2^p (pos_p - neg_p)

``pann_matmul_act`` launches the CUDA kernel (``csrc/pann_matmul.cu``) on
CUDA tensors and runs ``pann_matmul_act_plain`` on CPU tensors. The plain
version is what the kernel is held against on the card.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.core import quant
from repro_torch.kernels import build

Tensor = torch.Tensor

launches = 0     # kernel launches since the caller last reset it

# split-K sizing: enough blocks for two waves on the H100's 132 SMs, with the
# encoded panel (rows x kchunk int8 codes) well inside 48 KB of shared memory
_TARGET_BLOCKS = 2 * 132
_COLS_PER_BLOCK = 128 * 4
_MAX_KCHUNK = 4096


def split_k(m: int, k: int, n: int) -> tuple[int, int]:
    """(ksplit, kchunk) of the launch: kchunk is a multiple of 8 and
    ksplit * kchunk >= k > (ksplit - 1) * kchunk."""
    tiles = -(-n // _COLS_PER_BLOCK) * -(-m // (4 if m <= 4 else 8))
    ksplit = max(1, min(-(-_TARGET_BLOCKS // tiles), -(-k // 64)))
    kchunk = min(-(-(-(-k // ksplit)) // 8) * 8, _MAX_KCHUNK)
    return -(-k // kchunk), kchunk


def rebuild_weight(planes_pos: Tensor, planes_neg: Tensor, shift
                   ) -> Tensor:
    """(K, N) int32 W = sum_{p >= shift} 2^p (pos_p - neg_p); ``shift`` is
    a 0-dim tensor, read on the device."""
    p = planes_pos.shape[0]
    dev = planes_pos.device
    sh = torch.round(shift).to(torch.int32)
    ks = torch.arange(p, dtype=torch.int32, device=dev)
    weights = torch.where(ks >= sh, 1 << ks, torch.zeros_like(ks))
    w = torch.zeros(planes_pos.shape[1:], dtype=torch.int32, device=dev)
    for i in range(p):
        w += weights[i] * (planes_pos[i].to(torch.int32)
                           - planes_neg[i].to(torch.int32))
    return w


def matmul_epilogue(q: Tensor, w: Tensor, s: Tensor, gamma: Tensor,
                    zcol: Tensor) -> Tensor:
    """Exact integer q @ w (fp64: every partial sum is an integer below
    2^53), then ((acc - zcol) * s) * gamma in fp32 — the kernels' finalize."""
    acc = torch.matmul(q.double(), w.double()).to(torch.int32)
    return (acc - zcol).to(torch.float32) * s * gamma


def pann_matmul_act_plain(x: Tensor, planes_pos: Tensor, planes_neg: Tensor,
                          qparams: Tensor, gamma: Tensor, zcol: Tensor
                          ) -> Tensor:
    """Plain PyTorch version of the kernel, on any device."""
    s, z, n_lvl, shift = qparams.unbind()
    q = quant.affine_encode(x, s, z, n_lvl)
    w = rebuild_weight(planes_pos, planes_neg, shift)
    return matmul_epilogue(q, w, s, gamma, zcol)


def check_args(x: Tensor, planes: tuple, plane_dtype, k_rows: int,
               qparams: Tensor, gamma: Tensor, zcol: Tensor) -> None:
    """Device, dtype, shape and contiguity checks shared by both matmul
    wrappers; ``k_rows`` is the planes' row count for this x."""
    dev = x.device
    tensors = (x, *planes, qparams, gamma, zcol)
    if any(t.device != dev for t in tensors):
        raise ValueError("all operands must be on one device")
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError("operands must be contiguous")
    if x.dtype != torch.float32 or x.ndim != 2:
        raise ValueError(f"x must be (M, K) float32, got {x.dtype} "
                         f"{tuple(x.shape)}")
    pos, neg = planes
    if pos.dtype != plane_dtype or neg.dtype != plane_dtype \
            or pos.shape != neg.shape or pos.ndim != 3:
        raise ValueError(f"planes must be two equal (P, K', N) {plane_dtype} "
                         f"tensors, got {pos.dtype} {tuple(pos.shape)}")
    p, k_rows_have, n = pos.shape
    if k_rows_have != k_rows:
        raise ValueError(f"planes have {k_rows_have} rows, x needs {k_rows}")
    if not 1 <= p <= 7:
        raise ValueError(f"plane count {p} outside [1, 7]")
    if n % 4:
        raise ValueError(f"N = {n} must be a multiple of 4")
    if qparams.dtype != torch.float32 or qparams.shape != (4,):
        raise ValueError("qparams must be a (4,) float32 [s, z, n, shift]")
    if gamma.dtype != torch.float32 or gamma.shape != (n,):
        raise ValueError(f"gamma must be ({n},) float32")
    if zcol.dtype != torch.int32 or zcol.shape != (n,):
        raise ValueError(f"zcol must be ({n},) int32")


def ptr(t: Tensor) -> ctypes.c_void_p:
    return ctypes.c_void_p(t.data_ptr())


def stream_of(t: Tensor) -> ctypes.c_void_p:
    return ctypes.c_void_p(torch.cuda.current_stream(t.device).cuda_stream)


def _launcher():
    return build.entry("pann_matmul", "pann_matmul_act_launch",
                       (build.P,) * 8 + (build.I,) * 6 + (build.P,))


def pann_matmul_act(x: Tensor, planes_pos: Tensor, planes_neg: Tensor,
                    qparams: Tensor, gamma: Tensor, zcol: Tensor) -> Tensor:
    """x (M, K) f32; planes_pos/neg (P, K, N) int8 in {0, 1}; qparams (4,)
    f32 [s, z, n_lvl, plane_shift] on the same device; gamma (N,) f32;
    zcol (N,) int32 -> (M, N) f32. CPU tensors run the plain version; CUDA
    tensors launch the kernel or raise."""
    if x.device.type == "cpu":
        return pann_matmul_act_plain(x, planes_pos, planes_neg, qparams,
                                     gamma, zcol)
    if x.device.type != "cuda":
        raise ValueError(f"no kernel for device {x.device}")
    m, k = x.shape
    check_args(x, (planes_pos, planes_neg), torch.int8, k, qparams, gamma,
               zcol)
    p, _, n = planes_pos.shape
    ksplit, kchunk = split_k(m, k, n)
    y = torch.empty((m, n), dtype=torch.float32, device=x.device)
    partial = torch.empty((ksplit, m, n), dtype=torch.int32, device=x.device)
    err = _launcher()(ptr(x), ptr(planes_pos), ptr(planes_neg), ptr(qparams),
                      ptr(gamma), ptr(zcol), ptr(y), ptr(partial), m, k, n,
                      p, ksplit, kchunk, stream_of(x))
    build.check(err, "pann_matmul_act")
    global launches
    launches += 1
    return y
