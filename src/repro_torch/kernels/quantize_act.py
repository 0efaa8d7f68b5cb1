"""Per-row unsigned activation quantization (port of
``repro.kernels.quantize_act``; the paper's App. A.4 half range):

    scale[m] = max(amax(relu x[m, :]), 1e-12) / qmax     qmax = 2^(b-1) - 1
    q[m, k]  = clip(round(x[m, k] / scale[m]), 0, qmax)   as int8

The scale is an IEEE division by qmax, as in the oracle
``repro.kernels.ref.quantize_act_ref``; the jitted TPU kernel lets XLA turn
it into a multiply by 1/qmax, which can differ by one ulp. ``quantize_act``
launches the CUDA kernel (``csrc/quantize_act.cu``) on CUDA tensors and runs
its plain version, ``ref.quantize_act_ref``, on CPU tensors.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import build
from repro_torch.kernels.ref import quantize_act_ref

Tensor = torch.Tensor

launches = 0     # kernel launches since the caller last reset it


def _launcher():
    return build.entry("quantize_act", "quantize_act_launch",
                       (build.P, build.I, build.P, build.P)
                       + (build.I,) * 3 + (build.P,))


def quantize_act(x: Tensor, *, bits: int = 8) -> tuple[Tensor, Tensor]:
    """x (M, K) float32 or bfloat16 -> (codes (M, K) int8, scales (M, 1)
    float32). CPU tensors run the plain version; CUDA tensors launch the
    kernel or raise."""
    if not 2 <= bits <= 8:
        raise ValueError(f"bits = {bits} outside [2, 8]")
    if x.device.type == "cpu":
        return quantize_act_ref(x, bits)
    if x.device.type != "cuda":
        raise ValueError(f"no kernel for device {x.device}")
    if x.ndim != 2 or x.dtype not in (torch.float32, torch.bfloat16) \
            or not x.is_contiguous():
        raise ValueError(f"x must be a contiguous (M, K) float32 or bfloat16 "
                         f"tensor, got {x.dtype} {tuple(x.shape)}")
    m, k = x.shape
    q = torch.empty((m, k), dtype=torch.int8, device=x.device)
    scale = torch.empty((m, 1), dtype=torch.float32, device=x.device)
    if m == 0:
        return q, scale
    err = _launcher()(build.ptr(x), int(x.dtype == torch.bfloat16),
                      build.ptr(q), build.ptr(scale), m, k,
                      (1 << (bits - 1)) - 1, build.stream_of(x))
    build.check(err, "quantize_act")
    global launches
    launches += 1
    return q, scale
