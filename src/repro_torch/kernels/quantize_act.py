"""Per-row unsigned activation quantization (port of
``repro.kernels.quantize_act``; the paper's App. A.4 half range):

    scale[m] = max(amax(relu x[m, :]), 1e-12) / qmax     qmax = 2^(b-1) - 1
    q[m, k]  = clip(round(x[m, k] / scale[m]), 0, qmax)   as int8

The scale is an IEEE division by qmax, as in the oracle
``repro.kernels.ref.quantize_act_ref``; the jitted TPU kernel lets XLA turn
it into a multiply by 1/qmax, which can differ by one ulp. ``quantize_act``
launches the CUDA kernel (``csrc/quantize_act.cu``) on CUDA tensors: each
row split over a thread block cluster of 1 to 8 blocks (``cluster_plan``),
read once into registers, the blocks' maxima exchanged through distributed
shared memory. CPU tensors run its plain version, ``ref.quantize_act_ref``.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import build
from repro_torch.kernels.pann_matmul import sm_count
from repro_torch.kernels.ref import quantize_act_ref

Tensor = torch.Tensor

launches = 0     # kernel launches since the caller last reset it

THREADS = 256               # threads a block
MAX_CLUSTER = 8             # blocks a cluster (the portable maximum)
VECTORS = (1, 2, 4, 8, 16)  # 16-byte vectors a thread holds (templates)
PLAN_VECTORS = 4            # the most a plan takes while 8 blocks suffice


def cluster_plan(m: int, k: int, elem_bytes: int, sms: int) -> tuple:
    """(C, V) of a launch over x (m, k) of ``elem_bytes``-byte elements on a
    card with ``sms`` SMs: V 16-byte vectors a thread (a power of 2) and C
    blocks a row, the fewest that cover a row at V. C starts where m * C
    blocks cover the SMs about once (C = 1 where m alone fills them, at
    least a vector a thread); V is the fewest that cover a row with those
    blocks, at most PLAN_VECTORS (fewer registers a block, more blocks a
    SM) unless a row needs more than MAX_CLUSTER blocks of PLAN_VECTORS.
    Raises for a row longer than MAX_CLUSTER blocks of 16 vectors."""
    vectors = -(-k * elem_bytes // 16)
    c = max(1, min(MAX_CLUSTER, sms // m, -(-vectors // THREADS)))
    need = min(-(-vectors // (c * THREADS)), PLAN_VECTORS)
    need = max(need, -(-vectors // (MAX_CLUSTER * THREADS)))
    v = next((v for v in VECTORS if v >= need), None)
    if v is None:
        most = MAX_CLUSTER * THREADS * VECTORS[-1] * 16 // elem_bytes
        raise ValueError(f"K = {k}: a row of more than {most} elements does "
                         "not fit one cluster's registers")
    return max(1, -(-vectors // (THREADS * v))), v


def _launcher():
    return build.entry("quantize_act", "quantize_act_launch",
                       (build.P, build.I, build.P, build.P)
                       + (build.I,) * 5 + (build.P,))


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
    c, v = cluster_plan(m, k, x.element_size(), sm_count(x.device.index))
    err = _launcher()(build.ptr(x), int(x.dtype == torch.bfloat16),
                      build.ptr(q), build.ptr(scale), m, k,
                      (1 << (bits - 1)) - 1, c, v, build.stream_of(x))
    build.check(err, "quantize_act")
    global launches
    launches += 1
    return q, scale
