"""One-token GQA decode attention read directly off the packed bit-plane
KV cache (port of ``repro.kernels.pann_attention.decode_attention``).

``decode_attention`` launches the CUDA kernel (``csrc/pann_attention.cu``)
on CUDA tensors and runs the plain version on CPU tensors. The plain
version is ``kernels.ref.decode_attention_ref`` — the module the JAX
package keeps its oracles in — bound here as ``decode_attention_plain``.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import build
from repro_torch.kernels import ref as _ref

Tensor = torch.Tensor

launches = 0     # kernel launches since the caller last reset it

decode_attention_plain = _ref.decode_attention_ref

# the kernel keeps the (G, S) fp32 scores and two (G, hd) int32 panels in
# dynamic shared memory: 227 KB per block on the H100, less a margin for
# the kernel's static reduction scratch
SMEM_BYTES = 227 * 1024 - 1024
MAX_GROUP = 8
HEAD_DIMS = (16, 32, 64, 128, 256)


def max_seq_len(group: int, head_dim: int) -> int:
    """Largest cache length S the kernel takes for G query heads per kv
    head and head dim hd: 4*G*S + 8*G*hd bytes must fit SMEM_BYTES."""
    return (SMEM_BYTES - 8 * group * head_dim) // (4 * group)


def _launcher():
    return build.entry("pann_attention", "decode_attention_launch",
                       (build.P,) * 10 + (build.I,) * 7
                       + (ctypes.c_float, build.P))


def decode_attention(qq: Tensor, q_z: Tensor, q_scale: Tensor,
                     k_planes: Tensor, k_s: Tensor, k_z: Tensor,
                     v_planes: Tensor, v_s: Tensor, v_z: Tensor,
                     pos: Tensor, k_pact=None, v_pact=None, *, window=None,
                     softcap: float = 0.0) -> Tensor:
    """Argument shapes as ``kernels.ref.decode_attention_ref``; ``pos`` is
    a 0-dim int32 (the caches share one length across the batch), and
    ``k_pact``/``v_pact`` are 0-dim counts of LIVE low planes (None = all),
    device tensors so every cache rung runs the same launch. Skipped planes
    are all-zero by construction, so the plain version needs no count.
    Returns (B, K, G, hd) fp32."""
    if qq.device.type == "cpu":
        return decode_attention_plain(qq, q_z, q_scale, k_planes, k_s, k_z,
                                      v_planes, v_s, v_z, pos, window=window,
                                      softcap=softcap)
    if qq.device.type != "cuda":
        raise ValueError(f"no kernel for device {qq.device}")
    b, kh, g, hd = qq.shape
    _, n_planes, s, kh2, d8 = k_planes.shape
    tensors = (qq, q_z, q_scale, k_planes, k_s, k_z, v_planes, v_s, v_z, pos)
    if any(t.device != qq.device for t in tensors):
        raise ValueError("all operands must be on one device")
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError("operands must be contiguous")
    if qq.dtype != torch.int32 or pos.dtype != torch.int32 or pos.numel() != 1:
        raise ValueError("qq must be int32 and pos a 0-dim int32")
    if kh2 != kh or d8 * 8 != hd or v_planes.shape != k_planes.shape:
        raise ValueError(f"cache planes {tuple(k_planes.shape)} do not match "
                         f"queries {tuple(qq.shape)}")
    if k_planes.dtype != torch.uint8 or v_planes.dtype != torch.uint8:
        raise ValueError("cache planes must be uint8")
    for row in (k_s, k_z, v_s, v_z):
        if row.dtype != torch.float32 or row.shape != (b, s):
            raise ValueError(f"cache rows must be ({b}, {s}) float32")
    if not 1 <= n_planes <= _ref.CACHE_PLANES:
        raise ValueError(f"plane count {n_planes} outside [1, 7]")
    if hd not in HEAD_DIMS or g > MAX_GROUP:
        raise ValueError(f"head dim {hd} not in {HEAD_DIMS} or group {g} "
                         f"> {MAX_GROUP}")
    if s > max_seq_len(g, hd):
        raise ValueError(f"cache length {s} exceeds the kernel's "
                         f"{max_seq_len(g, hd)} at G={g}, hd={hd}")
    full = q_scale.new_full((), float(n_planes))
    pact = [full if a is None else
            torch.clamp(a.to(torch.float32).reshape(()), 1.0, float(n_planes))
            for a in (k_pact, v_pact)]
    qp = torch.stack([q_z.to(torch.float32).reshape(()),
                      q_scale.to(torch.float32).reshape(()), *pact])
    out = torch.empty((b, kh, g, hd), dtype=torch.float32, device=qq.device)
    ptrs = [build.ptr(t) for t in (qq, qp, pos, k_planes, k_s, k_z,
                                   v_planes, v_s, v_z, out)]
    err = _launcher()(*ptrs, b, n_planes, s, kh, g, hd,
                      -1 if window is None else int(window), float(softcap),
                      build.stream_of(qq))
    build.check(err, "decode_attention")
    global launches
    launches += 1
    return out
