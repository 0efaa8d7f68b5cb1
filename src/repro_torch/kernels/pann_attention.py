"""One-token GQA decode attention read directly off the packed bit-plane
KV cache (port of ``repro.kernels.pann_attention.decode_attention``).

``decode_attention`` launches the CUDA kernel (``csrc/pann_attention.cu``)
on CUDA tensors and runs the plain version on CPU tensors. The plain
version is ``kernels.ref.decode_attention_ref`` — the module the JAX
package keeps its oracles in — bound here as ``decode_attention_plain``.

The kernel is one launch per call: the C blocks of each (batch, kv head)
form a thread block cluster and split the S cached positions into C
contiguous chunks (``cluster_size`` picks C in 1..8 from S and from how
many such clusters the card holds at once). Each block copies its chunk's
live V plane rows into shared memory asynchronously while it computes its
chunk's scores from K read straight into registers, both products on the
int8 tensor cores, and the blocks exchange their softmax maxima, fp64
partial sums, largest V scale and int32 PV partials through distributed
shared memory. ``q_z``, ``q_scale``, ``k_pact`` and ``v_pact`` reach the
kernel as device pointers and are clamped and rounded there, so the
wrapper launches no kernel of its own. Shared memory bounds the cluster
kernel's S: ``max_seq_len`` (12,032 at G = 4, hd = 128 and 7 cache
planes).

Past that cap the wrapper launches the long path instead (the same
source's ``decode_attention_long_kernel``, counted in ``long_launches``):
clusters of ``LONG_CLUSTER`` blocks a (batch, kv head) walk their chunks
of whole ``LONG_TILE``-row tiles in three passes (scores into a (B, KH,
G, S) fp32 scratch with the maxima; the exps and fp64 partial sums; the
probability codes and the int32 PV a tile at a time), exchanging the
same maxima, sums, V scale and partials through distributed shared
memory, so it gives the plain version's bits at any S. Only the int32 PV
bounds it: ``max_long_seq_len`` (33,785,872 positions).
"""
from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.kernels import build
from repro_torch.kernels import ref as _ref

Tensor = torch.Tensor

launches = 0     # kernel launches since the caller last reset it
long_launches = 0   # long-path launches since the caller last reset it

decode_attention_plain = _ref.decode_attention_ref

# A block keeps its chunk's V rows for every cache plane (hd/8 bytes a row,
# padded to 4: 20 at hd = 160), its v_s / v_z rows, its (G, chunk) fp32
# scores and two bytes of probability code in dynamic shared memory: the
# H100's 227 KB a block less the kernel's static arrays and a margin.
# Chunks are padded to whole 32-row groups.
DYN_SMEM_BYTES = 232448 - 12 * 1024
CLUSTERS = tuple(range(1, 9))
MIN_CHUNK = 64          # positions a block is worth a cluster rank for
ROW_PAD = 32
MAX_GROUP = 8
HEAD_DIMS = (16, 32, 64, 128, 160, 256)
LONG_CLUSTER = 8        # blocks a (batch, kv head) on the long path
LONG_TILE = 256         # cached rows a long-path block holds at once


def _chunk_pad(s: int, c: int) -> int:
    chunk = -(-s // c)
    return -(-chunk // ROW_PAD) * ROW_PAD


def smem_bytes(s: int, c: int, group: int, head_dim: int,
               n_planes: int = _ref.CACHE_PLANES) -> int:
    """Dynamic shared memory of one block at cluster size ``c``."""
    row = max(head_dim // 8, 4)
    return _chunk_pad(s, c) * (n_planes * row + 6 * group + 8)


def max_seq_len(group: int, head_dim: int,
                n_planes: int = _ref.CACHE_PLANES) -> int:
    """Largest cache length S the kernel takes for G query heads per kv
    head, head dim hd and P cache planes: a chunk of S / 8 positions (the
    largest cluster) must fit DYN_SMEM_BYTES."""
    per_row = n_planes * max(head_dim // 8, 4) + 6 * group + 8
    return CLUSTERS[-1] * (DYN_SMEM_BYTES // per_row // ROW_PAD * ROW_PAD)


def max_long_seq_len() -> int:
    """Largest S the long path takes: an output's int32 PV sum is at most
    127 * sum(pq) <= 127 * (2^14 + S / 2) (each probability code rounds up
    by at most half), which must stay below 2^31."""
    return 2 * ((2 ** 31 - 1) // 127 - int(_ref.PROB_SCALE))


def long_chunk(s: int) -> int:
    """Positions a long-path block walks: S / LONG_CLUSTER rounded up to
    whole tiles, so every tile lies in one block."""
    chunk = -(-s // LONG_CLUSTER)
    return -(-chunk // LONG_TILE) * LONG_TILE


def launch_plan(s: int, heads: int, group: int, head_dim: int,
                n_planes: int, max_clusters) -> tuple[str, int]:
    """("cluster", C) from ``cluster_size`` up to ``max_seq_len``, else
    ("long", LONG_CLUSTER); raises past ``max_long_seq_len``."""
    if s <= max_seq_len(group, head_dim, n_planes):
        return "cluster", cluster_size(s, heads, group, head_dim, n_planes,
                                       max_clusters)
    if s > max_long_seq_len():
        raise ValueError(f"cache length {s} exceeds the int32 PV bound "
                         f"{max_long_seq_len()}")
    return "long", LONG_CLUSTER


def cluster_size(s: int, heads: int, group: int, head_dim: int,
                 n_planes: int, max_clusters) -> int:
    """Blocks per (batch, kv head). Candidates: the smallest cluster whose
    chunk fits shared memory, and the larger ones whose chunks keep
    MIN_CHUNK positions. ``max_clusters(c)`` is how many clusters of c
    blocks the card holds at once, so ``heads`` (= B * KH) clusters take
    ceil(heads / max_clusters(c)) waves; the candidate with the shortest
    waves x padded chunk wins, the largest on a tie. Raises above
    ``max_seq_len`` or when the card can hold no candidate's cluster."""
    fit = [c for c in CLUSTERS
           if smem_bytes(s, c, group, head_dim, n_planes) <= DYN_SMEM_BYTES]
    if not fit:
        raise ValueError(f"cache length {s} exceeds the kernel's "
                         f"{max_seq_len(group, head_dim, n_planes)} at "
                         f"G={group}, hd={head_dim}, P={n_planes}")
    held = {c: max_clusters(c) for c in fit
            if c == fit[0] or -(-s // c) >= MIN_CHUNK}
    held = {c: n for c, n in held.items() if n > 0}
    if not held:
        raise RuntimeError(f"decode_attention: the card holds no cluster of "
                           f"{fit} blocks at S={s}, G={group}, hd={head_dim}")
    return min(held, key=lambda c: (-(-heads // held[c]) * _chunk_pad(s, c),
                                    -c))


@functools.cache
def _max_clusters(index: int, n_planes: int, s: int, kh: int, group: int,
                  head_dim: int, c: int) -> int:
    fn = build.entry("pann_attention", "decode_attention_max_clusters",
                     (build.I,) * 6 + (build.P,))
    active = ctypes.c_int(0)
    with torch.cuda.device(index):
        build.check(fn(n_planes, s, kh, group, head_dim, c,
                       ctypes.byref(active)), "decode_attention occupancy")
    return active.value


def plan_of(qq: Tensor, k_planes: Tensor) -> tuple[str, int]:
    """The path and cluster size ``decode_attention`` launches for these
    operands (CUDA tensors)."""
    b, kh, g, hd = qq.shape
    n_planes, s = k_planes.shape[1:3]
    return launch_plan(
        s, b * kh, g, hd, n_planes,
        lambda c: _max_clusters(qq.device.index, n_planes, s, kh, g, hd, c))


def _launcher():
    return build.entry("pann_attention", "decode_attention_launch",
                       (build.P,) * 13 + (build.I,) * 8
                       + (ctypes.c_float, build.P))


def _long_launcher():
    return build.entry("pann_attention", "decode_attention_long_launch",
                       (build.P,) * 14 + (build.I,) * 8
                       + (ctypes.c_float, build.P))


def decode_attention(qq: Tensor, q_z: Tensor, q_scale: Tensor,
                     k_planes: Tensor, k_s: Tensor, k_z: Tensor,
                     v_planes: Tensor, v_s: Tensor, v_z: Tensor,
                     pos: Tensor, k_pact=None, v_pact=None, *, window=None,
                     softcap: float = 0.0, path=None) -> Tensor:
    """Argument shapes as ``kernels.ref.decode_attention_ref``; ``pos`` is
    a 0-dim int32 (the caches share one length across the batch), and
    ``k_pact``/``v_pact`` are 0-dim counts of LIVE low planes (None = all),
    device tensors so every cache rung runs the same launch. Skipped planes
    are all-zero by construction, so the plain version needs no count.
    On the card ``q_z``, ``q_scale`` and the counts must be 1-element
    float32 tensors (the kernel reads them through their pointers), and
    ``qq`` must hold codes in [0, 255] (the serving path's are in
    [0, 127]): the kernel multiplies them as bytes. ``path="long"``
    launches the long path at any S (``chip_smoke.py`` times it below the
    cap beside the cluster kernel); None takes ``plan_of``'s. Returns (B,
    K, G, hd) fp32."""
    if path not in (None, "long"):
        raise ValueError(f"path {path!r} is not None or 'long'")
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
    scalars = [t for t in (q_z, q_scale, k_pact, v_pact) if t is not None]
    if any(t.device != qq.device or t.dtype != torch.float32
           or t.numel() != 1 for t in scalars):
        raise ValueError("q_z, q_scale, k_pact and v_pact must be 1-element "
                         f"float32 tensors on {qq.device}")
    if k_planes.data_ptr() % 16 or v_planes.data_ptr() % 16:
        raise ValueError("cache planes must be 16-byte aligned")
    plan = plan_of(qq, k_planes)
    path, c = plan if path is None else ("long", LONG_CLUSTER)
    out = torch.empty((b, kh, g, hd), dtype=torch.float32, device=qq.device)
    ptrs = [build.ptr(t) for t in (qq, q_z, q_scale, k_pact, v_pact, pos,
                                   k_planes, k_s, k_z, v_planes, v_s, v_z,
                                   out)]
    win = -1 if window is None else int(window)
    global launches, long_launches
    if path == "long":
        # the scores, then their exps, of every position: (B, KH, G, S)
        scratch = torch.empty((b, kh, g, s), dtype=torch.float32,
                              device=qq.device)
        err = _long_launcher()(*ptrs, build.ptr(scratch), b, n_planes, s,
                               kh, g, hd, long_chunk(s), win, float(softcap),
                               build.stream_of(qq))
        build.check(err, "decode_attention (long path)")
        long_launches += 1
        return out
    err = _launcher()(*ptrs, b, n_planes, s, kh, g, hd, c, win,
                      float(softcap), build.stream_of(qq))
    build.check(err, "decode_attention")
    launches += 1
    return out
