"""The arithmetic of the B3 decode-attention kernel
(``src/repro_torch/csrc/pann_attention.cu``), emulated in numpy step for
step as the kernel does it, on the CPU (the kernel itself runs only on the
card):

- the cluster's split of S into contiguous chunks (every position exactly
  once, ragged S, chunks wholly outside the mask [s_lo, s_hi]) and the
  wrapper's choice of cluster size from the card's occupancy;
- QK^T: a lane's 32-bit K words of the live planes, the 8 x 8 bit
  transpose into codes (against ``ref.unpack_cache_codes``), and the
  m16n8k32 tensor-core products (``mma_u8``, its PTX fragment layout
  emulated lane by lane) with the query codes in the transposed order as
  A rows and a row of ones for ``colsum``, both zero points corrected in
  int32;
- the fp32 epilogue and the softmax with the kernel's exchanges: block
  maxima, fp64 partial sums in the kernel's order (lanes, a shuffle tree,
  warps, then ranks in rank order), the largest valid V scale, the int32
  zero-point corrections;
- PV: the 4 x 4 byte transpose across lanes by two shuffles into the B
  fragment layout, the bit transpose, the m16n8k32 products with the
  probability codes split into low 7 bits (A rows g) and high bits (rows
  8 + g), the sums over warps and ranks, garbage in the shared-memory
  rows outside the mask adding nothing;
- the in-kernel clamp and round of the live-plane counts;
- the long path (caches past ``max_seq_len``): LONG_CLUSTER blocks a head
  over chunks of whole LONG_TILE-row tiles, scores and their exps through
  the global scratch, the three passes with the same exchanges, the V
  rows and probability codes a tile at a time with the PV accumulators
  carried across tiles, and the wrapper's choice between the two paths.

The emulation is held bit for bit against the plain version
``kernels.ref.decode_attention_ref`` (torch, CPU) for clusters of 1-8
blocks, 1-7 live planes, G in {1, 4, 8}, hd in {16, 128, 160, 256}, the
first, middle and last position, windows that mask whole chunks, and
softcap 0 and > 0; the long path at (1, 1, 4, 128), S = 12,288 and (1,
1, 2, 256), S = 7,200 with ragged positions, windows that mask whole
tiles and blocks, softcap and 1, 4 and 7 live planes. The
transcendental steps (``expf``, ``tanhf``) are taken from torch on the
CPU, as the plain version takes them: the card's own
``expf``/``tanhf`` are held against the plain version on the card by
``chip_smoke.py``. Tolerance: bit-identical (0).
"""
import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st

from repro_torch.kernels import pann_attention as tpa
from repro_torch.kernels import ref as tref
from test_torch_decode_math import byte_perm, transpose_bits, u32

WARPS = 8                     # kThreads / 32 in the kernel
NEG_INF = np.float32(-1e30)
PROB_SCALE = np.float32(16384.0)
P = tref.CACHE_PLANES


# ---------------------------------------------------------------------------
# the kernel's word operations
# ---------------------------------------------------------------------------

def ubytes(w) -> np.ndarray:
    """(..., 4) int64 unsigned bytes of uint32 words, byte 0 first."""
    w = np.ascontiguousarray(u32(w)).astype("<u4")
    return w.view(np.uint8).reshape(*w.shape, 4).astype(np.int64)


def mma_u8(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    """mma.sync.m16n8k32.row.col.s32.u8.u8.s32 with C = 0: lane fragments
    a (..., 32, 4) and b (..., 32, 2) uint32 -> c (..., 32, 4) int64.
    Lane l = 4 gid + tig: a0/a2 hold row gid, a1/a3 row gid + 8, columns
    4 tig + byte (a0, a1) and 16 + 4 tig + byte (a2, a3); b0/b1 hold
    column gid, rows 4 tig + byte and 16 + 4 tig + byte; c0/c1 are row
    gid, columns 2 tig and 2 tig + 1, c2/c3 the same of row gid + 8."""
    lane = np.arange(32)
    gid, tig = lane >> 2, lane & 3
    ab, bb = ubytes(a), ubytes(b)                     # (..., 32, 4|2, 4)
    lead = a.shape[:-2]
    A = np.zeros(lead + (16, 32), np.int64)
    B = np.zeros(lead + (32, 8), np.int64)
    for x in range(4):
        A[..., gid, 4 * tig + x] = ab[..., :, 0, x]
        A[..., gid + 8, 4 * tig + x] = ab[..., :, 1, x]
        A[..., gid, 16 + 4 * tig + x] = ab[..., :, 2, x]
        A[..., gid + 8, 16 + 4 * tig + x] = ab[..., :, 3, x]
        B[..., 4 * tig + x, gid] = bb[..., :, 0, x]
        B[..., 16 + 4 * tig + x, gid] = bb[..., :, 1, x]
    C = A @ B
    return np.stack([C[..., gid, 2 * tig], C[..., gid, 2 * tig + 1],
                     C[..., gid + 8, 2 * tig], C[..., gid + 8, 2 * tig + 1]],
                    -1)


def row_words(rows: np.ndarray) -> np.ndarray:
    """Plane rows (..., d8) uint8 -> the kernel's 32-bit words (..., WPR):
    byte c of word k = row byte 4k + c (hd = 16 pads its 2 bytes)."""
    d8 = rows.shape[-1]
    if d8 < 4:
        rows = np.concatenate(
            [rows, np.zeros(rows.shape[:-1] + (4 - d8,), np.uint8)], -1)
    return np.ascontiguousarray(rows).view("<u4").astype(np.uint32)


def live_planes(pact, n_planes: int) -> int:
    """live_planes(): a null count is every plane, else the count clamped to
    [1, P] in fp32 and rounded half to even."""
    if pact is None:
        return n_planes
    x = np.fmin(np.fmax(np.float32(pact), np.float32(1.0)),
                np.float32(n_planes))
    return int(np.rint(x))


def chunks(s: int, c: int) -> list:
    """[start, end) of each rank's positions: chunk = ceil(S / C)."""
    chunk = -(-s // c)
    return [(r * chunk, r * chunk + max(0, min(chunk, s - r * chunk)))
            for r in range(c)]


def warp_sum_tree(v: np.ndarray) -> np.ndarray:
    """warp_sum: 32 lanes, xor shuffles 16, 8, 4, 2, 1; lane 0's value."""
    v = v.copy()
    lanes = np.arange(32)
    for o in (16, 8, 4, 2, 1):
        v = v + v[lanes ^ o]
    return v[0]


# ---------------------------------------------------------------------------
# the kernel, one (batch, kv head) cluster at a time
# ---------------------------------------------------------------------------

def qk_scores(kpl, q, qz, q_scale, ks, kz, softcap, k_pact, hd):
    """Scores of positions (rows of kpl (P, n, d8)) as the kernel computes
    them: 8-row steps of m16n8k32 products on the transposed codes, then
    the fp32 epilogue. Returns (G, n) float32."""
    g_n = q.shape[0]
    d8 = hd // 8
    wk = row_words(kpl)                               # (P, n, WPR)
    wpr = wk.shape[-1]
    n = wk.shape[1]
    halves = -(-wpr // 4)                             # kHalves
    # query words: word (g, k, i), byte c = q[g, 8 (4k + c) + i]
    qpad = np.zeros((g_n, max(d8, 4) * 8), np.int64)
    qpad[:, :hd] = q
    qb = qpad.reshape(g_n, wpr, 4, 8)                 # [g, k, c, i]
    qw = sum(qb[:, :, c, :].astype(np.uint32) << np.uint32(8 * c)
             for c in range(4)).astype(np.uint32)    # [g, k, i]
    steps = -(-n // 8)
    lane = np.arange(32)
    n_l, kq = lane >> 2, lane & 3
    row = np.arange(steps)[:, None] * 8 + n_l[None]   # (steps, 32) loads
    c = np.zeros((steps, 32, 4), np.int64)
    ones = np.where(n_l == 0, 0x01010101, 0).astype(np.uint32)
    for u in range(halves):
        k = kq + 4 * u
        ok = (row < n) & (k < wpr)[None]
        w = [np.where(ok, wk[p][np.minimum(row, n - 1), np.minimum(k, wpr - 1)],
                      0).astype(np.uint32) if p < k_pact
             else u32(np.zeros(row.shape)) for p in range(P)]
        code = transpose_bits(w + [u32(np.zeros(row.shape))])
        for m2 in range(4):
            qa = [np.where((n_l < g_n) & (k < wpr),
                           qw[np.minimum(n_l, g_n - 1), np.minimum(k, wpr - 1),
                              2 * m2 + e2], 0).astype(np.uint32)
                  for e2 in range(2)]
            a = np.broadcast_to(np.stack([qa[0], ones, qa[1], ones], -1),
                                (steps, 32, 4))
            b = np.stack([code[2 * m2], code[2 * m2 + 1]], -1)
            c = c + mma_u8(a, b)
    # lane (n_l, kq): dot of head n_l at rows 2kq, 2kq + 1 of the step; the
    # colsums are row 8, held by lane kq (a shuffle)
    cs = np.stack([c[:, kq, 2], c[:, kq, 3]], -1)     # (steps, 32, 2)
    out = np.zeros((g_n, n), np.float32)
    rowsum = q.sum(-1)
    for e2 in range(2):
        so = np.arange(steps)[:, None] * 8 + 2 * kq[None] + e2
        sel = (so < n) & (n_l < g_n)[None]
        g_i, s_i = n_l[None].repeat(steps, 0)[sel], so[sel]
        kzi = np.rint(kz[s_i]).astype(np.int64)
        i32 = (c[:, :, e2][sel] - qz * cs[:, :, e2][sel] - kzi * rowsum[g_i]
               + qz * kzi * hd)
        assert np.abs(i32).max(initial=0) < 2 ** 31
        v = (i32.astype(np.float32) * np.float32(q_scale)) * ks[s_i]
        if softcap > 0:
            cap = np.float32(softcap)
            v = cap * torch.tanh(torch.from_numpy(v / cap)).numpy()
        out[g_i, s_i] = v
    return out


def pv_steps(lv0: int, lv1: int, n_oct: int) -> list:
    """The 32-row steps r0 of one byte octet, as its warps take them: warp
    w of octet w % n_oct is part w // n_oct of wpo = WARPS // n_oct, and
    the warps past wpo parts (hd = 160: warps 6, 7) take none."""
    wpo = WARPS // n_oct
    steps = []
    for part_w in range(-(-WARPS // n_oct)):
        r_first = (lv0 // 32 + part_w) * 32 if part_w < wpo else lv1
        steps += list(range(r_first, lv1, 32 * wpo))
    return steps


def pv_partial(vsm, pql, pqh, v_pact, lv0, lv1, hd):
    """One block's PV partial (G, hd) int64 from its shared rows vsm
    (P, cp, d8) and probability code bytes pql / pqh (G, cp), lane by lane
    over the 32-row steps each warp takes and the byte octets."""
    d8 = hd // 8
    words = row_words(vsm)                            # (P, cp, WPR)
    wpr = words.shape[-1]
    g_n = pql.shape[0]
    lane = np.arange(32)
    n_l, kq = lane >> 2, lane & 3
    kp, mp = n_l >> 2, n_l & 3
    out = np.zeros((g_n, hd), np.int64)
    if lv1 <= lv0:
        return out
    n_oct = -(-d8 // 8)

    def pq_word(arr, col):                            # 4 bytes from col
        gi = np.minimum(n_l, g_n - 1)
        w = sum(arr[gi, col + x].astype(np.uint32) << np.uint32(8 * x)
                for x in range(4))
        return np.where(n_l < g_n, w, 0).astype(np.uint32)

    for oct_ in range(n_oct):
        steps = pv_steps(lv0, lv1, n_oct)
        # every step of the block's rows taken by exactly one warp
        assert sorted(steps) == list(range(lv0 // 32 * 32, lv1, 32))
        r0 = np.asarray(steps)[:, None]               # (steps, 1)
        wd = 2 * oct_ + kp                            # per lane
        acc = np.zeros((r0.shape[0], 32, 8, 4), np.int64)
        halves = []
        for off in (0, 16):
            rows = r0 + off + 4 * kq + mp             # (steps, 32)
            ok = (wd < wpr)[None]
            code = []
            for p in range(P):
                x = (np.where(ok, words[p][rows, np.minimum(wd, wpr - 1)],
                              0).astype(np.uint32) if p < v_pact
                     else u32(np.zeros(rows.shape)))
                y = x[:, lane ^ 8]
                z = np.where(mp & 2, byte_perm(y, x, 0x7632),
                             byte_perm(x, y, 0x5410))
                y = z[:, lane ^ 4]
                code.append(u32(np.where(mp & 1, byte_perm(y, z, 0x7351),
                                         byte_perm(z, y, 0x6240))))
            halves.append(transpose_bits(code + [u32(np.zeros(rows.shape))]))
        col = r0 + 4 * kq                             # (steps, 32)
        a = np.stack([pq_word(pql, col), pq_word(pqh, col),
                      pq_word(pql, col + 16), pq_word(pqh, col + 16)], -1)
        for i in range(8):
            acc[:, :, i] = mma_u8(a, np.stack([halves[0][i], halves[1][i]],
                                              -1))
        acc = acc.sum(0)                              # the warps' steps
        for e2 in range(2):
            j = 8 * oct_ + 2 * kq + e2
            keep = (n_l < g_n) & (j < d8)
            for i in range(8):
                np.add.at(out, (n_l[keep], 8 * j[keep] + i),
                          acc[keep, i, e2] + 128 * acc[keep, i, 2 + e2])
    return out


def emulate(a: dict, pos: int, window, softcap: float, c: int,
            k_pact=None, v_pact=None, seed: int = 0) -> np.ndarray:
    """The kernel's output (B, KH, G, hd) for numpy operands ``a`` at
    cluster size ``c``."""
    rng = np.random.default_rng(seed)
    b_n, kh_n, g_n, hd = a["qq"].shape
    n_planes, s = a["k_planes"].shape[1:3]
    d8 = hd // 8
    qz = int(np.float32(a["q_z"]).astype(np.int32))   # static_cast<int>
    kp = live_planes(k_pact, n_planes)
    vp = live_planes(v_pact, n_planes)
    w = window if window is not None else -1
    s_lo = max(0, pos - w + 1) if w > 0 else 0
    s_hi = min(pos, s - 1)
    wpg = WARPS // g_n
    chunk = -(-s // c)
    cp = -(-chunk // 32) * 32
    out = np.zeros((b_n, kh_n, g_n, hd), np.float32)
    for b in range(b_n):
        for kh in range(kh_n):
            q = a["qq"][b, kh].astype(np.int64)
            blocks = []
            for c0, c1 in chunks(s, c):
                length = c1 - c0
                v0, v1 = max(c0, s_lo), min(c1, s_hi + 1)
                sc = np.full((g_n, cp), NEG_INF, np.float32)
                if v1 > v0:
                    sc[:, v0 - c0:v1 - c0] = qk_scores(
                        a["k_planes"][b, :, v0:v1, kh], q, qz,
                        a["q_scale"], a["k_s"][b, v0:v1], a["k_z"][b, v0:v1],
                        softcap, kp, hd)
                # the shared V rows: copied inside the mask, garbage outside
                vsm = rng.integers(0, 256, (P, cp, d8)).astype(np.uint8)
                vsm[:vp, v0 - c0:max(v0, v1) - c0] = \
                    a["v_planes"][b, :vp, v0:max(v0, v1), kh]
                blocks.append(dict(c0=c0, len=length, v0=v0, v1=v1, sc=sc,
                                   vsm=vsm))
            # exchange 1: maxima (per warp, per head, then ranks)
            for blk in blocks:
                blk["m"] = np.array([
                    max([NEG_INF] + [blk["sc"][g, :blk["len"]].max()
                                     if blk["len"] else NEG_INF])
                    for g in range(g_n)], np.float32)
                vs_valid = a["v_s"][b, blk["v0"]:blk["v1"]]
                blk["vmax"] = np.float32(max([0.0] + list(vs_valid)))
            m = np.max([blk["m"] for blk in blocks], axis=0)
            sv_ref = np.float32(max(np.float32(1e-12),
                                    max(blk["vmax"] for blk in blocks)))
            # exchange 2: fp64 partial sums in the kernel's order: warp
            # (g, wp) lane l adds positions wp * 32 + l + 32 * wpg * n in
            # turn, then the shuffle tree, the warps of g, the ranks
            for blk in blocks:
                part = np.zeros(g_n)
                n_it = -(-cp // (32 * wpg))
                for g in range(g_n):
                    e = torch.exp(torch.from_numpy(
                        blk["sc"][g, :blk["len"]] - m[g])).numpy()
                    blk["sc"][g, :blk["len"]] = e
                    ed = np.zeros(n_it * 32 * wpg)
                    ed[:blk["len"]] = e
                    seq = np.cumsum(ed.reshape(n_it, wpg, 32), axis=0)[-1]
                    tot = 0.0
                    for wp in range(wpg):
                        tot += warp_sum_tree(seq[wp])
                    part[g] = tot
                blk["part"] = part
            denom = np.zeros(g_n)
            for blk in blocks:
                denom = denom + blk["part"]
            denom = denom.astype(np.float32)
            # requantize; zero-point corrections per block
            corr = np.zeros(g_n, np.int64)
            for blk in blocks:
                pq = np.zeros((g_n, cp), np.int64)
                lo, hi = blk["v0"] - blk["c0"], blk["v1"] - blk["c0"]
                if hi > lo:
                    gs = slice(blk["v0"], blk["v1"])
                    ratio = a["v_s"][b, gs] / sv_ref
                    pr = blk["sc"][:, lo:hi] / denom[:, None]
                    qv = np.rint((pr * ratio[None]) * PROB_SCALE)
                    assert qv.min() >= 0 and qv.max() <= 1 << 14
                    pq[:, lo:hi] = qv.astype(np.int64)
                    corr += (qv.astype(np.int64)
                             * np.rint(a["v_z"][b, gs]).astype(np.int64)
                             ).sum(-1)
                blk["pv"] = pv_partial(blk["vsm"], (pq & 127).astype(np.uint8),
                                       (pq >> 7).astype(np.uint8), vp,
                                       blk["v0"] - blk["c0"],
                                       blk["v1"] - blk["c0"]
                                       if blk["v1"] > blk["v0"] else 0, hd)
            pv = sum(blk["pv"] for blk in blocks)
            scale = sv_ref / PROB_SCALE
            out[b, kh] = ((pv - corr[:, None]).astype(np.float32) * scale)
    return out


def emulate_long(a: dict, pos: int, window, softcap: float, k_pact=None,
                 v_pact=None, seed: int = 0) -> np.ndarray:
    """The long-path kernel's output (B, KH, G, hd): LONG_CLUSTER blocks
    over chunks of whole tiles, pass 1's scores (the cluster kernel's QK^T
    steps from the block's first valid row) and maxima, pass 2's fp64
    partial sums (warp (g, part) lane l: positions v0 + 32 part + l +
    32 wpg n in turn, the shuffle tree, the warps of g, then the ranks),
    pass 3 a tile at a time (V rows copied for the tile's valid rows over
    the last tile's, codes 0 outside them, the PV steps of the tile's
    32-row groups holding valid rows)."""
    rng = np.random.default_rng(seed)
    b_n, kh_n, g_n, hd = a["qq"].shape
    n_planes, s = a["k_planes"].shape[1:3]
    d8 = hd // 8
    tile = tpa.LONG_TILE
    qz = int(np.float32(a["q_z"]).astype(np.int32))
    kp = live_planes(k_pact, n_planes)
    vp = live_planes(v_pact, n_planes)
    w = window if window is not None else -1
    s_lo = max(0, pos - w + 1) if w > 0 else 0
    s_hi = min(pos, s - 1)
    wpg = WARPS // g_n
    chunk = tpa.long_chunk(s)
    out = np.zeros((b_n, kh_n, g_n, hd), np.float32)
    for b in range(b_n):
        for kh in range(kh_n):
            q = a["qq"][b, kh].astype(np.int64)
            scg = np.zeros((g_n, s), np.float32)     # the global scratch
            blocks = []
            for r in range(tpa.LONG_CLUSTER):
                c0 = r * chunk
                v0, v1 = max(c0, s_lo), min(c0 + chunk, s, s_hi + 1)
                blk = dict(v0=v0, v1=v1, m=np.full(g_n, NEG_INF, np.float32),
                           vmax=np.float32(0.0))
                if v1 > v0:
                    scg[:, v0:v1] = qk_scores(
                        a["k_planes"][b, :, v0:v1, kh], q, qz,
                        a["q_scale"], a["k_s"][b, v0:v1], a["k_z"][b, v0:v1],
                        softcap, kp, hd)
                    blk["m"] = scg[:, v0:v1].max(-1)
                    blk["vmax"] = np.float32(a["v_s"][b, v0:v1].max())
                blocks.append(blk)
            m = np.max([blk["m"] for blk in blocks], axis=0)
            sv_ref = np.float32(max(np.float32(1e-12),
                                    max(blk["vmax"] for blk in blocks)))
            denom = np.zeros(g_n)
            for blk in blocks:                        # ranks in rank order
                v0, v1 = blk["v0"], blk["v1"]
                n = max(0, v1 - v0)
                n_it = max(1, -(-n // (32 * wpg)))
                for g in range(g_n):
                    e = torch.exp(torch.from_numpy(scg[g, v0:v0 + n]
                                                   - m[g])).numpy()
                    scg[g, v0:v0 + n] = e
                    ed = np.zeros(n_it * 32 * wpg)
                    ed[:n] = e
                    seq = np.cumsum(ed.reshape(n_it, wpg, 32), axis=0)[-1]
                    tot = 0.0
                    for wp in range(wpg):
                        tot += warp_sum_tree(seq[wp])
                    denom[g] += tot
            denom = denom.astype(np.float32)
            pv = np.zeros((g_n, hd), np.int64)
            corr = np.zeros(g_n, np.int64)
            for blk in blocks:
                v0, v1 = blk["v0"], blk["v1"]
                if v1 <= v0:
                    continue
                # the shared tile: garbage before the first copy, then each
                # tile's rows written over the last tile's
                vsm = rng.integers(0, 256, (P, tile, d8)).astype(np.uint8)
                for t0 in range(v0 // tile * tile, v1, tile):
                    a0, a1 = max(t0, v0), min(t0 + tile, v1)
                    vsm[:vp, a0 - t0:a1 - t0] = \
                        a["v_planes"][b, :vp, a0:a1, kh]
                    ratio = a["v_s"][b, a0:a1] / sv_ref
                    pr = scg[:, a0:a1] / denom[:, None]
                    qv = np.rint((pr * ratio[None]) * PROB_SCALE)
                    assert qv.min() >= 0 and qv.max() <= 1 << 14
                    pq = np.zeros((g_n, tile), np.int64)
                    pq[:, a0 - t0:a1 - t0] = qv.astype(np.int64)
                    corr += (qv.astype(np.int64)
                             * np.rint(a["v_z"][b, a0:a1]).astype(np.int64)
                             ).sum(-1)
                    pv += pv_partial(vsm, (pq & 127).astype(np.uint8),
                                     (pq >> 7).astype(np.uint8), vp,
                                     a0 - t0, a1 - t0, hd)
            scale = sv_ref / PROB_SCALE
            out[b, kh] = ((pv - corr[:, None]).astype(np.float32) * scale)
    return out


# ---------------------------------------------------------------------------
# operands
# ---------------------------------------------------------------------------

def operands(seed, b=1, kh=1, g=4, hd=16, s=40, bits=4):
    rng = np.random.default_rng(seed)
    kc = rng.integers(0, 1 << bits, (b, s, kh, hd))
    vc = rng.integers(0, 1 << bits, (b, s, kh, hd))
    pk = tref.pack_cache_codes(torch.from_numpy(kc)).movedim(0, 1)
    pv = tref.pack_cache_codes(torch.from_numpy(vc)).movedim(0, 1)
    return dict(
        qq=rng.integers(0, 128, (b, kh, g, hd)).astype(np.int32),
        q_z=np.float32(rng.integers(0, 128)),
        q_scale=np.float32(rng.uniform(0.002, 0.02)),
        k_planes=np.ascontiguousarray(pk.numpy()),
        k_s=rng.uniform(0.01, 0.2, (b, s)).astype(np.float32),
        k_z=rng.integers(0, 1 << bits, (b, s)).astype(np.float32),
        v_planes=np.ascontiguousarray(pv.numpy()),
        v_s=rng.uniform(0.01, 0.2, (b, s)).astype(np.float32),
        v_z=rng.integers(0, 1 << bits, (b, s)).astype(np.float32),
        kc=kc, vc=vc)


KEYS = ("qq", "q_z", "q_scale", "k_planes", "k_s", "k_z", "v_planes",
        "v_s", "v_z")


def plain(a, pos, window, softcap) -> np.ndarray:
    args = [torch.from_numpy(np.asarray(a[k])) for k in KEYS]
    return tpa.decode_attention_plain(
        *args, torch.tensor(pos, dtype=torch.int32), window=window,
        softcap=softcap).numpy()


# ---------------------------------------------------------------------------
# tests
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("hd", [16, 32, 64, 128, 160, 256])
@pytest.mark.parametrize("bits", range(1, 8))
def test_transposed_k_words_are_the_cache_codes(hd, bits):
    """The bit transpose of a position's live plane words gives the codes
    ref.unpack_cache_codes gives, element 8 (4k + c) + i at byte c of
    word (k, i)."""
    rng = np.random.default_rng(hd * 10 + bits)
    codes = rng.integers(0, 1 << bits, (5, hd))
    planes = tref.pack_cache_codes(torch.from_numpy(codes)).numpy()
    want = tref.unpack_cache_codes(torch.from_numpy(planes)).numpy()
    words = row_words(planes)                         # (P, 5, WPR)
    for k in range(words.shape[-1]):
        code = transpose_bits([words[p, :, k] for p in range(P)]
                              + [u32(np.zeros(5))])
        got = ubytes(np.stack(code, -1))              # (5, 8 i, 4 c)
        for i in range(8):
            for c in range(4):
                e = 8 * (4 * k + c) + i
                if e < hd:
                    np.testing.assert_array_equal(got[:, i, c], want[:, e])
                else:
                    assert not got[:, i, c].any()


@pytest.mark.parametrize("hd", [16, 32, 64, 128, 160, 256])
def test_lane_byte_transpose_builds_the_b_fragments(hd):
    """PV's two shuffles and four byte_perms: lane 4 (4 k' + m') + kq,
    which read word 2 oct + k' of row 4 kq + m', ends with byte
    8 oct + 4 k' + m' (its B column) of rows 4 kq .. 4 kq + 3 (its B rows),
    one per byte lane."""
    d8 = hd // 8
    rng = np.random.default_rng(hd)
    rows = rng.integers(0, 256, (16, d8)).astype(np.uint8)
    words = row_words(rows)
    wpr = words.shape[-1]
    lane = np.arange(32)
    n_l, kq = lane >> 2, lane & 3
    kp, mp = n_l >> 2, n_l & 3
    padded = np.zeros((16, 4 * wpr), np.int64)
    padded[:, :d8] = rows
    for oct_ in range(-(-d8 // 8)):
        wd = 2 * oct_ + kp
        x = np.where(wd < wpr, words[4 * kq + mp, np.minimum(wd, wpr - 1)],
                     0).astype(np.uint32)
        y = x[lane ^ 8]
        z = np.where(mp & 2, byte_perm(y, x, 0x7632), byte_perm(x, y, 0x5410))
        y = z[lane ^ 4]
        got = ubytes(np.where(mp & 1, byte_perm(y, z, 0x7351),
                              byte_perm(z, y, 0x6240)))
        j = 8 * oct_ + n_l
        for r in range(4):
            want = np.where(j < 4 * wpr,
                            padded[4 * kq + r, np.minimum(j, 4 * wpr - 1)], 0)
            np.testing.assert_array_equal(got[:, r], want)


def test_mma_fragments_multiply_the_matrices():
    """mma_u8 on fragments cut from a random A (16 x 32) and B (32 x 8)
    with the PTX layout gives A @ B in the C layout."""
    rng = np.random.default_rng(7)
    A = rng.integers(0, 256, (16, 32))
    B = rng.integers(0, 256, (32, 8))
    lane = np.arange(32)
    gid, tig = lane >> 2, lane & 3

    def word(vals):
        return sum(vals[x].astype(np.uint32) << np.uint32(8 * x)
                   for x in range(4)).astype(np.uint32)
    a = np.stack([word([A[gid, 4 * tig + x] for x in range(4)]),
                  word([A[gid + 8, 4 * tig + x] for x in range(4)]),
                  word([A[gid, 16 + 4 * tig + x] for x in range(4)]),
                  word([A[gid + 8, 16 + 4 * tig + x] for x in range(4)])], -1)
    b = np.stack([word([B[4 * tig + x, gid] for x in range(4)]),
                  word([B[16 + 4 * tig + x, gid] for x in range(4)])], -1)
    c = mma_u8(a, b)
    C = A @ B
    np.testing.assert_array_equal(c[:, 0], C[gid, 2 * tig])
    np.testing.assert_array_equal(c[:, 3], C[gid + 8, 2 * tig + 1])


@pytest.mark.parametrize("s", [1, 2, 7, 48, 63, 64, 65, 1000, 4096, 12000])
@pytest.mark.parametrize("c", range(1, 9))
def test_chunks_cover_every_position_once(s, c):
    """Ranks' chunks, and their parts inside any mask, cover each position
    exactly once; chunks past S are empty."""
    seen = np.zeros(s, int)
    for c0, c1 in chunks(s, c):
        assert 0 <= c1 - c0 <= -(-s // c)
        seen[c0:c1] += 1
    assert (seen == 1).all()
    for s_lo, s_hi in ((0, s - 1), (s // 3, s // 2), (s - 1, s - 1), (0, 0)):
        hit = np.zeros(s, int)
        for c0, c1 in chunks(s, c):
            v0, v1 = max(c0, s_lo), min(c1, s_hi + 1)
            if v1 > v0:
                hit[v0:v1] += 1
        assert (hit == ((np.arange(s) >= s_lo) & (np.arange(s) <= s_hi))
                ).all()


@pytest.mark.parametrize("pact,want", [
    (None, 7), (0.0, 1), (-3.0, 1), (0.4, 1), (1.0, 1), (2.5, 2), (3.5, 4),
    (4.0, 4), (6.6, 7), (7.0, 7), (9.0, 7), (float("nan"), 1)])
def test_live_plane_count_is_clamped_and_rounded(pact, want):
    assert live_planes(pact, P) == want


def test_cluster_size_follows_occupancy_and_shared_memory():
    """The wrapper's choice at the H100's occupancy (clusters of c blocks
    the card holds at once, one block of 256 threads per SM slot; read off
    the card for the serve's shape): the serve's S = 48 stays in one block,
    S = 4096 spreads over 7 blocks a head so the 32 clusters fit one wave;
    above max_seq_len it takes the long path, and with no cluster held it
    raises."""
    held = {1: 132, 2: 66, 3: 39, 4: 30, 5: 22, 6: 39, 7: 32, 8: 30}

    def pick(s):
        path, c = tpa.launch_plan(s, 32, 4, 128, P, held.get)
        assert path == ("cluster" if s <= top else "long")
        return c
    top = tpa.max_seq_len(4, 128)
    assert pick(48) == 1
    assert pick(4096) == 7
    assert pick(1000) > 1
    assert pick(top) >= 1
    assert pick(top + 1) == tpa.LONG_CLUSTER
    with pytest.raises(ValueError):
        tpa.cluster_size(top + 1, 32, 4, 128, P, held.get)
    with pytest.raises(RuntimeError):
        tpa.cluster_size(4096, 32, 4, 128, P, lambda c: 0)
    for s in (48, 1000, 4096, top):
        c = pick(s)
        assert tpa.smem_bytes(s, c, 4, 128) <= tpa.DYN_SMEM_BYTES
        assert c == 1 or -(-s // c) >= tpa.MIN_CHUNK


@pytest.mark.parametrize("hd", tpa.HEAD_DIMS)
def test_shared_rows_and_copies_cover_a_head_row(hd):
    """The kernel's Rows<D8>: the shared row (kRS bytes) is the wrapper's
    row in ``smem_bytes``, a cp.async piece divides the head's row and the
    alignment of its start (a multiple of D8 bytes), and the pieces cover
    the row; the QK^T halves and PV octets cover every 32-bit word and
    every byte. At hd = 160 (20-byte rows) that is five 4-byte copies,
    two halves and three octets of which two warps each work."""
    d8 = hd // 8
    wpr = d8 // 4 if d8 >= 4 else 1
    rs = 4 * wpr
    copy = (16 if d8 % 16 == 0 else 8 if d8 % 8 == 0 else 4 if d8 >= 4
            else d8)
    assert rs == max(hd // 8, 4)
    assert tpa.smem_bytes(64, 1, 4, hd) == 64 * (P * rs + 6 * 4 + 8)
    assert d8 % copy == 0 and (d8 // copy) * copy == d8
    assert copy in (2, 4, 8, 16) and rs >= d8
    assert 4 * -(-wpr // 4) >= wpr and -(-wpr // 4) <= 2
    n_oct = -(-d8 // 8)
    assert 8 * n_oct >= d8 and WARPS // n_oct >= 1
    if hd == 160:
        assert (copy, d8 // copy, -(-wpr // 4), n_oct) == (4, 5, 2, 3)
        assert tpa.max_seq_len(4, 160) >= 4096
    for lv0, lv1 in ((0, 48), (5, 300), (40, 41), (0, 1280)):
        steps = pv_steps(lv0, lv1, n_oct)
        assert sorted(steps) == list(range(lv0 // 32 * 32, lv1, 32))


@pytest.mark.parametrize("g,hd", [(1, 16), (4, 16), (8, 16), (1, 128),
                                  (4, 128), (6, 128), (8, 128), (1, 160),
                                  (4, 160), (8, 160), (1, 256), (4, 256),
                                  (8, 256)])
@pytest.mark.parametrize("c", range(1, 9))
def test_emulated_kernel_is_the_plain_version(c, g, hd):
    """Every live-plane count 1-7, each with one of the (pos, window)
    cases in turn (the last, middle and first position, a window that
    leaves whole chunks masked, a short one mid-cache) and softcap 0 or
    30 in turn: bit-identical to decode_attention_ref."""
    s = 45 + 13 * c
    chunk = -(-s // c)
    cases = ((s - 1, None), (s // 2, None), (0, None),
             (s - 1, chunk // 2 + 1), (s // 2, 3))
    for bits in range(1, 8):
        a = operands(100 * c + 10 * g + bits, g=g, hd=hd, s=s, bits=bits)
        softcap = 0.0 if bits % 2 else 30.0
        pos, window = cases[(bits + c) % len(cases)]
        want = plain(a, pos, window, softcap)
        got = emulate(a, pos, window, softcap, c, k_pact=float(bits),
                      v_pact=bits + 0.3)
        np.testing.assert_array_equal(got, want)


@settings(max_examples=30, deadline=None)
@given(seed=st.integers(0, 2 ** 31 - 1), c=st.integers(1, 8),
       g=st.sampled_from([1, 2, 3, 4, 6, 8]),
       hd=st.sampled_from([16, 32, 64, 128, 160, 256]),
       s=st.integers(1, 150), bits=st.integers(1, 7),
       pos_frac=st.floats(0, 1), window=st.one_of(st.none(),
                                                  st.integers(1, 160)))
def test_emulated_kernel_random_shapes(seed, c, g, hd, s, bits, pos_frac,
                                       window):
    """Random shapes, positions, windows and plane counts (pact = None:
    every plane read, the dead ones all-zero)."""
    a = operands(seed % 10_000, b=2, kh=1, g=g, hd=hd, s=s, bits=bits)
    pos = min(s - 1, int(pos_frac * s))
    want = plain(a, pos, window, 0.0)
    got = emulate(a, pos, window, 0.0, c, seed=seed)
    np.testing.assert_array_equal(got, want)


# ---------------------------------------------------------------------------
# the long path
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("g,hd", [(4, 128), (2, 256), (1, 64), (8, 160)])
def test_long_path_is_taken_past_the_cap_and_bounded_by_int32(g, hd):
    """launch_plan keeps the cluster sizes up to max_seq_len (S = 48,
    1,000, 4,096 as cluster_size picks them), takes the long path from
    max_seq_len + 1 on, at 524,288 (long_500k) too, and raises only past
    the int32 PV bound, where 127 * (2^14 + S / 2) passes 2^31."""
    held = {1: 132, 2: 66, 3: 39, 4: 30, 5: 22, 6: 39, 7: 32, 8: 30}
    top = tpa.max_seq_len(g, hd)
    for s in (48, 1000, 4096):
        if s <= top:
            assert tpa.launch_plan(s, 32, g, hd, P, held.get) == (
                "cluster", tpa.cluster_size(s, 32, g, hd, P, held.get))
    assert tpa.launch_plan(top + 1, 32, g, hd, P, held.get) == (
        "long", tpa.LONG_CLUSTER)
    assert tpa.launch_plan(524_288, 32, g, hd, P, lambda c: 0)[0] == "long"
    big = tpa.max_long_seq_len()
    assert 127 * (2 ** 14 + big / 2) < 2 ** 31
    assert 127 * (2 ** 14 + (big + 2) / 2) >= 2 ** 31
    assert tpa.launch_plan(big, 32, g, hd, P, held.get)[0] == "long"
    with pytest.raises(ValueError):
        tpa.launch_plan(big + 1, 32, g, hd, P, held.get)


@pytest.mark.parametrize("s", [12_033, 12_288, 32_768, 131_072, 524_288,
                               7_169, 33_785_872])
def test_long_chunks_tile_every_position_once(s):
    """long_chunk: whole tiles, LONG_CLUSTER chunks cover [0, S), every
    position in exactly one tile of one block, whatever the mask."""
    chunk = tpa.long_chunk(s)
    assert chunk % tpa.LONG_TILE == 0
    assert (tpa.LONG_CLUSTER - 1) * chunk < s <= tpa.LONG_CLUSTER * chunk
    for s_lo, s_hi in ((0, s - 1), (s // 3, s // 2), (s - 1, s - 1), (0, 0),
                       (s - 300, s - 1)):
        seen = 0
        for r in range(tpa.LONG_CLUSTER):
            c0 = r * chunk
            v0, v1 = max(c0, s_lo), min(c0 + chunk, s, s_hi + 1)
            if v1 <= v0:
                continue
            for t0 in range(v0 // tpa.LONG_TILE * tpa.LONG_TILE, v1,
                            tpa.LONG_TILE):
                assert c0 <= t0 and t0 + tpa.LONG_TILE <= c0 + chunk
                seen += min(t0 + tpa.LONG_TILE, v1) - max(t0, v0)
        assert seen == s_hi - s_lo + 1


@pytest.mark.parametrize("g,hd,s", [(4, 128, 12_288), (2, 256, 7_200)])
@pytest.mark.parametrize("bits", [1, 4, 7])
def test_emulated_long_path_is_the_plain_version(g, hd, s, bits):
    """The long path past max_seq_len, bit-identical to
    decode_attention_ref: the last position, a ragged middle one, a window
    that masks whole tiles and blocks, one ending mid-tile, the first
    position; softcap 0 and 50 in turn; pact as a device count."""
    assert s > tpa.max_seq_len(g, hd)
    a = operands(1000 * bits + g, g=g, hd=hd, s=s, bits=bits)
    cases = ((s - 1, None, 0.0), (s // 2 + 37, None, 50.0),
             (s - 1, 700, 0.0), (s // 3 + 5, 4_000, 50.0), (0, None, 0.0))
    for pos, window, softcap in cases:
        want = plain(a, pos, window, softcap)
        got = emulate_long(a, pos, window, softcap, k_pact=float(bits),
                           v_pact=bits + 0.3, seed=pos)
        np.testing.assert_array_equal(got, want)


def test_emulated_long_path_ring_position():
    """A ring's step past its rows: pos beyond S with no window reads every
    row (s_hi = S - 1), as the plain version's ``k_pos <= pos`` does."""
    s = tpa.max_seq_len(2, 256) + 40
    a = operands(77, g=2, hd=256, s=s, bits=4)
    for pos in (s, 3 * s + 11):
        want = plain(a, pos, None, 50.0)
        np.testing.assert_array_equal(want, plain(a, s - 1, None, 50.0))
        got = emulate_long(a, pos, None, 50.0, k_pact=4.0, v_pact=4.0)
        np.testing.assert_array_equal(got, want)


def test_wrapper_path_option_on_the_cpu():
    """``decode_attention(..., path="long")`` (the forced long path that
    ``chip_smoke.py`` times below the cap) is the plain version on CPU
    tensors, as None is; any other path is refused."""
    a = operands(31, b=2, kh=2, g=2, hd=32, s=70)
    args = [torch.from_numpy(np.asarray(a[k])) for k in KEYS]
    pos = torch.tensor(50, dtype=torch.int32)
    want = plain(a, 50, 16, 30.0)
    for path in (None, "long"):
        got = tpa.decode_attention(*args, pos, window=16, softcap=30.0,
                                   path=path)
        np.testing.assert_array_equal(got.numpy(), want)
    with pytest.raises(ValueError, match="path"):
        tpa.decode_attention(*args, pos, path="cluster")
