"""The integer arithmetic of the tensor-core tile kernel that B1
``pann_matmul_act`` and B4 ``pann_matmul`` run above 8 rows
(``src/repro_torch/csrc/pann_tc.cuh``), emulated in numpy step for step as
the kernel does it, on the CPU (the kernel itself runs only on the card):

- the SIMD-within-a-register rebuild: 32-bit words of 4 plane bytes, the
  OR of the live planes shifted by p, the per-byte subtraction without
  borrow read as int8, the 4 x 4 byte transpose (``__byte_perm``) and the
  rotated stores into wgmma's K-major no-swizzle tile, against
  ``kernels.pann_matmul.rebuild_weight`` for P = 1..7 and every
  plane_shift, |w| = 127 included;
- the product read back through the wgmma descriptors (LBO 128 B, SBO
  8 kK B), 'fused' and 'planes' (pos_p and neg_p tiles pre-scaled by 2^p,
  two accumulators, one subtraction), against ``int_product`` and the JAX
  package's oracle ``repro.kernels.ref.pann_matmul_ref``;
- B1's encode without a division per code: rint(x * (1/s)) with the
  near-tie test, against IEEE rint(x / s);
- ``split_k`` of the tile kernel at every shape the card is checked at.

Tolerance: all integer results are bit-identical (0).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st

from repro.kernels import ref as rref
from repro_torch.kernels import pann_matmul as tpm

TILE_N = 128
K_STEP = {"fused": 64, "planes": 32}


def byte_perm(x, y, sel: int):
    """CUDA's __byte_perm(x, y, sel) on uint32 arrays (selector nibbles
    0-7: byte i of the result is byte sel_i of y:x)."""
    src = np.stack([(x >> (8 * i)) & 0xFF for i in range(4)]
                   + [(y >> (8 * i)) & 0xFF for i in range(4)])
    out = np.zeros_like(x)
    for i in range(4):
        out |= src[(sel >> (4 * i)) & 7] << np.uint32(8 * i)
    return out


def transpose4(a0, a1, a2, a3):
    """The kernel's transpose4: 4 rows of 4 bytes -> 4 columns."""
    t0, t1 = byte_perm(a0, a1, 0x5140), byte_perm(a0, a1, 0x7362)
    t2, t3 = byte_perm(a2, a3, 0x5140), byte_perm(a2, a3, 0x7362)
    return [byte_perm(t0, t2, 0x5410), byte_perm(t0, t2, 0x7632),
            byte_perm(t1, t3, 0x5410), byte_perm(t1, t3, 0x7632)]


def vsub4(a, b):
    """__vsub4: per-byte a - b modulo 256, no borrow between bytes."""
    out = np.zeros_like(a)
    for i in range(4):
        d = (((a >> (8 * i)) & 0xFF) - ((b >> (8 * i)) & 0xFF)) & 0xFF
        out |= d << np.uint32(8 * i)
    return out


def tile_off(r, k, kk: int):
    """Byte (r, k) of a rows x kk K-major tile in wgmma's no-swizzle
    canonical layout (pann_tc.cuh tile_off); r, k may be arrays."""
    return ((r >> 3) * (kk // 16) + (k >> 4)) * 128 + (r & 7) * 16 + (k & 15)


def words(plane_rows: np.ndarray) -> np.ndarray:
    """(rows, 128) uint8 plane bytes -> (rows, 32) uint32 words, byte b of
    word j = column 4j + b (a little-endian 4-byte load)."""
    return np.ascontiguousarray(plane_rows).view("<u4").astype(np.uint32)


def store_tile(tile: np.ndarray, w: list, kk: int) -> None:
    """The workers' stores: worker (kq, nb) holds words w[i][j] of rows
    4kq + i, columns 8nb + 4j.. (j < 2); it transposes them, rotates the 8
    column words by nb % 8 and stores word s at column 8nb + (s + nb) % 8,
    as store_block does. ``w[i][j]`` are (kk/4, 16) uint32 arrays over
    (kq, nb), one lane per worker."""
    c = np.stack(transpose4(*[w[i][0] for i in range(4)])
                 + transpose4(*[w[i][1] for i in range(4)]))
    kq, nb = np.meshgrid(np.arange(kk // 4), np.arange(TILE_N // 8),
                         indexing="ij")
    rot = nb & 7
    d = np.stack([np.take_along_axis(c, ((o + rot) & 7)[None], 0)[0]
                  for o in range(8)])
    base = tile_off(8 * nb, 4 * kq, kk)
    t32 = tile.view("<u4")
    for s_ in range(8):
        t32[(base + ((s_ + rot) & 7) * 16) // 4] = d[s_]


def split_words(plane_rows: np.ndarray, kk: int) -> list:
    """(kk, 128) plane bytes -> w[i][j]: (kk/4, 16) word arrays of rows
    4kq + i and columns 8nb + 4j.."""
    wd = words(plane_rows).reshape(kk // 4, 4, TILE_N // 8, 2)
    return [[wd[:, i, :, j] for j in range(2)] for i in range(4)]


def read_tile(tile: np.ndarray, kk: int) -> np.ndarray:
    """(kk, 128) int8 W[k, n] read back from a K-major tile."""
    k, n = np.meshgrid(np.arange(kk), np.arange(TILE_N), indexing="ij")
    return tile[tile_off(n, k, kk)].view(np.int8)


def fused_tile(pos: np.ndarray, neg: np.ndarray, shift: int) -> np.ndarray:
    """The 'fused' weight tile of one K step (pos/neg (P, 64, 128)) as the
    kernel builds it, as raw bytes."""
    kk = K_STEP["fused"]
    posw = [[np.zeros((kk // 4, 16), np.uint32) for _ in range(2)]
            for _ in range(4)]
    negw = [[np.zeros((kk // 4, 16), np.uint32) for _ in range(2)]
            for _ in range(4)]
    for p in range(shift, pos.shape[0]):
        pw, nw = split_words(pos[p], kk), split_words(neg[p], kk)
        for i in range(4):
            for j in range(2):
                posw[i][j] |= pw[i][j] << np.uint32(p)
                negw[i][j] |= nw[i][j] << np.uint32(p)
    w = [[vsub4(posw[i][j], negw[i][j]) for j in range(2)] for i in range(4)]
    tile = np.zeros(TILE_N * kk, np.uint8)
    store_tile(tile, w, kk)
    return tile


def plane_tile(plane: np.ndarray, p: int) -> np.ndarray:
    """A 'planes' tile: one side of plane p (32, 128), pre-scaled by 2^p."""
    kk = K_STEP["planes"]
    w = [[x << np.uint32(p) for x in row] for row in split_words(plane, kk)]
    tile = np.zeros(TILE_N * kk, np.uint8)
    store_tile(tile, w, kk)
    return tile


def wgmma_read(tile: np.ndarray, start: int, rows: int, kk: int
               ) -> np.ndarray:
    """The (rows, 32) int8 operand a wgmma k32 reads from a descriptor at
    byte ``start``: element (r, k) at start + (r / 8) SBO + (k / 16) LBO +
    (r % 8) 16 + k % 16, LBO = 128, SBO = 8 kk."""
    r, k = np.meshgrid(np.arange(rows), np.arange(32), indexing="ij")
    off = start + (r >> 3) * 8 * kk + (k >> 4) * 128 + (r & 7) * 16 + (k & 15)
    return tile[off].view(np.int8).astype(np.int64)


def code_tile(q: np.ndarray, kk: int) -> np.ndarray:
    """The (rows, kk) codes as the workers store them (tile_off)."""
    tile = np.zeros(q.shape[0] * kk, np.uint8)
    r, k = np.meshgrid(np.arange(q.shape[0]), np.arange(kk), indexing="ij")
    tile[tile_off(r, k, kk)] = q.astype(np.uint8)
    return tile


def planes_of(codes: np.ndarray, n_planes: int):
    """(P, K, N) int8 0/1 planes of signed codes |c| < 2^P."""
    pos = np.stack([(np.maximum(codes, 0) >> p) & 1
                    for p in range(n_planes)]).astype(np.int8)
    neg = np.stack([(np.maximum(-codes, 0) >> p) & 1
                    for p in range(n_planes)]).astype(np.int8)
    return pos, neg


def rand_codes(rng, n_planes: int, shape) -> np.ndarray:
    """Signed codes with |c| < 2^P, the extremes +-(2^P - 1) forced into
    the first row."""
    top = (1 << n_planes) - 1
    codes = rng.integers(-top, top + 1, size=shape)
    codes[0, ::2], codes[0, 1::2] = top, -top
    return codes


def rebuild(pos, neg, shift):
    return tpm.rebuild_weight(torch.from_numpy(pos), torch.from_numpy(neg),
                              torch.tensor(float(shift))).numpy()


@pytest.mark.parametrize("n_planes,shift",
                         [(p, s) for p in range(1, 8) for s in range(p + 1)])
def test_fused_rebuild_matches_rebuild_weight(n_planes, shift):
    rng = np.random.default_rng(100 * n_planes + shift)
    codes = rand_codes(rng, n_planes, (K_STEP["fused"], TILE_N))
    pos, neg = planes_of(codes, n_planes)
    got = read_tile(fused_tile(pos, neg, shift), K_STEP["fused"])
    want = rebuild(pos, neg, shift)
    assert np.abs(want).max() <= 127
    np.testing.assert_array_equal(got.astype(np.int32), want)
    if shift == 0:
        np.testing.assert_array_equal(got, codes.astype(np.int8))


@pytest.mark.parametrize("n_planes,shift",
                         [(p, s) for p in range(1, 8) for s in range(p + 1)])
def test_prescaled_plane_tiles_give_planes_product(n_planes, shift):
    """sum_p q @ (pos_p << p) - sum_p q @ (neg_p << p), from the K-major
    pre-scaled tiles, equals int_product(mode='planes') over one K step."""
    kk = K_STEP["planes"]
    rng = np.random.default_rng(7 + 10 * n_planes + shift)
    codes = rand_codes(rng, n_planes, (kk, TILE_N))
    pos, neg = planes_of(codes, n_planes)
    q = rng.integers(0, 128, size=(9, kk))
    acc_pos = np.zeros((9, TILE_N), np.int64)
    acc_neg = np.zeros((9, TILE_N), np.int64)
    for p in range(shift, n_planes):
        tp = read_tile(plane_tile(pos[p], p), kk).astype(np.int64)
        tn = read_tile(plane_tile(neg[p], p), kk).astype(np.int64)
        assert tp.max() <= 64 and tn.max() <= 64   # fits s8
        acc_pos += q @ tp
        acc_neg += q @ tn
    want = tpm.int_product(torch.from_numpy(q.astype(np.int8)),
                           torch.from_numpy(pos), torch.from_numpy(neg),
                           torch.tensor(float(shift)), mode="planes")
    np.testing.assert_array_equal(acc_pos - acc_neg, want.numpy())


@pytest.mark.parametrize("mode", tpm.MODES)
def test_descriptor_product_matches_jax_oracle(mode):
    """One block's product as wgmma reads it: the code tile and the weight
    tile(s) through the descriptors, two 64-row warpgroups, K steps of kK
    with the ragged last step zero-filled (K = 96 is no multiple of 64),
    against the JAX package's oracle on the same numpy inputs (s_x = gamma
    = 1, so the fp32 output is the integer sum)."""
    kk, n_planes, m, k = K_STEP[mode], 6, 128, 96
    rng = np.random.default_rng(3)
    codes = rand_codes(rng, n_planes, (k, TILE_N))
    pos, neg = planes_of(codes, n_planes)
    q = rng.integers(0, 128, size=(m, k))
    acc = np.zeros((m, TILE_N), np.int64)
    for kb in range(0, k, kk):
        qs = np.zeros((m, kk), np.int64)
        qs[:, :min(kk, k - kb)] = q[:, kb:kb + kk]
        ps = np.zeros((n_planes, kk, TILE_N), np.int8)
        ns = np.zeros_like(ps)
        ps[:, :min(kk, k - kb)] = pos[:, kb:kb + kk]
        ns[:, :min(kk, k - kb)] = neg[:, kb:kb + kk]
        a = code_tile(qs, kk)
        if mode == "fused":
            tiles = [(fused_tile(ps, ns, 0), 1)]
        else:
            tiles = [(plane_tile(ps[p], p), 1) for p in range(n_planes)] + \
                    [(plane_tile(ns[p], p), -1) for p in range(n_planes)]
        for wg in range(2):
            rows = slice(64 * wg, 64 * wg + 64)
            for k32 in range(kk // 32):
                aw = wgmma_read(a, wg * 64 * kk + 256 * k32, 64, kk)
                for tile, sign in tiles:
                    bw = wgmma_read(tile, 256 * k32, TILE_N, kk)
                    acc[rows] += sign * (aw @ bw.T)
    ones = np.ones((m, 1), np.float32)
    want = np.asarray(rref.pann_matmul_ref(
        jnp.asarray(q.astype(np.int8)), jnp.asarray(pos), jnp.asarray(neg),
        jnp.asarray(ones), jnp.ones((TILE_N,), jnp.float32)))
    assert np.abs(acc).max() < 2 ** 24   # exact in the oracle's fp32
    np.testing.assert_array_equal(acc.astype(np.float32), want)


@settings(deadline=None, max_examples=25, derandomize=True)
@given(n_planes=st.integers(1, 7), data=st.data())
def test_fused_rebuild_property(n_planes, data):
    shift = data.draw(st.integers(0, n_planes))
    seed = data.draw(st.integers(0, 2 ** 31 - 1))
    codes = rand_codes(np.random.default_rng(seed), n_planes,
                       (K_STEP["fused"], TILE_N))
    pos, neg = planes_of(codes, n_planes)
    got = read_tile(fused_tile(pos, neg, shift), K_STEP["fused"])
    np.testing.assert_array_equal(got.astype(np.int32),
                                  rebuild(pos, neg, shift))


def rint_quot(x: np.ndarray, s: np.float32):
    """The kernel's rint_quot in float32: rint(x * r), r = 1 / s, and the
    near-tie flag (within 2^-21 |y| of a half-integer, or not finite)."""
    r = np.float32(1.0) / s
    y = (x * r).astype(np.float32)
    q = np.rint(y)
    gap = np.abs(np.abs(y - q) - np.float32(0.5))
    tie = ~(gap > np.abs(y) * np.float32(2.0 ** -21))
    return q, tie


@pytest.mark.parametrize("scale", [0.25, 0.1, 0.03125, 1 / 127, 0.0377,
                                   3.7e-3, 12.5])
def test_encode_without_division_matches_ieee(scale):
    """Where the flag is clear, rint(x * (1/s)) == rint(x / s) in IEEE
    float32; half-integer quotients (exact ties) are always flagged."""
    s = np.float32(scale)
    rng = np.random.default_rng(int(scale * 1e6))
    x = np.concatenate([
        rng.standard_normal(200_000).astype(np.float32) * 3,
        (rng.integers(-400, 400, 20_000) + 0.5).astype(np.float32) * s,
        np.nextafter((np.arange(-50, 50) + 0.5).astype(np.float32) * s,
                     np.float32(np.inf)),
        np.array([0.0, -0.0, 1e-30, -1e-30, 3e38], np.float32)])
    with np.errstate(over="ignore", invalid="ignore"):  # 3e38 / s is inf
        q, tie = rint_quot(x, s)
        want = np.rint(x / s)
        half = (x / s) == np.rint(x / s - np.float32(0.5)) + np.float32(0.5)
    np.testing.assert_array_equal(q[~tie], want[~tie])
    assert tie[half].all()


# (M, K, N) where the card checks the tile regime: phase 6 at M = 512 and
# the ragged shapes above 8 rows (chip_smoke.py UNFUSED_M, RAGGED)
TILE_SHAPES = ([(512, 4096, 4096), (512, 4096, 1024), (512, 4096, 14336),
                (512, 14336, 4096), (512, 4096, 128256), (512, 14336, 1024)]
               + [(m, 4096, 1024) for m in (9, 13, 64, 100, 127, 129, 200)]
               + [(m, 130, 72) for m in (13, 100, 129)]
               + [(m, 4100, 136) for m in (13, 129)])


@pytest.mark.parametrize("m,k,n", TILE_SHAPES)
def test_split_k_tile_regime(m, k, n):
    """Above 8 rows every matmul (B1/B4, B2/B5, B6) sizes split-K by
    TC_TILE: the chunks cover K once, in whole K steps of every mode (64
    'fused', 'packed' and 'split', 32 'planes'), as tc::launch requires."""
    ksplit, kchunk = tpm.split_k(m, k, n)
    assert ksplit * kchunk >= k > (ksplit - 1) * kchunk
    assert kchunk % tpm.TC_TILE[2] == 0   # whole K steps
    assert kchunk % 64 == 0 and kchunk % K_STEP["planes"] == 0
