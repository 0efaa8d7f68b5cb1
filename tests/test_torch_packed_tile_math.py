"""The integer arithmetic of the tensor-core tile kernel's two newer weight
sources (``src/repro_torch/csrc/pann_tc.cuh``, modes kPacked and kSplit),
which B2 ``pann_matmul_packed_act``, B5 ``pann_matmul_packed`` and B6
``unsigned_matmul`` run above 8 rows, emulated in numpy step for step as
the workers do it, on the CPU (the kernel itself runs only on the card):

- kPacked: per live plane and sign, the 32-bit word of a packed row (8 K
  rows x 4 columns) out of a TMA box of 8 packed rows x 128 columns, zero
  past K / 8 and N; the 8 x 8 bit transpose (``transpose_bits``), pos -
  neg per byte (``sub_bytes``), the two 4 x 4 byte transposes and the
  rotated 8-byte stores (``store_rows8``) into wgmma's K-major tile, held
  against ``kernels.pann_matmul.rebuild_weight`` at P = 1..7 and every
  plane_shift 0..P, with ragged K and N tails;
- kSplit: ``split_word``'s W+ / W- bytes of every int8 in [-127, 127],
  the two tiles through ``store_block``, and Eq. 6's two products into two
  accumulators with one subtraction;
- both products read back through the wgmma descriptors over whole
  launches at M > 8 (split-K as ``split_k`` sizes it, the epilogue's two
  fp32 multiplies), against the plain versions, ``int_product`` and the
  JAX package's oracles; the plain versions against the JAX kernels in
  interpret mode at M > 8, as the JAX package's own tests run them.

Tolerance: the integer sums are bit-identical (0), and so are the fp32
outputs of the epilogue.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st

from repro.kernels import ref as rref
from repro.kernels.pann_matmul_packed import pack_planes as r_pack
from repro.kernels.pann_matmul_packed import (
    pann_matmul_packed as r_pann_matmul_packed)
from repro.kernels.pann_matmul_packed import (
    pann_matmul_packed_act as r_pann_matmul_packed_act)
from repro.kernels.unsigned_matmul import unsigned_matmul as r_unsigned
from repro_torch.core import quant
from repro_torch.kernels import pann_matmul as tpm
from repro_torch.kernels import pann_matmul_packed as tpk
from repro_torch.kernels import unsigned_matmul as tum
from test_torch_decode_math import (pack, planes_of, rand_weights,
                                    split_word, sub_bytes, transpose_bits,
                                    transpose4, u32, words)
from test_torch_tile_math import (TILE_N, code_tile, read_tile, split_words,
                                  store_tile, tile_off, wgmma_read)

KK = 64            # K step of both modes
BOX_ROWS = KK // 8  # packed rows of a box
TILE_M = 128


# ---------------------------------------------------------------------------
# kPacked: the weight tile of one K step and column block
# ---------------------------------------------------------------------------

def packed_box(planes: np.ndarray, p: int, kb: int, n_blk: int
               ) -> np.ndarray:
    """The (8, 128) TMA box of plane p at K row kb, column n_blk: packed
    rows kb/8.. of (P, K/8, N), zero past K/8 and N (TMA's fill, and the
    copy warp's own loads where TMA cannot address the planes)."""
    box = np.zeros((BOX_ROWS, TILE_N), np.uint8)
    rows = planes[p, kb // 8:kb // 8 + BOX_ROWS, n_blk:n_blk + TILE_N]
    box[:rows.shape[0], :rows.shape[1]] = rows
    return box


def store_rows8(tile: np.ndarray, d: list) -> None:
    """store_rows8: worker (k8, c4) holds d[j] (row 8k8 + j, byte c =
    column 4c4 + c); two transpose4 give column c's rows 0-3 (lo) and 4-7
    (hi); the 4 column pairs rotate by (c4 / 2) % 4 in two select stages,
    and pair s lands at column 4c4 + (s + rot) % 4 as one 8-byte store.
    ``d[j]`` are (8, 32) uint32 arrays over (k8, c4)."""
    lo, hi = np.stack(transpose4(*d[:4])), np.stack(transpose4(*d[4:]))
    k8, c4 = np.meshgrid(np.arange(BOX_ROWS), np.arange(TILE_N // 4),
                         indexing="ij")
    rot = (c4 >> 1) & 3
    for bit in (1, 2):
        sel = (rot & bit) != 0
        lo = np.stack([np.where(sel, lo[(o + bit) & 3], lo[o])
                       for o in range(4)])
        hi = np.stack([np.where(sel, hi[(o + bit) & 3], hi[o])
                       for o in range(4)])
    base = tile_off(4 * c4, 8 * k8, KK)
    t32 = tile.view("<u4")
    for s in range(4):
        off = (base + ((s + rot) & 3) * 16) // 4
        t32[off], t32[off + 1] = lo[s], hi[s]


def packed_tile(ppk: np.ndarray, npk: np.ndarray, kb: int, n_blk: int,
                shift: int) -> np.ndarray:
    """The kPacked weight tile of one K step as the workers build it, as
    raw bytes: dead planes (p < shift) are never loaded (0)."""
    n_planes = ppk.shape[0]
    zero = u32(np.zeros((BOX_ROWS, TILE_N // 4)))

    def magnitudes(planes):
        w = [words(packed_box(planes, p, kb, n_blk))
             if shift <= p < n_planes else zero for p in range(7)]
        return transpose_bits(w + [zero])

    wp, wn = magnitudes(ppk), magnitudes(npk)
    d = [sub_bytes(wp[j], wn[j]) for j in range(8)]
    tile = np.zeros(TILE_N * KK, np.uint8)
    store_rows8(tile, d)
    return tile


def rebuild(pos, neg, shift):
    return tpm.rebuild_weight(torch.from_numpy(pos), torch.from_numpy(neg),
                              torch.tensor(float(shift))).numpy()


def window(w: np.ndarray, kb: int, n_blk: int) -> np.ndarray:
    """(KK, 128) rows kb.. x columns n_blk.. of w, zero past its edge."""
    out = np.zeros((KK, TILE_N), w.dtype)
    part = w[kb:kb + KK, n_blk:n_blk + TILE_N]
    out[:part.shape[0], :part.shape[1]] = part
    return out


# K = 72: the second step holds one packed row; N = 200: the second
# column block holds 72 columns (N % 16 != 0: the copy warp's own loads)
RAGGED_K, RAGGED_N = 72, 200


@pytest.mark.parametrize("n_planes,shift",
                         [(p, s) for p in range(1, 8) for s in range(p + 1)])
def test_packed_tile_matches_rebuild_weight(n_planes, shift):
    rng = np.random.default_rng(300 + 10 * n_planes + shift)
    w = rand_weights(rng, n_planes, RAGGED_K, RAGGED_N)
    pos, neg = planes_of(w, n_planes)
    ppk, npk = pack(pos), pack(neg)
    want = rebuild(pos, neg, shift)
    assert np.abs(want).max() <= 127
    for kb in (0, KK):
        for n_blk in (0, TILE_N):
            got = read_tile(packed_tile(ppk, npk, kb, n_blk, shift), KK)
            np.testing.assert_array_equal(got.astype(np.int32),
                                          window(want, kb, n_blk))
            if shift == 0:
                np.testing.assert_array_equal(got, window(w, kb, n_blk))


@settings(deadline=None, max_examples=25, derandomize=True)
@given(n_planes=st.integers(1, 7), data=st.data())
def test_packed_tile_property(n_planes, data):
    shift = data.draw(st.integers(0, n_planes))
    k8 = data.draw(st.integers(1, 16))
    n = 4 * data.draw(st.integers(1, 40))
    seed = data.draw(st.integers(0, 2 ** 31 - 1))
    w = rand_weights(np.random.default_rng(seed), n_planes, 8 * k8, n)
    pos, neg = planes_of(w, n_planes)
    want = rebuild(pos, neg, shift)
    for kb in range(0, 8 * k8, KK):
        for n_blk in range(0, n, TILE_N):
            got = read_tile(packed_tile(pack(pos), pack(neg), kb, n_blk,
                                        shift), KK)
            np.testing.assert_array_equal(got.astype(np.int32),
                                          window(want, kb, n_blk))


def test_packed_store_rotation_spreads_a_warp():
    """A warp's 32 lanes (one k8, c4 = lane) write, at each of the 4
    stores, 8 distinct 16-byte rows of their core matrices, 4 lanes each
    (without the rotation 16 lanes would meet on one)."""
    c4 = np.arange(32)
    rot = (c4 >> 1) & 3
    for k8 in range(BOX_ROWS):
        for s in range(4):
            for rotate in (True, False):
                col = (s + rot) & 3 if rotate else np.full(32, s)
                off = tile_off(4 * c4 + col, 8 * k8, KK)
                bank_row = (off % 128) // 16     # the 16-byte row of banks
                counts = np.bincount(bank_row, minlength=8)
                assert counts.max() == (4 if rotate else 16)


# ---------------------------------------------------------------------------
# kSplit: the W+ / W- tiles
# ---------------------------------------------------------------------------

def test_split_word_every_byte():
    """Every int8 in [-127, 127] in every byte position of a word, beside
    random neighbours: W+ = max(w, 0), W- = max(-w, 0), bytes in [0, 127]."""
    rng = np.random.default_rng(0)
    vals = np.arange(-127, 128)
    for pos in range(4):
        b = rng.integers(-127, 128, size=(vals.size, 4))
        b[:, pos] = vals
        w = b.astype(np.int8).view("<u4").reshape(-1)
        wp, wn = split_word(w)
        got_p = wp.astype("<u4").view(np.uint8).reshape(-1, 4)
        got_n = wn.astype("<u4").view(np.uint8).reshape(-1, 4)
        np.testing.assert_array_equal(got_p, np.maximum(b, 0))
        np.testing.assert_array_equal(got_n, np.maximum(-b, 0))


def split_tiles(w: np.ndarray, kb: int, n_blk: int) -> tuple:
    """The W+ and W- tiles of one K step (w (K, N) int8) as the workers
    build them: the TMA box (zero past K and N), split_word on each word,
    store_block into two K-major tiles."""
    box = window(w, kb, n_blk).view(np.uint8)
    halves = [[split_word(x) for x in row] for row in split_words(box, KK)]
    tiles = []
    for side in range(2):
        tile = np.zeros(TILE_N * KK, np.uint8)
        store_tile(tile, [[h[side] for h in row] for row in halves], KK)
        tiles.append(tile)
    return tiles[0], tiles[1]


@pytest.mark.parametrize("kb,n_blk", [(0, 0), (0, TILE_N), (KK, 0),
                                      (KK, TILE_N)])
def test_split_tiles_match_unsigned_split(kb, n_blk):
    rng = np.random.default_rng(kb + n_blk)
    w = rng.integers(-127, 128, size=(KK + 6, TILE_N + 72)).astype(np.int8)
    w[0, ::2], w[0, 1::2] = 127, -127
    tp, tn = split_tiles(w, kb, n_blk)
    wi = window(w, kb, n_blk).astype(np.int32)
    np.testing.assert_array_equal(read_tile(tp, KK), np.maximum(wi, 0))
    np.testing.assert_array_equal(read_tile(tn, KK), np.maximum(-wi, 0))


# ---------------------------------------------------------------------------
# whole launches through the descriptors
# ---------------------------------------------------------------------------

def block_codes(q: np.ndarray, m0: int, kb: int, kend: int) -> np.ndarray:
    """The code tile of one block and K step: rows m0.., columns kb..,
    0 past M and kend."""
    qs = np.zeros((TILE_M, KK), np.int64)
    part = q[m0:m0 + TILE_M, kb:min(kb + KK, kend)]
    qs[:part.shape[0], :part.shape[1]] = part
    return code_tile(qs, KK)


def wg_products(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    """(128, 128) sum of one stage's wgmma products: each warpgroup's 64
    rows, two k32 descriptors each."""
    acc = np.zeros((TILE_M, TILE_N), np.int64)
    for wg in range(2):
        for k32 in range(KK // 32):
            aw = wgmma_read(a, wg * 64 * KK + 256 * k32, 64, KK)
            bw = wgmma_read(b, 256 * k32, TILE_N, KK)
            acc[64 * wg:64 * wg + 64] += aw @ bw.T
    return acc


def launch(q: np.ndarray, n: int, stage) -> np.ndarray:
    """The int32 (M, N) sums of a tile launch: every (M tile, N tile, K
    split) block with split_k's chunks, ``stage(kb, n_blk)`` giving the
    block's (128 x 128) product of one K step from its code tile; the
    epilogue kernel's sum over the splits."""
    m, k = q.shape
    ksplit, kchunk = tpm.split_k(m, k, n)
    assert kchunk % KK == 0 or ksplit == 1
    out = np.zeros((m + TILE_M, n + TILE_N), np.int64)
    for ky in range(ksplit):
        k0, kend = ky * kchunk, min(ky * kchunk + kchunk, k)
        for m0 in range(0, m, TILE_M):
            for n_blk in range(0, n, TILE_N):
                acc = np.zeros((TILE_M, TILE_N), np.int64)
                for kb in range(k0, kend, KK):
                    acc += stage(block_codes(q, m0, kb, kend), kb, n_blk)
                out[m0:m0 + TILE_M, n_blk:n_blk + TILE_N] += acc
    assert np.abs(out).max() < 2 ** 31
    return out[:m, :n]


def packed_launch(q, ppk, npk, shift):
    return launch(q, ppk.shape[2], lambda a, kb, n_blk: wg_products(
        a, packed_tile(ppk, npk, kb, n_blk, shift)))


def split_launch(q, w):
    def stage(a, kb, n_blk):
        tp, tn = split_tiles(w, kb, n_blk)
        return wg_products(a, tp) - wg_products(a, tn)   # acc_pos, acc_neg
    return launch(q, w.shape[1], stage)


def epilogue(sums: np.ndarray, s, gamma, zcol=None) -> np.ndarray:
    """epilogue_kernel: ((sum - zcol) * s) * gamma, each product rounded
    to fp32."""
    acc = sums.astype(np.int32) - (0 if zcol is None else zcol)
    return (acc.astype(np.float32) * s).astype(np.float32) * gamma


# (M, K, N, P, shift): M > 8, ragged M, K (whole packed rows) and N tails,
# more than one K split
PACKED_LAUNCHES = [(100, 136, 200, 6, 0), (129, 64, 72, 7, 0),
                   (9, 520, 128, 6, 2), (40, 1000, 136, 3, 3),
                   (16, 256, 128, 7, 7)]


@pytest.mark.parametrize("m,k,n,n_planes,shift", PACKED_LAUNCHES)
def test_packed_launch_matches_plain_and_oracle(m, k, n, n_planes, shift):
    rng = np.random.default_rng(m + k + n)
    w = rand_weights(rng, n_planes, k, n)
    pos, neg = planes_of(w, n_planes)
    ppk, npk = pack(pos), pack(neg)
    x = rng.standard_normal((m, k)).astype(np.float32)
    qp = torch.tensor([0.02, 40.0, 127.0, float(shift)])
    q = quant.affine_encode(torch.from_numpy(x), qp[0], qp[1], qp[2]) \
        .to(torch.int8).numpy()
    sums = packed_launch(q, ppk, npk, shift)
    want = tpm.int_product(torch.from_numpy(q), torch.from_numpy(pos),
                           torch.from_numpy(neg), qp[3]).numpy()
    np.testing.assert_array_equal(sums, want)
    gamma = rng.random(n).astype(np.float32) * 1e-3
    zcol = rng.integers(-2 ** 20, 2 ** 20, n).astype(np.int32)
    t = torch.from_numpy
    # B2: per-tensor s, zcol
    np.testing.assert_array_equal(
        epilogue(sums, np.float32(0.02), gamma, zcol),
        tpk.pann_matmul_packed_act_plain(t(x), t(ppk), t(npk), qp, t(gamma),
                                         t(zcol)).numpy())
    # B5: every plane live, per-row s_x
    sums0 = sums if shift == 0 else packed_launch(q, ppk, npk, 0)
    sx = rng.random((m, 1)).astype(np.float32) + 0.5
    np.testing.assert_array_equal(
        epilogue(sums0, sx, gamma),
        tpk.pann_matmul_packed_plain(t(q), t(ppk), t(npk), t(sx),
                                     t(gamma)).numpy())
    oracle = np.asarray(rref.pann_matmul_ref(
        jnp.asarray(q), jnp.asarray(pos), jnp.asarray(neg),
        jnp.ones((m, 1), jnp.float32), jnp.ones((n,), jnp.float32)))
    assert np.abs(sums0).max() < 2 ** 24     # exact in the oracle's fp32
    np.testing.assert_array_equal(sums0.astype(np.float32), oracle)


SPLIT_LAUNCHES = [(100, 130, 72), (129, 200, 136), (16, 64, 128),
                  (9, 1000, 200)]


@pytest.mark.parametrize("m,k,n", SPLIT_LAUNCHES)
def test_split_launch_matches_plain_and_oracle(m, k, n):
    rng = np.random.default_rng(7 * m + k)
    q = rng.integers(0, 128, (m, k)).astype(np.int8)
    q[:, 0] = 127
    w = rng.integers(-127, 128, (k, n)).astype(np.int8)
    w[0, ::2], w[0, 1::2] = 127, -127
    sums = split_launch(q, w)
    wi = w.astype(np.int64)
    np.testing.assert_array_equal(
        sums, q.astype(np.int64) @ np.maximum(wi, 0)
        - q.astype(np.int64) @ np.maximum(-wi, 0))
    sx = rng.random((m, 1)).astype(np.float32) + 0.5
    sw = rng.random(n).astype(np.float32) * 1e-3
    t = torch.from_numpy
    want = tum.unsigned_matmul_plain(t(q), t(w), t(sx), t(sw)).numpy()
    np.testing.assert_array_equal(epilogue(sums, sx, sw), want)
    np.testing.assert_array_equal(want, np.asarray(rref.unsigned_matmul_ref(
        jnp.asarray(q), jnp.asarray(w), jnp.asarray(sx), jnp.asarray(sw))))


# ---------------------------------------------------------------------------
# the plain versions against the JAX kernels above 8 rows
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("shift", range(7))
def test_packed_act_plain_matches_pallas_above_8_rows(shift):
    m, k, n, n_planes = 16, 256, 128, 6
    rng = np.random.default_rng(40 + shift)
    w = rand_weights(rng, n_planes, k, n)
    pos, neg = planes_of(w, n_planes)
    x = rng.standard_normal((m, k)).astype(np.float32)
    qp = np.array([0.021, 37.0, 127.0, float(shift)], np.float32)
    gamma = rng.random(n).astype(np.float32) * 1e-3
    zcol = rng.integers(-2 ** 16, 2 ** 16, n).astype(np.int32)
    want = np.asarray(r_pann_matmul_packed_act(
        jnp.asarray(x), r_pack(jnp.asarray(pos)), r_pack(jnp.asarray(neg)),
        jnp.asarray(qp.reshape(1, 4)), jnp.asarray(gamma), jnp.asarray(zcol),
        bm=16, bn=128, bk=128, interpret=True))
    t = torch.from_numpy
    got = tpk.pann_matmul_packed_act_plain(
        t(x), t(pack(pos)), t(pack(neg)), t(qp), t(gamma), t(zcol)).numpy()
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("m,n_planes", [(16, 7), (48, 5)])
def test_packed_plain_matches_pallas_above_8_rows(m, n_planes):
    k, n = 256, 128
    rng = np.random.default_rng(m + n_planes)
    w = rand_weights(rng, n_planes, k, n)
    pos, neg = planes_of(w, n_planes)
    q = rng.integers(0, 128, (m, k)).astype(np.int8)
    sx = rng.random((m, 1)).astype(np.float32) + 0.5
    gamma = rng.random(n).astype(np.float32) * 1e-3
    want = np.asarray(r_pann_matmul_packed(
        jnp.asarray(q), r_pack(jnp.asarray(pos)), r_pack(jnp.asarray(neg)),
        jnp.asarray(sx), jnp.asarray(gamma), bm=16, bn=128, bk=128,
        interpret=True))
    t = torch.from_numpy
    got = tpk.pann_matmul_packed_plain(t(q), t(pack(pos)), t(pack(neg)),
                                       t(sx), t(gamma)).numpy()
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("m", [16, 48])
def test_unsigned_plain_matches_pallas_above_8_rows(m):
    k, n = 256, 128
    rng = np.random.default_rng(m)
    q = rng.integers(0, 128, (m, k)).astype(np.int8)
    w = rng.integers(-127, 128, (k, n)).astype(np.int8)
    sx = rng.random((m, 1)).astype(np.float32) + 0.5
    sw = rng.random(n).astype(np.float32) * 1e-3
    want = np.asarray(r_unsigned(jnp.asarray(q), jnp.asarray(w),
                                 jnp.asarray(sx), jnp.asarray(sw), bm=16,
                                 bn=128, bk=128, interpret=True))
    t = torch.from_numpy
    got = tum.unsigned_matmul_plain(t(q), t(w), t(sx), t(sw)).numpy()
    np.testing.assert_array_equal(got, want)


# (M, K, N, shards, shift): the accumulator mode above 8 rows, a
# row-parallel K split over "model" ranks
ACC_TILE = [(100, 256, 72, 2, 0), (17, 512, 136, 4, 2)]


@pytest.mark.parametrize("m,k,n,shards,shift", ACC_TILE)
def test_accumulator_mode_tile_launch(m, k, n, shards, shift):
    """The accumulator mode above 8 rows: each K shard's tile launch and
    ``sum_splits_kernel`` (the split sums added, no epilogue) equal
    ``pann_matmul_packed_act_acc_plain`` on the shard; the shards' sums
    added, through the epilogue entry (ksplit 1), equal the whole
    projection's plain version bit for bit."""
    rng = np.random.default_rng(m + k + n)
    n_planes = 7
    pos, neg = planes_of(rand_weights(rng, n_planes, k, n), n_planes)
    x = rng.standard_normal((m, k)).astype(np.float32)
    qp = torch.tensor([0.02, 40.0, 127.0, float(shift)])
    t = torch.from_numpy
    q = quant.affine_encode(t(x), qp[0], qp[1], qp[2]).to(torch.int8).numpy()
    ks = k // shards
    total = np.zeros((m, n), np.int64)
    for r in range(shards):
        sl = slice(r * ks, (r + 1) * ks)
        ppk, npk = pack(pos[:, sl]), pack(neg[:, sl])
        sums = packed_launch(np.ascontiguousarray(q[:, sl]), ppk, npk, shift)
        np.testing.assert_array_equal(
            sums, tpk.pann_matmul_packed_act_acc_plain(
                t(np.ascontiguousarray(x[:, sl])), t(ppk), t(npk),
                qp).numpy())
        total += sums
    gamma = rng.random(n).astype(np.float32) * 1e-3
    zcol = rng.integers(-2 ** 20, 2 ** 20, n).astype(np.int32)
    y = epilogue(total, np.float32(0.02), gamma, zcol)
    np.testing.assert_array_equal(y, tpm.pann_epilogue_plain(
        t(total.astype(np.int32)), qp, t(gamma), t(zcol)).numpy())
    np.testing.assert_array_equal(y, tpk.pann_matmul_packed_act_plain(
        t(x), t(pack(pos)), t(pack(neg)), qp, t(gamma), t(zcol)).numpy())
