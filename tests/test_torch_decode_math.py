"""The integer arithmetic of the streaming decode kernels that B1
``pann_matmul_act`` / B4 ``pann_matmul`` (unpacked planes,
``src/repro_torch/csrc/pann_matmul.cu``), B2 ``pann_matmul_packed_act`` /
B5 ``pann_matmul_packed`` (packed planes, ``csrc/pann_matmul_packed.cu``)
and B6 ``unsigned_matmul`` (the signed int8 weight,
``csrc/unsigned_matmul.cu``) run at M <= 8, emulated in numpy step for step
as the kernels do it, on the CPU (the kernels themselves run only on the
card):

- B2's rebuild: the 32-bit plane words (byte c = column c, bit j = row j),
  the 8 x 8 bit transpose in each byte lane by three swap stages, the
  per-byte pos - neg without borrow read as int8 (``sub_bytes``), the
  ``__byte_perm`` 4 x 4 transpose to K-major words and ``__dp4a`` lanes in
  K order;
- B1's SIMD rebuild (sum of pos_p << p per word, ``sub_bytes``, the byte
  transpose) in 'fused' mode, and 'planes' mode's one product per live
  plane and sign on the pre-scaled plane bytes, the negative side through
  the negated codes (``neg_bytes``);
- B6's rebuild: the 32-bit words of 4 weight rows, the ``__byte_perm``
  4 x 4 transpose to K-major words, ``split_word``'s W+ and W- words, two
  u8 ``__dp4a`` lanes in K order into acc_pos and acc_neg (the s8 form
  reading the same values), and the one subtraction a lane;
- the grid: ``decode_split``, the warps' K steps, the zero-padded ragged
  last step, and the one-launch split-K finish (integer atomics into a
  buffer, tickets, the last block's read-and-zero and epilogue) in every
  order of the blocks' arrival, which leaves the buffers zero;
- every K row covered exactly once at every shape the card checks and at
  M = 1..8.

All of it is held against ``kernels.pann_matmul.rebuild_weight`` /
``int_product``, ``kernels.unsigned_matmul.unsigned_matmul_plain``, the
plain versions and the JAX package's oracles
``repro.kernels.ref.pann_matmul_ref`` / ``unsigned_matmul_ref``, for P =
1..7, every plane_shift, |w| = 127, codes of +-127 (B6: codes 0..127) and
ragged K and N. Tolerance: bit-identical (0).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st

from repro.kernels import ref as rref
from repro_torch.kernels import pann_matmul as tpm
from repro_torch.kernels import pann_matmul_packed as tpk
from repro_torch.kernels import unsigned_matmul as tum

H = np.uint32(0x80808080)
SMS = 132                      # the H100's SM count, as the wrapper reads it
MAX_PLANES = 7


# ---------------------------------------------------------------------------
# the kernels' word operations
# ---------------------------------------------------------------------------

def u32(x) -> np.ndarray:
    return np.asarray(x, dtype=np.uint32)


def byte_perm(x, y, sel: int):
    """CUDA's __byte_perm(x, y, sel) on uint32 arrays (selector nibbles
    0-7: byte i of the result is byte sel_i of y:x)."""
    src = np.stack([(x >> np.uint32(8 * i)) & np.uint32(0xFF)
                    for i in range(4)]
                   + [(y >> np.uint32(8 * i)) & np.uint32(0xFF)
                      for i in range(4)])
    out = np.zeros_like(x)
    for i in range(4):
        out |= src[(sel >> (4 * i)) & 7] << np.uint32(8 * i)
    return out


def transpose4(a0, a1, a2, a3):
    """pann::transpose4: 4 rows of 4 bytes -> 4 columns (byte i = row i)."""
    t0, t1 = byte_perm(a0, a1, 0x5140), byte_perm(a0, a1, 0x7362)
    t2, t3 = byte_perm(a2, a3, 0x5140), byte_perm(a2, a3, 0x7362)
    return [byte_perm(t0, t2, 0x5410), byte_perm(t0, t2, 0x7632),
            byte_perm(t1, t3, 0x5410), byte_perm(t1, t3, 0x7632)]


def sub_bytes(a, b):
    """pann::sub_bytes: a - b per byte for bytes in [0, 127]."""
    return ((u32(a) | H) - u32(b)) ^ H


def neg_bytes(q):
    """pann_matmul.cu's neg_bytes: 0 - q per byte, any int8 but -128."""
    q = u32(q)
    return (H - (q & ~H)) ^ (~q & H)


def split_word(w):
    """pann_tc.cuh's split_word: one = 1 in each negative byte, s = 0xFF there, |w| =
    (w ^ s) + one per byte; W+ = |w| & ~s, W- = |w| & s."""
    w = u32(w)
    one = (w >> np.uint32(7)) & np.uint32(0x01010101)
    s = (one * np.uint32(0xFF)).astype(np.uint32)
    mag = ((w ^ s) + one).astype(np.uint32)
    return mag & ~s, mag & s


def swap_bits(a, b, s: int, mask: int):
    """One swap stage of the bit transpose (swap_bits<S, Mask>)."""
    m, ms = np.uint32(mask), np.uint32((mask << s) & 0xFFFFFFFF)
    s = np.uint32(s)
    return (a & ~ms) | ((b << s) & ms), (b & ~m) | ((a >> s) & m)


def transpose_bits(w: list) -> list:
    """In each byte lane, bit j of w[p] -> bit p of w[j] (8 words)."""
    w = list(w)
    for p in range(4):
        w[p], w[p + 4] = swap_bits(w[p], w[p + 4], 4, 0x0F0F0F0F)
    for p in (0, 1, 4, 5):
        w[p], w[p + 2] = swap_bits(w[p], w[p + 2], 2, 0x33333333)
    for p in (0, 2, 4, 6):
        w[p], w[p + 1] = swap_bits(w[p], w[p + 1], 1, 0x55555555)
    return w


def sbytes(w) -> np.ndarray:
    """(..., 4) int64 signed bytes of uint32 words, byte i last."""
    w = np.ascontiguousarray(u32(w)).astype("<u4")
    return w.view(np.int8).reshape(*w.shape, 4).astype(np.int64)


def dp4a(a, b, c):
    """__dp4a(a, b, c), s8 x s8: c + sum_i a.byte_i * b.byte_i (int32)."""
    out = c + (sbytes(a) * sbytes(b)).sum(-1)
    assert np.abs(out).max(initial=0) < 2 ** 31
    return out


def ubytes(w) -> np.ndarray:
    """(..., 4) int64 unsigned bytes of uint32 words, byte i last."""
    w = np.ascontiguousarray(u32(w)).astype("<u4")
    return w.view(np.uint8).reshape(*w.shape, 4).astype(np.int64)




def words(rows: np.ndarray) -> np.ndarray:
    """(..., N) uint8/int8 bytes -> (..., N/4) uint32 words, byte c of word
    i = column 4i + c (a lane's little-endian 32-bit load)."""
    return np.ascontiguousarray(rows).view(np.uint8).view("<u4") \
        .astype(np.uint32)


# ---------------------------------------------------------------------------
# operands
# ---------------------------------------------------------------------------

def planes_of(codes: np.ndarray, n_planes: int):
    """(P, K, N) int8 0/1 planes of signed weights |w| < 2^P."""
    pos = np.stack([(np.maximum(codes, 0) >> p) & 1
                    for p in range(n_planes)]).astype(np.int8)
    neg = np.stack([(np.maximum(-codes, 0) >> p) & 1
                    for p in range(n_planes)]).astype(np.int8)
    return pos, neg


def rand_weights(rng, n_planes: int, k: int, n: int) -> np.ndarray:
    """Signed weights |w| < 2^P, the extremes +-(2^P - 1) forced into the
    first row."""
    top = (1 << n_planes) - 1
    w = rng.integers(-top, top + 1, size=(k, n))
    w[0, ::2], w[0, 1::2] = top, -top
    return w


def rand_codes(rng, m: int, k: int, signed: bool = False) -> np.ndarray:
    """int8 codes in [0, 127] (the kernels' contract), or [-127, 127];
    the extremes forced into the first columns."""
    q = rng.integers(-127 if signed else 0, 128, size=(m, k))
    q[:, 0] = 127
    if signed:
        q[:, 1] = -127
    return q.astype(np.int8)


def pack(planes: np.ndarray) -> np.ndarray:
    return tpk.pack_planes(torch.from_numpy(planes)).numpy()


def blocks_of(step: int) -> dict:
    """Blocks a SM of the decode kernel with K steps of ``step`` rows."""
    return tpm.BLOCKS_PACKED if step == tpm.STEP_PACKED else tpm.BLOCKS_PLANES


def int_product(q, pos, neg, shift=None, mode="fused") -> np.ndarray:
    sh = None if shift is None else torch.tensor(float(shift))
    return tpm.int_product(torch.from_numpy(q), torch.from_numpy(pos),
                           torch.from_numpy(neg), sh, mode).numpy()


def jax_oracle(q, pos, neg) -> np.ndarray:
    """The JAX package's oracle with s_x = gamma = 1: the integer sum as
    fp32 (exact below 2^24)."""
    m, n = q.shape[0], pos.shape[2]
    return np.asarray(rref.pann_matmul_ref(
        jnp.asarray(q), jnp.asarray(pos), jnp.asarray(neg),
        jnp.ones((m, 1), jnp.float32), jnp.ones((n,), jnp.float32)))


# ---------------------------------------------------------------------------
# one K step, as a lane computes it (vectorised over every lane's 4 columns)
# ---------------------------------------------------------------------------

def packed_step_words(ppk, npk, k8: int, lo: int):
    """B2: the lane's Step8 (live plane words of 8 rows) -> the K-major
    words lo[c], hi[c] (rows 0-3 and 4-7 of column c), as step_product
    builds them."""
    n_planes = ppk.shape[0]

    def magnitudes(packed):
        w = [words(packed[p, k8]) if lo <= p < n_planes
             else u32(np.zeros(packed.shape[2] // 4)) for p in range(7)]
        return transpose_bits(w + [u32(np.zeros_like(w[0]))])

    wp, wn = magnitudes(ppk), magnitudes(npk)
    d = [sub_bytes(wp[j], wn[j]) for j in range(8)]
    return transpose4(*d[:4]), transpose4(*d[4:])


def packed_step(ppk, npk, k8, lo, panel, acc):
    """acc (MT, N/4, 4) += one B2 step; panel (MT, 8) int8 codes."""
    low, high = packed_step_words(ppk, npk, k8, lo)
    qw = words(panel)                     # (MT, 2): rows 0-3, rows 4-7
    for m in range(acc.shape[0]):
        for c in range(4):
            acc[m, :, c] = dp4a(qw[m, 0], low[c], acc[m, :, c])
            acc[m, :, c] = dp4a(qw[m, 1], high[c], acc[m, :, c])


def planes_step(pos, neg, rows, lo, panel, acc, mode):
    """acc (MT, N/4, 4) += one B1 step of 4 rows (row indices ``rows``,
    -1 past kend: its words are 0); panel (MT, 4) int8 codes."""
    n_planes, _, n = pos.shape
    zero = u32(np.zeros(n // 4))

    def word(planes, p, r):
        live = lo <= p < n_planes and rows[r] >= 0
        return words(planes[p, rows[r]]) if live else zero

    qw = words(panel)[:, 0]               # (MT,)
    if mode == "fused":
        w = []
        for r in range(4):
            pw, nw = zero.copy(), zero.copy()
            for p in range(MAX_PLANES):
                pw = pw + (word(pos, p, r) << np.uint32(p))
                nw = nw + (word(neg, p, r) << np.uint32(p))
            w.append(sub_bytes(pw, nw))
        col = transpose4(*w)
        for m in range(acc.shape[0]):
            for c in range(4):
                acc[m, :, c] = dp4a(qw[m], col[c], acc[m, :, c])
        return
    for p in range(lo, n_planes):
        cp = transpose4(*[word(pos, p, r) << np.uint32(p) for r in range(4)])
        cn = transpose4(*[word(neg, p, r) << np.uint32(p) for r in range(4)])
        for m in range(acc.shape[0]):
            nq = neg_bytes(qw[m])
            for c in range(4):
                acc[m, :, c] = dp4a(qw[m], cp[c], acc[m, :, c])
                acc[m, :, c] = dp4a(nq, cn[c], acc[m, :, c])


def signed_step_words(w, rows):
    """B6: the lane's 4 row words of the int8 weight (0 past kend: row -1)
    -> pann::transpose4 -> split_word: the K-major W+ and W- words of
    columns c = 0..3 (byte i = row i)."""
    zero = u32(np.zeros(w.shape[1] // 4))
    col = transpose4(*[words(w[r]) if r >= 0 else zero for r in rows])
    return [split_word(c) for c in col]


def signed_step(w, rows, panel, acc):
    """acc (2, MT, N/4, 4): acc_pos, acc_neg += one B6 step of 4 rows;
    panel (MT, 4) int8 codes in [0, 127]. Lane (m, c) of each side is one
    u8 __dp4a of the row's code word and the column's K-major word; every
    operand byte is in [0, 127], so the s8 form reads the same values."""
    halves = signed_step_words(w, rows)
    qb = ubytes(words(panel)[:, 0])                    # (MT, 4)
    for side in range(2):
        wb = np.stack([ubytes(halves[c][side]) for c in range(4)], 1)
        assert qb.max(initial=0) <= 127 and wb.max(initial=0) <= 127
        np.testing.assert_array_equal(
            wb, sbytes(np.stack([halves[c][side] for c in range(4)], 1)))
        # (MT, 1, 1, 4) x (N/4, 4 columns, 4 rows): sum over the 4 rows
        acc[side] += (qb[:, None, None, :] * wb[None]).sum(-1)
    assert acc.max(initial=0) < 2 ** 31


# ---------------------------------------------------------------------------
# a whole launch: blocks, warps, steps and the finish
# ---------------------------------------------------------------------------

def decode_launch(q, n: int, step: int, blocks: dict, step_fn, rng,
                  sides: int = 1, split=None):
    """The int32 sums of a decode launch with N columns, block by block as
    the kernel runs it: ``step_fn(rows, panel, acc)`` adds one K step of
    ``step`` rows (row indices, -1 past the chunk's end) to a warp's
    accumulators acc (sides, MT, N/4, 4); with two sides (B6's acc_pos and
    acc_neg) each lane subtracts once. The blocks of a column tile arrive in
    a random order and finish through the atomics buffer and the tickets
    (ksplit > 1) or directly (ksplit == 1). ``split`` (ksplit, kchunk)
    replaces ``decode_split``'s, as a tuned launch's does
    (``kernels.autotune``). Returns (sums (M, N), the blocks' K rows,
    buffers)."""
    m, k = q.shape
    mt = 4 if m <= 4 else 8
    ksplit, kchunk = (tpm.decode_split(k, n, step, SMS * blocks[mt])
                      if split is None else split)
    tiles = -(-n // tpm.DECODE_COLS)
    acc_buf = np.zeros((m, n), np.int64)      # the wrapper's zeroed acc
    tickets = np.zeros(tiles, np.int64)
    out = np.full((m, n), np.iinfo(np.int64).min)
    covered = np.zeros(k, np.int64)
    for m0 in range(0, m, mt):
        qt = np.zeros((mt, k), np.int8)
        qt[:min(mt, m - m0)] = q[m0:m0 + mt]
        for y in rng.permutation(ksplit):
            k0 = y * kchunk
            kc = min(kchunk, k - k0)
            steps = -(-kc // step)
            panel = np.zeros((mt, steps * step), np.int8)   # zero-padded
            panel[:, :kc] = qt[:, k0:k0 + kc]
            block = np.zeros((mt, n // 4, 4), np.int64)
            for warp in range(tpm.DECODE_WARPS):
                acc = np.zeros((sides, mt, n // 4, 4), np.int64)
                for s in range(warp, steps, tpm.DECODE_WARPS):
                    rows = np.arange(k0 + step * s, k0 + step * s + step)
                    rows[rows >= k0 + kc] = -1
                    step_fn(rows, panel[:, step * s:step * s + step], acc)
                    if m0 == 0:
                        covered[rows[rows >= 0]] += 1
                block += acc[0] if sides == 1 else acc[0] - acc[1]
            sums = block.reshape(mt, n)[:min(mt, m - m0)]
            rows_out = slice(m0, m0 + sums.shape[0])
            if ksplit == 1:
                out[rows_out] = sums
                continue
            acc_buf[rows_out] += sums          # red.global.add
            tickets += 1                       # every column tile's ticket
            if tickets[0] == ksplit:           # the last block: read, zero
                out[rows_out] = acc_buf[rows_out]
                acc_buf[rows_out] = 0
                tickets[:] = 0
    assert np.abs(out).max() < 2 ** 31
    return out, covered, (acc_buf, tickets)


def packed_launch(q, pos, neg, lo, seed=0, split=None):
    ppk, npk = pack(pos), pack(neg)

    def step_fn(rows, panel, acc):
        packed_step(ppk, npk, rows[0] // 8, lo, panel, acc[0])

    return decode_launch(q, pos.shape[2], tpm.STEP_PACKED,
                         tpm.BLOCKS_PACKED, step_fn,
                         np.random.default_rng(seed), split=split)


def planes_launch(q, pos, neg, lo, mode, seed=0, split=None):
    def step_fn(rows, panel, acc):
        planes_step(pos, neg, rows, lo, panel, acc[0], mode)

    return decode_launch(q, pos.shape[2], tpm.STEP_PLANES,
                         tpm.BLOCKS_PLANES, step_fn,
                         np.random.default_rng(seed), split=split)


def signed_launch(q, w, seed=0):
    """B6 at M <= 8: K steps of 4 rows, BLOCKS_SIGNED blocks a SM."""
    def step_fn(rows, panel, acc):
        signed_step(w, rows, panel, acc)

    return decode_launch(q, w.shape[1], tpm.STEP_PLANES, tpm.BLOCKS_SIGNED,
                         step_fn, np.random.default_rng(seed), sides=2)


# ---------------------------------------------------------------------------
# tests
# ---------------------------------------------------------------------------

def test_sub_bytes_and_neg_bytes_every_byte():
    a, b = np.meshgrid(np.arange(128), np.arange(128), indexing="ij")
    # four different bytes per word: no borrow may cross a byte
    wa = u32(a | (b << 8) | (a << 16) | ((127 - b) << 24))
    wb = u32(b | (a << 8) | ((127 - a) << 16) | (b << 24))
    got = sbytes(sub_bytes(wa, wb))
    want = np.stack([a - b, b - a, a - (127 - a), (127 - b) - b], -1)
    np.testing.assert_array_equal(got, want)
    q = np.arange(-127, 128)
    w = u32(q.astype(np.int8).view(np.uint8)) * np.uint32(0x01010101)
    w ^= u32(np.roll(q, 7).astype(np.int8).view(np.uint8)) << np.uint32(8)
    got = sbytes(neg_bytes(w))
    want = -sbytes(w)
    np.testing.assert_array_equal(got, want)


def test_bit_transpose_is_a_transpose():
    rng = np.random.default_rng(0)
    w = [u32(rng.integers(0, 2 ** 32, 64)) for _ in range(8)]
    t = transpose_bits(w)
    bit = lambda x, i: (x >> np.uint32(i)) & np.uint32(1)   # noqa: E731
    for p in range(8):
        for c in range(4):
            for j in range(8):
                np.testing.assert_array_equal(bit(t[j], 8 * c + p),
                                              bit(w[p], 8 * c + j))
    np.testing.assert_array_equal(np.stack(transpose_bits(t)), np.stack(w))


@pytest.mark.parametrize("n_planes,shift",
                         [(p, s) for p in range(1, 8) for s in range(p + 1)])
def test_packed_rebuild_matches_rebuild_weight(n_planes, shift):
    """B2's words of one step (8 rows x 32 columns) read back as int8 are
    rebuild_weight's W at plane_shift ``shift``."""
    rng = np.random.default_rng(10 * n_planes + shift)
    w = rand_weights(rng, n_planes, 8, 32)
    pos, neg = planes_of(w, n_planes)
    low, high = packed_step_words(pack(pos), pack(neg), 0, shift)
    got = np.concatenate([np.stack([sbytes(x) for x in low], 0),
                          np.stack([sbytes(x) for x in high], 0)], -1)
    got = got.transpose(2, 1, 0).reshape(8, 32)   # (row, quad, c) -> (k, n)
    want = tpm.rebuild_weight(torch.from_numpy(pos), torch.from_numpy(neg),
                              torch.tensor(float(shift))).numpy()
    np.testing.assert_array_equal(got, want)
    if shift == 0:
        np.testing.assert_array_equal(got, w)


# (M, K, N) at which B2 is driven: 8 rows a step, K % 8 == 0
PACKED_CASES = [(m, 96, 136) for m in (1, 3, 4, 5, 8)] + [(4, 1024, 40)]


@pytest.mark.parametrize("m,k,n", PACKED_CASES)
@pytest.mark.parametrize("n_planes,shift", [(7, 0), (7, 5), (6, 1), (3, 2),
                                            (1, 0), (7, 7)])
def test_packed_launch_matches_int_product_and_oracle(m, k, n, n_planes,
                                                      shift):
    rng = np.random.default_rng(m * 1000 + k + n_planes * 10 + shift)
    pos, neg = planes_of(rand_weights(rng, n_planes, k, n), n_planes)
    q = rand_codes(rng, m, k)
    got, covered, (acc, tickets) = packed_launch(q, pos, neg, shift)
    np.testing.assert_array_equal(got, int_product(q, pos, neg, shift))
    assert (covered == 1).all() and not acc.any() and not tickets.any()
    if shift == 0:
        np.testing.assert_array_equal(got.astype(np.float32),
                                      jax_oracle(q, pos, neg))


# (M, K, N) at which B1/B4 are driven: 4 rows a step, ragged K included
PLANES_CASES = ([(m, 96, 136) for m in (1, 3, 4, 5, 8)]
                + [(4, 130, 72), (8, 130, 72), (1, 37, 8), (4, 1030, 16)])


@pytest.mark.parametrize("mode", tpm.MODES)
@pytest.mark.parametrize("m,k,n", PLANES_CASES)
@pytest.mark.parametrize("n_planes,shift", [(7, 0), (7, 5), (6, 1), (3, 3),
                                            (1, 0)])
def test_planes_launch_matches_int_product_and_oracle(mode, m, k, n,
                                                      n_planes, shift):
    rng = np.random.default_rng(m * 1000 + k + n_planes * 10 + shift)
    pos, neg = planes_of(rand_weights(rng, n_planes, k, n), n_planes)
    q = rand_codes(rng, m, k)
    got, covered, (acc, tickets) = planes_launch(q, pos, neg, shift, mode)
    np.testing.assert_array_equal(got, int_product(q, pos, neg, shift, mode))
    assert (covered == 1).all() and not acc.any() and not tickets.any()
    if shift == 0:
        np.testing.assert_array_equal(got.astype(np.float32),
                                      jax_oracle(q, pos, neg))


@pytest.mark.parametrize("kernel", ["packed", "fused", "planes"])
def test_extremes_signed_codes(kernel):
    """7 planes of +-127 weights against codes of +-127 (dp4a is s8 x s8;
    'planes' negates the codes per byte) over K = 2048: the largest sums."""
    rng = np.random.default_rng(5)
    k, n = 2048, 16
    w = 127 * (rng.integers(0, 2, size=(k, n)) * 2 - 1)
    pos, neg = planes_of(w, 7)
    q = np.where(rng.integers(0, 2, size=(4, k)) == 1, 127, -127
                 ).astype(np.int8)
    w[:, 0] = 127                        # row 0, column 0: 127^2 K
    q[0] = 127
    q[1] = -127 * np.sign(w[:, 1])       # row 1, column 1: -127^2 K
    pos, neg = planes_of(w, 7)
    if kernel == "packed":
        got = packed_launch(q, pos, neg, 0)[0]
    else:
        got = planes_launch(q, pos, neg, 0, kernel)[0]
    want = q.astype(np.int64) @ w
    assert want[0, 0] == 127 * 127 * k and want[1, 1] == -127 * 127 * k
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got, int_product(q, pos, neg))


@pytest.mark.parametrize("m", [1, 4, 8])
def test_epilogue_matches_plain_versions(m):
    """y = ((sum - zcol) * s) * gamma from the emulated sums, in the
    kernels' association (__fmul_rn), equals each plain version: B1/B2 with
    the encode of fp32 x at plane_shift 1, B4/B5 with per-row scales."""
    rng = np.random.default_rng(m)
    k, n, n_planes = 96, 40, 6
    pos, neg = planes_of(rand_weights(rng, n_planes, k, n), n_planes)
    x = torch.from_numpy(rng.standard_normal((m, k)).astype(np.float32))
    gamma = torch.from_numpy(rng.random(n).astype(np.float32) * 1e-3)
    zcol = torch.from_numpy(rng.integers(-2 ** 20, 2 ** 20, n)
                            .astype(np.int32))
    qp = torch.tensor([0.02, 40.0, 127.0, 1.0])
    from repro_torch.core import quant
    q = quant.affine_encode(x, qp[0], qp[1], qp[2]).to(torch.int8).numpy()

    def y_of(sums, s):
        acc = torch.from_numpy(sums.astype(np.int32)) - zcol
        return torch.from_numpy(
            (acc.numpy().astype(np.float32) * s) * gamma.numpy())

    tp, tn = torch.from_numpy(pos), torch.from_numpy(neg)
    for mode in tpm.MODES:
        got = y_of(planes_launch(q, pos, neg, 1, mode)[0], np.float32(0.02))
        want = tpm.pann_matmul_act_plain(x, tp, tn, qp, gamma, zcol, mode)
        assert torch.equal(got, want)
    got = y_of(packed_launch(q, pos, neg, 1)[0], np.float32(0.02))
    want = tpk.pann_matmul_packed_act_plain(
        x, torch.from_numpy(pack(pos)), torch.from_numpy(pack(neg)), qp,
        gamma, zcol)
    assert torch.equal(got, want)
    sx = rng.random((m, 1)).astype(np.float32) + 0.5
    for mode in tpm.MODES:
        got = y_of(planes_launch(q, pos, neg, 0, mode)[0], sx)
        want = tpm.pann_matmul_plain(torch.from_numpy(q), tp, tn,
                                     torch.from_numpy(sx), gamma, zcol,
                                     mode=mode)
        assert torch.equal(got, want)
    got = y_of(packed_launch(q, pos, neg, 0)[0], sx)
    want = tpk.pann_matmul_packed_plain(
        torch.from_numpy(q), torch.from_numpy(pack(pos)),
        torch.from_numpy(pack(neg)), torch.from_numpy(sx), gamma, zcol)
    assert torch.equal(got, want)


# (K, N) where the card drives the decode kernels: phase 3 (the serve's
# projections and lm_head), phase 6 and the ragged shapes of chip_smoke.py
CARD_SHAPES = [(4096, 4096), (4096, 1024), (4096, 14336), (14336, 4096),
               (4096, 128256), (130, 72), (4100, 136), (14336, 1024)]


@pytest.mark.parametrize("m", range(1, tpm.DECODE_ROWS + 1))
@pytest.mark.parametrize("k,n,step", [
    (k, n, step) for k, n in CARD_SHAPES
    for step in (tpm.STEP_PLANES, tpm.STEP_PACKED)
    if step == tpm.STEP_PLANES or k % 8 == 0])   # packed planes: K % 8 == 0
def test_decode_split_covers_every_row_once(k, n, step, m):
    """At M rows (a row tile of 4 or 8): every split non-empty, whole-warp
    chunks, the code panel and the block's sums inside shared memory's
    48 KB, no more blocks than the card's slots (unless one split already
    overfills them), and the warps' steps cover every K row once."""
    mt = 4 if m <= 4 else 8
    slots = SMS * blocks_of(step)[mt]
    ksplit, kchunk = tpm.decode_split(k, n, step, slots)
    align = tpm.DECODE_WARPS * step
    assert kchunk % align == 0 and kchunk <= 4096
    assert mt * (4 * tpm.DECODE_COLS + kchunk) <= 48 * 1024
    assert ksplit * kchunk >= k > (ksplit - 1) * kchunk
    tiles = -(-n // tpm.DECODE_COLS)
    assert ksplit == 1 or tiles * ksplit <= slots
    seen = np.zeros(k, np.int64)
    for y in range(ksplit):
        k0 = y * kchunk
        kc = min(kchunk, k - k0)
        assert kc > 0
        for warp in range(tpm.DECODE_WARPS):
            for s in range(warp, -(-kc // step), tpm.DECODE_WARPS):
                rows = np.arange(k0 + step * s, k0 + step * s + step)
                seen[rows[rows < k0 + kc]] += 1
    assert (seen == 1).all()


@settings(deadline=None, max_examples=20, derandomize=True)
@given(n_planes=st.integers(1, 7), m=st.integers(1, 8), data=st.data())
def test_packed_and_planes_launch_property(n_planes, m, data):
    shift = data.draw(st.integers(0, n_planes))
    k8 = data.draw(st.integers(1, 24))
    n = 4 * data.draw(st.integers(1, 40))
    seed = data.draw(st.integers(0, 2 ** 31 - 1))
    rng = np.random.default_rng(seed)
    pos, neg = planes_of(rand_weights(rng, n_planes, 8 * k8, n), n_planes)
    q = rand_codes(rng, m, 8 * k8, signed=True)
    want = int_product(q, pos, neg, shift)
    np.testing.assert_array_equal(packed_launch(q, pos, neg, shift, seed)[0],
                                  want)
    for mode in tpm.MODES:
        np.testing.assert_array_equal(
            planes_launch(q[:, :8 * k8 - 3], pos[:, :8 * k8 - 3],
                          neg[:, :8 * k8 - 3], shift, mode, seed)[0],
            int_product(q[:, :8 * k8 - 3], pos[:, :8 * k8 - 3],
                        neg[:, :8 * k8 - 3], shift, mode))


# ---------------------------------------------------------------------------
# B6 unsigned_matmul at M <= 8
# ---------------------------------------------------------------------------

def signed_weights(rng, k: int, n: int) -> np.ndarray:
    """int8 weights in [-127, 127], +-127 forced into the first row."""
    w = rng.integers(-127, 128, size=(k, n))
    w[0, ::2], w[0, 1::2] = 127, -127
    return w.astype(np.int8)


def test_signed_step_words_are_w_plus_and_w_minus():
    """B6's words of one step (4 rows x 32 columns) read back as bytes are
    max(w, 0) and max(-w, 0), K-major (byte i = row i), at every int8 of
    [-127, 127] and a ragged step (rows past kend give 0)."""
    rng = np.random.default_rng(0)
    vals = np.arange(-127, 128)
    for r in range(4):
        w = rng.integers(-127, 128, size=(4, vals.size + 1)).astype(np.int8)
        w[r, :vals.size] = vals
        w = w[:, :vals.size - vals.size % 4]
        for rows in ([0, 1, 2, 3], [0, 1, -1, -1]):
            halves = signed_step_words(w, np.array(rows))
            live = (np.array(rows) >= 0)[:, None]
            for side, want in ((0, np.maximum(w, 0)), (1, np.maximum(-w, 0))):
                got = np.stack([ubytes(halves[c][side]) for c in range(4)])
                # (column c, quad, row i) -> (row i, column 4 quad + c)
                got = got.transpose(2, 1, 0).reshape(4, -1)
                np.testing.assert_array_equal(got, np.where(live, want, 0))


# (K, N) at which B6's decode is emulated: ragged K (no multiple of 4 or of
# the 32-row chunk alignment) and ragged N (a partial 128-column tile)
SIGNED_CASES = [(96, 136), (130, 72), (37, 8), (1030, 16)]


@pytest.mark.parametrize("k,n", SIGNED_CASES)
@pytest.mark.parametrize("m", range(1, tpm.DECODE_ROWS + 1))
def test_signed_launch_matches_plain_and_oracle(m, k, n):
    """B6's decode launch: sums equal x_q @ w, every K row once, buffers
    left zero; y = (sum * s_x) * s_w (the finish's __fmul_rn order) equals
    unsigned_matmul_plain and the JAX oracle bit for bit. The last row of
    codes is all zero."""
    rng = np.random.default_rng(m * 1000 + k + n)
    w = signed_weights(rng, k, n)
    q = rand_codes(rng, m, k)
    if m > 1:
        q[-1] = 0
    got, covered, (acc, tickets) = signed_launch(q, w, seed=m)
    np.testing.assert_array_equal(got, q.astype(np.int64) @ w)
    assert (covered == 1).all() and not acc.any() and not tickets.any()
    sx = (rng.random((m, 1)) + 0.5).astype(np.float32)
    sw = (rng.random(n) * 1e-3).astype(np.float32)
    y = (got.astype(np.int32).astype(np.float32) * sx) * sw[None, :]
    t = torch.from_numpy
    want = tum.unsigned_matmul_plain(t(q), t(w), t(sx), t(sw)).numpy()
    np.testing.assert_array_equal(y, want)
    np.testing.assert_array_equal(y, np.asarray(rref.unsigned_matmul_ref(
        jnp.asarray(q), jnp.asarray(w), jnp.asarray(sx), jnp.asarray(sw))))


@pytest.mark.parametrize("m", [1, 4, 5, 8])
def test_signed_extremes(m):
    """|w| = 127 with random signs against codes of 127 at K = 14336 (the
    path's deepest K): the largest sums acc_pos and acc_neg meet, 127^2 K =
    231,231,744 in a column of all +127 (and of all -127)."""
    rng = np.random.default_rng(7)
    k, n = 14336, 8
    w = (127 * (rng.integers(0, 2, size=(k, n)) * 2 - 1)).astype(np.int8)
    w[:, 0], w[:, 1] = 127, -127
    q = np.full((m, k), 127, np.int8)
    got = signed_launch(q, w)[0]
    want = q.astype(np.int64) @ w
    assert want[0, 0] == 127 * 127 * k and want[0, 1] == -127 * 127 * k
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("m", range(1, tpm.DECODE_ROWS + 1))
@pytest.mark.parametrize("k,n", CARD_SHAPES + [(520, 1028), (37, 8)])
def test_signed_decode_split_covers_every_row_once(k, n, m):
    """B6's split at BLOCKS_SIGNED blocks a SM: whole-warp chunks of 4-row
    steps, panel and sums inside 48 KB of shared memory, no more blocks
    than slots unless one split already overfills them, and every K row
    covered once by the warps' steps."""
    mt = 4 if m <= 4 else 8
    slots = SMS * tpm.BLOCKS_SIGNED[mt]
    ksplit, kchunk = tpm.decode_split(k, n, tpm.STEP_PLANES, slots)
    assert kchunk % (tpm.DECODE_WARPS * tpm.STEP_PLANES) == 0
    assert mt * (4 * tpm.DECODE_COLS + kchunk) <= 48 * 1024
    assert ksplit * kchunk >= k > (ksplit - 1) * kchunk
    assert ksplit == 1 or -(-n // tpm.DECODE_COLS) * ksplit <= slots
    seen = np.zeros(k, np.int64)
    for y in range(ksplit):
        kc = min(kchunk, k - y * kchunk)
        assert kc > 0
        for warp in range(tpm.DECODE_WARPS):
            for s in range(warp, -(-kc // 4), tpm.DECODE_WARPS):
                rows = np.arange(y * kchunk + 4 * s, y * kchunk + 4 * s + 4)
                seen[rows[rows < y * kchunk + kc]] += 1
    assert (seen == 1).all()


@settings(deadline=None, max_examples=20, derandomize=True)
@given(m=st.integers(1, 8), k=st.integers(1, 300), n4=st.integers(1, 40),
       seed=st.integers(0, 2 ** 31 - 1))
def test_signed_launch_property(m, k, n4, seed):
    rng = np.random.default_rng(seed)
    w = signed_weights(rng, k, 4 * n4)
    q = rand_codes(rng, m, k)
    got, covered, (acc, tickets) = signed_launch(q, w, seed)
    np.testing.assert_array_equal(got, q.astype(np.int64) @ w)
    assert (covered == 1).all() and not acc.any() and not tickets.any()


# the reduced llama3-8b's w_down, and a ragged-N one with a longer K (more
# legal splits)
TUNE_SHAPES = ((128, 64), (1000, 72))


@pytest.mark.parametrize("backend", ["packed", "fused"])
@pytest.mark.parametrize("m", [1, 4, 8])
def test_every_tuned_split_is_bit_identical(backend, m):
    """Every legal (ksplit, kchunk) the autotuner measures
    (``autotune.candidate_params``) gives B2's / B1's decode launch the
    same int32 sums as the plain version, every K row once, and leaves
    the atomics buffer and tickets zero: a tuned launch is exact."""
    from repro_torch.kernels import autotune
    rng = np.random.default_rng(100 * m + len(backend))
    for k, n in TUNE_SHAPES:
        pos, neg = planes_of(rand_weights(rng, MAX_PLANES, k, n), MAX_PLANES)
        q = rand_codes(rng, m, k)
        splits = autotune.candidate_params(m, k, n, backend)
        assert len(splits) >= (1 if k <= 128 else 5)
        shift = 2
        want = int_product(q, pos, neg, shift)
        for split in splits:
            if backend == "packed":
                got, covered, bufs = packed_launch(q, pos, neg, shift,
                                                   split=split)
            else:
                got, covered, bufs = planes_launch(q, pos, neg, shift,
                                                   "fused", split=split)
            np.testing.assert_array_equal(got, want)
            assert (covered == 1).all()
            assert not bufs[0].any() and not bufs[1].any()


# (M, K, N, shards, plane_shift): a row-parallel projection's K split over
# the "model" ranks; a shard's K a multiple of the packed planes' 8
ACC_SHARDS = [(1, 128, 40, 2, 0), (4, 256, 72, 4, 1), (8, 96, 40, 2, 3),
              (3, 4096 // 16, 136, 2, 0)]


@pytest.mark.parametrize("m,k,n,shards,shift", ACC_SHARDS)
def test_accumulator_mode_and_epilogue_entry(m, k, n, shards, shift):
    """The accumulator mode at M <= 8 (``Finish.sums`` set): each K shard's
    launch stores the int32 sums the finish reads (the ticketed read-back
    of the split-K atomics, or the block's own sums), no epilogue; equal
    to ``*_act_acc_plain`` on that shard. The shards' sums added (the
    ranks' int32 all-reduce) equal the whole-K product, and the epilogue
    entry (``epilogue_kernel`` at ksplit 1: one sum, minus zcol, two
    __fmul_rn) on them equals the whole projection's plain version and
    ``pann_epilogue_plain``, bit for bit."""
    rng = np.random.default_rng(m + k + n + shards)
    n_planes = 7
    pos, neg = planes_of(rand_weights(rng, n_planes, k, n), n_planes)
    x = torch.from_numpy(rng.standard_normal((m, k)).astype(np.float32))
    gamma = torch.from_numpy(rng.random(n).astype(np.float32) * 1e-3)
    zcol = torch.from_numpy(rng.integers(-2 ** 20, 2 ** 20, n)
                            .astype(np.int32))
    qp = torch.tensor([0.02, 40.0, 127.0, float(shift)])
    from repro_torch.core import quant
    q = quant.affine_encode(x, qp[0], qp[1], qp[2]).to(torch.int8).numpy()
    ks = k // shards
    t = torch.from_numpy
    for kind in ("packed",) + tpm.MODES:
        total = np.zeros((m, n), np.int64)
        for r in range(shards):
            sl = slice(r * ks, (r + 1) * ks)
            qs, ps, ns = q[:, sl], pos[:, sl], neg[:, sl]
            if kind == "packed":
                sums = packed_launch(qs, ps, ns, shift, seed=r)[0]
                plain = tpk.pann_matmul_packed_act_acc_plain(
                    x[:, sl].contiguous(), t(pack(ps)), t(pack(ns)), qp)
            else:
                sums = planes_launch(qs, ps, ns, shift, kind, seed=r)[0]
                plain = tpm.pann_matmul_act_acc_plain(
                    x[:, sl].contiguous(), t(ps), t(ns), qp, kind)
            assert plain.dtype == torch.int32
            np.testing.assert_array_equal(sums, plain.numpy())
            total += sums
        np.testing.assert_array_equal(
            total, int_product(q, pos, neg, shift))
        acc = total.astype(np.int32) - zcol.numpy()        # epilogue_kernel
        y = (acc.astype(np.float32) * np.float32(0.02)) * gamma.numpy()
        assert torch.equal(t(y), tpm.pann_epilogue_plain(
            t(total.astype(np.int32)), qp, gamma, zcol))
        whole = (tpk.pann_matmul_packed_act_plain(x, t(pack(pos)),
                                                  t(pack(neg)), qp, gamma,
                                                  zcol)
                 if kind == "packed" else
                 tpm.pann_matmul_act_plain(x, t(pos), t(neg), qp, gamma,
                                           zcol, kind))
        assert torch.equal(t(y), whole)
