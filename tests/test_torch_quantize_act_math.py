"""The arithmetic of B7 ``quantize_act``'s CUDA kernel
(``src/repro_torch/csrc/quantize_act.cu``), emulated in numpy block by
block as the kernel runs it, on the CPU (the kernel itself runs only on the
card):

- the launch plan (``kernels.quantize_act.cluster_plan``): C blocks a row
  and V 16-byte vectors a thread, which cover every row;
- the chunking: a row's vectors start at its first 16-byte aligned element;
  vector g goes to rank g // (256 V), thread g % 256; the head before the
  first vector and the tail after the last whole one are single elements
  of rank 0's threads 0.. and 32..; every element held exactly once;
- the per-thread, per-warp and per-block maxima (0 is max's identity:
  max(relu x) >= 0), the cluster max in rank order, the one scale every
  block forms, ``fmaxf(amax, 1e-12f) / qmax`` (IEEE);
- the encode ``clip(rint(relu(x) / s), 0, qmax)`` (IEEE division, round
  half to even) and the stores: 4 (fp32) or 8 (bf16) codes a vector,
  aligned wherever x and q are 16-byte aligned.

Held bit for bit (tolerance 0) against the plain version
``kernels.ref.quantize_act_ref`` and the JAX package's oracle
``repro.kernels.ref.quantize_act_ref`` at M = 1..8, 131 and 512, K ragged
(no multiple of 4 or 16) and up to 14336, fp32 and bf16, bits 2..8,
all-zero and all-negative rows (the scale floors at 1e-12 / qmax) and an x
whose base is not 16-byte aligned.
"""
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st

from repro.kernels import ref as rref
from repro_torch.kernels import quantize_act as tqa
from repro_torch.kernels import ref as tref

SMS = 132                      # the H100's SM count, as the wrapper reads it
THREADS = tqa.THREADS
WARPS = THREADS // 32


def fp32_of(x: torch.Tensor) -> np.ndarray:
    """The kernel's fp32 view of x: fp32 as is, bf16 bits << 16."""
    if x.dtype == torch.float32:
        return x.numpy().copy()
    bits = x.view(torch.int16).numpy().view(np.uint16).astype(np.uint32)
    return (bits << np.uint32(16)).view(np.float32)


def emulate(x: torch.Tensor, bits: int, offset: int = 0) -> tuple:
    """(codes (M, K) int8, scales (M, 1) f32, stats) as the kernel computes
    them, one cluster a row, x's base ``offset`` elements past a 16-byte
    boundary (q's base 16-byte aligned). stats counts the aligned and byte
    stores."""
    m, k = x.shape
    esz = x.element_size()
    vec = 16 // esz
    c, v = tqa.cluster_plan(m, k, esz, SMS)
    assert c * THREADS * v * vec >= k       # the cluster covers a row
    xf = fp32_of(x)
    qmax = (1 << (bits - 1)) - 1
    qm = np.float32(qmax)
    q = np.full((m, k), -1, np.int64)
    scale = np.zeros((m, 1), np.float32)
    stats = {"aligned": 0, "bytes": 0}
    for row in range(m):
        addr = (offset + row * k) * esz
        h = min(k, (16 - addr % 16) % 16 // esz)
        nv = (k - h) // vec
        tail = k - h - nv * vec
        rank = np.empty(k, np.int64)
        thread = np.empty(k, np.int64)
        g = (np.arange(h, h + nv * vec) - h) // vec
        rank[h:h + nv * vec] = g // (THREADS * v)
        thread[h:h + nv * vec] = g % THREADS
        rank[:h] = 0
        thread[:h] = np.arange(h)
        rank[h + nv * vec:] = 0
        thread[h + nv * vec:] = 32 + np.arange(tail)
        assert (rank < c).all() and (thread < THREADS).all()
        # a thread's max, then the warp's (shuffles), the block's, the
        # cluster's in rank order
        t_max = np.zeros((c, THREADS), np.float32)
        np.maximum.at(t_max, (rank, thread), xf[row])
        b_max = t_max.reshape(c, WARPS, 32).max(-1).max(-1)
        amax = np.float32(0)
        for r in range(c):
            amax = max(amax, b_max[r])
        s = np.float32(max(amax, np.float32(1e-12))) / qm
        scale[row] = s
        relu = np.maximum(xf[row], np.float32(0))
        q[row] = np.clip(np.rint(relu / s), 0, qm).astype(np.int64)
        aligned = (row * k + h) % vec == 0
        stats["aligned" if aligned else "bytes"] += nv
        assert aligned or offset % vec or nv == 0
    return q.astype(np.int8), scale, stats


def jax_oracle(x: torch.Tensor, bits: int) -> tuple:
    dt = ml_dtypes.bfloat16 if x.dtype == torch.bfloat16 else np.float32
    xj = jnp.asarray(fp32_of(x).astype(dt))
    qr, sr = rref.quantize_act_ref(xj, bits=bits)
    return np.asarray(qr), np.asarray(sr)


def operand(rng, m, k, dtype, rows=("negative", "zero")) -> torch.Tensor:
    x = (3 * rng.standard_normal((m, k))).astype(np.float32)
    if "negative" in rows:
        x[0] = -np.abs(x[0]) - 1.0
    if "zero" in rows and m > 2:
        x[2] = 0.0
    return torch.from_numpy(x).to(dtype)


def check(x: torch.Tensor, bits: int, offset: int = 0) -> dict:
    q, s, stats = emulate(x, bits, offset)
    qp, sp = tref.quantize_act_ref(x, bits)
    np.testing.assert_array_equal(q, qp.numpy())
    np.testing.assert_array_equal(s, sp.numpy())
    qj, sj = jax_oracle(x, bits)
    np.testing.assert_array_equal(q, qj)
    np.testing.assert_array_equal(s, sj)
    return stats


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("m", list(range(1, 9)) + [131])
@pytest.mark.parametrize("k", [4096, 4100, 130, 37])
def test_emulated_kernel_matches_plain_and_oracle(k, m, dtype):
    """Every M the decode batch takes and a prefill's 131, K of whole and
    of ragged vectors; row 0 all negative, row 2 all zero: their scale is
    1e-12 / qmax and their codes 0."""
    rng = np.random.default_rng(m * 10000 + k)
    x = operand(rng, m, k, dtype)
    stats = check(x, 8)
    if k * x.element_size() % 16 == 0:
        assert stats["bytes"] == 0
    _, s, _ = emulate(x, 8)
    assert s[0, 0] == np.float32(1e-12) / np.float32(127)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("bits", range(2, 9))
def test_every_bit_width(bits, dtype):
    rng = np.random.default_rng(bits)
    check(operand(rng, 4, 1030, dtype), bits)


# the pass's shapes: (M, K, bytes an element) -> (C, V) on 132 SMs
PASS_PLANS = {(4, 4096, 4): (4, 1), (4, 14336, 4): (7, 2),
              (512, 4096, 4): (1, 4), (512, 14336, 4): (4, 4),
              (1, 4096, 2): (2, 1), (512, 14336, 2): (2, 4)}


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("k", [4096, 14336])
def test_prefill_rows(k, dtype):
    """M = 512, the pass's prefill chunk, at its two widths."""
    rng = np.random.default_rng(k)
    check(operand(rng, 512, k, dtype), 8)


@pytest.mark.parametrize("offset", [1, 2, 3])
def test_unaligned_base(offset):
    """x starting ``offset`` fp32 elements past a 16-byte boundary: every
    row has a head, the codes go out a byte at a time, the result is the
    same."""
    rng = np.random.default_rng(offset)
    stats = check(operand(rng, 4, 4096, torch.float32), 8, offset)
    assert stats["aligned"] == 0 and stats["bytes"] > 0


def test_cluster_plan_covers_the_card_and_the_row():
    """Every block of a cluster holds vectors and the cluster covers a row;
    C = 1 once M alone fills the SMs (up to 4 vectors a thread); V at most
    4 while 8 blocks of 4 cover a row; a row of more than 8 * 256 * 16
    vectors refused; the pass's plans."""
    for esz in (4, 2):
        vec = 16 // esz
        for m in (1, 2, 4, 8, 16, 33, 66, 131, 132, 512, 4096):
            for k in (1, 37, 130, 1024, 4096, 4100, 14336, 65536, 131072):
                c, v = tqa.cluster_plan(m, k, esz, SMS)
                vectors = -(-k // vec)
                assert 1 <= c <= 8 and v in tqa.VECTORS
                assert c * THREADS * v >= vectors              # covered
                assert (c - 1) * THREADS * v < vectors or c == 1  # no idle
                if vectors <= 8 * THREADS * tqa.PLAN_VECTORS:
                    assert v <= tqa.PLAN_VECTORS
                if m >= SMS and vectors <= THREADS * tqa.PLAN_VECTORS:
                    assert c == 1
                if c > 1 and v < tqa.PLAN_VECTORS:
                    assert m * c <= SMS
        with pytest.raises(ValueError):
            tqa.cluster_plan(4, 8 * THREADS * 16 * vec + 1, esz, SMS)
    for (m, k, esz), plan in PASS_PLANS.items():
        assert tqa.cluster_plan(m, k, esz, SMS) == plan


@settings(deadline=None, max_examples=25, derandomize=True)
@given(m=st.integers(1, 12), k=st.integers(1, 3000),
       bits=st.integers(2, 8), bf16=st.booleans(),
       offset=st.integers(0, 3), seed=st.integers(0, 2 ** 31 - 1))
def test_emulated_kernel_property(m, k, bits, bf16, offset, seed):
    rng = np.random.default_rng(seed)
    dtype = torch.bfloat16 if bf16 else torch.float32
    x = operand(rng, m, k, dtype, rows=())
    check(x, bits, offset if not bf16 else 0)
