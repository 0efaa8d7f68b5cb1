"""The unfused code path's kernels and their model-level definitions: the
port's plain versions of B4 ``pann_matmul`` (both modes), B5
``pann_matmul_packed``, B6 ``unsigned_matmul`` and B7 ``quantize_act``
against the JAX package's Pallas kernels in interpret mode (as its own
tests run them) and its oracles, B1's 'planes' mode against its 'fused'
mode, and the deployment subset of ``core`` (RUQ, the unsigned split, the
bit-plane forward) against ``repro.core`` — the same seeded numpy inputs
on both sides, CPU.

Tolerances: the integer products and their two-multiply epilogues are
bit-identical. B7 is bit-identical to ``ref.quantize_act_ref``; the jitted
interpret-mode kernel computes the scale as a multiply by 1/qmax (XLA's
rewrite of the division), so against it scales agree within 1 ulp and
codes within 1 on under 1 % of the elements. fp32 outputs of the model
functions whose weights the port quantizes itself (``pann_prepare``) are
held to rtol 1e-6 (gamma is an fp32 sum taken in another order).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import pann as rpann
from repro.core import quant as rquant
from repro.core import unsigned as runs
from repro.kernels import ref as rref
from repro.kernels.pann_matmul import pann_matmul as r_pann_matmul
from repro.kernels.pann_matmul import pann_matmul_act as r_pann_matmul_act
from repro.kernels.pann_matmul_packed import pack_planes as r_pack
from repro.kernels.pann_matmul_packed import (
    pann_matmul_packed as r_pann_matmul_packed)
from repro.kernels.quantize_act import quantize_act as r_quantize_act
from repro.kernels.unsigned_matmul import unsigned_matmul as r_unsigned
from repro_torch.core import pann as tpann
from repro_torch.core import quant as tquant
from repro_torch.core import unsigned as tuns
from repro_torch.kernels import pann_matmul as tpm
from repro_torch.kernels import pann_matmul_packed as tpk
from repro_torch.kernels import quantize_act as tqa
from repro_torch.kernels import ref as tref
from repro_torch.kernels import unsigned_matmul as tum


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _planes(rng, k, n, n_planes):
    """Signed codes in (-2^P, 2^P) split into (P, K, N) int8 planes."""
    hi = 1 << n_planes
    w_q = rng.integers(-(hi - 1), hi, (k, n))
    pos, neg = np.maximum(w_q, 0), np.maximum(-w_q, 0)
    shifts = np.arange(n_planes).reshape(-1, 1, 1)
    return (w_q, ((pos[None] >> shifts) & 1).astype(np.int8),
            ((neg[None] >> shifts) & 1).astype(np.int8))


def _codes_operands(seed, m, k, n, n_planes, zcol):
    rng = np.random.default_rng(seed)
    w_q, pp, pn = _planes(rng, k, n, n_planes)
    x_q = rng.integers(0, 128, (m, k)).astype(np.int8)
    s_x = rng.uniform(0.01, 0.1, (m, 1)).astype(np.float32)
    gamma = rng.uniform(0.001, 0.01, (n,)).astype(np.float32)
    zc = (rng.integers(-2 ** 16, 2 ** 16, (n,)).astype(np.int32)
          if zcol else None)
    return w_q, pp, pn, x_q, s_x, gamma, zc


def _j(a):
    return None if a is None else jnp.asarray(a)


# the shapes of tests/test_kernels.py and tests/test_kernels_packed.py, and
# the plane-count sweep 1..6; the last case carries a zero-point row
CODES_CASES = [(128, 128, 128, 4, False), (128, 256, 128, 4, False),
               (256, 512, 256, 4, False), (128, 128, 128, 1, False),
               (128, 128, 128, 2, False), (128, 128, 128, 3, False),
               (128, 128, 128, 5, False), (128, 128, 128, 6, False),
               (128, 256, 128, 5, True)]
PACKED_CASES = [(128, 128, 128, 3, False), (128, 256, 128, 4, False),
                (256, 128, 256, 2, False), (128, 128, 128, 1, False),
                (128, 128, 128, 5, False), (128, 128, 128, 6, True)]


@pytest.mark.parametrize("mode", ["fused", "planes"])
@pytest.mark.parametrize("m,k,n,n_planes,zcol", CODES_CASES)
def test_pann_matmul_plain_bit_identical_to_pallas(m, k, n, n_planes, zcol,
                                                   mode):
    _, pp, pn, x_q, s_x, gamma, zc = _codes_operands(m + n_planes, m, k, n,
                                                     n_planes, zcol)
    want = np.asarray(r_pann_matmul(
        jnp.asarray(x_q), jnp.asarray(pp), jnp.asarray(pn), jnp.asarray(s_x),
        jnp.asarray(gamma), _j(zc), mode=mode, interpret=True))
    got = tpm.pann_matmul(_t(x_q), _t(pp), _t(pn), _t(s_x), _t(gamma),
                          None if zc is None else _t(zc), mode=mode).numpy()
    assert got.dtype == want.dtype and np.array_equal(got, want)
    if zc is None:
        oracle = tref.pann_matmul_ref(_t(x_q), _t(pp), _t(pn), _t(s_x),
                                      _t(gamma)).numpy()
        assert np.array_equal(oracle, np.asarray(rref.pann_matmul_ref(
            jnp.asarray(x_q), jnp.asarray(pp), jnp.asarray(pn),
            jnp.asarray(s_x), jnp.asarray(gamma))))
        assert np.array_equal(got, oracle)


@pytest.mark.parametrize("m,k,n,n_planes,zcol", PACKED_CASES)
def test_pann_matmul_packed_plain_bit_identical_to_pallas(m, k, n, n_planes,
                                                          zcol):
    _, pp, pn, x_q, s_x, gamma, zc = _codes_operands(k + n_planes, m, k, n,
                                                     n_planes, zcol)
    want = np.asarray(r_pann_matmul_packed(
        jnp.asarray(x_q), r_pack(jnp.asarray(pp)), r_pack(jnp.asarray(pn)),
        jnp.asarray(s_x), jnp.asarray(gamma), _j(zc), interpret=True))
    got = tpk.pann_matmul_packed(
        _t(x_q), tpk.pack_planes(_t(pp)), tpk.pack_planes(_t(pn)), _t(s_x),
        _t(gamma), None if zc is None else _t(zc)).numpy()
    assert np.array_equal(got, want)
    # the packed and unpacked products of the same planes agree
    assert np.array_equal(got, tpm.pann_matmul(
        _t(x_q), _t(pp), _t(pn), _t(s_x), _t(gamma),
        None if zc is None else _t(zc)).numpy())


@pytest.mark.parametrize("m,k,n", [(128, 128, 128), (128, 384, 256)])
def test_unsigned_matmul_plain_bit_identical_to_pallas(m, k, n):
    rng = np.random.default_rng(k)
    x_q = rng.integers(0, 128, (m, k)).astype(np.int8)
    w_q = rng.integers(-127, 128, (k, n)).astype(np.int8)
    s_x = rng.uniform(0.01, 0.1, (m, 1)).astype(np.float32)
    s_w = rng.uniform(0.001, 0.01, (n,)).astype(np.float32)
    want = np.asarray(r_unsigned(jnp.asarray(x_q), jnp.asarray(w_q),
                                 jnp.asarray(s_x), jnp.asarray(s_w),
                                 interpret=True))
    got = tum.unsigned_matmul(_t(x_q), _t(w_q), _t(s_x), _t(s_w)).numpy()
    assert np.array_equal(got, want)
    oracle = tref.unsigned_matmul_ref(_t(x_q), _t(w_q), _t(s_x), _t(s_w))
    assert np.array_equal(oracle.numpy(), np.asarray(rref.unsigned_matmul_ref(
        jnp.asarray(x_q), jnp.asarray(w_q), jnp.asarray(s_x),
        jnp.asarray(s_w))))
    assert np.array_equal(got, oracle.numpy())


def test_codes_kernels_agree_with_each_other():
    """B4 (both modes), B5 and B6 on the same integers and scales compute
    the same product and the same two multiplies."""
    w_q, pp, pn, x_q, s_x, gamma, _ = _codes_operands(7, 96, 200, 72, 6,
                                                      False)
    args = (_t(x_q), _t(pp), _t(pn), _t(s_x), _t(gamma))
    outs = [tpm.pann_matmul(*args, mode="fused"),
            tpm.pann_matmul(*args, mode="planes"),
            tpk.pann_matmul_packed(_t(x_q), tpk.pack_planes(_t(pp)),
                                   tpk.pack_planes(_t(pn)), _t(s_x),
                                   _t(gamma)),
            tum.unsigned_matmul(_t(x_q), _t(w_q.astype(np.int8)), _t(s_x),
                                _t(gamma)),
            tref.pann_matmul_ref(*args)]
    for y in outs[1:]:
        assert torch.equal(y, outs[0])


def _ulps(a, b):
    """|a - b| in units of the last place of float32 b (both positive)."""
    return np.abs(a.view(np.int32).astype(np.int64)
                  - b.view(np.int32).astype(np.int64))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("m,k", [(128, 256), (256, 128)])
@pytest.mark.parametrize("bits", [2, 4, 6, 8])
def test_quantize_act_bit_identical_to_oracle(bits, m, k, dtype):
    rng = np.random.default_rng(bits * 1000 + m)
    x32 = (3 * rng.standard_normal((m, k))).astype(np.float32)
    xj = jnp.asarray(x32, getattr(jnp, dtype))
    xt = _t(x32).to(getattr(torch, dtype))
    assert np.array_equal(np.asarray(xj.astype(jnp.float32)),
                          xt.float().numpy())
    qr, sr = rref.quantize_act_ref(xj, bits=bits)
    q, s = tqa.quantize_act(xt, bits=bits)
    assert q.dtype == torch.int8 and s.shape == (m, 1)
    assert np.array_equal(q.numpy(), np.asarray(qr))
    assert np.array_equal(s.numpy(), np.asarray(sr))
    # the jitted Pallas kernel (interpret mode): XLA's reciprocal multiply
    qk, sk = r_quantize_act(xj, bits=bits, bm=128, interpret=True)
    ulps = _ulps(s.numpy(), np.asarray(sk))
    rows = int(np.sum(ulps > 0))
    print(f"bits={bits} {dtype} ({m}, {k}): {rows} of {m} row scales differ "
          f"from the interpret-mode kernel's, by at most {ulps.max()} ulp")
    assert ulps.max() <= 1
    diff = np.abs(q.numpy().astype(np.int32) - np.asarray(qk, np.int32))
    assert diff.max() <= 1 and (diff > 0).mean() < 0.01
    assert int(q.max()) <= (1 << (bits - 1)) - 1 and int(q.min()) >= 0


@pytest.mark.parametrize("shift", range(7))
def test_pann_matmul_act_planes_mode_equals_fused(shift):
    """B1's 'planes' mode (the port's new mode) gives 'fused' bit for bit
    and the JAX kernel's 'planes' mode, at every plane_shift."""
    rng = np.random.default_rng(shift)
    m, k, n = 16, 128, 128
    _, pp, pn = _planes(rng, k, n, 7)
    x = (rng.standard_normal((m, k)) * 2 + 0.3).astype(np.float32)
    lo, hi = rquant.act_range_bounds(jnp.asarray(x), include_zero=True)
    s, z = rquant.affine_scale_zp(lo, hi, jnp.float32(127.0))
    qp = np.array([s, z, 127.0, shift], np.float32)
    gamma = rng.uniform(0.001, 0.01, (n,)).astype(np.float32)
    zcol = rng.integers(-2 ** 16, 2 ** 16, (n,)).astype(np.int32)
    args = (_t(x), _t(pp), _t(pn), _t(qp), _t(gamma), _t(zcol))
    fused = tpm.pann_matmul_act(*args, mode="fused").numpy()
    planes = tpm.pann_matmul_act(*args, mode="planes").numpy()
    assert np.array_equal(planes, fused)
    want = np.asarray(r_pann_matmul_act(
        jnp.asarray(x), jnp.asarray(pp), jnp.asarray(pn),
        jnp.asarray(qp.reshape(1, 4)), jnp.asarray(gamma), jnp.asarray(zcol),
        mode="planes", bm=16, bn=128, bk=128, interpret=True))
    assert np.array_equal(planes, want)


def test_unknown_mode_raises():
    _, pp, pn, x_q, s_x, gamma, _ = _codes_operands(1, 4, 16, 8, 2, False)
    with pytest.raises(ValueError):
        tpm.pann_matmul(_t(x_q), _t(pp), _t(pn), _t(s_x), _t(gamma),
                        mode="fast")


# ---------------------------------------------------------------------------
# the core subset
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("bits", [2, 4, 8])
@pytest.mark.parametrize("signed,half_range", [(True, False), (False, False),
                                               (False, True)])
@pytest.mark.parametrize("axis", [None, 0, 1, -1])
def test_ruq_codes_and_scales_exact(bits, signed, half_range, axis):
    rng = np.random.default_rng(bits)
    x = (rng.standard_normal((24, 40)) * 1.5).astype(np.float32)
    rq, rs = rquant.ruq(jnp.asarray(x), bits, signed, axis,
                        half_range=half_range)
    tq, ts = tquant.ruq(_t(x), bits, signed, axis, half_range=half_range)
    assert np.array_equal(tq.numpy(), np.asarray(rq))
    assert np.array_equal(ts.numpy(), np.asarray(rs))
    tr, rr = (tquant.qrange(bits, signed, half_range),
              rquant.qrange(bits, signed, half_range))
    assert (tr.qmin, tr.qmax, tr.n_levels) == (rr.qmin, rr.qmax,
                                               rr.n_levels)
    assert np.array_equal(tquant.dequantize(tq, ts).numpy(),
                          np.asarray(rquant.dequantize(rq, rs)))


def _pann_weights(seed, k, n, r, axis):
    """The JAX package's PannWeights carried across, so that the products
    below see the same codes and steps."""
    rng = np.random.default_rng(seed)
    w = (rng.standard_normal((k, n)) * 0.05).astype(np.float32)
    rpw = rpann.pann_prepare(jnp.asarray(w), r, axis=axis)
    tpw = tpann.PannWeights(w_q=_t(np.asarray(rpw.w_q)),
                            gamma=_t(np.asarray(rpw.gamma)), r=r)
    return w, rpw, tpw


@pytest.mark.parametrize("axis", [None, 0])
@pytest.mark.parametrize("r", [0.7, 2.0, 7.9])
def test_pann_deployment_forward_exact(r, axis):
    w, rpw, tpw = _pann_weights(int(r * 10), 64, 48, r, axis)
    rng = np.random.default_rng(3)
    x = np.abs(rng.standard_normal((10, 64))).astype(np.float32)
    b = rng.standard_normal(48).astype(np.float32)
    for act_bits in (4, 8):
        want = np.asarray(rpann.pann_matmul_reference(jnp.asarray(x), rpw,
                                                      act_bits))
        got = tpann.pann_matmul_reference(_t(x), tpw, act_bits).numpy()
        assert np.array_equal(got, want)
        want = np.asarray(rpann.pann_bitplane_linear(
            jnp.asarray(x), rpw, act_bits, jnp.asarray(b)))
        got = tpann.pann_bitplane_linear(_t(x), tpw, act_bits,
                                         _t(b)).numpy()
        assert np.array_equal(got, want)
    apr = np.asarray(rpann.additions_per_element(rpw.w_q, axis=axis))
    apt = tpann.additions_per_element(tpw.w_q, dim=axis).numpy()
    assert np.array_equal(apt, apr)
    # the port's own quantizer: gamma within rtol 1e-6, and the forward
    # through it within the same bound
    tpw_own = tpann.pann_prepare(_t(w), r, dim=axis)
    gr, gt = np.asarray(rpw.gamma), tpw_own.gamma.numpy()
    assert np.max(np.abs(gt - gr) / gr) <= 1e-6
    want = np.asarray(rpann.pann_bitplane_linear(jnp.asarray(x), rpw, 8))
    got = tpann.pann_bitplane_linear(_t(x), tpw_own, 8).numpy()
    err = np.max(np.abs(got - want) / np.maximum(np.abs(want), 1e-3))
    print(f"r={r} axis={axis}: own quantizer forward rel err {err:.2e}")
    assert err <= 1e-6


@pytest.mark.parametrize("n_planes", [1, 3, 6])
def test_bitplane_matmul_exact(n_planes):
    rng = np.random.default_rng(n_planes)
    _, pp, pn = _planes(rng, 48, 20, n_planes)
    x = rng.integers(0, 128, (7, 48)).astype(np.float32)
    want = np.asarray(rpann.bitplane_matmul(jnp.asarray(x), jnp.asarray(pp),
                                            jnp.asarray(pn)))
    got = tpann.bitplane_matmul(_t(x), _t(pp), _t(pn)).numpy()
    assert np.array_equal(got, want)


def test_core_unsigned_matmul_exact():
    rng = np.random.default_rng(0)
    x = rng.integers(0, 64, (9, 32)).astype(np.float32)
    w = rng.integers(-20, 21, (32, 12)).astype(np.float32)
    b = rng.standard_normal(12).astype(np.float32)
    want = np.asarray(runs.unsigned_matmul(jnp.asarray(x), jnp.asarray(w),
                                           jnp.asarray(b)))
    got = tuns.unsigned_matmul(_t(x), _t(w), _t(b)).numpy()
    assert np.array_equal(got, want)
    assert tuns.is_unsigned_exact(_t(x), _t(w))
    assert runs.is_unsigned_exact(jnp.asarray(x), jnp.asarray(w))
