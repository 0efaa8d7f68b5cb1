"""The float and fake-quant projections of the port against the JAX package
on the CPU: the quantizers (``fake_quant``, ``affine_quant_levels``,
``affine_from_range``, ``pann_fake_quant``), ``qlinear`` at its four modes,
``apply_linear``'s float-dequant branch of a serving artifact, the tied
head ``unembed`` at every mode, and the straight-through gradients.

Tolerances: the quantizers' codes, scales and zero points are equal bit
for bit (single correctly rounded fp32 ops on both sides), except the
codes of ``pann_fake_quant`` at ``.5`` ties of w / gamma, where gamma's
fp32 sum runs in another order (counted; every mismatch must sit at a
tie). Projections agree within 1e-6 * max|y| (the matmul's sum order);
'ruq' and 'ruq_unsigned' are bit-identical in the port.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.base import QuantConfig as RQuantConfig
from repro.core import pann as RP
from repro.core import quant as RQ
from repro.models import layers as RL
from repro_torch.configs.base import QuantConfig as TQuantConfig
from repro_torch.core import pann as TP
from repro_torch.core import quant as TQ
from repro_torch.models import layers as TL

REL = 1e-6


def _t(a):
    return torch.from_numpy(np.array(a))


def _x(shape, seed, loc=0.0):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal(shape) + loc).astype(np.float32)


def _w(shape, seed):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal(shape) * shape[0] ** -0.5).astype(np.float32)


def _close(got, want, rel=REL):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=rel * np.abs(want).max())


@pytest.mark.parametrize("signed,dim,half_range",
                         [(True, None, False), (True, 0, False),
                          (False, None, False), (False, -1, True)])
@pytest.mark.parametrize("bits", [2, 4, 8])
def test_fake_quant_matches_reference(bits, signed, dim, half_range):
    x = _x((6, 40), bits)
    want = RQ.fake_quant(jnp.asarray(x), bits, signed, axis=dim,
                         half_range=half_range)
    got = TQ.fake_quant(_t(x), bits, signed, dim=dim, half_range=half_range)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("include_zero", [False, True])
@pytest.mark.parametrize("loc", [0.0, 5.0])        # 5.0: does not span 0
def test_affine_quant_levels_matches_reference(loc, include_zero):
    x = _x((8, 24), 3, loc)
    for n in (3.0, 15.0, 127.0):
        want = RQ.affine_quant_levels(jnp.asarray(x), n,
                                      include_zero=include_zero)
        got = TQ.affine_quant_levels(_t(x), n, include_zero=include_zero)
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g.numpy(), np.asarray(w))


@pytest.mark.parametrize("case", ["seen", "unseen", "non_spanning"])
def test_affine_from_range_matches_reference(case):
    """A seen range is zero-extended; an unseen one (lo > hi) falls back to
    the dynamic extremes without the extension; a seen range that does not
    span 0 is extended to it."""
    x = _x((8, 24), 4, 1.0)
    lo, hi = {"seen": (-1.5, 2.25), "unseen": (1.0, -1.0),
              "non_spanning": (0.25, 3.5)}[case]
    n = 15.0
    want = RQ.affine_from_range(jnp.asarray(x), n, lo, hi)
    got = TQ.affine_from_range(_t(x), n, torch.tensor(lo), torch.tensor(hi))
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    if case == "unseen":
        dyn = TQ.affine_quant_levels(_t(x), n)
        for g, d in zip(got, dyn):
            assert torch.equal(g, d)


@pytest.mark.parametrize("rng", [(-1.5, 2.25), (1.0, -1.0), (0.25, 3.5)])
def test_affine_fake_quant_ranged_matches_reference(rng):
    """Against a seen, an unseen (lo > hi: the dynamic range, bit-exact
    with ``affine_fake_quant``) and a non-spanning calibrated range."""
    x = _x((4, 6, 32), 6, 0.5)
    want = RL.affine_fake_quant_ranged(jnp.asarray(x), 4,
                                       jnp.asarray(rng, jnp.float32))
    got = TL.affine_fake_quant_ranged(_t(x), 4, torch.tensor(rng))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    if rng[0] > rng[1]:
        assert torch.equal(got, TL.affine_fake_quant(_t(x), 4))


@pytest.mark.parametrize("r", [1.0, 2.83, 7.9])
def test_pann_fake_quant_codes_match_reference_but_ties(r):
    w = _w((96, 48), int(r * 10))
    want = np.asarray(RP.pann_fake_quant(jnp.asarray(w), r, axis=0))
    got = TP.pann_fake_quant(_t(w), r, dim=0).numpy()
    q_ref, g_ref = RP.pann_quantize(jnp.asarray(w), r, axis=0)
    q_port, g_port = TP.pann_quantize(_t(w), r, dim=0)
    np.testing.assert_allclose(g_port.numpy(), np.asarray(g_ref), rtol=1e-6)
    flipped = q_port.numpy() != np.asarray(q_ref)
    ratio = w / np.asarray(g_ref)
    ties = np.abs(np.abs(ratio - np.trunc(ratio)) - 0.5) < 1e-4
    assert not (flipped & ~ties).any()
    print(f"R={r}: {int(flipped.sum())} of {w.size} codes flipped at .5 "
          f"ties of w / gamma")
    # the dequantized weights: equal where the codes are
    same = ~flipped
    _close(got[same], want[same])


@pytest.mark.parametrize("mode", ["none", "ruq", "ruq_unsigned", "pann"])
@pytest.mark.parametrize("bias", [False, True])
def test_qlinear_matches_reference(mode, bias):
    x = _x((2, 5, 64), 7)
    w = _w((64, 48), 8)
    b = _x((48,), 9) * 0.1 if bias else None
    kw = dict(mode=mode, weight_bits=4, act_bits=6, r=2.83,
              act_bits_tilde=3)
    want = RL.qlinear(jnp.asarray(x), jnp.asarray(w),
                      None if b is None else jnp.asarray(b),
                      RQuantConfig(**kw), path="attn.wq")
    got = TL.qlinear(_t(x), _t(w), None if b is None else _t(b),
                     TQuantConfig(**kw), path="attn.wq")
    _close(got.numpy(), want)


def test_ruq_unsigned_is_ruq_and_unknown_mode_raises():
    x, w = _t(_x((3, 64), 1)), _t(_w((64, 32), 2))
    y = TL.qlinear(x, w, None, TQuantConfig(mode="ruq", weight_bits=5,
                                            act_bits=5))
    y_u = TL.qlinear(x, w, None, TQuantConfig(mode="ruq_unsigned",
                                              weight_bits=5, act_bits=5))
    assert torch.equal(y, y_u)
    with pytest.raises(ValueError, match="unknown quant mode"):
        TL.qlinear(x, w, None, TQuantConfig(mode="lsq"))


def _artifact_module(act: str, bias: bool):
    """One module's serving leaves: PANN codes at R = 2.83 and the act
    leaves of ``act`` ('act_n', 'range', 'unseen' or 'none')."""
    w = _w((64, 32), 11)
    q, gamma = RP.pann_quantize(jnp.asarray(w), 2.83, axis=0)
    p = {"w_q": np.asarray(jnp.clip(q, -127, 127).astype(jnp.int8)),
         "w_scale": np.asarray(gamma, np.float32)}
    if act != "none":
        p["act_n"] = np.float32(7.0)
    if act == "range":
        p["act_lo"], p["act_hi"] = np.float32(-1.25), np.float32(2.0)
    if act == "unseen":
        p["act_lo"], p["act_hi"] = np.float32(1.0), np.float32(-1.0)
    if bias:
        p["b"] = _x((32,), 12) * 0.1
    return p


@pytest.mark.parametrize("act", ["act_n", "range", "unseen", "none"])
@pytest.mark.parametrize("bias", [False, True])
def test_float_dequant_branch_matches_reference(act, bias):
    """``apply_linear`` on serving leaves with backend None: w = w_q *
    w_scale; activations fake-quantized at act_n levels over their own
    range, against the frozen act_lo/act_hi range, or not at all."""
    p = _artifact_module(act, bias)
    x = _x((2, 3, 64), 13)
    want = RL.apply_linear(jnp.asarray(x), jax.tree_util.tree_map(
        jnp.asarray, p), RQuantConfig(), backend=None)
    got = TL.apply_linear(_t(x), {k: _t(v) for k, v in p.items()},
                          TQuantConfig(), backend=None)
    _close(got.numpy(), want)


@pytest.mark.parametrize("mode", ["none", "ruq", "ruq_unsigned", "pann"])
def test_unembed_at_every_mode_matches_reference(mode):
    rng = np.random.default_rng(1)
    x = rng.standard_normal((2, 3, 64)).astype(np.float32)
    table = (rng.standard_normal((512, 64)) * 0.02).astype(np.float32)
    kw = dict(mode=mode, weight_bits=8, act_bits=8, r=5.5, act_bits_tilde=4)
    want = RL.unembed(jnp.asarray(x), {"table": jnp.asarray(table)},
                      RQuantConfig(**kw))
    got = TL.unembed(_t(x), {"table": _t(table)}, TQuantConfig(**kw))
    assert got.shape == (2, 3, 512)
    _close(got.numpy(), want)


def test_straight_through_gradients_are_identity_inside_the_range():
    x = _t(_x((4, 32), 5)).requires_grad_(True)
    TQ.fake_quant(x, 4, signed=True).sum().backward()
    assert torch.equal(x.grad, torch.ones_like(x))
    w = _t(_w((32, 16), 6)).requires_grad_(True)
    TP.pann_fake_quant(w, 2.0, dim=0).sum().backward()
    assert torch.equal(w.grad, torch.ones_like(w))
    x.grad = None
    TL.affine_fake_quant(x, 4).sum().backward()
    assert torch.equal(x.grad, torch.ones_like(x))
    # the projection: d/dx of sum(xq @ wq) is the row sums of wq, as the
    # reference's jax.grad gives
    xr, wr = _x((3, 32), 7), _w((32, 16), 8)
    qc = dict(mode="pann", r=2.0, act_bits_tilde=4)
    want = jax.grad(lambda a: RP.pann_qat_matmul(
        a, jnp.asarray(wr), RQuantConfig(**qc)).sum())(jnp.asarray(xr))
    xt = _t(xr).requires_grad_(True)
    TP.pann_qat_matmul(xt, _t(wr), TQuantConfig(**qc)).sum().backward()
    _close(xt.grad.numpy(), want)
