"""Mamba2 (SSD) of the port (``repro_torch.models.ssm``) against
``repro.models.ssm`` on the CPU, at reduced zamba2-1.2b (d = 64,
d_inner = 128, 8 heads of P = 16, state N = 16, conv width 4): the
softplus, the projection split, ``_causal_conv`` (with and without a
tail), ``_ssd_chunked`` (T = 64, 128 and T < 64, one chunk of T),
``apply_ssm`` at quant modes 'none' and 'pann', ``decode_ssm`` step by
step, and decode after a prefill against ``apply_ssm`` and, for the whole
model, against the reference's ``forward``.

Inputs and parameters are seeded numpy arrays handed to both sides; the
reference runs op by op (``jax.disable_jit()``), as its own tests run it.
The leaves its init makes 0 or 1 (conv bias, skip, norm scale) are
perturbed, so they are checked too.

Tolerance: every fp output within 1e-5 * max|ref| (``REL``), the conv tail
exact (it is a copy of inputs); whole-model logits within 1e-4 *
max|logit| (``LOGIT_REL``). At mode 'pann' the activation codes of both
sides are captured and compared: a code may flip only where the two
sides' fp inputs straddle a rounding boundary, so flips are counted and
held to 1 in 10^4 codes, with the output bound then 2e-2 (as
``test_torch_forward``).
"""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from repro import configs as rconfigs
from repro.configs.base import QuantConfig as RQuantConfig
from repro.core import quant as RQ
from repro.models import model as RMD
from repro.models import ssm as RS
from repro_torch import configs as tconfigs
from repro_torch.configs.base import QuantConfig as TQuantConfig
from repro_torch.convert import params_from_reference
from repro_torch.core import quant as TQ
from repro_torch.models import model as TMD
from repro_torch.models import ssm as TS
from test_torch_common import tonp
from test_torch_common import one_torch_thread  # noqa: F401
from test_torch_forward import _capture

ARCH = "zamba2-1.2b"
REL = 1e-5
LOGIT_REL = 1e-4
FLIP_REL = 2e-2
MAX_FLIP_SHARE = 1e-4
PANN = dict(mode="pann", r=2.83, act_bits_tilde=4)
VOCAB = 512


def ref_cfg(qc=None):
    cfg = rconfigs.reduced(rconfigs.get_config(ARCH))
    return cfg if qc is None else dataclasses.replace(
        cfg, quant=RQuantConfig(**qc))


def port_cfg(qc=None):
    cfg = tconfigs.reduced(tconfigs.get_config(ARCH))
    return cfg if qc is None else dataclasses.replace(
        cfg, quant=TQuantConfig(**qc))


# leaves the inits make constant, given seeded values here: (mean, sd)
PERTURB = {"conv_b": (0.0, 0.1), "d_skip": (1.0, 0.2), "dt_bias": (0.0, 0.1),
           "scale": (0.0, 0.2), "bias": (0.0, 0.3), "b": (0.0, 0.3),
           "bonus": (0.0, 0.3), "decay_base": (-4.0, 0.5), "mu": (0.5, 0.25)}


def perturb(node, rng, trail=()):
    """Seeded nonzero values for the leaves ``PERTURB`` names (numpy tree
    in, numpy tree out)."""
    if isinstance(node, dict):
        return {k: perturb(v, rng, trail + (k,)) for k, v in node.items()}
    if isinstance(node, (list, tuple)):
        return [perturb(v, rng, trail) for v in node]
    a = np.asarray(node)
    if trail and trail[-1] in PERTURB:
        mean, sd = PERTURB[trail[-1]]
        if trail[-1] == "scale":
            mean = a
        return (mean + rng.normal(0.0, sd, a.shape)).astype(a.dtype)
    return a


@functools.lru_cache(maxsize=None)
def ssm_params(seed=0):
    """One reference ``init_ssm`` block, perturbed (numpy)."""
    p = RS.init_ssm(jax.random.PRNGKey(seed), ref_cfg())
    return perturb(tonp(p), np.random.default_rng(seed + 5))


def _x(shape, seed, scale=1.0):
    return (np.random.default_rng(seed).standard_normal(shape)
            * scale).astype(np.float32)


def _jnp(tree):
    return jax.tree_util.tree_map(jnp.asarray, tree)


def _torch(tree):
    return jax.tree_util.tree_map(lambda a: torch.from_numpy(np.array(a)),
                                  tree)


def _close(got, want, rel=REL):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape and got.dtype == want.dtype
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=rel * np.abs(want).max())


def _flips(ref_codes, port_codes):
    """(codes flipped, codes compared) over two captures, which must have
    the same calls and shapes; holds the flips to MAX_FLIP_SHARE."""
    assert len(ref_codes) == len(port_codes)
    assert [a.shape for a in ref_codes] == [b.shape for b in port_codes]
    flipped = sum(int((a != b).sum()) for a, b in zip(ref_codes,
                                                      port_codes))
    n = sum(a.size for a in ref_codes)
    assert flipped <= MAX_FLIP_SHARE * max(n, 1), (flipped, n)
    return flipped, n


def test_init_ssm_has_the_reference_leaves():
    """Same leaf set, shapes and dtypes; the deterministic leaves equal."""
    want = tonp(RS.init_ssm(jax.random.PRNGKey(0), ref_cfg()))
    got = TS.init_ssm(torch.Generator().manual_seed(0), port_cfg(), "cpu")
    shapes = jax.tree_util.tree_map(lambda a: (tuple(a.shape),
                                               str(a.dtype)), want)
    assert jax.tree_util.tree_map(
        lambda t: (tuple(t.shape), str(t.dtype).replace("torch.", "")),
        got) == shapes
    for name in ("conv_b", "dt_bias", "d_skip"):
        np.testing.assert_array_equal(got[name].numpy(), want[name])
    # log(linspace(1, 16, H)): torch's and XLA's log differ by an ulp
    np.testing.assert_allclose(got["a_log"].numpy(), want["a_log"],
                               rtol=1e-6)
    assert TS._dims(port_cfg()) == RS._dims(ref_cfg()) == (128, 8, 16, 16)


def test_softplus_is_jax_softplus():
    """``logaddexp(x, 0)`` over [-60, 60], past F.softplus's threshold."""
    x = np.linspace(-60.0, 60.0, 4001).astype(np.float32)
    want = np.asarray(jax.nn.softplus(jnp.asarray(x)))
    got = TS._softplus(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-30)
    assert np.array_equal(got[x > 30], x[x > 30])


def test_split_proj_takes_the_reference_indices():
    cfg = port_cfg()
    width = 2 * 128 + 2 * 16 + 8
    zx = np.arange(2 * width, dtype=np.float32).reshape(1, 2, width)
    want = RS._split_proj(jnp.asarray(zx), ref_cfg())
    got = TS._split_proj(torch.from_numpy(zx), cfg)
    assert [g.shape[-1] for g in got] == [128, 128, 16, 16, 8]
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


@pytest.mark.parametrize("t", [1, 5])
@pytest.mark.parametrize("tail", [False, True])
def test_causal_conv_matches_reference(tail, t):
    p = ssm_params()
    c = p["conv_w"].shape[1]
    x = _x((2, t, c), 3 + t)
    tl = _x((2, 3, c), 4) if tail else None
    want, want_tail = RS._causal_conv(
        jnp.asarray(x), jnp.asarray(p["conv_w"]), jnp.asarray(p["conv_b"]),
        None if tl is None else jnp.asarray(tl))
    got, got_tail = TS._causal_conv(
        torch.from_numpy(x), torch.from_numpy(p["conv_w"]),
        torch.from_numpy(p["conv_b"]),
        None if tl is None else torch.from_numpy(tl))
    _close(got.numpy(), want)
    np.testing.assert_array_equal(got_tail.numpy(), np.asarray(want_tail))


def _ssd_inputs(t, seed):
    x = _x((2, t, 8, 16), seed)
    dt = _x((2, t, 8), seed + 1)
    b = _x((2, t, 16), seed + 2)
    c = _x((2, t, 16), seed + 3)
    return x, dt, ssm_params()["a_log"], b, c


@pytest.mark.parametrize("t", [16, 48, 64, 128])
def test_ssd_chunked_matches_reference(t):
    """chunk = min(64, T): one chunk of T below 64, two chunks at 128
    (the cross-chunk recurrence)."""
    args = _ssd_inputs(t, t)
    with jax.disable_jit():
        want_y, want_s = RS._ssd_chunked(*map(jnp.asarray, args))
    got_y, got_s = TS._ssd_chunked(*map(torch.from_numpy, args))
    _close(got_y.numpy(), want_y)
    _close(got_s.numpy(), want_s)


def test_ssd_chunked_refuses_a_ragged_length():
    """T = 96 is no multiple of the 64-token chunk: both sides assert."""
    args = _ssd_inputs(96, 1)
    with pytest.raises(AssertionError):
        RS._ssd_chunked(*map(jnp.asarray, args))
    with pytest.raises(AssertionError):
        TS._ssd_chunked(*map(torch.from_numpy, args))


@pytest.mark.parametrize("mode", ["none", "pann"])
def test_apply_ssm_matches_reference(mode, monkeypatch):
    qc = PANN if mode == "pann" else dict(mode="none")
    x = _x((2, 64, 64), 7)
    ref_codes, port_codes = [], []
    _capture(monkeypatch, RQ, ref_codes)
    _capture(monkeypatch, TQ, port_codes)
    with jax.disable_jit():
        want = RS.apply_ssm(jnp.asarray(x), _jnp(ssm_params()), ref_cfg(qc))
    got = TS.apply_ssm(torch.from_numpy(x), _torch(ssm_params()),
                       port_cfg(qc))
    flipped, n = _flips(ref_codes, port_codes)
    # in_proj's (2, 64, 64) rows and out_proj's (2, 64, 128)
    assert n == (0 if mode == "none" else 3 * x.size)
    print(f"apply_ssm {mode}: {flipped} of {n} codes flipped")
    _close(got.numpy(), want, REL if flipped == 0 else FLIP_REL)


def test_decode_ssm_step_by_step_matches_reference():
    """Ten tokens from a zero state, each side carrying its own state: the
    output, the (B, H, P, N) state, the pre-conv tail and the length at
    every step."""
    p = ssm_params()
    rst = RS.init_ssm_state(ref_cfg(), 2, jnp.float32)
    tst = TS.init_ssm_state(port_cfg(), 2, torch.float32, "cpu")
    for name in ("state", "conv"):
        np.testing.assert_array_equal(getattr(tst, name).numpy(),
                                      np.asarray(getattr(rst, name)))
    for step in range(10):
        x = _x((2, 1, 64), 20 + step)
        with jax.disable_jit():
            want, rst = RS.decode_ssm(jnp.asarray(x), rst, _jnp(p),
                                      ref_cfg())
        got, tst = TS.decode_ssm(torch.from_numpy(x), tst, _torch(p),
                                 port_cfg())
        _close(got.numpy(), want)
        _close(tst.state.numpy(), rst.state)
        _close(tst.conv.numpy(), rst.conv)
        assert int(tst.length) == int(rst.length) == step + 1
        assert tst.length.dtype == torch.int32


def test_decode_ssm_does_not_write_its_input_state():
    """The step returns new tensors; the state handed in is unchanged."""
    p = _torch(ssm_params())
    st = TS.init_ssm_state(port_cfg(), 2, torch.float32, "cpu")
    _, st = TS.decode_ssm(torch.from_numpy(_x((2, 1, 64), 1)), st, p,
                          port_cfg())
    before = [t.clone() for t in st]
    _, new = TS.decode_ssm(torch.from_numpy(_x((2, 1, 64), 2)), st, p,
                           port_cfg())
    assert all(torch.equal(a, b) for a, b in zip(before, st))
    assert all(a is not b for a, b in zip(new, st))


def test_decode_after_prefill_matches_apply_ssm():
    """Token by token through ``decode_ssm`` = the chunked prefill at every
    position (T = 64, one chunk), on the port and against the reference's
    prefill."""
    x = _x((2, 64, 64), 9)
    with jax.disable_jit():
        want = RS.apply_ssm(jnp.asarray(x), _jnp(ssm_params()), ref_cfg())
    p, cfg = _torch(ssm_params()), port_cfg()
    prefill = TS.apply_ssm(torch.from_numpy(x), p, cfg)
    st = TS.init_ssm_state(cfg, 2, torch.float32, "cpu")
    steps = []
    for t in range(x.shape[1]):
        y, st = TS.decode_ssm(torch.from_numpy(x[:, t:t + 1]), st, p, cfg)
        steps.append(y)
    decoded = torch.cat(steps, dim=1).numpy()
    _close(decoded, prefill.numpy())
    _close(decoded, want)


@functools.lru_cache(maxsize=None)
def model_params():
    """Reduced zamba2's reference params, perturbed (numpy)."""
    params = RMD.init_params(jax.random.PRNGKey(0), ref_cfg())
    return perturb(tonp(params), np.random.default_rng(11))


def test_model_decode_after_prefill_matches_reference_forward():
    """The whole reduced zamba2 (2 groups and a 2-layer tail, the shared
    block at both mamba_attn positions): the port's token-by-token
    ``decode_step`` against the reference's ``forward`` at every position,
    fp params at mode 'none', fp cache."""
    tokens = np.random.default_rng(5).integers(0, VOCAB, (2, 16)).astype(
        np.int32)
    want = np.asarray(RMD.forward(_jnp(model_params()), ref_cfg(),
                                  jnp.asarray(tokens), remat=False).logits)
    cfg = port_cfg()
    params = params_from_reference(model_params(), cfg, "cpu")
    st = TMD.init_decode_state(params, cfg, 2, tokens.shape[1])
    out = []
    for t in range(tokens.shape[1]):
        lg, st = TMD.decode_step(params, cfg, st,
                                 torch.from_numpy(tokens[:, t:t + 1]).long())
        out.append(lg)
    got = torch.cat(out, dim=1).numpy()
    err = float(np.abs(got - want).max() / np.abs(want).max())
    print(f"zamba2 decode vs reference forward: {err:.3g} of max|logit|")
    _close(got, want, LOGIT_REL)


def test_silu_matches_jax_silu():
    """The gate's and the conv's silu: the port's F.silu against
    jax.nn.silu within REL over [-32, 32]."""
    z = _x((4, 256), 13, scale=8.0)
    _close(F.silu(torch.from_numpy(z)).numpy(),
           np.asarray(jax.nn.silu(jnp.asarray(z))))
