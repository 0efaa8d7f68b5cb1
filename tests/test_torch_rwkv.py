"""RWKV-6 of the port (``repro_torch.models.rwkv``) against
``repro.models.rwkv`` on the CPU, at reduced rwkv6-1.6b (d = 64: one
64-wide head, d_ff = 128): the token shift, ``_time_mix_inner`` (the wkv
recurrence, two heads, from a nonzero state), ``apply_time_mix`` and
``apply_channel_mix`` from zeros and from a carried state at quant modes
'none' and 'pann', the state carry (a sequence in two pieces = one
piece), and the rwkv layer's decode step by step.

Inputs and parameters are seeded numpy arrays handed to both sides, the
leaves init makes constant (``mu``, ``bonus``, ``decay_base``, the norms)
perturbed; the reference runs op by op (``jax.disable_jit()``).

Tolerance: every fp output and state within 1e-5 * max|ref| (``REL``);
shifts exact (copies of inputs). At mode 'pann' the activation codes of
both sides are compared, flips counted and held to 1 in 10^4 (the output
bound then 2e-2), as in ``test_torch_ssm``.
"""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as rconfigs
from repro.configs.base import QuantConfig as RQuantConfig
from repro.core import quant as RQ
from repro.models import rwkv as RR
from repro.models import transformer as RT
from repro_torch import configs as tconfigs
from repro_torch.configs.base import QuantConfig as TQuantConfig
from repro_torch.core import quant as TQ
from repro_torch.models import rwkv as TR
from repro_torch.models import transformer as TT
from test_torch_common import tonp
from test_torch_forward import _capture
from test_torch_ssm import (FLIP_REL, PANN, REL, _close, _flips, _jnp, _torch,
                            _x, perturb)

ARCH = "rwkv6-1.6b"


def ref_cfg(qc=None):
    cfg = rconfigs.reduced(rconfigs.get_config(ARCH))
    return cfg if qc is None else dataclasses.replace(
        cfg, quant=RQuantConfig(**qc))


def port_cfg(qc=None):
    cfg = tconfigs.reduced(tconfigs.get_config(ARCH))
    return cfg if qc is None else dataclasses.replace(
        cfg, quant=TQuantConfig(**qc))


@functools.lru_cache(maxsize=None)
def layer_params(seed=0):
    """One reference rwkv layer ({norm1, tm, norm2, cm}), perturbed."""
    p = RT.init_layer(jax.random.PRNGKey(seed), ref_cfg(),
                      RT.LayerSpec("rwkv"))
    return perturb(tonp(p), np.random.default_rng(seed + 3))


def _qc(mode):
    return PANN if mode == "pann" else dict(mode="none")


def _ref_state(seed, b=2):
    """A nonzero reference RWKVState (and the same as the port's)."""
    h = 1
    st = RR.RWKVState(
        wkv=jnp.asarray(_x((b, h, 64, 64), seed, 0.3)),
        shift_tm=jnp.asarray(_x((b, 64), seed + 1)),
        shift_cm=jnp.asarray(_x((b, 64), seed + 2)),
        length=jnp.asarray(5, jnp.int32))
    return st, TR.RWKVState(*(torch.from_numpy(np.array(a)) for a in st))


def test_inits_have_the_reference_leaves():
    def shapes(tree):
        return jax.tree_util.tree_map(
            lambda a: (tuple(a.shape),
                       str(a.dtype).replace("torch.", "")), tree)
    gen = torch.Generator().manual_seed(0)
    for rinit, tinit in ((RR.init_rwkv_time_mix, TR.init_rwkv_time_mix),
                         (RR.init_rwkv_channel_mix,
                          TR.init_rwkv_channel_mix)):
        want = tonp(rinit(jax.random.PRNGKey(0), ref_cfg()))
        got = tinit(gen, port_cfg(), "cpu")
        assert shapes(got) == shapes(want)
        for name in ("mu", "decay_base", "bonus"):
            if name in want:
                np.testing.assert_array_equal(got[name].numpy(), want[name])
    assert TR.HEAD_DIM == RR.HEAD_DIM == 64
    assert TR._heads(port_cfg()) == RR._heads(ref_cfg()) == 1
    st = TR.init_rwkv_state(port_cfg(), 2, torch.float32, "cpu")
    assert shapes(st._asdict()) == shapes(tonp(RR.init_rwkv_state(
        ref_cfg(), 2, jnp.float32)._asdict()))


def test_token_shift_is_exact():
    x, prev = _x((2, 5, 64), 1), _x((2, 64), 2)
    want = RR._token_shift(jnp.asarray(x), jnp.asarray(prev))
    got = TR._token_shift(torch.from_numpy(x), torch.from_numpy(prev))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("t", [1, 9])
def test_time_mix_inner_matches_reference(t):
    """Two heads, a nonzero bonus u and state: the output reads s + u*kv
    before the update s <- w*s + kv."""
    r, k, v = (_x((2, t, 2, 64), s, 0.5) for s in (1, 2, 3))
    w = np.exp(-np.exp(_x((2, t, 2, 64), 4, 0.5) - 1.0)).astype(np.float32)
    u = _x((2, 64), 5, 0.3)
    s0 = _x((2, 2, 64, 64), 6, 0.3)
    args = (r, k, v, w, u, s0)
    with jax.disable_jit():
        want_out, want_s = RR._time_mix_inner(*map(jnp.asarray, args))
    got_out, got_s = TR._time_mix_inner(*map(torch.from_numpy, args))
    _close(got_out.numpy(), want_out)
    _close(got_s.numpy(), want_s)


def test_time_mix_inner_reads_the_state_before_the_update():
    """One step by hand: out = r @ (s + u*kv), s' = w*s + kv."""
    r, k, v = (_x((1, 1, 1, 64), s) for s in (7, 8, 9))
    w = np.full((1, 1, 1, 64), 0.5, np.float32)
    u = _x((1, 64), 10)
    s0 = _x((1, 1, 64, 64), 11)
    out, s1 = TR._time_mix_inner(*map(torch.from_numpy,
                                      (r, k, v, w, u, s0)))
    kv = k[0, 0, 0][:, None] * v[0, 0, 0][None, :]
    np.testing.assert_allclose(out[0, 0, 0].numpy(),
                               r[0, 0, 0] @ (s0[0, 0] + u[0][:, None] * kv),
                               rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(s1[0, 0].numpy(), 0.5 * s0[0, 0] + kv,
                               rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("carried", [False, True])
@pytest.mark.parametrize("mode", ["none", "pann"])
def test_apply_time_mix_matches_reference(mode, carried, monkeypatch):
    tm = layer_params()["tm"]
    x = _x((2, 12, 64), 21)
    rst, tst = _ref_state(30) if carried else (None, None)
    ref_codes, port_codes = [], []
    _capture(monkeypatch, RQ, ref_codes)
    _capture(monkeypatch, TQ, port_codes)
    with jax.disable_jit():
        want = RR.apply_time_mix(jnp.asarray(x), _jnp(tm), ref_cfg(_qc(mode)),
                                 state=rst)
    got = TR.apply_time_mix(torch.from_numpy(x), _torch(tm),
                            port_cfg(_qc(mode)), state=tst)
    flipped, n = _flips(ref_codes, port_codes)
    # wr, wk, wv, wg, decay_a, decay_b, wo: seven projections
    assert len(port_codes) == (0 if mode == "none" else 7)
    print(f"apply_time_mix {mode} carried={carried}: {flipped} of {n} "
          "codes flipped")
    rel = REL if flipped == 0 else FLIP_REL
    _close(got[0].numpy(), want[0], rel)
    _close(got[1].numpy(), want[1], rel)
    np.testing.assert_array_equal(got[2].numpy(), np.asarray(want[2]))


@pytest.mark.parametrize("carried", [False, True])
@pytest.mark.parametrize("mode", ["none", "pann"])
def test_apply_channel_mix_matches_reference(mode, carried, monkeypatch):
    cm = layer_params()["cm"]
    x = _x((2, 12, 64), 22)
    prev = _x((2, 64), 23) if carried else None
    ref_codes, port_codes = [], []
    _capture(monkeypatch, RQ, ref_codes)
    _capture(monkeypatch, TQ, port_codes)
    with jax.disable_jit():
        want = RR.apply_channel_mix(
            jnp.asarray(x), _jnp(cm), ref_cfg(_qc(mode)),
            prev=None if prev is None else jnp.asarray(prev))
    got = TR.apply_channel_mix(
        torch.from_numpy(x), _torch(cm), port_cfg(_qc(mode)),
        prev=None if prev is None else torch.from_numpy(prev))
    flipped, _ = _flips(ref_codes, port_codes)
    _close(got[0].numpy(), want[0], REL if flipped == 0 else FLIP_REL)
    np.testing.assert_array_equal(got[1].numpy(), np.asarray(want[1]))


def test_state_carry_splits_a_sequence():
    """Time mix over 12 tokens = 5 tokens, then 7 from the carried wkv
    state and last token; channel mix likewise from the carried token."""
    p, cfg = _torch(layer_params()), port_cfg()
    x = torch.from_numpy(_x((2, 12, 64), 24))
    whole, s_whole, _ = TR.apply_time_mix(x, p["tm"], cfg)
    y1, s1, last = TR.apply_time_mix(x[:, :5], p["tm"], cfg)
    st = TR.init_rwkv_state(cfg, 2, torch.float32, "cpu")._replace(
        wkv=s1, shift_tm=last)
    y2, s2, _ = TR.apply_time_mix(x[:, 5:], p["tm"], cfg, state=st)
    _close(torch.cat([y1, y2], 1).numpy(), whole.numpy())
    _close(s2.numpy(), s_whole.numpy())
    cw, _ = TR.apply_channel_mix(x, p["cm"], cfg)
    c1, lc = TR.apply_channel_mix(x[:, :5], p["cm"], cfg)
    c2, _ = TR.apply_channel_mix(x[:, 5:], p["cm"], cfg, prev=lc)
    _close(torch.cat([c1, c2], 1).numpy(), cw.numpy())


def test_rwkv_layer_decode_step_by_step_matches_reference():
    """``transformer.decode_layer`` on an rwkv layer, eight tokens from a
    zero state, each side carrying its own ``RWKVState``: the output and
    every state leaf at every step, and the layer's prefill
    (``apply_layer``) at every position."""
    spec_r, spec_t = RT.LayerSpec("rwkv"), TT.LayerSpec("rwkv")
    p = layer_params()
    rst = RR.init_rwkv_state(ref_cfg(), 2, jnp.float32)
    tst = TR.init_rwkv_state(port_cfg(), 2, torch.float32, "cpu")
    xs = _x((2, 8, 64), 25)
    outs = []
    for t in range(xs.shape[1]):
        x = xs[:, t:t + 1]
        with jax.disable_jit():
            want, rst = RT.decode_layer(jnp.asarray(x), rst, _jnp(p),
                                        ref_cfg(), spec_r)
        got, tst = TT.decode_layer(torch.from_numpy(x), tst, _torch(p),
                                   port_cfg(), spec_t)
        outs.append(got)
        _close(got.numpy(), want)
        _close(tst.wkv.numpy(), rst.wkv)
        for name in ("shift_tm", "shift_cm"):
            _close(getattr(tst, name).numpy(), getattr(rst, name))
            assert getattr(tst, name).dtype == torch.float32
        assert int(tst.length) == int(rst.length) == t + 1
    prefill, aux = TT.apply_layer(torch.from_numpy(xs), _torch(p),
                                  port_cfg(), spec_t)
    assert float(aux) == 0.0
    _close(torch.cat(outs, 1).numpy(), prefill.numpy())
