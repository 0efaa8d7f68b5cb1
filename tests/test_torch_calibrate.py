"""Activation-range calibration of the port against the JAX package on the
CPU: the tap in ``forward`` (observed ranges, quantizing against frozen
ones, inert while unseen, the same under ``remat``), ``calib_suspend`` in
the MoE expert loop, and the calibrated serving leaves (``act_lo``,
``act_hi``, ``act_s``, ``act_z`` and the cache roles' ``k_s``/``k_z``/
``v_s``/``v_z``) of both store functions, with the logits of a calibrated
store on every backend.

Reduced llama3-8b (2 layers, d 64) and reduced mixtral-8x7b; the
reference runs op by op (``jax.disable_jit()``) where its forward is
compared, so its scalar divisions stay divisions. Tolerances per test.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as rconfigs
from repro.configs.base import QuantConfig as RQuantConfig
from repro.core import calibrate as RCAL
from repro.models import model as RMD
from repro.models import serving as RSV
from repro_torch import configs as tconfigs
from repro_torch.configs.base import ParallelConfig, QuantConfig, TrainConfig
from repro_torch.convert import params_from_reference
from repro_torch.core import calibrate as TCAL
from repro_torch.launch import steps as TST
from repro_torch.models import layers as TL
from repro_torch.models import model as TMD
from repro_torch.models import serving as TSV
from test_torch_common import (CALIB, LADDER, reference_store, rung_specs,
                               tonp)
from test_torch_common import one_torch_thread  # noqa: F401
from test_torch_slice import REL_BOUND

ARCH = "llama3-8b"
QC = dict(mode="pann", r=2.0, act_bits_tilde=6, act_bits=6)


def rcfg(arch=ARCH, **quant):
    q = RQuantConfig(**quant) if quant else None
    return rconfigs.reduced(rconfigs.get_config(arch, quant=q))


def tcfg(arch=ARCH, **quant):
    q = QuantConfig(**quant) if quant else None
    return tconfigs.reduced(tconfigs.get_config(arch, quant=q))


@pytest.fixture(scope="module")
def ref_params():
    return RMD.init_params(jax.random.PRNGKey(0), rcfg())


def port_params(ref_params, arch=ARCH):
    """A fresh port copy (the serving quantizers consume what they get)."""
    return params_from_reference(tonp(ref_params), tcfg(arch), "cpu")


def _collection(cfg, seed, frac=0.6):
    """A calibration collection over ``cfg``'s roles, about ``frac`` of
    them seen (ranges from a numpy seed), the rest unseen."""
    rng = np.random.default_rng(seed)
    out = {}
    for p in RCAL.calib_paths(cfg):
        if rng.random() < frac:
            lo = -rng.random() * 3
            out[p] = np.asarray([lo, lo + 0.5 + rng.random() * 4],
                                np.float32)
        else:
            out[p] = np.asarray(RCAL.UNSEEN, np.float32)
    return out


def _tokens(b=2, t=16, seed=1):
    return np.random.default_rng(seed).integers(0, 512, (b, t)).astype(
        np.int32)


# ---------------------------------------------------------------------------
# the tap in forward
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("quant", ["pann", "ruq", "none"])
def test_forward_calib_matches_reference(ref_params, quant):
    """forward(calib=...): logits within 1e-5 * max|logit| of the
    reference's, every observed range within 1e-5 * its max |bound| (the
    activations agree to fp32 rounding), the same roles seen. At 'none'
    only the cache roles observe (the projections quantize nothing)."""
    qc = dict(QC, mode=quant) if quant != "none" else {}
    rc, tc = rcfg(**qc), tcfg(**qc)
    calib = _collection(rc, seed=3)
    tokens = _tokens()
    with jax.disable_jit():
        want = RMD.forward(ref_params, rc, jnp.asarray(tokens), remat=False,
                           calib={k: jnp.asarray(v) for k, v in
                                  calib.items()})
    got = TMD.forward(port_params(ref_params), tc,
                      torch.from_numpy(tokens).long(), remat=False,
                      calib={k: torch.from_numpy(v) for k, v in
                             calib.items()})
    wl = np.asarray(want.logits)
    np.testing.assert_allclose(got.logits.numpy(), wl, rtol=0,
                               atol=REL_BOUND * np.abs(wl).max())
    assert got.calib.keys() == want.calib.keys()
    seen = set()
    for k, v in want.calib.items():
        w = np.asarray(v)
        g = got.calib[k].numpy()
        assert (w[0] <= w[1]) == (g[0] <= g[1]), k
        if w[0] <= w[1]:
            seen.add(k)
            np.testing.assert_allclose(g, w, rtol=0,
                                       atol=1e-5 * np.abs(w).max())
    if quant == "none":
        assert seen == {"attn.k_cache", "attn.v_cache"}
    else:
        assert seen == set(RCAL.calib_paths(rc)) - {"moe.router"}


def test_unseen_collection_is_inert(ref_params):
    """An all-unseen collection quantizes exactly as no collection does
    (bit-identical logits) and reports every role it ran."""
    tc = tcfg(**QC)
    params = port_params(ref_params)
    tokens = torch.from_numpy(_tokens()).long()
    plain = TMD.forward(params, tc, tokens, remat=False)
    assert plain.calib is None
    tapped = TMD.forward(params, tc, tokens, remat=False,
                         calib=TCAL.init_calib(tc, "cpu"))
    assert torch.equal(plain.logits, tapped.logits)
    assert TCAL.n_seen(tapped.calib) == len(TCAL.calib_paths(tc))
    assert TL._TAPS == []


def test_remat_keeps_calib_and_grads(ref_params, monkeypatch):
    """lm_loss with remat=True (each layer group under
    torch.utils.checkpoint, rerun in backward with its tap) and
    remat=False: the same loss, observed ranges and gradients, bit for
    bit; the tap stack is empty after backward."""
    tc = tcfg(**QC)
    calib = {k: torch.from_numpy(v) for k, v in
             _collection(rcfg(**QC), seed=5).items()}
    tokens = torch.from_numpy(_tokens(seed=2)).long()
    labels = torch.roll(tokens, -1, 1)
    labels[:, -1] = -1
    calls = []
    real = TMD._ckpt.checkpoint
    monkeypatch.setattr(TMD._ckpt, "checkpoint",
                        lambda *a, **k: calls.append(1) or real(*a, **k))
    out = {}
    for remat in (False, True):
        params = port_params(ref_params)
        leaves = [params["layers"][0]["attn"]["wq"]["w"],
                  params["layers"][1]["mlp"]["w_down"]["w"],
                  params["lm_head"]["w"]]
        for p in leaves:
            p.requires_grad_(True)
        loss, obs = TMD.lm_loss(params, tc, tokens, labels, remat=remat,
                                calib=calib, return_calib=True)
        grads = torch.autograd.grad(loss, leaves)
        out[remat] = (loss.detach(), obs, grads)
        assert TL._TAPS == []
    assert len(calls) == 2          # one checkpoint a layer group
    (l0, o0, g0), (l1, o1, g1) = out[False], out[True]
    assert torch.equal(l0, l1)
    assert o0.keys() == o1.keys()
    assert all(torch.equal(o0[k], o1[k]) for k in o0)
    assert all(torch.equal(a, b) for a, b in zip(g0, g1))


def test_moe_calibration_suspends_expert_loop():
    """Reduced mixtral, one QAT train step with a collection: the router
    and attention roles are seen, the expert roles stay unseen (their
    projections run under calib_suspend), as in the reference; the
    observed router range within 1e-5 * its max |bound| of the
    reference's (jitted) forward."""
    arch = "mixtral-8x7b"
    rc, tc = rcfg(arch, **QC), tcfg(arch, **QC)
    rparams = RMD.init_params(jax.random.PRNGKey(1), rc)
    tokens = _tokens(t=8, seed=4)
    want = jax.jit(lambda p, t, c: RMD.forward(
        p, rc, t, remat=False, calib=c).calib)(
        rparams, jnp.asarray(tokens), RCAL.init_calib(rc))
    tcfg_train = TrainConfig(total_steps=4)
    state = TST.make_train_state(tc, tcfg_train, calibrate=True,
                                 device="cpu")
    state = state._replace(params=port_params(rparams, arch))
    batch = {"tokens": torch.from_numpy(tokens).long(),
             "labels": torch.zeros((2, 8), dtype=torch.long)}
    state, metrics = TST.train_step(state, batch, cfg=tc, tcfg=tcfg_train,
                                    par=ParallelConfig(remat="none"))
    assert np.isfinite(float(metrics["loss"]))
    seen = {k for k, v in state.calib.items() if bool(TCAL.seen(v))}
    ref_seen = {k for k, v in want.items()
                if float(v[0]) <= float(v[1])}
    assert seen == ref_seen
    assert "moe.router" in seen and "attn.wq" in seen
    assert not seen & {"moe.w_gate", "moe.w_up", "moe.w_down"}
    w = np.asarray(want["moe.router"])
    np.testing.assert_allclose(state.calib["moe.router"].numpy(), w,
                               rtol=0, atol=1e-5 * np.abs(w).max())


# ---------------------------------------------------------------------------
# calibrated serving leaves
# ---------------------------------------------------------------------------

FROZEN = ("act_lo", "act_hi", "act_s", "act_z", "act_n", "act_nlvl")
CACHE = ("k_s", "k_z", "v_s", "v_z", "k_nlvl", "v_nlvl")


def _ref_node(tree, layer, *path):
    node = tree["decoder"]["groups"]["layers"][0]
    for k in path:
        node = node[k]
    return jax.tree_util.tree_map(lambda a: np.asarray(a)[layer], node)


PROJ = (("attn", "wq"), ("attn", "wo"), ("mlp", "w_down"), ("mlp", "w_up"))


@pytest.mark.parametrize("policy", [False, True])
def test_single_point_freezes_calibrated_ranges(ref_params, policy):
    """quantize_params_for_serving(calib=...): the frozen leaves of every
    projection and cache role equal the reference's bit for bit, leaf
    sets included (unseen roles get none); refused without an activation
    bit width, as the reference refuses it."""
    rc, tc = rcfg(**QC), tcfg(**QC)
    if policy:
        from repro.core import anneal as RAN
        from repro_torch.core import anneal as TAN
        rtree = RAN.BudgetAnnealer(RAN.BudgetSchedule.parse("0:6"),
                                   rc).tree_for(6)
        ttree = TAN.BudgetAnnealer(TAN.BudgetSchedule.parse("0:6"),
                                   tc).tree_for(6)
        rkw, tkw = dict(policy=rtree), dict(policy=ttree)
    else:
        rkw = tkw = dict(r=2.0, act_bits=6)
    want = RSV.quantize_params_for_serving(
        ref_params, rc, spec=RSV.ServingQuantSpec(calib=CALIB, cache_bits=4,
                                                  **rkw))
    got = TSV.quantize_params_for_serving(
        port_params(ref_params), tc,
        TSV.ServingQuantSpec(calib=CALIB, cache_bits=4, **tkw))
    for layer in range(2):
        for parent, name in PROJ:
            w = _ref_node(want, layer, parent, name)
            g = got["layers"][layer][parent][name]
            keys = {k for k in w if k in FROZEN}
            assert keys == {k for k in g if k in FROZEN}, (parent, name)
            for k in keys:
                assert g[k].numpy().tobytes() == w[k].tobytes(), k
        wc = _ref_node(want, layer, "attn", "kv_cache")
        gc = got["layers"][layer]["attn"]["kv_cache"]
        assert set(wc) == set(gc) == set(CACHE)
        for k in CACHE:
            assert gc[k].numpy().tobytes() == wc[k].tobytes(), k
    assert "act_s" in got["layers"][0]["attn"]["wq"]
    assert "act_s" not in got["layers"][0]["attn"]["wo"]
    with pytest.raises(ValueError, match="bit width"):
        TSV.quantize_params_for_serving(
            port_params(ref_params), tc,
            TSV.ServingQuantSpec(r=2.0, calib=CALIB))


@pytest.fixture(scope="module")
def calibrated_stores(ref_params):
    """(the reference's calibrated WeightStore, the port's, built from the
    same params and collection)."""
    _, _, rws, _ = reference_store(calib=True)
    tws = TSV.build_weight_store(
        port_params(ref_params), tcfg(), rung_specs(rcfg()),
        spec=TSV.ServingQuantSpec(pack_planes=True, cache_bits=4,
                                  calib=CALIB))
    return rws, tws


def test_weight_store_freezes_calibrated_ranges(calibrated_stores):
    """build_weight_store(calib=...): every view's frozen leaves equal
    the reference's bit for bit, leaf sets included."""
    rws, tws = calibrated_stores
    for bits in LADDER:
        rv, tv = rws.views[bits], tws.views[bits]
        for layer in range(2):
            for parent, name in PROJ:
                w = _ref_node(rv, layer, parent, name)
                g = tv["layers"][layer][parent][name]
                keys = {k for k in w if k in FROZEN}
                assert keys == {k for k in g if k in FROZEN}
                for k in keys:
                    assert g[k].numpy().tobytes() == w[k].tobytes(), k
            wc = _ref_node(rv, layer, "attn", "kv_cache")
            gc = tv["layers"][layer]["attn"]["kv_cache"]
            assert set(wc) == set(gc)
            for k in wc:
                assert gc[k].numpy().tobytes() == wc[k].tobytes(), k
        assert "act_s" in tv["lm_head"] or "lm_head" not in CALIB


def test_calibrated_store_logits(calibrated_stores):
    """The port's calibrated store, teacher-forced through decode_step on
    'ref', 'fused' and 'packed' (plain versions on the CPU): logits equal
    across the backends, and within 1e-5 * max|logit| of the reference's
    calibrated decode over its own store."""
    rws, tws = calibrated_stores
    rows = _tokens(t=4, seed=9)
    rc = dataclasses.replace(rcfg(), kernel_backend="ref", cache_bits=4)
    step = jax.jit(lambda p, s, t: RMD.decode_step(p, rc, s, t))
    for bits in LADDER:
        st = RMD.init_decode_state(rws.views[bits], rc, 2, rows.shape[1])
        want = []
        for t in range(rows.shape[1]):
            lg, st = step(rws.views[bits], st, jnp.asarray(rows[:, t:t + 1]))
            want.append(np.asarray(lg)[:, 0])
        want = np.stack(want)
        outs = {}
        for backend in ("ref", "fused", "packed"):
            tc = dataclasses.replace(tcfg(), kernel_backend=backend,
                                     cache_bits=4)
            st = TMD.init_decode_state(tws.views[bits], tc, 2, rows.shape[1])
            got = []
            for t in range(rows.shape[1]):
                lg, st = TMD.decode_step(
                    tws.views[bits], tc, st,
                    torch.from_numpy(rows[:, t:t + 1]).long())
                got.append(lg[:, 0])
            outs[backend] = torch.stack(got)
        assert torch.equal(outs["ref"], outs["fused"])
        assert torch.equal(outs["ref"], outs["packed"])
        bound = REL_BOUND * np.max(np.abs(want), axis=-1, keepdims=True)
        assert np.all(np.abs(outs["packed"].numpy() - want) <= bound)
