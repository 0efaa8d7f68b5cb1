"""The encoder-decoder and vision families of the port against the JAX
package on the CPU, on reduced seamless-m4t-medium (a two-conv speech stem
over (96, 1, 80) features, a 2-layer bidirectional encoder, 2 decoder
layers that each cross-attend) and reduced llama-3.2-vision-90b (a 4x4/s4
patchify stem over 16x16x3 pixels, 10 decoder layers in 2 groups whose
first layer cross-attends): the frontend stubs, ``encode``, ``forward``
with 3-D stub embeddings and raw 4-D input at quant modes 'none' and
'pann', and the cross path's gate on a weight store carried across from
the reference (its cross K/V and decode are held to the reference in
``test_torch_encoder_serve``).

Before anything is built the reference's parameters get seeded nonzero
values where init leaves zeros or ones: the conv and layernorm biases,
every norm scale, and every ``xgate`` (init makes it 0, and tanh(0) = 0
would make every cross-attention check pass without cross-attending).

The reference runs under ``jax.disable_jit()`` (op by op) where activation
codes are compared. Tolerances: the frontend stubs and the conv stem
through the serving kernels bit for bit; ``encode`` / ``forward`` at 'none'
within 1e-5 * max|out|; at 'pann' within the same bound when no
activation code flipped between the two sides; else the first quantizer
call with a flip must see inputs within that bound and flip only codes at
a rounding tie (4-bit activations through a relu MLP and an encoder
carry one tie flip on to hundreds of codes downstream); the port's three
backends bit-identical to each other.
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
from repro.data import pipeline as RP
from repro.models import model as RMD
from repro.models import serving as RSV
from repro_torch import configs as tconfigs
from repro_torch.configs.base import QuantConfig as TQuantConfig
from repro_torch.convert import (params_from_reference,
                                 weight_store_from_reference)
from repro_torch.core import quant as TQ
from repro_torch.data import pipeline as TP
from repro_torch.models import model as TMD
from test_torch_common import rung_specs, tonp
from test_torch_common import one_torch_thread  # noqa: F401

ARCHS = ("seamless-m4t-medium", "llama-3.2-vision-90b")
REL_BOUND = 1e-5
PANN = dict(mode="pann", r=2.83, act_bits_tilde=4)
BATCH = 2
STEPS = 5


def ref_cfg(arch, **kw):
    return dataclasses.replace(rconfigs.reduced(rconfigs.get_config(arch)),
                               **kw)


def port_cfg(arch, **kw):
    return dataclasses.replace(tconfigs.reduced(tconfigs.get_config(arch)),
                               **kw)


def frontend_key(cfg):
    return "enc_inputs" if cfg.family == "encdec" else "image_embeds"


def _perturb(node, rng, trail=()):
    """Seeded nonzero values for the leaves init makes 0 or 1: biases,
    norm scales and the cross-attention gates (numpy tree in and out)."""
    if isinstance(node, dict):
        return {k: _perturb(v, rng, trail + (k,)) for k, v in node.items()}
    if isinstance(node, (list, tuple)):
        return [_perturb(v, rng, trail) for v in node]
    a = np.asarray(node)
    name = trail[-1]
    if name in ("b", "bias"):
        return rng.normal(0.0, 0.3, a.shape).astype(a.dtype)
    if name == "scale":
        return (a + rng.normal(0.0, 0.2, a.shape)).astype(a.dtype)
    if name == "xgate":
        return rng.normal(0.8, 0.2, a.shape).astype(a.dtype)
    return a


@functools.lru_cache(maxsize=None)
def reference_params(arch, seed=0):
    """The reference's fp params with the zero/one leaves perturbed."""
    params = RMD.init_params(jax.random.PRNGKey(seed), ref_cfg(arch))
    return _perturb(tonp(params), np.random.default_rng(seed + 17))


def jparams(arch):
    return jax.tree_util.tree_map(jnp.asarray, reference_params(arch))


@functools.lru_cache(maxsize=None)
def reference_store(arch):
    """(reference WeightStore, port WeightStore): ladder 2,4,6, packed
    planes, 4-bit KV cache, carried across onto the CPU."""
    cfg = ref_cfg(arch)
    ws = RSV.build_weight_store(
        jparams(arch), cfg, rung_specs(cfg),
        spec=RSV.ServingQuantSpec(pack_planes=True, cache_bits=4))
    pws = weight_store_from_reference(
        tonp(ws.store), {k: tonp(v) for k, v in ws.views.items()},
        port_cfg(arch), "cpu")
    return ws, pws


def raw_input(arch, step=0, batch=BATCH):
    return TP.frontend_raw_stub(port_cfg(arch), batch, step)


def stub_input(arch, step=0, batch=BATCH):
    return TP.frontend_stub(port_cfg(arch), batch, step)


def tokens(seed, t=STEPS, batch=BATCH):
    return np.random.default_rng(seed).integers(0, 512, (batch, t)).astype(
        np.int32)


def _capture(monkeypatch, module, log):
    """Record (input, codes, scale) of every affine quantizer call."""
    orig = module.affine_quant_levels

    def wrapped(x, n, include_zero=False):
        out = orig(x, n, include_zero=include_zero)
        log.append((np.asarray(x), np.asarray(out[0]), np.asarray(out[1])))
        return out

    monkeypatch.setattr(module, "affine_quant_levels", wrapped)


def _held(got, want, ref_log, port_log, what):
    """Hold ``got`` to ``want`` within REL_BOUND when no activation code
    flipped between the two sides. A flipped code moves its projection's
    output by a whole activation step, and the flips after it are its
    consequences, not faults: then the first quantizer call with a flip
    must see inputs within REL_BOUND of each other and every code it
    flipped must sit at a rounding tie of the reference's x / s (within
    1e-4 of k + 1/2); the outputs stay finite and of the same shape."""
    assert got.shape == want.shape and np.isfinite(got).all()
    assert len(ref_log) == len(port_log)
    flips = [int((a[1] != b[1]).sum()) for a, b in zip(ref_log, port_log)]
    err = float(np.abs(got - want).max() / np.abs(want).max())
    print(f"{what}: max|err| / max|out| = {err:.3g}, {sum(flips)} of "
          f"{sum(a[1].size for a in ref_log)} activation codes flipped")
    if not any(flips):
        np.testing.assert_allclose(got, want, rtol=0,
                                   atol=REL_BOUND * np.abs(want).max())
        return
    first = next(i for i, f in enumerate(flips) if f)
    (rx, rq, rs), (tx, tq, _) = ref_log[first], port_log[first]
    np.testing.assert_allclose(tx, rx, rtol=0,
                               atol=REL_BOUND * np.abs(rx).max())
    t = (rx / rs)[rq != tq]
    tie = np.abs(t - np.floor(t) - 0.5)
    print(f"{what}: first flip at quantizer call {first}, {flips[first]} "
          f"codes, largest distance from a tie {tie.max():.3g}")
    assert tie.max() <= 1e-4


def test_frontend_stubs_match_reference():
    for arch in ARCHS:
        for step in (0, 3):
            rc, tc = ref_cfg(arch), port_cfg(arch)
            for mine, theirs in ((TP.frontend_raw_stub(tc, 3, step, 5),
                                  RP.frontend_raw_stub(rc, 3, step, 5)),
                                 (TP.frontend_stub(tc, 3, step, 5),
                                  RP.frontend_stub(rc, 3, step, 5))):
                assert mine.dtype == theirs.dtype == np.float32
                assert mine.tobytes() == theirs.tobytes()
    lm = tconfigs.reduced(tconfigs.get_config("llama3-8b"))
    assert TP.frontend_stub(lm, 2, 0) is None
    assert TP.frontend_raw_stub(lm, 2, 0) is None


@pytest.mark.parametrize("mode", ["none", "pann"])
@pytest.mark.parametrize("arch", ARCHS)
def test_encode_matches_reference(arch, mode, monkeypatch):
    """The stem (and seamless's encoder and enc_norm) over raw input, fp
    params through the fake-quant projections."""
    qc = dict(PANN) if mode == "pann" else dict(mode="none")
    ref_codes, port_codes = [], []
    _capture(monkeypatch, RQ, ref_codes)
    _capture(monkeypatch, TQ, port_codes)
    raw = raw_input(arch)
    with jax.disable_jit():
        want = np.asarray(RMD.encode(
            jparams(arch), ref_cfg(arch, quant=RQuantConfig(**qc)),
            jnp.asarray(raw)))
    cfg = port_cfg(arch, quant=TQuantConfig(**qc))
    got = TMD.encode(params_from_reference(reference_params(arch), cfg,
                                           "cpu"), cfg,
                     torch.from_numpy(raw)).numpy()
    _held(got, want, ref_codes, port_codes, f"{arch} encode {mode}")


@pytest.mark.parametrize("frontend", ["stub", "raw"])
@pytest.mark.parametrize("mode", ["none", "pann"])
@pytest.mark.parametrize("arch", ARCHS)
def test_forward_matches_reference(arch, mode, frontend, monkeypatch):
    """``forward`` with 3-D stub embeddings or raw 4-D input (through the
    stem), causal over the tokens, cross-attending to the source."""
    qc = dict(PANN) if mode == "pann" else dict(mode="none")
    fe = raw_input(arch) if frontend == "raw" else stub_input(arch)
    toks = tokens(len(arch) + len(mode), t=6)
    ref_codes, port_codes = [], []
    _capture(monkeypatch, RQ, ref_codes)
    _capture(monkeypatch, TQ, port_codes)
    rc = ref_cfg(arch, quant=RQuantConfig(**qc))
    with jax.disable_jit():
        want = np.asarray(RMD.forward(
            jparams(arch), rc, jnp.asarray(toks), remat=False,
            **{frontend_key(rc): jnp.asarray(fe)}).logits)
    cfg = port_cfg(arch, quant=TQuantConfig(**qc))
    out = TMD.forward(params_from_reference(reference_params(arch), cfg,
                                            "cpu"), cfg,
                      torch.from_numpy(toks).long(),
                      **{frontend_key(cfg): torch.from_numpy(fe)})
    assert float(out.aux_loss) == 0.0
    _held(out.logits.numpy(), want, ref_codes, port_codes,
          f"{arch} forward {mode} {frontend}")


@pytest.mark.parametrize("arch", ARCHS)
def test_cross_attention_changes_the_logits(arch):
    """The cross path is live: with the seeded gates, changing only the
    frontend input changes the logits (decode and forward, raw input);
    with every gate at 0 it changes nothing."""
    _, pws = reference_store(arch)
    cfg = port_cfg(arch, kernel_backend="ref", cache_bits=4)
    view = pws.views[6]
    toks = torch.from_numpy(tokens(9, t=3)).long()
    key = frontend_key(cfg)
    outs = []
    for step in (0, 1):
        fe = torch.from_numpy(raw_input(arch, step=step))
        st = TMD.init_decode_state(view, cfg, BATCH, 3, **{key: fe})
        lg, _ = TMD.decode_step(view, cfg, st, toks[:, :1])
        outs.append((lg, TMD.forward(view, cfg, toks, **{key: fe}).logits))
    assert not torch.equal(outs[0][0], outs[1][0])
    assert not torch.equal(outs[0][1], outs[1][1])
    closed = {k: v for k, v in view.items() if k != "layers"}
    closed["layers"] = [dict(lp, xgate=torch.zeros(())) if "xgate" in lp
                        else lp for lp in view["layers"]]
    same = [TMD.forward(closed, cfg, toks, **{key: torch.from_numpy(
        raw_input(arch, step=s))}).logits for s in (0, 1)]
    assert torch.equal(same[0], same[1])


@pytest.mark.parametrize("arch", ARCHS)
def test_raw_input_is_the_stemmed_embeddings(arch):
    """Raw 4-D input through ``forward`` equals the same input stemmed
    first and handed in as 3-D embeddings, bit for bit, on a rung view
    through each backend; the stem's output is (B, tokens, c_out)."""
    _, pws = reference_store(arch)
    view = pws.views[4]
    raw = torch.from_numpy(raw_input(arch))
    toks = torch.from_numpy(tokens(4, t=3)).long()
    outs = []
    for backend in ("ref", "fused", "packed"):
        cfg = port_cfg(arch, kernel_backend=backend)
        emb = TMD.apply_conv_stem(view, cfg, raw)
        assert emb.shape == (BATCH, cfg.stem_tokens,
                             cfg.conv_stem[-1].c_out)
        key = frontend_key(cfg)
        four = TMD.forward(view, cfg, toks, **{key: raw}).logits
        three = TMD.forward(view, cfg, toks, **{key: emb}).logits
        assert torch.equal(four, three)
        outs.append(four)
    assert all(torch.equal(o, outs[0]) for o in outs)


def test_refusals_of_the_frontend():
    """A cross-attending config without its frontend, ``encode`` of 3-D
    input on a config with a stem, and an unknown layer kind raise."""
    from repro_torch.models import transformer as TT
    for arch in ARCHS:
        cfg = port_cfg(arch)
        params = params_from_reference(reference_params(arch), cfg, "cpu")
        toks = torch.zeros((1, 2), dtype=torch.long)
        with pytest.raises(ValueError, match=frontend_key(cfg)):
            TMD.forward(params, cfg, toks)
        with pytest.raises(ValueError, match=frontend_key(cfg)):
            TMD.init_decode_state(params, cfg, 1, 4)
        with pytest.raises(ValueError, match="raw"):
            TMD.encode(params, cfg, torch.zeros((1, 4, cfg.d_model)))
    with pytest.raises(ValueError, match="unknown layer kind"):
        TT.init_layer(torch.Generator(), port_cfg(ARCHS[0]),
                      TT.LayerSpec("conv"), "cpu")
