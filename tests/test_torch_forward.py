"""Prefill attention and ``forward`` of the port against the JAX package on
the CPU: ``_chunked_attention`` (causal, window, softcap, ``q_offset``,
several q and kv chunks, the one-chunk fallback), ``forward`` of the four
reduced dense decoders at quant modes 'none' and 'pann' on fp params
carried across from the reference, the port's teacher-forced
``decode_step`` against its own ``forward``, the refusal of what is not
ported (naming their ROADMAP queue items), and the layer kinds
and cross-attention inputs that used to be refused (ROADMAP A6; their
parity lives in ``test_torch_encoder``; MoE, see ``test_torch_moe``, and
the SSM and hybrid families, see ``test_torch_recurrent_serve``).

The reference's ``forward`` runs under ``jax.disable_jit()``: op by op,
so a division by a Python scalar stays a division (under jit XLA may turn
it into a multiply by the reciprocal, which the port never does).

Tolerances: ``_chunked_attention`` within 1e-6 * max|out|; ``forward`` at
'none' within 1e-5 * max|logit|; at 'pann' within the same bound when no
activation code flipped between the two sides, else within 2e-2 *
max|logit| (one flipped code of b~x = 4 levels moves its projection's
output by up to one activation step), the count of flipped codes printed
and held to at most 1 in 10^4; decode against forward rtol = atol = 2e-2
as ``tests/test_models_smoke.py`` holds the reference's.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.base import QuantConfig as RQuantConfig
from repro.core import quant as RQ
from repro.models import attention as RA
from repro.models import model as RMD
from repro_torch.configs.base import QuantConfig as TQuantConfig
from repro_torch.convert import params_from_reference
from repro_torch.core import quant as TQ
from repro_torch.models import attention as TA
from repro_torch.models import model as TMD
from repro_torch.models import transformer as TT
from test_torch_dense_variants import port_cfg, ref_cfg, reference_params

ARCHS = ("llama3-8b", "qwen1.5-4b", "gemma2-9b", "stablelm-12b")
T_LEN = 12
NONE_BOUND = 1e-5
FLIP_BOUND = 2e-2
MAX_FLIP_SHARE = 1e-4
PANN = dict(mode="pann", r=2.83, act_bits_tilde=4)

# (B, T, S, K, G, hd, causal, window, softcap, q_offset, q_chunk, kv_chunk)
ATT_CASES = {
    "causal": (2, 16, 16, 2, 2, 8, True, None, 0.0, 0, 4, 8),
    "window": (2, 16, 16, 2, 2, 8, True, 5, 0.0, 0, 4, 4),
    "softcap": (2, 16, 16, 2, 1, 16, True, None, 20.0, 0, 8, 4),
    "bidirectional": (1, 8, 16, 1, 4, 8, False, None, 0.0, 0, 4, 8),
    "q_offset": (2, 8, 16, 2, 2, 8, True, 6, 0.0, 8, 4, 4),
    "one_chunk": (2, 12, 12, 2, 2, 8, True, None, 0.0, 0, 8, 8),
}


@pytest.mark.parametrize("case", sorted(ATT_CASES))
def test_chunked_attention_matches_reference(case):
    b, t, s, kh, g, hd, causal, window, cap, off, qc, kc = ATT_CASES[case]
    rng = np.random.default_rng(len(case))
    q = rng.standard_normal((b, t, kh, g, hd)).astype(np.float32)
    k = rng.standard_normal((b, s, kh, hd)).astype(np.float32)
    v = rng.standard_normal((b, s, kh, hd)).astype(np.float32)
    kw = dict(causal=causal, window=window, softcap_val=cap, q_offset=off,
              q_chunk=qc, kv_chunk=kc)
    want = np.asarray(RA._chunked_attention(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), **kw))
    got = TA._chunked_attention(torch.from_numpy(q), torch.from_numpy(k),
                                torch.from_numpy(v), **kw).numpy()
    assert got.shape == want.shape == (b, t, kh, g, hd)
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=1e-6 * np.abs(want).max())


def _tokens(cfg, seed=0, b=2, t=T_LEN):
    rng = np.random.default_rng(seed)
    return rng.integers(0, cfg.vocab_size, (b, t)).astype(np.int32)


def _capture(monkeypatch, module, log):
    """Record the activation codes of every affine quantizer call."""
    orig = module.affine_quant_levels

    def wrapped(x, n, include_zero=False):
        out = orig(x, n, include_zero=include_zero)
        log.append(np.asarray(out[0]))
        return out

    monkeypatch.setattr(module, "affine_quant_levels", wrapped)


def reference_forward(arch, qc, tokens):
    cfg = dataclasses.replace(ref_cfg(arch), quant=RQuantConfig(**qc))
    params = jax.tree_util.tree_map(jnp.asarray, reference_params(arch))
    with jax.disable_jit():
        out = RMD.forward(params, cfg, jnp.asarray(tokens), remat=False)
    return np.asarray(out.logits)


def port_forward(arch, qc, tokens):
    cfg = dataclasses.replace(port_cfg(arch), quant=TQuantConfig(**qc))
    params = params_from_reference(reference_params(arch), cfg, "cpu")
    out = TMD.forward(params, cfg, torch.from_numpy(tokens).long())
    assert float(out.aux_loss) == 0.0 and out.calib is None
    return out.logits.numpy()


@pytest.mark.parametrize("mode", ["none", "pann"])
@pytest.mark.parametrize("arch", ARCHS)
def test_forward_matches_reference(arch, mode, monkeypatch):
    qc = dict(PANN) if mode == "pann" else dict(mode="none")
    tokens = _tokens(ref_cfg(arch), seed=len(arch))
    ref_codes, port_codes = [], []
    _capture(monkeypatch, RQ, ref_codes)
    _capture(monkeypatch, TQ, port_codes)
    want = reference_forward(arch, qc, tokens)
    got = port_forward(arch, qc, tokens)
    assert got.shape == want.shape
    assert np.isfinite(got).all()
    assert len(ref_codes) == len(port_codes)
    flipped = sum(int((a != b).sum()) for a, b in zip(ref_codes, port_codes))
    n_codes = sum(a.size for a in ref_codes)
    err = float(np.abs(got - want).max() / np.abs(want).max())
    print(f"{arch} {mode}: max|err| / max|logit| = {err:.3g}, "
          f"{flipped} of {n_codes} activation codes flipped")
    assert flipped <= MAX_FLIP_SHARE * n_codes
    bound = NONE_BOUND if flipped == 0 else FLIP_BOUND
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=bound * np.abs(want).max())


@pytest.mark.parametrize("arch", ARCHS)
def test_decode_matches_forward(arch):
    """Teacher-forced ``decode_step`` reproduces the port's ``forward``
    logits (fp params, fp cache)."""
    cfg = port_cfg(arch)
    params = params_from_reference(reference_params(arch), cfg, "cpu")
    tokens = torch.from_numpy(_tokens(cfg, seed=3, b=1, t=8)).long()
    fwd = TMD.forward(params, cfg, tokens).logits
    state = TMD.init_decode_state(params, cfg, 1, 8)
    outs = []
    for t in range(8):
        lg, state = TMD.decode_step(params, cfg, state, tokens[:, t:t + 1])
        outs.append(lg[:, 0])
    dec = torch.stack(outs, dim=1)
    np.testing.assert_allclose(dec.numpy(), fwd.numpy(), rtol=2e-2,
                               atol=2e-2)


@pytest.mark.parametrize("family,item", [("vlm", "A6"), ("encdec", "A6")])
def test_forward_refuses_unported_layer_kinds(family, item):
    """The cross-attending layer kinds that ROADMAP ``item`` ported run:
    ``forward`` of the family's reduced config with its frontend gives
    finite logits, a cross_attn layer runs in ``apply_layer`` (a new
    source changes its output), and what is still refused is only a
    missing frontend, without a queue item to wait for."""
    arch = {"vlm": "llama-3.2-vision-90b",
            "encdec": "seamless-m4t-medium"}[family]
    cfg = port_cfg(arch)
    assert cfg.family == family
    params = TMD.init_params(cfg, seed=1, device="cpu")
    key = "enc_inputs" if family == "encdec" else "image_embeds"
    raw = torch.randn((1,) + cfg.frontend_hw + (cfg.conv_stem[0].c_in,))
    tokens = torch.zeros((1, 4), dtype=torch.long)
    logits = TMD.forward(params, cfg, tokens, **{key: raw}).logits
    assert logits.shape == (1, 4, cfg.padded_vocab)
    assert torch.isfinite(logits).all()
    with pytest.raises(ValueError, match=key) as err:
        TMD.forward(params, cfg, tokens)
    assert f"ROADMAP {item}" not in str(err.value)
    spec = TT.group_pattern(cfg)[0]
    assert spec.kind == "cross_attn"
    layer = dict(params["layers"][0], xgate=torch.ones(()))
    x = torch.randn((1, 4, cfg.d_model))
    outs = [TT.apply_layer(x, layer, cfg, spec,
                           cross_src=torch.randn((1, 3, cfg.d_model)))[0]
            for _ in range(2)]
    assert outs[0].shape == x.shape and not torch.equal(outs[0], outs[1])


def test_forward_refuses_calibration_and_cross_inputs():
    """Calibration is no longer refused: ``forward(calib=...)`` returns the
    observed ranges in ``ForwardOut.calib`` (held against the reference in
    tests/test_torch_calibrate.py), and an all-unseen collection leaves
    the logits bit-identical. A decoder-only config ignores
    ``enc_inputs`` / ``image_embeds``, as the reference does, and
    ``attend`` cross-attends to ``kv_src`` (no RoPE, not causal) as the
    reference's does, within 1e-6 * max|out|."""
    from repro_torch.core import calibrate as TCAL
    cfg = port_cfg("llama3-8b")
    tokens = torch.zeros((1, 4), dtype=torch.long)
    params = params_from_reference(reference_params("llama3-8b"), cfg, "cpu")
    plain = TMD.forward(params, cfg, tokens).logits
    out = TMD.forward(params, cfg, tokens, calib=TCAL.init_calib(cfg, "cpu"))
    assert torch.equal(out.logits, plain)
    assert set(out.calib) == set(TCAL.calib_paths(cfg))
    for kw in ("enc_inputs", "image_embeds"):
        out = TMD.forward(params, cfg, tokens,
                          **{kw: torch.zeros((1, 2, 64))}).logits
        assert torch.equal(out, plain)
    rng = np.random.default_rng(5)
    x = rng.standard_normal((1, 4, 64)).astype(np.float32)
    src = rng.standard_normal((1, 3, 64)).astype(np.float32)
    rp = jax.tree_util.tree_map(
        jnp.asarray, reference_params("llama3-8b")["decoder"]["groups"][
            "layers"][0]["attn"])
    rp = jax.tree_util.tree_map(lambda a: a[0], rp)
    want = np.asarray(RA.attend(jnp.asarray(x), rp, ref_cfg("llama3-8b"),
                                kv_src=jnp.asarray(src)))
    got = TA.attend(torch.from_numpy(x), params["layers"][0]["attn"], cfg,
                    kv_src=torch.from_numpy(src)).numpy()
    assert got.shape == want.shape == (1, 4, 64)
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=1e-6 * np.abs(want).max())
