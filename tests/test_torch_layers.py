"""The layers the dense variants add to the port, each against the JAX
package on the CPU: ``layernorm`` (stablelm), the tied head ``unembed``
(gemma2), the post-norms of ``init_params`` (gemma2), and B3's plain
version at the head dims and options those configs give it (hd 160 at
G = 4 for stablelm; hd 256 with softcap 50 and a window for gemma2)
against the JAX kernel in interpret mode.

Tolerances: ``layernorm`` within fp32 rounding (rtol 1e-6 of the row's
largest value), ``unembed`` within fp32 rounding of a K = 64 sum. B3:
the port sums the softmax denominator in fp64 and the JAX kernel in
fp32, which can move a requantized probability code across a rounding
tie; every query row whose probability codes agree (recomputed with
each library's own ops) is bit-identical, and a row with flipped codes
is held to (#flips) * 127 * sv_ref / 2^14, as in
``test_torch_attention``.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as rconfigs
from repro.configs.base import QuantConfig as RQuantConfig
from repro.kernels import pann_attention as rpa
from repro.models import layers as RL
from repro.models import model as RMD
from repro_torch import configs as tconfigs
from repro_torch.configs.base import QuantConfig as TQuantConfig
from repro_torch.convert import params_from_reference, reference_layout
from repro_torch.kernels import pann_attention as tpa
from repro_torch.models import layers as TL
from repro_torch.models import model as TMD
from repro_torch.serve_engine.artifact import _flatten
from test_torch_attention import PROB, _inputs, _qk_int64, _t
from test_torch_common import tonp

ARGS = ("qq", "q_z", "q_scale", "k_planes", "k_s", "k_z", "v_planes",
        "v_s", "v_z")


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_layernorm_matches_reference(dtype):
    rng = np.random.default_rng(0)
    x = (rng.standard_normal((3, 5, 96)) * 3 + 1.5).astype(np.float32)
    scale = (1 + rng.normal(0, 0.2, 96)).astype(np.float32)
    bias = rng.normal(0, 0.3, 96).astype(np.float32)
    jd = jnp.bfloat16 if dtype == "bfloat16" else jnp.float32
    td = torch.bfloat16 if dtype == "bfloat16" else torch.float32
    want = np.asarray(RL.layernorm(jnp.asarray(x, jd), jnp.asarray(scale),
                                   jnp.asarray(bias)).astype(jnp.float32))
    got = TL.layernorm(_t(x).to(td), _t(scale), _t(bias)).float().numpy()
    tol = 1e-6 if dtype == "float32" else 1e-2
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=tol * np.abs(want).max())
    # apply_norm / init_norm route "layernorm" to it: scale 1, bias 0
    p = TL.init_norm(96, "layernorm", "cpu")
    assert torch.equal(p["scale"], torch.ones(96))
    assert torch.equal(p["bias"], torch.zeros(96))
    rp = RL.init_norm(96, "layernorm")
    assert sorted(p) == sorted(rp)
    y = TL.apply_norm(_t(x), {"scale": _t(scale), "bias": _t(bias)},
                      "layernorm")
    assert torch.equal(y, TL.layernorm(_t(x), _t(scale), _t(bias)))


def test_unembed_matches_reference_and_refuses_quant_modes():
    rng = np.random.default_rng(1)
    x = rng.standard_normal((2, 1, 64)).astype(np.float32)
    table = (rng.standard_normal((512, 64)) * 0.02).astype(np.float32)
    want = np.asarray(RL.unembed(jnp.asarray(x), {"table": jnp.asarray(
        table)}, RQuantConfig(mode="none")))
    got = TL.unembed(_t(x), {"table": _t(table)},
                     TQuantConfig(mode="none")).numpy()
    assert got.shape == want.shape == (2, 1, 512)
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=1e-6 * np.abs(want).max())
    # the fake-quant modes run through qlinear, as the reference's do; a
    # mode that is none of the four is refused
    for mode in ("ruq", "ruq_unsigned", "pann"):
        want = np.asarray(RL.unembed(jnp.asarray(x), {"table": jnp.asarray(
            table)}, RQuantConfig(mode=mode)))
        got = TL.unembed(_t(x), {"table": _t(table)},
                         TQuantConfig(mode=mode)).numpy()
        np.testing.assert_allclose(got, want, rtol=0,
                                   atol=1e-6 * np.abs(want).max())
    with pytest.raises(ValueError, match="unknown quant mode"):
        TL.unembed(_t(x), {"table": _t(table)}, TQuantConfig(mode="lsq"))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_scale_embed_rounds_sqrt_d_to_the_compute_dtype(dtype):
    """gemma2's embeddings times sqrt(d): the scalar is rounded to the
    compute dtype before the multiply, bit for bit the reference's."""
    import dataclasses
    cfg = dataclasses.replace(tconfigs.get_config("gemma2-9b"), dtype=dtype)
    jd = jnp.bfloat16 if dtype == "bfloat16" else jnp.float32
    td = torch.bfloat16 if dtype == "bfloat16" else torch.float32
    x = np.random.default_rng(2).standard_normal((4, 64)).astype(np.float32)
    want = np.asarray((jnp.asarray(x, jd) * jnp.asarray(
        cfg.d_model ** 0.5, jd)).astype(jnp.float32))
    got = (_t(x).to(td) * TMD.embed_scale(cfg)).float().numpy()
    assert np.array_equal(got, want)


def test_gemma2_init_has_post_norms_and_the_reference_leaf_set():
    """Every layer of the port's own gemma2 init holds post1/post2 (a
    missing one was skipped silently by the residual) and the leaf set is
    the reference's, carried across; no lm_head (tied)."""
    tc = tconfigs.reduced(tconfigs.get_config("gemma2-9b"))
    rc = rconfigs.reduced(rconfigs.get_config("gemma2-9b"))
    own = TMD.init_params(tc, seed=0, device="cpu")
    assert len(own["layers"]) == tc.num_layers == 4
    for lp in own["layers"]:
        assert {"post1", "post2"} <= set(lp)
        assert torch.equal(lp["post1"]["scale"], torch.zeros(tc.d_model))
    ref = params_from_reference(
        tonp(RMD.init_params(jax.random.PRNGKey(0), rc)), tc, "cpu")

    def shapes(tree):
        return {p: tuple(t.shape) for p, t in _flatten(tree)}
    assert shapes(own) == shapes(ref)
    assert "lm_head" not in own and "lm_head" not in ref


@pytest.mark.parametrize("arch,groups", [("gemma2-9b", (21, 2)),
                                         ("qwen1.5-4b", (40, 1)),
                                         ("stablelm-12b", (40, 1))])
def test_full_width_group_layout_both_ways(arch, groups):
    """At full depth the reference stacks gemma2's (local, global) pattern
    as 21 groups of 2 layers: the port's 42 per-layer dicts restack into
    that layout (``reference_layout``, as the v1 artifact is written) and
    slice back in order (``params_from_reference``)."""
    cfg = tconfigs.get_config(arch)
    layers = [{"norm1": {"scale": torch.full((2,), float(i))}}
              for i in range(cfg.num_layers)]
    if cfg.post_norm:
        for i, lp in enumerate(layers):
            lp["post1"] = {"scale": torch.full((2,), float(i))}
    back = reference_layout({"layers": layers}, cfg)
    stacked = back["decoder"]["groups"]["layers"]
    assert len(stacked) == groups[1] and "tail" not in back["decoder"]
    for pos, node in enumerate(stacked):
        parts = node["norm1"]["scale"].parts
        assert len(parts) == groups[0]
        assert [p[0].item() for p in parts] == [
            float(g * groups[1] + pos) for g in range(groups[0])]
    np_tree = {"decoder": {"groups": {"layers": [
        {k: {"scale": np.stack([p.numpy() for p in v["scale"].parts])}
         for k, v in node.items()} for node in stacked]}}}
    again = params_from_reference(np_tree, cfg, "cpu")
    assert [lp["norm1"]["scale"][0].item() for lp in again["layers"]] == \
        [float(i) for i in range(cfg.num_layers)]


def _pq(a, pos, window, softcap, lib):
    """The requantized probability codes as each library computes them
    (JAX: fp32 denominator; torch: fp64), and sv_ref."""
    xp = jnp if lib == "jax" else torch
    asx = jnp.asarray if lib == "jax" else _t
    i32 = asx(_qk_int64(a).astype(np.int32))
    sc = (i32.astype(xp.float32) if lib == "jax" else i32.float())
    sc = (sc * asx(np.float32(a["q_scale"]))) * asx(a["k_s"])[
        :, None, None, :]
    if softcap > 0:
        cap = asx(np.float32(softcap))
        sc = cap * xp.tanh(sc / cap)
    s = a["k_s"].shape[1]
    k_pos = np.arange(s)
    valid = k_pos[None, :] <= pos
    if window is not None:
        valid &= (pos - k_pos[None, :]) < window
    valid = np.broadcast_to(valid, a["k_s"].shape)
    sc = xp.where(asx(valid)[:, None, None, :], sc,
                  asx(np.float32(-1e30)))
    if lib == "jax":
        p = jnp.exp(sc - jnp.max(sc, axis=-1, keepdims=True))
        p = p / jnp.sum(p, axis=-1, keepdims=True)
    else:
        p = torch.exp(sc - sc.amax(-1, keepdim=True))
        p = p / p.double().sum(-1, keepdim=True).float()
    sv = np.maximum(np.max(np.where(valid, a["v_s"], 0.0), axis=-1),
                    np.float32(1e-12)).astype(np.float32)
    ratio = asx(a["v_s"]) / asx(sv)[:, None]
    pq = xp.round(p * ratio[:, None, None, :] * PROB)
    return np.asarray(pq), sv


@pytest.mark.parametrize("g,hd,softcap,window", [
    (4, 160, 0.0, None), (4, 160, 0.0, 7), (4, 160, 50.0, None),
    (1, 160, 0.0, None), (2, 256, 50.0, 6), (2, 256, 50.0, None),
    (2, 256, 0.0, 6)])
@pytest.mark.parametrize("seed", range(2))
def test_attention_plain_matches_jax_kernel_at_new_head_dims(seed, g, hd,
                                                             softcap, window):
    """B3's plain version (what the CUDA kernel is held to bit for bit on
    the card) against ``repro.kernels.pann_attention.decode_attention`` in
    interpret mode, at 2, 4 and 7 cache bits."""
    rows_exact = rows = 0
    for bits in (2, 4, 7):
        a = _inputs(100 * seed + bits, b=2, kh=2, g=g, hd=hd, s=24,
                    kbits=bits, vbits=bits)
        pos = 19
        want = np.asarray(rpa.decode_attention(
            *[jnp.asarray(a[k]) for k in ARGS], jnp.int32(pos),
            window=window, softcap=softcap, interpret=True))
        got = tpa.decode_attention(
            *[_t(np.asarray(a[k])) for k in ARGS],
            torch.tensor(pos, dtype=torch.int32), window=window,
            softcap=softcap).numpy()
        assert got.shape == want.shape == (2, 2, g, hd)
        pq_r, sv = _pq(a, pos, window, softcap, "jax")
        pq_t, _ = _pq(a, pos, window, softcap, "torch")
        flips = np.sum(pq_r != pq_t, axis=-1)                # (B, K, G)
        same = flips == 0
        assert np.array_equal(got[same], want[same])
        bound = flips[..., None] * 127.0 * sv[:, None, None, None] / PROB
        assert np.all(np.abs(got - want) <= bound)
        rows_exact += int(same.sum())
        rows += same.size
    # the codes agree on most rows: the comparison is mostly bit for bit
    assert rows_exact >= rows // 2, (rows_exact, rows)
    print(f"hd {hd} G {g} softcap {softcap} window {window}: "
          f"{rows_exact} of {rows} rows bit-identical")
