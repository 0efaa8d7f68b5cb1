"""Quantizer parity: the port's ``core/quant``, ``core/pann``, the plane
and cache codecs, and its own weight-store builder against the JAX package
on the same seeded numpy inputs (CPU)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import pann as rpann
from repro.core import quant as rquant
from repro.kernels import ref as rref
from repro.kernels.pann_matmul_packed import pack_planes as r_pack_planes
from repro.kernels.pann_matmul_packed import unpack_planes as r_unpack_planes
from repro_torch.convert import params_from_reference
from repro_torch.core import pann as tpann
from repro_torch.core import quant as tquant
from repro_torch.kernels import ref as tref
from repro_torch.kernels.pann_matmul_packed import pack_planes, unpack_planes
from repro_torch.models import serving as TSV
from test_torch_common import (LADDER, port_cfg, reference_store, rung_specs,
                               tonp)


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


@pytest.mark.parametrize("seed", range(4))
@pytest.mark.parametrize("n_lvl", [3.0, 15.0, 127.0])
def test_affine_scalars_and_encode_exact_with_ties(seed, n_lvl):
    rng = np.random.default_rng(seed)
    x = (rng.standard_normal((6, 40)) * 3 + seed - 1).astype(np.float32)
    lo, hi = rquant.act_range_bounds(jnp.asarray(x), include_zero=True)
    s, z = rquant.affine_scale_zp(lo, hi, jnp.float32(n_lvl))
    tlo, thi = tquant.act_range_bounds(_t(x), include_zero=True)
    ts, tz = tquant.affine_scale_zp(tlo, thi, torch.tensor(n_lvl))
    assert np.float32(s) == ts.item() and np.float32(z) == tz.item()
    # exact .5 ties of x / s: round half to even must agree
    ties = ((np.arange(-20, 20) + 0.5) * np.float32(s)).astype(np.float32)
    xt = np.concatenate([x.reshape(-1), ties]).astype(np.float32)
    ref = np.asarray(rquant.affine_encode(jnp.asarray(xt), s, z, n_lvl))
    got = tquant.affine_encode(_t(xt), ts, tz, torch.tensor(n_lvl)).numpy()
    assert np.array_equal(ref, got)
    got_scalar_n = tquant.affine_encode(_t(xt), ts, tz, n_lvl).numpy()
    assert np.array_equal(ref, got_scalar_n)


def test_frozen_range_bounds_exact():
    x = np.linspace(-1, 3, 50, dtype=np.float32)
    for lo, hi in [(-0.5, 2.0), (0.3, 0.9), (2.0, 1.0)]:   # last: unseen
        r = rquant.act_range_bounds(jnp.asarray(x), jnp.float32(lo),
                                    jnp.float32(hi))
        t = tquant.act_range_bounds(_t(x), torch.tensor(lo),
                                    torch.tensor(hi))
        assert [float(v) for v in r] == [v.item() for v in t]


@pytest.mark.parametrize("shift", range(7))
def test_bitplanes_masked_and_truncated_codes_exact(shift):
    rng = np.random.default_rng(shift)
    codes = rng.integers(-127, 128, (24, 40)).astype(np.int8)
    pos = np.maximum(codes.astype(np.int32), 0)
    assert np.array_equal(
        np.asarray(rpann.bitplane_decompose(jnp.asarray(pos), 7)),
        tpann.bitplane_decompose(_t(pos), 7).numpy())
    assert np.array_equal(
        np.asarray(rpann.masked_codes(jnp.asarray(codes), shift)),
        tpann.masked_codes(_t(codes), torch.tensor(float(shift))).numpy())
    assert np.array_equal(
        np.asarray(rpann.truncate_codes(jnp.asarray(codes), shift)),
        tpann.truncate_codes(_t(codes), shift).numpy())


@pytest.mark.parametrize("n_planes", [1, 7, 8, 9])
@pytest.mark.parametrize("dtype", [np.int8, np.int16, np.int32, np.int64])
def test_bitplane_decompose_dtypes_match_reference(dtype, n_planes):
    """The low-byte path (n_planes <= 8, int8 input reinterpreted, wider
    input masked) and the int32 path (9 planes) against the reference,
    on the unsigned split's magnitudes 0..128 and wider values whose
    planes past the low byte must come out too."""
    rng = np.random.default_rng(n_planes)
    codes = rng.integers(-128, 128, (16, 24))
    for w in (np.maximum(codes, 0), np.maximum(-codes, 0),
              rng.integers(0, 1 << 12, (16, 24))):
        if np.iinfo(dtype).max < w.max():
            continue
        w = w.astype(dtype)
        got = tpann.bitplane_decompose(_t(w), n_planes)
        assert got.dtype == torch.int8 and got.is_contiguous()
        assert np.array_equal(
            np.asarray(rpann.bitplane_decompose(
                jnp.asarray(w.astype(np.int32)), n_planes)), got.numpy())


def test_view_shift_and_snapped_r_match():
    for r_max in (0.5, 2.83, 7.9, 31.0):
        for r in (0.1, 0.4, 1.0, 2.83, 5.5, 7.9):
            assert rpann.view_shift(r_max, r) == tpann.view_shift(r_max, r)
        for sh in range(7):
            assert rpann.snapped_r(r_max, sh) == tpann.snapped_r(r_max, sh)


@pytest.mark.parametrize("k", [8, 13, 64])
def test_pack_unpack_planes_exact(k):
    rng = np.random.default_rng(k)
    planes = rng.integers(0, 2, (7, k, 12)).astype(np.int8)
    ref = np.asarray(r_pack_planes(jnp.asarray(planes)))
    got = pack_planes(_t(planes)).numpy()
    assert np.array_equal(ref, got)
    assert np.array_equal(np.asarray(r_unpack_planes(jnp.asarray(ref), k)),
                          unpack_planes(_t(got), k).numpy())


@pytest.mark.parametrize("bits", [2, 4, 7])
def test_pack_unpack_cache_codes_exact(bits):
    rng = np.random.default_rng(bits)
    codes = rng.integers(0, 1 << bits, (3, 5, 2, 16)).astype(np.int32)
    ref = np.asarray(rref.pack_cache_codes(jnp.asarray(codes)))
    got = tref.pack_cache_codes(_t(codes)).numpy()
    assert np.array_equal(ref, got)
    assert np.array_equal(np.asarray(rref.unpack_cache_codes(jnp.asarray(ref))),
                          tref.unpack_cache_codes(_t(got)).numpy())


def _near_tie(w, gamma, tol=1e-4):
    frac = np.abs(w / gamma) - np.floor(np.abs(w / gamma))
    return np.abs(frac - 0.5) < tol


@pytest.mark.parametrize("r", [0.7, 2.83, 7.9])
def test_pann_gamma_and_quantize_match_up_to_ties(r):
    rng = np.random.default_rng(int(r * 10))
    w = (rng.standard_normal((128, 96)) * 0.05).astype(np.float32)
    rg = np.asarray(rpann.pann_gamma(jnp.asarray(w), r, axis=0))
    tg = tpann.pann_gamma(_t(w), r, dim=0).numpy()
    assert np.max(np.abs(tg - rg) / rg) <= 1e-6
    rq, _ = rpann.pann_quantize(jnp.asarray(w), r, axis=0)
    tq, _ = tpann.pann_quantize(_t(w), r, dim=0)
    differ = np.asarray(rq) != tq.numpy()
    ties = _near_tie(w, rg)
    # codes may differ only where w / gamma sits within 1e-4 of a .5 tie
    assert not np.any(differ & ~ties), int(np.sum(differ & ~ties))
    print(f"r={r}: {int(differ.sum())} codes differ, all at "
          f"{int(ties.sum())} near-tie elements")


def test_port_weight_store_matches_reference_up_to_ties():
    """The port's own quantizer on the same params: every rung view's
    codes, planes, colsum and leaves equal the reference's, except at codes
    whose w/gamma is within 1e-4 of a .5 tie (counted)."""
    cfg, params, ws, _ = reference_store(cache_bits=4)
    tparams = params_from_reference(tonp(params), port_cfg(), "cpu")
    pws = TSV.build_weight_store(
        tparams, port_cfg(), rung_specs(cfg),
        TSV.ServingQuantSpec(pack_planes=True, cache_bits=4))
    assert all("w" not in lp["mlp"]["w_up"] for lp in tparams["layers"])
    n_diff = n_ties = 0
    ref_params = tonp(params)
    for layer in range(cfg.num_layers):
        for parent, name in [("attn", "wq"), ("attn", "wv"),
                             ("mlp", "w_down")]:
            w = ref_params["decoder"]["groups"]["layers"][0][parent][name][
                "w"][layer]
            r_store = ws.store["decoder"]["groups"]["layers"][0][parent][name]
            rq = np.asarray(r_store["w_q"][layer])
            rg = np.asarray(r_store["w_scale"][layer])
            t_store = pws.store["layers"][layer][parent][name]
            tq = t_store["w_q"].numpy()
            differ = rq != tq
            assert not np.any(differ & ~_near_tie(w, rg))
            n_diff += int(differ.sum())
            n_ties += int(_near_tie(w, rg).sum())
            if not differ.any():
                assert np.array_equal(
                    np.asarray(r_store["w_planes_pos"][layer]),
                    t_store["w_planes_pos"].numpy())
            for bits in LADDER:
                rv = jax.tree_util.tree_map(
                    lambda a: a[layer],
                    ws.views[bits]["decoder"]["groups"]["layers"][0][parent][
                        name])
                tv = pws.views[bits]["layers"][layer][parent][name]
                for key in ("plane_shift", "act_n", "act_nlvl"):
                    assert np.asarray(rv[key]) == tv[key].item()
                if not differ.any():
                    assert np.array_equal(np.asarray(rv["w_colsum"]),
                                          tv["w_colsum"].numpy())
    kc = pws.views[2]["layers"][0]["attn"]["kv_cache"]
    assert kc["k_nlvl"].item() == 15.0 and kc["v_nlvl"].item() == 15.0
    print(f"port quantizer: {n_diff} codes differ, {n_ties} near-tie "
          "elements")
