"""The conv projections of the port (``kernels/pann_conv``,
``dispatch.serving_conv``, ``layers.apply_conv``) against the JAX package
on the CPU, at the stems of reduced seamless-m4t-medium (3x1/s2 convs with
a 1-row pad: (96, 1, 80) -> 48 -> 24 positions, K = 240 and 192) and
reduced llama-3.2-vision-90b (a 4x4/s4 patchify: 16x16x3 -> 16 tokens,
K = 48), and at the full widths' K (240, 3072, 588) on small inputs.

Tolerance: bit for bit. im2col is a gather, and the conv's integer sums
are exact on both sides (the port's oracle is a float64 convolution of the
codes, exact below 2^53): ``serving_conv`` on 'ref', 'fused' and 'packed'
(the plain versions of B1 and B2 on the CPU) equals the port's oracle and
the reference's ``serving_conv`` ('packed:force', Pallas in interpret mode)
and its int32 ``lax.conv`` oracle, on every rung view of a store carried
across from the reference. ``apply_conv`` on fp params at quant 'none'
and 'pann' (the fake-quant projection) within 1e-6 * max|out| of the
reference.
"""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.base import ConvSpec as RConvSpec
from repro.configs.base import QuantConfig as RQuantConfig
from repro.kernels import dispatch as RD
from repro.kernels import pann_conv as RPC
from repro.models import layers as RL
from repro.models import serving as RSV
from repro_torch.configs.base import ConvSpec
from repro_torch.configs.base import QuantConfig as TQuantConfig
from repro_torch.convert import weight_store_from_reference
from repro_torch.kernels import dispatch as TD
from repro_torch.kernels import pann_conv as TPC
from repro_torch.models import layers as TL
from test_torch_common import rung_specs, tonp
from test_torch_common import one_torch_thread  # noqa: F401
from test_torch_encoder import (ARCHS, PANN, port_cfg, raw_input, ref_cfg,
                                reference_params)

BACKENDS = ("ref", "fused", "packed")


def test_extract_patches_matches_flat_weight_layout():
    """Feature order (di, dj, c): the patch matmul is the conv (float,
    against F.conv2d), and the patches equal the reference's bit for
    bit."""
    rng = np.random.default_rng(0)
    x = rng.standard_normal((2, 9, 7, 5)).astype(np.float32)
    w = rng.standard_normal((3 * 2 * 5, 4)).astype(np.float32)
    patches = TPC.extract_patches(torch.from_numpy(x), 3, 2, 2, 1)
    assert patches.shape == (2, 4, 6, 30)
    want = np.asarray(RPC.extract_patches(jnp.asarray(x), 3, 2, 2, 1))
    assert np.array_equal(patches.numpy(), want)
    y_mat = patches.reshape(-1, 30) @ torch.from_numpy(w)
    y_conv = torch.nn.functional.conv2d(
        torch.from_numpy(x).permute(0, 3, 1, 2),
        torch.from_numpy(w).reshape(3, 2, 5, 4).permute(3, 2, 0, 1),
        stride=(2, 1)).permute(0, 2, 3, 1)
    np.testing.assert_allclose(y_mat.reshape(y_conv.shape).numpy(),
                               y_conv.numpy(), rtol=1e-5, atol=1e-5)
    padded = TPC.pad_nhwc(torch.from_numpy(x), 2, 1)
    assert np.array_equal(padded.numpy(), np.asarray(
        RPC.pad_nhwc(jnp.asarray(x), 2, 1)))


@pytest.mark.parametrize("size,k,stride,pad", [(2, 5, 1, 0), (0, 1, 1, 0),
                                               (3, 8, 2, 2)])
def test_conv_out_size_refuses_empty_output(size, k, stride, pad):
    with pytest.raises(ValueError, match="empty output"):
        TPC.conv_out_size(size, k, stride, pad)
    with pytest.raises(ValueError):
        RPC.conv_out_size(size, k, stride, pad)
    for args in ((4096, 3, 2, 1), (560, 14, 14, 0), (7, 3, 2, 0)):
        assert TPC.conv_out_size(*args) == RPC.conv_out_size(*args)


def test_conv_exact_is_the_integer_patch_matmul():
    """The oracle's float64 convolution of codes equals the int64 patch
    matmul and the reference's int32 ``lax.conv`` at the codes' extremes
    (127 x 127 products over K = 588)."""
    rng = np.random.default_rng(1)
    q = rng.integers(0, 128, (1, 28, 28, 3)).astype(np.float32)
    q[0, :14, :14] = 127
    w = rng.integers(-127, 128, (14 * 14 * 3, 8)).astype(np.int32)
    w[:, 0] = 127
    got = TPC.conv_exact(torch.from_numpy(q), torch.from_numpy(w),
                         14, 14, 14, 14)
    patches = TPC.extract_patches(torch.from_numpy(q), 14, 14, 14, 14)
    want = patches.to(torch.int64).reshape(-1, 588) @ torch.from_numpy(
        w).to(torch.int64)
    assert torch.equal(got.reshape(-1, 8), want)
    ref = np.asarray(RPC.conv_int32(jnp.asarray(q), jnp.asarray(w),
                                    14, 14, 14, 14))
    assert np.array_equal(got.numpy(), ref.astype(np.int64))


@functools.lru_cache(maxsize=None)
def stem_store(arch):
    """The conv stem alone of the reference's seeded params (biases
    nonzero), as a reference weight store (ladder 2,4,6, packed planes)
    and the port's carried copy."""
    rc = ref_cfg(arch)
    params = {"conv_stem": jax.tree_util.tree_map(
        jnp.asarray, reference_params(arch)["conv_stem"])}
    ws = RSV.build_weight_store(params, rc, rung_specs(rc),
                                spec=RSV.ServingQuantSpec(pack_planes=True))

    def full(tree):      # no decoder layers: an empty stack
        return dict(tonp(tree), decoder={})
    pws = weight_store_from_reference(
        full(ws.store), {k: full(v) for k, v in ws.views.items()},
        None, "cpu")
    return ws, pws


def _stem_inputs(arch):
    """Each stem layer's input: the raw frontend, then a relu'd normal
    tensor of the next layer's input shape."""
    cfg = port_cfg(arch)
    xs = [raw_input(arch)]
    h, w = cfg.frontend_hw
    rng = np.random.default_rng(5)
    for spec in cfg.conv_stem[:-1]:
        h, w = spec.out_hw(h, w)
        xs.append(np.maximum(rng.standard_normal(
            (2, h, w, spec.c_out)), 0).astype(np.float32))
    return xs


@pytest.mark.parametrize("arch", ARCHS)
def test_serving_conv_bit_identical_to_oracles_on_every_rung(arch):
    """Every stem layer at every rung view: the port's three backends
    equal its float64 oracle, the reference's int32 oracle and the
    reference's Pallas backend (interpret mode), bit for bit; the rungs'
    outputs differ (the views' plane_shift masks are live)."""
    ws, pws = stem_store(arch)
    cfg = port_cfg(arch)
    for i, (spec, x) in enumerate(zip(cfg.conv_stem, _stem_inputs(arch))):
        rspec = ref_cfg(arch).conv_stem[i]
        outs = {}
        for bits in sorted(pws.views):
            tp = pws.views[bits]["conv_stem"][f"s{i}"]
            rp = ws.views[bits]["conv_stem"][f"s{i}"]
            assert "plane_shift" in tp and "b" in tp
            oracle = TD.serving_conv_oracle(torch.from_numpy(x), tp, spec)
            assert oracle.dtype == torch.float32
            assert oracle.shape == (2,) + spec.out_hw(*x.shape[1:3]) + (
                spec.c_out,)
            for backend in BACKENDS:
                got = TD.serving_conv(torch.from_numpy(x), tp, spec, backend)
                assert torch.equal(got, oracle), (arch, i, bits, backend)
            xj = jnp.asarray(x)
            for want in (RD.serving_conv_oracle(xj, rp, rspec),
                         RD.serving_conv(xj, rp, rspec, "packed:force")):
                assert np.array_equal(oracle.numpy(), np.asarray(want))
            outs[bits] = oracle
        assert not torch.equal(outs[min(outs)], outs[max(outs)])


@pytest.mark.parametrize("kh,kw,s,c_in,c_out,pad,hw", [
    (3, 1, 2, 80, 64, 1, (17, 1)),       # seamless s0: K = 240
    (3, 1, 2, 1024, 16, 1, (9, 1)),      # seamless s1: K = 3072
    (14, 14, 14, 3, 32, 0, (28, 42)),    # vision: K = 588, packed to 592
])
def test_serving_conv_at_the_full_stems_k(kh, kw, s, c_in, c_out, pad, hw):
    """The full-width stems' K (240, 3072, 588: none a multiple of 64, 588
    none of 8) on small inputs: a single-point artifact of the reference
    (value-exact plane count) and a ladder view, carried across; every
    backend equals the oracle and the reference's oracle bit for bit."""
    spec = ConvSpec(kh=kh, kw=kw, sh=s, sw=1 if kw == 1 else s, c_in=c_in,
                    c_out=c_out, ph=pad)
    rspec = RConvSpec(**dataclasses.asdict(spec))
    rng = np.random.default_rng(kh * c_in)
    params = {"conv_stem": {"s0": {
        "w": jnp.asarray(rng.standard_normal((spec.fan_in, c_out)).astype(
            np.float32) * spec.fan_in ** -0.5),
        "b": jnp.asarray(rng.normal(0, 0.3, c_out).astype(np.float32))}}}
    rc = ref_cfg(ARCHS[0])
    single = RSV.quantize_params_for_serving(
        params, rc, spec=RSV.ServingQuantSpec(r=4.0, act_bits=6,
                                              pack_planes=True))
    ws = RSV.build_weight_store(params, rc, rung_specs(rc),
                                spec=RSV.ServingQuantSpec(pack_planes=True))
    x = rng.standard_normal((2,) + hw + (c_in,)).astype(np.float32)
    for rp in (single["conv_stem"]["s0"], ws.views[2]["conv_stem"]["s0"]):
        tp = {k: torch.from_numpy(np.array(v)) for k, v in tonp(rp).items()}
        if c_in * kh * kw == 588:
            assert tp["w_planes_pos"].shape[-2] * 8 == 592
        oracle = TD.serving_conv_oracle(torch.from_numpy(x), tp, spec)
        want = np.asarray(RD.serving_conv_oracle(jnp.asarray(x), rp, rspec))
        assert np.array_equal(oracle.numpy(), want)
        for backend in BACKENDS:
            assert torch.equal(
                TD.serving_conv(torch.from_numpy(x), tp, spec, backend),
                oracle), backend


@pytest.mark.parametrize("arch", ARCHS)
def test_zero_padding_is_exact(arch):
    """The scalars come from the padded input and a zero border encodes to
    the zero point: padding inside ``serving_conv`` equals padding by hand
    and a pad-free geometry, bit for bit (vision's stem has no pad, so its
    check pads a copy of seamless's geometry over its pixels)."""
    _, pws = stem_store(arch)
    cfg = port_cfg(arch)
    spec = cfg.conv_stem[0]
    x = torch.from_numpy(raw_input(arch))
    p = pws.views[4]["conv_stem"]["s0"]
    if not spec.ph:
        spec = dataclasses.replace(spec, ph=2, pw=1)
    y = TD.serving_conv(x, p, spec, "packed")
    manual = TD.serving_conv(TPC.pad_nhwc(x, spec.ph, spec.pw), p,
                             dataclasses.replace(spec, ph=0, pw=0), "packed")
    assert torch.equal(y, manual)


@pytest.mark.parametrize("mode", ["none", "pann"])
@pytest.mark.parametrize("arch", ARCHS)
def test_apply_conv_matches_reference(arch, mode):
    """``apply_conv`` on fp params: im2col and ``apply_linear`` at the
    module's quant mode, against the reference's."""
    qc = dict(PANN) if mode == "pann" else dict(mode="none")
    rc = ref_cfg(arch, quant=RQuantConfig(**qc))
    tc = port_cfg(arch, quant=TQuantConfig(**qc))
    x = raw_input(arch)
    p = reference_params(arch)["conv_stem"]["s0"]
    want = np.asarray(RL.apply_conv(
        jnp.asarray(x), jax.tree_util.tree_map(jnp.asarray, p), rc,
        rc.conv_stem[0], "conv.s0"))
    got = TL.apply_conv(torch.from_numpy(x),
                        {k: torch.from_numpy(v) for k, v in p.items()}, tc,
                        tc.conv_stem[0], "conv.s0").numpy()
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=1e-6 * np.abs(want).max())
