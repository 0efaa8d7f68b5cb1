"""The kernel API: ``repro_torch.kernels.ops`` against ``repro.kernels.ops``
(its Pallas kernels in interpret mode) on ragged shapes and leading dims,
and the unfused chain x -> quantize_act -> B4 / B5 / B6 against the JAX
chain, on the same seeded numpy inputs (CPU).

Tolerances: the matmul wrappers are bit-identical. ``quantize_act`` is
bit-identical to ``ref.quantize_act_ref`` row by row; against the jitted
interpret-mode kernel (XLA multiplies by 1/qmax) its scales agree within
1 ulp and its codes within 1 on under 1 % of the elements.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st

from repro.kernels import ops as rops
from repro.kernels import ref as rref
from repro.kernels.pann_matmul import pann_matmul as r_pann_matmul
from repro.kernels.pann_matmul_packed import pack_planes as r_pack
from repro.kernels.pann_matmul_packed import (
    pann_matmul_packed as r_pann_matmul_packed)
from repro.kernels.unsigned_matmul import unsigned_matmul as r_unsigned
from repro_torch.kernels import ops as tops
from repro_torch.kernels import pann_matmul as tpm
from repro_torch.kernels import pann_matmul_packed as tpk
from repro_torch.kernels import ref as tref
from repro_torch.kernels import unsigned_matmul as tum

RAGGED = [(100, 200, 72), (13, 130, 7), (64, 96, 80), (200, 256, 120),
          (128, 64, 64)]


def _t(a):
    return torch.from_numpy(np.array(a))


def _packed_to_torch(rp: dict) -> dict:
    return {k: _t(np.asarray(v)) if hasattr(v, "shape") else v
            for k, v in rp.items()}


def _ulps(a, b):
    return np.abs(a.view(np.int32).astype(np.int64)
                  - b.view(np.int32).astype(np.int64))


@pytest.mark.parametrize("bits", [4, 8])
@pytest.mark.parametrize("shape", [(4, 32, 96), (100, 200), (13, 130)])
def test_ops_quantize_act_leading_dims(shape, bits):
    rng = np.random.default_rng(len(shape) * 10 + bits)
    x = (2 * rng.standard_normal(shape) + 0.5).astype(np.float32)
    q, s = tops.quantize_act(_t(x), bits=bits)
    assert q.shape == shape and s.shape == shape[:-1] + (1,)
    qr, sr = rref.quantize_act_ref(jnp.asarray(x.reshape(-1, shape[-1])),
                                   bits=bits)
    assert np.array_equal(q.numpy().reshape(qr.shape), np.asarray(qr))
    assert np.array_equal(s.numpy().reshape(sr.shape), np.asarray(sr))
    qk, sk = rops.quantize_act(jnp.asarray(x), bits=bits, interpret=True)
    assert qk.shape == q.shape and sk.shape == s.shape
    ulps = _ulps(s.numpy(), np.asarray(sk))
    print(f"{shape} bits={bits}: {int(np.sum(ulps > 0))} of {ulps.size} row "
          f"scales 1 ulp from the interpret-mode kernel's")
    assert ulps.max() <= 1
    diff = np.abs(q.numpy().astype(np.int32) - np.asarray(qk, np.int32))
    assert diff.max() <= 1 and (diff > 0).mean() < 0.01


@pytest.mark.parametrize("m,k,n", RAGGED)
def test_ops_unsigned_matmul_ragged(m, k, n):
    rng = np.random.default_rng(m + k + n)
    x_q = rng.integers(0, 128, (m, k)).astype(np.int8)
    w_q = rng.integers(-127, 128, (k, n)).astype(np.int8)
    s_x = rng.uniform(0.01, 0.1, (m, 1)).astype(np.float32)
    s_w = rng.uniform(0.001, 0.01, (n,)).astype(np.float32)
    want = np.asarray(rops.unsigned_matmul(
        jnp.asarray(x_q), jnp.asarray(w_q), jnp.asarray(s_x),
        jnp.asarray(s_w), interpret=True))
    got = tops.unsigned_matmul(_t(x_q), _t(w_q), _t(s_x), _t(s_w)).numpy()
    assert got.shape == (m, n) and np.array_equal(got, want)


@pytest.mark.parametrize("mode", ["fused", "planes"])
@pytest.mark.parametrize("m,k,n", RAGGED)
def test_ops_pann_matmul_ragged(m, k, n, mode):
    """The end-to-end PANN linear through B1 in both modes: the JAX
    package's packing carried across, then the port's own packing."""
    rng = np.random.default_rng(m * k + n)
    w = rng.standard_normal((k, n)).astype(np.float32)
    x = (rng.standard_normal((m, k)) + 0.2).astype(np.float32)
    rp = rops.pann_pack_weights(jnp.asarray(w), 2.0, axis=0)
    want = np.asarray(rops.pann_matmul(jnp.asarray(x), rp, act_bits=8,
                                       mode=mode, interpret=True))
    got = tops.pann_matmul(_t(x), _packed_to_torch(rp), act_bits=8,
                           mode=mode).numpy()
    assert got.shape == (m, n) and np.array_equal(got, want)
    tp = tops.pann_pack_weights(_t(w), 2.0, dim=0)
    assert tp["n_planes"] == rp["n_planes"] and tp["r"] == rp["r"]
    assert np.array_equal(tp["planes_pos"].numpy(),
                          np.asarray(rp["planes_pos"]))
    assert np.array_equal(tp["planes_neg"].numpy(),
                          np.asarray(rp["planes_neg"]))
    g = np.asarray(rp["gamma"])
    assert np.max(np.abs(tp["gamma"].numpy() - g) / g) <= 1e-6


@settings(deadline=None, max_examples=12)
@given(m=st.integers(1, 20), k=st.integers(1, 40), n=st.integers(1, 24),
       bits=st.integers(2, 8), seed=st.integers(0, 2 ** 16))
def test_ops_pann_matmul_modes_agree(m, k, n, bits, seed):
    rng = np.random.default_rng(seed)
    w = torch.from_numpy(rng.standard_normal((k, n)).astype(np.float32))
    x = torch.from_numpy(rng.standard_normal((m, k)).astype(np.float32))
    packed = tops.pann_pack_weights(w, 3.0)
    a = tops.pann_matmul(x, packed, act_bits=bits, mode="fused")
    b = tops.pann_matmul(x, packed, act_bits=bits, mode="planes")
    assert a.shape == (m, n) and torch.equal(a, b)


@pytest.mark.parametrize("m,k,n,bits", [(128, 128, 128, 8), (128, 256, 128, 6),
                                        (256, 128, 256, 4)])
def test_unfused_chain_matches_jax(m, k, n, bits):
    """x -> quantize_act -> B4 (both modes), B5, B6: the port's chain
    against the JAX chain (oracle quantizer, Pallas kernels in interpret
    mode), bit for bit."""
    rng = np.random.default_rng(bits)
    x = np.abs(rng.standard_normal((m, k))).astype(np.float32)
    w = (rng.standard_normal((k, n)) * 0.05).astype(np.float32)
    rp = rops.pann_pack_weights(jnp.asarray(w), 2.0, axis=0)
    tp = _packed_to_torch(rp)
    xq_j, sx_j = rref.quantize_act_ref(jnp.asarray(x), bits=bits)
    xq, sx = tops.quantize_act(_t(x), bits=bits)
    assert np.array_equal(xq.numpy(), np.asarray(xq_j))
    pp_j, pn_j, g_j = rp["planes_pos"], rp["planes_neg"], rp["gamma"]
    pp, pn, g = tp["planes_pos"], tp["planes_neg"], tp["gamma"]
    w_q = tpm.rebuild_weight(pp, pn).to(torch.int8)
    ys = {}
    for mode in ("fused", "planes"):
        want = np.asarray(r_pann_matmul(xq_j, pp_j, pn_j, sx_j, g_j,
                                        mode=mode, interpret=True))
        ys[mode] = tpm.pann_matmul(xq, pp, pn, sx, g, mode=mode).numpy()
        assert np.array_equal(ys[mode], want)
    want = np.asarray(r_pann_matmul_packed(xq_j, r_pack(pp_j), r_pack(pn_j),
                                           sx_j, g_j, interpret=True))
    ys["packed"] = tpk.pann_matmul_packed(xq, tpk.pack_planes(pp),
                                          tpk.pack_planes(pn), sx, g).numpy()
    assert np.array_equal(ys["packed"], want)
    want = np.asarray(r_unsigned(xq_j, jnp.asarray(w_q.numpy()), sx_j, g_j,
                                 interpret=True))
    ys["unsigned"] = tum.unsigned_matmul(xq, w_q, sx, g).numpy()
    assert np.array_equal(ys["unsigned"], want)
    oracle = tref.pann_matmul_ref(xq, pp, pn, sx, g).numpy()
    for name, y in ys.items():
        assert np.array_equal(y, oracle), name
