"""Decode-attention parity: the port's plain version of the bit-plane
attention kernel against the JAX package's ``decode_attention_ref``, the
cache writer's codes and (s, z) rows, and the query path of
``dispatch.decode_attention`` (CPU).

Tolerance of the attention output: the integer QK^T is exact (checked
against an int64 numpy oracle). The fp32 softmax differs only through
``exp`` (XLA-CPU against torch-CPU) and the order of the denominator's sum
(the port sums in fp64), which can move a requantized probability code pq
across a rounding tie. One flipped code changes an output element by at
most 127 * sv_ref / 2^14 (|vq - vz| <= 127), so each output row is held
to (#flipped pq codes of its query row) * 127 * sv_ref / 2^14; the codes
of both sides are recomputed here with each library's own ops.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import dispatch as rdisp
from repro.kernels import ref as rref
from repro.models import attention as RA
from repro_torch.kernels import dispatch as tdisp
from repro_torch.kernels import pann_attention as tpa
from repro_torch.kernels import ref as tref
from repro_torch.models import attention as TA
from test_torch_common import LADDER, ref_layer_view, reference_store

PROB = 2.0 ** 14


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _inputs(seed, b=2, kh=1, g=4, hd=16, s=12, kbits=4, vbits=4):
    rng = np.random.default_rng(seed)
    kc = rng.integers(0, 1 << kbits, (b, s, kh, hd))
    vc = rng.integers(0, 1 << vbits, (b, s, kh, hd))
    return dict(
        qq=rng.integers(0, 128, (b, kh, g, hd)).astype(np.int32),
        q_z=np.float32(rng.integers(0, 128)),
        q_scale=np.float32(rng.uniform(0.002, 0.01)),
        k_planes=np.moveaxis(np.asarray(rref.pack_cache_codes(
            jnp.asarray(kc))), 0, 1).copy(),
        k_s=rng.uniform(0.01, 0.2, (b, s)).astype(np.float32),
        k_z=rng.integers(0, 1 << kbits, (b, s)).astype(np.float32),
        v_planes=np.moveaxis(np.asarray(rref.pack_cache_codes(
            jnp.asarray(vc))), 0, 1).copy(),
        v_s=rng.uniform(0.01, 0.2, (b, s)).astype(np.float32),
        v_z=rng.integers(0, 1 << vbits, (b, s)).astype(np.float32),
        kc=kc, vc=vc)


def _qk_int64(a):
    """Exact QK^T with both zero points, numpy int64."""
    q = a["qq"].astype(np.int64) - int(a["q_z"])
    k = a["kc"].astype(np.int64) - np.rint(a["k_z"]).astype(np.int64)[
        :, :, None, None]
    return np.einsum("bkgh,bskh->bkgs", q, k)


def _pq_jax(a, pos, window):
    i32 = jnp.asarray(_qk_int64(a).astype(np.int32))
    sc = (i32.astype(jnp.float32) * a["q_scale"]) * a["k_s"][:, None, None, :]
    s = a["k_s"].shape[1]
    k_pos = jnp.arange(s)
    valid = k_pos[None, :] <= pos
    if window is not None:
        valid &= (pos - k_pos[None, :]) < window
    valid = jnp.broadcast_to(valid, a["k_s"].shape)
    sc = jnp.where(valid[:, None, None, :], sc, -1e30)
    p = jnp.exp(sc - jnp.max(sc, axis=-1, keepdims=True))
    p = p / jnp.sum(p, axis=-1, keepdims=True)
    sv = jnp.maximum(jnp.max(jnp.where(valid, a["v_s"], 0.0), axis=-1),
                     1e-12)
    ratio = a["v_s"] / sv[:, None]
    return np.asarray(jnp.round(p * ratio[:, None, None, :] * PROB)), \
        np.asarray(sv)


def _pq_torch(a, pos, window):
    i32 = _t(_qk_int64(a).astype(np.int32))
    sc = (i32.float() * torch.tensor(a["q_scale"])) * _t(a["k_s"])[
        :, None, None, :]
    s = a["k_s"].shape[1]
    k_pos = torch.arange(s)
    valid = k_pos[None, :] <= pos
    if window is not None:
        valid &= (pos - k_pos[None, :]) < window
    valid = valid.expand(a["k_s"].shape)
    sc = torch.where(valid[:, None, None, :], sc, torch.tensor(-1e30))
    p = torch.exp(sc - sc.amax(-1, keepdim=True))
    p = p / p.double().sum(-1, keepdim=True).float()
    sv = torch.clamp(torch.where(valid, _t(a["v_s"]), 0.0).amax(-1),
                     min=1e-12)
    ratio = _t(a["v_s"]) / sv[:, None]
    return torch.round(p * ratio[:, None, None, :] * PROB).numpy()


@pytest.mark.parametrize("seed", range(3))
@pytest.mark.parametrize("window", [None, 5])
@pytest.mark.parametrize("bits", [(2, 3), (4, 4), (7, 7)])
def test_decode_attention_plain_within_probability_quantum(seed, window,
                                                           bits):
    a = _inputs(seed, kbits=bits[0], vbits=bits[1])
    pos = 9
    args = ("qq", "q_z", "q_scale", "k_planes", "k_s", "k_z", "v_planes",
            "v_s", "v_z")
    want = np.asarray(rref.decode_attention_ref(
        *[jnp.asarray(a[k]) for k in args], jnp.int32(pos), window=window))
    got = tpa.decode_attention(*[_t(np.asarray(a[k])) for k in args],
                               torch.tensor(pos, dtype=torch.int32),
                               window=window).numpy()
    pq_r, sv = _pq_jax(a, pos, window)
    pq_t = _pq_torch(a, pos, window)
    flips = np.sum(pq_r != pq_t, axis=-1)                  # (B, K, G)
    bound = flips[..., None] * 127.0 * sv[:, None, None, None] / PROB
    assert np.all(np.abs(got - want) <= bound), (
        np.max(np.abs(got - want)), int(flips.sum()))


def test_decode_attention_integer_path_exact():
    """With every probability code equal, the output is bit for bit the
    reference's: the integer QK^T and PV passes are exact."""
    a = _inputs(5, s=1)              # one valid position: p == 1 exactly
    args = ("qq", "q_z", "q_scale", "k_planes", "k_s", "k_z", "v_planes",
            "v_s", "v_z")
    want = np.asarray(rref.decode_attention_ref(
        *[jnp.asarray(a[k]) for k in args], jnp.int32(0)))
    got = tref.decode_attention_ref(*[_t(np.asarray(a[k])) for k in args],
                                    torch.tensor(0, dtype=torch.int32))
    assert np.array_equal(got.numpy(), want)


@pytest.mark.parametrize("calib", [False, True])
@pytest.mark.parametrize("bits", LADDER)
def test_cache_write_codes_and_rows_exact(calib, bits):
    _, _, ws, pws = reference_store(calib=calib)
    rkc = ref_layer_view(ws.views[bits], 0, "attn", "kv_cache")
    tkc = pws.views[bits]["layers"][0]["attn"]["kv_cache"]
    rng = np.random.default_rng(bits)
    b, s_max, kh, hd = 2, 6, 1, 16
    new = (rng.standard_normal((b, 1, kh, hd)) * 2).astype(np.float32)
    for role in ("k", "v"):
        n_r = jnp.asarray(rkc[f"{role}_nlvl"], jnp.float32).reshape(())
        s_r, z_r = RA._cache_rows(jnp.asarray(new), rkc.get(f"{role}_s"),
                                  rkc.get(f"{role}_z"), n_r)
        planes = jnp.zeros((b, 7, s_max, kh, hd // 8), jnp.uint8)
        row = jnp.zeros((b, s_max), jnp.float32)
        rp, rs, rz = RA._cache_write(planes, row, row, jnp.asarray(new),
                                     s_r, z_r, n_r, jnp.int32(3))
        n_t = tkc[f"{role}_nlvl"].reshape(())
        s_t, z_t = TA._cache_rows(_t(new), tkc.get(f"{role}_s"),
                                  tkc.get(f"{role}_z"), n_t)
        tp = torch.zeros((b, 7, s_max, kh, hd // 8), dtype=torch.uint8)
        ts, tz = torch.zeros((b, s_max)), torch.zeros((b, s_max))
        TA._cache_write(tp, ts, tz, _t(new), s_t, z_t, n_t,
                        torch.tensor(3, dtype=torch.int32))
        assert np.array_equal(np.asarray(rp), tp.numpy())
        assert np.array_equal(np.asarray(rs), ts.numpy())
        assert np.array_equal(np.asarray(rz), tz.numpy())


def test_dispatch_query_codes_and_planes_active():
    """The query quantizer and live-plane counts of the dispatch agree
    with the reference's; with one cached position the whole attention is
    exact end to end."""
    for n in (3.0, 15.0, 127.0):
        assert float(rdisp.cache_planes_active(jnp.float32(n))) == \
            tdisp.cache_planes_active(torch.tensor(n)).item()
    a = _inputs(9, b=2, s=4)
    rng = np.random.default_rng(9)
    q = rng.standard_normal((2, 4, 16)).astype(np.float32)

    class Cache:
        pass

    rc, tc = Cache(), Cache()
    for k in ("k_planes", "k_s", "k_z", "v_planes", "v_s", "v_z"):
        setattr(rc, k, jnp.asarray(a[k]))
        setattr(tc, k, _t(np.asarray(a[k])))
    rc.length, tc.length = jnp.int32(0), torch.tensor(0, dtype=torch.int32)
    want = np.asarray(rdisp.decode_attention(jnp.asarray(q), rc, "ref",
                                             num_kv_heads=1))
    for backend in ("ref", "packed"):
        got = tdisp.decode_attention(_t(q), tc, backend, num_kv_heads=1,
                                     k_nlvl=torch.tensor(15.0),
                                     v_nlvl=torch.tensor(15.0))
        assert np.array_equal(got.numpy(), want), backend
    jax.clear_caches()
