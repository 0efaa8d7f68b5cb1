"""``serving_linear`` parity: the port's backends on a weight store carried
across from the JAX package give the JAX 'ref' backend's fp32 output bit
for bit, for every rung view (every plane_shift), with dynamic activation
scalars, hoisted act_s/act_z, a bias, and a width N that is no multiple
of 4 (padded for the kernels and sliced back). On CPU tensors the port's
'fused' and 'packed' run their kernels' plain versions; the JAX side also
runs its Pallas kernels in interpret mode ('fused:force'/'packed:force')."""
import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import dispatch as rdisp
from repro.models import serving as RSV
from repro_torch.convert import _alias, _to_torch
from repro_torch.kernels import dispatch as tdisp
from repro_torch.kernels import pann_matmul as tpm
from repro_torch.kernels import pann_matmul_packed as tpk
from test_torch_common import (LADDER, ref_cfg, ref_layer_view,
                               reference_store, rung_specs, tonp)

# a width that is no multiple of the kernels' 4 columns (ROADMAP C8)
RAGGED_N = 74
PROJ = [("attn", "wq"), ("attn", "wk"), ("attn", "wo"), ("mlp", "w_gate"),
        ("mlp", "w_down")]


def _x(seed, rows, k, offset=0.0):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((rows, 1, k)) * 1.7 + offset).astype(
        np.float32)


def _pair(bits, layer, parent, name, calib=False):
    _, _, ws, pws = reference_store(calib=calib)
    rp = ref_layer_view(ws.views[bits], layer, parent, name)
    tp = pws.views[bits]["layers"][layer][parent][name]
    return rp, tp


def _check(rp, tp, x, ref_backend="ref", backends=("ref", "fused",
                                                    "packed")):
    want = np.asarray(rdisp.serving_linear(jnp.asarray(x), rp, ref_backend))
    for b in backends:
        got = tdisp.serving_linear(torch.from_numpy(x), tp, b).numpy()
        assert got.dtype == want.dtype and got.shape == want.shape
        assert np.array_equal(got, want), (b, np.max(np.abs(got - want)))


@pytest.mark.parametrize("bits", LADDER)
@pytest.mark.parametrize("layer", [0, 1])
@pytest.mark.parametrize("proj", PROJ)
def test_serving_linear_exact_every_rung(bits, layer, proj):
    rp, tp = _pair(bits, layer, *proj)
    k = tp["w_q"].shape[0]
    _check(rp, tp, _x(bits * 10 + layer, 4, k))
    # activations that do not span zero exercise the zero-extended range
    _check(rp, tp, _x(bits, 3, k, offset=5.0))


@pytest.mark.parametrize("bits", LADDER)
def test_serving_linear_exact_lm_head(bits):
    _, _, ws, pws = reference_store()
    rp = ws.views[bits]["lm_head"]
    tp = pws.views[bits]["lm_head"]
    _check(rp, tp, _x(bits, 4, 64))


@pytest.mark.parametrize("bits", LADDER)
@pytest.mark.parametrize("proj", [("attn", "wq"), ("mlp", "w_down")])
def test_serving_linear_exact_hoisted_act_scalars(bits, proj):
    rp, tp = _pair(bits, 0, *proj, calib=True)
    assert "act_s" in tp and "act_z" in tp
    _check(rp, tp, _x(bits + 7, 4, tp["w_q"].shape[0]))


@pytest.mark.parametrize("bits", LADDER)
def test_serving_linear_exact_with_bias(bits):
    rp, tp = _pair(bits, 1, "attn", "wv")
    n = tp["w_q"].shape[1]
    b = (np.random.default_rng(bits).standard_normal(n) * 0.3).astype(
        np.float32)
    rp = dict(rp, b=jnp.asarray(b))
    tp = dict(tp, b=torch.from_numpy(b))
    _check(rp, tp, _x(bits + 3, 4, tp["w_q"].shape[0]))


@pytest.mark.parametrize("backend", ["fused:force", "packed:force"])
def test_plain_versions_match_reference_pallas_kernels(backend):
    """The JAX package's Pallas kernels (interpret mode) against the
    port's plain versions of the same kernels."""
    bits = LADDER[0]
    rp, tp = _pair(bits, 0, "mlp", "w_up")
    x = _x(11, 4, tp["w_q"].shape[0])
    _check(rp, tp, x, ref_backend=backend,
           backends=(backend.split(":")[0],))


def test_kernel_wrappers_take_plain_path_on_cpu_only():
    _, tp = _pair(LADDER[1], 0, "attn", "wq")
    before = (tpm.launches, tpk.launches)
    tdisp.serving_linear(torch.from_numpy(_x(1, 2, 64)), tp, "packed")
    tdisp.serving_linear(torch.from_numpy(_x(1, 2, 64)), tp, "fused")
    assert (tpm.launches, tpk.launches) == before   # no kernel on CPU


def test_backend_spelling():
    assert tdisp.parse_backend("packed") == "packed"
    for bad in ("packed:force", "fused:force", "pallas"):
        with pytest.raises(ValueError):
            tdisp.parse_backend(bad)
    _, tp = _pair(LADDER[0], 0, "attn", "wq")
    no_planes = {k: v for k, v in tp.items() if not k.startswith("w_planes")}
    with pytest.raises(ValueError):
        tdisp.resolve_backend("packed", no_planes)


@functools.lru_cache(maxsize=None)
def ragged_store(n=RAGGED_N):
    """A (64, n) projection's weight store, built by the JAX package with
    packed planes (numpy store and views) and carried across."""
    cfg = ref_cfg()
    w = (np.random.default_rng(n).standard_normal((64, n)) * 0.1).astype(
        np.float32)
    ws = RSV.build_weight_store({"lm_head": {"w": jnp.asarray(w)}}, cfg,
                                rung_specs(cfg),
                                spec=RSV.ServingQuantSpec(pack_planes=True))
    store = _to_torch(tonp(ws.store), "cpu")
    views = {k: _alias(tonp(v), store, "cpu") for k, v in ws.views.items()}
    return ws, views


@pytest.mark.parametrize("bits", LADDER)
def test_serving_linear_ragged_n_matches_reference(bits, monkeypatch):
    """N = 74 (not a multiple of 4, ROADMAP C8) on every backend, bit for
    bit with the reference's 'ref' and its Pallas kernel in interpret
    mode; 'fused' and 'packed' hand their kernel wrappers N padded to 76
    (what the CUDA wrappers require) and slice the result back, while the
    store's leaves keep N = 74."""
    ws, views = ragged_store()
    rp, tp = ws.views[bits]["lm_head"], views[bits]["lm_head"]
    assert tp["w_planes_pos"].shape[-1] == tp["w_q"].shape[-1] == RAGGED_N
    seen = []
    for mod in (tpm, tpk):
        plain = mod.pann_matmul_act_plain if mod is tpm else \
            mod.pann_matmul_packed_act_plain
        name = "pann_matmul_act" if mod is tpm else "pann_matmul_packed_act"

        def wrapped(x, pos, neg, qp, gamma, zcol, *rest, plain=plain):
            seen.append((pos.shape[-1], gamma.shape[0], zcol.shape[0]))
            return plain(x, pos, neg, qp, gamma, zcol, *rest)

        monkeypatch.setattr(mod, name, wrapped)
    x = _x(bits + 40, 4, 64)
    _check(rp, tp, x)
    _check(rp, tp, x, ref_backend="packed:force", backends=("packed",))
    assert seen and all(s == (76, 76, 76) for s in seen)
