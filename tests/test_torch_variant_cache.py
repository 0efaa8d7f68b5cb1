"""The last reference API outside ``dist/``, held against the JAX package
on the CPU (reduced configs, the reference's params carried across):

* ``models.serving.build_variant_cache``: one single-point artifact per
  rung, leaf for leaf the reference's (codes bit for bit except where
  w / gamma sits at a .5 tie, gamma within an ulp: the tie rule of
  ``test_torch_single_point``); the caller's params left whole; its
  refusals; with ``mesh=`` its leaves DTensors;
* ``variant_shardings``: its specs the reference's, restacked;
* ``materialize_view``: every leaf bit for bit the reference's, and its
  decode bit for bit the view's;
* ``serve_engine.artifact.read_meta``: the reference's result and errors;
* ``core.pann.pann_linear``: both forms within 1e-5 of the reference's,
  the STE gradients too;
* ``ServeEngine(artifact_format=)`` and ``launch.serve --artifact_format``:
  only ``views``, the reference's messages otherwise.
"""
import dataclasses
import functools
import json
import os
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.base import ParallelConfig as RPar
from repro.core import pann as RP
from repro.core import policy as RPOL
from repro.dist import sharding as RSH
from repro.launch import serve as rserve
from repro.models import serving as RSV
from repro.serve_engine import ServeEngine as RServeEngine
from repro.serve_engine import artifact as RA
from repro_torch import convert
from repro_torch.core import pann as TP
from repro_torch.core import policy as TPOL
from repro_torch.dist import sharding as TSH
from repro_torch.launch import serve as tserve
from repro_torch.models import model as TMD
from repro_torch.models import serving as TSV
from repro_torch.serve_engine import ServeEngine as TServeEngine
from repro_torch.serve_engine import artifact as TA
from test_torch_common import LADDER, reference_store, rung_specs, tonp
from test_torch_dense_variants import port_cfg, ref_cfg, reference_params
from test_torch_single_point import _check_artifact, _flat

MESH = types.SimpleNamespace(axis_names=("data", "model"),
                             shape={"data": 4, "model": 2})


def _policy(mod):
    mq = mod.ModuleQuant
    return mod.policy_tree(mq(mode="pann", r=3.1, b_x_tilde=4),
                           {"mlp.w_down": mq(mode="pann", r=7.9,
                                             b_x_tilde=5)})


@functools.lru_cache(maxsize=None)
def _caches(arch):
    """(ref variants, port variants, port params after the call, carried
    fp params) of one cache over the ladder's rungs and a policy rung."""
    rc, tc = ref_cfg(arch), port_cfg(arch)
    np_params = reference_params(arch)
    rungs_r = dict(rung_specs(rc))
    rungs_t = dict(rungs_r)
    rungs_r[99] = _policy(RPOL)
    rungs_t[99] = _policy(TPOL)
    kw = dict(pack_planes=True, plane_count=TSV.LADDER_PLANE_COUNT,
              cache_bits={k: 4 if k != 99 else 3 for k in rungs_r})
    ref = RSV.build_variant_cache(
        jax.tree_util.tree_map(jnp.asarray, np_params), rc, rungs_r, **kw)
    params = convert.params_from_reference(np_params, tc, "cpu")
    own = TSV.build_variant_cache(params, tc, rungs_t, **kw)
    return ref, own, params, convert.params_from_reference(np_params, tc,
                                                            "cpu")


def test_build_variant_cache_matches_reference():
    arch = "llama3-8b"
    ref, own, params, fp = _caches(arch)
    assert sorted(ref) == sorted(own)
    tc = port_cfg(arch)
    for key in ref:
        carried = convert.params_from_reference(tonp(ref[key]), tc, "cpu")
        _check_artifact(carried, own[key], fp)
    # the caller's params are whole: every fp weight still there
    assert _flat(params).keys() == _flat(fp).keys()


def test_build_variant_cache_refusals_match_reference():
    rc, tc = ref_cfg("llama3-8b"), port_cfg("llama3-8b")
    rungs = rung_specs(rc)
    for kw in ({"cache_bits": {2: 4}},
               {"pack_planes": True}):
        with pytest.raises(ValueError) as r:
            RSV.build_variant_cache({}, rc, rungs, **kw)
        with pytest.raises(ValueError) as t:
            TSV.build_variant_cache({}, tc, rungs, **kw)
        assert str(t.value) == str(r.value)


def test_variant_shardings_specs_match_reference():
    ref, own, _, _ = _caches("llama3-8b")
    tc = port_cfg("llama3-8b")
    for key in ref:
        shapes = jax.tree_util.tree_map(
            lambda a: jax.ShapeDtypeStruct(a.shape, a.dtype), ref[key])
        for fsdp in (False, True):
            want = RSH.param_specs(shapes, MESH, RPar(fsdp=fsdp))
            named = TSV.variant_shardings(own[key], MESH,
                                          TSV_PAR(fsdp))
            got = TSH.restack(convert.reference_layout(
                _specs_of(named), tc))
            flat_w = jax.tree_util.tree_flatten_with_path(
                want, is_leaf=lambda x: isinstance(
                    x, jax.sharding.PartitionSpec))[0]
            flat_g = jax.tree_util.tree_flatten_with_path(
                got, is_leaf=lambda x: isinstance(x, TSH.PartitionSpec))[0]
            assert [(jax.tree_util.keystr(p), tuple(v)) for p, v in flat_g] \
                == [(jax.tree_util.keystr(p), tuple(v)) for p, v in flat_w]


def TSV_PAR(fsdp):
    from repro_torch.configs.base import ParallelConfig
    return ParallelConfig(fsdp=fsdp)


def _specs_of(tree):
    if isinstance(tree, TSH.NamedSharding):
        return tree.spec
    if isinstance(tree, dict):
        return {k: _specs_of(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_specs_of(v) for v in tree)
    return tree


def test_build_variant_cache_places_leaves_on_a_mesh(tmp_path):
    import torch.distributed as dist
    from repro_torch.dist import compat
    from repro_torch.launch.mesh import make_local_mesh
    tc = port_cfg("llama3-8b")
    rungs = rung_specs(ref_cfg("llama3-8b"))
    params = TMD.init_params(tc, 0, "cpu")
    plain = TSV.build_variant_cache(params, tc, rungs)
    assert not dist.is_initialized()
    compat.init_process_group("cpu", store_dir=str(tmp_path))
    try:
        mesh = make_local_mesh(1, "cpu")
        placed = TSV.build_variant_cache(params, tc, rungs, mesh=mesh)
        for key in rungs:
            want, got = _flat_t(plain[key]), _flat_t(placed[key])
            assert want.keys() == got.keys()
            for k, v in got.items():
                assert compat.is_dtensor(v), k
                assert torch.equal(compat.full(v), want[k]), k
    finally:
        dist.destroy_process_group()


def _flat_t(tree, trail=""):
    if isinstance(tree, dict):
        return {k2: v2 for k, v in tree.items()
                for k2, v2 in _flat_t(v, f"{trail}/{k}").items()}
    if isinstance(tree, (list, tuple)):
        return {k2: v2 for i, v in enumerate(tree)
                for k2, v2 in _flat_t(v, f"{trail}/{i}").items()}
    return {trail: tree}


# ---------------------------------------------------------------------------
# materialize_view
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("bits", LADDER)
def test_materialize_view_matches_reference(bits):
    cfg, _, ws, pws = reference_store()
    want = _flat(convert.params_from_reference(
        tonp(RSV.materialize_view(ws.views[bits])), port_cfg("llama3-8b"),
        "cpu"))
    got = _flat(TSV.materialize_view(pws.views[bits]))
    assert sorted(got) == sorted(want)
    assert not any(k.endswith("plane_shift") for k in got)
    for k in got:
        assert got[k].dtype == want[k].dtype, k
        assert np.array_equal(got[k], want[k]), k


def test_materialized_view_decodes_as_the_view():
    _, _, ws, pws = reference_store()
    tc = dataclasses.replace(port_cfg("llama3-8b"), kernel_backend="ref",
                             cache_bits=4)
    bits = LADDER[0]
    view = pws.views[bits]
    assert int(view["layers"][0]["attn"]["wq"]["plane_shift"]) > 0
    mat = TSV.materialize_view(view)
    rows = torch.as_tensor(np.random.default_rng(3).integers(
        0, tc.vocab_size, (2, 6)))
    out = []
    for tree in (view, mat):
        state = TMD.init_decode_state(tree, tc, 2, 6)
        steps = []
        for i in range(6):
            lg, state = TMD.decode_step(tree, tc, state, rows[:, i:i + 1])
            steps.append(lg)
        out.append(torch.cat(steps, 1))
    assert torch.equal(out[0], out[1])


# ---------------------------------------------------------------------------
# read_meta, pann_linear, artifact_format
# ---------------------------------------------------------------------------

def test_read_meta_matches_reference(tmp_path):
    _, _, _, pws = reference_store()
    d = str(tmp_path / "art")
    TA.write_artifact(d, pws, port_cfg("llama3-8b"),
                      meta={"arch": "llama3-8b", "rungs": list(LADDER)})
    assert TA.read_meta(d) == RA.read_meta(d) == {
        "arch": "llama3-8b", "rungs": list(LADDER)}
    manifest = os.path.join(d, TA.MANIFEST)
    m = json.load(open(manifest))
    for bad in ({**m, "magic": "other"}, {**m, "version": 2}):
        json.dump(bad, open(manifest, "w"))
        for mod in (TA, RA):
            with pytest.raises(mod.ArtifactError,
                               match="not a loadable serving artifact"):
                mod.read_meta(d)
    open(manifest, "w").write("{")
    for where in (d, str(tmp_path / "none")):   # corrupt, then missing
        msgs = []
        for mod in (TA, RA):
            with pytest.raises(mod.ArtifactError) as e:
                mod.read_meta(where)
            msgs.append(str(e.value))
        assert msgs[0] == msgs[1]


@pytest.mark.parametrize("qat", [False, True])
@pytest.mark.parametrize("axis", [0, 1])
def test_pann_linear_matches_reference(qat, axis):
    rng = np.random.default_rng(5 + axis)
    x = rng.standard_normal((4, 32)).astype(np.float32)
    w = (rng.standard_normal((32, 16)) * 0.2).astype(np.float32)
    b = rng.standard_normal(16).astype(np.float32)

    def ref(x, w):
        return RP.pann_linear(x, w, b, 2.5, 6, axis=axis, qat=qat)

    want = ref(x, w)
    tx = torch.tensor(x, requires_grad=True)
    tw = torch.tensor(w, requires_grad=True)
    got = TP.pann_linear(tx, tw, torch.tensor(b), 2.5, 6, axis=axis,
                         qat=qat)
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               rtol=1e-5, atol=1e-5)
    if qat:     # the STE: identity gradients through both quantizers
        gx, gw = jax.jit(jax.grad(lambda a, c: jnp.sum(ref(a, c) ** 2),
                                  argnums=(0, 1)))(x, w)
        (got ** 2).sum().backward()
        np.testing.assert_allclose(tx.grad.numpy(), np.asarray(gx),
                                   rtol=1e-4, atol=1e-5)
        np.testing.assert_allclose(tw.grad.numpy(), np.asarray(gw),
                                   rtol=1e-4, atol=1e-5)


@pytest.mark.parametrize("fmt", ["legacy", "bogus"])
def test_engine_refuses_artifact_formats_as_reference(fmt):
    rc, tc = ref_cfg("llama3-8b"), port_cfg("llama3-8b")
    with pytest.raises(ValueError) as r:
        RServeEngine(rc, jax.tree_util.tree_map(
            jnp.asarray, reference_params("llama3-8b")), ladder_bits=(2,),
            artifact_format=fmt)
    with pytest.raises(ValueError) as t:
        TServeEngine(tc, TMD.init_params(tc, 0, "cpu"), ladder_bits=(2,),
                     device="cpu", artifact_format=fmt)
    assert str(t.value) == str(r.value)


@pytest.mark.parametrize("fmt", ["legacy", "bogus"])
def test_serve_cli_refuses_artifact_formats_as_reference(fmt):
    argv = ["--reduced", "--artifact_format", fmt]
    with pytest.raises(SystemExit) as r:
        rserve.main(argv)
    with pytest.raises(SystemExit) as t:
        tserve.main(argv + ["--device", "cpu"])
    assert str(t.value) == str(r.value) and "views" in str(t.value)


def test_engine_reports_its_artifact_format():
    tc = port_cfg("llama3-8b")
    eng = TServeEngine(tc, TMD.init_params(tc, 0, "cpu"), ladder_bits=(2,),
                       max_batch=1, max_len=8, device="cpu",
                       artifact_format="views")
    assert eng.artifact_format == "views"
    assert eng.describe()["artifact_format"] == "views"
