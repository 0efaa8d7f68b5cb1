"""The v1 serving artifact across the two packages on reduced llama3-8b,
reduced mixtral-8x7b (fp32 router and experts beside the packed
projections), reduced seamless-m4t-medium (an encoder stack, the conv
stem, cross-attention and its gate) and reduced llama-3.2-vision-90b:
the port loads what the JAX package writes and the JAX package loads what
the port writes (``repro_torch.serve_engine.artifact`` against
``repro.serve_engine.artifact``), and each serves the other's store.

Tolerance: leaves are byte-identical and the port's logits on a loaded
store are bit-identical to the same store carried across in memory
(``convert.weight_store_from_reference``); against the JAX package's
logits, ``test_torch_slice``'s 1e-5 * max|logit| bound.
"""
import dataclasses
import json
import os
import shutil

import jax
import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st

from repro.serve_engine import Request as RRequest
from repro.serve_engine import ServeEngine as RServeEngine
from repro.serve_engine import artifact as RA
from repro_torch.models import model as TMD
from repro_torch.models import serving as TSV
from repro_torch.serve_engine import artifact as TA
from test_torch_common import (LADDER, port_cfg, ref_cfg, reference_store,
                               tonp)
from test_torch_common import one_torch_thread  # noqa: F401
from test_torch_encoder import ARCHS as ENC_ARCHS
from test_torch_encoder import frontend_key, raw_input
from test_torch_encoder import port_cfg as enc_port_cfg
from test_torch_encoder import reference_store as enc_reference_store
from test_torch_moe import _port_decode as moe_port_decode
from test_torch_moe import port_cfg as moe_port_cfg
from test_torch_moe import ref_cfg as moe_ref_cfg
from test_torch_moe import reference_store as moe_reference_store
from test_torch_slice import REL_BOUND, ref_logits

STEPS = 6
MOE = "mixtral-8x7b"


@pytest.fixture(scope="module")
def ref_written(tmp_path_factory):
    """A store built and written by the JAX package."""
    d = str(tmp_path_factory.mktemp("ref_artifact"))
    RA.write_artifact(d, reference_store()[2], meta={"arch": "llama3-8b"})
    return d


def _logits(views, bits, rows, backend="packed"):
    cfg = dataclasses.replace(port_cfg(), kernel_backend=backend,
                              cache_bits=4)
    st = TMD.init_decode_state(views[bits], cfg, rows.shape[0],
                               rows.shape[1])
    out = []
    for t in range(rows.shape[1]):
        lg, st = TMD.decode_step(views[bits], cfg, st,
                                 torch.from_numpy(rows[:, t:t + 1]).long())
        out.append(lg[:, 0])
    return torch.stack(out)


def _flat(tree):
    return dict(TA._flatten(tree))


@pytest.mark.parametrize("bits", LADDER)
def test_reference_artifact_serves_in_port(ref_written, bits):
    got = TA.load_artifact(ref_written, device="cpu")
    carried = reference_store()[3]
    assert sorted(got.views) == sorted(carried.views)
    a, b = _flat(got.views[bits]), _flat(carried.views[bits])
    assert a.keys() == b.keys()
    for k in a:
        assert a[k].dtype == b[k].dtype and torch.equal(a[k], b[k]), k
    rows = np.random.default_rng(bits).integers(0, 512, (2, STEPS)).astype(
        np.int32)
    for backend in ("ref", "packed"):
        assert torch.equal(_logits(got.views, bits, rows, backend),
                           _logits(carried.views, bits, rows, backend))
    want = ref_logits(bits, 4, rows)
    have = _logits(got.views, bits, rows).numpy()
    bound = REL_BOUND * np.max(np.abs(want), axis=-1, keepdims=True)
    assert np.all(np.abs(have - want) <= bound)


def test_ref_leaves_alias_the_store(ref_written):
    """A view leaf the manifest marks ``ref`` is the store's own tensor;
    every other view leaf is the view's own."""
    got = TA.load_artifact(ref_written, device="cpu")
    man = json.load(open(os.path.join(ref_written, TA.MANIFEST)))
    for v in man["views"]:
        for path, ent in v["leaves"].items():
            assert ("ref" in ent) == (path in man["store"]), path
    store_t = _flat(got.store)
    n_ref = 0
    for leaves in map(_flat, got.views.values()):
        for path, t in leaves.items():
            if path in store_t:
                assert t is store_t[path]
                assert t.data_ptr() == store_t[path].data_ptr()
                n_ref += 1
            else:
                assert all(t.data_ptr() != s.data_ptr()
                           for s in store_t.values())
    assert n_ref > 0


def test_port_artifact_loads_in_reference(tmp_path):
    """A store the port writes is byte-identical, leaf for leaf, in the
    JAX package's loader, and the JAX package's engine serves it with the
    tokens it serves from its own store."""
    _, _, ws, pws = reference_store()
    d = TA.write_artifact(str(tmp_path / "port"), pws, port_cfg(),
                          meta={"from": "port"})
    loaded = RA.load_artifact(d)
    assert RA.read_meta(d) == {"from": "port"}
    flat = jax.tree_util.tree_leaves_with_path
    for mine, theirs in [(loaded.store, ws.store)] + [
            (loaded.views[k], ws.views[k]) for k in LADDER]:
        a, b = flat(tonp(mine)), flat(tonp(theirs))
        assert [p for p, _ in a] == [p for p, _ in b]
        for (p, x), (_, y) in zip(a, b):
            assert x.dtype == y.dtype and x.shape == y.shape, p
            assert x.tobytes() == y.tobytes(), p
    kw = dict(ladder_bits=LADDER, max_batch=2, max_len=12, cache_bits=4,
              backend="ref")
    rng = np.random.default_rng(9)
    reqs = [dict(uid=i, prompt=rng.integers(0, 512, 5).astype(np.int32),
                 max_new_tokens=4, power_budget_bits=b)
            for i, b in enumerate((2, 6, 4))]
    want = RServeEngine(ref_cfg(), weight_store=ws, **kw).generate(
        [RRequest(**r) for r in reqs])
    got = RServeEngine(ref_cfg(), weight_store=loaded, **kw).generate(
        [RRequest(**r) for r in reqs])
    assert [r.tokens for r in got] == [r.tokens for r in want]


@pytest.fixture(scope="module")
def moe_written(tmp_path_factory):
    """A reduced mixtral store (fp32 router and experts beside the packed
    attention and head) written by the JAX package."""
    d = str(tmp_path_factory.mktemp("moe_artifact"))
    RA.write_artifact(d, moe_reference_store(MOE)[0],
                      meta={"arch": "mixtral-8x7b"})
    return d


def _moe_rows(bits):
    return np.random.default_rng(bits).integers(0, 512, (2, STEPS)).astype(
        np.int32)


def test_moe_reference_artifact_serves_in_port(moe_written):
    """The JAX package's MoE artifact, loaded by the port: every leaf equal
    to the store carried across in memory, the experts and the router the
    store's own tensors in every view, and every rung's logits bit-identical
    to the carried store's on 'ref' and 'packed'."""
    got = TA.load_artifact(moe_written, device="cpu")
    carried = moe_reference_store(MOE)[1]
    store = _flat(got.store)
    experts = [k for k in store if "/moe/" in k]
    assert len(experts) == 4 * moe_port_cfg(MOE).num_layers
    assert all(store[k].dtype == torch.float32 for k in experts)
    for bits in LADDER:
        a, b = _flat(got.views[bits]), _flat(carried.views[bits])
        assert a.keys() == b.keys()
        for k in a:
            assert a[k].dtype == b[k].dtype and torch.equal(a[k], b[k]), k
        for k in experts:
            assert a[k] is store[k]
        for backend in ("ref", "packed"):
            cfg = dataclasses.replace(moe_port_cfg(MOE),
                                      kernel_backend=backend, cache_bits=4)
            assert np.array_equal(
                moe_port_decode(got.views[bits], cfg, _moe_rows(bits)),
                moe_port_decode(carried.views[bits], cfg, _moe_rows(bits)))


def test_moe_port_artifact_loads_in_reference(tmp_path):
    """A MoE store the port writes is byte-identical, leaf for leaf, in the
    JAX package's loader (experts restacked to (G, E, d, ff)), and the JAX
    package's engine serves it with the tokens of its own store."""
    ws, pws = moe_reference_store(MOE)
    d = TA.write_artifact(str(tmp_path / "port_moe"), pws, moe_port_cfg(MOE))
    loaded = RA.load_artifact(d)
    flat = jax.tree_util.tree_leaves_with_path
    for mine, theirs in [(loaded.store, ws.store)] + [
            (loaded.views[k], ws.views[k]) for k in LADDER]:
        a, b = flat(tonp(mine)), flat(tonp(theirs))
        assert [p for p, _ in a] == [p for p, _ in b]
        for (p, x), (_, y) in zip(a, b):
            assert x.dtype == y.dtype and x.shape == y.shape, p
            assert x.tobytes() == y.tobytes(), p
    kw = dict(ladder_bits=LADDER, max_batch=2, max_len=12, cache_bits=4,
              backend="ref")
    rng = np.random.default_rng(10)
    reqs = [dict(uid=i, prompt=rng.integers(0, 512, 5).astype(np.int32),
                 max_new_tokens=4, power_budget_bits=b)
            for i, b in enumerate((2, 6, 4))]
    cfg = moe_ref_cfg(MOE)
    want = RServeEngine(cfg, weight_store=ws, **kw).generate(
        [RRequest(**r) for r in reqs])
    got = RServeEngine(cfg, weight_store=loaded, **kw).generate(
        [RRequest(**r) for r in reqs])
    assert [r.tokens for r in got] == [r.tokens for r in want]


@pytest.mark.parametrize("arch", ENC_ARCHS)
def test_encoder_artifacts_cross_packages(arch, tmp_path):
    """The cross-attending configs both ways: the JAX package's artifact
    loaded by the port equals the store carried across in memory, leaf
    for leaf (the encoder's layers, ``enc_norm``, the conv stem, every
    ``xattn`` and ``xgate``), and serves bit-identical logits from raw
    frontend input at the bottom and top rungs; the port's artifact is
    byte-identical, leaf for leaf, in the JAX package's loader."""
    ws, pws = enc_reference_store(arch)
    d = str(tmp_path / "ref")
    RA.write_artifact(d, ws, meta={"arch": arch})
    got = TA.load_artifact(d, device="cpu")
    store = _flat(got.store)
    assert any(k.startswith("conv_stem/") for k in store)
    assert any("/xattn/" in k for k in store)
    assert any("xgate" in k for k in store)
    cfg = enc_port_cfg(arch, kernel_backend="packed", cache_bits=4)
    assert any(k.startswith("encoder/") for k in store) == bool(
        cfg.encoder_layers)
    fe = {frontend_key(cfg): torch.from_numpy(raw_input(arch))}
    rows = torch.from_numpy(np.random.default_rng(3).integers(
        0, 512, (2, 3))).long()
    for bits in LADDER:
        a, b = _flat(got.views[bits]), _flat(pws.views[bits])
        assert a.keys() == b.keys()
        for k in a:
            assert a[k].dtype == b[k].dtype and torch.equal(a[k], b[k]), k
    for bits in (LADDER[0], LADDER[-1]):
        logits = []
        for views in (got.views, pws.views):
            st = TMD.init_decode_state(views[bits], cfg, 2, 3, **fe)
            for t in range(3):
                lg, st = TMD.decode_step(views[bits], cfg, st,
                                         rows[:, t:t + 1])
            logits.append(lg)
        assert torch.equal(logits[0], logits[1])
    d2 = TA.write_artifact(str(tmp_path / "port"), pws, enc_port_cfg(arch))
    loaded = RA.load_artifact(d2)
    flat = jax.tree_util.tree_leaves_with_path
    for mine, theirs in [(loaded.store, ws.store)] + [
            (loaded.views[k], ws.views[k]) for k in LADDER]:
        a, b = flat(tonp(mine)), flat(tonp(theirs))
        assert [p for p, _ in a] == [p for p, _ in b]
        for (p, x), (_, y) in zip(a, b):
            assert x.dtype == y.dtype and x.shape == y.shape, p
            assert x.tobytes() == y.tobytes(), p


def test_port_round_trip_keeps_every_leaf(tmp_path):
    """A store the port builds itself (bf16 embedding included) survives
    its own write and load bit for bit, refs and all."""
    cfg = dataclasses.replace(port_cfg(), kernel_backend="packed",
                              cache_bits=4)
    params = TMD.init_params(cfg, seed=2, device="cpu")
    params["embed"]["table"] = params["embed"]["table"].to(torch.bfloat16)
    specs = {op.bits: (op.r, op.b_x_tilde) for op in _ladder(cfg)}
    ws = TSV.build_weight_store(params, cfg, specs, TSV.ServingQuantSpec(
        pack_planes=True, cache_bits=4))
    d = TA.write_artifact(str(tmp_path / "rt"), ws, cfg)
    man = json.load(open(os.path.join(d, TA.MANIFEST)))
    assert man["store"]["embed/table"]["dtype"] == "bfloat16"
    got = TA.load_artifact(d, device="cpu")
    for mine, theirs in [(got.store, ws.store)] + [
            (got.views[k], ws.views[k]) for k in specs]:
        a, b = _flat(mine), _flat(theirs)
        assert a.keys() == b.keys()
        for k in a:
            assert a[k].dtype == b[k].dtype and torch.equal(a[k], b[k]), k
    # the JAX package reads the bf16 leaf by its name, too
    assert str(RA.load_artifact(d).store["embed"]["table"].dtype) == \
        "bfloat16"


def _random_leaf(rng, dtype_name, shape):
    """A tensor of random bytes (NaNs and all) of a manifest dtype."""
    dtype, carrier = TA._DTYPES[dtype_name]
    n = int(np.prod(shape, dtype=np.int64)) * np.dtype(carrier).itemsize
    raw = rng.integers(0, 256, n, dtype=np.uint8)
    if dtype_name == "bool":
        raw &= 1
    return torch.from_numpy(raw.view(carrier).reshape(shape)).view(dtype)


def _bytes(t):
    return TA._host_bytes(t)


@settings(max_examples=20, deadline=None)
@given(st.lists(st.sampled_from(sorted(TA._DTYPES)), min_size=1, max_size=4),
       st.lists(st.integers(0, 5), min_size=0, max_size=3),
       st.integers(0, 2 ** 31 - 1))
def test_any_dtype_and_shape_round_trips(dtype_names, shape, seed):
    """Every dtype the manifest names, at any shape (0-d included), in the
    stacked layers, at the top level and in a view: written and loaded
    back byte for byte, refs aliasing and own leaves not."""
    import tempfile
    rng = np.random.default_rng(seed)
    shape = tuple(shape)
    layers = [{"m": {f"x{i}": _random_leaf(rng, name, shape)
                     for i, name in enumerate(dtype_names)}}
              for _ in range(port_cfg().num_layers)]
    store = {"layers": layers,
             "top": {name: _random_leaf(rng, name, shape[::-1])
                     for name in dtype_names}}
    own = {name: _random_leaf(rng, name, shape) for name in dtype_names}
    views = {3: {"layers": [{"m": dict(lp["m"], own=own[dtype_names[0]])}
                            for lp in layers], "top": store["top"]}}
    ws = TSV.WeightStore(store=store, views=views)
    with tempfile.TemporaryDirectory() as d:
        TA.write_artifact(d, ws, port_cfg())
        got = TA.load_artifact(d, device="cpu")
        assert list(got.views) == [3]
        for mine, theirs in ((got.store, store), (got.views[3], views[3])):
            a, b = _flat(mine), _flat(theirs)
            assert a.keys() == b.keys()
            for k in a:
                assert a[k].dtype == b[k].dtype
                assert a[k].shape == b[k].shape
                assert _bytes(a[k]) == _bytes(b[k]), k
        store_t, view_t = _flat(got.store), _flat(got.views[3])
        for k, t in view_t.items():
            assert (t is store_t[k]) if k in store_t else \
                k.endswith("/own")


def _ladder(cfg):
    from repro_torch.serve_engine import build_ladder
    return build_ladder(LADDER, d=float(cfg.d_model))


def _copy(src, dst):
    shutil.copytree(src, dst)
    return dst


def _edit_manifest(d, fn):
    path = os.path.join(d, TA.MANIFEST)
    man = json.load(open(path))
    fn(man)
    json.dump(man, open(path, "w"))


def _skew(d):
    _edit_manifest(d, lambda m: m.update(version=TA.ARTIFACT_VERSION + 1))


def _magic(d):
    _edit_manifest(d, lambda m: m.update(magic="not-a-weight-store"))


def _truncate(d):
    path = os.path.join(d, TA.BLOB)
    data = open(path, "rb").read()
    open(path, "wb").write(data[:len(data) // 2])


def _no_manifest(d):
    os.unlink(os.path.join(d, TA.MANIFEST))


def _out_of_bounds(d):
    def move(m):
        ent = m["store"]["lm_head/w_q"]
        ent["offset"] = m["blob_bytes"] - ent["nbytes"] // 2
    _edit_manifest(d, move)


@pytest.mark.parametrize("corrupt,match", [
    (_skew, "version"), (_magic, "magic"), (_truncate, "size"),
    (_no_manifest, "manifest"), (_out_of_bounds, "outside")])
def test_corrupt_artifacts_raise(ref_written, tmp_path, corrupt, match):
    d = _copy(ref_written, str(tmp_path / "bad"))
    corrupt(d)
    with pytest.raises(TA.ArtifactError, match=match):
        TA.load_artifact(d, device="cpu")
    # the JAX package refuses the same directories
    with pytest.raises(RA.ArtifactError):
        RA.load_artifact(d)
