"""``repro_torch.dist.sharding`` and ``dist.constrain``'s rules against the
JAX package's, spec for spec, on abstract meshes (objects with
``axis_names`` and a ``shape`` mapping, as the reference's own tests use):
{"data": 4, "model": 2} and {"pod": 2, "data": 16, "model": 16}.

The port keeps one dict per layer where the reference stacks a layer
group along a leading axis, so the port's specs are restacked
(``convert.reference_layout``, then ``sharding.restack``: the stack dim
leads, unsharded) before they are compared. Shapes come from the
reference's ``jax.eval_shape`` and the port's "meta" tensors, for every
one of the 10 architectures at ``configs.reduced`` size. Exact equality
throughout (the rules are integer arithmetic).
"""
import functools
import types

import jax
import jax.numpy as jnp
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st

from repro import configs as rconfigs
from repro.configs.base import ParallelConfig as RPar
from repro.dist import constrain as RC
from repro.dist import sharding as RSH
from repro.models import model as RMD
from repro_torch import configs as tconfigs
from repro_torch import convert
from repro_torch.configs.base import ParallelConfig as TPar
from repro_torch.dist import constrain as TC
from repro_torch.dist import sharding as TSH
from repro_torch.models import model as TMD
from repro_torch.models import transformer as TT

MESHES = {
    "4x2": types.SimpleNamespace(axis_names=("data", "model"),
                                 shape={"data": 4, "model": 2}),
    "2x16x16": types.SimpleNamespace(axis_names=("pod", "data", "model"),
                                     shape={"pod": 2, "data": 16,
                                            "model": 16}),
}
ARCHS = rconfigs.ARCH_NAMES
BATCH, MAX_LEN = 8, 16   # MAX_LEN within the reduced local window


def _cfgs(arch):
    return (rconfigs.reduced(rconfigs.get_config(arch)),
            tconfigs.reduced(tconfigs.get_config(arch)))


@functools.lru_cache(maxsize=None)
def _ref_param_shapes(arch):
    rcfg, _ = _cfgs(arch)
    return jax.eval_shape(lambda: RMD.init_params(jax.random.PRNGKey(0),
                                                  rcfg))


def _leaves(tree, spec_type):
    """(path, entries) of every spec leaf, in the tree's order."""
    flat, _ = jax.tree_util.tree_flatten_with_path(
        tree, is_leaf=lambda x: isinstance(x, spec_type))
    return [(jax.tree_util.keystr(p), tuple(v)) for p, v in flat]


def test_the_port_has_every_architecture():
    assert tuple(tconfigs.ARCH_NAMES) == tuple(ARCHS) and len(ARCHS) == 10


@pytest.mark.parametrize("fsdp", [False, True], ids=["tp", "fsdp"])
@pytest.mark.parametrize("mesh", list(MESHES))
@pytest.mark.parametrize("arch", ARCHS)
def test_param_specs_match_reference(arch, mesh, fsdp):
    m = MESHES[mesh]
    _, tcfg = _cfgs(arch)
    want = RSH.param_specs(_ref_param_shapes(arch), m, RPar(fsdp=fsdp))
    got = TSH.param_specs(TMD.init_params(tcfg, 0, "meta"), m,
                          TPar(fsdp=fsdp))
    got = TSH.restack(convert.reference_layout(got, tcfg))
    assert _leaves(got, TSH.PartitionSpec) == _leaves(
        want, jax.sharding.PartitionSpec)


def _ref_caches(arch):
    rcfg, _ = _cfgs(arch)
    kw = {}
    if rcfg.family == "encdec":
        kw["enc_inputs"] = jax.ShapeDtypeStruct(
            (BATCH, rcfg.encoder_seq_len, rcfg.d_model), jnp.float32)
    if rcfg.family == "vlm":
        kw["image_embeds"] = jax.ShapeDtypeStruct(
            (BATCH, rcfg.num_image_tokens, rcfg.d_model), jnp.float32)
    state = jax.eval_shape(
        lambda p, **k: RMD.init_decode_state(p, rcfg, BATCH, MAX_LEN, **k),
        _ref_param_shapes(arch), **kw)
    return state


@pytest.mark.parametrize("mesh", list(MESHES))
@pytest.mark.parametrize("arch", ARCHS)
def test_cache_specs_match_reference(arch, mesh):
    """The decode state's caches and position: the port's one cache per
    layer restacked per group position (stack dim leading, unsharded),
    then the tail layers, against the reference's stacked caches."""
    m = MESHES[mesh]
    _, tcfg = _cfgs(arch)
    ref = _ref_caches(arch)
    want = RSH.cache_specs({"caches": ref.caches,
                            "position": ref.position}, m)
    specs = TMD.layer_specs(tcfg)
    caches = [TT.init_layer_cache(tcfg, s, BATCH, MAX_LEN,
                                  TMD._dtype(tcfg), "meta") for s in specs]
    got = TSH.cache_specs({"caches": caches,
                           "position": torch.zeros((), dtype=torch.int32)},
                          m)
    pattern, n_groups, _ = TT.group_layout(tcfg)
    per_layer = [jax.tree_util.tree_leaves(
        c, is_leaf=lambda x: isinstance(x, TSH.PartitionSpec))
        for c in got["caches"]]
    grouped = n_groups * len(pattern)
    port = []
    for i in range(len(pattern) if n_groups else 0):
        layers = per_layer[i:grouped:len(pattern)]
        for leaf in zip(*layers):
            assert all(s == leaf[0] for s in leaf)
            port.append((None,) + tuple(leaf[0]))
    for layer in per_layer[grouped:]:
        port.extend(tuple(s) for s in layer)
    port.append(tuple(got["position"]))
    ref_leaves = [v for _, v in _leaves(
        {"caches": want["caches"], "position": want["position"]},
        jax.sharding.PartitionSpec)]
    assert port == ref_leaves


@pytest.mark.parametrize("cache_bits", [None, 4])
@pytest.mark.parametrize("mesh", list(MESHES))
def test_slot_specs_keep_a_ring_on_whole_kv_heads(mesh, cache_bits):
    """A windowed layer's ring (gemma2-smoke's local layers at max_len 40:
    16 rows) takes the specs a cache of max_len rows takes: the batch on
    "data", whole KV heads on "model", the rows whole (C14)."""
    import dataclasses
    from repro_torch.models import attention as TA
    m = MESHES[mesh]
    _, tcfg = _cfgs("gemma2-9b")
    cfg = dataclasses.replace(tcfg, cache_bits=cache_bits)
    specs = TMD.layer_specs(cfg)
    dtype = TMD._dtype(cfg)
    rings = [TT.init_layer_cache(cfg, s, BATCH, 40, dtype, "meta")
             for s in specs]
    fulls = [TA.init_cache(cfg, BATCH, 40, dtype, "meta") for _ in specs]
    rows = [(c.k_s if cache_bits else c.k).shape[1] for c in rings]
    assert rows == [16 if s.window else 40 for s in specs] and 16 in rows
    assert TSH.slot_specs(rings, m) == TSH.slot_specs(fulls, m)


@pytest.mark.parametrize("mesh", list(MESHES))
def test_input_sharding_and_batch_axis_match_reference(mesh):
    m = MESHES[mesh]
    for b in (1, 2, 3, 4, 6, 8, 16, 24, 32, 64, 512):
        for rest in ((), (16,), (16, 64)):
            shape = (b,) + rest
            assert tuple(TSH.input_sharding(m, shape)) == tuple(
                RSH.input_sharding(m, shape)), shape
        assert TC.batch_axis(m, b) == RC.batch_axis(m, b), b
    assert tuple(TSH.input_sharding(m, ())) == tuple(
        RSH.input_sharding(m, ()))


@pytest.mark.parametrize("mesh", list(MESHES))
def test_dp_model_plan_and_greedy_spec_match_reference(mesh, monkeypatch):
    m = MESHES[mesh]
    monkeypatch.setattr(RC, "_context_mesh", lambda: m)
    sizes = (1, 2, 3, 4, 8, 16, 32, 48, 64, 100, 512)
    with TC.use_mesh(m):
        for b in sizes:
            for s in sizes:
                assert TC.dp_model_plan(b, s) == RC.dp_model_plan(b, s), \
                    (b, s)
    assert TC.dp_model_plan(4, 16) == (None, None)    # no ambient mesh
    for dims in ((8, 16), (3, 16, 64), (16, 16), (5, 7), (32, 2, 512)):
        assert tuple(TSH.greedy_spec(dims, m)) == tuple(
            RSH.greedy_spec(dims, m)), dims


_NAMES = ["wq", "wo", "w_up", "w_down", "router", "table", "norm", "b",
          "scale", "w_q", "w_planes_pos", "other"]


@settings(max_examples=20, deadline=None)
@given(parent=st.sampled_from(_NAMES), leaf=st.sampled_from(_NAMES),
       dims=st.lists(st.sampled_from([1, 2, 3, 4, 8, 16, 32, 48]),
                     min_size=0, max_size=3),
       fsdp=st.booleans(), mesh=st.sampled_from(sorted(MESHES)))
def test_param_spec_invariants_and_parity(parent, leaf, dims, fsdp, mesh):
    """Any leaf under any parent: an axis at most once, every assigned dim
    divisible by its axis, and the reference's spec."""
    m = MESHES[mesh]
    shape = tuple(dims)
    got = TSH.param_specs({parent: {leaf: types.SimpleNamespace(
        shape=shape)}}, m, TPar(fsdp=fsdp))[parent][leaf]
    want = RSH.param_specs({parent: {leaf: jax.ShapeDtypeStruct(
        shape, jnp.float32)}}, m, RPar(fsdp=fsdp))[parent][leaf]
    assert tuple(got) == tuple(want)
    named = [e for e in got if e is not None]
    assert len(named) == len(set(named))
    for d, e in zip(shape, got):
        if e is not None:
            assert d % m.shape[e] == 0


def test_named_sharding_placements_follow_the_spec():
    from repro_torch.dist.compat import Replicate, Shard
    m = types.SimpleNamespace(mesh_dim_names=("pod", "data", "model"),
                              shape=(2, 2, 2))
    ns = TSH.NamedSharding(m, TSH.P(("pod", "data"), None, "model"))
    assert ns.placements == [Shard(0), Shard(0), Shard(2)]
    assert TSH.NamedSharding(m, TSH.P()).placements == [Replicate()] * 3
