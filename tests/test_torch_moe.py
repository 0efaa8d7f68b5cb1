"""The MoE decoders of the port (mixtral-8x7b, dbrx-132b) against the JAX
package on the CPU: ``router_topk`` (hand-made ties included), ``route``,
``expert_ffn`` at modes 'none', 'ruq' and 'pann', ``apply_moe``, ``forward``
and teacher-forced ``decode_step`` (fp params and every rung's view of a
weight store), the single-point artifact and the weight store leaf for
leaf, the ladder engine (ladder, rung trees, energy ledgers, tokens) at
``allocation`` 'uniform' and 'layerwise', and the CLI.

Cases: reduced mixtral and reduced dbrx (both E = 4, k = 2, as the
reference's ``reduced``) and ``dbrx-top4``, reduced dbrx with
``MoEConfig(8, 4)`` on both sides (the top-4 softmax order).

Tolerances: router gates within 1e-6 * max|gate|; projections and
``apply_moe`` within 1e-6 * max|y|; logits of ``forward`` and decode
within 1e-5 * max|logit| (2e-2 where an activation code flipped between
the two sides, the flips counted and held to 1 in 10^4, as
``test_torch_forward``); ``aux_loss`` within 1e-6 relative. Selected
experts must be identical for every token, under a guard: for each token
the gap between its k-th and (k+1)-th router logit must exceed the largest
difference between the two sides' router logits, so a different
selection can only come from a fault, never from rounding.
"""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as rconfigs
from repro.configs.base import MoEConfig as RMoEConfig
from repro.configs.base import QuantConfig as RQuantConfig
from repro.core import quant as RQ
from repro.models import mlp as RM
from repro.models import model as RMD
from repro.models import serving as RSV
from repro.serve_engine import Request as RRequest
from repro.serve_engine import ServeEngine as RServeEngine
from repro_torch import configs as tconfigs
from repro_torch.configs.base import MoEConfig as TMoEConfig
from repro_torch.configs.base import QuantConfig as TQuantConfig
from repro_torch.convert import (params_from_reference, reference_layout,
                                 weight_store_from_reference)
from repro_torch.core import costs as tcosts
from repro_torch.core import quant as TQ
from repro_torch.launch import serve as tserve
from repro_torch.models import mlp as TM
from repro_torch.models import model as TMD
from repro_torch.models import serving as TSV
from repro_torch.serve_engine import Request as TRequest
from repro_torch.serve_engine import ServeEngine as TServeEngine
from repro_torch.serve_engine import build_ladder as t_build_ladder
from test_torch_common import LADDER, rung_specs, tonp
from test_torch_common import one_torch_thread  # noqa: F401
from test_torch_dense_variants import _np_leaves, _perturb
from test_torch_forward import _capture
from test_torch_layerwise import _tree
from test_torch_single_point import _check_artifact
from test_torch_slice import _margin

ARCHS = ("mixtral-8x7b", "dbrx-132b")
CASES = ARCHS + ("dbrx-top4",)
GATE_REL = 1e-6
Y_REL = 1e-6
LOGIT_REL = 1e-5
FLIP_REL = 2e-2
MAX_FLIP_SHARE = 1e-4
AUX_REL = 1e-6
VOCAB = 512
STEPS = 8                # teacher-forced tokens; mixtral's reduced window 16
PANN = dict(mode="pann", r=2.83, act_bits_tilde=4)


def ref_cfg(case):
    arch = "dbrx-132b" if case == "dbrx-top4" else case
    cfg = rconfigs.reduced(rconfigs.get_config(arch))
    if case == "dbrx-top4":
        cfg = dataclasses.replace(cfg, moe=RMoEConfig(8, 4))
    return cfg


def port_cfg(case):
    arch = "dbrx-132b" if case == "dbrx-top4" else case
    cfg = tconfigs.reduced(tconfigs.get_config(arch))
    if case == "dbrx-top4":
        cfg = dataclasses.replace(cfg, moe=TMoEConfig(8, 4))
    return cfg


@functools.lru_cache(maxsize=None)
def reference_params(case, seed=0):
    """The reference's params (numpy), norm scales and biases perturbed
    away from their init's zeros and ones."""
    params = RMD.init_params(jax.random.PRNGKey(seed), ref_cfg(case))
    return _perturb(tonp(params), np.random.default_rng(seed + 17))


def _moe_params(case, layer=0):
    """Layer ``layer``'s MoE block of the reference params (numpy)."""
    node = reference_params(case)["decoder"]["groups"]["layers"][0]["moe"]
    return jax.tree_util.tree_map(lambda a: np.asarray(a)[layer], node)


def _x(shape, seed):
    return np.random.default_rng(seed).standard_normal(shape).astype(
        np.float32)


def _jnp(tree):
    return jax.tree_util.tree_map(jnp.asarray, tree)


def _torch(tree):
    return jax.tree_util.tree_map(lambda a: torch.from_numpy(np.array(a)),
                                  tree)


def _close(got, want, rel):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=rel * np.abs(want).max())


def _same_experts(ref_routes, port_routes):
    """Every router call of both sides selected the same experts, under the
    top-k margin guard. Returns the number of routed tokens."""
    assert len(ref_routes) == len(port_routes) > 0
    tokens = 0
    for (rl, rm, k), (pl, pm, pk) in zip(ref_routes, port_routes):
        assert k == pk and rl.shape == pl.shape
        diff = float(np.abs(rl - pl).max())
        top = -np.sort(-rl, axis=-1)
        gap = top[..., k - 1] - top[..., k]
        assert (gap > diff).all(), (
            f"top-{k} margin {gap.min()} <= router logit difference {diff}")
        assert np.array_equal(rm, pm)
        tokens += rm[..., 0].size
    return tokens


def _record_routes(monkeypatch, module, log):
    """Record (fp32 logits, mask, k) of every ``router_topk`` call."""
    orig = module.router_topk

    def wrapped(logits, top_k):
        gates, mask = orig(logits, top_k)
        log.append((np.array(logits), np.array(mask), top_k))
        return gates, mask

    monkeypatch.setattr(module, "router_topk", wrapped)


# ---------------------------------------------------------------------------
# unit functions
# ---------------------------------------------------------------------------

# hand-made ties over 8 experts: a three-way tie at the top, all equal,
# ties straddling the k-th place, equal ends
TIES = np.array([[1, 3, 3, 0, 3, -1, 2, 2],
                 [2, 2, 2, 2, 2, 2, 2, 2],
                 [0, 5, 1, 5, 1, 5, 1, 0],
                 [4, 1, 1, 1, 1, 1, 1, 4],
                 [0, -2, 7, 7, -2, 7, 7, -2]], np.float32)[None]


@pytest.mark.parametrize("e,k,ties", [(4, 2, False), (8, 4, False),
                                      (16, 4, False), (8, 2, True),
                                      (8, 4, True)])
def test_router_topk_matches_reference(e, k, ties):
    logits = TIES if ties else _x((3, 5, e), e + k)
    rg, rm = RM.router_topk(jnp.asarray(logits), k)
    tg, tm = TM.router_topk(torch.from_numpy(logits), k)
    assert np.array_equal(tm.numpy(), np.asarray(rm))
    _close(tg.numpy(), rg, GATE_REL)
    assert (tm.sum(-1) == k).all()
    if ties:
        # ties go to the lowest index, as jax.lax.top_k orders them
        order = np.lexsort((np.arange(8)[None, None].repeat(5, 1),
                            -logits), axis=-1)[..., :k]
        want = np.zeros_like(logits, dtype=bool)
        np.put_along_axis(want, order, True, axis=-1)
        assert np.array_equal(tm.numpy(), want)


@pytest.mark.parametrize("mode", ["none", "pann"])
@pytest.mark.parametrize("case", CASES)
def test_route_matches_reference(case, mode, monkeypatch):
    qc = PANN if mode == "pann" else dict(mode="none")
    rc = dataclasses.replace(ref_cfg(case), quant=RQuantConfig(**qc))
    tc = dataclasses.replace(port_cfg(case), quant=TQuantConfig(**qc))
    p = _moe_params(case)
    x = _x((2, 6, rc.d_model), 3)
    ref_codes, port_codes, ref_routes, port_routes = [], [], [], []
    _capture(monkeypatch, RQ, ref_codes)
    _capture(monkeypatch, TQ, port_codes)
    _record_routes(monkeypatch, RM, ref_routes)
    _record_routes(monkeypatch, TM, port_routes)
    with jax.disable_jit():
        rg, rmask, raux = RM.route(jnp.asarray(x), _jnp(p), rc)
    tg, tmask, taux = TM.route(torch.from_numpy(x), _torch(p), tc)
    assert all(np.array_equal(a, b) for a, b in zip(ref_codes, port_codes))
    _same_experts(ref_routes, port_routes)
    assert np.array_equal(tmask.numpy(), np.asarray(rmask))
    _close(tg.numpy(), rg, GATE_REL)
    assert taux.dtype == torch.float32 and taux.shape == ()
    np.testing.assert_allclose(float(taux), float(raux), rtol=AUX_REL)


@pytest.mark.parametrize("mode", ["none", "ruq", "pann"])
@pytest.mark.parametrize("case", ARCHS)
def test_expert_ffn_matches_reference(case, mode, monkeypatch):
    qc = dict(mode=mode, weight_bits=4, act_bits=6, r=2.83,
              act_bits_tilde=4)
    rc = dataclasses.replace(ref_cfg(case), quant=RQuantConfig(**qc))
    tc = dataclasses.replace(port_cfg(case), quant=TQuantConfig(**qc))
    p = _moe_params(case, layer=1)
    ws = [p[k][1] for k in ("w_gate", "w_up", "w_down")]
    x = _x((2, 6, rc.d_model), 5)
    ref_codes, port_codes = [], []
    _capture(monkeypatch, RQ, ref_codes)
    _capture(monkeypatch, TQ, port_codes)
    want = RM.expert_ffn(jnp.asarray(x), *map(jnp.asarray, ws), rc)
    got = TM.expert_ffn(torch.from_numpy(x),
                        *(torch.from_numpy(w) for w in ws), tc)
    assert len(ref_codes) == len(port_codes) == (0 if mode == "none" else 3)
    flipped = sum(int((a != b).sum()) for a, b in zip(ref_codes,
                                                      port_codes))
    assert flipped == 0
    _close(got.numpy(), want, Y_REL)


@pytest.mark.parametrize("case", ["mixtral-8x7b", "dbrx-top4"])
def test_apply_moe_matches_reference(case, monkeypatch):
    rc, tc = ref_cfg(case), port_cfg(case)
    p = _moe_params(case)
    assert p["w_gate"].shape == (rc.moe.num_experts, rc.d_model, rc.d_ff)
    x = _x((2, 6, rc.d_model), 7)
    ref_routes, port_routes = [], []
    _record_routes(monkeypatch, RM, ref_routes)
    _record_routes(monkeypatch, TM, port_routes)
    with jax.disable_jit():
        ry, raux = RM.apply_moe(jnp.asarray(x), _jnp(p), rc)
    ty, taux = TM.apply_moe(torch.from_numpy(x), _torch(p), tc)
    assert _same_experts(ref_routes, port_routes) == 12
    _close(ty.numpy(), ry, Y_REL)
    np.testing.assert_allclose(float(taux), float(raux), rtol=AUX_REL)


def test_apply_moe_runs_every_expert_on_every_token_in_order():
    """y = carry + gate_e * y_e for e = 0..E-1, bit for bit: the sum runs
    in expert order over every expert, unrouted ones at gate 0."""
    tc = port_cfg("dbrx-top4")
    p = _torch(_moe_params("dbrx-top4"))
    x = torch.from_numpy(_x((2, 3, tc.d_model), 9))
    gates, mask, _ = TM.route(x, p, tc)
    want = torch.zeros_like(x)
    for e in range(tc.moe.num_experts):
        y_e = TM.expert_ffn(x, p["w_gate"][e], p["w_up"][e], p["w_down"][e],
                            tc)
        want = want + gates[..., e, None] * y_e
    got, _ = TM.apply_moe(x, p, tc)
    assert torch.equal(got, want)
    assert (mask.sum(-1) == 4).all() and not mask.all()


# ---------------------------------------------------------------------------
# whole models
# ---------------------------------------------------------------------------

def _tokens(seed, b=2, t=12):
    return np.random.default_rng(seed).integers(0, VOCAB, (b, t)).astype(
        np.int32)


def _bound(flipped, n_codes):
    assert flipped <= MAX_FLIP_SHARE * max(n_codes, 1)
    return LOGIT_REL if flipped == 0 else FLIP_REL


@pytest.mark.parametrize("mode", ["none", "pann"])
@pytest.mark.parametrize("case", CASES)
def test_forward_matches_reference(case, mode, monkeypatch):
    qc = PANN if mode == "pann" else dict(mode="none")
    rc = dataclasses.replace(ref_cfg(case), quant=RQuantConfig(**qc))
    tc = dataclasses.replace(port_cfg(case), quant=TQuantConfig(**qc))
    tokens = _tokens(len(case))
    ref_codes, port_codes, ref_routes, port_routes = [], [], [], []
    _capture(monkeypatch, RQ, ref_codes)
    _capture(monkeypatch, TQ, port_codes)
    _record_routes(monkeypatch, RM, ref_routes)
    _record_routes(monkeypatch, TM, port_routes)
    with jax.disable_jit():
        want = RMD.forward(_jnp(reference_params(case)), rc,
                           jnp.asarray(tokens), remat=False)
    got = TMD.forward(params_from_reference(reference_params(case), tc,
                                            "cpu"), tc,
                      torch.from_numpy(tokens).long())
    assert len(ref_codes) == len(port_codes)
    flipped = sum(int((a != b).sum()) for a, b in zip(ref_codes,
                                                      port_codes))
    n_codes = sum(a.size for a in ref_codes)
    routed = _same_experts(ref_routes, port_routes)
    assert routed == rc.num_layers * tokens.size
    logits, want_logits = got.logits.numpy(), np.asarray(want.logits)
    assert np.isfinite(logits).all()
    err = float(np.abs(logits - want_logits).max()
                / np.abs(want_logits).max())
    print(f"{case} {mode}: max|err| / max|logit| = {err:.3g}, {flipped} of "
          f"{n_codes} activation codes flipped, {routed} tokens routed")
    _close(logits, want_logits, _bound(flipped, n_codes))
    assert float(got.aux_loss) > 0
    np.testing.assert_allclose(float(got.aux_loss), float(want.aux_loss),
                               rtol=AUX_REL)


def _ref_decode(params, cfg, rows):
    """(T, B, V) reference logits of teacher-forcing ``rows``, op by op."""
    st = RMD.init_decode_state(params, cfg, rows.shape[0], rows.shape[1])
    out = []
    with jax.disable_jit():
        for t in range(rows.shape[1]):
            lg, st = RMD.decode_step(params, cfg, st,
                                     jnp.asarray(rows[:, t:t + 1]))
            out.append(np.asarray(lg)[:, 0])
    return np.stack(out)


def _port_decode(params, cfg, rows):
    st = TMD.init_decode_state(params, cfg, rows.shape[0], rows.shape[1])
    out = []
    for t in range(rows.shape[1]):
        lg, st = TMD.decode_step(params, cfg, st,
                                 torch.from_numpy(rows[:, t:t + 1]).long())
        out.append(lg[:, 0].numpy())
    return np.stack(out)


def _per_step_close(got, want):
    scale = np.max(np.abs(want), axis=-1, keepdims=True)
    worst = float(np.max(np.abs(got - want) / scale))
    assert worst <= LOGIT_REL, worst
    return worst


@pytest.mark.parametrize("case", ARCHS)
def test_decode_step_matches_reference(case, monkeypatch):
    """Teacher-forced ``decode_step`` on fp params (fp cache)."""
    rows = _tokens(11, t=STEPS)
    ref_routes, port_routes = [], []
    _record_routes(monkeypatch, RM, ref_routes)
    _record_routes(monkeypatch, TM, port_routes)
    want = _ref_decode(_jnp(reference_params(case)), ref_cfg(case), rows)
    tc = port_cfg(case)
    got = _port_decode(params_from_reference(reference_params(case), tc,
                                             "cpu"), tc, rows)
    assert _same_experts(ref_routes, port_routes) == \
        tc.num_layers * rows.size
    print(f"{case}: worst |logit gap| / max|logit| = "
          f"{_per_step_close(got, want):.3g}")


@functools.lru_cache(maxsize=None)
def reference_store(case):
    """(ref WeightStore, port WeightStore carried across) of the ladder
    with packed planes and 4-bit cache leaves."""
    cfg = ref_cfg(case)
    spec = RSV.ServingQuantSpec(pack_planes=True, cache_bits=4)
    ws = RSV.build_weight_store(_jnp(reference_params(case)), cfg,
                                rung_specs(cfg), spec=spec)
    pws = weight_store_from_reference(
        tonp(ws.store), {k: tonp(v) for k, v in ws.views.items()},
        port_cfg(case), "cpu")
    return ws, pws


@pytest.mark.parametrize("case", ARCHS)
def test_decode_on_every_rung_view_matches_reference(case, monkeypatch):
    """The served path: every rung's view, 4-bit cache, the port's 'ref',
    'fused' and 'packed' bit-identical, against the reference's 'ref';
    the router and the experts run in fp32 on both sides."""
    ws, pws = reference_store(case)
    rc = dataclasses.replace(ref_cfg(case), kernel_backend="ref",
                             cache_bits=4)
    worst = 0.0
    for bits in LADDER:
        rows = _tokens(bits, t=STEPS)
        ref_routes, port_routes = [], []
        _record_routes(monkeypatch, RM, ref_routes)
        _record_routes(monkeypatch, TM, port_routes)
        want = _ref_decode(ws.views[bits], rc, rows)
        got = {}
        for b in ("ref", "fused", "packed"):
            tc = dataclasses.replace(port_cfg(case), kernel_backend=b,
                                     cache_bits=4)
            got[b] = _port_decode(pws.views[bits], tc, rows)
        assert np.array_equal(got["ref"], got["fused"])
        assert np.array_equal(got["ref"], got["packed"])
        # every backend's routes against the reference's
        _same_experts(ref_routes * 3, port_routes)
        worst = max(worst, _per_step_close(got["packed"], want))
        monkeypatch.undo()
    print(f"{case}: worst |logit gap| / max|logit| = {worst:.3g}")


# ---------------------------------------------------------------------------
# the single-point artifact, the weight store and the layouts
# ---------------------------------------------------------------------------

MOE_LEAVES = ("router/w", "w_gate", "w_up", "w_down")


def _moe_leaf(layer_node, name):
    node = layer_node["moe"]
    for k in name.split("/"):
        node = node[k]
    return node


@pytest.mark.parametrize("case", ARCHS)
def test_params_carry_across_both_ways(case):
    """The port's own init has the reference's leaf set; carried params
    restack into the reference's (G, E, d, ff) stacks leaf for leaf."""
    tc = port_cfg(case)
    ref = reference_params(case)
    own = TMD.init_params(tc, seed=0, device="cpu")
    carried = params_from_reference(ref, tc, "cpu")
    assert jax.tree_util.tree_map(lambda t: (t.shape, t.dtype), own) == \
        jax.tree_util.tree_map(lambda t: (t.shape, t.dtype), carried)
    assert carried["layers"][0]["moe"]["w_down"].shape == \
        (tc.moe.num_experts, tc.d_ff, tc.d_model)

    def restacked(node):
        if isinstance(node, dict):
            return {k: restacked(v) for k, v in node.items()}
        if isinstance(node, list):
            return [restacked(v) for v in node]
        return np.stack([p.numpy() for p in node.parts]) \
            if hasattr(node, "parts") else node.numpy()

    got, want = _np_leaves(restacked(reference_layout(carried, tc))), \
        _np_leaves(ref)
    assert sorted(got) == sorted(want)
    for k in want:
        assert np.array_equal(got[k], want[k]), k


@pytest.mark.parametrize("case", ARCHS)
def test_single_point_artifact_matches_reference(case):
    """``quantize_params_for_serving`` at a PANN point: the attention
    projections and the head quantized as the reference's (codes equal
    but at .5 ties), the router and the experts passed through unquantized
    as the very tensors handed in."""
    rc, tc = ref_cfg(case), port_cfg(case)
    spec = dict(r=2.83, act_bits=4, pack_planes=True, cache_bits=4)
    ref = RSV.quantize_params_for_serving(
        _jnp(reference_params(case)), rc, spec=RSV.ServingQuantSpec(**spec))
    fp = params_from_reference(reference_params(case), tc, "cpu")
    handed = params_from_reference(reference_params(case), tc, "cpu")
    kept = [[_moe_leaf(lp, n) for n in MOE_LEAVES]
            for lp in handed["layers"]]
    own = TSV.quantize_params_for_serving(handed, tc,
                                          TSV.ServingQuantSpec(**spec))
    carried = params_from_reference(tonp(ref), tc, "cpu")
    flipped = _check_artifact(carried, own, fp)
    print(f"{case}: {flipped} codes flipped at .5 ties")
    for i, lp in enumerate(own["layers"]):
        assert "w_q" not in lp["moe"]["router"]
        for name, t in zip(MOE_LEAVES, kept[i]):
            assert _moe_leaf(lp, name) is t
            assert t.dtype == torch.float32
            assert torch.equal(t, _moe_leaf(carried["layers"][i], name))


def _flat(tree, trail=""):
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_flat(v, f"{trail}/{k}" if trail else k))
        return out
    if isinstance(tree, (list, tuple)):
        out = {}
        for i, v in enumerate(tree):
            out.update(_flat(v, f"{trail}/{i}"))
        return out
    return {trail: tree}


def _check_tree(got, want, fp):
    """Leaf for leaf: the same paths and dtypes; codes equal but at .5 ties
    of w / gamma (then the module's colsum differs with them), gamma
    within 1e-6 relative, every other leaf equal. Returns the flips."""
    got, want, w_fp = _flat(got), _flat(want), _flat(fp)
    assert sorted(got) == sorted(want)
    flipped = 0
    skip = set()
    for k in got:
        if k.endswith("/w_q"):
            mod = k.rsplit("/", 1)[0]
            bad = got[k].numpy() != want[k].numpy()
            if bad.any():
                ratio = w_fp[f"{mod}/w"].numpy() / want[
                    f"{mod}/w_scale"].numpy()
                ties = np.abs(np.abs(ratio - np.trunc(ratio)) - 0.5) < 1e-4
                assert not (bad & ~ties).any(), mod
                flipped += int(bad.sum())
                skip |= {f"{mod}/{leaf}" for leaf in (
                    "w_q", "w_colsum", "w_planes_pos", "w_planes_neg")}
    for k in got:
        assert got[k].dtype == want[k].dtype, k
        if k in skip:
            continue
        if k.endswith("/w_scale"):
            np.testing.assert_allclose(got[k].numpy(), want[k].numpy(),
                                       rtol=1e-6)
        else:
            assert torch.equal(got[k], want[k]), k
    return flipped


@pytest.mark.parametrize("allocation", ["uniform", "layerwise"])
@pytest.mark.parametrize("case", ["mixtral-8x7b"])
def test_weight_store_matches_reference(case, allocation):
    """``build_weight_store`` over a MoE tree, leaf for leaf against the
    reference's; the router and expert leaves are the handed-in tensors,
    the same objects in the store and in every view (a graph captured on
    one view reads the same pointers)."""
    rc, tc = ref_cfg(case), port_cfg(case)
    reng = RServeEngine(rc, _jnp(reference_params(case)), ladder_bits=LADDER,
                        backend="packed", cache_bits=4, allocation=allocation)
    ladder = t_build_ladder(LADDER, d=float(tc.d_model),
                            allocation=allocation,
                            profile=tcosts.module_cost_profile(tc))
    specs = {op.bits: (op.tree if op.tree is not None
                       else (op.r, op.b_x_tilde)) for op in ladder}
    carried = weight_store_from_reference(
        tonp(reng.weight_store),
        {k: tonp(v) for k, v in reng.variants.items()}, tc, "cpu")
    fp = params_from_reference(reference_params(case), tc, "cpu")
    handed = params_from_reference(reference_params(case), tc, "cpu")
    kept = [[_moe_leaf(lp, n) for n in MOE_LEAVES]
            for lp in handed["layers"]]
    own = TSV.build_weight_store(handed, tc, specs, TSV.ServingQuantSpec(
        pack_planes=True, cache_bits=reng._cache_bits_by_rung))
    flipped = _check_tree(own.store, carried.store, fp)
    for bits in specs:
        flipped += _check_tree(own.views[bits], carried.views[bits], fp)
    print(f"{case} {allocation}: {flipped} codes flipped at .5 ties")
    for i in range(tc.num_layers):
        for name, t in zip(MOE_LEAVES, kept[i]):
            assert _moe_leaf(own.store["layers"][i], name) is t
            for bits in specs:
                assert _moe_leaf(own.views[bits]["layers"][i], name) is t
                assert _moe_leaf(carried.views[bits]["layers"][i], name) \
                    is _moe_leaf(carried.store["layers"][i], name)


# ---------------------------------------------------------------------------
# the ladder engine and the CLI
# ---------------------------------------------------------------------------

@functools.lru_cache(maxsize=None)
def engines(case, allocation):
    """(reference engine, port engine quantizing the same params, port
    engine serving the reference's store carried across), 4-bit cache."""
    kw = dict(ladder_bits=LADDER, max_batch=2, max_len=12, cache_bits=4,
              allocation=allocation)
    reng = RServeEngine(ref_cfg(case), _jnp(reference_params(case)),
                        backend="ref", **kw)
    tc = port_cfg(case)
    own = TServeEngine(tc, params_from_reference(reference_params(case), tc,
                                                 "cpu"),
                       backend="packed", device="cpu", **kw)
    ws = weight_store_from_reference(
        tonp(reng.weight_store),
        {k: tonp(v) for k, v in reng.variants.items()}, tc, "cpu")
    carried = TServeEngine(tc, weight_store=ws, backend="fused",
                           device="cpu", **kw)
    return reng, own, carried


@pytest.mark.parametrize("allocation", ["uniform", "layerwise"])
def test_engine_ladder_trees_and_ledgers_match_reference(allocation):
    reng, own, carried = engines("mixtral-8x7b", allocation)
    assert [m.path for m in own.profile] == [m.path for m in reng.profile]
    assert any(m.path.startswith("moe.") for m in own.profile)
    for teng in (own, carried):
        for r, t in zip(reng.ladder, teng.ladder, strict=True):
            assert (r.bits, r.allocation, r.r, r.b_x_tilde, r.power) == \
                (t.bits, t.allocation, t.r, t.b_x_tilde, t.power)
            assert t.allocation == allocation
            if r.tree is not None:
                assert _tree(r.tree) == _tree(t.tree)
            assert _tree(reng._rung_tree(r)) == _tree(teng._rung_tree(t))
            for ctx in (7, 12, 300):
                a, b = reng.ledger_for(r, ctx), teng.ledger_for(t, ctx)
                assert a.bitflips_per_token == b.bitflips_per_token
                assert a.breakdown_per_token == b.breakdown_per_token


@pytest.mark.parametrize("allocation", ["uniform", "layerwise"])
def test_engine_generate_matches_reference(allocation):
    """Every response: the same rung and energy report (``EnergyLedger``
    metadata); tokens equal up to the first step the reference's own
    top-1/top-2 margin calls too close. The engine that serves the
    reference's store through graphs' bookkeeping recompiles nothing."""
    reng, own, carried = engines("mixtral-8x7b", allocation)
    carried.warmup()
    rng = np.random.default_rng(7)
    budgets = (2, 4, 6, 4)
    prompts = [rng.integers(0, VOCAB, 6).astype(np.int32) for _ in budgets]

    def reqs(cls):
        return [cls(uid=i, prompt=p, max_new_tokens=6, power_budget_bits=b)
                for i, (p, b) in enumerate(zip(prompts, budgets))]

    rres = reng.generate(reqs(RRequest))
    tres = carried.generate(reqs(TRequest))
    ores = own.generate(reqs(TRequest))
    carried.assert_no_recompile()
    rc = dataclasses.replace(reng.cfg, kernel_backend="ref")
    step = jax.jit(lambda p, s, t: RMD.decode_step(p, rc, s, t))
    for r, t, o, p in zip(rres, tres, ores, prompts):
        assert (r.uid, r.rung_bits) == (t.uid, t.rung_bits) == \
            (o.uid, o.rung_bits)
        assert r.metadata == t.metadata == o.metadata
        rows = np.concatenate([p, np.asarray(r.tokens[:-1], np.int32)])
        view = reng.variants[r.rung_bits]
        st = RMD.init_decode_state(view, rc, 1, len(rows))
        want = []
        for i in range(len(rows)):
            lg, st = step(view, st, jnp.asarray(rows[None, i:i + 1]))
            want.append(np.asarray(lg)[0, 0])
        want = np.stack(want)[len(p) - 1:]
        bound = LOGIT_REL * np.max(np.abs(want), axis=-1)
        for i, (a, b) in enumerate(zip(r.tokens, t.tokens)):
            if _margin(want[i], VOCAB) <= 2 * bound[i]:
                break
            assert a == b, (r.uid, i)
    assert carried.describe()["steps_by_rung"] == \
        reng.describe()["steps_by_rung"]


@pytest.mark.parametrize("case", ARCHS)
def test_serve_cli_takes_each_moe_config(case):
    """``launch/serve.py --arch`` serves each MoE config, reduced on the
    CPU: the ladder (every request at the rung its budget picks) and the
    single point at --quant pann (the router and experts through the
    fake-quant projections, the rest through the artifact's backends,
    which give the same tokens)."""
    cli = ["--arch", case, "--reduced", "--device", "cpu", "--batch", "2",
           "--prompt_len", "4", "--gen", "4"]
    out = tserve.main(cli + ["--requests", "3", "--cache_bits", "4"])
    assert out["arch"] == case + "-smoke"
    assert [r["rung_bits"] for r in out["requests"]] == list(LADDER)
    assert all(len(r["sample"]) == 4 for r in out["requests"])
    samples = {b: tserve.main(cli + ["--quant", "pann", "--power_bits", "4",
                                     "--backend", b])["sample"]
               for b in ("ref", "fused", "packed")}
    assert samples["ref"] == samples["fused"] == samples["packed"]
