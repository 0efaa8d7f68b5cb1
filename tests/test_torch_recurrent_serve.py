"""The recurrent families of the port, zamba2-1.2b (Mamba2 with a shared
attention + MLP block every 6th layer, and a tail) and rwkv6-1.6b, served
and evaluated against the JAX package on the CPU at their reduced configs
(zamba2: 14 layers = 2 groups of 6 + a 2-layer tail, d = 64; rwkv6: 2
layers of one 64-wide head):

- the layer layout (groups, then the tail's ``pattern[0]``,
  ``pattern[1]``) and ``convert``'s round trips of the tail and the
  top-level ``shared_attn``;
- ``forward`` logits at quant modes 'none' and 'pann';
- the single-point artifact and the weight store leaf for leaf (the
  shared block quantized once, its views aliasing the store, one
  ``kv_cache`` under ``shared_attn.attn``, the recurrent fp leaves the
  very tensors handed in, in the store and every view);
- decode on every rung's view through 'ref', 'fused' and 'packed';
- the v1 artifact byte for byte;
- the ladder engine (ladder, rung trees, ``EnergyLedger`` and tokens, the
  counterpart of ``tests/test_serve_engine.py``'s recurrent-family test)
  and its decode-state slots: ``_slot_step`` writes every recurrent leaf
  back into the slot's own tensors, ``_reset`` zeroes them in place;
- the CLI in ladder and single-point modes.

Tolerance: logits within 1e-4 * max|logit| (``LOGIT_REL``), per decode
step against the step's own max. At mode 'pann' (fake quant) the
activation codes of both sides are captured and compared: a code flips
only where the two sides' fp inputs straddle a rounding boundary, so
flips are counted, held to 1 in 10^4 codes, and the bound is then 2e-2
(as ``test_torch_forward``). Codes of the weight stores and artifacts
equal the reference's but at .5 ties of w / gamma, counted. Tokens equal
the reference's up to the first step whose top-1/top-2 logit margin is
within twice the bound.
"""
import dataclasses
import filecmp
import functools
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as rconfigs
from repro.configs.base import QuantConfig as RQuantConfig
from repro.core import costs as rcosts
from repro.core import quant as RQ
from repro.models import model as RMD
from repro.models import serving as RSV
from repro.models import transformer as RT
from repro.serve_engine import Request as RRequest
from repro.serve_engine import ServeEngine as RServeEngine
from repro.serve_engine import artifact as RA
from repro_torch import configs as tconfigs
from repro_torch.configs.base import QuantConfig as TQuantConfig
from repro_torch.convert import (params_from_reference, reference_layout,
                                 weight_store_from_reference)
from repro_torch.core import costs as tcosts
from repro_torch.core import quant as TQ
from repro_torch.launch import serve as tserve
from repro_torch.models import model as TMD
from repro_torch.models import serving as TSV
from repro_torch.serve_engine import Request as TRequest
from repro_torch.serve_engine import ServeEngine as TServeEngine
from repro_torch.serve_engine import artifact as TA
from repro_torch.serve_engine import build_ladder as t_build_ladder
from repro_torch.serve_engine.engine import _tensors
from test_torch_common import LADDER, rung_specs, tonp
from test_torch_common import one_torch_thread  # noqa: F401
from test_torch_dense_variants import _np_leaves
from test_torch_forward import _capture
from test_torch_layerwise import _tree
from test_torch_moe import _check_tree, _flat
from test_torch_single_point import _check_artifact
from test_torch_slice import _margin
from test_torch_ssm import perturb

ARCHS = ("zamba2-1.2b", "rwkv6-1.6b")
LOGIT_REL = 1e-4
FLIP_REL = 2e-2
MAX_FLIP_SHARE = 1e-4
VOCAB = 512
STEPS = 6
PANN = dict(mode="pann", r=2.83, act_bits_tilde=4)
# the leaves the recurrent blocks keep in fp32, passed through every store
FP_LEAVES = {"zamba2-1.2b": ("ssm/conv_w", "ssm/conv_b", "ssm/a_log",
                             "ssm/dt_bias", "ssm/d_skip", "ssm/norm/scale"),
             "rwkv6-1.6b": ("tm/mu", "tm/decay_base", "tm/bonus",
                            "tm/ln_x/scale", "tm/ln_x/bias", "cm/mu")}


def ref_cfg(arch, qc=None):
    cfg = rconfigs.reduced(rconfigs.get_config(arch))
    return cfg if qc is None else dataclasses.replace(
        cfg, quant=RQuantConfig(**qc))


def port_cfg(arch, qc=None):
    cfg = tconfigs.reduced(tconfigs.get_config(arch))
    return cfg if qc is None else dataclasses.replace(
        cfg, quant=TQuantConfig(**qc))


@functools.lru_cache(maxsize=None)
def reference_params(arch, seed=0):
    """The reference's params (numpy), the leaves its init makes constant
    perturbed (``test_torch_ssm.perturb``)."""
    params = RMD.init_params(jax.random.PRNGKey(seed), ref_cfg(arch))
    return perturb(tonp(params), np.random.default_rng(seed + 29))


def _jnp(tree):
    return jax.tree_util.tree_map(jnp.asarray, tree)


def _tokens(seed, b=2, t=12):
    return np.random.default_rng(seed).integers(0, VOCAB, (b, t)).astype(
        np.int32)


def _leaf(node, path):
    for k in path.split("/"):
        node = node[k]
    return node


# ---------------------------------------------------------------------------
# layout and conversion
# ---------------------------------------------------------------------------

def test_zamba2_layers_are_groups_then_the_tail():
    """14 layers = 2 groups of [mamba x 5, mamba_attn] and a tail of
    pattern[0], pattern[1] (both mamba); the carried params put the
    reference's tail layers last and the group layers in order."""
    arch = "zamba2-1.2b"
    cfg = port_cfg(arch)
    kinds = [s.kind for s in TMD.layer_specs(cfg)]
    assert kinds == (["mamba"] * 5 + ["mamba_attn"]) * 2 + ["mamba"] * 2
    pattern, n_groups, n_tail = RT.group_layout(ref_cfg(arch))
    assert (n_groups, n_tail) == (2, 2)
    assert [s.kind for s in pattern[:n_tail]] == kinds[12:]
    ref = reference_params(arch)
    carried = params_from_reference(ref, cfg, "cpu")
    assert len(carried["layers"]) == 14 and "shared_attn" in carried
    groups = ref["decoder"]["groups"]["layers"]
    for i, lp in enumerate(carried["layers"]):
        want = (ref["decoder"]["tail"][i - 12] if i >= 12 else
                jax.tree_util.tree_map(lambda a, g=i // 6: a[g],
                                       groups[i % 6]))
        got = _np_leaves(lp)
        assert sorted(got) == sorted(_np_leaves(want))
        for k, v in _np_leaves(want).items():
            assert np.array_equal(got[k], v), (i, k)
    for k, v in _np_leaves(ref["shared_attn"]).items():
        assert np.array_equal(_np_leaves(carried["shared_attn"])[k], v)


def _restacked(node):
    if isinstance(node, dict):
        return {k: _restacked(v) for k, v in node.items()}
    if isinstance(node, list):
        return [_restacked(v) for v in node]
    return np.stack([p.numpy() for p in node.parts]) \
        if hasattr(node, "parts") else node.numpy()


@pytest.mark.parametrize("arch", ARCHS)
def test_params_carry_across_both_ways(arch):
    """The port's own init has the reference's leaf set; carried params
    restack into the reference's layout (groups, tail, shared block) leaf
    for leaf."""
    cfg = port_cfg(arch)
    ref = reference_params(arch)
    own = TMD.init_params(cfg, seed=0, device="cpu")
    carried = params_from_reference(ref, cfg, "cpu")

    def shapes(tree):
        return jax.tree_util.tree_map(lambda t: (t.shape, t.dtype), tree)
    assert shapes(own) == shapes(carried)
    got = _np_leaves(_restacked(reference_layout(carried, cfg)))
    want = _np_leaves(ref)
    assert sorted(got) == sorted(want)
    for k in want:
        assert np.array_equal(got[k], want[k]), k


# ---------------------------------------------------------------------------
# forward
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("mode", ["none", "pann"])
@pytest.mark.parametrize("arch", ARCHS)
def test_forward_matches_reference(arch, mode, monkeypatch):
    qc = PANN if mode == "pann" else dict(mode="none")
    tokens = _tokens(len(arch), t=16)
    ref_codes, port_codes = [], []
    _capture(monkeypatch, RQ, ref_codes)
    _capture(monkeypatch, TQ, port_codes)
    with jax.disable_jit():
        want = RMD.forward(_jnp(reference_params(arch)), ref_cfg(arch, qc),
                           jnp.asarray(tokens), remat=False)
    cfg = port_cfg(arch, qc)
    got = TMD.forward(params_from_reference(reference_params(arch), cfg,
                                            "cpu"), cfg,
                      torch.from_numpy(tokens).long())
    assert len(ref_codes) == len(port_codes)
    flipped = sum(int((a != b).sum()) for a, b in zip(ref_codes,
                                                      port_codes))
    n_codes = sum(a.size for a in ref_codes)
    assert flipped <= MAX_FLIP_SHARE * max(n_codes, 1)
    logits, want_logits = got.logits.numpy(), np.asarray(want.logits)
    assert np.isfinite(logits).all() and float(got.aux_loss) == 0.0
    err = float(np.abs(logits - want_logits).max()
                / np.abs(want_logits).max())
    print(f"{arch} {mode}: max|err| / max|logit| = {err:.3g}, {flipped} of "
          f"{n_codes} activation codes flipped")
    bound = LOGIT_REL if flipped == 0 else FLIP_REL
    np.testing.assert_allclose(logits, want_logits, rtol=0,
                               atol=bound * np.abs(want_logits).max())


# ---------------------------------------------------------------------------
# the single-point artifact and the weight store
# ---------------------------------------------------------------------------

def _fp_leaves_pass_through(arch, handed_layers, tree_layers):
    """Every recurrent fp leaf of every layer of ``tree_layers`` is the
    tensor handed in."""
    for lp, hp in zip(tree_layers, handed_layers):
        for path in FP_LEAVES[arch]:
            assert _leaf(lp, path) is hp[path], path
            assert _leaf(lp, path).dtype == torch.float32


def _handed(params, arch):
    """{path: tensor} of each layer's recurrent fp leaves, taken before the
    builder consumes ``params``."""
    return [{p: _leaf(lp, p) for p in FP_LEAVES[arch]}
            for lp in params["layers"]]


def _kv_cache_paths(tree):
    return sorted(k for k in _flat(tree) if "/kv_cache/" in k)


@pytest.mark.parametrize("arch", ARCHS)
def test_single_point_artifact_matches_reference(arch):
    rc, tc = ref_cfg(arch), port_cfg(arch)
    spec = dict(r=2.83, act_bits=4, pack_planes=True, cache_bits=4)
    ref = RSV.quantize_params_for_serving(
        _jnp(reference_params(arch)), rc, spec=RSV.ServingQuantSpec(**spec))
    fp = params_from_reference(reference_params(arch), tc, "cpu")
    handed = params_from_reference(reference_params(arch), tc, "cpu")
    kept = _handed(handed, arch)
    own = TSV.quantize_params_for_serving(handed, tc,
                                          TSV.ServingQuantSpec(**spec))
    carried = params_from_reference(tonp(ref), tc, "cpu")
    flipped = _check_artifact(carried, own, fp)
    print(f"{arch}: {flipped} codes flipped at .5 ties")
    _fp_leaves_pass_through(arch, kept, own["layers"])
    want_kv = (["shared_attn/attn/kv_cache/k_nlvl",
                "shared_attn/attn/kv_cache/v_nlvl"]
               if arch == "zamba2-1.2b" else [])
    assert _kv_cache_paths(own) == want_kv


@functools.lru_cache(maxsize=None)
def reference_store(arch):
    """(ref WeightStore, port WeightStore carried across) of the ladder with
    packed planes and 4-bit cache leaves."""
    spec = RSV.ServingQuantSpec(pack_planes=True, cache_bits=4)
    ws = RSV.build_weight_store(_jnp(reference_params(arch)), ref_cfg(arch),
                                rung_specs(ref_cfg(arch)), spec=spec)
    pws = weight_store_from_reference(
        tonp(ws.store), {k: tonp(v) for k, v in ws.views.items()},
        port_cfg(arch), "cpu")
    return ws, pws


SHARED_LEAVES = ("w_q", "w_scale", "w_planes_pos", "w_planes_neg")


@pytest.mark.parametrize("allocation", ["uniform", "layerwise"])
@pytest.mark.parametrize("arch", ARCHS)
def test_weight_store_matches_reference(arch, allocation):
    """``build_weight_store`` leaf for leaf against the reference's (codes
    but at .5 ties); zamba2's shared block is quantized once, at the top
    of the tree, and every view's shared-block leaves are the store's
    tensors; one ``kv_cache`` (under ``shared_attn.attn``) in each view;
    the recurrent fp leaves are the handed-in tensors in the store and in
    every view."""
    rc, tc = ref_cfg(arch), port_cfg(arch)
    reng = RServeEngine(rc, _jnp(reference_params(arch)), ladder_bits=LADDER,
                        backend="packed", cache_bits=4, allocation=allocation)
    ladder = t_build_ladder(LADDER, d=float(tc.d_model),
                            allocation=allocation,
                            profile=tcosts.module_cost_profile(tc))
    specs = {op.bits: (op.tree if op.tree is not None
                       else (op.r, op.b_x_tilde)) for op in ladder}
    carried = weight_store_from_reference(
        tonp(reng.weight_store),
        {k: tonp(v) for k, v in reng.variants.items()}, tc, "cpu")
    fp = params_from_reference(reference_params(arch), tc, "cpu")
    handed = params_from_reference(reference_params(arch), tc, "cpu")
    kept = _handed(handed, arch)
    own = TSV.build_weight_store(handed, tc, specs, TSV.ServingQuantSpec(
        pack_planes=True, cache_bits=reng._cache_bits_by_rung))
    flipped = _check_tree(own.store, carried.store, fp)
    for bits in specs:
        flipped += _check_tree(own.views[bits], carried.views[bits], fp)
    print(f"{arch} {allocation}: {flipped} codes flipped at .5 ties")
    _fp_leaves_pass_through(arch, kept, own.store["layers"])
    store = _flat(own.store)
    for bits in specs:
        _fp_leaves_pass_through(arch, kept, own.views[bits]["layers"])
        view = _flat(own.views[bits])
        want_kv = (["shared_attn/attn/kv_cache/k_nlvl",
                    "shared_attn/attn/kv_cache/v_nlvl"]
                   if arch == "zamba2-1.2b" else [])
        assert _kv_cache_paths(own.views[bits]) == want_kv
        for path, t in view.items():
            if path.rsplit("/", 1)[-1] in SHARED_LEAVES:
                assert t is store[path], path
    if arch == "zamba2-1.2b":
        shared = [k for k in store if k.startswith("shared_attn/")
                  and k.endswith("/w_q")]
        assert len(shared) == 6      # wq, wk, wv, wo, w_up, w_down, once
        assert not any("attn" in k for k in _flat(own.store["layers"]))


@pytest.mark.parametrize("arch", ARCHS)
def test_decode_on_every_rung_view_matches_reference(arch, monkeypatch):
    """The served path: every rung's view, 4-bit cache, the port's 'ref',
    'fused' and 'packed' bit-identical, against the reference's 'ref'
    (op by op: jitted, XLA fuses the recurrent fp ops in another order,
    which can flip a 4-bit activation code) per step within LOGIT_REL."""
    ws, pws = reference_store(arch)
    rc = dataclasses.replace(ref_cfg(arch), kernel_backend="ref",
                             cache_bits=4)
    worst = 0.0
    for bits in LADDER:
        rows = _tokens(bits, t=STEPS)
        st = RMD.init_decode_state(ws.views[bits], rc, 2, STEPS)
        want = []
        with jax.disable_jit():
            for t in range(STEPS):
                lg, st = RMD.decode_step(ws.views[bits], rc, st,
                                         jnp.asarray(rows[:, t:t + 1]))
                want.append(np.asarray(lg)[:, 0])
        want = np.stack(want)
        got = {}
        for b in ("ref", "fused", "packed"):
            tc = dataclasses.replace(port_cfg(arch), kernel_backend=b,
                                     cache_bits=4)
            tst = TMD.init_decode_state(pws.views[bits], tc, 2, STEPS)
            out = []
            for t in range(STEPS):
                lg, tst = TMD.decode_step(
                    pws.views[bits], tc, tst,
                    torch.from_numpy(rows[:, t:t + 1]).long())
                out.append(lg[:, 0].numpy())
            got[b] = np.stack(out)
        assert np.array_equal(got["ref"], got["fused"])
        assert np.array_equal(got["ref"], got["packed"])
        scale = np.max(np.abs(want), axis=-1, keepdims=True)
        worst = max(worst, float(np.max(np.abs(got["packed"] - want)
                                        / scale)))
    print(f"{arch}: worst |logit gap| / max|logit| = {worst:.3g}")
    assert worst <= LOGIT_REL


@pytest.mark.parametrize("arch", ARCHS)
def test_v1_artifact_is_the_reference_byte_for_byte(arch, tmp_path):
    """The port writes the store carried across to the very bytes the
    reference writes (blob and manifest, the tail and the shared block's
    ``kv_cache`` leaves included), and loads the reference's artifact
    into the carried store's leaves, views aliasing the store."""
    ws, pws = reference_store(arch)
    d_ref, d_port = str(tmp_path / "ref"), str(tmp_path / "port")
    RA.write_artifact(d_ref, ws, meta={"arch": arch})
    TA.write_artifact(d_port, pws, port_cfg(arch), meta={"arch": arch})
    assert filecmp.cmp(os.path.join(d_ref, TA.BLOB),
                       os.path.join(d_port, TA.BLOB), shallow=False)
    man = [json.load(open(os.path.join(d, TA.MANIFEST)))
           for d in (d_ref, d_port)]
    assert man[0] == man[1]
    paths = man[0]["store"]
    assert any(p.startswith("decoder/tail/") for p in paths) == \
        (arch == "zamba2-1.2b")
    got = TA.load_artifact(d_ref, device="cpu")
    store = _flat(got.store)
    for bits in LADDER:
        a, b = _flat(got.views[bits]), _flat(pws.views[bits])
        assert a.keys() == b.keys()
        for k in a:
            assert a[k].dtype == b[k].dtype and torch.equal(a[k], b[k]), k
            if k in store:
                assert a[k] is store[k]


# ---------------------------------------------------------------------------
# the ladder engine and its decode-state slots
# ---------------------------------------------------------------------------

ENGINE_CASES = [("zamba2-1.2b", "uniform", 4), ("zamba2-1.2b", "layerwise",
                                                "auto"),
                ("rwkv6-1.6b", "uniform", None), ("rwkv6-1.6b", "layerwise",
                                                  "auto")]


@functools.lru_cache(maxsize=None)
def engines(arch, allocation, cache_bits):
    """(reference engine, port engine quantizing the same params, port
    engine serving the reference's store carried across)."""
    kw = dict(ladder_bits=LADDER, max_batch=2, max_len=12,
              cache_bits=cache_bits, allocation=allocation)
    reng = RServeEngine(ref_cfg(arch), _jnp(reference_params(arch)),
                        backend="ref", **kw)
    tc = port_cfg(arch)
    own = TServeEngine(tc, params_from_reference(reference_params(arch), tc,
                                                 "cpu"),
                       backend="packed", device="cpu", **kw)
    ws = weight_store_from_reference(
        tonp(reng.weight_store),
        {k: tonp(v) for k, v in reng.variants.items()}, tc, "cpu")
    carried = TServeEngine(tc, weight_store=ws, backend="fused",
                           device="cpu", **kw)
    return reng, own, carried


@pytest.mark.parametrize("arch,allocation,cache_bits", ENGINE_CASES)
def test_engine_ladder_trees_and_ledgers_match_reference(arch, allocation,
                                                         cache_bits):
    reng, own, carried = engines(arch, allocation, cache_bits)
    assert [m.path for m in own.profile] == [m.path for m in reng.profile]
    for teng in (own, carried):
        assert teng.describe()["cache_bits_by_rung"] == \
            reng.describe()["cache_bits_by_rung"]
        for r, t in zip(reng.ladder, teng.ladder, strict=True):
            assert (r.bits, r.allocation, r.r, r.b_x_tilde, r.power) == \
                (t.bits, t.allocation, t.r, t.b_x_tilde, t.power)
            if r.tree is not None:
                assert _tree(r.tree) == _tree(t.tree)
            assert _tree(reng._rung_tree(r)) == _tree(teng._rung_tree(t))
            for ctx in (7, 12, 300):
                a, b = reng.ledger_for(r, ctx), teng.ledger_for(t, ctx)
                assert a.bitflips_per_token == b.bitflips_per_token
                assert a.breakdown_per_token == b.breakdown_per_token


def test_cost_profile_prices_the_shared_block_once_as_the_reference():
    """ROADMAP C9, the reference's behaviour, copied: zamba2's shared block
    is priced once a token although decode runs it at every mamba_attn
    position, and ``ssm.conv`` is priced as a PANN module though its
    weights stay fp32."""
    cfg = port_cfg("zamba2-1.2b")
    prof = {m.path: m for m in tcosts.module_cost_profile(cfg)}
    ref = {m.path: m for m in rcosts.module_cost_profile(ref_cfg(
        "zamba2-1.2b"))}
    assert list(prof) == list(ref)
    for path in prof:
        assert dataclasses.astuple(prof[path]) == \
            dataclasses.astuple(ref[path])
    positions = sum(s.kind == "mamba_attn" for s in TMD.layer_specs(cfg))
    assert positions == 2 and prof["attn.wq"].instances == 1
    assert prof["ssm.conv"].instances == cfg.num_layers


@pytest.mark.parametrize("arch,allocation,cache_bits", ENGINE_CASES)
def test_engine_generate_matches_reference(arch, allocation, cache_bits):
    """Every response: the same rung and energy report; tokens equal up to
    the first step the reference's own top-1/top-2 margin calls too
    close. The engine serving the reference's store goes through the
    warmup bookkeeping and recompiles nothing; the port's own engine
    gives the carried one's tokens."""
    reng, own, carried = engines(arch, allocation, cache_bits)
    carried.warmup()
    rng = np.random.default_rng(7)
    budgets = (2, 4, 6, 4)
    prompts = [rng.integers(0, VOCAB, 6).astype(np.int32) for _ in budgets]

    def reqs(cls):
        return [cls(uid=i, prompt=p, max_new_tokens=5, power_budget_bits=b)
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
    assert [r.tokens for r in tres] == [r.tokens for r in ores]
    assert carried.describe()["steps_by_rung"] == \
        reng.describe()["steps_by_rung"]


@pytest.mark.parametrize("arch", ARCHS)
def test_slot_step_writes_the_recurrent_state_in_place(arch):
    """A slot's step (the work one CUDA graph replays on the card) leaves
    every state tensor where it was, each holding what an eager
    ``decode_step`` returns as the new state; ``_reset`` zeroes them in
    place to a fresh ``init_decode_state``, bit for bit."""
    _, _, eng = engines(arch, "uniform", 4 if arch == "zamba2-1.2b" else None)
    bits = LADDER[1]
    slot = eng._acquire()
    try:
        leaves = _tensors(slot.state)
        ptrs = [t.data_ptr() for t in leaves] + [slot.tok.data_ptr()]
        kinds = {type(c).__name__ for c in slot.state.caches}
        assert kinds == ({"SSMState", "tuple"} if arch == "zamba2-1.2b"
                         else {"RWKVState"})
        view = eng.variants[bits]
        state = TMD.init_decode_state(view, eng.cfg, eng.max_batch,
                                      eng.max_len)
        rows = torch.from_numpy(_tokens(3, b=eng.max_batch, t=5)).long()
        for t in range(rows.shape[1]):
            slot.tok.copy_(rows[:, t:t + 1])
            logits = eng._slot_step(bits, slot)
            want, state = TMD.decode_step(view, eng.cfg, state,
                                          rows[:, t:t + 1])
            assert torch.equal(logits, want)
            now = _tensors(slot.state)
            assert [x.data_ptr() for x in now] + [slot.tok.data_ptr()] \
                == ptrs
            for a, b in zip(now, _tensors(state), strict=True):
                assert a.dtype == b.dtype and torch.equal(a, b)
        assert int(slot.state.position) == rows.shape[1]
        assert any(bool(t.any()) for t in _tensors(slot.state.caches))
        eng._reset(slot)
        fresh = TMD.init_decode_state(view, eng.cfg, eng.max_batch,
                                      eng.max_len)
        assert [t.data_ptr() for t in _tensors(slot.state)] == ptrs[:-1]
        for a, b in zip(_tensors(slot.state), _tensors(fresh), strict=True):
            assert torch.equal(a, b)
        assert not slot.tok.any()
    finally:
        slot.busy = False


@pytest.mark.parametrize("arch", ARCHS)
def test_serve_cli_takes_each_recurrent_config(arch):
    """``launch/serve.py --arch`` serves each config, reduced on the CPU:
    the ladder (every request at the rung its budget picks) and the
    single point at --quant pann, whose backends give the same tokens."""
    cli = ["--arch", arch, "--reduced", "--device", "cpu", "--batch", "2",
           "--prompt_len", "4", "--gen", "4"]
    out = tserve.main(cli + ["--requests", "3", "--cache_bits", "4"])
    assert out["arch"] == arch + "-smoke"
    assert [r["rung_bits"] for r in out["requests"]] == list(LADDER)
    assert all(len(r["sample"]) == 4 for r in out["requests"])
    samples = {b: tserve.main(cli + ["--quant", "pann", "--power_bits", "4",
                                     "--backend", b])["sample"]
               for b in ("ref", "fused", "packed")}
    assert samples["ref"] == samples["fused"] == samples["packed"]
