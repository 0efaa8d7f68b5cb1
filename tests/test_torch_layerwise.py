"""``allocation="layerwise"`` and ``cache_bits="auto"`` in the port's
``ServeEngine`` side by side with the JAX package's, on reduced llama3-8b
with cache_bits None, 4 and "auto".

The ``core`` modules are identical copies, so ladders, rung trees, cache
widths, ``describe()`` fields and energy ledgers are held exactly. The
port's own store, quantized from the same params, carries the same
per-module rung leaves (plane shifts, activation and cache level counts).
Tokens: the port serves the JAX package's store carried across, and
follows ``test_torch_slice``'s rule: equal wherever the reference's
top-1/top-2 margin exceeds twice its 1e-5 * max|logit| bound.
"""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from repro.models import model as RMD
from repro.serve_engine import Request as RRequest
from repro.serve_engine import ServeEngine as RServeEngine
from repro_torch.convert import (params_from_reference,
                                 weight_store_from_reference)
from repro_torch.launch import serve as tserve
from repro_torch.serve_engine import Request as TRequest
from repro_torch.serve_engine import ServeEngine as TServeEngine
from test_torch_common import LADDER, port_cfg, ref_cfg, tonp
from test_torch_common import one_torch_thread  # noqa: F401
from test_torch_slice import REL_BOUND, _margin

CACHE = [None, 4, "auto"]
KW = dict(ladder_bits=LADDER, max_batch=2, max_len=12,
          allocation="layerwise")


@functools.lru_cache(maxsize=None)
def engines(cache_bits):
    """(reference engine, port engine quantizing the same params, port
    engine serving the reference's store carried across)."""
    params = RMD.init_params(jax.random.PRNGKey(4), ref_cfg())
    reng = RServeEngine(ref_cfg(), params, backend="ref",
                        cache_bits=cache_bits, **KW)
    own = TServeEngine(port_cfg(),
                       params_from_reference(tonp(params), port_cfg(), "cpu"),
                       backend="packed", cache_bits=cache_bits,
                       device="cpu", **KW)
    ws = weight_store_from_reference(
        tonp(reng.weight_store),
        {k: tonp(v) for k, v in reng.variants.items()}, port_cfg(), "cpu")
    carried = TServeEngine(port_cfg(), weight_store=ws, backend="fused",
                           cache_bits=cache_bits, device="cpu", **KW)
    return reng, own, carried


def _tree(t):
    return (dataclasses.asdict(t.default),
            [(p, dataclasses.asdict(mq)) for p, mq in t.overrides])


@pytest.mark.parametrize("cache_bits", CACHE)
def test_ladder_trees_and_cache_widths_match_reference(cache_bits):
    reng, own, carried = engines(cache_bits)
    for teng in (own, carried):
        assert [op.bits for op in teng.ladder] == \
            [op.bits for op in reng.ladder]
        for r, t in zip(reng.ladder, teng.ladder):
            assert (r.allocation, r.r, r.b_x_tilde, r.power, r.score) == \
                (t.allocation, t.r, t.b_x_tilde, t.power, t.score)
            assert t.allocation == "layerwise"
            assert _tree(r.tree) == _tree(t.tree)
            assert _tree(reng._rung_tree(r)) == _tree(teng._rung_tree(t))
        assert teng._cache_bits_by_rung == reng._cache_bits_by_rung
        want, got = reng.describe(), teng.describe()
        for key in ("allocation", "cache_bits", "cache_bits_by_rung",
                    "ladder", "max_batch", "max_len"):
            assert got[key] == want[key], key
    if cache_bits == "auto":
        # the allocator spent the budget on the cache roles too
        assert all(v is None for v in own._cache_bits_by_rung.values())
        assert len({tuple(own._rung_tree(op).lookup(p).b_x_tilde
                          for p in ("attn.k_cache", "attn.v_cache"))
                    for op in own.ladder}) > 1


@pytest.mark.parametrize("cache_bits", CACHE)
@pytest.mark.parametrize("ctx", [7, 12, 300])
def test_ledgers_match_reference(cache_bits, ctx):
    reng, own, _ = engines(cache_bits)
    for r, t in zip(reng.ladder, own.ladder):
        a, b = reng.ledger_for(r, ctx), own.ledger_for(t, ctx)
        assert a.bitflips_per_token == b.bitflips_per_token
        assert a.breakdown_per_token == b.breakdown_per_token
        assert reng.token_flips(r.bits, ctx) == own.token_flips(t.bits, ctx)


def _leaves(tree, keys):
    """{(layer, module path, key): value} of the small per-rung leaves."""
    out = {}

    def walk(node, path):
        if isinstance(node, dict):
            for k, v in node.items():
                if k in keys:
                    arr = np.asarray(v).reshape(-1)
                    for i, x in enumerate(arr):
                        out[(i, path, k)] = float(x)
                else:
                    walk(v, path + (k,))
        elif isinstance(node, (list, tuple)):
            for v in node:
                walk(v, path)

    walk(tree, ())
    return out


RUNG_LEAVES = ("plane_shift", "act_n", "act_nlvl", "k_nlvl", "v_nlvl")


@pytest.mark.parametrize("cache_bits", CACHE)
def test_port_store_carries_the_reference_rung_leaves(cache_bits):
    """The port quantizes the layerwise trees into the same per-module
    plane shifts and level counts as the JAX package."""
    reng, own, _ = engines(cache_bits)
    for bits in LADDER:
        want = _leaves(tonp(reng.variants[bits]), RUNG_LEAVES)
        view = own.variants[bits]
        got = {}
        for i, layer in enumerate(view["layers"]):
            for (_, path, k), x in _leaves(layer, RUNG_LEAVES).items():
                got[(i, ("decoder", "groups", "layers") + path, k)] = x
        rest = {key: v for key, v in view.items() if key != "layers"}
        got.update(_leaves(rest, RUNG_LEAVES))
        assert got == want


def _ref_logits(reng, bits, rows):
    view = reng.variants[bits]
    st = RMD.init_decode_state(view, reng.cfg, rows.shape[0], rows.shape[1])
    out = []
    for t in range(rows.shape[1]):
        lg, st = reng._step(view, st, jnp.asarray(rows[:, t:t + 1]))
        out.append(np.asarray(lg)[:, 0])
    return np.stack(out)


@pytest.mark.parametrize("cache_bits", CACHE)
def test_generate_matches_reference(cache_bits):
    reng, own, carried = engines(cache_bits)
    rng = np.random.default_rng(13)
    budgets = (2, 4, 6, 2)
    reqs = [dict(uid=i, prompt=rng.integers(0, 512, 6).astype(np.int32),
                 max_new_tokens=5, power_budget_bits=b)
            for i, b in enumerate(budgets)]
    carried.warmup()
    want = reng.generate([RRequest(**r) for r in reqs])
    got = carried.generate([TRequest(**r) for r in reqs])
    carried.assert_no_recompile()
    for r, t, q in zip(want, got, reqs):
        assert (r.uid, r.rung_bits) == (t.uid, t.rung_bits)
        assert r.metadata == t.metadata
        rows = np.concatenate([q["prompt"], np.asarray(r.tokens[:-1],
                                                       np.int32)])
        logits = _ref_logits(reng, r.rung_bits, np.stack([rows, rows]))[
            len(q["prompt"]) - 1:, 0]
        bound = REL_BOUND * np.max(np.abs(logits), axis=-1)
        for i, (a, b) in enumerate(zip(r.tokens, t.tokens)):
            if _margin(logits[i]) <= 2 * bound[i]:
                break
            assert a == b, (r.uid, i)
    # the port's own store serves the same traffic: finite tokens in the
    # vocabulary at every rung
    for t in own.generate([TRequest(**r) for r in reqs]):
        assert len(t.tokens) == 5 and all(0 <= x < 512 for x in t.tokens)


def test_launch_serve_layerwise_auto_cli():
    """``--allocation layerwise --cache_bits auto`` through the port's CLI
    on the CPU, as the JAX package's ``test_launch_serve_layerwise_cli``
    drives its own."""
    out = tserve.main([
        "--arch", "llama3-8b", "--reduced", "--device", "cpu",
        "--power_ladder", "2,4", "--allocation", "layerwise",
        "--cache_bits", "auto", "--budgets", "2,4", "--batch", "2",
        "--prompt_len", "4", "--gen", "4"])
    eng = out["engine"]
    assert eng["allocation"] == "layerwise" and eng["cache_bits"] == "auto"
    assert eng["compilations_after_warmup"] == 0
    assert eng["cache_bits_by_rung"] == {2: None, 4: None}
    assert {r["rung_bits"] for r in out["requests"]} == {2, 4}
    for r in out["requests"]:
        assert r["allocation"] == "layerwise"
        assert r["per_module_share"]
        assert set(r["cache_bits"]) == {"attn.k_cache", "attn.v_cache"}
