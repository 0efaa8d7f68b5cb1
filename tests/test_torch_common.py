"""Shared set-up of the port's parity tests (``tests/test_torch_*.py``) and
the checks of the carried-across layouts, the framework-free core and the
ladder: the same seeded inputs go through the JAX package and
``repro_torch`` on the CPU.

Reduced llama3-8b: 2 layers, d=64, 4 heads, kv=1, hd=16, d_ff=128,
vocab 512.
"""
import dataclasses
import functools

import jax
import numpy as np
import pytest
import torch

from repro import configs as rconfigs
from repro.core import costs as rcosts
from repro.core import planner as rplanner
from repro.models import model as RMD
from repro.models import serving as RSV
from repro.serve_engine import build_ladder as r_build_ladder
from repro_torch import configs as tconfigs
from repro_torch.convert import (params_from_reference,
                                 weight_store_from_reference)
from repro_torch.core import costs as tcosts
from repro_torch.core import planner as tplanner
from repro_torch.serve_engine import build_ladder as t_build_ladder

LADDER = (2, 4, 6)


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """One torch intra-op thread for a module that imports this fixture:
    the reduced configs run thousands of small torch ops, and under the
    suite's six workers every worker's pool of threads contends for the
    same cores (a fleet case took 7 s alone and 456 s in the suite before
    its file pinned one thread). Each comparison is against the JAX
    package within its bound or between two port paths in one process,
    so none depends on the thread count."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)
# a frozen activation-range collection: two projection roles and both
# cache roles get hoisted (s, z) leaves; the rest stay dynamic
CALIB = {"attn.wq": (-1.5, 2.25), "mlp.w_down": (0.1, 0.7),
         "attn.k_cache": (-2.0, 2.0), "attn.v_cache": (-0.5, 1.5)}


def ref_cfg():
    return rconfigs.reduced(rconfigs.get_config("llama3-8b"))


def port_cfg():
    return tconfigs.reduced(tconfigs.get_config("llama3-8b"))


def tonp(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def rung_specs(cfg):
    return {op.bits: (op.r, op.b_x_tilde)
            for op in r_build_ladder(LADDER, d=float(cfg.d_model))}


@functools.lru_cache(maxsize=None)
def reference_store(cache_bits=4, calib=False, seed=0):
    """(ref cfg, ref params, ref WeightStore, port WeightStore) with packed
    planes, carried across onto the CPU."""
    cfg = ref_cfg()
    params = RMD.init_params(jax.random.PRNGKey(seed), cfg)
    spec = RSV.ServingQuantSpec(pack_planes=True, cache_bits=cache_bits,
                                calib=CALIB if calib else None)
    ws = RSV.build_weight_store(params, cfg, rung_specs(cfg), spec=spec)
    pws = weight_store_from_reference(
        tonp(ws.store), {k: tonp(v) for k, v in ws.views.items()},
        port_cfg(), "cpu")
    return cfg, params, ws, pws


def ref_layer_view(view, layer, *path):
    """One layer's node of a reference view, group axis sliced away."""
    node = view["decoder"]["groups"]["layers"][0]
    for k in path:
        node = node[k]
    return jax.tree_util.tree_map(lambda a: a[layer], node)


def test_params_carry_across_layer_by_layer():
    cfg = ref_cfg()
    params = RMD.init_params(jax.random.PRNGKey(3), cfg)
    tp = params_from_reference(tonp(params), port_cfg(), "cpu")
    assert len(tp["layers"]) == cfg.num_layers
    for i in range(cfg.num_layers):
        ref_w = np.asarray(
            params["decoder"]["groups"]["layers"][0]["mlp"]["w_up"]["w"][i])
        assert np.array_equal(tp["layers"][i]["mlp"]["w_up"]["w"].numpy(),
                              ref_w)
    assert np.array_equal(tp["embed"]["table"].numpy(),
                          np.asarray(params["embed"]["table"]))


def test_carried_views_alias_the_store():
    _, _, ws, pws = reference_store()
    for bits in LADDER:
        v = pws.views[bits]["layers"][1]["mlp"]["w_gate"]
        s = pws.store["layers"][1]["mlp"]["w_gate"]
        assert v["w_q"] is s["w_q"] and v["w_planes_pos"] is s["w_planes_pos"]
        ref = ref_layer_view(ws.views[bits], 1, "mlp", "w_gate")
        for key in ("plane_shift", "w_colsum", "act_nlvl"):
            assert np.array_equal(v[key].numpy(), np.asarray(ref[key]))


@pytest.mark.parametrize("arch_cut", ["reduced", "full"])
def test_module_cost_profile_matches_reference(arch_cut):
    rc = rconfigs.get_config("llama3-8b")
    tc = tconfigs.get_config("llama3-8b")
    if arch_cut == "reduced":
        rc, tc = rconfigs.reduced(rc), tconfigs.reduced(tc)
    assert [dataclasses.astuple(m) for m in rcosts.module_cost_profile(rc)] \
        == [dataclasses.astuple(m) for m in tcosts.module_cost_profile(tc)]
    for ctx in (16, 4096):
        assert dataclasses.astuple(rcosts.macs_per_token(rc, ctx)) == \
            dataclasses.astuple(tcosts.macs_per_token(tc, ctx))


@pytest.mark.parametrize("d", [64.0, 4096.0])
def test_ladder_rungs_match_reference(d):
    r = r_build_ladder(LADDER, d=d)
    t = t_build_ladder(LADDER, d=d)
    assert [(op.bits, op.r, op.b_x_tilde, op.power) for op in r] \
        == [(op.bits, op.r, op.b_x_tilde, op.power) for op in t]
    for bits in range(2, 9):
        assert rplanner.budget_from_bits(bits) == \
            tplanner.budget_from_bits(bits)
        assert dataclasses.astuple(
            rplanner.plan_with_theory(rplanner.budget_from_bits(bits))) \
            == dataclasses.astuple(
                tplanner.plan_with_theory(tplanner.budget_from_bits(bits)))
