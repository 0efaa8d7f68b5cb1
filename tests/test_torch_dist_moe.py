"""The MoE capacity dispatch (``repro_torch.dist.moe_ep``) against the
JAX package's, on the CPU.

* In process: ``apply_moe_capacity`` against the reference's on a
  ``jax.make_mesh((1, 1), ("data", "model"))`` at a capacity factor that
  drops tokens: the keep mask equal, y and the aux loss within 1e-5, the
  gradients within 1e-4 (relative to each one's largest value); and the
  layer takes it only under a ``DeviceMesh``.
* On a real mesh: one ``launch.train`` step of reduced mixtral (its own
  capacity factor 1.25, routes dropped) on a (4, 1) mesh of CPU gloo
  ranks, the experts over "data" and DTensors throughout, in ONE
  spawned group for this file (``_torch_dist_worker.spawn_group``, a
  ``FileStore`` under the test's temporary directory), resumed from the
  reference's step-0 state; against the reference's ``train_step`` under
  its 1 x 1 mesh, run here while the ranks work: the loss within 1e-4
  relative, every gradient (read off the AdamW first moment) within 1e-4
  of its leaf's largest value.
"""
import dataclasses
import json
import math
import os
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import _torch_dist_worker as W
from repro import configs as rconfigs
from repro.ckpt import checkpoint as rck
from repro.data.pipeline import SyntheticLM
from repro.dist import moe_ep as RMOE
from repro.launch import steps as RST
from repro.launch import train as RTR
from repro.models import mlp as RM
from repro_torch import configs as tconfigs
from repro_torch.dist import moe_ep as TMOE
from repro_torch.dist.constrain import use_mesh
from repro_torch.models import mlp as TM
from repro_torch.models import transformer as TT

CAP_RTOL, CAP_GRAD_RTOL = 1e-5, 1e-4
EP_RTOL = 1e-4


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    """The reduced configs run many tiny torch ops; one intra-op thread
    keeps them from contending with the other test workers' threads for
    the cores (the tolerances do not depend on it)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# ---------------------------------------------------------------------------
# the capacity dispatch (in process)
# ---------------------------------------------------------------------------

def _moe_case(seed=11):
    rcfg = rconfigs.reduced(rconfigs.get_config("mixtral-8x7b"))
    tcfg = tconfigs.reduced(tconfigs.get_config("mixtral-8x7b"))
    # 0.5: fewer slots than routes, so tokens are dropped
    rcfg = dataclasses.replace(rcfg, moe=dataclasses.replace(
        rcfg.moe, capacity_factor=0.5))
    tcfg = dataclasses.replace(tcfg, moe=dataclasses.replace(
        tcfg.moe, capacity_factor=0.5))
    rng = np.random.default_rng(seed)
    e, d, ff = tcfg.moe.num_experts, tcfg.d_model, tcfg.d_ff
    p = {"router": {"w": rng.standard_normal((d, e)) * 0.5},
         "w_gate": rng.standard_normal((e, d, ff)) * d ** -0.5,
         "w_up": rng.standard_normal((e, d, ff)) * d ** -0.5,
         "w_down": rng.standard_normal((e, ff, d)) * ff ** -0.5}
    p = jax.tree_util.tree_map(lambda a: a.astype(np.float32), p)
    x = rng.standard_normal((2, 16, d)).astype(np.float32)
    return rcfg, tcfg, p, x


def test_capacity_dispatch_matches_reference():
    rcfg, tcfg, p, x = _moe_case()
    mesh = jax.make_mesh((1, 1), ("data", "model"))

    def ref_loss(p, x):
        y, aux = RMOE.apply_moe_capacity(x, p, rcfg, mesh)
        return jnp.sum(y ** 2) + aux, (y, aux)

    (_, (ry, raux)), (rgp, rgx) = jax.jit(jax.value_and_grad(
        ref_loss, argnums=(0, 1), has_aux=True))(p, x)
    # the reference's keep mask, from its router
    _, rmask, _ = RM.route(jnp.asarray(x), p, rcfg)
    n, e = x.shape[0] * x.shape[1], rcfg.moe.num_experts
    cap = max(1, min(int(math.ceil(rcfg.moe.capacity_factor * n
                                   * rcfg.moe.top_k / e)), n))
    rm = np.asarray(rmask).reshape(n, e)
    rkeep = rm & (np.cumsum(rm.astype(np.int32), axis=0) - 1 < cap)
    assert rkeep.sum() < rm.sum(), "the case drops no token"

    tp = jax.tree_util.tree_map(lambda a: torch.tensor(a,
                                                       requires_grad=True),
                                p)
    tx = torch.tensor(x, requires_grad=True)
    _, tmask, _ = TM.route(tx, tp, tcfg)
    assert TMOE.capacity_of(tcfg, n) == cap
    tkeep, _ = TMOE.dispatch_plan(tmask.reshape(n, e), cap)
    np.testing.assert_array_equal(tkeep.numpy(), rkeep)
    stand_in = types.SimpleNamespace(axis_names=("data", "model"),
                                     shape={"data": 1, "model": 1})
    ty, taux = TMOE.apply_moe_capacity(tx, tp, tcfg, stand_in)
    (ty.pow(2).sum() + taux).backward()
    np.testing.assert_allclose(ty.detach().numpy(), np.asarray(ry),
                               rtol=CAP_RTOL, atol=CAP_RTOL)
    np.testing.assert_allclose(taux.item(), float(raux), rtol=CAP_RTOL)
    for got, want in [(tx.grad, rgx)] + [
            (tp[k].grad if k != "router" else tp[k]["w"].grad,
             rgp[k] if k != "router" else rgp[k]["w"])
            for k in ("router", "w_gate", "w_up", "w_down")]:
        want = np.asarray(want)
        rel = np.abs(got.numpy() - want).max() / np.abs(want).max()
        assert rel <= CAP_GRAD_RTOL, rel


def test_layer_takes_capacity_path_only_under_a_mesh(monkeypatch):
    """``transformer._apply_moe_dispatch``: the scan without a mesh (and
    under an abstract stand-in), the capacity dispatch under a
    DeviceMesh, as the reference's."""
    _, tcfg, p, x = _moe_case()
    tp = jax.tree_util.tree_map(torch.tensor, p)
    calls = []
    monkeypatch.setattr(TMOE, "apply_moe_capacity",
                        lambda *a: calls.append(a) or (a[0], a[0].sum()))
    TT._apply_moe_dispatch(torch.tensor(x), tp, tcfg)
    with use_mesh(types.SimpleNamespace(axis_names=("data",),
                                        shape={"data": 1})):
        TT._apply_moe_dispatch(torch.tensor(x), tp, tcfg)
    assert not calls
    fake = object.__new__(__import__(
        "repro_torch.dist.compat", fromlist=["DeviceMesh"]).DeviceMesh)
    with use_mesh(fake):
        TT._apply_moe_dispatch(torch.tensor(x), tp, tcfg)
    assert len(calls) == 1


@pytest.fixture(scope="module")
def group_run(tmp_path_factory):
    """(the spawned group's directory, the reference's state and metrics
    after its step). The reference's step-0 checkpoint is written while
    the ranks start; its step runs while they train."""
    tmp = str(tmp_path_factory.mktemp("dist_moe"))
    args = W.reference_args(W.MOE_ARGV)
    cfg, tcfg, par = RTR.build(args)
    # jitted: one compile instead of one an eager op
    state0 = jax.jit(lambda k: RST.make_train_state(k, cfg, tcfg))(
        jax.random.PRNGKey(0))

    def prepare():
        rck.save(os.path.join(tmp, "moe_ckpt"), 0, state0)

    def reference():
        batch = SyntheticLM(vocab_size=cfg.vocab_size, seq_len=args.seq,
                            global_batch=args.batch,
                            seed=args.seed).global_batch_arrays(0)
        with jax.make_mesh((1, 1), ("data", "model")):
            return jax.jit(lambda s, b: RST.train_step(
                s, b, cfg=cfg, tcfg=tcfg, par=par))(
                state0, {k: jnp.asarray(v) for k, v in batch.items()})

    ref = W.spawn_group(tmp, ("moe_ep",), prepare, reference)
    return tmp, ref


# ---------------------------------------------------------------------------
# the capacity dispatch on a (4, 1) mesh
# ---------------------------------------------------------------------------

def test_capacity_dispatch_on_mesh_matches_reference(group_run):
    """One train step of reduced mixtral on a (4, 1) mesh: every layer
    took the capacity dispatch, routes were dropped, the expert buffer
    was sharded over "data", and the loss and every gradient equal the
    reference's step under its 1 x 1 mesh."""
    tmp, (state, metrics) = group_run
    cfg, _, _ = RTR.build(W.reference_args(W.MOE_ARGV))
    with open(os.path.join(tmp, "moe.json")) as f:
        got = json.load(f)
    # one dispatch a layer (every layer of mixtral is attn_moe) in the
    # step's forward and one in the held-out eval's
    assert got["summary"]["mesh"] == {"data": 4, "model": 1}
    plans = got["plans"]
    assert len(plans) == 2 * cfg.num_layers, plans
    assert sum(r - k for r, k in plans) > 0, plans
    # the expert buffer (E, C, d) sharded over "data" (E = 4 divides it)
    assert ["Shard(0)", "Replicate"] in got["placements"], \
        got["placements"]
    np.testing.assert_allclose(got["summary"]["losses_exact"],
                               [float(metrics["loss"])], rtol=EP_RTOL)
    # after one step the AdamW first moment is (1 - b1) times the
    # (clipped) gradient, in both packages
    mine = rck.restore(os.path.join(tmp, "moe_ckpt"), 1,
                       jax.tree_util.tree_map(np.asarray, state))
    flat_got = dict(jax.tree_util.tree_leaves_with_path(mine.opt.mu))
    for path, want in jax.tree_util.tree_leaves_with_path(state.opt.mu):
        want = np.asarray(want)
        err = np.abs(np.asarray(flat_got[path]) - want).max()
        assert err <= EP_RTOL * max(np.abs(want).max(), 1e-30), \
            (jax.tree_util.keystr(path), err, np.abs(want).max())
