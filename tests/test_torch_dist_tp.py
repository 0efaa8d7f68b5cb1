"""Tensor-parallel training of the port on CPU gloo ranks against the JAX
package's single-device train step.

``launch.train`` runs on a 2 x 2 ("data", "model") mesh (2-way tensor
parallelism) in ONE spawned group of 4 ranks for this file
(``_torch_dist_worker.spawn_group``, a ``FileStore`` under the test's
temporary directory), resumed from the reference's step-0 state (a
checkpoint this process writes while the ranks start), for one step.
The reference's ``train_step`` runs here from that state on the same
batch while the ranks train: the loss within rel 2e-3, the reference's
own tolerance (tests/test_dist_multidev.py:185); every gradient, read
off the AdamW first moment of the step-1 checkpoint, within 1e-4 of its
leaf's largest value.
"""
import functools
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest

import _torch_dist_worker as W
from repro.ckpt import checkpoint as rck
from repro.data.pipeline import SyntheticLM
from repro.launch import steps as RST
from repro.launch import train as RTR

TP_RTOL = 2e-3
GRAD_RTOL = 1e-4


@pytest.fixture(scope="module")
def tp_run(tmp_path_factory):
    """(the spawned group's directory, the rank-0 summary of its TP run,
    the reference's state and metrics after its step, computed here while
    the ranks train)."""
    tmp = str(tmp_path_factory.mktemp("dist_tp"))
    args = W.reference_args(W.TRAIN_ARGV)
    cfg, tcfg, par = RTR.build(args)
    # jitted: one compile instead of one an eager op
    state0 = jax.jit(lambda k: RST.make_train_state(k, cfg, tcfg))(
        jax.random.PRNGKey(0))

    def prepare():
        rck.save(os.path.join(tmp, "tp_ckpt"), 0, state0)

    def reference():
        batch = SyntheticLM(vocab_size=cfg.vocab_size, seq_len=args.seq,
                            global_batch=args.batch,
                            seed=args.seed).global_batch_arrays(0)
        return jax.jit(functools.partial(
            RST.train_step, cfg=cfg, tcfg=tcfg, par=par))(
            state0, {k: jnp.asarray(v) for k, v in batch.items()})

    ref = W.spawn_group(tmp, ("tp",), prepare, reference)
    with open(os.path.join(tmp, "tp.json")) as f:
        return tmp, json.load(f), ref


def test_tp_training_matches_single_device_reference(tp_run):
    tmp, tp, (state, metrics) = tp_run
    assert tp["mesh"] == {"data": 2, "model": 2}
    (got,) = tp["losses_exact"]
    want = float(metrics["loss"])
    assert abs(got - want) <= TP_RTOL * abs(want), (got, want)
    # after one step the AdamW first moment is (1 - b1) times the
    # (clipped) gradient, in both packages
    mine = rck.restore(os.path.join(tmp, "tp_ckpt"), 1,
                       jax.tree_util.tree_map(np.asarray, state))
    flat_got = dict(jax.tree_util.tree_leaves_with_path(mine.opt.mu))
    for path, want in jax.tree_util.tree_leaves_with_path(state.opt.mu):
        want = np.asarray(want)
        err = np.abs(np.asarray(flat_got[path]) - want).max()
        assert err <= GRAD_RTOL * max(np.abs(want).max(), 1e-30), \
            (jax.tree_util.keystr(path), err, np.abs(want).max())
