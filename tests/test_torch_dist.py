"""``repro_torch.dist`` on torch.distributed against the JAX package, on
CPU gloo ranks.

Every multi-rank case of this file runs in ONE spawned group of 4 ranks
(``_torch_dist_worker.spawn_group``), started on a ``FileStore`` under
the test's temporary directory, so no fixed port clashes across
pytest-xdist workers, and no process group is left up in the pytest
worker. The MoE capacity dispatch and tensor-parallel training have
groups of their own (``test_torch_dist_moe.py``,
``test_torch_dist_tp.py``). The JAX references run in this process, on
its one CPU device:

* ``compressed_psum_mean``: through ``jax.vmap(..., axis_name="data")``
  over the 4 ranks' stacked shards; the int8 wire codes exactly, the mean
  and the residual within 1e-6 of their largest value;
* ``pipeline_stack`` over a 2-stage "pod" axis of a (2, 2) mesh: against
  the sequential ``lax.scan`` fold, forward within 1e-5, gradient within
  1e-4 relative;
* elastic restore: a (4, 1) FSDP-sharded train state saved, restored onto
  (2, 2) and as one rank's arrays: every value exact.
"""
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest

import _torch_dist_worker as W
from repro.dist import collectives as RC

PSUM_RTOL = 1e-6
PIPE_ATOL, PIPE_GRAD_RTOL = 1e-5, 1e-4


@pytest.fixture(scope="module")
def group_run(tmp_path_factory):
    """The spawned 4-rank group's outputs (its temporary directory)."""
    tmp = str(tmp_path_factory.mktemp("dist"))
    W.spawn_group(tmp, ("psum", "pipeline", "elastic"))
    return tmp


# ---------------------------------------------------------------------------
# compressed_psum_mean
# ---------------------------------------------------------------------------

def test_compressed_psum_mean_matches_reference(group_run):
    shards = [W.psum_inputs(r) for r in range(W.WORLD)]
    g = {k: np.stack([s[0][k] for s in shards]) for k in W.PSUM_SHAPES}
    e = {k: np.stack([s[1][k] for s in shards]) for k in W.PSUM_SHAPES}
    mean, err = jax.vmap(lambda a, b: RC.compressed_psum_mean(a, b, "data"),
                         axis_name="data")(g, e)
    got = [np.load(os.path.join(group_run, f"psum_{r}.npz"))
           for r in range(W.WORLD)]
    for k in W.PSUM_SHAPES:
        val = g[k] + e[k]
        scale = np.float32(max(np.abs(val).max(), np.float32(1e-30))) \
            / np.float32(127.0)
        # the reference's wire codes, read back off its residual
        codes = np.rint((val - np.asarray(err[k])) / scale)
        for r in range(W.WORLD):
            np.testing.assert_array_equal(got[r][f"codes_{k}"], codes[r])
            # the sum over ranks runs in another order than XLA's psum:
            # relative to the largest value
            for name, want in (("mean", mean[k]), ("err", err[k])):
                want = np.asarray(want)[r]
                rel = (np.abs(got[r][f"{name}_{k}"] - want).max()
                       / np.abs(want).max())
                assert rel <= PSUM_RTOL, (name, k, r, rel)


# ---------------------------------------------------------------------------
# pipeline_stack
# ---------------------------------------------------------------------------

def test_pipeline_stack_matches_sequential_fold(group_run):
    ws, x = W.pipe_inputs()

    def fold(ws, x):
        h, _ = jax.lax.scan(lambda h, w: (jnp.tanh(h @ w), None), x, ws)
        return h

    out = fold(ws, x)
    gw, gx = jax.grad(lambda w, v: jnp.sum(fold(w, v) ** 2),
                      argnums=(0, 1))(ws, x)
    got = np.load(os.path.join(group_run, "pipe.npz"))
    np.testing.assert_allclose(got["out"], np.asarray(out), rtol=0,
                               atol=PIPE_ATOL)
    for name, want in (("gw", gw), ("gx", gx)):
        want = np.asarray(want)
        rel = np.abs(got[name] - want).max() / np.abs(want).max()
        assert rel <= PIPE_GRAD_RTOL, (name, rel)


# ---------------------------------------------------------------------------
# elastic restore
# ---------------------------------------------------------------------------

def test_checkpoint_restores_exactly_on_another_mesh(group_run):
    with open(os.path.join(group_run, "elastic.json")) as f:
        res = json.load(f)
    assert res["sharded_leaves_41"] > 0 and res["sharded_leaves_22"] > 0
    assert res["equal_22"] and all(res["equal_22"].values()), \
        [k for k, v in res["equal_22"].items() if not v]
    assert res["equal_11"] and all(res["equal_11"].values()), \
        [k for k, v in res["equal_11"].items() if not v]
    assert res["port_layout_equal"]
