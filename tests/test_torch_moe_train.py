"""The port's single-process trainer on a capacity-dispatch MoE config
against the JAX package's trainer, on the CPU.

Reduced mixtral-8x7b (``moe_impl="capacity"``, 4 experts, top-2, its own
capacity factor 1.25). Both trainers run as one process under their
1 x 1 mesh, so both route through the capacity dispatch, which drops
routes on these batches. Both resume from one step-0 state the
reference wrote (a checkpoint) and train 3 fp steps on the same batches:
the losses and the held-out eval loss within 1e-4 relative. Then the
port trains 3 PANN QAT steps and exports its checkpoint: the drift gate
re-evaluates the recorded eval loss through the same dispatch.
"""
import os
import shutil

import jax
import numpy as np
import pytest
import torch

import _torch_dist_worker as W
from repro.ckpt import checkpoint as rck
from repro.launch import steps as RST
from repro.launch import train as RTR
from repro_torch.dist import moe_ep as TMOE
from repro_torch.launch import export as TEX
from repro_torch.launch import train as TTR

STEPS = 3
ARGV = ["--arch", "mixtral-8x7b", "--reduced", "--batch", "4", "--seq",
        "16", "--steps", str(STEPS), "--lr", "1e-2", "--log_every", "100"]
QAT = ["--quant", "pann", "--train_quant", "qat"]
# the losses and eval loss, relative (the train steps' tolerance in
# tests/test_torch_train.py)
LOSS_RTOL = 1e-4


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    """The reduced configs run many tiny torch ops; one intra-op thread
    keeps them from contending with the other test workers' threads for
    the cores (the tolerances do not depend on it)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _counted(argv):
    """``launch.train.main(argv)`` on the CPU, and the (routes, kept) of
    each capacity dispatch it ran."""
    plans = []
    real = TMOE.dispatch_plan

    def counted(mask, capacity):
        keep, pos = real(mask, capacity)
        plans.append((int(mask.sum()), int(keep.sum())))
        return keep, pos

    mp = pytest.MonkeyPatch()
    mp.setattr(TMOE, "dispatch_plan", counted)
    try:
        return TTR.main(argv + ["--device", "cpu"]), plans
    finally:
        mp.undo()


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """{"ref": the reference trainer's summary, "fp": the port's summary
    and dispatches from the same step-0 state, "qat": the port's QAT
    summary, dispatches and checkpoint directory}."""
    root = tmp_path_factory.mktemp("moe_train")
    ref_dir, port_dir = str(root / "ref"), str(root / "port")
    cfg, tcfg, _ = RTR.build(W.reference_args(ARGV))
    assert cfg.moe_impl == "capacity" and cfg.moe.capacity_factor == 1.25
    rck.save(ref_dir, 0, RST.make_train_state(jax.random.PRNGKey(0), cfg,
                                              tcfg))
    shutil.copytree(ref_dir, port_dir)
    qat_dir = str(root / "qat")
    return {"ref": RTR.main(ARGV + ["--ckpt_dir", ref_dir]),
            "fp": _counted(ARGV + ["--ckpt_dir", port_dir]),
            "qat": _counted(ARGV + QAT + ["--ckpt_dir", qat_dir])
            + (qat_dir,)}


def test_capacity_training_matches_reference_trainer(runs):
    """The port routed every MoE layer through the capacity dispatch and
    dropped routes; its 3 losses and its eval loss equal the reference
    trainer's within 1e-4 relative."""
    ref, (port, plans) = runs["ref"], runs["fp"]
    assert plans and sum(r - k for r, k in plans) > 0, plans
    assert port["mesh"] == {"data": 1, "model": 1}
    assert len(port["losses_exact"]) == len(ref["losses"]) == STEPS
    np.testing.assert_allclose(port["losses_exact"], ref["losses"],
                               rtol=LOSS_RTOL)
    np.testing.assert_allclose(port["eval_loss"], ref["eval_loss"],
                               rtol=LOSS_RTOL)


def test_capacity_training_exports_through_drift_gate(runs, tmp_path):
    """The QAT run's held-out eval dropped routes; the port's export of
    its checkpoint re-evaluates the recorded eval loss through the same
    capacity dispatch, bit for bit, and both of the reference's gates
    pass at tol 1e-3 (no SystemExit)."""
    port, plans, ckpt = runs["qat"]
    cfg, _, _ = RTR.build(W.reference_args(ARGV))
    # the last dispatches are the held-out eval's, one a layer
    assert sum(r - k for r, k in plans[-cfg.num_layers:]) > 0, plans
    out = TEX.main(["--ckpt_dir", ckpt, "--out", str(tmp_path / "single"),
                    "--tol", "1e-3", "--device", "cpu"])
    assert out["meta_eval_loss"] == port["eval_loss"]
    # the same forward on the restored params: bit for bit on the CPU
    # (through the scan it would differ by the dropped routes, within the
    # gate's 1e-3)
    assert out["loss_train_eval"] == port["eval_loss"]
    assert out["rel_diff"] <= 1e-3
    assert os.path.isdir(tmp_path / "single")
