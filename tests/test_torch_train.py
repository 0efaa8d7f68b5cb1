"""The port's training path against the JAX package on the CPU: ``lm_loss``
and its gradients (fp, PANN QAT, QAT against a calibration collection),
``train_step`` (AdamW, the EMA fold, gradient accumulation over
microbatches) from one state carried across (``convert``), the trainer
CLI (its refusals, a mid-anneal resume that is bit-exact).

Reduced llama3-8b (2 layers, d 64, vocab 512), batch 4 x 16 tokens from
``SyntheticLM``. The reference is jitted, as its trainer runs it; the
tolerances are stated per test.
"""
import json
import os
import types
from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as rconfigs
from repro.configs.base import ParallelConfig as RParallelConfig
from repro.configs.base import QuantConfig as RQuantConfig
from repro.configs.base import TrainConfig as RTrainConfig
from repro.core import calibrate as RCAL
from repro.data.pipeline import SyntheticLM
from repro.launch import steps as RST
from repro.models import model as RMD
from repro_torch import configs as tconfigs
from repro_torch import convert
from repro_torch.configs.base import ParallelConfig, QuantConfig, TrainConfig
from repro_torch.launch import steps as TST
from repro_torch.launch import train as TTR
from repro_torch.models import model as TMD

ARCH = "llama3-8b"
QC = dict(mode="pann", r=2.0, act_bits_tilde=6, act_bits=6, qat=True)


def rcfg(**quant):
    q = RQuantConfig(**quant) if quant else None
    return rconfigs.reduced(rconfigs.get_config(ARCH, quant=q))


def tcfg(**quant):
    q = QuantConfig(**quant) if quant else None
    return tconfigs.reduced(tconfigs.get_config(ARCH, quant=q))


def _batch(step=0, b=4, t=16):
    return SyntheticLM(vocab_size=512, seq_len=t, global_batch=b,
                       seed=11).global_batch_arrays(step)


def _tbatch(host):
    return {k: torch.from_numpy(v).long() for k, v in host.items()}


def _to_port(tree):
    """A reference-layout numpy tree (params or grads) in the port's."""
    return convert.params_from_reference(tree, tcfg(), "cpu")


def _leaves(tree, prefix=""):
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _leaves(tree[k], f"{prefix}{k}/")
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from _leaves(v, f"{prefix}#{i}/")
    else:
        yield prefix[:-1], tree


@pytest.fixture(scope="module")
def ref_params():
    return RMD.init_params(jax.random.PRNGKey(2), rcfg())


def _collection(seed=3):
    rng = np.random.default_rng(seed)
    out = {}
    for p in RCAL.calib_paths(rcfg()):
        lo = -rng.random() * 3
        out[p] = np.asarray([lo, lo + 0.5 + rng.random() * 4], np.float32)
    out["attn.wo"] = np.asarray(RCAL.UNSEEN, np.float32)
    return out


@pytest.mark.parametrize("case", ["fp", "qat", "qat_calib"])
def test_lm_loss_and_grads_match_reference(ref_params, case):
    """lm_loss (labels of -1 masked) and its gradient w.r.t. every param:
    the loss within 1e-5 relative, each gradient leaf within
    1e-4 * max|g| of the reference's jax.value_and_grad, the observed
    ranges of the calibrated case within 1e-5 * their max |bound|."""
    qc = {} if case == "fp" else QC
    rc, tc = rcfg(**qc), tcfg(**qc)
    host = _batch()
    calib = _collection() if case == "qat_calib" else None

    def rloss(p, calib):
        return RMD.lm_loss(p, rc, jnp.asarray(host["tokens"]),
                           jnp.asarray(host["labels"]), remat=False,
                           calib=calib, return_calib=True)

    rcal = None if calib is None else {k: jnp.asarray(v)
                                       for k, v in calib.items()}
    (wl, wobs), wg = jax.jit(jax.value_and_grad(rloss, has_aux=True))(
        ref_params, rcal)
    params = _to_port(jax.tree_util.tree_map(np.asarray, ref_params))
    leaves = [t for _, t in _leaves(params)]
    for p in leaves:
        p.requires_grad_(True)
    tb = _tbatch(host)
    loss, obs = TMD.lm_loss(
        params, tc, tb["tokens"], tb["labels"], remat=False,
        calib=None if calib is None else {k: torch.from_numpy(v)
                                          for k, v in calib.items()},
        return_calib=True)
    grads = torch.autograd.grad(loss, leaves)
    np.testing.assert_allclose(loss.item(), float(wl), rtol=1e-5)
    want = dict(_leaves(_to_port(jax.tree_util.tree_map(np.asarray, wg))))
    names = [k for k, _ in _leaves(params)]
    assert names == list(want)
    for name, g in zip(names, grads):
        w = want[name].numpy()
        np.testing.assert_allclose(g.numpy(), w, rtol=0,
                                   atol=1e-4 * np.abs(w).max(),
                                   err_msg=name)
    if calib is None:
        assert obs is None and wobs is None
    else:
        for k, v in wobs.items():
            w = np.asarray(v)
            np.testing.assert_allclose(obs[k].numpy(), w, rtol=0,
                                       atol=1e-5 * np.abs(w).max(),
                                       err_msg=k)


@pytest.mark.parametrize("microbatches", [1, 2])
def test_train_steps_match_reference(ref_params, microbatches):
    """Three QAT train_steps with a calibration collection from one state
    carried across: the losses within 1e-4 relative, the EMA ranges within
    1e-5 * their max |bound|, the gradient norms within 1e-4 relative,
    the step and AdamW count equal. (Params are not compared: Adam
    divides each moment by its own root, so an element whose gradient is
    a cancellation near 0 moves by about lr either way.)"""
    rc, tc = rcfg(**QC), tcfg(**QC)
    rtc = RTrainConfig(total_steps=8, warmup_steps=2, lr=1e-2,
                       calib_decay=0.9)
    ttc = TrainConfig(total_steps=8, warmup_steps=2, lr=1e-2,
                      calib_decay=0.9)
    rstate = RST.make_train_state(jax.random.PRNGKey(2), rc, rtc,
                                  calibrate=True)
    rstate = rstate._replace(params=ref_params)
    tstate = convert.train_state_from_reference(
        jax.tree_util.tree_map(np.asarray, rstate), tc, "cpu")
    matrix = convert.reference_matrix_mask(tstate.params, tc)
    fn = jax.jit(partial(RST.train_step, cfg=rc, tcfg=rtc,
                         par=RParallelConfig(remat="none",
                                             microbatches=microbatches)))
    par = ParallelConfig(remat="none", microbatches=microbatches)
    for step in range(3):
        host = _batch(step)
        rstate, rm = fn(rstate, {k: jnp.asarray(v) for k, v in host.items()})
        tstate, tm = TST.train_step(tstate, _tbatch(host), cfg=tc, tcfg=ttc,
                                    par=par, matrix=matrix)
        np.testing.assert_allclose(float(tm["loss"]), float(rm["loss"]),
                                   rtol=1e-4)
        np.testing.assert_allclose(float(tm["grad_norm"]),
                                   float(rm["grad_norm"]), rtol=1e-4)
        for k, v in rstate.calib.items():
            w = np.asarray(v)
            np.testing.assert_allclose(tstate.calib[k].numpy(), w, rtol=0,
                                       atol=1e-5 * np.abs(w).max(),
                                       err_msg=k)
    assert int(tstate.step) == int(rstate.step) == 3
    assert int(tstate.opt.count) == int(rstate.opt.count) == 3


def test_train_quant_tri_state():
    """resolve_train_quant: the reference's cases."""
    def args(**kw):
        ns = dict(quant="none", train_quant="", budget_schedule="")
        ns.update(kw)
        return types.SimpleNamespace(**ns)

    assert TTR.resolve_train_quant(args()) == "none"
    assert TTR.resolve_train_quant(args(quant="pann")) == "qat"
    assert TTR.resolve_train_quant(args(quant="pann",
                                        train_quant="ptq")) == "ptq"
    for bad in (dict(train_quant="qat"),
                dict(quant="pann", train_quant="none"),
                dict(quant="pann", train_quant="ptq", budget_schedule="0:8"),
                dict(quant="ruq", train_quant="qat", budget_schedule="0:8")):
        with pytest.raises(ValueError):
            TTR.resolve_train_quant(args(**bad))


def test_train_cli_refusals(tmp_path):
    """Tensor parallelism outside torchrun (one process, no ranks to split
    the model over) is refused naming torchrun; a bad quant combo and a
    finished checkpoint exit as the reference's do."""
    base = ["--arch", ARCH, "--reduced", "--batch", "2", "--seq", "8",
            "--device", "cpu", "--log_every", "100"]
    with pytest.raises(SystemExit, match="torchrun"):
        TTR.main(base + ["--model_axis", "2"])
    with pytest.raises(SystemExit, match="needs a quantization"):
        TTR.main(base + ["--train_quant", "qat"])
    ck = str(tmp_path / "ck")
    TTR.main(base + ["--steps", "2", "--ckpt_dir", ck, "--ckpt_every", "2"])
    with pytest.raises(SystemExit, match="already at step"):
        TTR.main(base + ["--steps", "2", "--ckpt_dir", ck])


SCHEDULE = "0:fp,2:8,5:6"
STEPS = 8
BASE = ["--arch", ARCH, "--reduced", "--batch", "2", "--seq", "16",
        "--quant", "pann", "--train_quant", "qat",
        "--budget_schedule", SCHEDULE, "--allocation", "layerwise",
        "--lr", "1e-2", "--log_every", "100", "--device", "cpu",
        "--anneal_warmup", "2"]


def _train(ckpt_dir, steps):
    return TTR.main(BASE + ["--ckpt_dir", str(ckpt_dir), "--steps",
                            str(steps), "--total_steps", str(STEPS),
                            "--ckpt_every", "4"])


def test_mid_anneal_resume_bit_exact(tmp_path):
    """The port's trainer: 8 steps straight, against 4 steps, a
    checkpoint, a restore and 4 more (resumed inside the 8-bit segment,
    with the LR re-warmup ramps on): the same losses, eval loss, params,
    AdamW moments and calibration ranges, bit for bit; the resumed run
    replans the allocator identically."""
    full = _train(tmp_path / "full", STEPS)
    first = _train(tmp_path / "resume", 4)
    resumed = _train(tmp_path / "resume", STEPS)
    assert first["losses"] == full["losses"][:4]
    assert resumed["losses"] == full["losses"][4:]
    assert resumed["eval_loss"] == full["eval_loss"]
    plans = {p["step"]: p for p in resumed["plans"]}
    for p in full["plans"]:
        if p["step"] in plans:
            assert plans[p["step"]]["gbitflips_per_token"] == \
                p["gbitflips_per_token"]
    a = np.load(os.path.join(tmp_path, "full", f"step_{STEPS:08d}",
                             "arrays.npz"))
    b = np.load(os.path.join(tmp_path, "resume", f"step_{STEPS:08d}",
                             "arrays.npz"))
    assert sorted(a.files) == sorted(b.files)
    assert any(k.startswith("calib/") for k in a.files)
    for k in a.files:
        np.testing.assert_array_equal(a[k], b[k], err_msg=k)
    lo, hi = a["calib/attn.wq"]
    assert np.isfinite([lo, hi]).all() and lo < hi
    with open(os.path.join(tmp_path, "full", f"step_{STEPS:08d}",
                           "meta.json")) as f:
        assert json.load(f)["eval_loss"] == resumed["eval_loss"]
