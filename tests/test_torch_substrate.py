"""The training substrate of the port against the JAX package, on the CPU:
the synthetic LM stream, the budget schedule and annealer, the
calibration collection's arithmetic, the clip and LSQ quantizers, AdamW
and its LR schedule, the checkpoint format across packages, the bit-flip
simulators and the step monitor.

Every input comes from a numpy seed; tolerances are stated per test.
"""
import dataclasses
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as rconfigs
from repro.ckpt import checkpoint as RCK
from repro.configs.base import TrainConfig as RTrainConfig
from repro.core import anneal as RAN
from repro.core import bitflip as RBF
from repro.core import calibrate as RCAL
from repro.core import quant as RQ
from repro.data.pipeline import SyntheticLM as RSyntheticLM
from repro.dist.fault import StepMonitor as RStepMonitor
from repro.launch import steps as RST
from repro.optim import optimizers as ROPT
from repro_torch import configs as tconfigs
from repro_torch import convert
from repro_torch.ckpt import checkpoint as TCK
from repro_torch.configs.base import TrainConfig as TTrainConfig
from repro_torch.core import anneal as TAN
from repro_torch.core import bitflip as TBF
from repro_torch.core import calibrate as TCAL
from repro_torch.core import quant as TQ
from repro_torch.data.pipeline import SyntheticLM as TSyntheticLM
from repro_torch.dist.fault import StepMonitor as TStepMonitor
from repro_torch.launch import steps as TST
from repro_torch.optim import optimizers as TOPT

ARCH = "llama3-8b"


def rcfg(arch=ARCH):
    return rconfigs.reduced(rconfigs.get_config(arch))


def tcfg(arch=ARCH):
    return tconfigs.reduced(tconfigs.get_config(arch))


# ---------------------------------------------------------------------------
# data
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("vocab,seq,batch,seed",
                         [(512, 16, 2, 0), (128256, 33, 3, 7)])
def test_synthetic_lm_batches_equal(vocab, seq, batch, seed):
    """SyntheticLM: equal arrays (tokens, labels with -1 at each row's
    end), dtypes and shards, step by step."""
    r = RSyntheticLM(vocab_size=vocab, seq_len=seq, global_batch=batch,
                     seed=seed)
    t = TSyntheticLM(vocab_size=vocab, seq_len=seq, global_batch=batch,
                     seed=seed)
    for step in (0, 1, 5):
        a, b = r.global_batch_arrays(step), t.global_batch_arrays(step)
        assert a.keys() == b.keys()
        for k in a:
            assert a[k].dtype == b[k].dtype
            np.testing.assert_array_equal(a[k], b[k])
        assert (b["labels"][:, -1] == -1).all()
        dev = t.device_batch(step, "cpu")
        np.testing.assert_array_equal(dev["tokens"].numpy(), a["tokens"])
    if batch % 2 == 0:
        np.testing.assert_array_equal(r.host_local_batch(2, 1, 2)["tokens"],
                                      t.host_local_batch(2, 1, 2)["tokens"])


# ---------------------------------------------------------------------------
# budget schedule and annealer
# ---------------------------------------------------------------------------

def test_schedule_parse_and_segments():
    """The reference's cases (tests/test_train_power.py), on the port."""
    s = TAN.BudgetSchedule.parse("0:fp,4:8,12:6")
    assert s.bits_at(0) == 0 and s.bits_at(3) == 0
    assert s.bits_at(4) == 8 and s.bits_at(11) == 8
    assert s.bits_at(12) == 6 and s.bits_at(999) == 6
    assert s.segments(0, 18) == ((0, 4, 0), (4, 12, 8), (12, 18, 6))
    assert s.segments(6, 18) == ((6, 12, 8), (12, 18, 6))
    assert s.segments(5, 5) == ()
    assert s.knot_steps() == (4, 12)
    r = RAN.BudgetSchedule.parse("0:fp,4:8,12:6")
    assert s.describe() == r.describe()
    assert s.segments(3, 40) == r.segments(3, 40)


@pytest.mark.parametrize("bad", ["", "4", "4:8,2:6", "x:8", "3:-1", "3:8.5"])
def test_schedule_parse_rejects(bad):
    for mod in (TAN, RAN):
        with pytest.raises(ValueError):
            mod.BudgetSchedule.parse(bad)


@pytest.mark.parametrize("allocation", ["layerwise", "uniform"])
@pytest.mark.parametrize("arch", [ARCH, "mixtral-8x7b"])
def test_annealer_trees_equal_at_every_knot(allocation, arch):
    """The PolicyTree, plan power and Gbit-flips per token at every knot
    of a schedule: equal to the reference's (the allocator is the same
    float arithmetic), and a stripped config at fp knots."""
    spec = "0:fp,2:8,5:6,9:4"
    r = RAN.BudgetAnnealer(RAN.BudgetSchedule.parse(spec), rcfg(arch),
                           allocation=allocation)
    t = TAN.BudgetAnnealer(TAN.BudgetSchedule.parse(spec), tcfg(arch),
                           allocation=allocation)
    for bits in (0, 8, 6, 4):
        rt, tt = r.tree_for(bits), t.tree_for(bits)
        assert (rt is None) == (tt is None) == (bits == 0)
        if rt is not None:
            assert dataclasses.astuple(rt) == dataclasses.astuple(tt)
        assert r.gbitflips_per_token(bits) == t.gbitflips_per_token(bits)
    for step in (0, 1, 2, 7, 9, 40):
        rc, _, rb = r.config_at(rcfg(arch), step)
        tc, _, tb = t.config_at(tcfg(arch), step)
        assert rb == tb
        assert tc.quant.mode == rc.quant.mode
        assert (tc.policy is None) == (rc.policy is None)


# ---------------------------------------------------------------------------
# calibration collection
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch", [ARCH, "mixtral-8x7b", "zamba2-1.2b",
                                  "rwkv6-1.6b", "seamless-m4t-medium"])
def test_calib_paths_equal(arch):
    assert TCAL.calib_paths(tcfg(arch)) == RCAL.calib_paths(rcfg(arch))
    init = TCAL.init_calib(tcfg(arch), "cpu")
    assert all(not bool(TCAL.seen(v)) for v in init.values())


def test_ema_update_and_merge_bit_exact():
    """ema_update (first observation adopted, unseen kept, the decay
    blend) and merge on fixed inputs: bit-exact with the reference."""
    rng = np.random.default_rng(0)
    paths = ("a", "b", "c", "d")
    unseen = np.asarray(RCAL.UNSEEN, np.float32)

    def draw():
        lo = rng.standard_normal(len(paths)).astype(np.float32)
        hi = lo + rng.random(len(paths)).astype(np.float32)
        return {p: np.asarray([lo[i], hi[i]], np.float32)
                for i, p in enumerate(paths)}

    cur = draw()
    cur["d"] = unseen                       # never seen yet
    for decay in (0.99, 0.9, 0.5):
        obs = draw()
        obs["c"] = unseen                   # this batch did not see "c"
        want = RCAL.ema_update({k: jnp.asarray(v) for k, v in cur.items()},
                               {k: jnp.asarray(v) for k, v in obs.items()},
                               decay)
        got = TCAL.ema_update({k: torch.from_numpy(v) for k, v in
                               cur.items()},
                              {k: torch.from_numpy(v) for k, v in
                               obs.items()}, decay)
        for k in paths:
            np.testing.assert_array_equal(got[k].numpy(), np.asarray(want[k]))
        wm = RCAL.merge({k: jnp.asarray(v) for k, v in cur.items()},
                        {k: jnp.asarray(v) for k, v in obs.items()})
        gm = TCAL.merge({k: torch.from_numpy(v) for k, v in cur.items()},
                        {k: torch.from_numpy(v) for k, v in obs.items()})
        for k in paths:
            np.testing.assert_array_equal(gm[k].numpy(), np.asarray(wm[k]))
        cur = {k: v.numpy() for k, v in got.items()}
    assert TCAL.ema_update(cur, None, 0.9) is cur
    assert "calibration ranges" in TCAL.describe(
        {k: torch.from_numpy(v) for k, v in cur.items()})
    assert TCAL.describe(None) == RCAL.describe(None)


# ---------------------------------------------------------------------------
# clip and LSQ quantizers
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("bits,signed", [(4, True), (3, False), (8, True)])
def test_lsq_forward_and_gradients(bits, signed):
    """lsq_quant's forward: bit-exact. Its gradients (the custom backward:
    in-range mask, q - v and the rails, 1/sqrt(n qmax)) against jax.grad
    of the reference's custom_vjp: rtol 1e-6. lsq_init_step within rtol
    1e-6 (its mean over |x| is a reduction summed in another order)."""
    rng = np.random.default_rng(bits)
    x = (rng.standard_normal((7, 33)) * 2).astype(np.float32)
    g = rng.standard_normal((7, 33)).astype(np.float32)
    qr = RQ.qrange(bits, signed)
    step0 = np.float32(RQ.lsq_init_step(jnp.asarray(x), bits, signed))
    tstep0 = TQ.lsq_init_step(torch.from_numpy(x), bits, signed)
    np.testing.assert_allclose(tstep0.item(), step0, rtol=1e-6)
    for step in (step0, np.float32(step0 * 3.1)):
        want = np.asarray(RQ.lsq_quant(jnp.asarray(x), jnp.asarray(step),
                                       qr.qmin, qr.qmax))
        xt = torch.from_numpy(x).requires_grad_(True)
        st = torch.tensor(step).requires_grad_(True)
        got = TQ.lsq_quant(xt, st, qr.qmin, qr.qmax)
        np.testing.assert_array_equal(got.detach().numpy(), want)
        dx, ds = jax.grad(
            lambda a, s: jnp.sum(RQ.lsq_quant(a, s, qr.qmin, qr.qmax)
                                 * jnp.asarray(g)), argnums=(0, 1))(
            jnp.asarray(x), jnp.asarray(step))
        (got * torch.from_numpy(g)).sum().backward()
        np.testing.assert_allclose(xt.grad.numpy(), np.asarray(dx),
                                   rtol=1e-6, atol=0)
        np.testing.assert_allclose(st.grad.numpy(), np.asarray(ds),
                                   rtol=1e-6, atol=0)


@pytest.mark.parametrize("bits,signed", [(4, True), (4, False)])
def test_calibrate_clip_and_clip_quant(bits, signed):
    """calibrate_clip: the same grid ratio picked, the clip within rtol
    1e-6 (the grid's fp32 points may differ from jnp.linspace's by an
    ulp); clip_quant on one clip value: codes and scale bit-exact."""
    rng = np.random.default_rng(3)
    x = rng.standard_normal((64, 32)).astype(np.float32)
    want = float(RQ.calibrate_clip(jnp.asarray(x), bits, signed))
    got = float(TQ.calibrate_clip(torch.from_numpy(x), bits, signed))
    np.testing.assert_allclose(got, want, rtol=1e-6)
    clip = np.float32(want)
    wq, ws = RQ.clip_quant(jnp.asarray(x), bits, signed, jnp.asarray(clip))
    tq_, ts = TQ.clip_quant(torch.from_numpy(x), bits, signed,
                            torch.tensor(clip))
    np.testing.assert_array_equal(tq_.numpy(), np.asarray(wq))
    assert ts.item() == float(ws)


# ---------------------------------------------------------------------------
# AdamW and the LR schedule
# ---------------------------------------------------------------------------

SCHEDULES = [dict(total_steps=8, warmup_steps=5),
             dict(total_steps=12, warmup_steps=5, lr=1e-2),
             dict(total_steps=8, warmup_steps=5, anneal_warmup_steps=3,
                  lr_rewarmup_knots=(2, 5)),
             dict(total_steps=200, warmup_steps=10, anneal_warmup_steps=7,
                  lr_rewarmup_knots=(40, 120))]


@pytest.mark.parametrize("kw", SCHEDULES)
def test_lr_schedule_bit_exact(kw):
    """The LR at every step of the schedule: bit-exact with the reference's
    schedule run op by op (fp32 true divisions, XLA's cos)."""
    r = ROPT.cosine_warmup_schedule(RTrainConfig(**kw))
    t = TOPT.cosine_warmup_schedule(TTrainConfig(**kw))
    with jax.disable_jit():
        want = [np.float32(r(jnp.asarray(s, jnp.int32)))
                for s in range(kw["total_steps"] + 20)]
    got = [t(s) for s in range(kw["total_steps"] + 20)]
    assert [w.view(np.int32) for w in want] == \
        [g.view(np.int32) for g in got]


def test_lr_schedule_long_horizon(monkeypatch):
    """Over the default 1,000-step horizon the port's LR equals the
    reference's op-by-op LR at every step where XLA's fp32 cos of the
    schedule's argument is the correctly rounded one (the port rounds the
    double-precision cos). At the steps where it is not, the port given
    XLA's cos value reproduces the reference's LR bit for bit, so the cos
    is the only difference."""
    import math
    import types
    r = ROPT.cosine_warmup_schedule(RTrainConfig())
    t = TOPT.cosine_warmup_schedule(TTrainConfig())
    f = np.float32
    differ = []
    with jax.disable_jit():
        for s in range(0, 1100):
            want = np.float32(r(jnp.asarray(s, jnp.int32)))
            if want == t(s):
                continue
            prog = min(max((f(s) - f(100)) / f(900), f(0)), f(1))
            arg = f(math.pi) * prog
            xla_cos = float(np.float32(jnp.cos(jnp.float32(arg))))
            assert xla_cos != float(f(math.cos(float(arg)))), s
            differ.append((s, want, xla_cos))
    for s, want, xla_cos in differ:
        monkeypatch.setattr(TOPT, "math", types.SimpleNamespace(
            pi=math.pi, cos=lambda _x, c=xla_cos: c))
        assert TOPT.cosine_warmup_schedule(TTrainConfig())(s) == want, s
    assert len(differ) < 10


def _param_tree(rng):
    """A small reference-layout params tree: a stacked group (matrices and
    a norm scale with the group axis), a tail-less head and a norm."""
    return {"decoder": {"groups": {"layers": [
        {"w": rng.standard_normal((2, 8, 6)).astype(np.float32),
         "scale": rng.standard_normal((2, 8)).astype(np.float32)}]}},
        "final_norm": {"scale": rng.standard_normal(8).astype(np.float32)},
        "lm_head": {"w": rng.standard_normal((8, 12)).astype(np.float32)}}


def test_adamw_update_matches_reference():
    """Three AdamW updates on carried-across params and grads: the params
    within 1e-6 * max|p|, the moments within 1e-6 * max|m|, the LR
    bit-exact with the reference's op-by-op schedule, the gradient norm
    within rtol 1e-6. The weight-decay mask follows the reference's
    layout: a grouped layer's norm scale is a matrix there."""
    rng = np.random.default_rng(0)
    params = _param_tree(rng)
    kw = dict(total_steps=8, warmup_steps=2, lr=1e-2, grad_clip=0.5)
    ropt, topt = ROPT.AdamW(RTrainConfig(**kw)), TOPT.AdamW(TTrainConfig(**kw))
    rp = jax.tree_util.tree_map(jnp.asarray, params)
    rs = ropt.init(rp)
    # the port's layout: one dict per layer, norms of the group 1-D
    layers = [{"w": torch.from_numpy(params["decoder"]["groups"]["layers"][0]
                                     ["w"][i].copy()),
               "scale": torch.from_numpy(params["decoder"]["groups"]
                                         ["layers"][0]["scale"][i].copy())}
              for i in range(2)]
    tp = {"layers": layers,
          "final_norm": {"scale": torch.from_numpy(
              params["final_norm"]["scale"].copy())},
          "lm_head": {"w": torch.from_numpy(params["lm_head"]["w"].copy())}}
    matrix = {"layers": [{"w": True, "scale": True}] * 2,
              "final_norm": {"scale": False}, "lm_head": {"w": True}}
    ts = topt.init(tp)
    for it in range(3):
        grads = jax.tree_util.tree_map(
            lambda p: rng.standard_normal(p.shape).astype(np.float32), params)
        with jax.disable_jit():
            rp, rs, rm = ropt.update(
                jax.tree_util.tree_map(jnp.asarray, grads), rs, rp)
        g_layers = [{"w": torch.from_numpy(grads["decoder"]["groups"]
                                           ["layers"][0]["w"][i].copy()),
                     "scale": torch.from_numpy(grads["decoder"]["groups"]
                                               ["layers"][0]["scale"][i]
                                               .copy())} for i in range(2)]
        tg = {"layers": g_layers,
              "final_norm": {"scale": torch.from_numpy(
                  grads["final_norm"]["scale"].copy())},
              "lm_head": {"w": torch.from_numpy(grads["lm_head"]["w"].copy())}}
        tp, ts, tm = topt.update(tg, ts, tp, matrix=matrix)
        assert np.float32(tm["lr"].item()) == np.float32(rm["lr"])
        np.testing.assert_allclose(tm["grad_norm"].item(),
                                   float(rm["grad_norm"]), rtol=1e-6)
        assert int(ts.count) == int(rs.count) == it + 1
        for name, t_tree, r_tree in (("p", tp, rp), ("mu", ts.mu, rs.mu),
                                     ("nu", ts.nu, rs.nu)):
            want = np.asarray(r_tree["decoder"]["groups"]["layers"][0]["w"])
            got = np.stack([t_tree["layers"][i]["w"].numpy()
                            for i in range(2)])
            np.testing.assert_allclose(got, want, rtol=0,
                                       atol=1e-6 * np.abs(want).max())
            want = np.asarray(r_tree["decoder"]["groups"]["layers"][0][
                "scale"])
            got = np.stack([t_tree["layers"][i]["scale"].numpy()
                            for i in range(2)])
            np.testing.assert_allclose(got, want, rtol=0,
                                       atol=1e-6 * np.abs(want).max())
            for key in ("final_norm", "lm_head"):
                leaf = "scale" if key == "final_norm" else "w"
                want = np.asarray(r_tree[key][leaf])
                np.testing.assert_allclose(
                    t_tree[key][leaf].numpy(), want, rtol=0,
                    atol=1e-6 * np.abs(want).max())


def test_reference_matrix_mask():
    """The weight-decay mask: grouped layers' 1-D leaves count as
    matrices (the reference stacks them), a tail layer's and the final
    norm's do not."""
    cfg = tconfigs.reduced(tconfigs.get_config("zamba2-1.2b"))
    from repro_torch.models import model as TMD
    from repro_torch.models import transformer as TT
    params = TMD.init_params(cfg, 0, "cpu")
    mask = convert.reference_matrix_mask(params, cfg)
    pattern, n_groups, n_tail = TT.group_layout(cfg)
    assert n_tail > 0
    grouped = n_groups * len(pattern)
    assert mask["layers"][0]["norm1"]["scale"] is True
    assert mask["layers"][grouped]["norm1"]["scale"] is False
    assert mask["final_norm"]["scale"] is False
    assert mask["embed"]["table"] is True


def test_sgdm_matches_reference():
    """SGD with momentum, one update: params within 1e-6 * max|p|."""
    rng = np.random.default_rng(2)
    p = rng.standard_normal((5, 4)).astype(np.float32)
    g = rng.standard_normal((5, 4)).astype(np.float32)
    kw = dict(total_steps=8, warmup_steps=2)
    ro = ROPT.make_optimizer("sgdm", RTrainConfig(**kw))
    to = TOPT.make_optimizer("sgdm", TTrainConfig(**kw))
    with jax.disable_jit():
        rp, _, _ = ro.update({"w": jnp.asarray(g)}, ro.init({"w": p}),
                             {"w": jnp.asarray(p)})
    tp_ = {"w": torch.from_numpy(p.copy())}
    tp_, _, _ = to.update({"w": torch.from_numpy(g)}, to.init(tp_), tp_)
    np.testing.assert_allclose(tp_["w"].numpy(), np.asarray(rp["w"]),
                               rtol=0, atol=1e-6 * np.abs(p).max())
    with pytest.raises(ValueError):
        TOPT.make_optimizer("lion", TTrainConfig())


# ---------------------------------------------------------------------------
# checkpoints across packages
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def ref_state():
    cfg = rcfg()
    state = RST.make_train_state(jax.random.PRNGKey(4), cfg,
                                 RTrainConfig(total_steps=8), calibrate=True)
    calib = dict(state.calib)
    calib["attn.wq"] = jnp.asarray([-1.25, 2.5], jnp.float32)
    return state._replace(calib=calib,
                          step=jnp.asarray(3, jnp.int32),
                          opt=state.opt._replace(
                              count=jnp.asarray(3, jnp.int32)))


def _flat(tree):
    return {"/".join(RCK._key_str(k) for k in path): np.asarray(leaf)
            for path, leaf in jax.tree_util.tree_flatten_with_path(tree)[0]}


def test_reference_checkpoint_restores_in_port(ref_state, tmp_path):
    """A JAX-written TrainState checkpoint restores through the port's
    restore into a port TrainState; written back by the port, its keys
    equal the reference's and every array is bit-equal."""
    RCK.save(str(tmp_path / "ref"), 3, ref_state, meta={"arch": "x"})
    cfg = tcfg()
    tmpl = convert.train_state_to_reference(TST.make_train_state(
        cfg, TTrainConfig(total_steps=8), calibrate=True, device="meta"),
        cfg)
    host = TCK.restore(str(tmp_path / "ref"), 3, tmpl, strict=("calib/",))
    state = convert.train_state_from_reference(host, cfg, "cpu")
    assert int(state.step) == 3 and int(state.opt.count) == 3
    assert state.calib["attn.wq"].tolist() == [-1.25, 2.5]
    TCK.save(str(tmp_path / "port"), 3,
             convert.train_state_to_reference(state, cfg), meta={"arch": "x"})
    want = dict(np.load(str(tmp_path / "ref" / "step_00000003"
                            / "arrays.npz")))
    got = dict(np.load(str(tmp_path / "port" / "step_00000003"
                           / "arrays.npz")))
    assert sorted(got) == sorted(want)
    for k in want:
        assert got[k].dtype == want[k].dtype, k
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    assert TCK.read_meta(str(tmp_path / "port"), 3) == \
        RCK.read_meta(str(tmp_path / "ref"), 3)


def test_port_checkpoint_restores_in_reference(ref_state, tmp_path):
    """A port-written checkpoint restores through
    ``repro.ckpt.checkpoint.restore`` into the reference's TrainState:
    keys equal, arrays bit-equal to the state the port carried across."""
    cfg = tcfg()
    state = convert.train_state_from_reference(
        jax.tree_util.tree_map(np.asarray, ref_state), cfg, "cpu")
    TCK.save(str(tmp_path), 3, convert.train_state_to_reference(state, cfg))
    tmpl = jax.tree_util.tree_map(np.asarray, ref_state)
    back = RCK.restore(str(tmp_path), 3, tmpl, strict=True)
    want, got = _flat(ref_state), _flat(back)
    assert sorted(want) == sorted(got)
    for k in want:
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    # the numpy copy of the restacked state is the same tree
    np_tree = convert.train_state_to_reference(state, cfg, numpy=True)
    assert _flat(np_tree) .keys() == want.keys()


def test_restore_fallback_is_scoped_to_calib(tmp_path):
    """The reference's scoped fallback: calib/ may keep its template init
    when absent, anything else raises; keep-k pruning and latest_step."""
    old = {"params": {"w": np.ones((2, 2), np.float32)}}
    for s in (1, 2, 3, 4):
        TCK.save(str(tmp_path), s, old, keep=3)
    assert TCK.all_steps(str(tmp_path)) == [2, 3, 4]
    assert TCK.latest_step(str(tmp_path)) == 4
    assert RCK.all_steps(str(tmp_path)) == [2, 3, 4]
    tmpl = {"params": {"w": np.zeros((2, 2), np.float32)},
            "calib": {"attn.wq": np.asarray(TCAL.UNSEEN, np.float32)}}
    out = TCK.restore(str(tmp_path), 4, tmpl, strict=("calib/",))
    np.testing.assert_array_equal(out["params"]["w"], 1.0)
    assert out["calib"]["attn.wq"][0] > out["calib"]["attn.wq"][1]
    with pytest.raises(KeyError):
        TCK.restore(str(tmp_path), 4, tmpl)
    tmpl2 = {"params": {"w": np.zeros((2, 2), np.float32),
                        "extra": np.zeros((2,), np.float32)}}
    with pytest.raises(KeyError):
        TCK.restore(str(tmp_path), 4, tmpl2, strict=("calib/",))
    with pytest.raises(ValueError):
        TCK.restore(str(tmp_path), 4,
                    {"params": {"w": np.zeros((3, 2), np.float32)}})
    with pytest.raises(FileNotFoundError):
        TCK.restore(str(tmp_path), 1, tmpl)
    # an uncommitted directory is no checkpoint
    os.makedirs(tmp_path / "step_00000009")
    assert TCK.latest_step(str(tmp_path)) == 4


# ---------------------------------------------------------------------------
# bit-flip simulators, step monitor
# ---------------------------------------------------------------------------

def test_bitflip_simulators_match_reference():
    """The NumPy simulators are a verbatim copy: equal counts on the same
    seeded operands."""
    names = [n for n in dir(RBF) if n.startswith("simulate_")
             or n.startswith("bitflips_")]
    assert names and names == [n for n in dir(TBF) if n.startswith(
        "simulate_") or n.startswith("bitflips_")]
    with open(RBF.__file__) as a, open(TBF.__file__) as b:
        assert a.read() == b.read()


def test_step_monitor_matches_reference():
    times = [1.0, 1.1, 0.9, 1.0, 1.05, 3.5, 1.0, 0.95, 10.0, 1.0]
    r, t = RStepMonitor(warmup=3), TStepMonitor(warmup=3)
    flags = [(r.record(i, s), t.record(i, s)) for i, s in enumerate(times)]
    assert all(a == b for a, b in flags)
    assert r.summary() == t.summary()
    assert t.summary()["stragglers"] == 2
