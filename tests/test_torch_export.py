"""The train -> serve export of the port against the JAX package on the
CPU: from one JAX-written QAT checkpoint (reduced llama3-8b, the schedule
0:fp,2:8,5:6 ending at a 6-bit layerwise point, calibrated ranges in the
state), ``repro_torch.launch.export`` and ``repro.launch.export`` pass the
same gates, write the same single-point checkpoint-layout artifact
(``--out``) and the same v1 ladder artifact (``--artifact_out``): equal
manifests, the frozen leaves (``act_lo``/``act_hi``/``act_s``/``act_z``,
the cache roles' ``k_s``/``k_z``/``v_s``/``v_z``) bit-equal, and code
blobs equal except codes that sit on a ``.5`` tie of w / gamma (gamma's
fp32 sum runs in another order; the ties are counted). Then the port's
own trainer end to end: a PTQ run exports quantized, a schedule that ends
at fp is refused.
"""
import json
import os
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from repro.ckpt import checkpoint as RCK
from repro.core import anneal as RAN
from repro.core import calibrate as RCAL
from repro.launch import export as REX
from repro.launch import steps as RST
from repro.launch import train as RTR
from repro.models import model as RMD
from repro_torch.ckpt import checkpoint as TCK
from repro_torch.launch import export as TEX
from repro_torch.launch import train as TTR
from repro_torch.serve_engine import artifact as TA

TRAIN_ARGS = dict(
    arch="llama3-8b", reduced=True, d_model=0, d_ff=0, layers=0, steps=8,
    total_steps=8, batch=2, seq=16, lr=1e-2, seed=0, quant="pann",
    train_quant="qat", r=2.0, act_bits=8, weight_bits=8,
    budget_schedule="0:fp,2:8,5:6", allocation="layerwise",
    calib_decay=0.99, anneal_warmup=0, remat=False, microbatches=1)
FROZEN = ("act_lo", "act_hi", "act_s", "act_z", "k_s", "k_z", "v_s", "v_z")
CODES = ("w_q", "w_colsum", "w_planes_pos", "w_planes_neg")


@pytest.fixture(scope="module")
def jax_ckpt(tmp_path_factory):
    """A QAT checkpoint written by the JAX package at step 8: its init
    params, a calibration collection observed by the reference's forward
    at the final operating point (lm_head's and the cache roles' too),
    and the eval loss its trainer would record."""
    d = str(tmp_path_factory.mktemp("jax_ckpt"))
    targs = types.SimpleNamespace(**TRAIN_ARGS)
    cfg, tcfg, _ = RTR.build(targs)
    state = RST.make_train_state(jax.random.PRNGKey(5), cfg, tcfg,
                                 calibrate=True)
    cfg_eval, _, _ = RAN.BudgetAnnealer.from_train_config(
        cfg, tcfg).config_at(cfg, 7)
    batch = RTR.make_eval_batch(cfg, targs)
    obs = jax.jit(lambda p, t, c: RMD.forward(
        p, cfg_eval, t, remat=False, calib=c).calib)(
        state.params, batch["tokens"], state.calib)
    calib = RCAL.ema_update(state.calib, obs, tcfg.calib_decay)
    state = state._replace(calib=calib, step=jnp.asarray(8, jnp.int32))
    eval_l = RST.eval_loss(state.params, cfg_eval, batch, calib=calib)
    RCK.save(d, 8, state, meta={"arch": cfg.name, "loss": eval_l,
                                "eval_loss": eval_l, "final_bits": 6,
                                "train_args": TRAIN_ARGS})
    return d, state


@pytest.fixture(scope="module")
def exports(jax_ckpt, tmp_path_factory):
    ckpt, _ = jax_ckpt
    out = {}
    for name, main, extra in (("ref", REX.main, []),
                              ("port", TEX.main, ["--device", "cpu"])):
        d = tmp_path_factory.mktemp(f"export_{name}")
        summary = main(["--ckpt_dir", ckpt, "--out", str(d / "single"),
                        "--artifact_out", str(d / "ladder"),
                        "--artifact_ladder", "2,4,6", "--tol", "1e-3"]
                       + extra)
        out[name] = (summary, d)
    return out


def test_export_gates_match_reference(exports):
    """Both exports pass the reference's two gates at tol 1e-3 (no
    SystemExit) on the same operating point; their training and serving
    eval losses agree within 1e-5 relative."""
    (rs, _), (ts, _) = exports["ref"], exports["port"]
    for k in ("step", "bits", "allocation", "train_quant", "meta_eval_loss"):
        assert ts[k] == rs[k], k
    assert ts["bits"] == 6 and ts["allocation"] == "layerwise"
    for k in ("loss_train_eval", "loss_serve_eval"):
        np.testing.assert_allclose(ts[k], rs[k], rtol=1e-5)
    assert ts["rel_diff"] <= 1e-3 and rs["rel_diff"] <= 1e-3


def _tie_checked(diff_paths, got, fp, scales):
    """Every differing code sits on a .5 tie of w / gamma; returns the
    count of flipped codes."""
    flipped = 0
    for path in diff_paths:
        mod = path.rsplit("/", 1)[0]
        a, b = got[0][path], got[1][path]
        if path.endswith("/w_q"):
            ratio = fp[mod] / scales[f"{mod}/w_scale"]
            ties = np.abs(np.abs(ratio - np.trunc(ratio)) - 0.5) < 1e-4
            bad = a != b
            assert not (bad & ~ties).any(), path
            flipped += int(bad.sum())
    return flipped


def _fp_weights(state, prefix):
    """{module path: fp weight} of the reference state, in the artifact's
    (stacked) layout."""
    out = {}
    for path, leaf in jax.tree_util.tree_flatten_with_path(state.params)[0]:
        key = prefix + "/".join(RCK._key_str(k) for k in path)
        if key.endswith("/w"):
            out[key[:-2]] = np.asarray(leaf)
    return out


def test_single_point_out_matches_reference(exports, jax_ckpt):
    """--out: the same keys and meta gates; the frozen leaves bit-equal;
    every other leaf equal, codes except counted ties (w_scale within 1e-6
    relative: the gamma sum's order)."""
    (_, rd), (_, td) = exports["ref"], exports["port"]
    a = dict(np.load(os.path.join(rd, "single", "step_00000008",
                                  "arrays.npz")))
    b = dict(np.load(os.path.join(td, "single", "step_00000008",
                                  "arrays.npz")))
    assert sorted(a) == sorted(b)
    assert any(k.endswith("/act_s") for k in a)
    diff = []
    for k in a:
        assert a[k].dtype == b[k].dtype and a[k].shape == b[k].shape, k
        if k.rsplit("/", 1)[-1] in FROZEN:
            assert a[k].tobytes() == b[k].tobytes(), k
        elif k.endswith("/w_scale"):
            np.testing.assert_allclose(b[k], a[k], rtol=1e-6)
        elif not np.array_equal(a[k], b[k]):
            assert k.rsplit("/", 1)[-1] in CODES, k
            diff.append(k)
    _, state = jax_ckpt
    flipped = _tie_checked([k for k in diff if k.endswith("/w_q")], (a, b),
                           _fp_weights(state, ""), a)
    print(f"--out: {flipped} codes flipped at .5 ties")
    ma = RCK.read_meta(os.path.join(rd, "single"), 8)
    mb = TCK.read_meta(os.path.join(td, "single"), 8)
    for k in ("bits", "allocation", "train_quant", "train_args"):
        assert ma[k] == mb[k], k


def _blob_leaves(d):
    """{path: numpy array} of every store and view leaf of an artifact,
    read straight off its manifest and blob."""
    with open(os.path.join(d, "manifest.json")) as f:
        m = json.load(f)
    blob = np.fromfile(os.path.join(d, "weights.bin"), np.uint8)
    dt = {"float32": np.float32, "int8": np.int8, "uint8": np.uint8,
          "int32": np.int32}

    def read(e):
        raw = blob[e["offset"]:e["offset"] + e["nbytes"]]
        return raw.view(dt[e["dtype"]]).reshape(e["shape"])

    out = {f"store/{p}": read(e) for p, e in m["store"].items()}
    for v in m["views"]:
        for p, e in v["leaves"].items():
            if "ref" not in e:
                out[f"view{v['key']}/{p}"] = read(e)
    return m, out


def test_ladder_artifact_matches_reference(exports, jax_ckpt):
    """--artifact_out: equal manifests (every leaf's dtype, shape, offset
    and size, the view tables, the meta), the frozen leaves of every view
    bit-equal (calibrated roles only: ``attn.wo`` and the rest that the
    collection saw, never an unseen one), the rest equal except codes on
    counted ties."""
    (_, rd), (_, td) = exports["ref"], exports["port"]
    ma, a = _blob_leaves(str(rd / "ladder"))
    mb, b = _blob_leaves(str(td / "ladder"))
    assert ma == mb
    frozen = [k for k in a if k.rsplit("/", 1)[-1] in FROZEN]
    assert any(k.endswith("/act_s") for k in frozen)
    for k in frozen:
        assert a[k].tobytes() == b[k].tobytes(), k
    diff = []
    for k in a:
        if k.endswith("/w_scale"):
            np.testing.assert_allclose(b[k], a[k], rtol=1e-6)
        elif not np.array_equal(a[k], b[k]):
            assert k.rsplit("/", 1)[-1] in CODES, k
            diff.append(k)
    _, state = jax_ckpt
    flipped = _tie_checked([k for k in diff if k.endswith("/w_q")], (a, b),
                           _fp_weights(state, "store/"), a)
    print(f"--artifact_out: {flipped} codes flipped at .5 ties")
    # the port loads its own artifact with the calibrated leaves in place
    ws = TA.load_artifact(str(td / "ladder"), device="cpu")
    assert "act_s" in ws.views[6]["layers"][0]["attn"]["wq"]


def test_cache_bits_freezes_cache_quantizers(jax_ckpt, tmp_path):
    """--cache_bits 4 (the port's option): every view gains the reference's
    KV-cache leaves, the calibrated cache roles' k_s/k_z/v_s/v_z bit-equal
    to ``repro.models.serving._cache_artifact`` on the same collection;
    nothing else changes."""
    from repro.core import policy as RPOL
    from repro.models import serving as RSV
    ckpt, state = jax_ckpt
    base = ["--ckpt_dir", ckpt, "--artifact_ladder", "2,4,6",
            "--device", "cpu"]
    TEX.main(base + ["--artifact_out", str(tmp_path / "plain")])
    TEX.main(base + ["--artifact_out", str(tmp_path / "cached"),
                     "--cache_bits", "4"])
    _, plain = _blob_leaves(str(tmp_path / "plain"))
    _, cached = _blob_leaves(str(tmp_path / "cached"))
    extra = sorted(set(cached) - set(plain))
    assert set(plain) <= set(cached)
    assert extra and all("/kv_cache/" in k for k in extra)
    for k in plain:
        assert np.array_equal(plain[k], cached[k]), k
    calib = {k: np.asarray(v, np.float32) for k, v in state.calib.items()}
    want = RSV._cache_artifact(
        (2,), {r: 4 for r in RPOL.CACHE_PATHS}, calib)
    assert {k.rsplit("/", 1)[-1] for k in extra} == set(want) | {
        "k_nlvl", "v_nlvl"} and "k_s" in want
    for k in extra:
        leaf = k.rsplit("/", 1)[-1]
        assert cached[k].tobytes() == np.asarray(want[leaf]).tobytes(), k
    ws = TA.load_artifact(str(tmp_path / "cached"), device="cpu")
    kc = ws.views[4]["layers"][1]["attn"]["kv_cache"]
    assert {"k_s", "k_z", "v_s", "v_z"} <= set(kc)


def test_ptq_trains_fp_but_exports_quantized(tmp_path):
    """The port's trainer at --train_quant ptq: no calibration collection
    in the checkpoint; its export quantizes and reports (not gates) the
    quantization gap; the training eval loss is reproduced."""
    ck = str(tmp_path / "ck")
    summary = TTR.main(["--arch", "llama3-8b", "--reduced", "--batch", "2",
                        "--seq", "16", "--quant", "pann", "--train_quant",
                        "ptq", "--steps", "3", "--lr", "1e-2",
                        "--log_every", "100", "--ckpt_dir", ck,
                        "--ckpt_every", "3", "--device", "cpu"])
    arrays = np.load(os.path.join(ck, "step_00000003", "arrays.npz"))
    assert not [k for k in arrays.files if k.startswith("calib/")]
    res = TEX.main(["--ckpt_dir", ck, "--device", "cpu"])
    assert res["train_quant"] == "ptq"
    assert np.isfinite(res["loss_serve_eval"])
    assert summary["eval_loss"] == pytest.approx(res["loss_train_eval"])
    # the reference's exporter takes the port's PTQ checkpoint too
    ref = REX.main(["--ckpt_dir", ck])
    np.testing.assert_allclose(ref["loss_serve_eval"],
                               res["loss_serve_eval"], rtol=1e-5)


def test_export_rejects_fp_schedule_tail(tmp_path):
    ck = str(tmp_path / "ck_fp")
    TTR.main(["--arch", "llama3-8b", "--reduced", "--batch", "2", "--seq",
              "16", "--quant", "pann", "--train_quant", "qat",
              "--budget_schedule", "0:fp", "--lr", "1e-2", "--log_every",
              "100", "--ckpt_dir", ck, "--steps", "2", "--ckpt_every", "2",
              "--device", "cpu"])
    with pytest.raises(SystemExit, match="full-precision"):
        TEX.main(["--ckpt_dir", ck, "--device", "cpu"])
    with pytest.raises(SystemExit, match="no checkpoint"):
        TEX.main(["--ckpt_dir", str(tmp_path / "empty"), "--device", "cpu"])
