"""The single-point serving artifact and the single-point serve of the port
against the JAX package on the CPU: ``quantize_params_for_serving`` leaf
for leaf (value-exact plane counts taken over the layer groups, clipping
at a pinned plane count, act and KV-cache leaves, q/k/v biases), the
reference's artifact carried across and served by ``serving_linear`` and
``forward`` on 'ref', 'fused' and 'packed' (the CPU plain versions), the
CLI's single-point mode and its refusals, and ``ServeEngine``'s refusal of
``backend=None``.

Tolerances: codes equal except at ``.5`` ties of w / gamma (gamma's fp32
sum runs in another order; every mismatch must sit at a tie, and a module
with one is held to its own consistency: colsum and planes of its own
codes); ``w_scale`` within 1e-6 relative, every other leaf equal.
Served outputs bit-identical across the
port's backends; against the reference's 'ref' backend on the same
artifact within 1e-6 * max|y| (one projection) and 1e-5 * max|logit|
(``forward``, reference op by op under ``jax.disable_jit()``) while no
activation code flipped between the two sides, else 2e-2 * max|logit|.
"""
import dataclasses
import functools
import gc
import weakref

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.base import QuantConfig as RQuantConfig
from repro.core import quant as RQ
from repro.kernels import dispatch as RD
from repro.launch import serve as rserve
from repro.models import model as RMD
from repro.models import serving as RSV
from repro.serve_engine import ServeEngine as RServeEngine
from repro_torch.convert import params_from_reference
from repro_torch.core import quant as TQ
from repro_torch.kernels import dispatch as TD
from repro_torch.kernels.pann_matmul_packed import unpack_planes
from repro_torch.launch import serve as tserve
from repro_torch.models import model as TMD
from repro_torch.models import serving as TSV
from repro_torch.serve_engine import ServeEngine as TServeEngine
from test_torch_common import tonp
from test_torch_common import one_torch_thread  # noqa: F401
from test_torch_dense_variants import port_cfg, ref_cfg, reference_params

R = 2.83
BACKENDS = ("ref", "fused", "packed")
FWD_BOUND = 1e-5
FLIP_BOUND = 2e-2

# (arch, act_bits, pack_planes, plane_count, cache_bits, policy)
ARTIFACTS = {
    "llama-w-only": ("llama3-8b", None, False, None, None, False),
    "llama-exact": ("llama3-8b", 3, True, None, None, False),
    "llama-p7": ("llama3-8b", 4, True, 7, None, False),
    "llama-p3-cache": ("llama3-8b", 4, True, 3, 4, False),
    "llama-policy": ("llama3-8b", None, True, None, None, True),
    "qwen-bias": ("qwen1.5-4b", 3, True, None, None, False),
    "gemma2": ("gemma2-9b", 4, True, None, 3, False),
    "stablelm": ("stablelm-12b", 4, True, None, None, False),
}


def _flat(tree, trail=""):
    """{path: numpy array} of a tree of numpy arrays or torch tensors."""
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_flat(v, f"{trail}/{k}" if trail else k))
        return out
    if isinstance(tree, (list, tuple)):
        out = {}
        for i, v in enumerate(tree):
            out.update(_flat(v, f"{trail}/{i}"))
        return out
    if isinstance(tree, torch.Tensor):
        return {trail: tree.numpy()}
    return {trail: np.asarray(tree)}


def _outlier(params):
    """Layer 0's wq gets one weight 50x its column's largest, so its codes
    reach the int8 clip: the groups' stack shares that plane count."""
    params = jax.tree_util.tree_map(np.array, params)
    w = params["decoder"]["groups"]["layers"][0]["attn"]["wq"]["w"]
    w[0, 3, 5] = 50 * np.abs(w[0, :, 5]).max()
    return params


def _spec(mod, act_bits, pack, plane_count, cache_bits, policy):
    """The spec in ``mod``'s package (its ``serving`` module); ``policy``:
    a tree with its own point for w_down and a 4-bit K cache."""
    tree = None
    if policy:
        mq = mod.pol.ModuleQuant
        tree = mod.pol.policy_tree(
            mq(mode="pann", r=R, b_x_tilde=3),
            {"mlp.w_down": mq(mode="pann", r=7.9, b_x_tilde=5),
             "attn.k_cache": mod.pol.cache_module_quant(4)})
    return mod.ServingQuantSpec(r=R, act_bits=act_bits, pack_planes=pack,
                                plane_count=plane_count,
                                cache_bits=cache_bits, policy=tree)


@functools.lru_cache(maxsize=None)
def ref_artifact(name, outlier=False):
    """The reference's single-point artifact of ``ARTIFACTS[name]``."""
    arch, *knobs = ARTIFACTS[name]
    np_params = reference_params(arch)
    if outlier:
        np_params = _outlier(np_params)
    return RSV.quantize_params_for_serving(
        jax.tree_util.tree_map(jnp.asarray, np_params), ref_cfg(arch),
        spec=_spec(RSV, *knobs))


@functools.lru_cache(maxsize=None)
def artifacts(name, outlier=False):
    """(ref artifact carried across, port artifact, carried fp params)."""
    arch, *knobs = ARTIFACTS[name]
    np_params = reference_params(arch)
    if outlier:
        np_params = _outlier(np_params)
    ref = ref_artifact(name, outlier)
    tc = port_cfg(arch)
    carried = params_from_reference(tonp(ref), tc, "cpu")
    own = TSV.quantize_params_for_serving(
        params_from_reference(np_params, tc, "cpu"), tc,
        spec=_spec(TSV, *knobs))
    return carried, own, params_from_reference(np_params, tc, "cpu")


def _check_artifact(carried, own, fp):
    want, got, w_fp = _flat(carried), _flat(own), _flat(fp)
    assert sorted(got) == sorted(want)
    assert not any(k.endswith("plane_shift") for k in got)
    flipped_total = 0
    modules = sorted({k.rsplit("/", 1)[0] for k in got
                      if k.endswith("/w_q")})
    for mod in modules:
        leaves = [k for k in got if k.rsplit("/", 1)[0] == mod]
        flipped = got[f"{mod}/w_q"] != want[f"{mod}/w_q"]
        if flipped.any():
            ratio = w_fp[f"{mod}/w"] / want[f"{mod}/w_scale"]
            ties = np.abs(np.abs(ratio - np.trunc(ratio)) - 0.5) < 1e-4
            assert not (flipped & ~ties).any(), mod
            flipped_total += int(flipped.sum())
            codes = got[f"{mod}/w_q"].astype(np.int32)
            assert np.array_equal(got[f"{mod}/w_colsum"], codes.sum(0))
            if f"{mod}/w_planes_pos" in got:
                pos = unpack_planes(torch.from_numpy(
                    got[f"{mod}/w_planes_pos"]), codes.shape[0]).numpy()
                neg = unpack_planes(torch.from_numpy(
                    got[f"{mod}/w_planes_neg"]), codes.shape[0]).numpy()
                w = 1 << np.arange(pos.shape[0])[:, None, None]
                assert np.array_equal(((pos - neg) * w).sum(0), codes)
            leaves = [k for k in leaves if not k.endswith(
                ("/w_q", "/w_colsum", "/w_planes_pos", "/w_planes_neg"))]
        for k in leaves:
            assert got[k].dtype == want[k].dtype, k
            if k.endswith("/w_scale"):      # gamma: the sum order's ulps
                np.testing.assert_allclose(got[k], want[k], rtol=1e-6)
            else:
                assert np.array_equal(got[k], want[k]), k
    for k in got:
        if "kv_cache" in k or k.startswith(("embed", "final_norm")):
            assert np.array_equal(got[k], want[k]), k
    return flipped_total


@pytest.mark.parametrize("name", sorted(ARTIFACTS))
def test_quantize_params_for_serving_matches_reference(name):
    flipped = _check_artifact(*artifacts(name))
    print(f"{name}: {flipped} codes flipped at .5 ties")


def test_plane_count_is_taken_over_the_layer_groups():
    """One outlier weight in layer 0's wq: the reference packs wq at 7
    planes for every layer of the stack, wk at its own smaller count."""
    carried, own, fp = artifacts("llama-exact", outlier=True)
    _check_artifact(carried, own, fp)
    counts = {(i, m): own["layers"][i]["attn"][m]["w_planes_pos"].shape[0]
              for i in range(2) for m in ("wq", "wk")}
    assert counts[(0, "wq")] == counts[(1, "wq")] == 7
    assert counts[(0, "wk")] == counts[(1, "wk")] < 7


def test_artifact_is_freed_with_its_last_reference():
    """Nothing inside the builder keeps the artifact alive: with the cyclic
    collector off, dropping the caller's reference frees its tensors (at
    full width, the next serve's fp32 params would otherwise share the card
    with the last artifact)."""
    tc = port_cfg("llama3-8b")
    gc.disable()
    try:
        art = TSV.quantize_params_for_serving(
            TMD.init_params(tc, device="cpu"), tc,
            TSV.ServingQuantSpec(r=R, act_bits=3, pack_planes=True))
        leaf = weakref.ref(art["layers"][0]["attn"]["wq"]["w_planes_pos"])
        del art
        assert leaf() is None
    finally:
        gc.enable()


@pytest.mark.parametrize("field", [
    {"r": R}, {"act_bits": 3}, {"plane_count": 5},
    {"policy": "tree"}])
def test_weight_store_refuses_single_point_fields(field):
    """A ladder build takes each rung's point from ``r_by_rung`` and packs
    7 planes: a spec that sets a single-point field is refused, not
    silently ignored."""
    tc = port_cfg("llama3-8b")
    if "policy" in field:
        field = {"policy": _spec(TSV, 3, True, None, None, True).policy}
    spec = TSV.ServingQuantSpec(pack_planes=True, **field)
    with pytest.raises(ValueError, match=next(iter(field))):
        TSV.build_weight_store(TMD.init_params(tc, device="cpu"), tc,
                               {"a": (R, 3)}, spec)


def _x(shape, seed):
    return np.random.default_rng(seed).standard_normal(shape).astype(
        np.float32)


@pytest.mark.parametrize("name", ["llama-exact", "qwen-bias",
                                  "llama-p3-cache"])
def test_serving_linear_takes_artifacts_without_plane_shift(name):
    """A single-point artifact has no ``plane_shift`` leaf: every backend
    runs it at shift 0, bit-identical to each other, and agrees with the
    reference's ``serving_linear`` on the same leaves."""
    carried, _, _ = artifacts(name)
    ref = ref_artifact(name)
    for m in ("wq", "wo"):
        tp = carried["layers"][1]["attn"][m]
        rp = jax.tree_util.tree_map(
            lambda a: a[1], ref["decoder"]["groups"]["layers"][0]["attn"][m])
        x = _x((5, tp["w_q"].shape[0]), len(m))
        outs = {b: TD.serving_linear(torch.from_numpy(x), tp, b)
                for b in BACKENDS}
        for b in BACKENDS[1:]:
            assert torch.equal(outs[b], outs["ref"]), b
        want = np.asarray(RD.serving_linear(jnp.asarray(x), rp, "ref"))
        np.testing.assert_allclose(outs["ref"].numpy(), want, rtol=0,
                                   atol=1e-6 * np.abs(want).max())


def _capture_encode(monkeypatch, module, log):
    orig = module.affine_encode

    def wrapped(x, s, z, n):
        out = orig(x, s, z, n)
        log.append(np.asarray(out))
        return out

    monkeypatch.setattr(module, "affine_encode", wrapped)


@pytest.mark.parametrize("name", ["llama-exact", "qwen-bias", "gemma2",
                                  "stablelm"])
def test_forward_serves_the_reference_artifact(name, monkeypatch):
    """The reference's artifact, carried across, through the port's
    ``forward`` on each backend: bit-identical across them, and within the
    bound of the reference's ``forward`` on the same artifact."""
    arch = ARTIFACTS[name][0]
    carried, _, _ = artifacts(name)
    ref = ref_artifact(name)
    tokens = np.random.default_rng(5).integers(
        0, ref_cfg(arch).vocab_size, (2, 10)).astype(np.int32)
    ref_codes, port_codes = [], []
    _capture_encode(monkeypatch, RQ, ref_codes)
    rc = dataclasses.replace(ref_cfg(arch), kernel_backend="ref")
    with jax.disable_jit():
        want = np.asarray(RMD.forward(ref, rc, jnp.asarray(tokens),
                                      remat=False).logits)
    _capture_encode(monkeypatch, TQ, port_codes)
    logits = {}
    for b in BACKENDS:       # 'ref' first: its codes are the ones counted
        tc = dataclasses.replace(port_cfg(arch), kernel_backend=b)
        logits[b] = TMD.forward(carried, tc,
                                torch.from_numpy(tokens).long()).logits
        monkeypatch.undo()
    for b in BACKENDS[1:]:
        assert torch.equal(logits[b], logits["ref"]), b
    got = logits["ref"].numpy()
    assert len(ref_codes) == len(port_codes) > 0
    flipped = sum(int((a != b).sum()) for a, b in zip(ref_codes, port_codes))
    err = float(np.abs(got - want).max() / np.abs(want).max())
    print(f"{name}: max|err| / max|logit| = {err:.3g}, {flipped} of "
          f"{sum(a.size for a in ref_codes)} activation codes flipped")
    bound = FWD_BOUND if flipped == 0 else FLIP_BOUND
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=bound * np.abs(want).max())


CLI = ["--reduced", "--batch", "2", "--prompt_len", "4", "--gen", "4"]


def test_single_point_cli_summary_matches_reference():
    want = rserve.main(CLI + ["--quant", "pann", "--power_bits", "4"])
    runs = {b: tserve.main(CLI + ["--device", "cpu", "--quant", "pann",
                                  "--power_bits", "4", "--backend", b])
            for b in BACKENDS}
    runs["default"] = tserve.main(CLI + ["--device", "cpu", "--quant",
                                         "pann", "--power_bits", "4"])
    for out in runs.values():
        assert sorted(out) == sorted(want)
        assert out["generated"] == want["generated"] == 4
    assert runs["default"]["backend"] == "packed"
    # the plain versions of the backends are bit-identical: same tokens
    assert runs["ref"]["sample"] == runs["fused"]["sample"] \
        == runs["packed"]["sample"] == runs["default"]["sample"]


@pytest.mark.parametrize("argv", [["--quant", "none"],
                                  ["--quant", "ruq", "--power_bits", "8"],
                                  ["--quant", "ruq_unsigned"],
                                  ["--quant", "pann", "--backend", ""]])
def test_single_point_cli_legacy_paths(argv):
    out = tserve.main(CLI + ["--device", "cpu"] + argv)
    want = rserve.main(CLI + [a for a in argv if a != "--backend"
                              and a != ""])
    assert sorted(out) == sorted(want)
    assert out["backend"] == "legacy" and out["quant"] == want["quant"]
    assert len(out["sample"]) == 4


@pytest.mark.parametrize("argv", [
    ["--quant", "ruq", "--backend", "packed"],
    ["--quant", "pann", "--allocation", "layerwise"],
    ["--quant", "pann", "--cache_bits", "4"]])
def test_single_point_cli_refusals_match_reference(argv):
    with pytest.raises(SystemExit):
        rserve.main(CLI + argv)
    with pytest.raises(SystemExit):
        tserve.main(CLI + ["--device", "cpu"] + argv)


def test_engine_refuses_backend_none():
    """The port's engine serves its store through a kernel backend only.
    The reference's ``backend=None`` float dequant reads ``w_q`` and
    ``w_scale`` and never ``plane_shift``: two rungs that share b~x (3
    and 4 bits: b~x = 4, R = 3.6 and 5.5) serve the same max-R weights,
    so their logits are equal (ROADMAP C6, not copied)."""
    with pytest.raises(ValueError, match="kernel backend"):
        TServeEngine(port_cfg("llama3-8b"), TMD.init_params(
            port_cfg("llama3-8b"), device="cpu"), ladder_bits=(3, 4),
            backend=None, device="cpu")
    cfg = dataclasses.replace(ref_cfg("llama3-8b"),
                              quant=RQuantConfig(mode="none"))
    params = jax.tree_util.tree_map(jnp.asarray,
                                    reference_params("llama3-8b"))
    eng = RServeEngine(cfg, params, ladder_bits=(3, 4), max_batch=2,
                       max_len=6, backend=None)
    assert {op.b_x_tilde for op in eng.ladder} == {4}
    rows = jnp.asarray(np.random.default_rng(0).integers(0, 512, (2, 6)),
                       jnp.int32)
    logits = {}
    for bits in (3, 4):
        view = eng.variants[bits]
        state = RMD.init_decode_state(view, eng.cfg, 2, 6)
        out = []
        for t in range(6):
            lg, state = RMD.decode_step(view, eng.cfg, state,
                                        rows[:, t:t + 1])
            out.append(np.asarray(lg))
        logits[bits] = np.stack(out)
    shifts = [float(np.asarray(eng.variants[b]["decoder"]["groups"][
        "layers"][0]["attn"]["wq"]["plane_shift"])[0]) for b in (3, 4)]
    assert shifts == [1.0, 0.0]
    assert np.array_equal(logits[3], logits[4])
