"""The port's ``EncodeEngine`` (whole-sequence encode waves under per-item
power budgets) and the serving CLI's encoder-decoder and vision modes
against the JAX package on the CPU, on reduced seamless-m4t-medium and
llama-3.2-vision-90b with the reference's seeded parameters
(``test_torch_encoder``): the ladders at allocation 'uniform' and
'layerwise' planned over the per-item profile, each response's rung and
ledger (the ``conv.s{i}`` roles included), the encoded states, the
refusals, ``describe`` and ``--encode``; and the single-point artifact
of both configs leaf for leaf.

The reference engine quantizes the params into its own store (ladder
2,4,6 over the encode profile, backend 'ref'); the port serves that store
carried across, and its three backends a packed store of its own.
Tolerance: rungs, ladders and ledgers equal; the encoded states bit for
bit through the stem (vision: the stem is its whole
encode) and within 1e-5 * max|out| through seamless's encoder (its fp
stages: layernorm, RoPE, bidirectional attention); the port's three
backends bit-identical to each other.
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.launch import serve as rserve
from repro.models import serving as RSV
from repro.serve_engine import EncodeEngine as REncodeEngine
from repro.serve_engine import EncodeRequest as REncodeRequest
from repro_torch import configs as tconfigs
from repro_torch.convert import (params_from_reference,
                                 weight_store_from_reference)
from repro_torch.launch import serve as tserve
from repro_torch.models import model as TMD
from repro_torch.models import serving as TSV
from repro_torch.models.serving import WeightStore
from repro_torch.serve_engine import EncodeEngine as TEncodeEngine
from repro_torch.serve_engine import EncodeRequest as TEncodeRequest
from test_torch_common import LADDER, tonp
from test_torch_common import one_torch_thread  # noqa: F401
from test_torch_encoder import (ARCHS, REL_BOUND, jparams, port_cfg,
                                raw_input, ref_cfg, reference_params)
from test_torch_single_point import _check_artifact

BUDGETS = (2, 4, 6, 6, 2)


@functools.lru_cache(maxsize=None)
def engines(arch, allocation):
    """(reference engine, port engine on the reference's store carried
    across)."""
    reng = REncodeEngine(ref_cfg(arch), jparams(arch), ladder_bits=LADDER,
                         max_batch=2, backend="ref", allocation=allocation)
    pws = weight_store_from_reference(
        tonp(reng.weight_store),
        {k: tonp(v) for k, v in reng.variants.items()}, port_cfg(arch),
        "cpu")
    teng = TEncodeEngine(port_cfg(arch), weight_store=pws,
                         ladder_bits=LADDER, max_batch=2, backend="ref",
                         allocation=allocation, device="cpu")
    return reng, teng


def _items(arch, n=len(BUDGETS)):
    return raw_input(arch, step=4, batch=n)


@pytest.mark.parametrize("allocation", ["uniform", "layerwise"])
@pytest.mark.parametrize("arch", ARCHS)
def test_encode_engine_matches_reference(arch, allocation):
    reng, teng = engines(arch, allocation)
    assert [(op.bits, op.r, op.b_x_tilde) for op in teng.ladder] == \
        [(op.bits, op.r, op.b_x_tilde) for op in reng.ladder]
    reng.warmup()
    teng.warmup()
    assert teng.compilations_after_warmup == 0   # no kernel library here
    items = _items(arch)
    want = reng.encode([REncodeRequest(uid=i, item=items[i],
                                       power_budget_bits=b)
                        for i, b in enumerate(BUDGETS)])
    got = teng.encode([TEncodeRequest(uid=i, item=items[i],
                                      power_budget_bits=b)
                       for i, b in enumerate(BUDGETS)])
    teng.assert_no_recompile()
    cfg = port_cfg(arch)
    for r, t in zip(want, got):
        assert (r.uid, r.rung_bits, r.metadata) == \
            (t.uid, t.rung_bits, t.metadata)
        assert t.encoded.shape == (cfg.stem_tokens, cfg.d_model)
        if cfg.family == "vlm":
            assert np.array_equal(t.encoded, r.encoded)
        else:
            np.testing.assert_allclose(
                t.encoded, r.encoded, rtol=0,
                atol=REL_BOUND * np.abs(r.encoded).max())
    breakdown = got[-1].metadata["per_module_gbitflips_per_token"]
    roles = {k for k in breakdown if k.startswith("conv.")}
    assert roles == {f"conv.s{i}" for i in range(len(cfg.conv_stem))}
    assert all(breakdown[k] > 0 for k in roles)
    flips = [t.metadata["est_bitflips_per_token"] for t in got[:3]]
    assert flips[0] < flips[1] < flips[2]
    mine, theirs = teng.describe(), reng.describe()
    assert mine.keys() == theirs.keys()
    for k in mine:
        if k not in ("backend", "compilations_after_warmup"):
            assert mine[k] == theirs[k], k


@pytest.mark.parametrize("arch", ARCHS)
def test_encode_backends_bit_identical(arch):
    """One store, three engines: the encoded states of 'ref', 'fused' and
    'packed' are bit-identical, and each equals ``MD.encode`` on its
    rung's view (the engine pads a short wave by repeating its first
    item, which changes nothing of the others)."""
    cfg = port_cfg(arch)
    teng = TEncodeEngine(cfg, params_from_reference(reference_params(arch),
                                                    cfg, "cpu"),
                         ladder_bits=LADDER, max_batch=2, backend="packed",
                         device="cpu")
    ws = WeightStore(store=teng.weight_store, views=teng.variants)
    items = _items(arch, 3)
    reqs = [TEncodeRequest(uid=i, item=items[i], power_budget_bits=b)
            for i, b in enumerate((2, 6, 6))]
    outs = {}
    for backend in ("ref", "fused", "packed"):
        eng = TEncodeEngine(port_cfg(arch), weight_store=ws,
                            ladder_bits=LADDER, max_batch=2,
                            backend=backend, device="cpu")
        outs[backend] = eng.encode(reqs)
    for backend in ("fused", "packed"):
        for a, b in zip(outs[backend], outs["ref"]):
            assert np.array_equal(a.encoded, b.encoded)
    cfg = port_cfg(arch, kernel_backend="ref")
    direct = TMD.encode(teng.variants[6], cfg, torch.from_numpy(
        np.stack([items[1], items[2]])))
    assert np.array_equal(outs["ref"][1].encoded, direct[0].numpy())
    assert np.array_equal(outs["ref"][2].encoded, direct[1].numpy())
    assert not np.array_equal(outs["ref"][0].encoded,
                              TMD.encode(teng.variants[6], cfg,
                                         torch.from_numpy(items[:1]))[0])


def test_encode_engine_refusals():
    arch = ARCHS[0]
    _, teng = engines(arch, "uniform")
    ws = WeightStore(store=teng.weight_store, views=teng.variants)
    with pytest.raises(ValueError, match="item shape"):
        teng.encode([TEncodeRequest(uid=0, item=np.zeros((3, 3, 3),
                                                         np.float32))])
    with pytest.raises(RuntimeError, match="warmup"):
        TEncodeEngine(port_cfg(arch), weight_store=ws, ladder_bits=LADDER,
                      device="cpu").assert_no_recompile()
    lm = tconfigs.reduced(tconfigs.get_config("llama3-8b"))
    with pytest.raises(ValueError, match="no encode path"):
        TEncodeEngine(lm, TMD.init_params(lm, device="cpu"),
                      ladder_bits=(4,), device="cpu")
    with pytest.raises(ValueError, match="exactly one"):
        TEncodeEngine(port_cfg(arch), ladder_bits=(4,), device="cpu")
    with pytest.raises(ValueError, match="no view for rung"):
        TEncodeEngine(port_cfg(arch), weight_store=ws, ladder_bits=(3,),
                      device="cpu")


def _summary_keys(summary, key):
    return sorted(summary), sorted(summary[key][0]), sorted(
        summary["engine"])


@pytest.mark.parametrize("arch", ARCHS)
def test_serve_cli_encode_and_frontends(arch):
    """``launch/serve.py`` on each config, reduced on the CPU: ``--encode``
    gives the reference's summary keys, rungs and per-item ledgers (the
    ledgers depend on the config and the ladder, not the weights); the
    ladder with the stub frontend serves every request at its budget's
    rung (vision cut by ``--layers`` to its one group of 5); seamless's
    single point at --quant pann gives the same tokens on 'ref' and
    'packed'."""
    cli = ["--arch", arch, "--reduced", "--batch", "2", "--requests", "3"]
    got = tserve.main(cli + ["--encode", "--device", "cpu"])
    cfg = port_cfg(arch)
    assert [r["encoded_shape"] for r in got["items"]] == \
        [[cfg.stem_tokens, cfg.d_model]] * 3
    assert [r["rung_bits"] for r in got["items"]] == list(LADDER)
    dec = ["--device", "cpu", "--prompt_len", "4", "--gen", "4"]
    if arch == "llama-3.2-vision-90b":
        out = tserve.main(cli + dec + ["--cache_bits", "4", "--layers", "5"])
        assert out["arch"] == cfg.name and out["mode"] == "ladder"
        assert [r["rung_bits"] for r in out["requests"]] == list(LADDER)
        return
    want = rserve.main(cli + ["--encode", "--backend", "ref"])
    assert _summary_keys(got, "items") == _summary_keys(want, "items")
    strip = ("encoded_shape",)
    assert [{k: v for k, v in r.items() if k not in strip}
            for r in got["items"]] == \
        [{k: v for k, v in r.items() if k not in strip}
         for r in want["items"]]
    out = tserve.main(cli + dec + ["--cache_bits", "4"])
    assert out["mode"] == "ladder"
    assert [r["rung_bits"] for r in out["requests"]] == list(LADDER)
    assert all(len(r["sample"]) == 4 for r in out["requests"])
    samples = {b: tserve.main(cli + dec + ["--quant", "pann",
                                           "--power_bits", "4",
                                           "--backend", b])["sample"]
               for b in ("ref", "packed")}
    assert samples["ref"] == samples["packed"]
    assert len(samples["ref"]) == 4


@pytest.mark.parametrize("arch", ARCHS)
def test_single_point_artifact_matches_reference(arch):
    """``quantize_params_for_serving`` of both configs (b~x 4, value-exact
    plane counts, 4-bit cache leaves) leaf for leaf against the
    reference's, the conv stem and every ``xattn`` included (codes equal
    but at .5 ties of w / gamma, ``test_torch_single_point``'s rule). An
    outlier weight in seamless's encoder layer 0 packs that encoder
    module at 7 planes in every encoder layer (the encoder is a stack of
    its own) and leaves the decoder's at their own count."""
    np_params = jax.tree_util.tree_map(np.array, reference_params(arch))
    if arch == "seamless-m4t-medium":
        w = np_params["encoder"]["groups"]["layers"][0]["attn"]["wq"]["w"]
        w[0, 3, 5] = 50 * np.abs(w[0, :, 5]).max()
    rc, tc = ref_cfg(arch), port_cfg(arch)
    spec = dict(r=2.83, act_bits=4, pack_planes=True, cache_bits=4)
    ref = RSV.quantize_params_for_serving(
        jax.tree_util.tree_map(jnp.asarray, np_params), rc,
        spec=RSV.ServingQuantSpec(**spec))
    own = TSV.quantize_params_for_serving(
        params_from_reference(np_params, tc, "cpu"), tc,
        spec=TSV.ServingQuantSpec(**spec))
    _check_artifact(params_from_reference(tonp(ref), tc, "cpu"), own,
                    params_from_reference(np_params, tc, "cpu"))
    assert "w_planes_pos" in own["conv_stem"]["s0"]
    assert all("kv_cache" not in lp["xattn"] for lp in own["layers"]
               if "xattn" in lp)
    if arch == "seamless-m4t-medium":
        enc = own["encoder"]["layers"]
        assert [lp["attn"]["wq"]["w_planes_pos"].shape[0]
                for lp in enc] == [7] * len(enc)
        assert all(lp["attn"]["wq"]["w_planes_pos"].shape[0] < 7
                   for lp in own["layers"])
        assert all("kv_cache" in lp["attn"] for lp in enc)
