"""Whole-slice parity on the reduced dense variants qwen1.5-4b (QKV bias,
rope theta 1e6, G = 1), gemma2-9b (local/global layers, attention and
logit softcaps, post-norms, GeGLU, ``scale_embed``, tied head, hd 32) and
stablelm-12b (layernorm, hd 16): ``decode_step`` and
``ServeEngine.generate`` of the port against the JAX package on a weight
store carried across from it, ladder 2,4,6, KV cache fp and 4-bit.

Before the store is built, the reference's parameters get seeded nonzero
values where init leaves zeros or ones: qwen's q/k/v biases, the
layernorm biases and every norm scale (a zero bias would test nothing).

Tolerance, as in ``test_torch_slice``: teacher-forced logits agree within
1e-5 * max|logit| per step (the worst measured is printed); the JAX side
runs its Pallas kernels in interpret mode (``packed:force``) at the top
rung with the 4-bit cache, and its integer oracle (bit-identical to them
by the JAX package's own contract) elsewhere. Within the port the three
backends are bit-identical. Greedy tokens of the engines are equal
wherever the reference's top-1/top-2 margin exceeds twice that bound.
"""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as rconfigs
from repro.models import model as RMD
from repro.models import serving as RSV
from repro.serve_engine import Request as RRequest
from repro.serve_engine import ServeEngine as RServeEngine
from repro_torch import configs as tconfigs
from repro_torch.convert import (params_from_reference, reference_layout,
                                 weight_store_from_reference)
from repro_torch.models import model as TMD
from repro_torch.models import serving as TSV
from repro_torch.serve_engine import Request as TRequest
from repro_torch.serve_engine import ServeEngine as TServeEngine
from repro_torch.serve_engine.artifact import _flatten
from test_torch_common import LADDER, rung_specs, tonp
from test_torch_common import one_torch_thread  # noqa: F401
from test_torch_slice import REL_BOUND, _margin, _strip_cache

ARCHS = ("qwen1.5-4b", "gemma2-9b", "stablelm-12b")
STEPS = 8            # teacher-forced tokens; max_len stays <= the window
VOCAB = 512


def ref_cfg(arch):
    return rconfigs.reduced(rconfigs.get_config(arch))


def port_cfg(arch):
    return tconfigs.reduced(tconfigs.get_config(arch))


def _perturb(node, rng, trail=()):
    """Seeded nonzero values for the leaves init makes 0 or 1: q/k/v
    biases, norm biases, norm scales (numpy tree in, numpy tree out)."""
    if isinstance(node, dict):
        return {k: _perturb(v, rng, trail + (k,)) for k, v in node.items()}
    if isinstance(node, (list, tuple)):
        return [_perturb(v, rng, trail) for v in node]
    a = np.asarray(node)
    name = trail[-1]
    if name == "b" or name == "bias":
        return rng.normal(0.0, 0.3, a.shape).astype(a.dtype)
    if name == "scale":
        return (a + rng.normal(0.0, 0.2, a.shape)).astype(a.dtype)
    return a


@functools.lru_cache(maxsize=None)
def reference_params(arch, seed=0):
    """The reference's params with the zero/one leaves perturbed (numpy)."""
    params = RMD.init_params(jax.random.PRNGKey(seed), ref_cfg(arch))
    return _perturb(tonp(params), np.random.default_rng(seed + 17))


@functools.lru_cache(maxsize=None)
def reference_store(arch):
    """(ref WeightStore, port WeightStore) with packed planes and 4-bit
    cache leaves, carried across onto the CPU."""
    cfg = ref_cfg(arch)
    params = jax.tree_util.tree_map(jnp.asarray, reference_params(arch))
    spec = RSV.ServingQuantSpec(pack_planes=True, cache_bits=4)
    ws = RSV.build_weight_store(params, cfg, rung_specs(cfg), spec=spec)
    pws = weight_store_from_reference(
        tonp(ws.store), {k: tonp(v) for k, v in ws.views.items()},
        port_cfg(arch), "cpu")
    return ws, pws


def _views(arch, bits, cache_bits):
    ws, pws = reference_store(arch)
    rv, tv = ws.views[bits], pws.views[bits]
    if cache_bits is None:
        rv, tv = _strip_cache(rv), _strip_cache(tv)
    return rv, tv


@functools.lru_cache(maxsize=None)
def _ref_step(arch, backend, cache_bits):
    rc = dataclasses.replace(ref_cfg(arch), kernel_backend=backend,
                             cache_bits=cache_bits)
    return rc, jax.jit(lambda p, s, t: RMD.decode_step(p, rc, s, t))


def ref_logits(arch, bits, cache_bits, rows, backend="ref"):
    """(T, B, V) reference logits of teacher-forcing ``rows`` (B, T)."""
    rc, step = _ref_step(arch, backend, cache_bits)
    rv, _ = _views(arch, bits, cache_bits)
    st = RMD.init_decode_state(rv, rc, rows.shape[0], rows.shape[1])
    out = []
    for t in range(rows.shape[1]):
        lg, st = step(rv, st, jnp.asarray(rows[:, t:t + 1]))
        out.append(np.asarray(lg)[:, 0])
    return np.stack(out)


def port_logits(arch, bits, cache_bits, rows, backend):
    tc = dataclasses.replace(port_cfg(arch), kernel_backend=backend,
                             cache_bits=cache_bits)
    _, tv = _views(arch, bits, cache_bits)
    st = TMD.init_decode_state(tv, tc, rows.shape[0], rows.shape[1])
    out = []
    for t in range(rows.shape[1]):
        lg, st = TMD.decode_step(tv, tc, st,
                                 torch.from_numpy(rows[:, t:t + 1]).long())
        out.append(lg[:, 0].numpy())
    return np.stack(out)


def _leaves(tree):
    return {path: (tuple(t.shape), str(t.dtype).replace("torch.", ""))
            for path, t in _flatten(tree)}


def _np_leaves(tree, trail=""):
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_np_leaves(v, f"{trail}/{k}" if trail else k))
        return out
    if isinstance(tree, (list, tuple)):
        out = {}
        for i, v in enumerate(tree):
            out.update(_np_leaves(v, f"{trail}/{i}"))
        return out
    return {trail: np.asarray(tree)}


@pytest.mark.parametrize("arch", ARCHS)
def test_reduced_configs_are_the_reference_smoke_variants(arch):
    """``reduced`` gives the reference's smoke variant field for field:
    qwen kv 4 (G = 1), gemma2 hd 32 / kv 2 / windows 16, stablelm hd 16
    (kv 1, G = 4)."""
    rc, tc = ref_cfg(arch), port_cfg(arch)
    assert dataclasses.asdict(tc) == dataclasses.asdict(rc)
    want = {"qwen1.5-4b": (1, 16, 4), "gemma2-9b": (2, 32, 2),
            "stablelm-12b": (4, 16, 1)}[arch]
    assert (tc.num_heads // tc.num_kv_heads, tc.resolved_head_dim,
            tc.num_kv_heads) == want
    full = tconfigs.get_config(arch)
    assert dataclasses.asdict(full) == dataclasses.asdict(
        rconfigs.get_config(arch))


@pytest.mark.parametrize("arch", ARCHS)
def test_params_and_store_carry_across_both_ways(arch):
    """The port's own init has the reference's leaf set (post-norms,
    layernorm biases, q/k/v biases, no lm_head when tied); carried
    params restack into the reference's group layout leaf for leaf; the
    port's store built from the carried params has the reference store's
    leaves (the tied head's fp32 table included) and views."""
    rc, tc = ref_cfg(arch), port_cfg(arch)
    ref = reference_params(arch)
    own = TMD.init_params(tc, seed=0, device="cpu")
    carried = params_from_reference(ref, tc, "cpu")
    assert _leaves(own) == _leaves(carried)
    assert ("lm_head" in own) == (not tc.tie_embeddings)
    back = reference_layout(carried, tc)
    want = _np_leaves(ref)

    def restacked(node):
        if isinstance(node, dict):
            return {k: restacked(v) for k, v in node.items()}
        if isinstance(node, list):
            return [restacked(v) for v in node]
        if hasattr(node, "parts"):
            return np.stack([p.numpy() for p in node.parts])
        return node.numpy()
    got = _np_leaves(restacked(back))
    assert sorted(got) == sorted(want)
    for k in want:
        assert np.array_equal(got[k], want[k]), k
    # the store the port builds from the same params
    pstore = TSV.build_weight_store(
        params_from_reference(ref, tc, "cpu"), tc, rung_specs(rc),
        TSV.ServingQuantSpec(pack_planes=True, cache_bits=4))
    ws, pws = reference_store(arch)
    assert _leaves(pstore.store) == _leaves(pws.store)
    for bits in LADDER:
        assert _leaves(pstore.views[bits]) == _leaves(pws.views[bits])
    if tc.tie_embeddings:
        table = pstore.store["embed"]["table"]
        assert table.dtype == torch.float32
        assert np.array_equal(table.numpy(),
                              np.asarray(ws.store["embed"]["table"]))
    if tc.qkv_bias:
        b = pstore.views[LADDER[0]]["layers"][0]["attn"]["wk"]["b"]
        assert b is pstore.store["layers"][0]["attn"]["wk"]["b"]
        assert b.abs().min() > 0


@pytest.mark.parametrize("cache_bits", [None, 4])
@pytest.mark.parametrize("arch", ARCHS)
def test_decode_step_teacher_forced_logits(arch, cache_bits):
    """Every rung: the port's ref / fused / packed logits bit-identical to
    each other and within 1e-5 * max|logit| of the reference's, whose
    packed run goes through its Pallas kernels in interpret mode."""
    worst = 0.0
    for bits in LADDER:
        rows = np.random.default_rng(bits).integers(
            0, VOCAB, (2, STEPS)).astype(np.int32)
        got = {b: port_logits(arch, bits, cache_bits, rows, b)
               for b in ("ref", "fused", "packed")}
        assert np.array_equal(got["ref"], got["fused"])
        assert np.array_equal(got["ref"], got["packed"])
        # the quantized cache puts both Pallas kernels (B2, B3) on the JAX
        # side's path: run them in interpret mode there, once a config
        ref_backend = ("packed:force" if cache_bits and bits == LADDER[-1]
                       else "ref")
        want = ref_logits(arch, bits, cache_bits, rows, ref_backend)
        scale = np.max(np.abs(want), axis=-1, keepdims=True)
        bound = REL_BOUND * scale
        assert np.all(np.abs(got["packed"] - want) <= bound), \
            np.max(np.abs(got["packed"] - want) / bound)
        worst = max(worst, float(np.max(np.abs(got["packed"] - want)
                                        / scale)))
        sure = _margin(want) > 2 * bound[..., 0]
        assert np.array_equal(np.argmax(want[..., :VOCAB], -1)[sure],
                              np.argmax(got["packed"][..., :VOCAB], -1)[sure])
    print(f"{arch}, cache {cache_bits}: worst |logit gap| / max|logit| = "
          f"{worst:.3g}")


@pytest.mark.parametrize("arch", ARCHS)
def test_serve_engine_generate_matches_reference(arch):
    ws, pws = reference_store(arch)
    kw = dict(ladder_bits=LADDER, max_batch=2, max_len=12, cache_bits=4)
    reng = RServeEngine(ref_cfg(arch), weight_store=ws, backend="ref", **kw)
    teng = TServeEngine(port_cfg(arch), weight_store=pws, backend="packed",
                        device="cpu", **kw)
    teng.warmup()
    rng = np.random.default_rng(7)
    budgets = (2, 4, 6, 4)
    prompts = [rng.integers(0, VOCAB, 6).astype(np.int32) for _ in budgets]
    rres = reng.generate([RRequest(uid=i, prompt=p, max_new_tokens=6,
                                   power_budget_bits=b)
                          for i, (p, b) in enumerate(zip(prompts, budgets))])
    tres = teng.generate([TRequest(uid=i, prompt=p, max_new_tokens=6,
                                   power_budget_bits=b)
                          for i, (p, b) in enumerate(zip(prompts, budgets))])
    teng.assert_no_recompile()
    for r, t, p in zip(rres, tres, prompts):
        assert (r.uid, r.rung_bits) == (t.uid, t.rung_bits)
        assert r.metadata == t.metadata
        rows = np.concatenate([p, np.asarray(r.tokens[:-1], np.int32)])
        want = ref_logits(arch, r.rung_bits, 4,
                          np.stack([rows, rows]))[len(p) - 1:, 0]
        bound = REL_BOUND * np.max(np.abs(want), axis=-1)
        for i, (a, b) in enumerate(zip(r.tokens, t.tokens)):
            if _margin(want[i]) <= 2 * bound[i]:
                break
            assert a == b, (r.uid, i)
    assert teng.describe()["steps_by_rung"] == \
        reng.describe()["steps_by_rung"]


@pytest.mark.parametrize("arch", ARCHS)
def test_serve_cli_takes_each_variant(arch):
    """``launch/serve.py --arch`` serves each variant (reduced, on the
    CPU): every request gets its tokens at the rung its budget picks."""
    from repro_torch.launch import serve
    out = serve.main(["--arch", arch, "--reduced", "--device", "cpu",
                      "--batch", "2", "--prompt_len", "4", "--gen", "4",
                      "--requests", "3", "--cache_bits", "4"])
    assert out["arch"] == arch + "-smoke"
    assert [r["rung_bits"] for r in out["requests"]] == list(LADDER)
    assert all(len(r["sample"]) == 4 for r in out["requests"])

