"""Whole-slice parity on reduced llama3-8b: ``decode_step`` and
``ServeEngine.generate`` of the port against the JAX package, on a weight
store carried across from it, ladder 2,4,6, KV cache fp and 4-bit.

Tolerance: teacher-forced logits agree within 1e-5 * max|logit| per step
(measured worst on these inputs, printed by the test: 2.7e-6, rung 4 with
the 4-bit cache; 2e-7 to 3e-7 elsewhere). The causes are RMSNorm, RoPE
sin/cos, silu and softmax ulps between XLA-CPU and torch-CPU, which can
move an activation or probability code across a rounding tie. Greedy
tokens must be equal wherever the reference's top-1/top-2 margin exceeds
twice that bound. Within the port, the three backends are bit-identical.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import model as RMD
from repro.serve_engine import Request as RRequest
from repro.serve_engine import ServeEngine as RServeEngine
from repro_torch.models import model as TMD
from repro_torch.serve_engine import Request as TRequest
from repro_torch.serve_engine import ServeEngine as TServeEngine
from test_torch_common import LADDER, port_cfg, ref_cfg, reference_store
from test_torch_common import one_torch_thread  # noqa: F401

REL_BOUND = 1e-5
STEPS = 10


def _strip_cache(tree):
    """The fp-cache store: the same views without their kv_cache leaves."""
    if isinstance(tree, dict):
        return {k: _strip_cache(v) for k, v in tree.items()
                if k != "kv_cache"}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_strip_cache(v) for v in tree)
    return tree


def _views(bits, cache_bits):
    _, _, ws, pws = reference_store()
    rv, tv = ws.views[bits], pws.views[bits]
    if cache_bits is None:
        rv, tv = _strip_cache(rv), _strip_cache(tv)
    return rv, tv


_STEP = {}


def _ref_step(cache_bits):
    if cache_bits not in _STEP:
        rc = dataclasses.replace(ref_cfg(), kernel_backend="ref",
                                 cache_bits=cache_bits)
        _STEP[cache_bits] = (rc, jax.jit(
            lambda p, s, t: RMD.decode_step(p, rc, s, t)))
    return _STEP[cache_bits]


def ref_logits(bits, cache_bits, rows):
    """(T, B, V) reference logits of teacher-forcing ``rows`` (B, T)."""
    rc, step = _ref_step(cache_bits)
    rv, _ = _views(bits, cache_bits)
    st = RMD.init_decode_state(rv, rc, rows.shape[0], rows.shape[1])
    out = []
    for t in range(rows.shape[1]):
        lg, st = step(rv, st, jnp.asarray(rows[:, t:t + 1]))
        out.append(np.asarray(lg)[:, 0])
    return np.stack(out)


def port_logits(bits, cache_bits, rows, backend):
    tc = dataclasses.replace(port_cfg(), kernel_backend=backend,
                             cache_bits=cache_bits)
    _, tv = _views(bits, cache_bits)
    st = TMD.init_decode_state(tv, tc, rows.shape[0], rows.shape[1])
    out = []
    for t in range(rows.shape[1]):
        lg, st = TMD.decode_step(tv, tc, st,
                                 torch.from_numpy(rows[:, t:t + 1]).long())
        out.append(lg[:, 0].numpy())
    return np.stack(out)


def _margin(logits, vocab=512):
    top2 = np.sort(logits[..., :vocab], axis=-1)[..., -2:]
    return top2[..., 1] - top2[..., 0]


@pytest.mark.parametrize("cache_bits", [None, 4])
@pytest.mark.parametrize("bits", LADDER)
def test_decode_step_teacher_forced_logits(bits, cache_bits):
    rows = np.random.default_rng(bits).integers(0, 512, (2, STEPS)).astype(
        np.int32)
    want = ref_logits(bits, cache_bits, rows)
    got = {b: port_logits(bits, cache_bits, rows, b)
           for b in ("ref", "fused", "packed")}
    # the port's own cross-backend contract: bit-identical logits
    assert np.array_equal(got["ref"], got["fused"])
    assert np.array_equal(got["ref"], got["packed"])
    scale = np.max(np.abs(want), axis=-1, keepdims=True)
    bound = REL_BOUND * scale
    assert np.all(np.abs(got["packed"] - want) <= bound), \
        np.max(np.abs(got["packed"] - want) / bound)
    print(f"rung {bits}, cache {cache_bits}: worst |logit gap| / "
          f"max|logit| = {np.max(np.abs(got['packed'] - want) / scale):.3g}")
    sure = _margin(want) > 2 * bound[..., 0]
    assert np.array_equal(np.argmax(want[..., :512], -1)[sure],
                          np.argmax(got["packed"][..., :512], -1)[sure])


@pytest.mark.parametrize("cache_bits", [None, 4])
def test_serve_engine_generate_matches_reference(cache_bits):
    _, _, ws, pws = reference_store()
    r_ws, t_ws = ws, pws
    if cache_bits is None:
        r_ws = type(ws)(store=ws.store, views=_strip_cache(ws.views))
        t_ws = type(pws)(store=pws.store, views=_strip_cache(pws.views))
    kw = dict(ladder_bits=LADDER, max_batch=2, max_len=12,
              cache_bits=cache_bits)
    reng = RServeEngine(ref_cfg(), weight_store=r_ws, backend="ref", **kw)
    teng = TServeEngine(port_cfg(), weight_store=t_ws, backend="packed",
                        device="cpu", **kw)
    rng = np.random.default_rng(7)
    budgets = (2, 4, 6, 4)
    prompts = [rng.integers(0, 512, 6).astype(np.int32) for _ in budgets]
    rres = reng.generate([RRequest(uid=i, prompt=p, max_new_tokens=6,
                                   power_budget_bits=b)
                          for i, (p, b) in enumerate(zip(prompts, budgets))])
    tres = teng.generate([TRequest(uid=i, prompt=p, max_new_tokens=6,
                                   power_budget_bits=b)
                          for i, (p, b) in enumerate(zip(prompts, budgets))])
    for r, t, p in zip(rres, tres, prompts):
        assert (r.uid, r.rung_bits) == (t.uid, t.rung_bits)
        # each response's energy report: the same rung, context and ledger
        assert r.metadata == t.metadata
        # tokens agree up to the first step the reference itself calls
        # too close (margin <= 2 * bound), after which they may diverge
        rows = np.concatenate([p, np.asarray(r.tokens[:-1], np.int32)])
        want = ref_logits(r.rung_bits, cache_bits,
                          np.stack([rows, rows]))[len(p) - 1:, 0]
        bound = REL_BOUND * np.max(np.abs(want), axis=-1)
        for i, (a, b) in enumerate(zip(r.tokens, t.tokens)):
            if _margin(want[i]) <= 2 * bound[i]:
                break
            assert a == b, (r.uid, i)
    assert teng.describe()["steps_by_rung"] == \
        reng.describe()["steps_by_rung"]


def test_engine_refuses_cuda_less_default_and_unported_options():
    cfg = port_cfg()
    if torch.cuda.is_available():
        pytest.skip("this host has a card: the default device is valid")
    with pytest.raises(RuntimeError, match="cuda"):
        TServeEngine(cfg, weight_store=reference_store()[3],
                     ladder_bits=LADDER)
    with pytest.raises(RuntimeError, match="cuda"):
        TMD.init_params(cfg)
    for bad in (dict(backend="packed:force"), dict(cache_bits=8)):
        with pytest.raises(ValueError):
            TServeEngine(cfg, weight_store=reference_store()[3],
                         ladder_bits=LADDER, device="cpu", **bad)


def test_decode_stream_rung_switches_match_reference():
    """A stream that switches rungs mid-flight replays its prefix through
    the next rung's view; tokens equal the reference's."""
    _, _, ws, pws = reference_store()
    kw = dict(ladder_bits=LADDER, max_batch=2, max_len=14, cache_bits=4)
    reng = RServeEngine(ref_cfg(), weight_store=ws, backend="ref", **kw)
    teng = TServeEngine(port_cfg(), weight_store=pws, backend="fused",
                        device="cpu", **kw)
    prompt = np.random.default_rng(11).integers(0, 512, 5).astype(np.int32)
    schedule = [(6, 3), (2, 3), (4, 2)]
    want = reng.decode_stream(prompt, schedule)
    got = teng.decode_stream(prompt, schedule)
    assert got == want
    assert teng.rung_switches == reng.rung_switches
