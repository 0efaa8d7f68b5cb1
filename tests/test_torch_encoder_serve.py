"""Decode of the cross-attending families through the port's serving path,
against the JAX package on the CPU, on reduced seamless-m4t-medium and
llama-3.2-vision-90b with a weight store carried across from the reference
(ladder 2,4,6, packed planes, 4-bit KV cache; the reference's parameters
seeded as in ``test_torch_encoder``, xgate nonzero): ``init_decode_state``'s
cross K/V off raw 4-D input at a rung view and teacher-forced decode from
it, ``ServeEngine`` with ``frontend_kwargs_fn`` (tokens and ledgers), and
the engine's graphed path driven on the CPU (``test_torch_engine_graphs``'
recorded steps), whose slots take every wave's cross K/V into their own
buffers in place.

Tolerance, as in ``test_torch_slice``: logits within 1e-5 * max|logit| a
step, the cross K/V within 1e-5 * max|K/V| (the encoder's fp stages:
layernorm, RoPE, bidirectional attention); tokens equal wherever the
reference's top-1/top-2 margin exceeds twice that bound. Within the port
the three backends, and the graphed slots against a functional decode
from their own ``init_decode_state``, are bit-identical.
"""
import functools

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
from test_torch_common import LADDER
from test_torch_common import one_torch_thread  # noqa: F401
from test_torch_encoder import (ARCHS, BATCH, REL_BOUND, frontend_key,
                                port_cfg, raw_input, ref_cfg,
                                reference_store, tokens)
from test_torch_engine_graphs import _fake_graphs
from test_torch_slice import _margin

STEPS = 4
MAX_LEN = 10


@functools.lru_cache(maxsize=None)
def _ref_step(arch):
    rc = ref_cfg(arch, kernel_backend="ref", cache_bits=4)
    return rc, jax.jit(lambda p, s, t: RMD.decode_step(p, rc, s, t))


def ref_decode(arch, bits, fe, rows, max_len=MAX_LEN):
    """(reference state, (T, B, V) logits) of teacher-forcing ``rows``
    from a state built off frontend ``fe``."""
    rc, step = _ref_step(arch)
    view = reference_store(arch)[0].views[bits]
    st = RMD.init_decode_state(view, rc, rows.shape[0], max_len,
                               **{frontend_key(rc): jnp.asarray(fe)})
    first, out = st, []
    for t in range(rows.shape[1]):
        lg, st = step(view, st, jnp.asarray(rows[:, t:t + 1]))
        out.append(np.asarray(lg)[:, 0])
    return first, np.stack(out)


def port_decode(arch, bits, backend, fe, rows, max_len=MAX_LEN):
    cfg = port_cfg(arch, kernel_backend=backend, cache_bits=4)
    view = reference_store(arch)[1].views[bits]
    st = TMD.init_decode_state(view, cfg, rows.shape[0], max_len,
                               **{frontend_key(cfg): torch.from_numpy(fe)})
    first, out = st, []
    for t in range(rows.shape[1]):
        lg, st = TMD.decode_step(view, cfg, st,
                                 torch.from_numpy(rows[:, t:t + 1]).long())
        out.append(lg[:, 0])
    return first, torch.stack(out)


@pytest.mark.parametrize("arch", ARCHS)
def test_cross_kv_and_decode_match_reference(arch):
    """Every cross_attn layer's K/V, projected once from raw input at the
    rung's view, against the reference's (stacked per group); then
    teacher-forced decode at the bottom and top rungs: 'ref' against the
    reference's jitted step, 'fused' and 'packed' bit-identical to 'ref'
    (cross K/V included)."""
    raw = raw_input(arch, step=2)
    cfg = port_cfg(arch)
    n_cross = sum(s.kind == "cross_attn" for s in TMD.layer_specs(cfg))
    for bits in (2, 6):
        rows = tokens(bits)
        rst, want = ref_decode(arch, bits, raw, rows)
        got = {b: port_decode(arch, bits, b, raw, rows)
               for b in ("ref", "fused", "packed")}
        # the reference's cross K/V: per pattern cross layer a (K, V) pair
        # stacked over the groups; the port's: one pair per cross layer
        n_groups = np.asarray(rst.cross_kv[0][0]).shape[0]
        ref_kv = [np.asarray(a[g]) for g in range(n_groups)
                  for pair in rst.cross_kv for a in pair]
        port_kv = [t for pair in got["ref"][0].cross_kv if pair is not None
                   for t in pair]
        assert len(port_kv) == len(ref_kv) == 2 * n_cross
        for a, b in zip(port_kv, ref_kv):
            assert tuple(a.shape) == b.shape
            np.testing.assert_allclose(a.numpy(), b, rtol=0,
                                       atol=REL_BOUND * np.abs(b).max())
        mine = got["ref"][1].numpy()
        assert np.isfinite(mine).all()
        bound = REL_BOUND * np.abs(want).max(axis=(1, 2), keepdims=True)
        assert np.all(np.abs(mine - want) <= bound)
        for backend in ("fused", "packed"):
            state, logits = got[backend]
            assert torch.equal(logits, got["ref"][1])
            for x, y in zip(state.cross_kv, got["ref"][0].cross_kv):
                assert (x is None) == (y is None)
                assert x is None or all(torch.equal(u, v)
                                        for u, v in zip(x, y))


def _requests(seed=7):
    rng = np.random.default_rng(seed)
    return [dict(uid=i, prompt=rng.integers(0, 512, 4).astype(np.int32),
                 max_new_tokens=4, power_budget_bits=b)
            for i, b in enumerate((2, 6, 4))]


def _frontend(arch, made=None):
    """frontend_kwargs_fn of raw input: the same input every call, or,
    with ``made``, a new seeded input every call, recorded."""
    cfg = port_cfg(arch)

    def fn(batch):
        step = 0 if made is None else len(made)
        fe = raw_input(arch, step=step, batch=batch)
        if made is not None:
            made.append(fe)
        return {frontend_key(cfg): fe}
    return fn


@pytest.mark.parametrize("arch", ARCHS)
def test_serve_engine_with_frontend_matches_reference(arch):
    """``ServeEngine`` with a raw frontend: the port's 'packed' engine
    against the reference's 'ref' engine on the same store, every
    response's rung and ledger equal, tokens equal up to the first step
    the reference calls too close."""
    ws, pws = reference_store(arch)
    kw = dict(ladder_bits=LADDER, max_batch=BATCH, max_len=MAX_LEN,
              cache_bits=4, frontend_kwargs_fn=_frontend(arch))
    reqs = _requests()
    reng = RServeEngine(ref_cfg(arch), weight_store=ws, backend="ref", **kw)
    teng = TServeEngine(port_cfg(arch), weight_store=pws, backend="packed",
                        device="cpu", **kw)
    rres = reng.generate([RRequest(**r) for r in reqs])
    tres = teng.generate([TRequest(**r) for r in reqs])
    raw = raw_input(arch, step=0)
    for r, t, q in zip(rres, tres, reqs):
        assert (r.uid, r.rung_bits, r.metadata) == \
            (t.uid, t.rung_bits, t.metadata)
        if r.tokens == t.tokens:
            continue
        rows = np.concatenate([q["prompt"], np.asarray(r.tokens[:-1],
                                                       np.int32)])
        _, want = ref_decode(arch, r.rung_bits, raw, np.stack([rows, rows]))
        want = want[len(q["prompt"]) - 1:, 0]
        bound = REL_BOUND * np.max(np.abs(want), axis=-1)
        for i, (a, b) in enumerate(zip(r.tokens, t.tokens)):
            if _margin(want[i]) <= 2 * bound[i]:
                break
            assert a == b, (r.uid, i)
    assert teng.describe()["steps_by_rung"] == \
        reng.describe()["steps_by_rung"]


@pytest.mark.parametrize("arch", ARCHS)
def test_graphed_slots_take_each_wave_cross_kv_in_place(arch, monkeypatch):
    """The card's path on the CPU (every step a recorded replay of what
    warmup captured), a new frontend every wave: each wave's cross K/V
    land in the slot's own buffers (the pointers warmup captured), bit
    for bit the K/V of ``init_decode_state`` on that wave's input at its
    rung, and every response's tokens equal a functional greedy decode
    from that state."""
    _, pws = reference_store(arch)
    made = []
    eng = TServeEngine(port_cfg(arch), weight_store=pws, ladder_bits=LADDER,
                       max_batch=BATCH, max_len=MAX_LEN, backend="packed",
                       cache_bits=4, device="cpu",
                       frontend_kwargs_fn=_frontend(arch, made))
    _fake_graphs(eng, monkeypatch)
    eng.warmup()
    ptrs = {s.index: [t.data_ptr() for pair in s.state.cross_kv
                      if pair is not None for t in pair]
            for s in eng._slots}
    waves = []
    load = eng._load_frontend

    def recorded(bits, slot):
        load(bits, slot)
        waves.append((bits, slot.index, made[-1],
                      [t.clone() for pair in slot.state.cross_kv
                       if pair is not None for t in pair]))

    monkeypatch.setattr(eng, "_load_frontend", recorded)
    reqs = _requests(seed=11)
    res = eng.generate([TRequest(**r) for r in reqs])
    eng.assert_no_recompile()
    assert len(waves) == len(reqs) and len(made) == len(eng._slots) + 3
    key = frontend_key(eng.cfg)
    # one request a rung, so a wave's rung names its request
    by_bits = {r.rung_bits: (r, q) for r, q in zip(res, reqs)}
    for bits, index, fe, kv in waves:
        resp, q = by_bits[bits]
        slot = eng._slots[index]
        assert [t.data_ptr() for pair in slot.state.cross_kv
                if pair is not None for t in pair] == ptrs[index]
        view = eng.variants[bits]
        st = TMD.init_decode_state(view, eng.cfg, BATCH, MAX_LEN,
                                   **{key: torch.from_numpy(fe)})
        want = [t for pair in st.cross_kv if pair is not None for t in pair]
        assert all(torch.equal(a, b) for a, b in zip(kv, want))
        rows = torch.from_numpy(np.stack([q["prompt"]] * BATCH)).long()
        toks = []
        for t in range(rows.shape[1] + q["max_new_tokens"] - 1):
            tok = rows[:, t:t + 1] if t < rows.shape[1] else toks[-1]
            lg, st = TMD.decode_step(view, eng.cfg, st, tok)
            if t >= rows.shape[1] - 1:
                toks.append(torch.argmax(lg[:, :, :eng.cfg.vocab_size], -1))
        assert resp.tokens == [int(t[0, 0]) for t in toks]
    # different frontends, different K/V: the copies are not vacuous
    assert not torch.equal(waves[0][3][0], waves[1][3][0])


def test_engine_refuses_a_missing_or_misshapen_frontend():
    arch = ARCHS[0]
    _, pws = reference_store(arch)
    cfg = port_cfg(arch)
    kw = dict(weight_store=pws, ladder_bits=LADDER, max_batch=BATCH,
              max_len=MAX_LEN, cache_bits=4, device="cpu")
    with pytest.raises(ValueError, match="frontend_kwargs_fn"):
        TServeEngine(cfg, **kw)
    made = []
    eng = TServeEngine(cfg, frontend_kwargs_fn=_frontend(arch, made), **kw)

    def short(batch):
        return {frontend_key(cfg): raw_input(arch, batch=batch)[:, :48]}

    eng._frontend_kwargs_fn = short
    with pytest.raises(ValueError, match="slots hold"):
        eng.generate([TRequest(**_requests()[0])])
    assert not any(s.busy for s in eng._slots)
