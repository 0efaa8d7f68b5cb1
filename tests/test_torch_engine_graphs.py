"""The serve engine's compiled decode step on reduced llama3-8b: the slot
step that ``ServeEngine.warmup`` captures as a CUDA graph on the card, run
eagerly here, against the functional ``decode_step`` and the JAX package's
engine, and the warmup / no-recompile bookkeeping around it.

Tolerance: within the port, the slot step is held bit for bit to the
functional ``decode_step`` (logits, tokens, cache lengths, position and
caches). Against the JAX package, tokens follow ``test_torch_slice``'s
rule: equal wherever the reference's top-1/top-2 margin exceeds twice its
1e-5 * max|logit| bound.
"""
import numpy as np
import pytest
import torch

from repro.serve_engine import Request as RRequest
from repro.serve_engine import ServeEngine as RServeEngine
from repro_torch.models import model as TMD
from repro_torch.serve_engine import Request as TRequest
from repro_torch.serve_engine import ServeEngine as TServeEngine
from test_torch_common import LADDER, port_cfg, ref_cfg, reference_store
from test_torch_common import one_torch_thread  # noqa: F401
from test_torch_slice import REL_BOUND, _margin, ref_logits

MAX_LEN = 12


def _engine(backend="packed", cache_bits=4, **kw):
    return TServeEngine(port_cfg(), weight_store=reference_store()[3],
                        ladder_bits=LADDER, max_batch=2, max_len=MAX_LEN,
                        backend=backend, cache_bits=cache_bits,
                        device="cpu", **kw)


def _state_tensors(state):
    return [t for c in state.caches for t in c] + [state.position]


def _assert_slot_equals(slot, state, tok):
    for a, b in zip(_state_tensors(slot.state), _state_tensors(state)):
        assert a.dtype == b.dtype and torch.equal(a, b)
    assert torch.equal(slot.tok, tok)


@pytest.mark.parametrize("backend,cache_bits", [("packed", 4), ("fused", 4),
                                                ("ref", None)])
def test_slot_step_matches_functional_decode_step(backend, cache_bits):
    """Two slots interleaved at different rungs, then a slot reset for a
    third wave at another rung: every slot step's logits, greedy token,
    cache lengths, position and caches equal the functional decode_step
    threaded through a fresh state, bit for bit."""
    eng = _engine(backend, cache_bits)
    rng = np.random.default_rng(3)
    waves = [(LADDER[0], 5), (LADDER[2], 7), (LADDER[1], 6)]

    def start(bits):
        slot = eng._acquire()
        state = TMD.init_decode_state(eng.variants[bits], eng.cfg, 2,
                                      MAX_LEN)
        # a reset slot is a fresh decode state bit for bit
        _assert_slot_equals(slot, state, torch.zeros_like(slot.tok))
        return {"bits": bits, "slot": slot, "state": state}

    def step(lane, tok_in):
        lane["slot"].tok.copy_(tok_in)
        got = eng._slot_step(lane["bits"], lane["slot"])
        want, lane["state"] = TMD.decode_step(
            eng.variants[lane["bits"]], eng.cfg, lane["state"], tok_in)
        assert torch.equal(got, want)
        greedy = torch.argmax(want[:, :, :eng.cfg.vocab_size], -1)
        _assert_slot_equals(lane["slot"], lane["state"], greedy)
        return greedy

    lanes = [start(waves[0][0]), start(waves[1][0])]
    toks = [torch.from_numpy(rng.integers(0, 512, (2, 1))) for _ in lanes]
    for t in range(max(n for _, n in waves[:2])):
        for i, (lane, (_, n)) in enumerate(zip(lanes, waves[:2])):
            if t < n:
                toks[i] = step(lane, toks[i])
    lanes[0]["slot"].busy = False
    third = start(waves[2][0])
    assert third["slot"] is lanes[0]["slot"]
    tok = torch.from_numpy(rng.integers(0, 512, (2, 1)))
    for _ in range(waves[2][1]):
        tok = step(third, tok)


def test_warmup_bookkeeping_on_cpu():
    eng = _engine()
    assert eng.describe()["compilations_after_warmup"] is None
    with pytest.raises(RuntimeError, match="warmup"):
        eng.assert_no_recompile()
    eng.warmup()
    assert eng.compilations_after_warmup == 0
    assert eng.describe()["compilations_after_warmup"] == 0
    eng.generate([TRequest(uid=0, prompt=np.arange(4, dtype=np.int32),
                           max_new_tokens=3, power_budget_bits=4)])
    eng.assert_no_recompile()
    eng.warmup()                       # a second call captures nothing
    assert eng.compilations_after_warmup == 0


def _requests(n_prompt=5, gen=4, budgets=(2, 4, 6, 4, 2)):
    rng = np.random.default_rng(5)
    return [dict(uid=i, prompt=rng.integers(0, 512, n_prompt).astype(
                 np.int32), max_new_tokens=gen, power_budget_bits=b)
            for i, b in enumerate(budgets)]


def test_call_needing_an_uncaptured_slot_raises():
    eng = _engine(slots=2)
    eng.warmup()
    with pytest.raises(ValueError, match="warmup"):
        eng.generate([TRequest(**r) for r in _requests()], max_lanes=3)
    waves = []
    for r in _requests()[:3]:
        eng.scheduler.submit(TRequest(**r))
        waves.append(eng.scheduler.next_wave())
    lanes = [eng.prefill_wave(w) for w in waves[:2]]
    with pytest.raises(ValueError, match="warmup"):
        eng.prefill_wave(waves[2])
    for lane in lanes:
        eng._finalize(lane)
    eng.prefill_wave(waves[2])         # a finalized lane frees its slot


def test_graphed_engine_refuses_steps_warmup_did_not_capture():
    """An engine that serves through graphs runs no step eagerly: before
    warmup every serving call raises."""
    eng = _engine()
    eng.graphed = True
    with pytest.raises(ValueError, match="warmup"):
        eng.decode_stream(np.arange(4, dtype=np.int32), [(2, 2)])
    with pytest.raises(ValueError, match="warmup"):
        eng.generate([TRequest(**r) for r in _requests()[:1]])
    assert not any(s.busy for s in eng._slots)


def _fake_graphs(eng, monkeypatch):
    """Drive a CPU engine through the card's path: warmup records the
    eager step of every (rung, slot) where the card captures a graph, and
    counts it as a capture."""
    eng.graphed = True
    monkeypatch.setattr(eng, "_prepare_capture", lambda: None)

    def capture(bits, slot):
        eng.graphs_captured += 1
        return lambda: eng._slot_step(bits, slot)

    monkeypatch.setattr(eng, "_capture", capture)


@pytest.mark.parametrize("graphed", [False, True])
def test_no_capture_after_warmup_and_tokens_match_reference(graphed,
                                                            monkeypatch):
    """After warmup the capture function is never called (patched to
    raise): generate and decode_stream run on what warmup captured (on
    the graphed path, only on it), and their tokens equal an unwarmed CPU
    engine's and the JAX package's."""
    eng = _engine()
    if graphed:
        _fake_graphs(eng, monkeypatch)
    eng.warmup()
    assert eng.compilations_after_warmup == (2 * len(LADDER) if graphed
                                             else 0)

    def refuse(*a):
        raise AssertionError("captured after warmup")

    monkeypatch.setattr(eng, "_capture", refuse)
    reqs = _requests()
    got = eng.generate([TRequest(**r) for r in reqs])
    stream = eng.decode_stream(reqs[0]["prompt"], [(6, 2), (2, 3)])
    eng.assert_no_recompile()

    fresh = _engine()
    assert [r.tokens for r in got] == \
        [r.tokens for r in fresh.generate([TRequest(**r) for r in reqs])]
    assert stream == fresh.decode_stream(reqs[0]["prompt"],
                                         [(6, 2), (2, 3)])

    _, _, ws, _ = reference_store()
    reng = RServeEngine(ref_cfg(), weight_store=ws, backend="ref",
                        ladder_bits=LADDER, max_batch=2, max_len=MAX_LEN,
                        cache_bits=4)
    want = reng.generate([RRequest(**r) for r in reqs])
    for r, t, q in zip(want, got, reqs):
        assert (r.uid, r.rung_bits, r.metadata) == \
            (t.uid, t.rung_bits, t.metadata)
        rows = np.concatenate([q["prompt"], np.asarray(r.tokens[:-1],
                                                       np.int32)])
        logits = ref_logits(r.rung_bits, 4, np.stack([rows, rows]))[
            len(q["prompt"]) - 1:, 0]
        bound = REL_BOUND * np.max(np.abs(logits), axis=-1)
        for i, (a, b) in enumerate(zip(r.tokens, t.tokens)):
            if _margin(logits[i]) <= 2 * bound[i]:
                break
            assert a == b, (r.uid, i)
