"""The port's serving fleet on its own (``repro_torch.serve_engine.fleet``,
the engine's lane API, ``dist.fault.Supervisor``), on the CPU, reduced
llama3-8b, over an artifact the port writes itself (``Fleet(params=...)``
quantizes once, writes the v1 artifact and maps it back): the three cases
of the JAX package's ``tests/test_fleet.py`` (a kill mid-decode resumed
bit for bit and equal to a kill-free fleet's tokens, a mid-run cap step
whose switched lanes replay bit for bit, the ledger accounting), a lane
moved between engines, the refusals, and the checkpoint supervisor.
Every served wave is checked by ``verify_streams`` on a fresh engine over
the fleet's store (bit-identical tokens). The cross-package cases are in
``test_torch_fleet.py``.
"""
import numpy as np
import pytest

from repro_torch.ckpt import checkpoint as TCK
from repro_torch.dist import fault as TFT
from repro_torch.models import model as TMD
from repro_torch.serve_engine import ServeEngine as TServeEngine
from repro_torch.serve_engine import engine as tengine
from repro_torch.serve_engine import fleet as TF
from test_torch_fleet import (LADDER, PROMPT, _fc, _one_thread,  # noqa: F401
                              _port_fleet, _run, _spec, _tokens_by_uid,
                              _verify_engine, tcfg)


@pytest.fixture(scope="module")
def artifact(tmp_path_factory):
    """The port's own artifact: a fleet built from params writes it."""
    d = str(tmp_path_factory.mktemp("port_fleet_artifact"))
    fleet = TF.Fleet(tcfg(), _fc(TF, "packed", n_decode_hosts=1), d,
                     params=TMD.init_params(tcfg(), seed=0, device="cpu"),
                     device="cpu")
    assert fleet.weight_store.views.keys() == set(LADDER)
    return d


# ---------------------------------------------------------------------------
# the lane API the fleet moves between engines
# ---------------------------------------------------------------------------

def test_lane_handoff_replay_and_slot_release(artifact):
    """A lane built on one engine steps only after another adopts it (its
    slots' graphs are its own); adoption frees the donor's slot; a
    prefix replay continues the same tokens; release frees a slot; the
    reference's replay-prefix checks."""
    fleet = _port_fleet(artifact, n_decode_hosts=1)
    a = fleet.prefill_hosts[0].engine
    b = fleet.decode_hosts[0].engine
    rng = np.random.default_rng(4)
    reqs = tuple(TF.Request(uid=i, prompt=rng.integers(0, 512, PROMPT)
                            .astype(np.int32), max_new_tokens=7)
                 for i in range(2))
    wave = TF.Wave(rung=b.rungs[2], requests=reqs)
    ref = a.prefill_wave(wave)
    for _ in range(6):
        a.step_lane(ref)
    whole = ref.generated_rows()
    a.release(ref)
    lane = a.prefill_wave(wave)
    with pytest.raises(ValueError, match="adopt"):
        b.step_lane(lane)
    donor = lane.slot
    b.adopt(lane)
    assert not donor.busy and lane.slot.busy and b._owns(lane.slot)
    for _ in range(2):
        b.step_lane(lane)
    head = lane.generated_rows()
    assert head.dtype == np.int32
    np.testing.assert_array_equal(head, whole[:, :3])
    b.release(lane)
    prefix = np.concatenate([np.stack([r.prompt for r in reqs]), head], 1)
    again = b.prefill_wave(wave, prefix_rows=prefix)
    assert (again.done, again.steps_left) == (3, 7 - 3 - 1)
    while not b.step_lane(again):
        pass
    np.testing.assert_array_equal(again.generated_rows(), whole[:, 3:])
    b.release(again)
    assert not any(s.busy for s in a._slots + b._slots)
    for bad in (prefix[:, :PROMPT - 1], np.concatenate(
            [prefix, whole[:, 3:]], 1)):
        with pytest.raises(ValueError, match="replay prefix carries"):
            b.prefill_wave(wave, prefix_rows=bad)


# ---------------------------------------------------------------------------
# tests/test_fleet.py's three cases on the port
# ---------------------------------------------------------------------------

def _small(**kw):
    base = dict(n_decode_hosts=2, cap_gbitflips_per_s=50.0)
    base.update(kw)
    return base


def _small_spec(**kw):
    base = dict(seed=3, n_ticks=6, slo_prob=0.0, budget_steps=(),
                host_kills=())
    base.update(kw)
    return _spec(TF, **base)


def test_host_kill_mid_decode_resumes_bit_identically(artifact):
    killed = _port_fleet(artifact, **_small())
    report = _run(killed, _small_spec(host_kills=((2, 1),)))
    killed.assert_no_recompile()
    assert report["host_restarts"] >= 1
    assert any(s["restarts"] >= 1 for s in report["streams"])
    assert TF.verify_streams(report, _verify_engine(killed)) == []
    calm = _port_fleet(artifact, **_small())
    calm_report = _run(calm, _small_spec())
    assert calm_report["host_restarts"] == 0
    assert _tokens_by_uid(report) == _tokens_by_uid(calm_report)


def test_mid_run_global_budget_step_bit_exact(artifact):
    fleet = _port_fleet(artifact, **_small(cap_gbitflips_per_s=0.25))
    report = _run(fleet, _small_spec(seed=5, n_ticks=12,
                                     budget_steps=((5, 0.03),)))
    fleet.assert_no_recompile()
    assert any(pt["ceiling_bits"] < max(LADDER)
               for pt in report["per_tick"])
    assert any(s["switches"] >= 1 for s in report["streams"])
    assert report["cap_violations"] == 0
    assert TF.verify_streams(report, _verify_engine(fleet)) == []


def test_fleet_report_accounting(artifact):
    fleet = _port_fleet(artifact, **_small())
    report = _run(fleet, _small_spec(seed=9, n_ticks=4))
    assert report["served"] == report["requests"]
    total = report["decode_gbitflips"] + report["prefill_gbitflips"]
    assert report["realized_gbitflips"] == pytest.approx(total)
    assert report["realized_gbitflips"] > 0
    assert report["decode_tokens"] == sum(s["max_new_tokens"]
                                          for s in report["streams"])
    hist = report["rung_token_histogram"]
    assert sum(hist.values()) >= report["decode_tokens"]
    assert TF.verify_streams(report, _verify_engine(fleet)) == []



def test_fleet_refuses_float_path_like_the_engine(artifact):
    with pytest.raises(ValueError) as err:
        TF.Fleet(tcfg(), _fc(TF, None), artifact, device="cpu")
    assert str(err.value) == tengine.NO_BACKEND
    with pytest.raises(ValueError) as err:
        TServeEngine(tcfg(), weight_store=TF.Fleet(
            tcfg(), _fc(TF, "packed", n_decode_hosts=1), artifact,
            device="cpu").weight_store, ladder_bits=LADDER, backend=None,
            device="cpu")
    assert str(err.value) == tengine.NO_BACKEND



def test_kill_of_unknown_host_refused(artifact):
    fleet = _port_fleet(artifact, n_decode_hosts=1)
    with pytest.raises(ValueError, match="unknown decode host 3"):
        _run(fleet, _small_spec(host_kills=((0, 3),)))



def _supervised(tmp_path, crash_at, max_restarts=3):
    crashed = set()

    def init_fn():
        return {"value": np.zeros((), np.float32), "steps_seen": []}

    def resume_fn(step):
        st = TCK.restore(str(tmp_path), step,
                         {"value": np.zeros((), np.float32)})
        return {"value": st["value"], "steps_seen": []}

    def step_fn(state, step):
        if step in crash_at and step not in crashed:
            crashed.add(step)
            raise RuntimeError("injected node failure")
        return {"value": state["value"] + 1.0,
                "steps_seen": state["steps_seen"] + [step]}

    def save_fn(state, step):
        TCK.save(str(tmp_path), step, {"value": state["value"]})

    sup = TFT.Supervisor(str(tmp_path), ckpt_every=5,
                         max_restarts=max_restarts)
    final = sup.run(total_steps=10, init_fn=init_fn, resume_fn=resume_fn,
                    step_fn=step_fn, save_fn=save_fn)
    return sup, final


def test_supervisor_restarts_after_injected_crash(tmp_path):
    """The reference's case: a crash at step 7 restores the step-5
    checkpoint (found by the port's ``latest_step``) and completes."""
    sup, final = _supervised(tmp_path / "a", {7})
    assert sup.restarts == 1
    assert float(final["value"]) == 10.0
    assert final["steps_seen"] == [5, 6, 7, 8, 9]
    assert TCK.latest_step(str(tmp_path / "a")) == 10
    # a crash before the first checkpoint re-runs from step 0
    sup, final = _supervised(tmp_path / "b", {2})
    assert sup.restarts == 1 and float(final["value"]) == 10.0
    assert final["steps_seen"] == list(range(10))
    # past max_restarts the failure propagates
    with pytest.raises(RuntimeError, match="injected"):
        _supervised(tmp_path / "c", {1, 3, 6}, max_restarts=2)
