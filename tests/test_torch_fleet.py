"""The serving fleet of the port (``repro_torch.serve_engine.fleet``, the
fault classes of ``dist.fault``, ``dist.sharding.rung_shard``, the lane
API of ``ServeEngine`` it moves between engines, and the serve CLI's fleet
mode) against the JAX package, on the CPU, reduced llama3-8b.

The traces, rung shards and governor are held equal. The fleet runs
``benchmarks/fleet_sim.py``'s settings (4 decode hosts and a prefill host,
a host kill at tick 4 and a cap step at tick 6) in both packages over one
artifact that the JAX package wrote: the JAX fleet at backend 'ref' (its
backends agree bit for bit; its Pallas kernels in interpret mode would be
slow), the port's at 'packed'. Tolerance: the EXACT fields of
``fleet_sim.py`` are equal (``realized_gbitflips`` by ``==``: prices are
host floats summed in the same order), so are the replan log and every
stream's segments; tokens are equal up to the first step where the
reference's top-two margin is within ``2 * test_torch_slice.REL_BOUND *
max|logit|`` (the rule of ``test_torch_slice``), and the port's
``verify_streams`` finds nothing.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as rconfigs
from repro.configs.base import QuantConfig as RQuantConfig
from repro.core import costs as rcosts
from repro.dist import fault as RFT
from repro.dist.sharding import rung_shard as r_rung_shard
from repro.launch import serve as rserve
from repro.models import model as RMD
from repro.models import serving as RSV
from repro.serve_engine import artifact as RA
from repro.serve_engine import fleet as RF
from repro.serve_engine.ladder import build_ladder as r_build_ladder
from repro_torch import configs as tconfigs
from repro_torch.configs.base import QuantConfig as TQuantConfig
from repro_torch.core import costs as tcosts
from repro_torch.dist import fault as TFT
from repro_torch.dist.sharding import rung_shard as t_rung_shard
from repro_torch.launch import serve as tserve
from repro_torch.serve_engine import ServeEngine as TServeEngine
from repro_torch.serve_engine import fleet as TF
from repro_torch.serve_engine.ladder import build_ladder as t_build_ladder
from test_torch_engine_graphs import _fake_graphs
from test_torch_slice import REL_BOUND, _margin

LADDER = (2, 4, 6)
PROMPT, GEN = 6, (6, 10)
MAX_LEN = PROMPT + max(GEN) + 2
CACHE_BITS = 4
# benchmarks/fleet_sim.py's EXACT-gated fields
EXACT_FIELDS = ("served", "realized_gbitflips", "decode_tokens",
                "cap_violations", "host_restarts", "migrations",
                "slo_violations")


def rcfg():
    return dataclasses.replace(
        rconfigs.reduced(rconfigs.get_config("llama3-8b")),
        quant=RQuantConfig(mode="none"))


def tcfg():
    return dataclasses.replace(
        tconfigs.reduced(tconfigs.get_config("llama3-8b")),
        quant=TQuantConfig(mode="none"))


def _fc(mod, backend, **kw):
    """fleet_sim.py's FleetConfig (4 decode hosts, control interval 3,
    batch 2, the drain guard at 16), with the 4-bit cache."""
    base = dict(n_decode_hosts=4, n_prefill_hosts=1, ladder_bits=LADDER,
                cap_gbitflips_per_s=0.25, control_interval=3, max_batch=2,
                max_len=MAX_LEN, drain_tick_factor=16,
                cache_bits=CACHE_BITS, backend=backend)
    base.update(kw)
    return mod.FleetConfig(**base)


def _spec(mod, **kw):
    """fleet_sim.py's traffic at scale 1: 12 ticks from seed 7, the cap
    step at tick 6 and the kill of decode host 1 at tick 4."""
    base = dict(seed=7, n_ticks=12, burst_prob=0.7, mean_burst=2.0,
                prompt_lens=(PROMPT,), gen_tokens=GEN,
                budget_mix=(2, 4, 6, 6), slo_prob=0.3, slo_bits=(4,),
                budget_steps=((6, 0.035),), host_kills=((4, 1),))
    base.update(kw)
    return mod.TrafficSpec(**base)



@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    """The reduced configs run thousands of tiny torch ops; one intra-op
    thread keeps them from contending with the other test workers'
    threads for the cores (the results do not depend on it)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)

@pytest.fixture(scope="module")
def artifact(tmp_path_factory):
    """The fleet's artifact, written by the JAX package as its
    ``Fleet.__init__`` writes one: packed planes, the 4-bit cache."""
    cfg = rcfg()
    params = RMD.init_params(jax.random.PRNGKey(0), cfg)
    ladder = r_build_ladder(LADDER, d=float(cfg.d_model),
                            allocation="uniform",
                            profile=rcosts.module_cost_profile(cfg))
    specs = {op.bits: (op.r, op.b_x_tilde) for op in ladder}
    ws = RSV.build_weight_store(
        params, cfg, specs, spec=RSV.ServingQuantSpec(
            pack_planes=True,
            cache_bits={op.bits: CACHE_BITS for op in ladder}))
    d = str(tmp_path_factory.mktemp("fleet_artifact"))
    RA.write_artifact(d, ws, meta={"fleet_ladder": list(LADDER)})
    return d


def _port_fleet(art, **kw):
    return TF.Fleet(tcfg(), _fc(TF, "packed", **kw), art, device="cpu")


def _run(fleet, spec):
    return fleet.run(TF.make_trace(spec, fleet.cfg.vocab_size, fleet.ladder))


def _verify_engine(fleet, max_len=MAX_LEN):
    """A fresh full-ladder engine over the fleet's store, with the fleet's
    backend and cache width."""
    eng = TServeEngine(fleet.cfg, weight_store=fleet.weight_store,
                       ladder_bits=LADDER, max_batch=2, max_len=max_len,
                       backend="packed", cache_bits=CACHE_BITS, slots=1,
                       device="cpu")
    eng.warmup()
    return eng


@pytest.fixture(scope="module")
def both(artifact):
    """The fleet_sim trace served by both packages on one artifact."""
    rfleet = RF.Fleet(rcfg(), _fc(RF, "ref"), artifact)
    rrep = rfleet.run(RF.make_trace(_spec(RF), rfleet.cfg.vocab_size,
                                    rfleet.ladder))
    tfleet = _port_fleet(artifact)
    trep = _run(tfleet, _spec(TF))
    return rfleet, rrep, tfleet, trep


def _tokens_by_uid(report):
    return {s["uid"]: [t for seg in s["segments"]
                       for t in seg["tokens"]][:s["max_new_tokens"]]
            for s in report["streams"]}


# ---------------------------------------------------------------------------
# traces, rung shards, the governor
# ---------------------------------------------------------------------------

TRACE_SPECS = [
    dict(),
    dict(seed=3, n_ticks=20, burst_prob=0.4, mean_burst=3.0,
         prompt_lens=(4, 8, 11), gen_tokens=(2, 5, 9), slo_prob=0.6,
         slo_bits=(4, 6)),
    dict(seed=2 ** 63 + 5, n_ticks=30, burst_prob=1.0, mean_burst=0.25,
         budget_mix=(6, 2), slo_prob=0.0, budget_steps=((3, 1.0),
                                                        (9, 0.5)),
         host_kills=((2, 0), (5, 3))),
]


@pytest.mark.parametrize("kw", TRACE_SPECS)
def test_make_trace_equal_request_for_request(kw):
    rlad = r_build_ladder(LADDER, d=64.0)
    tlad = t_build_ladder(LADDER, d=64.0)
    want = RF.make_trace(_spec(RF, **kw), 512, rlad)
    got = TF.make_trace(_spec(TF, **kw), 512, tlad)
    assert got.n_requests == want.n_requests > 0
    assert (got.budget_steps, got.host_kills, got.n_ticks) == \
        (want.budget_steps, want.host_kills, want.n_ticks)
    assert len(got.arrivals) == len(want.arrivals)
    for (rt, rreqs), (tt, treqs) in zip(want.arrivals, got.arrivals):
        assert rt == tt and len(rreqs) == len(treqs)
        for r, t in zip(rreqs, treqs):
            assert (r.uid, r.max_new_tokens, r.power_budget_bits,
                    r.min_score) == (t.uid, t.max_new_tokens,
                                     t.power_budget_bits, t.min_score)
            assert r.prompt.dtype == t.prompt.dtype == np.int32
            assert r.prompt.tobytes() == t.prompt.tobytes()


def test_make_trace_refuses_foreign_slo_bits():
    with pytest.raises(ValueError, match="slo_bits"):
        TF.make_trace(_spec(TF, slo_bits=(5,)), 512,
                      t_build_ladder(LADDER, d=64.0))


@pytest.mark.parametrize("ladder", [(2, 4, 6), (2, 3, 4, 6), (8, 2, 5, 3,
                                                             4)])
def test_rung_shard_equal(ladder):
    for hosts in range(1, 9):
        assert t_rung_shard(ladder, hosts) == r_rung_shard(ladder, hosts)
    with pytest.raises(ValueError):
        t_rung_shard(ladder, 0)
    with pytest.raises(ValueError):
        t_rung_shard((), 2)


def test_power_governor_replans_equal():
    """One fixed sequence of grants, observations, cap steps and replans
    through both governors: the same replan log, ceilings and grants."""
    rprof = rcosts.module_cost_profile(rcfg())
    tprof = tcosts.module_cost_profile(tcfg())
    govs = [mod.PowerGovernor(lad(LADDER, d=64.0), prof, 0.25,
                              tick_seconds=0.5, control_interval=3)
            for mod, lad, prof in ((RF, r_build_ladder, rprof),
                                   (TF, t_build_ladder, tprof))]
    seq = [("spend", 2e7), ("take", 1e8), ("observe", 14), ("observe", 0),
           ("replan", 2), ("observe", 9), ("cap", 0.035), ("spend", 1e6),
           ("observe", 40), ("observe", 3), ("observe", 7), ("replan", 9),
           ("cap", 2.0), ("observe", 1), ("observe", 1), ("observe", 1),
           ("replan", 13), ("take", -5.0), ("spend", 1e12)]
    outs = []
    for gov in govs:
        out = []
        for tick, (op, val) in enumerate(seq):
            gov.begin_tick() if op == "observe" else None
            if op == "spend":
                out.append(gov.try_spend(val))
            elif op == "take":
                out.append(gov.take(val))
            elif op == "observe":
                gov.observe(val)
            elif op == "replan":
                out.append(gov.maybe_replan(val))
            else:
                gov.set_cap(val, tick)
            out.append((gov.ceiling_bits, gov.cap_per_tick,
                        gov.spent_this_tick))
        outs.append((out, gov.replans))
    assert outs[1] == outs[0]
    assert outs[0][1] and any(r["moved"] for r in outs[0][1])
    with pytest.raises(ValueError, match="positive"):
        govs[1].set_cap(0.0, 0)


# ---------------------------------------------------------------------------
# the fleet_sim trace in both packages
# ---------------------------------------------------------------------------

def _ref_wave_logits(artifact, wave, rung_of):
    """(n_tokens, rows, V) reference logits of the reference's own tokens
    of one wave, each token at the rung of its segment, teacher-forced at
    the fleet's batch (the wave's rows padded by repeating row 0)."""
    ws = RA.load_artifact(artifact)
    rows = np.stack([np.concatenate([np.asarray(s["prompt"], np.int32),
                                     np.asarray([t for g in s["segments"]
                                                 for t in g["tokens"]],
                                                np.int32)])
                     for s in wave])
    rows = np.concatenate([rows, np.repeat(rows[:1], 2 - len(wave), 0)])
    out = {}
    for bits in sorted(set(rung_of)):
        cfg = dataclasses.replace(rcfg(), kernel_backend="ref",
                                  cache_bits=CACHE_BITS)
        step = jax.jit(lambda p, s, t, cfg=cfg: RMD.decode_step(p, cfg, s,
                                                                 t))
        st = RMD.init_decode_state(ws.views[bits], cfg, 2, MAX_LEN)
        lg = []
        for t in range(rows.shape[1] - 1):
            logits, st = step(ws.views[bits], st,
                              jnp.asarray(rows[:, t:t + 1]))
            lg.append(np.asarray(logits)[:, 0])
        out[bits] = np.stack(lg)[PROMPT - 1:]
    return np.stack([out[b][i] for i, b in enumerate(rung_of)])


def test_fleet_sim_trace_matches_reference(artifact, both):
    rfleet, rrep, tfleet, trep = both
    for key in EXACT_FIELDS + ("requests", "ticks", "decode_gbitflips",
                               "prefill_gbitflips", "rung_token_histogram",
                               "hosts", "per_tick"):
        assert trep[key] == rrep[key], key
    assert trep["served"] == trep["requests"] > 0
    assert trep["cap_violations"] == 0 and trep["host_restarts"] == 1
    assert trep["migrations"] >= 1
    assert trep["governor"] == rrep["governor"]
    assert any(r["moved"] and r["tick"] >= 6
               for r in trep["governor"]["replans"])
    rs = {s["uid"]: s for s in rrep["streams"]}
    ts = {s["uid"]: s for s in trep["streams"]}
    assert rs.keys() == ts.keys()
    for uid in rs:
        assert [(g["rung_bits"], len(g["tokens"])) for g in
                rs[uid]["segments"]] == \
            [(g["rung_bits"], len(g["tokens"])) for g in
             ts[uid]["segments"]], uid
        for key in ("prompt", "wave_uids", "restarts", "switches",
                    "max_new_tokens", "budget_bits"):
            assert ts[uid][key] == rs[uid][key], (uid, key)
    # tokens: equal wave by wave up to the reference's first near-tie
    waves = {}
    for s in rrep["streams"]:
        waves.setdefault(tuple(s["wave_uids"]), []).append(s["uid"])
    for uids in waves.values():
        want = [[t for g in rs[u]["segments"] for t in g["tokens"]]
                for u in uids]
        got = [[t for g in ts[u]["segments"] for t in g["tokens"]]
               for u in uids]
        if got == want:
            continue
        first = min(i for w, g in zip(want, got)
                    for i, (a, b) in enumerate(zip(w, g)) if a != b)
        rung_of = [g["rung_bits"] for g in rs[uids[0]]["segments"]
                   for _ in g["tokens"]]
        logits = _ref_wave_logits(artifact, [rs[u] for u in uids], rung_of)
        bound = REL_BOUND * np.max(np.abs(logits), axis=-1)
        tie = (_margin(logits) <= 2 * bound)[:, :len(uids)].any(axis=1)
        assert tie[:first + 1].any(), (uids, first)
    assert TF.verify_streams(trep, _verify_engine(tfleet)) == []
    tfleet.assert_no_recompile()
    # every host serves the fleet's views of its one store
    ws = tfleet.weight_store
    for host in list(tfleet.decode_hosts.values()) + \
            list(tfleet.prefill_hosts.values()):
        assert host.engine.weight_store is ws.store
        for bits, view in host.engine.variants.items():
            assert view is ws.views[bits]
            assert _aliased(view, ws.store) > 0


def _aliased(view, store) -> int:
    """The view's leaves at a path the store has, each asserted to be the
    store's own tensor (same data_ptr); returns their count."""
    if isinstance(view, torch.Tensor):
        if isinstance(store, torch.Tensor):
            assert view.data_ptr() == store.data_ptr()
            return 1
        return 0
    if isinstance(view, dict) and isinstance(store, dict):
        return sum(_aliased(v, store[k]) for k, v in view.items()
                   if k in store)
    if isinstance(view, (list, tuple)) and isinstance(store, (list, tuple)):
        return sum(_aliased(v, t) for v, t in zip(view, store))
    return 0


class _Counting(TServeEngine):
    """An engine whose every capture site runs the CPU's eager step and
    counts (``test_torch_engine_graphs._fake_graphs``)."""
    patch = None

    def __init__(self, *args, **kwargs):
        super().__init__(*args, **kwargs)
        _fake_graphs(self, self.patch)


def test_fleet_through_fake_graphs_serves_the_same_tokens(artifact, both,
                                                          monkeypatch):
    """The same trace with every host (the reborn one included) on the
    graphed path: each step replays what its engine captured for (rung,
    slot) at warmup, so a lane stepped over another engine's slot or a
    slot never freed would change tokens or raise. Tokens, segments and
    the EXACT fields equal the eager run's, and nothing is captured after
    a host's warmup."""
    _, _, _, trep = both
    monkeypatch.setattr(_Counting, "patch", monkeypatch)
    monkeypatch.setattr(TF, "ServeEngine", _Counting)
    fleet = _port_fleet(artifact)
    report = _run(fleet, _spec(TF))
    for key in EXACT_FIELDS:
        assert report[key] == trep[key], key
    assert report["streams"] == trep["streams"]
    hosts = list(fleet.decode_hosts.values()) + \
        list(fleet.prefill_hosts.values())
    assert all(h.engine.graphed for h in hosts)
    for h in hosts:
        n = len(h.rung_bits) * fleet.fc.max_lanes_per_host
        assert h.engine.graphs_captured == \
            h.engine.compilations_after_warmup == n
        assert not any(s.busy for s in h.engine._slots)
    fleet.assert_no_recompile()
    assert len(report["handoff_ms"]) >= 1 and len(report["restart_s"]) == 1


# ---------------------------------------------------------------------------
# errors
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("bad", [dict(n_decode_hosts=0),
                                 dict(n_prefill_hosts=0),
                                 dict(cache_bits="auto"),
                                 dict(cache_bits=8)])
def test_fleet_config_errors_match_reference(artifact, bad):
    for mod, backend, kw in ((RF, "ref", {}), (TF, "packed",
                                               {"device": "cpu"})):
        cfg = rcfg() if mod is RF else tcfg()
        with pytest.raises(ValueError) as err:
            mod.Fleet(cfg, _fc(mod, backend, **bad), artifact, **kw)
        if mod is RF:
            want = str(err.value)
    assert str(err.value) == want


def test_stall_guard_raises_like_reference(artifact):
    tiny = dict(n_decode_hosts=1, cap_gbitflips_per_s=1e-6,
                drain_tick_factor=2)
    spec = dict(n_ticks=3, host_kills=(), budget_steps=())
    errs = []
    for mod, backend, kw in ((RF, "ref", {}), (TF, "packed",
                                               {"device": "cpu"})):
        fleet = mod.Fleet(rcfg() if mod is RF else tcfg(),
                          _fc(mod, backend, **tiny), artifact, **kw)
        trace = mod.make_trace(_spec(mod, **spec), 512, fleet.ladder)
        with pytest.raises(RuntimeError, match="fleet stalled") as err:
            fleet.run(trace)
        errs.append(str(err.value))
    assert errs[0] == errs[1]


# ---------------------------------------------------------------------------
# the fault classes (tests/test_substrate.py's supervisor case)
# ---------------------------------------------------------------------------

def test_fleet_supervisor_and_host_failure_match_reference():
    counts = []
    for mod in (RFT, TFT):
        built = []
        sup = mod.FleetSupervisor(lambda h: built.append(h) or f"host{h}",
                                  max_restarts_per_host=2)
        got = [sup.absorb(mod.HostFailure(h, "killed at tick 4"))
               for h in (1, 0, 1)]
        with pytest.raises(mod.HostFailure, match="host 1: killed") as err:
            sup.absorb(mod.HostFailure(1, "killed"))
        assert err.value.host_id == 1 and err.value.reason == "killed"
        counts.append((got, built, dict(sup.restarts), sup.total_restarts,
                       str(mod.HostFailure(7))))
    assert counts[1] == counts[0]
    assert issubclass(TFT.HostFailure, RuntimeError)


# ---------------------------------------------------------------------------
# the CLI
# ---------------------------------------------------------------------------

CLI = ["--arch", "llama3-8b", "--reduced", "--fleet_hosts", "2",
       "--batch", "2", "--prompt_len", "4", "--gen", "6", "--ticks", "6"]
CLI_EXACT = ("arch", "mode", "hosts", "cap_gbitflips_per_s", "requests",
             "served", "realized_gbitflips", "realized_gbitflips_per_s",
             "cap_violations", "rung_token_histogram", "governor_replans")


def test_serve_cli_fleet_mode_matches_reference(tmp_path):
    want = rserve.main(CLI + ["--artifact_dir", str(tmp_path / "ref")])
    got = tserve.main(CLI + ["--artifact_dir", str(tmp_path / "port"),
                             "--device", "cpu"])
    assert set(got) == set(want)
    for key in CLI_EXACT:
        assert got[key] == want[key], key
    assert got["served"] == got["requests"] > 0
    assert got["cap_violations"] == 0
    assert got["artifact_dir"] == str(tmp_path / "port")
    with pytest.raises(SystemExit):
        tserve.main(CLI + ["--device", "cpu", "--backend", ""])
