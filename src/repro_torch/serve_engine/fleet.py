"""Multi-host fleet serving under one global power cap (port of
``repro.serve_engine.fleet``; DESIGN.md §12).

``Fleet`` runs ``ServeEngine`` replicas as simulated hosts inside one
process: prefill and decode are disaggregated (a prefill host
teacher-forces prompts and hands each finished lane to a decode host), the
rung views are SHARDED across decode hosts (``dist.sharding.rung_shard``:
each host captures only its rungs' decode graphs), and every host serves
views of ONE device copy of the weight store, mapped once from the
serving artifact (``serve_engine.artifact``): a host reborn after a kill
serves the same tensors the fleet booted with, and so does
``verify_streams``'s engine. That is the one-card counterpart of the
reference's hosts mapping one ``weights.bin``.

The fleet power governor closes the loop: ``EnergyLedger`` bit-flip
telemetry, aggregated across hosts every tick, drives periodic
``planner.replan_for_rate`` replans whose per-MAC budget picks the RUNG
CEILING (the highest rung any request may be served at), and a hard
per-tick flip grant pre-pays every prefill and decode step, so the fleet
stays under the cap by construction. A mid-run cap change re-resolves
queued work and switches in-flight lanes down the ladder by prefix replay
(bit-exact), and a host kill is absorbed by ``dist.fault.FleetSupervisor``:
the host is rebuilt over the shared store and replays its lost lanes,
changing latency and restart energy but never a served token.

Lanes between engines. A lane's decode state lives in a slot of the
engine that built it, and that engine's CUDA graphs were captured on its
own slots. So a decode host ``adopt``s a lane the prefill host built (its
state copied into one of the decode host's free slots, the donor's slot
freed), and every path that detaches a lane (finished, switched, lost
with its host) ``release``s its slot.

Simulated time advances in TICKS (``FleetConfig.tick_seconds`` of virtual
wall time each). Everything the checks read (requests served, realized
fleet bit flips, cap violations) is a deterministic function of the seeded
trace: prices are host floats summed in a fixed order, and greedy decode
always emits a request's full token quota. Wall-clock timings ride along
as informational fields. The traffic generator vendors a SplitMix64
stream, so the trace is identical on every numpy version and in both
packages.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Any, Optional

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.core import costs
from repro_torch.core import planner
from repro_torch.core import power as pw
from repro_torch.dist import fault
from repro_torch.dist.sharding import rung_shard
from repro_torch.kernels import dispatch
from repro_torch.models import model as MD
from repro_torch.models import serving
from repro_torch.serve_engine import artifact as afct
from repro_torch.serve_engine.engine import NO_BACKEND, Lane, ServeEngine
from repro_torch.serve_engine.ladder import build_ladder, select_rung
from repro_torch.serve_engine.scheduler import (Request, Response, Scheduler,
                                                Wave)


# ---------------------------------------------------------------------------
# Deterministic traffic generation
# ---------------------------------------------------------------------------

_MASK64 = (1 << 64) - 1


class SplitMix64:
    """Vendored 64-bit stream: the fleet trace must be bit-identical on
    every numpy version (NEP 19 lets ``np.random.Generator`` streams move
    between releases), so the traffic generator rolls its own."""

    def __init__(self, seed: int):
        self._s = seed & _MASK64

    def next_u64(self) -> int:
        self._s = (self._s + 0x9E3779B97F4A7C15) & _MASK64
        z = self._s
        z = ((z ^ (z >> 30)) * 0xBF58476D1CE4E5B9) & _MASK64
        z = ((z ^ (z >> 27)) * 0x94D049BB133111EB) & _MASK64
        return z ^ (z >> 31)

    def uniform(self) -> float:
        return (self.next_u64() >> 11) * (2.0 ** -53)

    def randint(self, n: int) -> int:
        return self.next_u64() % n

    def choice(self, seq):
        return seq[self.randint(len(seq))]


@dataclasses.dataclass(frozen=True)
class TrafficSpec:
    """Knobs of the synthetic fleet workload.

    Arrivals are bursty: each tick opens a burst with ``burst_prob`` whose
    size is 1 + uniform[0, 2 x mean_burst) — quiet ticks and multi-request
    spikes, not a smooth rate. ``budget_mix`` cycles per-request power
    budgets; ``slo_prob`` requests additionally carry a ``min_score``
    accuracy floor pinned to a rung in ``slo_bits``. ``budget_steps``
    rewrites the GLOBAL cap mid-run ((tick, gbitflips_per_s) pairs);
    ``host_kills`` murders decode hosts ((tick, host_id) pairs)."""
    seed: int = 0
    n_ticks: int = 24
    burst_prob: float = 0.7
    mean_burst: float = 2.0
    prompt_lens: tuple = (8,)
    gen_tokens: tuple = (8, 12)
    budget_mix: tuple = (2, 4, 6, 6)
    slo_prob: float = 0.25
    slo_bits: tuple = (4,)
    budget_steps: tuple = ()
    host_kills: tuple = ()


@dataclasses.dataclass(frozen=True)
class FleetTrace:
    """One materialized workload: everything ``Fleet.run`` consumes."""
    arrivals: tuple            # ((tick, (Request, ...)), ...)
    budget_steps: tuple        # ((tick, gbitflips_per_s), ...)
    host_kills: tuple          # ((tick, host_id), ...)
    n_ticks: int

    @property
    def n_requests(self) -> int:
        return sum(len(reqs) for _, reqs in self.arrivals)


def make_trace(spec: TrafficSpec, vocab_size: int, ladder) -> FleetTrace:
    """Deterministically expand a spec into a trace. ``ladder`` supplies
    the rung scores ``slo_bits`` floors pin to — a floor IS a rung's
    planner score, so 'meets the floor' and 'serves at that rung or
    better' coincide exactly."""
    rng = SplitMix64(spec.seed)
    scores = {op.bits: op.score for op in ladder}
    for b in spec.slo_bits:
        if b not in scores:
            raise ValueError(f"slo_bits {b} not a ladder rung "
                             f"{sorted(scores)}")
    uid = 0
    arrivals = []
    for tick in range(spec.n_ticks):
        if rng.uniform() >= spec.burst_prob:
            continue
        size = 1 + rng.randint(max(int(2 * spec.mean_burst), 1))
        reqs = []
        for _ in range(size):
            n = rng.choice(spec.prompt_lens)
            prompt = np.array([rng.randint(vocab_size) for _ in range(n)],
                              np.int32)
            floor = None
            if rng.uniform() < spec.slo_prob:
                floor = scores[rng.choice(spec.slo_bits)]
            reqs.append(Request(
                uid=uid, prompt=prompt,
                max_new_tokens=rng.choice(spec.gen_tokens),
                power_budget_bits=spec.budget_mix[uid % len(spec.budget_mix)],
                min_score=floor))
            uid += 1
        arrivals.append((tick, tuple(reqs)))
    return FleetTrace(arrivals=tuple(arrivals),
                      budget_steps=tuple(spec.budget_steps),
                      host_kills=tuple(spec.host_kills),
                      n_ticks=spec.n_ticks)


# ---------------------------------------------------------------------------
# The fleet power governor
# ---------------------------------------------------------------------------

class PowerGovernor:
    """Closed loop from aggregated telemetry to per-request rung selection.

    Two actuators, one cap:

      * the per-tick GRANT — ``cap_gbitflips_per_s x tick_seconds`` bit
        flips a tick may spend, debited before any prefill or decode step
        runs (``try_spend``). This is the hard guarantee: a step that does
        not fit stalls to the next tick, so realized flips never exceed
        the cap in any tick.
      * the RUNG CEILING — every ``control_interval`` ticks (and
        immediately on a cap change) the realized fleet token rate from
        ``EnergyLedger`` telemetry feeds ``planner.replan_for_rate``; the
        replan's per-MAC budget picks the highest ladder rung the traffic
        can afford fleet-wide, and ``select_rung(max_bits=ceiling)``
        squeezes every subsequent selection under it. The grant keeps the
        cap; the ceiling keeps the fleet NEAR the cap instead of stalling.
    """

    def __init__(self, ladder, profile, cap_gbitflips_per_s: float,
                 tick_seconds: float = 1.0, control_interval: int = 4):
        self.ladder = tuple(sorted(ladder, key=lambda op: op.power))
        self.profile = [m for m in profile if m.macs > 0]
        self.tick_seconds = float(tick_seconds)
        self.control_interval = int(control_interval)
        self.ceiling_bits = self.ladder[-1].bits
        self.replans: list[dict] = []
        self._spent_this_tick = 0.0
        self._window_tokens = 0
        self._window_ticks = 0
        self.set_cap(cap_gbitflips_per_s, tick=0, replan=False)

    # -- the hard per-tick grant -------------------------------------------

    @property
    def cap_per_tick(self) -> float:
        return self.cap_gbitflips_per_s * 1e9 * self.tick_seconds

    def begin_tick(self) -> None:
        self._spent_this_tick = 0.0

    def try_spend(self, flips: float) -> bool:
        """Debit ``flips`` from this tick's grant; False = stall (the
        caller must not run the step)."""
        if self._spent_this_tick + flips > self.cap_per_tick:
            return False
        self._spent_this_tick += flips
        return True

    def take(self, flips: float) -> float:
        """Debit up to ``flips`` from what remains of this tick's grant
        and return the amount actually taken. Lets a single action whose
        price exceeds one tick's whole grant (a long replay under a tight
        cap) save up across ticks — each tick still spends at most its
        grant, and the action runs only once fully paid."""
        got = min(max(flips, 0.0), self.cap_per_tick - self._spent_this_tick)
        got = max(got, 0.0)
        self._spent_this_tick += got
        return got

    @property
    def spent_this_tick(self) -> float:
        return self._spent_this_tick

    # -- the telemetry-driven ceiling --------------------------------------

    def set_cap(self, gbitflips_per_s: float, tick: int,
                replan: bool = True) -> None:
        if gbitflips_per_s <= 0:
            raise ValueError(f"cap must be positive: {gbitflips_per_s}")
        self.cap_gbitflips_per_s = float(gbitflips_per_s)
        if replan:
            self.replan(tick, reason="cap_step")

    def observe(self, tokens: int) -> None:
        """Record one tick's realized decode tokens (from the aggregated
        ledgers) into the replan window."""
        self._window_tokens += int(tokens)
        self._window_ticks += 1

    def maybe_replan(self, tick: int) -> bool:
        if self._window_ticks < self.control_interval:
            return False
        return self.replan(tick, reason="periodic")

    def replan(self, tick: int, reason: str) -> bool:
        """allocate_layerwise on the budget the measured rate leaves under
        the cap; returns True when the ceiling moved."""
        ticks = max(self._window_ticks, 1)
        rate = self._window_tokens / (ticks * self.tick_seconds)
        if rate <= 0:
            # no traffic observed yet: assume one wave-step per tick at the
            # top rung would be served, i.e. stay permissive until data
            rate = 1.0 / self.tick_seconds
        plan = planner.replan_for_rate(self.cap_gbitflips_per_s * 1e9,
                                       rate, self.profile)
        fits = [op.bits for op in self.ladder
                if op.power <= plan.power_budget * (1 + 1e-9)]
        new_ceiling = fits[-1] if fits else self.ladder[0].bits
        moved = new_ceiling != self.ceiling_bits
        self.replans.append({
            "tick": int(tick), "reason": reason,
            "tokens_per_s": rate,
            "per_mac_budget": plan.power_budget,
            "plan_gbitflips_per_token": pw.giga(plan.total_power),
            "ceiling_bits": int(new_ceiling),
            "moved": bool(moved),
        })
        self.ceiling_bits = new_ceiling
        self._window_tokens = 0
        self._window_ticks = 0
        return moved


# ---------------------------------------------------------------------------
# Hosts and per-request bookkeeping
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class FleetHost:
    """One simulated host: an engine plus its live lanes and telemetry."""
    host_id: int
    role: str                      # "prefill" | "decode"
    engine: ServeEngine
    rung_bits: tuple
    max_lanes: int
    lanes: list = dataclasses.field(default_factory=list)
    monitor: fault.StepMonitor = dataclasses.field(
        default_factory=fault.StepMonitor)

    def free_slots(self) -> int:
        return self.max_lanes - len(self.lanes)


@dataclasses.dataclass
class _StreamRec:
    """Fleet-side record of one request across hosts, rungs and restarts.
    ``tokens`` is lane-aligned (uncapped at max_new_tokens — a row rides
    its wave to the wave's gen_max); the response truncates, the replay
    and verification paths use the full row."""
    req: Request
    arrival: int
    rung_bits: int
    slo_violated: bool
    tokens: list = dataclasses.field(default_factory=list)
    segments: list = dataclasses.field(default_factory=list)
    decode_ledgers: list = dataclasses.field(default_factory=list)
    prefill_ledgers: list = dataclasses.field(default_factory=list)
    first_token_tick: Optional[int] = None
    done_tick: Optional[int] = None
    restarts: int = 0
    switches: int = 0
    wave_uids: tuple = ()          # uids sharing this stream's wave/lane

    def close_segment(self, new_tokens: list) -> None:
        self.tokens.extend(new_tokens)
        if self.segments and self.segments[-1]["rung_bits"] == \
                self.rung_bits:
            self.segments[-1]["tokens"].extend(new_tokens)
        else:
            self.segments.append({"rung_bits": self.rung_bits,
                                  "tokens": list(new_tokens)})


@dataclasses.dataclass
class _Replay:
    """Work waiting for budget and a slot: a detached lane to be
    teacher-forced back into a (possibly different) host at a (possibly
    different) rung, or a fresh wave whose prefill did not fit this
    tick's grant. ``paid`` accumulates grant credit across ticks so an
    action pricier than one whole tick's grant still makes progress —
    it executes once fully paid, and no tick ever overspends."""
    wave: Wave
    prefix_rows: Optional[np.ndarray]   # None for a fresh prefill
    pinned_host: Optional[int]          # restarts resume on the reborn host
    reason: str                         # "restart" | "switch" | "prefill"
    paid: float = 0.0


# ---------------------------------------------------------------------------
# The fleet
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class FleetConfig:
    """Shape of the simulated fleet. ``backend`` None is the reference's
    float path, which the port refuses (ROADMAP C6): name a kernel
    backend."""
    n_decode_hosts: int = 4
    n_prefill_hosts: int = 1
    ladder_bits: tuple = (2, 4, 6)
    allocation: str = "uniform"
    cap_gbitflips_per_s: float = 2.0
    tick_seconds: float = 1.0
    control_interval: int = 4
    steps_per_tick: int = 4        # decode steps per lane per tick
    prefills_per_tick: int = 1     # waves one prefill host starts per tick
    max_lanes_per_host: int = 2
    max_batch: int = 2
    max_len: int = 48
    rung_sharding: bool = True
    backend: Optional[str] = None
    cache_bits: Optional[int] = None
    max_restarts_per_host: int = 3
    drain_tick_factor: int = 10    # stall guard: max ticks / trace ticks


class Fleet:
    """A mesh of ServeEngine hosts under one power governor.

    Build once from a model config + params (the weight store is written
    to ``artifact_dir`` as the v1 serving artifact) or point
    ``artifact_dir`` at an existing artifact (``params=None``). The fleet
    maps the artifact once onto ``device`` (``artifact.load_artifact``)
    and every host, reborn ones included, serves views of that one store.
    """

    def __init__(self, cfg: ModelConfig, fleet_cfg: FleetConfig,
                 artifact_dir: str, params: Any = None,
                 mse_dim: Optional[float] = None, device="cuda"):
        fc = fleet_cfg
        if fc.n_decode_hosts < 1 or fc.n_prefill_hosts < 1:
            raise ValueError("need >= 1 prefill and >= 1 decode host")
        if fc.cache_bits is not None:
            # "auto" is engine-level; fleet pricing needs one fixed width
            if not isinstance(fc.cache_bits, int) \
                    or not 2 <= fc.cache_bits <= 7:
                raise ValueError(f"fleet cache_bits must be None or an int "
                                 f"in [2, 7]: {fc.cache_bits!r}")
        if fc.backend is None:
            raise ValueError(NO_BACKEND)
        self.cfg = cfg
        self.fc = fc
        self.device = MD.resolve_device(device)
        self.artifact_dir = artifact_dir
        self._mse_dim = float(mse_dim or cfg.d_model)
        self.profile = costs.module_cost_profile(cfg)
        alloc_profile = self.profile
        self.ladder = build_ladder(fc.ladder_bits, d=self._mse_dim,
                                   allocation=fc.allocation,
                                   profile=alloc_profile)
        if params is not None:
            # quantize ONCE and persist as the artifact the fleet maps
            specs = {op.bits: (op.tree if op.tree is not None
                               else (op.r, op.b_x_tilde))
                     for op in self.ladder}
            cb = ({op.bits: fc.cache_bits for op in self.ladder}
                  if fc.cache_bits is not None else None)
            qspec = serving.ServingQuantSpec(
                pack_planes=dispatch.parse_backend(fc.backend) == "packed",
                cache_bits=cb)
            ws = serving.build_weight_store(params, cfg, specs, spec=qspec)
            afct.write_artifact(artifact_dir, ws, cfg,
                                meta={"fleet_ladder": list(fc.ladder_bits)})
            del ws
        # ONE device copy of the store: every host's engine takes views of
        # it, no host copies a leaf
        self.weight_store = afct.load_artifact(artifact_dir, self.device)
        self.handoff_s: list[float] = []
        self.restart_s: list[float] = []

        shards = (rung_shard(fc.ladder_bits, fc.n_decode_hosts)
                  if fc.rung_sharding else
                  {h: tuple(sorted(fc.ladder_bits))
                   for h in range(fc.n_decode_hosts)})
        self.decode_hosts: dict[int, FleetHost] = {
            h: self._build_host(h, "decode", shards[h])
            for h in range(fc.n_decode_hosts)}
        self.prefill_hosts: dict[int, FleetHost] = {
            h: self._build_host(h, "prefill",
                                tuple(sorted(fc.ladder_bits)))
            for h in range(fc.n_prefill_hosts)}
        # ONE pricing authority: the first prefill host's full-ladder
        # engine prices every ledger, so fleet accounting cannot drift
        # between hosts serving different shards
        self._pricer = self.prefill_hosts[0].engine
        self.governor = PowerGovernor(
            self.ladder, self.profile, fc.cap_gbitflips_per_s,
            tick_seconds=fc.tick_seconds,
            control_interval=fc.control_interval)
        self.supervisor = fault.FleetSupervisor(
            self._restart_host,
            max_restarts_per_host=fc.max_restarts_per_host)
        self.scheduler = Scheduler(self.ladder, fc.max_batch)
        self.streams: dict[int, _StreamRec] = {}
        self._replays: list[_Replay] = []
        self._deferred: list[_Replay] = []
        self._pending_responses: list[Response] = []
        self.migrations = 0

    # -- host lifecycle -----------------------------------------------------

    def _build_host(self, host_id: int, role: str,
                    rung_bits: tuple) -> FleetHost:
        eng = ServeEngine(self.cfg, weight_store=self.weight_store,
                          ladder_bits=rung_bits,
                          max_batch=self.fc.max_batch,
                          max_len=self.fc.max_len,
                          mse_dim=self._mse_dim,
                          allocation=self.fc.allocation,
                          backend=self.fc.backend,
                          cache_bits=self.fc.cache_bits,
                          slots=self.fc.max_lanes_per_host,
                          device=self.device)
        eng.warmup()
        return FleetHost(host_id=host_id, role=role, engine=eng,
                         rung_bits=rung_bits,
                         max_lanes=self.fc.max_lanes_per_host)

    def _restart_host(self, host_id: int) -> FleetHost:
        """dist.fault restart path: the reborn host serves views of the
        SAME device store (no re-quantization, no copy) and captures its
        decode graphs anew; ``restart_s`` times the rebuild."""
        dead = self.decode_hosts[host_id]
        t0 = time.monotonic()
        host = self._build_host(host_id, "decode", dead.rung_bits)
        self._sync()
        self.restart_s.append(time.monotonic() - t0)
        return host

    def _sync(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def _alive_decode_hosts(self) -> list[FleetHost]:
        return [self.decode_hosts[h] for h in sorted(self.decode_hosts)]

    def _slot_for(self, bits: int,
                  pinned: Optional[int] = None) -> Optional[FleetHost]:
        """Deterministic placement: the pinned host if it can take the
        lane, else the least-loaded (lowest id) live host serving ``bits``
        with a free slot."""
        if pinned is not None:
            host = self.decode_hosts[pinned]
            if bits in host.rung_bits and host.free_slots() > 0:
                return host
        cands = [h for h in self._alive_decode_hosts()
                 if bits in h.rung_bits and h.free_slots() > 0]
        if not cands:
            return None
        return min(cands, key=lambda h: (len(h.lanes), h.host_id))

    # -- request admission --------------------------------------------------

    def _resolve(self, req: Request) -> tuple:
        """(rung, slo_violated) under the governor ceiling. The cap wins
        conflicts: a floor that needs a rung above the ceiling (or above
        the request's own budget) is served at the best rung the ceiling
        allows and COUNTED as an SLO violation — never silently dropped,
        never a cap breach."""
        ceiling = self.governor.ceiling_bits
        try:
            rung = select_rung(self.ladder, req.power_budget_bits,
                               req.min_score, max_bits=ceiling)
        except ValueError:
            rung = select_rung(self.ladder, req.power_budget_bits,
                               max_bits=ceiling)
        violated = (req.min_score is not None
                    and rung.score < req.min_score)
        return rung, violated

    def _admit(self, req: Request, tick: int) -> None:
        rung, violated = self._resolve(req)
        self.streams[req.uid] = _StreamRec(
            req=req, arrival=tick, rung_bits=rung.bits,
            slo_violated=violated)
        self.scheduler.submit(req, rung=rung)

    def _requeue_for_ceiling(self, tick: int) -> None:
        """Ceiling moved: re-resolve every piece of work that has not
        finished — queued requests, deferred waves, queued replays, and
        in-flight lanes above the ceiling (those close their segment and
        queue a bit-exact prefix replay at the new rung on whichever host
        takes it)."""
        queued = self.scheduler.drain() + \
            [req for ent in self._deferred for req in ent.wave.requests]
        self._deferred.clear()   # partial credit on deferred waves is burned
        for req in queued:
            rec = self.streams[req.uid]
            rung, violated = self._resolve(req)
            rec.rung_bits = rung.bits
            rec.slo_violated = rec.slo_violated or violated
            self.scheduler.submit(req, rung=rung)
        ceiling = self.governor.ceiling_bits
        new_rung = select_rung(self.ladder, max_bits=ceiling)
        for i, rp in enumerate(self._replays):
            if rp.wave.rung.bits > ceiling:
                for req in rp.wave.requests:
                    rec = self.streams[req.uid]
                    rec.switches += 1
                    rec.rung_bits = new_rung.bits
                self._replays[i] = dataclasses.replace(
                    rp, wave=Wave(rung=new_rung,
                                  requests=rp.wave.requests))
        for host in self._alive_decode_hosts():
            for lane in list(host.lanes):
                if lane.wave.rung.bits <= ceiling:
                    continue
                host.lanes.remove(lane)
                if lane.steps_left <= 0:
                    # already fully generated — nothing left to serve at
                    # the new rung; finalize instead of replaying
                    self._detach_lane_finished(lane, tick, host.engine)
                    self._pending_responses.extend(
                        self._responses_for(lane))
                    continue
                prefix = self._detach_lane(lane, host.engine,
                                           switch_to=new_rung.bits)
                self._replays.append(_Replay(
                    wave=Wave(rung=new_rung, requests=lane.wave.requests),
                    prefix_rows=prefix, pinned_host=None, reason="switch"))
                self.migrations += 1

    def _detach_lane(self, lane: Lane, engine: ServeEngine,
                     switch_to: Optional[int] = None) -> np.ndarray:
        """Fold a detached lane's tokens into its streams, free its slot
        on ``engine``, and return the replay prefix rows (prompt + every
        token grown so far)."""
        gen = lane.generated_rows()
        engine.release(lane)
        for i, req in enumerate(lane.wave.requests):
            rec = self.streams[req.uid]
            rec.close_segment(gen[i].tolist())
            if switch_to is not None:
                rec.switches += 1
                rec.rung_bits = switch_to
            else:
                rec.restarts += 1
        prompts = np.stack([r.prompt for r in lane.wave.requests])
        rows = [np.concatenate([prompts[i].astype(np.int32),
                                np.asarray(self.streams[r.uid].tokens,
                                           np.int32)])
                for i, r in enumerate(lane.wave.requests)]
        return np.stack(rows)

    def _kill_host(self, host_id: int, tick: int) -> None:
        if host_id not in self.decode_hosts:
            raise ValueError(f"host_kills names unknown decode host "
                             f"{host_id}")
        host = self.decode_hosts[host_id]
        dead = host.engine
        lost = list(host.lanes)
        host.lanes.clear()
        reborn = self.supervisor.absorb(
            fault.HostFailure(host_id, f"killed at tick {tick}"))
        self.decode_hosts[host_id] = reborn
        for lane in lost:
            if lane.steps_left <= 0:
                # the lane finished before the kill; its tokens were
                # already produced (streamed) — finalize, don't replay
                self._detach_lane_finished(lane, tick, dead)
                self._pending_responses.extend(self._responses_for(lane))
                continue
            prefix = self._detach_lane(lane, dead)
            self._replays.append(_Replay(
                wave=lane.wave, prefix_rows=prefix,
                pinned_host=host_id, reason="restart"))

    # -- pricing ------------------------------------------------------------

    def _stream_ctx(self, req: Request) -> int:
        return req.prompt_len + req.max_new_tokens

    def _wave_step_flips(self, wave: Wave, gen_counts) -> float:
        """One decode step's price: one token per request still inside its
        own quota, at the wave's rung. Fixed summation order (request
        order in the wave) keeps the float total deterministic."""
        bits = wave.rung.bits
        total = 0.0
        for req, done in zip(wave.requests, gen_counts):
            if done < req.max_new_tokens:
                total += self._pricer.token_flips(bits,
                                                  self._stream_ctx(req))
        return total

    def _prefix_flips(self, wave: Wave, n_prefix: int) -> float:
        bits = wave.rung.bits
        return sum(self._pricer.token_flips(bits, self._stream_ctx(req))
                   * n_prefix for req in wave.requests)

    def _charge_prefill(self, wave: Wave, n_prefix: int) -> None:
        for req in wave.requests:
            led = self._pricer.ledger_for(self.ladder_rung(wave.rung.bits),
                                          self._stream_ctx(req))
            led.charge(n_prefix)
            self.streams[req.uid].prefill_ledgers.append(led)

    def ladder_rung(self, bits: int):
        for op in self.ladder:
            if op.bits == bits:
                return op
        raise KeyError(bits)

    # -- lane servicing -----------------------------------------------------

    def _start_lane(self, host: FleetHost, wave: Wave, lane: Lane,
                    tick: int) -> None:
        """The lane joins ``host``: a lane another host's engine built is
        adopted into one of ``host``'s slots first (the disaggregation
        handoff; ``handoff_s`` times the copy)."""
        if not host.engine._owns(lane.slot):
            self._sync()
            t0 = time.monotonic()
            host.engine.adopt(lane)
            self._sync()
            self.handoff_s.append(time.monotonic() - t0)
        host.lanes.append(lane)
        uids = tuple(r.uid for r in wave.requests)
        for req in wave.requests:
            rec = self.streams[req.uid]
            rec.wave_uids = uids
            if rec.first_token_tick is None:
                rec.first_token_tick = tick
            led = self._pricer.ledger_for(self.ladder_rung(wave.rung.bits),
                                          self._stream_ctx(req))
            rec.decode_ledgers.append(led)
            # the lane is born with its first generated token on board
            if len(rec.tokens) < req.max_new_tokens:
                led.charge(1)

    def _replay_cost(self, rp: _Replay) -> float:
        """Full price of executing a pending entry: the teacher-forced
        prefix plus the one new token the (re)built lane is born with."""
        if rp.prefix_rows is not None:
            n_prefix = rp.prefix_rows.shape[1]
            gen = [len(self.streams[r.uid].tokens)
                   for r in rp.wave.requests]
        else:
            n_prefix = rp.wave.requests[0].prompt_len
            gen = [0] * len(rp.wave.requests)
        return self._prefix_flips(rp.wave, n_prefix) + \
            self._wave_step_flips(rp.wave, gen)

    def _pay(self, rp: _Replay) -> bool:
        """Pay down a pending entry from this tick's grant; True when it
        is fully paid and may execute."""
        cost = self._replay_cost(rp)
        need = cost - rp.paid
        if need > 0:
            rp.paid += self.governor.take(need)
        return rp.paid >= cost - 1e-6

    def _service_replays(self, tick: int) -> None:
        kept = []
        for rp in self._replays:
            host = self._slot_for(rp.wave.rung.bits, rp.pinned_host)
            if host is None or not self._pay(rp):
                kept.append(rp)
                continue
            n_prefix = rp.prefix_rows.shape[1]
            t0 = time.monotonic()
            lane = host.engine.prefill_wave(rp.wave,
                                            prefix_rows=rp.prefix_rows)
            host.monitor.record(tick, time.monotonic() - t0)
            self._charge_prefill(rp.wave, n_prefix)
            self._start_lane(host, rp.wave, lane, tick)
        self._replays = kept

    def _service_prefill(self, tick: int) -> None:
        """Start new lanes, up to the fleet's prefill capacity this tick.
        A wave whose prefill does not fit what remains of the grant parks
        in the deferred queue with its partial credit and executes once
        fully paid (FIFO — later arrivals don't overtake it)."""
        capacity = len(self.prefill_hosts) * self.fc.prefills_per_tick
        ph_ids = sorted(self.prefill_hosts)
        started = 0
        while started < capacity:
            if self._deferred:
                ent = self._deferred[0]
                if self._slot_for(ent.wave.rung.bits) is None:
                    break
                if not self._pay(ent):
                    break
                self._deferred.pop(0)
            else:
                eligible = {op.bits for op in self.ladder
                            if self._slot_for(op.bits) is not None}
                wave = self.scheduler.next_wave(eligible)
                if wave is None:
                    break
                ent = _Replay(wave=wave, prefix_rows=None,
                              pinned_host=None, reason="prefill")
                if not self._pay(ent):
                    self._deferred.append(ent)
                    break
            host = self._slot_for(ent.wave.rung.bits)
            ph = self.prefill_hosts[ph_ids[started % len(ph_ids)]]
            t0 = time.monotonic()
            lane = ph.engine.prefill_wave(ent.wave)
            ph.monitor.record(tick, time.monotonic() - t0)
            # disaggregation handoff: the lane's state moves into a slot
            # of the decode host (_start_lane); both engines serve views
            # of one store, so the continuation is the same function
            # either side computes
            self._charge_prefill(ent.wave, ent.wave.requests[0].prompt_len)
            self._start_lane(host, ent.wave, lane, tick)
            started += 1

    def _service_decode(self, tick: int) -> tuple[int, list[Response]]:
        tokens = 0
        finished: list[Response] = []
        for _ in range(self.fc.steps_per_tick):
            for host in self._alive_decode_hosts():
                for lane in list(host.lanes):
                    if lane.steps_left <= 0:
                        done = True
                    else:
                        gen_counts = [len(self.streams[r.uid].tokens)
                                      + len(lane.generated)
                                      for r in lane.wave.requests]
                        cost = self._wave_step_flips(lane.wave, gen_counts)
                        if not self.governor.try_spend(cost):
                            continue          # stall: grant exhausted
                        t0 = time.monotonic()
                        done = host.engine.step_lane(lane)
                        host.monitor.record(tick,
                                            time.monotonic() - t0)
                        for req, n in zip(lane.wave.requests, gen_counts):
                            if n < req.max_new_tokens:
                                rec = self.streams[req.uid]
                                rec.decode_ledgers[-1].charge(1)
                                tokens += 1
                    if done:
                        host.lanes.remove(lane)
                        self._detach_lane_finished(lane, tick, host.engine)
                        finished.extend(self._responses_for(lane))
        return tokens, finished

    def _detach_lane_finished(self, lane: Lane, tick: int,
                              engine: ServeEngine) -> None:
        gen = lane.generated_rows()
        engine.release(lane)
        for i, req in enumerate(lane.wave.requests):
            rec = self.streams[req.uid]
            rec.close_segment(gen[i].tolist())
            rec.done_tick = tick

    def _responses_for(self, lane: Lane) -> list[Response]:
        out = []
        for req in lane.wave.requests:
            rec = self.streams[req.uid]
            agg = pw.aggregate_ledgers(rec.decode_ledgers)
            meta = {
                "rung_bits": rec.rung_bits,
                "segments": [{"rung_bits": s["rung_bits"],
                              "tokens": len(s["tokens"])}
                             for s in rec.segments],
                "arrival_tick": rec.arrival,
                "done_tick": rec.done_tick,
                "first_token_tick": rec.first_token_tick,
                "restarts": rec.restarts,
                "switches": rec.switches,
                "slo_violated": rec.slo_violated,
                "est_bitflips_total": agg["bitflips_total"],
                "tokens": agg["tokens"],
            }
            out.append(Response(
                uid=req.uid,
                tokens=rec.tokens[:req.max_new_tokens],
                rung_bits=rec.rung_bits, metadata=meta))
        return out

    # -- the tick loop ------------------------------------------------------

    def _work_pending(self) -> bool:
        return bool(self.scheduler.pending() or self._deferred
                    or self._replays or self._pending_responses
                    or any(h.lanes for h in self._alive_decode_hosts()))

    def run(self, trace: FleetTrace) -> dict:
        """Serve the whole trace; returns the fleet report. Deterministic
        up to the wall-clock fields (``wall_s``, ``handoff_ms``,
        ``restart_s``, the monitors'), which are informational."""
        t_wall = time.monotonic()
        arrivals = dict(trace.arrivals)
        kills: dict[int, list[int]] = {}
        for t, h in trace.host_kills:
            kills.setdefault(int(t), []).append(int(h))
        steps = {int(t): float(g) for t, g in trace.budget_steps}
        responses: list[Response] = []
        per_tick: list[dict] = []
        max_ticks = max(trace.n_ticks, 1) * self.fc.drain_tick_factor
        tick = 0
        while tick < trace.n_ticks or self._work_pending():
            if tick >= max_ticks:
                raise RuntimeError(
                    f"fleet stalled: work still pending after {tick} "
                    f"ticks (cap too small for the trace? "
                    f"{len(responses)} / {len(self.streams)} streams "
                    f"done)")
            self.governor.begin_tick()
            if tick in steps:
                self.governor.set_cap(steps[tick], tick)
                self._requeue_for_ceiling(tick)
            for h in kills.get(tick, ()):
                self._kill_host(h, tick)
            for req in arrivals.get(tick, ()):
                self._admit(req, tick)
            self._service_replays(tick)
            self._service_prefill(tick)
            tokens, done = self._service_decode(tick)
            responses.extend(self._pending_responses)
            self._pending_responses.clear()
            responses.extend(done)
            self.governor.observe(tokens)
            per_tick.append({
                "tick": tick,
                "flips": self.governor.spent_this_tick,
                "cap": self.governor.cap_per_tick,
                "tokens": tokens,
                "ceiling_bits": self.governor.ceiling_bits,
            })
            if self.governor.maybe_replan(tick):
                self._requeue_for_ceiling(tick)
            tick += 1
        return self._report(trace, responses, per_tick,
                            time.monotonic() - t_wall)

    # -- reporting ----------------------------------------------------------

    def assert_no_recompile(self) -> None:
        """No host (reborn ones included) captured a decode graph after its
        warmup, across governor replans, rung switches, handoffs and
        replays."""
        for host in (list(self.prefill_hosts.values())
                     + list(self.decode_hosts.values())):
            host.engine.assert_no_recompile()

    def _report(self, trace, responses, per_tick, wall_s) -> dict:
        responses = sorted(responses, key=lambda r: r.uid)
        recs = [self.streams[uid] for uid in sorted(self.streams)]
        decode_agg = pw.aggregate_ledgers(
            led for rec in recs for led in rec.decode_ledgers)
        prefill_agg = pw.aggregate_ledgers(
            led for rec in recs for led in rec.prefill_ledgers)
        realized = decode_agg["bitflips_total"] + \
            prefill_agg["bitflips_total"]
        violations = sum(1 for t in per_tick if t["flips"] > t["cap"])
        hist: dict[int, int] = {}
        for rec in recs:
            for seg in rec.segments:
                hist[seg["rung_bits"]] = hist.get(seg["rung_bits"], 0) \
                    + len(seg["tokens"])
        lat = sorted((rec.done_tick - rec.arrival) for rec in recs
                     if rec.done_tick is not None)
        ttft = sorted((rec.first_token_tick - rec.arrival) for rec in recs
                      if rec.first_token_tick is not None)

        def p50(xs):
            return xs[len(xs) // 2] if xs else None

        sim_seconds = len(per_tick) * self.fc.tick_seconds
        return {
            "hosts": {
                "decode": len(self.decode_hosts),
                "prefill": len(self.prefill_hosts),
                "rung_shards": {h: list(self.decode_hosts[h].rung_bits)
                                for h in sorted(self.decode_hosts)},
            },
            "requests": trace.n_requests,
            "served": len(responses),
            "ticks": len(per_tick),
            "sim_seconds": sim_seconds,
            # the EXACT-gated telemetry numbers (benchmarks/fleet_sim.py)
            "realized_bitflips": realized,
            "realized_gbitflips": pw.giga(realized),
            "decode_gbitflips": decode_agg["gbitflips_total"],
            "prefill_gbitflips": prefill_agg["gbitflips_total"],
            "decode_tokens": decode_agg["tokens"],
            "cap_violations": violations,
            "realized_gbitflips_per_s": pw.giga(realized)
            / max(sim_seconds, 1e-9),
            "tokens_per_sim_s": decode_agg["tokens"]
            / max(sim_seconds, 1e-9),
            "rung_token_histogram": {str(k): hist[k]
                                     for k in sorted(hist)},
            "slo_violations": sum(1 for rec in recs if rec.slo_violated),
            "host_restarts": self.supervisor.total_restarts,
            "migrations": self.migrations,
            "governor": {
                "cap_gbitflips_per_s": self.governor.cap_gbitflips_per_s,
                "ceiling_bits": self.governor.ceiling_bits,
                "replans": self.governor.replans,
            },
            "per_tick": per_tick,
            "straggler_steps": sum(
                h.monitor.stragglers
                for h in (list(self.prefill_hosts.values())
                          + list(self.decode_hosts.values()))),
            # informational (wall clock — NOT gated)
            "wall_s": round(wall_s, 3),
            "handoff_ms": [round(s * 1e3, 3) for s in self.handoff_s],
            "restart_s": [round(s, 3) for s in self.restart_s],
            "latency_ticks_p50": p50(lat),
            "ttft_ticks_p50": p50(ttft),
            "streams": [{
                "uid": rec.req.uid,
                "prompt": rec.req.prompt.tolist(),
                "max_new_tokens": rec.req.max_new_tokens,
                "budget_bits": rec.req.power_budget_bits,
                "wave_uids": list(rec.wave_uids),
                "segments": rec.segments,
                "restarts": rec.restarts,
                "switches": rec.switches,
            } for rec in recs],
        }


def verify_streams(report: dict, engine: ServeEngine,
                   only_disrupted: bool = False) -> list[str]:
    """Replay every served WAVE through ONE uninterrupted reference engine
    and compare tokens segment by segment — the fleet-scope bit-exactness
    oracle. A wave that crossed the prefill/decode handoff, a host restart,
    a governor rung switch and any number of hosts must equal a single
    engine serving the same (requests, rung schedule) start to finish.

    Replays are wave-granular, not stream-granular, because activation
    quantization scales are computed over the whole batch: a row's logits
    depend on its batchmates, so only a replay with the SAME batch
    composition (which is exactly what fleet restarts and switches
    preserve) is bit-comparable. The engine frees each segment's slot
    when the segment is read, so one slot suffices. Returns human-readable
    mismatches (empty = all verified)."""
    failures = []
    waves: dict[tuple, dict] = {}
    for s in report["streams"]:
        waves.setdefault(tuple(s["wave_uids"]), {})[s["uid"]] = s
    by_bits = {op.bits: op for op in engine.ladder}
    for uids in sorted(waves):
        if not uids:
            continue               # stream never reached a lane
        ss = [waves[uids][u] for u in uids]
        if only_disrupted and not any(s["restarts"] or s["switches"]
                                      for s in ss):
            continue
        # rows of one wave step together, so their segment structures are
        # identical; total is the lane-aligned (uncapped) token count
        segs = ss[0]["segments"]
        total = sum(len(seg["tokens"]) for seg in segs)
        if total == 0:
            continue
        reqs = tuple(Request(uid=s["uid"],
                             prompt=np.asarray(s["prompt"], np.int32),
                             max_new_tokens=total) for s in ss)
        prompts = np.stack([np.asarray(s["prompt"], np.int32) for s in ss])
        grown = np.zeros((len(ss), 0), np.int32)
        for k, seg in enumerate(segs):
            n = len(seg["tokens"])
            if n == 0:
                continue
            wave = Wave(rung=by_bits[seg["rung_bits"]], requests=reqs)
            if grown.shape[1] == 0:
                lane = engine.prefill_wave(wave)
            else:
                lane = engine.prefill_wave(
                    wave, prefix_rows=np.concatenate([prompts, grown],
                                                     axis=1))
            for _ in range(n - 1):
                engine.step_lane(lane)
            rows = lane.generated_rows()[:, :n]
            engine.release(lane)
            for i, s in enumerate(ss):
                want = s["segments"][k]["tokens"]
                got = rows[i].tolist()
                if got != want:
                    failures.append(
                        f"stream {s['uid']} segment {k} "
                        f"({seg['rung_bits']}b x {n}): fleet tokens != "
                        f"uninterrupted replay; fleet {want[:8]} "
                        f"ref {got[:8]}")
            grown = np.concatenate([grown, rows], axis=1)
    return failures
