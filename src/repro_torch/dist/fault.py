"""Fault tolerance (port of ``repro.dist.fault``): straggler telemetry,
checkpoint/restart supervision, and host-level supervision of the
serving fleet.

``StepMonitor`` keeps a running baseline of healthy step times and flags
any step slower than ``threshold`` x the baseline. ``Supervisor`` wraps a
step loop with periodic checkpointing and restart from the newest
checkpoint (``ckpt.checkpoint.latest_step``) on a crash.

``HostFailure`` / ``FleetSupervisor`` are the serving fleet's analogues at
host granularity (``serve_engine.fleet``): a host dying mid-decode raises
``HostFailure``; the supervisor absorbs it by rebuilding that one host
(over the fleet's one device copy of the weight store) while the rest of
the fleet keeps serving. The dead host's lanes resume by prefix replay,
which is bit-exact by the same argument as a mid-stream rung switch, so a
kill costs latency and restart energy but never changes a served token.
"""
from __future__ import annotations

import time
from typing import Any, Callable, Optional


class HostFailure(RuntimeError):
    """One fleet host died (a simulated kill or a real crash mid-step)."""

    def __init__(self, host_id: int, reason: str = "killed"):
        super().__init__(f"host {host_id}: {reason}")
        self.host_id = int(host_id)
        self.reason = reason


class FleetSupervisor:
    """Restart failed hosts against the fleet's shared weight store.

    ``restart_fn(host_id)`` returns the replacement host; ``absorb``
    enforces a per-host restart budget (a host that keeps dying is an
    outage, not a blip: it re-raises rather than flap forever). The fleet
    calls ``absorb`` from its tick loop, so the restart count is a
    deterministic function of the kill schedule."""

    def __init__(self, restart_fn: Callable[[int], Any],
                 max_restarts_per_host: int = 3):
        self.restart_fn = restart_fn
        self.max_restarts_per_host = int(max_restarts_per_host)
        self.restarts: dict[int, int] = {}

    @property
    def total_restarts(self) -> int:
        return sum(self.restarts.values())

    def absorb(self, failure: HostFailure) -> Any:
        """Handle one host failure: count it and rebuild the host."""
        n = self.restarts.get(failure.host_id, 0) + 1
        if n > self.max_restarts_per_host:
            raise failure
        self.restarts[failure.host_id] = n
        return self.restart_fn(failure.host_id)


class StepMonitor:
    """Flags straggler steps against a running mean of healthy steps."""

    def __init__(self, warmup: int = 5, threshold: float = 2.0):
        self.warmup = warmup
        self.threshold = threshold
        self.times: list[float] = []
        self.stragglers = 0
        self._baseline_sum = 0.0
        self._baseline_n = 0

    def record(self, step: int, seconds: float) -> bool:
        """Record one step duration; True iff the step is a straggler."""
        flagged = False
        if self._baseline_n >= self.warmup:
            baseline = self._baseline_sum / self._baseline_n
            flagged = seconds > self.threshold * baseline
        if flagged:
            self.stragglers += 1
        else:  # stragglers don't poison the baseline
            self._baseline_sum += seconds
            self._baseline_n += 1
        self.times.append(seconds)
        return flagged

    def summary(self) -> dict:
        n = len(self.times)
        mean = (self._baseline_sum / self._baseline_n
                if self._baseline_n else 0.0)
        return {
            "steps_recorded": n,
            "stragglers": self.stragglers,
            "mean_step_s": round(mean, 6),
            "max_step_s": round(max(self.times), 6) if self.times else 0.0,
        }


class Supervisor:
    """Run a step loop with periodic checkpoints; on a crash, restore from
    the newest checkpoint and continue.

    At-least-once semantics: a crash replays the (up to ``ckpt_every - 1``)
    steps since the last checkpoint, and a crash before the first
    checkpoint re-runs ``init_fn`` from step 0, so ``step_fn``'s side
    effects must be idempotent or keyed by step. The state trajectory is
    exact: the final state equals an uninterrupted run's."""

    def __init__(self, ckpt_dir: str, ckpt_every: int = 5,
                 max_restarts: int = 3, backoff_s: float = 0.0):
        self.ckpt_dir = ckpt_dir
        self.ckpt_every = ckpt_every
        self.max_restarts = max_restarts
        self.backoff_s = backoff_s
        self.restarts = 0

    def run(self, total_steps: int, *,
            init_fn: Callable[[], Any],
            resume_fn: Callable[[int], Any],
            step_fn: Callable[[Any, int], Any],
            save_fn: Callable[[Any, int], None]) -> Any:
        from repro_torch.ckpt import checkpoint as ck

        state = init_fn()
        step = 0
        while step < total_steps:
            try:
                while step < total_steps:
                    state = step_fn(state, step)
                    step += 1
                    if step % self.ckpt_every == 0:
                        save_fn(state, step)
                return state
            except Exception:
                self.restarts += 1
                if self.restarts > self.max_restarts:
                    raise
                if self.backoff_s:
                    time.sleep(self.backoff_s)
                last: Optional[int] = ck.latest_step(self.ckpt_dir)
                if last is None:
                    state = init_fn()
                    step = 0
                else:
                    state = resume_fn(last)
                    step = last
        return state
