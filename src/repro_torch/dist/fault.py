"""Fault tolerance of the trainer (port of ``repro.dist.fault``, its
``StepMonitor``): straggler telemetry. ``StepMonitor`` keeps a running
baseline of healthy step times and flags any step slower than
``threshold`` x the baseline. The fleet's ``HostFailure`` and
``FleetSupervisor`` and the restart loop ``Supervisor`` come with the
serving fleet (ROADMAP A9).
"""
from __future__ import annotations


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
