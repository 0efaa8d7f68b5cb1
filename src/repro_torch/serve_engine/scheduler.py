"""Continuous-batching scheduler over operating-point rungs.

Requests declare *what they can afford* (a power budget in unsigned-MAC
bits) or *what they must achieve* (an accuracy-proxy floor); the scheduler
resolves each to a ladder rung at admission and keeps one FIFO per rung.
Waves (rung, up-to-max_batch requests of equal prompt length) are handed to
the engine round-robin across rungs, so a burst on one rung can't starve
the others and the engine demonstrably switches operating points between
decode steps.
"""
from __future__ import annotations

import dataclasses
from collections import OrderedDict, deque
from typing import Optional, Sequence

import numpy as np

from repro_torch.serve_engine.ladder import OperatingPoint, select_rung


@dataclasses.dataclass
class Request:
    """One generation request with its declared power/accuracy constraint."""
    uid: int
    prompt: np.ndarray                        # (prompt_len,) int32 token ids
    max_new_tokens: int = 16
    power_budget_bits: Optional[int] = None   # "spend at most this much"
    min_score: Optional[float] = None         # "be at least this good"

    @property
    def prompt_len(self) -> int:
        return int(self.prompt.shape[0])


@dataclasses.dataclass
class Response:
    """Generated tokens plus the energy/operating-point metadata every
    response carries: which rung served the request and what it cost per
    token."""
    uid: int
    tokens: list                              # generated token ids
    rung_bits: int
    metadata: dict                            # plan + EnergyLedger report


@dataclasses.dataclass(frozen=True)
class Wave:
    """A schedulable unit: requests sharing a rung and a prompt length."""
    rung: OperatingPoint
    requests: tuple


class Scheduler:
    def __init__(self, ladder: Sequence[OperatingPoint], max_batch: int):
        self.ladder = tuple(sorted(ladder, key=lambda op: op.power))
        self.max_batch = int(max_batch)
        self._queues: "OrderedDict[int, deque]" = OrderedDict(
            (op.bits, deque()) for op in self.ladder)
        self._rungs = {op.bits: op for op in self.ladder}
        self._rr = 0                      # round-robin cursor over rung index

    def submit(self, req: Request,
               rung: Optional[OperatingPoint] = None) -> OperatingPoint:
        """Resolve the request's constraint to a rung and enqueue it; pass a
        pre-resolved ``rung`` to skip re-selection (the engine validates the
        whole batch before enqueueing anything)."""
        if rung is None:
            rung = select_rung(self.ladder, req.power_budget_bits,
                               req.min_score)
        self._queues[rung.bits].append(req)
        return rung

    def pending(self) -> int:
        return sum(len(q) for q in self._queues.values())

    def drain(self) -> list[Request]:
        """Remove and return every queued request, FIFO within each rung,
        rungs in ladder (ascending-power) order. The fleet governor uses
        this on a ceiling change: queued work was resolved under the OLD
        ceiling, so it is drained and re-submitted through the new one —
        re-selection is the governor's actuator, and it must reach work
        that has not started yet, not only new arrivals."""
        out: list[Request] = []
        for q in self._queues.values():
            out.extend(q)
            q.clear()
        return out

    def next_wave(self, eligible_bits: Optional[set] = None
                  ) -> Optional[Wave]:
        """Pop the next wave, round-robin over rungs with queued work.

        Within a rung's FIFO we take the head request and every request
        behind it with the same prompt length (up to max_batch), so a wave
        prefills as one rectangular batch without padding bookkeeping.

        ``eligible_bits`` restricts which rungs may form a wave this call —
        the fleet hands in the rungs that currently have a free decode slot
        on some live host, so a busy (or dead) rung's queue waits without
        blocking the others, and the round-robin cursor only advances past
        rungs that actually produced work.
        """
        n = len(self.ladder)
        for off in range(n):
            bits = self.ladder[(self._rr + off) % n].bits
            if eligible_bits is not None and bits not in eligible_bits:
                continue
            q = self._queues[bits]
            if not q:
                continue
            self._rr = (self._rr + off + 1) % n
            head = q.popleft()
            picked = [head]
            rest = deque()
            while q and len(picked) < self.max_batch:
                r = q.popleft()
                if r.prompt_len == head.prompt_len:
                    picked.append(r)
                else:
                    rest.append(r)
            rest.extend(q)
            q.clear()
            q.extend(rest)
            return Wave(rung=self._rungs[bits], requests=tuple(picked))
        return None
