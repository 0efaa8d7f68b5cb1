"""The operating-point ladder: the deployment-time power-accuracy dial.

A rung is one equal-power PANN point — "the accuracy you can buy for the
power of a b-bit unsigned MAC" (Fig. 3). The ladder is a handful of rungs
planned once at server startup; every request then names a rung indirectly,
through a power budget or an accuracy floor, and the scheduler resolves it
with ``select_rung``.

Two allocation modes per rung (DESIGN.md §7):

  * ``uniform`` — one global (b~x, R) for every module (the legacy rung);
  * ``layerwise`` — a ``PolicyTree`` from ``planner.allocate_layerwise``
    spending the SAME total bit-flip budget non-uniformly across module
    paths. A layerwise rung's total power matches its uniform twin within
    float precision and its theory score never trails it (asserted in
    tests/test_policy_allocator.py).

A rung's planned R is the EXACT Algorithm-1 point. It is realized as a
zero-copy view over the one weight store (DESIGN.md §11): each module
quantizes once at its maximal rung budget and the rung's view drops low
bit-planes, SERVING the snapped budget ``core.pann.snapped_r(r_max,
shift)`` rather than ``plan.r`` itself (power drift < sqrt(2), equal-power
score gap bounded in closed form by benchmarks/artifact_parity.py). The
OperatingPoint stays the planning-side truth — budgets, scores and
scheduling all key off the planned point.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Sequence

from repro_torch.core import planner
from repro_torch.core import policy as pol


@dataclasses.dataclass(frozen=True)
class OperatingPoint:
    """One rung: the bit budget it matches and the planned PANN point.

    ``lw`` holds the layerwise plan when the ladder was built with
    ``allocation="layerwise"``; ``plan`` is always the matched uniform
    Algorithm-1 point at the same budget (the rung's per-MAC power and the
    fallback single-point view)."""
    bits: int                    # unsigned-MAC bit width this rung's power equals
    plan: planner.PannPlan
    lw: Optional[planner.LayerwisePlan] = None

    @property
    def power(self) -> float:
        return self.plan.power_budget

    @property
    def r(self) -> float:
        return self.plan.r

    @property
    def b_x_tilde(self) -> int:
        return self.plan.b_x_tilde

    @property
    def score(self) -> float:
        return self.lw.score if self.lw is not None else self.plan.score

    @property
    def allocation(self) -> str:
        return "layerwise" if self.lw is not None else "uniform"

    @property
    def tree(self) -> Optional[pol.PolicyTree]:
        """The rung's PolicyTree (None for a uniform rung)."""
        return self.lw.tree if self.lw is not None else None

    def describe(self) -> str:
        if self.lw is not None:
            return f"rung[{self.bits}b] {self.lw.describe()}"
        return f"rung[{self.bits}b] {self.plan.describe()}"


def build_ladder(bits: Sequence[int] = (2, 3, 4, 6), d: float = 4096.0,
                 eval_fn=None, allocation: str = "uniform",
                 profile: Optional[Sequence] = None
                 ) -> tuple[OperatingPoint, ...]:
    """Plan the ladder, sorted by ascending power. Deterministic: a pure
    function of its inputs, so two servers configured alike agree rung for
    rung (tested in tests/test_serve_engine.py).

    ``allocation="layerwise"`` needs ``profile`` (a
    ``costs.module_cost_profile``); each rung then carries a PolicyTree
    spending the rung's total budget across modules, plus its matched
    uniform plan for comparison and logging. ``eval_fn`` (the Algorithm-1
    per-(b~x, R) backend) is rejected for layerwise ladders rather than
    silently dropped — every rung score on one ladder must come from ONE
    metric, or ``select_rung``'s accuracy floors compare apples to oranges.
    """
    sorted_bits = sorted({int(b) for b in bits})
    if allocation == "uniform":
        plans = planner.plan_ladder(sorted_bits, d=d, eval_fn=eval_fn)
        return tuple(OperatingPoint(b, p) for b, p in zip(sorted_bits, plans))
    lw_plans = planner.plan_ladder(sorted_bits, d=d, eval_fn=eval_fn,
                                   allocation=allocation, profile=profile)
    plans = planner.plan_ladder(sorted_bits, d=d)   # theory metric, matched
    return tuple(OperatingPoint(b, p, lw)
                 for b, p, lw in zip(sorted_bits, plans, lw_plans))


def select_rung(ladder: Sequence[OperatingPoint],
                power_budget_bits: Optional[int] = None,
                min_score: Optional[float] = None,
                max_bits: Optional[int] = None) -> OperatingPoint:
    """Resolve a request's declared constraint to a rung.

    * power budget: the highest-fidelity rung whose power fits the budget
      (best accuracy the budget can buy); below the lowest rung we clamp to
      the lowest rung rather than refuse the request.
    * accuracy floor: the cheapest rung whose planner score meets the floor
      (least power that honors the SLO); unattainable floors get the top
      rung — the best the server has.
    * both: the cheapest rung meeting the floor WITHIN the budget; if the
      floor needs more power than the budget allows, raise — silently
      violating a declared SLO is worse than refusing the request.
    * neither: the top rung.

    ``max_bits`` is the fleet power governor's ceiling (docs/fleet.md): the
    ladder is first clipped to rungs at or below it (keeping at least the
    cheapest rung, mirroring the budget clamp), then the rules above apply
    within the clipped ladder — so a global cap squeezes every selection
    down the ladder without rewriting per-request constraints. A floor
    that only a rung ABOVE the ceiling meets raises, like an unaffordable
    budget+floor pair: the caller decides whether the cap or the SLO wins.
    """
    if not ladder:
        raise ValueError("empty ladder")
    ladder = sorted(ladder, key=lambda op: op.power)
    if max_bits is not None:
        clipped = [op for op in ladder if op.bits <= max_bits] or [ladder[0]]
        if min_score is not None and all(op.score < min_score
                                        for op in clipped):
            raise ValueError(
                f"no rung under the {max_bits}-bit governor ceiling meets "
                f"score floor {min_score} (best: {clipped[-1].score})")
        ladder = clipped
    if power_budget_bits is not None:
        fits = [op for op in ladder if op.bits <= power_budget_bits] \
            or [ladder[0]]
        if min_score is None:
            return fits[-1]
        for op in fits:                # ascending power == ascending score
            if op.score >= min_score:
                return op
        raise ValueError(
            f"no rung within a {power_budget_bits}-bit power budget meets "
            f"score floor {min_score} (best affordable: {fits[-1].score})")
    if min_score is not None:
        for op in ladder:
            if op.score >= min_score:
                return op
        return ladder[-1]
    return ladder[-1]
