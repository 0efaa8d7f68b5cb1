"""Power-budget annealing for quantization-aware training (port of
``repro.core.anneal``, framework-free: the same code, the port's imports).

The curriculum starts training near full precision and tightens the
network's bit-flip budget at schedule knots, re-running the layer-wise
allocator (``planner.allocate_layerwise``) at every knot so each budget is
spent non-uniformly across module roles — training visits exactly the
per-module (b̃x, R) operating points the serving ladder deploys.

A schedule is a comma list of ``step:bits`` knots, bits being the
unsigned-MAC-equivalent budget of the equal-power protocol
(``planner.budget_from_bits``) or ``fp``/``0`` for an unquantized segment:

    "0:fp,200:8,600:6,900:4"

Everything here is a pure function of (schedule, model config): replanning
at a checkpoint resume reproduces the original PolicyTree bit-for-bit (the
allocator is deterministic Python float math), which is what makes
mid-anneal resume exact (tests/test_torch_train.py).
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Sequence, Tuple

from repro_torch.configs.base import ModelConfig
from repro_torch.core import costs
from repro_torch.core import planner
from repro_torch.core import policy as pol
from repro_torch.core import power as pw


def strip_quant(cfg: ModelConfig) -> ModelConfig:
    """The one definition of a full-precision forward config: no policy
    tree, global quant mode off. Used for fp annealing segments, for
    --train_quant none/ptq training, and as export's PTQ reference."""
    return dataclasses.replace(
        cfg, policy=None,
        quant=dataclasses.replace(cfg.quant, mode="none"))


@dataclasses.dataclass(frozen=True)
class Knot:
    step: int
    bits: int          # unsigned-MAC-equivalent budget; 0 = full precision


@dataclasses.dataclass(frozen=True)
class BudgetSchedule:
    """Ascending ``Knot``s; steps before the first knot run full precision."""
    knots: Tuple[Knot, ...]

    @classmethod
    def parse(cls, spec: str) -> "BudgetSchedule":
        knots = []
        for entry in spec.split(","):
            entry = entry.strip()
            if not entry:
                continue
            try:
                step_s, bits_s = entry.split(":")
                step = int(step_s)
                bits = 0 if bits_s.strip().lower() in ("fp", "none") \
                    else int(bits_s)
            except ValueError:
                raise ValueError(
                    f"bad budget-schedule entry {entry!r}; expected "
                    f"'step:bits' with bits an int or 'fp'") from None
            if step < 0 or bits < 0:
                raise ValueError(f"negative step/bits in {entry!r}")
            knots.append(Knot(step=step, bits=bits))
        if not knots:
            raise ValueError(f"empty budget schedule {spec!r}")
        steps = [k.step for k in knots]
        if sorted(set(steps)) != steps:
            raise ValueError(
                f"budget-schedule steps must be strictly ascending: {spec!r}")
        return cls(knots=tuple(knots))

    def bits_at(self, step: int) -> int:
        bits = 0
        for k in self.knots:
            if k.step <= step:
                bits = k.bits
            else:
                break
        return bits

    def segments(self, start: int, stop: int
                 ) -> Tuple[Tuple[int, int, int], ...]:
        """Constant-budget (seg_start, seg_end, bits) spans covering
        [start, stop) — the trainer jits one step function per span."""
        if stop <= start:
            return ()
        bounds = sorted({start, stop}
                        | {k.step for k in self.knots if start < k.step < stop})
        return tuple((s0, s1, self.bits_at(s0))
                     for s0, s1 in zip(bounds[:-1], bounds[1:]))

    def knot_steps(self) -> Tuple[int, ...]:
        """Steps at which the budget *changes* — LR re-warmup points."""
        out, prev = [], 0
        for k in self.knots:
            if k.bits != prev:
                out.append(k.step)
            prev = k.bits
        return tuple(s for s in out if s > 0)

    def describe(self) -> str:
        return " -> ".join(
            f"@{k.step}:{'fp' if k.bits == 0 else f'{k.bits}b'}"
            for k in self.knots)


class BudgetAnnealer:
    """Materializes the training config for each schedule segment.

    One allocator run per distinct budget (cached — the plan for 6 bits is
    the same object at step 600 and at a step-700 resume), spending the
    budget across module roles exactly like the serving ladder does, so the
    QAT forward and the exported artifact share their PolicyTrees.
    """

    def __init__(self, schedule: BudgetSchedule, cfg: ModelConfig,
                 allocation: str = "layerwise",
                 b_range: Sequence[int] = tuple(range(2, 9))):
        if allocation not in ("uniform", "layerwise"):
            raise ValueError(f"unknown allocation {allocation!r}")
        self.schedule = schedule
        self.allocation = allocation
        self.b_range = tuple(b_range)
        self.profile = costs.module_cost_profile(cfg)
        self._plans: dict[int, object] = {}

    def plan_for(self, bits: int):
        """The (cached) plan at an unsigned-MAC bit budget; None for fp."""
        if bits <= 0:
            return None
        if bits not in self._plans:
            budget = planner.budget_from_bits(bits)
            if self.allocation == "layerwise":
                self._plans[bits] = planner.allocate_layerwise(
                    budget, self.profile, b_range=self.b_range)
            else:
                self._plans[bits] = planner.plan_with_theory(
                    budget, b_range=self.b_range)
        return self._plans[bits]

    def tree_for(self, bits: int) -> Optional[pol.PolicyTree]:
        plan = self.plan_for(bits)
        if plan is None:
            return None
        if isinstance(plan, planner.LayerwisePlan):
            return plan.tree
        # uniform: the global Algorithm-1 point on every module, with each
        # module's own Eq.-20 accumulator width (same lift the ladder uses)
        return pol.policy_tree(
            pol.pann_module_quant(plan.r, plan.b_x_tilde,
                                  max(m.fan_in for m in self.profile)),
            {m.path: pol.pann_module_quant(plan.r, plan.b_x_tilde, m.fan_in)
             for m in self.profile})

    def config_at(self, cfg: ModelConfig, step: int
                  ) -> Tuple[ModelConfig, Optional[object], int]:
        """(training config, plan, bits) governing ``step``.

        fp segments strip quantization from the forward entirely; quantized
        segments install the allocator's PolicyTree (mode comes from the
        tree's per-module ModuleQuants — all 'pann').
        """
        bits = self.schedule.bits_at(step)
        plan = self.plan_for(bits)
        if plan is None:
            return strip_quant(cfg), None, bits
        return dataclasses.replace(cfg, policy=self.tree_for(bits)), plan, \
            bits

    @classmethod
    def from_train_config(cls, cfg: ModelConfig, tcfg
                          ) -> Optional["BudgetAnnealer"]:
        """The one construction path shared by the trainer and the exporter
        — both must materialize the SAME annealer from a TrainConfig or the
        exported operating point drifts from the trained one."""
        if not tcfg.budget_schedule:
            return None
        return cls(BudgetSchedule.parse(tcfg.budget_schedule), cfg,
                   allocation=tcfg.budget_allocation)

    def gbitflips_per_token(self, bits: int) -> float:
        """Planned network power at a knot (Gbit-flips/token, weight MACs)
        — the train-smoke CI gate compares this against its baseline."""
        plan = self.plan_for(bits)
        if plan is None:
            return 0.0
        if isinstance(plan, planner.LayerwisePlan):
            return pw.giga(plan.total_power)
        total_macs = sum(m.macs for m in self.profile)
        return pw.giga(plan.power_budget * total_macs)
