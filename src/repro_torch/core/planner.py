"""Algorithm 1: determining the optimal PANN parameters for a power budget.

Given a power budget P (per-weight-MAC, in bit flips), sweep the activation
bit width b~x, set R = P / b~x - 0.5 (Eq. 13), evaluate the PANN-ified model
on a validation set, and keep the best-performing (b~x, R).

Two evaluation backends:
  * ``plan_with_eval``   — the paper's Algorithm 1 verbatim (needs an eval fn),
  * ``plan_with_theory`` — data-free fallback minimizing Eq. (19).

The planner is also the deployment-time knob: moving between equal-power
curves (Fig. 3) only changes (b~x, R) — no architecture change.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Iterable, Optional, Sequence

from repro_torch.core import mse as mse_theory
from repro_torch.core import policy as pol
from repro_torch.core import power as pw


@dataclasses.dataclass(frozen=True)
class PannPlan:
    power_budget: float      # per weight-MAC, bit flips
    b_x_tilde: int
    r: float
    score: float             # accuracy (eval backend) or -MSE (theory backend)
    candidates: tuple        # (b_x, r, score) for every candidate swept

    def describe(self, total_macs: Optional[float] = None) -> str:
        """``total_macs`` (network weight MACs per token) appends the total
        network price — MACs x per-MAC power — so uniform and layerwise
        plans compare in the same unit in logs."""
        text = (f"PANN plan @ P={self.power_budget:.1f} bit-flips/MAC: "
                f"b~x={self.b_x_tilde}, R={self.r:.2f} "
                f"(score {self.score:.4f})")
        if total_macs is not None:
            total = pw.giga(self.power_budget * total_macs)
            text += f" | total {total:.2f} Gbit-flips/token"
        return text


def candidate_bit_widths(power: float,
                         b_range: Sequence[int] = tuple(range(2, 9))
                         ) -> list[int]:
    """Bit widths for which the budget leaves a positive addition factor."""
    return [b for b in b_range if pw.pann_r_for_budget(power, b) > 0.05]


def plan_with_eval(power: float,
                   eval_fn: Callable[[int, float], float],
                   b_range: Sequence[int] = tuple(range(2, 9)),
                   ) -> PannPlan:
    """Algorithm 1. ``eval_fn(b_x_tilde, r) -> accuracy`` runs the quantized
    network on a validation set (lines 5-8)."""
    cands = []
    for b in candidate_bit_widths(power, b_range):
        r = pw.pann_r_for_budget(power, b)
        acc = float(eval_fn(b, r))
        cands.append((b, r, acc))
    if not cands:
        raise ValueError(f"power budget {power} too small for any bit width")
    b, r, acc = max(cands, key=lambda t: t[2])
    return PannPlan(power, b, r, acc, tuple(cands))


def plan_with_theory(power: float,
                     d: float = 4096.0,
                     b_range: Sequence[int] = tuple(range(2, 9)),
                     ) -> PannPlan:
    """Data-free planner: minimize the Eq. (19) MSE instead of evaluating."""
    cands = []
    for b in candidate_bit_widths(power, b_range):
        r = pw.pann_r_for_budget(power, b)
        m = mse_theory.mse_pann_at_budget(d, power, b)
        cands.append((b, r, -m))
    if not cands:
        raise ValueError(f"power budget {power} too small for any bit width")
    b, r, score = max(cands, key=lambda t: t[2])
    return PannPlan(power, b, r, score, tuple(cands))


def budget_from_bits(bits: int) -> float:
    """Power budget equal to a ``bits``-wide *unsigned* MAC (the paper's
    experimental protocol: PANN is always matched to the unsigned-MAC cost)."""
    return pw.p_mac_unsigned(bits)


def equal_power_curve(bits: int, b_range: Iterable[int] = range(2, 9)
                      ) -> list[tuple[int, float]]:
    """Fig. 3: (b~x, R) combinations matching a b_x-bit unsigned MAC."""
    p = budget_from_bits(bits)
    out = []
    for b in b_range:
        r = pw.pann_r_for_budget(p, b)
        if r > 0:
            out.append((b, r))
    return out


def plan_ladder(bits_ladder: Sequence[int] = (2, 3, 4, 6),
                d: float = 4096.0,
                b_range: Sequence[int] = tuple(range(2, 9)),
                eval_fn: Optional[Callable[[int, float], float]] = None,
                allocation: str = "uniform",
                profile: Optional[Sequence] = None,
                ) -> tuple:
    """The deployment ladder: one operating point per equal-power budget.

    For each unsigned-MAC bit budget in ``bits_ladder``, pick the best point
    on its Fig.-3 equal-power curve (Algorithm 1 when ``eval_fn`` is given,
    Eq.-19 theory otherwise). Returns plans sorted by ascending power — a
    pure function of its inputs, so ladder planning is deterministic and two
    servers configured alike materialize identical operating points.

    ``allocation="layerwise"`` (requires ``profile``, a
    ``costs.module_cost_profile``) returns ``LayerwisePlan``s instead: each
    rung spends the SAME total bit-flip budget non-uniformly across module
    paths via ``allocate_layerwise`` — every rung's power matches its
    uniform twin, its theory score never trails it.
    """
    if allocation not in ("uniform", "layerwise"):
        raise ValueError(f"unknown allocation {allocation!r}")
    if allocation == "layerwise" and profile is None:
        raise ValueError("layerwise allocation needs a module cost profile")
    if allocation == "layerwise" and eval_fn is not None:
        # never silently drop the eval backend: a per-(b,r) eval_fn cannot
        # score a tree; eval-backed layerwise planning takes a tree-level
        # judge via allocate_layerwise(eval_fn=tree -> score) directly
        raise ValueError(
            "plan_ladder(eval_fn=...) is the Algorithm-1 per-(b~x, R) "
            "backend and does not apply to layerwise allocation; call "
            "allocate_layerwise(..., eval_fn=tree -> score) instead")
    plans = []
    for bits in sorted({int(b) for b in bits_ladder}):
        p = budget_from_bits(bits)
        if allocation == "layerwise":
            plans.append(allocate_layerwise(p, profile, b_range=b_range))
        elif eval_fn is not None:
            plans.append(plan_with_eval(p, eval_fn, b_range))
        else:
            plans.append(plan_with_theory(p, d, b_range))
    return tuple(plans)


# ---------------------------------------------------------------------------
# Layer-wise power-budget allocation
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class LayerwisePlan:
    """A per-module spend of the network's total bit-flip budget.

    ``power_budget`` is the matched per-weight-MAC budget (same unit as
    ``PannPlan``): the plan's total power equals ``power_budget x
    total_macs`` — the SAME total as the uniform plan at this budget —
    spent non-uniformly across module paths.
    """
    power_budget: float          # per weight-MAC (matched to uniform)
    tree: pol.PolicyTree         # pann ModuleQuant per module path
    score: float                 # tree_theory_score (or eval_fn) of the tree
    uniform_score: float         # same metric, matched uniform tree
    uniform_tree: pol.PolicyTree
    total_macs: float            # weight MACs per token
    total_power: float           # bit flips per token (weight modules)
    per_module: tuple            # (path, macs, fan_in, b~x, R, p/MAC) rows

    def describe(self) -> str:
        total = pw.giga(self.total_power)
        gain = self.score - self.uniform_score
        return (f"layerwise plan @ P={self.power_budget:.1f} bit-flips/MAC "
                f"x {self.total_macs:.3e} MACs = {total:.2f} "
                f"Gbit-flips/token over {len(self.per_module)} modules "
                f"(score {self.score:.4f}, +{gain:.4f} vs uniform)")

    def bit_table(self) -> str:
        rows = [f"{'module':<16}{'MACs':>12}{'fan_in':>8}{'b~x':>5}"
                f"{'R':>8}{'bf/MAC':>8}{'Gbf/tok':>9}"]
        for path, macs, fan_in, b, r, p_mac in self.per_module:
            rows.append(f"{path:<16}{macs:>12.3e}{fan_in:>8d}{b:>5d}"
                        f"{r:>8.2f}{p_mac:>8.2f}"
                        f"{pw.giga(macs * p_mac):>9.3f}")
        return "\n".join(rows)


def _level_grid(power_budget: float, n_levels: int) -> list[float]:
    """Per-MAC power levels the knapsack moves between: geometric from just
    above the cheapest viable PANN point up to well past the budget (a
    module CAN exceed the per-MAC budget — that is the point of layerwise —
    as long as the network total stays inside)."""
    lo = pw.p_pann(0.25, 2)                      # 1.5 bit flips/MAC
    hi = max(4.0 * power_budget, pw.p_mac_unsigned(8))
    ratio = (hi / lo) ** (1.0 / (n_levels - 1))
    grid = [lo * ratio ** i for i in range(n_levels)]
    grid.append(float(power_budget))             # uniform point reachable
    return sorted(set(grid))


def _best_point_at(p: float, b_range: Sequence[int]
                   ) -> Optional[tuple[int, float, float]]:
    """Best (b~x, R, relative mse) on the equal-power curve at per-MAC
    power ``p`` — plan_with_theory's argmin, with the d=1 (signal-
    normalized) Eq.-18 MSE the tree score uses (see
    policy.tree_theory_score; the argmin over b is d-independent)."""
    best = None
    for b in b_range:
        r = pw.pann_r_for_budget(p, b)
        if r <= 0.05:
            continue
        m = mse_theory.mse_pann(1.0, b, r)
        if best is None or m < best[2]:
            best = (b, r, m)
    return best


# cache codes are unsigned affine with <= 7 planes (codes <= 127; see
# kernels/ref.CACHE_PLANES) — the allocator's cache ladder is the integer
# bit widths inside that envelope
CACHE_B_RANGE = tuple(range(2, 8))


def _cache_levels() -> list[tuple[float, int, float, float]]:
    """Candidate (per-MAC power, bits, R=0, relative mse) levels for a
    CACHE_PATHS pseudo-module: integer unsigned widths priced at
    ``p_mac_unsigned`` (the same split ``policy.tree_power_per_token``
    charges a cache-carrying tree) and scored with the Eq.-16 RUQ MSE at
    b_x = b_w = b (codes quantize both operand streams of the act x act
    MAC)."""
    return [(pw.p_mac_unsigned(b), b, 0.0, mse_theory.mse_ruq(1.0, b, b))
            for b in CACHE_B_RANGE]


def _uniform_cache_bits(power_budget: float) -> int:
    """Largest integer cache width an unsigned MAC at ``power_budget`` can
    pay for — the uniform twin's cache point (floor 2 keeps the twin
    constructible even under the smallest ladder budgets)."""
    fit = [b for b in CACHE_B_RANGE if pw.p_mac_unsigned(b)
           <= power_budget * (1 + 1e-9)]
    return max(fit) if fit else CACHE_B_RANGE[0]


def allocate_layerwise(power_budget: float,
                       profile: Sequence,
                       b_range: Sequence[int] = tuple(range(2, 9)),
                       n_levels: int = 48,
                       eval_fn: Optional[Callable] = None,
                       ) -> LayerwisePlan:
    """Spend ``power_budget x total_macs`` bit flips across modules.

    Greedy marginal-benefit knapsack over a shared grid of per-MAC power
    levels: every module starts at the cheapest viable PANN point; the
    upgrade with the best MSE-reduction per extra bit flip is applied until
    no upgrade fits the total budget. Two closing moves make the invariants
    (tests/test_policy_allocator.py) unconditional:

      * R-fill — the residual slack is spread over all modules as extra R
        at fixed b~x (Eq. 13 is linear in R), so total power equals the
        budget exactly, matching the uniform plan's total to float
        precision.
      * uniform fallback — if the greedy tree somehow scores below the
        matched uniform tree under ``tree_theory_score``, the uniform tree
        is returned instead: layerwise is never worse than uniform.

    ``eval_fn(tree) -> score`` mirrors ``plan_with_eval``: when given, the
    greedy and uniform candidate trees are both evaluated and the better
    one wins (the recorded score is then the eval score).

    ``profile`` is ``costs.module_cost_profile(cfg)`` (anything with
    .path/.macs/.fan_in works). Appending ``costs.cache_cost_modules`` rows
    puts the KV cache on the same knapsack: CACHE_PATHS entries move on the
    integer unsigned ladder (``_cache_levels``) instead of the PANN grid,
    and the closing R-fill — a PANN-only move (Eq. 13 has no cache
    analogue) — spreads the slack over the PANN modules alone.
    """
    modules = [m for m in profile if m.macs > 0]
    if not modules:
        raise ValueError("empty module cost profile")
    is_cache = [m.path in pol.CACHE_PATHS for m in modules]
    total_macs = sum(m.macs for m in modules)
    budget_total = power_budget * total_macs

    # the matched uniform twin: the global Algorithm-1 point everywhere
    # (cache roles: the widest integer width the budget pays for)
    uni = plan_with_theory(power_budget, b_range=b_range)
    uni_cache = pol.cache_module_quant(_uniform_cache_bits(power_budget))
    uniform_tree = pol.policy_tree(
        pol.pann_module_quant(uni.r, uni.b_x_tilde,
                              max(m.fan_in for m in modules)),
        {m.path: (uni_cache if c else
                  pol.pann_module_quant(uni.r, uni.b_x_tilde, m.fan_in))
         for m, c in zip(modules, is_cache)})

    # per-module candidate levels: (per-MAC power, b~x, R, mse), ascending
    grid = _level_grid(power_budget, n_levels)
    cands = []
    for m, c in zip(modules, is_cache):
        if c:
            cands.append(_cache_levels())
            continue
        levels = []
        for p in grid:
            pt = _best_point_at(p, b_range)
            if pt is not None:
                levels.append((p, pt[0], pt[1], pt[2]))
        if not levels:
            raise ValueError(
                f"power budget {power_budget} too small for any bit width "
                f"(module {m.path})")
        cands.append(levels)

    idx = [0] * len(modules)
    total = sum(m.macs * cands[i][0][0] for i, m in enumerate(modules))
    if total > budget_total * (1 + 1e-9):
        raise ValueError(
            f"power budget {power_budget} below the cheapest viable "
            f"layerwise plan ({total / total_macs:.2f} bit-flips/MAC)")
    # weight of one neuron's MSE: outputs per token = macs / fan_in
    w = [m.macs / max(float(m.fan_in), 1.0) for m in modules]
    while True:
        best, best_gain = None, 0.0
        for i, m in enumerate(modules):
            if idx[i] + 1 >= len(cands[i]):
                continue
            cur, nxt = cands[i][idx[i]], cands[i][idx[i] + 1]
            dcost = m.macs * (nxt[0] - cur[0])
            if total + dcost > budget_total * (1 + 1e-12):
                continue
            gain = w[i] * (cur[3] - nxt[3]) / max(dcost, 1e-30)
            if best is None or gain > best_gain:
                best, best_gain = i, gain
        if best is None:
            break
        total += modules[best].macs * (cands[best][idx[best] + 1][0]
                                       - cands[best][idx[best]][0])
        idx[best] += 1

    # R-fill: hand the residual slack to every PANN module as extra R at
    # fixed b~x — consumes the budget exactly and only lowers the Eq.-18
    # MSE. Cache modules sit on an integer ladder with no R axis, so they
    # keep their level and the slack goes to the PANN side.
    pann_macs = sum(m.macs for m, c in zip(modules, is_cache) if not c)
    slack_per_mac = (budget_total - total) / max(pann_macs, 1e-30)
    overrides = {}
    for i, (m, c) in enumerate(zip(modules, is_cache)):
        p, b, r, _ = cands[i][idx[i]]
        if c:
            overrides[m.path] = pol.cache_module_quant(b)
            continue
        p_eff = p + slack_per_mac
        overrides[m.path] = pol.pann_module_quant(
            pw.pann_r_for_budget(p_eff, b), b, m.fan_in)

    tree = pol.policy_tree(
        pol.pann_module_quant(uni.r, uni.b_x_tilde,
                              max(m.fan_in for m in modules)),
        overrides)

    score = pol.tree_theory_score(modules, tree)
    uniform_score = pol.tree_theory_score(modules, uniform_tree)
    if eval_fn is not None:
        score = float(eval_fn(tree))
        uniform_score = float(eval_fn(uniform_tree))
    if score < uniform_score:        # the unconditional guarantee
        tree, score = uniform_tree, uniform_score

    per_module = tuple(
        (m.path, m.macs, m.fan_in, tree.lookup(m.path).b_x_tilde,
         tree.lookup(m.path).r, tree.lookup(m.path).power_per_mac())
        for m in modules)
    total_power = sum(m.macs * tree.lookup(m.path).power_per_mac()
                      for m in modules)
    return LayerwisePlan(power_budget=power_budget, tree=tree, score=score,
                         uniform_score=uniform_score,
                         uniform_tree=uniform_tree,
                         total_macs=total_macs, total_power=total_power,
                         per_module=per_module)


def replan_for_rate(cap_bitflips_per_s: float,
                    tokens_per_s: float,
                    profile: Sequence,
                    b_range: Sequence[int] = tuple(range(2, 9)),
                    bits_envelope: tuple[int, int] = (2, 8),
                    ) -> LayerwisePlan:
    """Telemetry-driven replan: the per-MAC power budget a MEASURED token
    rate leaves under a fleet-wide bit-flips/sec cap, spent layerwise.

    This is the closed-loop heart of the fleet power governor
    (``repro.serve_engine.fleet``): aggregated ``EnergyLedger`` telemetry
    gives the fleet's realized tokens/sec; dividing the cap by (rate x
    total MACs/token) yields the affordable per-weight-MAC budget, which
    ``allocate_layerwise`` then spends across modules exactly as at plan
    time. The resulting plan's ``power_budget`` is what rung-ceiling
    selection compares against ladder rung powers.

    The budget is clamped to the constructible envelope
    ``[budget_from_bits(lo), budget_from_bits(hi)]`` — a cap far above
    what the traffic can spend replans at the top of the ladder instead
    of chasing unbounded R, and a cap below the cheapest viable point
    replans at the floor instead of raising from the knapsack.
    Deterministic: a pure function of its (finite) float inputs.
    """
    if cap_bitflips_per_s <= 0:
        raise ValueError(f"cap must be positive, got {cap_bitflips_per_s}")
    total_macs = sum(m.macs for m in profile if m.macs > 0)
    if total_macs <= 0:
        raise ValueError("empty module cost profile")
    rate = max(float(tokens_per_s), 1e-9)
    per_mac = cap_bitflips_per_s / (rate * total_macs)
    lo = budget_from_bits(bits_envelope[0])
    hi = budget_from_bits(bits_envelope[1])
    per_mac = min(max(per_mac, lo), hi)
    return allocate_layerwise(per_mac, profile, b_range=b_range)
