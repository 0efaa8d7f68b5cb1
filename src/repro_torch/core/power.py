"""Analytic power models from the PANN paper, in units of bit flips.

All formulas are from "Energy awareness in low precision neural networks"
(Spingarn Eliezer et al., 2022):

  Eq. (1)  P_mult        = 0.5 b^2 + b                      (signed b x b)
  Eq. (2)  P_acc         = 0.5 B + 2 b                      (signed, B-bit accumulator)
  Eq. (3)  P_mult^u      = 0.5 b^2 + b                      (unsigned)
  Eq. (4)  P_acc^u       = 3 b                              (unsigned)
  Eq. (7)  P_mult_mixed  = 0.5 max(bw,bx)^2 + 0.5 (bw+bx)   (signed, mixed widths)
  Eq. (13) P_PANN        = (R + 0.5) b~x                    (per input element)
  Eq. (20) B_required    = bx + bw + 1 + log2(k^2 C_in)

Power is *per MAC* (or per input element for PANN); multiply by the MAC count of
the network to get total forward-pass power in bit flips (reported in Giga
bit-flips, as in the paper's tables).
"""
from __future__ import annotations

import dataclasses
import math
from typing import Iterable, Optional

DEFAULT_ACC_BITS = 32  # the paper's default accumulator width


# ---------------------------------------------------------------------------
# Per-op models
# ---------------------------------------------------------------------------

def p_mult_signed(b: float) -> float:
    """Eq. (1): signed b x b multiplier power (bit flips per multiply)."""
    return 0.5 * b * b + b


def p_acc_signed(b: float, acc_bits: float = DEFAULT_ACC_BITS) -> float:
    """Eq. (2): accumulator power for signed products (B-bit accumulator)."""
    return 0.5 * acc_bits + 2.0 * b


def p_mult_unsigned(b: float) -> float:
    """Eq. (3): unsigned multiplier power (same model as signed; App. A.3)."""
    return 0.5 * b * b + b


def p_acc_unsigned(b: float) -> float:
    """Eq. (4): accumulator power for unsigned products."""
    return 3.0 * b


def p_mult_mixed(b_w: float, b_x: float) -> float:
    """Eq. (7): signed multiplier with different input widths.

    Observation 2: dominated by max(b_w, b_x)."""
    m = max(b_w, b_x)
    return 0.5 * m * m + 0.5 * (b_w + b_x)


def p_mac_signed(b: float, acc_bits: float = DEFAULT_ACC_BITS) -> float:
    """Signed MAC: Eq. (1) + Eq. (2)."""
    return p_mult_signed(b) + p_acc_signed(b, acc_bits)


def p_mac_unsigned(b: float) -> float:
    """Unsigned MAC: Eq. (3) + Eq. (4) = 0.5 b^2 + 4 b (Fig. 3 caption)."""
    return p_mult_unsigned(b) + p_acc_unsigned(b)


def p_mac_mixed_signed(b_w: float, b_x: float,
                       acc_bits: float = DEFAULT_ACC_BITS) -> float:
    """Mixed-width signed MAC: Eq. (7) + Eq. (2) at b = max(b_w, b_x)."""
    return p_mult_mixed(b_w, b_x) + p_acc_signed(max(b_w, b_x), acc_bits)


def p_pann(r: float, b_x_tilde: float) -> float:
    """Eq. (13): PANN power per input element, R additions of b~x-bit values."""
    return (r + 0.5) * b_x_tilde


def pann_r_for_budget(power: float, b_x_tilde: float) -> float:
    """Invert Eq. (13): the addition budget R matching a power budget."""
    return power / b_x_tilde - 0.5


def pann_bx_for_budget(power: float, r: float) -> float:
    """Invert Eq. (13) for the activation bit width."""
    return power / (r + 0.5)


def required_acc_bits(b_x: int, b_w: int, fan_in: int) -> int:
    """Eq. (20): accumulator width that avoids overflow.

    ``fan_in`` is k^2 * C_in for a conv layer, or d for a dense layer.
    The paper evaluates log2 with floor (Table 6 reproduces exactly).
    """
    return int(b_x + b_w + 1 + math.floor(math.log2(max(fan_in, 1))))


def unsigned_power_save(b: float, acc_bits: float = DEFAULT_ACC_BITS) -> float:
    """Fractional power saved by switching a signed MAC to unsigned (Fig. 12a)."""
    signed = p_mac_signed(b, acc_bits)
    return 1.0 - p_mac_unsigned(b) / signed


# ---------------------------------------------------------------------------
# Network-level accounting
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class MacBreakdown:
    """MAC counts of one forward pass, split by whether a static weight is
    involved (PANN applies) or both operands are activations (PANN does not)."""
    weight_macs: float = 0.0   # weight x activation products
    act_macs: float = 0.0      # activation x activation products (QK^T, AV, ...)

    @property
    def total(self) -> float:
        return self.weight_macs + self.act_macs

    def __add__(self, other: "MacBreakdown") -> "MacBreakdown":
        return MacBreakdown(self.weight_macs + other.weight_macs,
                            self.act_macs + other.act_macs)

    def scale(self, k: float) -> "MacBreakdown":
        return MacBreakdown(self.weight_macs * k, self.act_macs * k)


def network_power_bitflips(
    macs: MacBreakdown,
    *,
    scheme: str,
    bits: Optional[int] = None,
    b_w: Optional[int] = None,
    b_x: Optional[int] = None,
    r: Optional[float] = None,
    b_x_tilde: Optional[int] = None,
    acc_bits: float = DEFAULT_ACC_BITS,
) -> float:
    """Total forward-pass power (bit flips) of a network under a scheme.

    Schemes:
      'signed'    — regular signed quantized MACs at ``bits`` (or b_w/b_x mixed).
      'unsigned'  — after the Sec.-4 conversion, at ``bits``.
      'pann'      — PANN weights (R additions, b~x-bit activations); the
                    act x act MACs are charged as unsigned MACs at b~x.
    """
    if scheme == "signed":
        if b_w is not None and b_x is not None:
            per_mac = p_mac_mixed_signed(b_w, b_x, acc_bits)
        else:
            assert bits is not None
            per_mac = p_mac_signed(bits, acc_bits)
        return macs.total * per_mac
    if scheme == "unsigned":
        assert bits is not None
        return macs.total * p_mac_unsigned(bits)
    if scheme == "pann":
        assert r is not None and b_x_tilde is not None
        weight_part = macs.weight_macs * p_pann(r, b_x_tilde)
        act_part = macs.act_macs * p_mac_unsigned(b_x_tilde)
        return weight_part + act_part
    raise ValueError(f"unknown scheme {scheme!r}")


def giga(x: float) -> float:
    return x / 1e9


# ---------------------------------------------------------------------------
# Per-request energy accounting (serving)
# ---------------------------------------------------------------------------

def pann_token_bitflips(macs_per_token: MacBreakdown, r: float,
                        b_x_tilde: int) -> float:
    """Estimated bit flips of ONE generated token at a PANN operating point:
    Eq. (13) on the weight MACs plus unsigned-MAC accounting on the act x act
    MACs — the unit the serving engine reports per response."""
    return network_power_bitflips(macs_per_token, scheme="pann", r=r,
                                  b_x_tilde=b_x_tilde)


@dataclasses.dataclass
class EnergyLedger:
    """Running bit-flip account for one request at a fixed operating point.

    The serving engine charges one token per decode step and attaches
    ``report()`` to the response metadata, so every reply carries its own
    estimated energy price. ``breakdown_per_token`` (module path -> bit
    flips per token, e.g. from ``policy.tree_power_per_token``) additionally
    itemizes WHERE the budget went — the per-module view that makes a
    layerwise allocation auditable from the response alone.
    """
    bitflips_per_token: float
    tokens: int = 0
    breakdown_per_token: Optional[dict] = None

    def charge(self, n_tokens: int = 1) -> None:
        self.tokens += n_tokens

    @property
    def total(self) -> float:
        return self.bitflips_per_token * self.tokens

    def report(self) -> dict:
        out = {
            "tokens": self.tokens,
            "est_bitflips_per_token": self.bitflips_per_token,
            "est_gbitflips_per_token": giga(self.bitflips_per_token),
            "est_bitflips_total": self.total,
        }
        if self.breakdown_per_token:
            denom = sum(self.breakdown_per_token.values()) or 1.0
            out["per_module_gbitflips_per_token"] = {
                path: giga(v) for path, v in
                sorted(self.breakdown_per_token.items())}
            out["per_module_share"] = {
                path: round(v / denom, 4) for path, v in
                sorted(self.breakdown_per_token.items())}
        return out


def aggregate_ledgers(ledgers: "Iterable[EnergyLedger]") -> dict:
    """Fleet-level telemetry: fold per-stream ``EnergyLedger`` accounts from
    MANY hosts into one report — total tokens, total realized bit flips,
    and the merged per-module breakdown (module path -> total bit flips).

    The fold is order-deterministic for the caller's iteration order, so a
    fleet that sums hosts in id order and streams in uid order realizes the
    SAME float total on every run — the property the fleet-sim CI gate
    checks EXACTLY against its committed baseline
    (``repro.serve_engine.fleet``, benchmarks/fleet_sim.py).
    """
    tokens = 0
    total = 0.0
    by_module: dict = {}
    for led in ledgers:
        tokens += led.tokens
        total += led.total
        if led.breakdown_per_token:
            for path in sorted(led.breakdown_per_token):
                by_module[path] = by_module.get(path, 0.0) + \
                    led.breakdown_per_token[path] * led.tokens
    out = {
        "tokens": tokens,
        "bitflips_total": total,
        "gbitflips_total": giga(total),
    }
    if by_module:
        out["per_module_bitflips"] = dict(sorted(by_module.items()))
    return out
