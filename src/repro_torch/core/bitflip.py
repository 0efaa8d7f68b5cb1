"""Bit-flip (switching-activity) simulators, vectorized with NumPy.

These reproduce the paper's "Python simulation" (App. A.2): dynamic power is
proportional to the number of bit toggles between consecutive instructions, so
we simulate the register/adder-input states of

  * a serial (long-multiplication) multiplier,
  * a radix-2 Booth-encoded multiplier,
  * a serial accumulator (adder + FF register),

and count `popcount(state_t XOR state_{t-1})` over all state words.

Conventions (matching App. A.2/A.4):
  * signed operands are drawn from [-2^(b-1), 2^(b-1)),
  * unsigned operands from [0, 2^(b-1)) — half range, so the *same* signed
    multiplier architecture can be reused (App. A.4),
  * a b_w x b_x multiply is simulated on a b x b multiplier with
    b = max(b_w, b_x); the *selecting* (recoded) operand is the activation and
    the *added* word is the weight, per the paper's long-multiplication
    description ("each bit of the multiplicand multiplies the multiplier word").

The simulators are the measurement instrument; the closed-form models the
paper fits to them live in ``repro.core.power``.
"""
from __future__ import annotations

import dataclasses
from typing import Literal

import numpy as np

MultKind = Literal["serial", "booth"]


def _mask(width: int) -> int:
    return (1 << width) - 1


def popcount_xor(prev: np.ndarray, curr: np.ndarray, width: int) -> np.ndarray:
    """Per-element toggle count between two register states of ``width`` bits."""
    diff = np.bitwise_xor(prev, curr) & np.int64(_mask(width))
    return np.bitwise_count(diff.astype(np.uint64))


# ---------------------------------------------------------------------------
# Operand sampling
# ---------------------------------------------------------------------------

def draw_uniform_signed(rng: np.random.Generator, bits: int, n: int) -> np.ndarray:
    return rng.integers(-(1 << (bits - 1)), 1 << (bits - 1), size=n, dtype=np.int64)


def draw_uniform_unsigned(rng: np.random.Generator, bits: int, n: int) -> np.ndarray:
    # Half range [0, 2^(b-1)) so the signed architecture is reused (App. A.4).
    return rng.integers(0, 1 << (bits - 1), size=n, dtype=np.int64)


def draw_gaussian(rng: np.random.Generator, bits: int, n: int,
                  signed: bool = True) -> np.ndarray:
    """App. A.2: N(0,1) scaled to the b-bit range, rounded, clipped."""
    z = rng.standard_normal(n)
    z = z / np.max(np.abs(z))
    if signed:
        v = np.clip(np.rint(z * (1 << (bits - 1))), -(1 << (bits - 1)),
                    (1 << (bits - 1)) - 1)
    else:
        v = np.clip(np.rint(np.abs(z) * ((1 << (bits - 1)) - 1)), 0,
                    (1 << (bits - 1)) - 1)
    return v.astype(np.int64)


# ---------------------------------------------------------------------------
# Multiplier
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class MultiplierStats:
    internal_toggles: float   # adder-array inputs (partial-product rows)
    input_toggles: float      # the two operand registers
    n_ops: int

    @property
    def total(self) -> float:
        return self.internal_toggles + self.input_toggles


def _booth_digits(x: np.ndarray, bits: int) -> np.ndarray:
    """Radix-2 Booth recoding digits d_i = x_{i-1} - x_i in {-1, 0, +1}.

    Returns an array of shape (n, bits) of int64 digits.
    """
    xu = (x & np.int64(_mask(bits))).astype(np.uint64)
    shifts = np.arange(bits, dtype=np.uint64)
    cur = ((xu[:, None] >> shifts) & np.uint64(1)).astype(np.int64)
    prev = np.concatenate(
        [np.zeros((x.shape[0], 1), dtype=np.int64), cur[:, :-1]], axis=1)
    return prev - cur


def _serial_digits(x: np.ndarray, bits: int) -> np.ndarray:
    """Plain long-multiplication digits: bit i of x, in {0, 1}."""
    xu = (x & np.int64(_mask(bits))).astype(np.uint64)
    shifts = np.arange(bits, dtype=np.uint64)
    return ((xu[:, None] >> shifts) & np.uint64(1)).astype(np.int64)


def simulate_multiplier(
    w: np.ndarray,
    x: np.ndarray,
    b_w: int,
    b_x: int,
    kind: MultKind = "booth",
) -> MultiplierStats:
    """Count toggles across a stream of multiplies w[t] * x[t].

    The simulated array is b x b with b = max(b_w, b_x). The partial-product
    rows (the adder-array inputs) are registered as 2b-bit two's-complement
    words; the operand registers are b_w / b_x bits.
    """
    assert w.shape == x.shape
    b = max(b_w, b_x)
    out_bits = 2 * b

    digits = (_booth_digits if kind == "booth" else _serial_digits)(x, b)
    # rows[t, i] = (d_i * w) << i, as a 2b-bit word.
    rows = (digits * w[:, None]) << np.arange(b, dtype=np.int64)[None, :]
    rows &= np.int64(_mask(out_bits))

    internal = popcount_xor(rows[:-1], rows[1:], out_bits).sum(axis=1)
    inp = (popcount_xor(w[:-1], w[1:], b_w)
           + popcount_xor(x[:-1], x[1:], b_x))
    n = w.shape[0] - 1
    return MultiplierStats(float(internal.sum()) / n, float(inp.sum()) / n, n)


# ---------------------------------------------------------------------------
# Accumulator
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class AccumulatorStats:
    input_toggles: float   # toggles at the adder input fed by the multiplier
    sum_toggles: float     # toggles at the adder output
    ff_toggles: float      # toggles in the FF register holding the sum
    n_ops: int

    @property
    def total(self) -> float:
        return self.input_toggles + self.sum_toggles + self.ff_toggles


def simulate_accumulator(addends: np.ndarray, acc_bits: int = 32,
                         count_input_changes: np.ndarray | None = None
                         ) -> AccumulatorStats:
    """Count toggles of a B-bit accumulator over a stream of addends.

    ``count_input_changes``: optional bool mask, True where the adder *input*
    register is rewritten before op t (PANN holds the input fixed for Q_w(w_i)
    consecutive additions, so only d of the R*d additions rewrite it).
    """
    a = addends.astype(np.int64)
    sums = np.cumsum(a.astype(object)) if acc_bits > 62 else np.cumsum(a)
    sums = (np.asarray(sums, dtype=np.int64)) & np.int64(_mask(acc_bits))

    inp = popcount_xor(a[:-1], a[1:], acc_bits)
    if count_input_changes is not None:
        inp = inp * count_input_changes[1:].astype(np.int64)
    s_tog = popcount_xor(sums[:-1], sums[1:], acc_bits)
    n = a.shape[0] - 1
    return AccumulatorStats(float(inp.sum()) / n, float(s_tog.sum()) / n,
                            float(s_tog.sum()) / n, n)


# ---------------------------------------------------------------------------
# End-to-end streams
# ---------------------------------------------------------------------------

def simulate_mac_stream(w: np.ndarray, x: np.ndarray, b_w: int, b_x: int,
                        acc_bits: int = 32, kind: MultKind = "booth"
                        ) -> float:
    """Average bit flips per MAC of the full multiply-accumulate datapath."""
    mult = simulate_multiplier(w, x, b_w, b_x, kind=kind)
    acc = simulate_accumulator(w * x, acc_bits)
    return mult.total + acc.total


def simulate_pann_stream(w_q: np.ndarray, x_q: np.ndarray, acc_bits: int = 32
                         ) -> tuple[float, float]:
    """Simulate PANN's Eq. (11): each product w_q[i] * x_q[i] is realized as
    w_q[i] repeated additions of x_q[i] (w_q must be non-negative ints).

    Returns (bit flips per input element, average additions per element R).
    """
    assert np.all(w_q >= 0)
    reps = w_q.astype(np.int64)
    addends = np.repeat(x_q.astype(np.int64), reps)
    # The accumulator input register is rewritten only when moving to the next
    # input element (d times in total).
    changes = np.zeros(addends.shape[0], dtype=bool)
    changes[np.cumsum(reps)[:-1][reps[:-1] > 0]] = True
    changes[0] = True
    acc = simulate_accumulator(addends, acc_bits, count_input_changes=changes)
    d = w_q.shape[0]
    n_adds = addends.shape[0]
    per_element = acc.total * (n_adds - 1) / max(d, 1)
    return per_element, n_adds / max(d, 1)
