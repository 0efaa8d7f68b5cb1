"""Section 5.3: quantization-error theory.

Closed forms under the paper's simplistic uniform model
(activations ~ U[0, M_x], weights ~ U[-M_w/2, M_w/2]):

  Eq. (14)  MSE ~= d (sigma_w^2 sigma_ex^2 + sigma_x^2 sigma_ew^2)
  Eq. (16)  MSE_RUQ  = d Mx^2 Mw^2 / 144 * (2^-2bx + 4 * 2^-2bw)
  Eq. (18)  MSE_PANN = d Mx^2 Mw^2 / 144 * (2^-2bx~ + 1/(4R^2))
  Eq. (19)  MSE_PANN(P) with R = P/bx~ - 0.5 substituted.

Plus the numeric optimal-bit-width search the paper runs over Eq. (19), and
Monte-Carlo counterparts used by the tests and Fig.-4 benchmark.
"""
from __future__ import annotations

import math
from typing import Iterable, Tuple

import numpy as np

from repro_torch.core import power as pw


def mse_ruq(d: float, b_x: float, b_w: float,
            m_x: float = 1.0, m_w: float = 1.0) -> float:
    """Eq. (16)."""
    return d * m_x ** 2 * m_w ** 2 / 144.0 * (2.0 ** (-2 * b_x)
                                              + 4.0 * 2.0 ** (-2 * b_w))


def mse_pann(d: float, b_x_tilde: float, r: float,
             m_x: float = 1.0, m_w: float = 1.0) -> float:
    """Eq. (18)."""
    return d * m_x ** 2 * m_w ** 2 / 144.0 * (2.0 ** (-2 * b_x_tilde)
                                              + 1.0 / (4.0 * r * r))


def mse_pann_at_budget(d: float, power: float, b_x_tilde: float,
                       m_x: float = 1.0, m_w: float = 1.0) -> float:
    """Eq. (19): substitute R = P / b_x~ - 0.5."""
    r = pw.pann_r_for_budget(power, b_x_tilde)
    if r <= 0:
        return math.inf
    return mse_pann(d, b_x_tilde, r, m_x, m_w)


def optimal_bx_tilde(power: float, d: float = 1.0,
                     candidates: Iterable[int] = range(2, 9)
                     ) -> Tuple[int, float]:
    """Numerically minimize Eq. (19) over integer activation bit widths."""
    best_b, best_mse = None, math.inf
    for b in candidates:
        m = mse_pann_at_budget(d, power, b)
        if m < best_mse:
            best_b, best_mse = b, m
    assert best_b is not None
    return best_b, best_mse


def mse_ratio_at_budget(b: int, d: float = 1.0) -> float:
    """Fig. 4: MSE_RUQ(b) / MSE_PANN at the same power budget.

    The RUQ uses b_x = b_w = b (its multiplier power is dominated by the max
    anyway); the matched budget is the unsigned MAC power 0.5 b^2 + 4b.
    """
    budget = pw.p_mac_unsigned(b)
    _, m_pann = optimal_bx_tilde(budget, d)
    return mse_ruq(d, b, b) / m_pann


# ---------------------------------------------------------------------------
# Monte-Carlo counterparts (validation instrument)
# ---------------------------------------------------------------------------

def mc_mse_ruq(rng: np.random.Generator, d: int, b_x: int, b_w: int,
               n: int = 2048, m_x: float = 1.0, m_w: float = 1.0,
               dist: str = "uniform") -> float:
    """Monte-Carlo MSE of RUQ on w^T x under the paper's §5.3 model."""
    if dist == "uniform":
        x = rng.uniform(0, m_x, size=(n, d))
        w = rng.uniform(-m_w / 2, m_w / 2, size=(n, d))
    else:  # gaussian weights, ReLU'd gaussian activations
        x = np.maximum(rng.standard_normal((n, d)) * m_x, 0.0)
        w = rng.standard_normal((n, d)) * m_w
    # mid-rise uniform quantizers with the §5.3 step sizes
    gx = m_x / 2 ** b_x if dist == "uniform" else np.abs(x).max() / 2 ** b_x
    gw = m_w / 2 ** b_w if dist == "uniform" else np.abs(w).max() / 2 ** b_w
    xq = np.round(x / gx) * gx
    wq = np.round(w / gw) * gw
    err = (w * x).sum(-1) - (wq * xq).sum(-1)
    return float(np.mean(err ** 2))


def mc_mse_pann(rng: np.random.Generator, d: int, b_x_tilde: int, r: float,
                n: int = 2048, m_x: float = 1.0, m_w: float = 1.0,
                dist: str = "uniform") -> float:
    """Monte-Carlo MSE of PANN weight quantization (Eq. 12) + b~x-bit RUQ."""
    if dist == "uniform":
        x = rng.uniform(0, m_x, size=(n, d))
        w = rng.uniform(-m_w / 2, m_w / 2, size=(n, d))
    else:
        x = np.maximum(rng.standard_normal((n, d)) * m_x, 0.0)
        w = rng.standard_normal((n, d)) * m_w
    gx = m_x / 2 ** b_x_tilde if dist == "uniform" \
        else np.abs(x).max() / 2 ** b_x_tilde
    xq = np.round(x / gx) * gx
    gw = np.abs(w).sum(-1, keepdims=True) / (r * d)   # Eq. (12), per row
    wq = np.round(w / gw) * gw
    err = (w * x).sum(-1) - (wq * xq).sum(-1)
    return float(np.mean(err ** 2))
