"""Section 4 of the paper: the unsigned split W = W+ - W- (port of
``repro.core.unsigned``).

Any linear layer y = Wx + b with non-negative inputs splits exactly into two
unsigned passes (Eq. 5-6): y+ = W+ x, y- = W- x, y = y+ - y-, with
W+ = ReLU(W), W- = ReLU(-W).
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch

Tensor = torch.Tensor


def unsigned_split(w: Tensor) -> Tuple[Tensor, Tensor]:
    """W -> (W+, W-), both non-negative, with W = W+ - W-."""
    return torch.clamp(w, min=0), torch.clamp(-w, min=0)


def unsigned_matmul(x: Tensor, w: Tensor, bias: Optional[Tensor] = None
                    ) -> Tensor:
    """Exactly y = x @ W (+ bias), computed as two unsigned passes."""
    w_pos, w_neg = unsigned_split(w)
    y = x @ w_pos - x @ w_neg
    if bias is not None:
        y = y + bias
    return y


def is_unsigned_exact(x: Tensor, w: Tensor, rtol: float = 1e-5) -> bool:
    """Self-check: the split must match the direct product."""
    return bool(torch.allclose(x @ w, unsigned_matmul(x, w), rtol=rtol,
                               atol=1e-5))
