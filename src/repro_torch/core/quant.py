"""The serving subset of the affine activation quantizer (port of
``repro.core.quant``): calibration bounds, (s, z) scalars, level counts and
the encode map.

Every op here is a single correctly rounded fp32 operation (min, max,
subtract, divide, round half to even, clamp), so the port and the JAX
package give the same bits on the same inputs. ``torch.round`` rounds half
to even like ``jnp.round``; ``floor(x + 0.5)`` would not.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch

Tensor = torch.Tensor


def act_range_bounds(x: Tensor, lo: Optional[Tensor] = None,
                     hi: Optional[Tensor] = None, include_zero: bool = True
                     ) -> Tuple[Tensor, Tensor]:
    """Calibration range [lo, hi] of the affine quantizer, as 0-dim tensors
    on ``x``'s device.

    Without ``lo``/``hi``: the tensor's own extremes, optionally extended to
    contain 0. With them: the frozen range, zero-extended when seen; an
    unseen range (lo > hi) falls back to the dynamic extremes WITHOUT the
    zero extension (``repro.core.quant.act_range_bounds``).
    """
    x_lo, x_hi = torch.aminmax(x)
    if lo is None:
        if include_zero:
            x_lo = torch.clamp(x_lo, max=0.0)
            x_hi = torch.clamp(x_hi, min=0.0)
        return x_lo, x_hi
    lo = torch.as_tensor(lo, dtype=x.dtype, device=x.device)
    hi = torch.as_tensor(hi, dtype=x.dtype, device=x.device)
    use = lo <= hi
    if include_zero:
        lo = torch.clamp(lo, max=0.0)
        hi = torch.clamp(hi, min=0.0)
    return torch.where(use, lo, x_lo), torch.where(use, hi, x_hi)


def affine_scale_zp(lo: Tensor, hi: Tensor, n) -> Tuple[Tensor, Tensor]:
    """(s, z) for calibration bounds [lo, hi] and ``n`` levels:
    ``s = max((hi - lo) / n, 1e-12)``, ``z = round(-lo / s)`` — the op
    sequence of ``repro.core.quant.affine_scale_zp``."""
    s = torch.clamp((hi - lo) / n, min=1e-12)
    z = torch.round(-lo / s)
    return s, z


def cap_levels(bits: int, cap: int = 127) -> int:
    """Serving level count of a ``bits``-wide unsigned code: 2^b - 1,
    capped so codes stay int8-safe."""
    return min((1 << int(bits)) - 1, cap)


def affine_encode(x: Tensor, s, z, n) -> Tensor:
    """``clip(round(x / s) + z, 0, n)`` as float-typed exact integers. The
    CUDA matmul kernels inline this op sequence (``rintf(x / s) + z``, IEEE
    division); change both or neither."""
    q = torch.round(x / s) + z
    if isinstance(n, Tensor):
        return torch.minimum(torch.clamp(q, min=0.0), n)
    return torch.clamp(q, 0.0, float(n))
