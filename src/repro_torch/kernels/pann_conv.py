"""Conv projections as im2col over the serving matmuls (port of
``repro.kernels.pann_conv``).

A conv layer's kernel is stored flat as a (kh*kw*Cin, Cout) weight, which
the weight store quantizes, packs and views like any linear; the input is
expanded to patch rows at run time and the rows go through the same B1 /
B2 kernels as a linear's. Why this is exact: the activations are encoded
with ranges that include zero, so a zero-padded fp border encodes to the
zero point z, which the int32 ``zcol`` correction cancels; patch
extraction is a gather, so it commutes with the encode; and the patch
matmul and the convolution sum the same integer products.

Feature order is the one layout contract: patch feature
``(di*kw + dj)*Cin + c`` <-> ``w_flat.reshape(kh, kw, Cin, Cout)`` (HWIO).
Plain PyTorch, no dispatch import (dispatch imports this module).
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

Tensor = torch.Tensor


def conv_out_size(size: int, k: int, stride: int, pad: int) -> int:
    """Output extent of a VALID conv over a ``pad``-padded input."""
    out = (size + 2 * pad - k) // stride + 1
    if out < 1:
        raise ValueError(
            f"conv geometry yields empty output: size={size} k={k} "
            f"stride={stride} pad={pad}")
    return out


def pad_nhwc(x: Tensor, ph: int, pw: int) -> Tensor:
    """Zero-pad the spatial dims of a (B, H, W, C) input, in fp before the
    activation encode, so the border lands on the zero point exactly."""
    if ph == 0 and pw == 0:
        return x
    return F.pad(x, (0, 0, pw, pw, ph, ph))


def extract_patches(xpad: Tensor, kh: int, kw: int, sh: int, sw: int
                    ) -> Tensor:
    """im2col: (B, Hp, Wp, C) -> (B, Ho, Wo, kh*kw*C) patch rows, the
    feature axis ordered (di, dj, c), as kh*kw strided slices and one
    concat."""
    _, hp, wp, _ = xpad.shape
    ho = (hp - kh) // sh + 1
    wo = (wp - kw) // sw + 1
    slabs = [xpad[:, di:di + sh * (ho - 1) + 1:sh,
                  dj:dj + sw * (wo - 1) + 1:sw, :]
             for di in range(kh) for dj in range(kw)]
    return torch.cat(slabs, dim=-1)


def conv_exact(q: Tensor, w_flat: Tensor, kh: int, kw: int, sh: int,
               sw: int) -> Tensor:
    """Exact integer VALID convolution of code tensors, the oracle's core:
    ``F.conv2d`` in float64 on the integer codes, exact because every
    partial sum is an integer below 2^53 (|code| <= 127 on both sides, so
    a sum of K products stays below 2^14 * K). ``q``: (B, Hp, Wp, Cin)
    integer codes, already padded; ``w_flat``: (kh*kw*Cin, Cout) integer
    weight codes. Returns (B, Ho, Wo, Cout) int64, equal to
    ``extract_patches(q) @ w_flat``."""
    c_in = q.shape[-1]
    w4 = w_flat.to(torch.float64).reshape(kh, kw, c_in, -1)
    y = F.conv2d(q.to(torch.float64).permute(0, 3, 1, 2),
                 w4.permute(3, 2, 0, 1), stride=(sh, sw))
    return y.permute(0, 2, 3, 1).to(torch.int64)
