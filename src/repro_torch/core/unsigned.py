"""Section 4 of the paper: the unsigned split W = W+ - W- (port of the
serving subset of ``repro.core.unsigned``)."""
from __future__ import annotations

from typing import Tuple

import torch


def unsigned_split(w: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """W -> (W+, W-), both non-negative, with W = W+ - W-."""
    return torch.clamp(w, min=0), torch.clamp(-w, min=0)
