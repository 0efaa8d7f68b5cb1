"""Compressed cross-replica gradient reduction (port of
``repro.dist.collectives``).

``compressed_psum_mean`` stands for an int8 wire format of the
data-parallel gradient all-reduce with error feedback (Karimireddy et
al., 2019): each round adds the residual it failed to transmit last
round before quantizing, so the quantization bias telescopes away. Every
rank of ``group`` calls it with its own shard of the gradients (the
reference runs it inside ``shard_map`` over the reduction axis).
"""
from __future__ import annotations

from typing import Any, Optional

import torch
import torch.distributed as dist

_WIRE_MAX = 127.0  # int8 symmetric code range


def _compress_one(g: torch.Tensor, err: torch.Tensor, group=None
                  ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(mean over ``group``, this rank's new residual, its int8 wire
    codes) of one gradient leaf."""
    val = g.to(torch.float32) + err.to(torch.float32)
    # a shared scale (one scalar all-reduce MAX), so every rank's codes
    # dequantize alike and the mean of the codes is the code of the mean
    amax = torch.amax(torch.abs(val))
    dist.all_reduce(amax, op=dist.ReduceOp.MAX, group=group)
    wire = torch.tensor(_WIRE_MAX, dtype=torch.float32, device=val.device)
    scale = torch.clamp(amax, min=1e-30) / wire
    # torch.round rounds half to even, as jnp.round
    codes = torch.clamp(torch.round(val / scale), -_WIRE_MAX, _WIRE_MAX)
    codes = codes.to(torch.int8)                       # the wire payload
    deq = codes.to(torch.float32) * scale
    total = deq.clone()
    dist.all_reduce(total, op=dist.ReduceOp.SUM, group=group)
    n = torch.tensor(float(dist.get_world_size(group)), dtype=torch.float32,
                     device=val.device)
    mean = total / n
    new_err = val - deq                                # residual stays local
    return mean.to(g.dtype), new_err.to(err.dtype), codes


def compressed_psum_mean(grads: Any, err: Any, group: Optional[Any] = None
                         ) -> tuple[Any, Any]:
    """int8-compressed mean over ``group`` (a process group; the default
    group when None) with error feedback.

    ``grads`` / ``err`` are matching trees of this rank's tensors. Returns
    (the mean tree, the same on every rank; this rank's new error-feedback
    tree)."""
    if isinstance(grads, dict):
        pairs = {k: compressed_psum_mean(v, err[k], group)
                 for k, v in grads.items()}
        return ({k: p[0] for k, p in pairs.items()},
                {k: p[1] for k, p in pairs.items()})
    if isinstance(grads, (list, tuple)):
        pairs = [compressed_psum_mean(v, e, group)
                 for v, e in zip(grads, err, strict=True)]
        return (type(grads)(p[0] for p in pairs),
                type(grads)(p[1] for p in pairs))
    mean, new_err, _ = _compress_one(grads, err, group)
    return mean, new_err
