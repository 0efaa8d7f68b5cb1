"""Shared layers of the serving path (port of ``repro.models.layers``):
norms, the embedding gather and the tied head, logit soft-capping, and the
projection choke point that routes every quantized weight through
``kernels.dispatch``.

Parameters are plain dicts of tensors, laid out as in the JAX package so
the two can be compared leaf for leaf.
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.kernels import dispatch

Tensor = torch.Tensor


def rmsnorm(x: Tensor, scale: Tensor, eps: float = 1e-6) -> Tensor:
    var = torch.mean(torch.square(x.to(torch.float32)), dim=-1, keepdim=True)
    y = x * torch.rsqrt(var + eps)
    return (y * (1.0 + scale)).to(x.dtype)


def layernorm(x: Tensor, scale: Tensor, bias: Tensor,
              eps: float = 1e-5) -> Tensor:
    """The reference's op order: fp32 mean, biased variance,
    rsqrt(var + eps), then y * scale + bias."""
    xf = x.to(torch.float32)
    mu = torch.mean(xf, dim=-1, keepdim=True)
    var = torch.mean(torch.square(xf - mu), dim=-1, keepdim=True)
    y = (xf - mu) * torch.rsqrt(var + eps)
    return (y * scale + bias).to(x.dtype)


def apply_norm(x: Tensor, params: dict, kind: str) -> Tensor:
    if kind == "layernorm":
        return layernorm(x, params["scale"], params["bias"])
    return rmsnorm(x, params["scale"])


def init_norm(d: int, kind: str, device) -> dict:
    if kind == "layernorm":
        return {"scale": torch.ones((d,), dtype=torch.float32, device=device),
                "bias": torch.zeros((d,), dtype=torch.float32,
                                    device=device)}
    return {"scale": torch.zeros((d,), dtype=torch.float32, device=device)}


def softcap(x: Tensor, cap: float) -> Tensor:
    """Gemma-2 logit soft-capping: cap * tanh(x / cap)."""
    if cap <= 0:
        return x
    return cap * torch.tanh(x / x.new_full((), float(cap)))


def module_quant(cfg, path: str):
    """The quant spec of the module at ``path``: the global ``cfg.quant``,
    or the policy tree's entry when the config carries one."""
    if cfg.policy is None:
        return cfg.quant
    return cfg.policy.lookup(path)


def project(x: Tensor, p: dict, cfg, path: str) -> Tensor:
    """The one-call projection idiom: every model projection goes through
    here with the configured kernel backend."""
    return apply_linear(x, p, module_quant(cfg, path),
                        backend=cfg.kernel_backend, path=path)


def init_linear(gen: torch.Generator, d_in: int, d_out: int, device,
                bias: bool = False, scale: Optional[float] = None) -> dict:
    scale = scale if scale is not None else d_in ** -0.5
    p = {"w": torch.randn((d_in, d_out), generator=gen, dtype=torch.float32,
                          device=device) * scale}
    if bias:
        p["b"] = torch.zeros((d_out,), dtype=torch.float32, device=device)
    return p


def apply_linear(x: Tensor, p: dict, qc=None, backend: Optional[str] = None,
                 path: Optional[str] = None) -> Tensor:
    """The projection entry point. The port serves quantized weight stores
    only: a module with ``w_q`` leaves runs through the selected kernel
    backend (``kernels.dispatch.serving_linear``). The JAX package's float
    and fake-quant (training) branches, which ``qc`` selects there, are not
    ported yet."""
    if "w_q" in p and backend is not None:
        return dispatch.serving_linear(x, p, backend)
    mode = getattr(qc, "mode", None)
    raise ValueError(
        f"module {path!r} (quant mode {mode!r}): the port serves weight-store "
        "leaves (w_q) through a kernel backend ('ref' | 'fused' | 'packed'); "
        "the float and QAT projection paths are not ported yet")


def init_embedding(gen: torch.Generator, vocab: int, d: int, device) -> dict:
    return {"table": torch.randn((vocab, d), generator=gen,
                                 dtype=torch.float32, device=device) * 0.02}


def embed(tokens: Tensor, p: dict, dtype) -> Tensor:
    return p["table"].to(dtype)[tokens]


def unembed(x: Tensor, p: dict, qc) -> Tensor:
    """The tied LM head: x @ table.T. The reference routes it through
    ``qlinear`` at ``qc``'s mode, which the serve engine leaves at "none",
    so it is a float matmul over the embedding table (kept in fp32 by the
    weight store); the fake-quant modes come with ROADMAP A3."""
    mode = getattr(qc, "mode", None)
    if mode != "none":
        raise ValueError(
            f"tied lm_head at quant mode {mode!r}: only mode 'none' (the "
            "float matmul) is ported; the ruq / ruq_unsigned / pann "
            "projections are ROADMAP A3")
    return x @ p["table"].t().to(x.dtype)
