"""The serving matmul and decode-attention dispatch (port of
``repro.kernels.dispatch``): the single choke point that turns one
module's weight-store leaves into projection outputs.

Backends:

  ``ref``     the plain integer dataflow in PyTorch, on any device.
  ``fused``   the bit-plane kernel (``kernels/pann_matmul``) on planes
              rebuilt from the int8 codes on every call.
  ``packed``  the packed-plane kernel (``kernels/pann_matmul_packed``) on
              the store's ``w_planes_pos``/``w_planes_neg`` uint8 leaves.

Every backend realizes the same integer dataflow, so their fp32 outputs
are bit-identical: affine codes q = clip(round(x/s) + z, 0, n), the exact
integer y = q @ w_q - zcol, then y * s * gamma. ``fused`` and ``packed``
run their kernel's plain version on CPU tensors and launch the kernel on
CUDA tensors; there is no other fallback, and the JAX package's
``:force`` (Pallas interpret mode) has no meaning here and raises.

Every value that differs between rungs — ``plane_shift``, ``act_nlvl``,
the derived (s, z), ``k_nlvl``/``v_nlvl`` — stays a device tensor that the
kernels read, so one step function serves every rung without host syncs.

Under a serving mesh (``dist.local_ops.use_shards``) each rank holds its
shard of every projection. A column-parallel one (wq, wk, wv, w_gate,
w_up, lm_head) runs on its output columns alone, its per-column leaves
sliced with them, and is unchanged column for column. A row-parallel one
(wo, w_down: K sharded) launches its kernel in the accumulator mode (the
int32 sums of its K shard), adds the shards' sums over "model" and then
runs the epilogue with the whole ``zcol``, which holds z * colsum(w) over
all of K and the bias once. The activation quantizer's range is reduced
over the ranks that split the input (``ServeShards.reduce_range``). The
conv stem is whole on every rank, which runs it on its own rows: its
range is reduced over "data". Every step is an integer sum or a min /
max, so the outputs are bit-identical to one rank's.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.core import quant
from repro_torch.core.pann import bitplane_decompose, masked_codes
from repro_torch.dist import local_ops
from repro_torch.kernels import autotune
from repro_torch.kernels import pann_attention as _pa
from repro_torch.kernels import pann_conv as _pc
from repro_torch.kernels import pann_matmul as _pm
from repro_torch.kernels import pann_matmul_packed as _pk
from repro_torch.kernels import ref as _ref
from repro_torch.kernels.ops import _N_MULT, _pad_to

Tensor = torch.Tensor

BACKENDS = ("ref", "fused", "packed")

# int8 serving codes are clipped to +-127 = 2^7 - 1, so 7 planes always
# reconstruct them exactly.
INT8_PLANES = 7

# n = 2^7 - 1: the kernels hold unsigned codes in [0, 127] (the paper's
# App.-A.4 half-range convention).
HALF_RANGE_LEVELS = 127.0


def parse_backend(spec: str) -> str:
    """'fused' -> 'fused'. Options after ':' (the JAX package's ':force')
    are refused: the port has no interpret mode."""
    name, sep, opt = spec.partition(":")
    if sep:
        raise ValueError(f"backend option {opt!r} in {spec!r} has no meaning "
                         "in the port: CPU tensors run the plain versions, "
                         "CUDA tensors the kernels")
    if name not in BACKENDS:
        raise ValueError(f"unknown kernel backend {name!r}; have {BACKENDS}")
    return name


def resolve_backend(spec: str, p: dict) -> str:
    """The backend for artifact ``p``; 'packed' without plane leaves is a
    build error, raised."""
    name = parse_backend(spec)
    if name == "packed" and "w_planes_pos" not in p:
        raise ValueError(
            "backend 'packed' needs the w_planes_pos/w_planes_neg leaves; "
            "build the store with ServingQuantSpec(pack_planes=True)")
    return name


def _scalar(x: Tensor, like: Tensor) -> Tensor:
    return x.to(device=like.device, dtype=torch.float32).reshape(())


def _act_scalars(xf: Tensor, p: dict, shards=None,
                 k_sharded: bool = False) -> tuple[Tensor, Tensor, Tensor]:
    """(s, z, n_lvl) of the projection's activation quantizer as 0-dim
    device tensors: the view's ``act_nlvl`` level count (127, the
    half-range ceiling, when the view has none), and the frozen-calibration
    ``act_s``/``act_z`` leaves when present (stores carried across from the
    JAX package may hold them), else (s, z) derived from x: under a
    serving mesh (``shards``) from the range of the whole input, reduced
    over the ranks that split it (``k_sharded``: a row-parallel input)."""
    nlvl = p.get("act_nlvl")
    n_lvl = (_scalar(nlvl, xf) if nlvl is not None
             else xf.new_full((), HALF_RANGE_LEVELS))
    if p.get("act_s") is not None:
        return _scalar(p["act_s"], xf), _scalar(p["act_z"], xf), n_lvl
    lo, hi = quant.act_range_bounds(xf, include_zero=True)
    if shards is not None:
        lo, hi = shards.reduce_range(lo, hi, model=k_sharded)
    s, z = quant.affine_scale_zp(lo, hi, n_lvl)
    return s, z, n_lvl


def _gamma_zcol(p: dict, s: Tensor, z: Tensor) -> tuple[Tensor, Tensor]:
    """(gamma, zcol): the per-output-channel dequant scale and the exact
    int32 zero-point/bias row z*colsum(w) - round(b / (s*gamma)), with the
    view's precomputed colsum of the codes its kernels realize."""
    gamma = p["w_scale"].to(torch.float32).reshape(-1)
    zcol = z.to(torch.int32) * p["w_colsum"]
    if "b" in p:
        b_q = torch.clamp(torch.round(p["b"].to(torch.float32) / (s * gamma)),
                          -2.0 ** 30, 2.0 ** 30).to(torch.int32)
        zcol = zcol - b_q
    return gamma, zcol


def _pad_columns(pos: Tensor, neg: Tensor, gamma: Tensor,
                 zcol: Tensor) -> tuple:
    """The B1/B2 operands with N zero-padded up to the kernels' multiple
    of 4 (each output column is computed on its own, so the real columns
    are unchanged and the padded ones are sliced away); a no-op, no copy,
    for every width served so far."""
    return (_pad_to(pos, _N_MULT, 2).contiguous(),
            _pad_to(neg, _N_MULT, 2).contiguous(),
            _pad_to(gamma, _N_MULT, 0), _pad_to(zcol, _N_MULT, 0))


def _kernel_operands(xf: Tensor, p: dict, s: Tensor, z: Tensor,
                     n_lvl: Tensor, gamma: Tensor, zcol: Tensor,
                     name: str) -> tuple:
    """The operands of backend ``name``'s kernel ('fused' | 'packed'):
    (x, pos, neg, qparams, gamma, zcol), x padded to the packed planes'
    K, N padded to the kernels' multiple of 4."""
    w_q = p["w_q"]
    shift = (_scalar(p["plane_shift"], xf) if "plane_shift" in p
             else xf.new_zeros(()))
    qparams = torch.stack([s, z, n_lvl, shift])
    if name == "fused":
        n_planes = (p["w_planes_pos"].shape[-3] if "w_planes_pos" in p
                    else INT8_PLANES)
        pos = bitplane_decompose(torch.clamp(w_q, min=0), n_planes)
        neg = bitplane_decompose(torch.clamp(-w_q.to(torch.int32), min=0),
                                 n_planes)
    else:
        pos, neg = p["w_planes_pos"], p["w_planes_neg"]
        k_full = pos.shape[-2] * 8      # pack_planes padded K up to 8
        if xf.shape[1] != k_full:
            xf = F.pad(xf, (0, k_full - xf.shape[1]))
    pos, neg, gamma, zcol = _pad_columns(pos, neg, gamma, zcol)
    return xf, pos, neg, qparams, gamma, zcol


def _kernel(name: str):
    """The kernel wrapper behind backend ``name`` ('fused' | 'packed')."""
    return _pm.pann_matmul_act if name == "fused" else \
        _pk.pann_matmul_packed_act


def _dispatch_rows(xf: Tensor, p: dict, s: Tensor, z: Tensor,
                   n_lvl: Tensor, gamma: Tensor, zcol: Tensor,
                   name: str) -> Tensor:
    """The backend branch on fixed scalars: (M, K) fp32 rows in, (M, N)
    fp32 out. ``plane_shift`` (the view's count of skipped low planes) is a
    device tensor: the kernels read it, the 'ref' path masks the codes. A
    single-point artifact has no such leaf and runs at shift 0."""
    w_q = p["w_q"]
    if name != "ref":
        return _kernel(name)(*_kernel_operands(xf, p, s, z, n_lvl, gamma,
                                                zcol, name))[:, :w_q.shape[-1]]
    shift = (_scalar(p["plane_shift"], xf) if "plane_shift" in p
             else xf.new_zeros(()))
    q = quant.affine_encode(xf, s, z, n_lvl)
    return _pm.matmul_epilogue(q, masked_codes(w_q, shift), s, gamma, zcol)


def _row_parallel_rows(xf: Tensor, p: dict, s: Tensor, z: Tensor,
                       n_lvl: Tensor, gamma: Tensor, zcol: Tensor,
                       name: str, shards) -> Tensor:
    """``_dispatch_rows`` of a row-parallel projection's K shard: its int32
    sums (the kernels' accumulator mode on 'fused' / 'packed'), added over
    "model", then the epilogue ``(sums - zcol) * s * gamma`` (the epilogue
    entry on the kernels' backends) with the whole ``zcol``."""
    w_q = p["w_q"]
    if name == "ref":
        shift = (_scalar(p["plane_shift"], xf) if "plane_shift" in p
                 else xf.new_zeros(()))
        q = quant.affine_encode(xf, s, z, n_lvl)
        sums = _ref.int_matmul(q, masked_codes(w_q, shift))
        shards.sum_model(sums)
        return _pm.epilogue(sums, s, gamma, zcol)
    x, pos, neg, qparams, gamma, zcol = _kernel_operands(
        xf, p, s, z, n_lvl, gamma, zcol, name)
    sums = (_pm.pann_matmul_act_acc(x, pos, neg, qparams) if name == "fused"
            else _pk.pann_matmul_packed_act_acc(x, pos, neg, qparams))
    shards.sum_model(sums)
    return _pm.pann_epilogue(sums, qparams, gamma, zcol)[:, :w_q.shape[-1]]


def serving_linear(x: Tensor, p: dict, backend: str,
                   path: str | None = None) -> Tensor:
    """The serving projection y = affine-quant(x) @ deq(w_q) [+ b] through
    the selected backend; ``p`` is one rung view's (K, N) leaves. Output
    dtype follows x. Under a serving mesh ``p`` holds the rank's shard and
    ``path`` (the module's, "attn.wo", ...) says whether it is
    row-parallel."""
    name = resolve_backend(backend, p)
    w_q = p["w_q"]
    if w_q.ndim != 2:
        raise ValueError(f"serving_linear wants a (K, N) weight, got "
                         f"{tuple(w_q.shape)}")
    lead, k = x.shape[:-1], x.shape[-1]
    xf = x.reshape(-1, k).to(torch.float32).contiguous()
    shards = local_ops.current_shards()
    row = shards is not None and shards.model > 1 \
        and local_ops.row_parallel(path)
    s, z, n_lvl = _act_scalars(xf, p, shards, k_sharded=row)
    gamma, zcol = _gamma_zcol(p, s, z)
    if row:
        y = _row_parallel_rows(xf, p, s, z, n_lvl, gamma, zcol, name,
                               shards)
    else:
        y = _dispatch_rows(xf, p, s, z, n_lvl, gamma, zcol, name)
    return y.reshape(*lead, w_q.shape[-1]).to(x.dtype)


def _conv_input(x: Tensor, p: dict, spec):
    """The padded fp32 input of a conv projection and its quantizer:
    (xpad, s, z, n_lvl, gamma, zcol). The activation scalars come from the
    padded input tensor, not from the patch rows (the reference's one
    deliberate divergence from ``serving_linear``: a strided geometry may
    leave pixels out of every patch, and the quantizer stays a function of
    the tensor alone). Under a serving mesh the stem is whole on every
    rank and ``x`` holds the rank's rows: the range is reduced over
    "data"."""
    xpad = _pc.pad_nhwc(x.to(torch.float32), spec.ph, spec.pw).contiguous()
    s, z, n_lvl = _act_scalars(xpad.reshape(-1, xpad.shape[-1]), p,
                               local_ops.current_shards())
    gamma, zcol = _gamma_zcol(p, s, z)
    return xpad, s, z, n_lvl, gamma, zcol


def serving_conv(x: Tensor, p: dict, spec, backend: str) -> Tensor:
    """The serving conv projection: im2col over the serving matmuls.
    ``x``: (B, H, W, Cin) fp input; ``p``: one rung view's leaves with the
    kernel flat as a (kh*kw*Cin, Cout) ``w_q``; ``spec``: the static
    geometry (``configs.base.ConvSpec``). The patch rows go through the
    same backend branch as a linear's (B1 on 'fused', B2 on 'packed', whose
    packed planes pad K up to a multiple of 8). Returns (B, Ho, Wo, Cout)
    in x's dtype."""
    name = resolve_backend(backend, p)
    w_q = p["w_q"]
    if w_q.ndim != 2 or x.ndim != 4:
        raise ValueError(f"serving_conv wants a (K, N) weight and a "
                         f"(B, H, W, C) input, got {tuple(w_q.shape)} and "
                         f"{tuple(x.shape)}")
    xpad, s, z, n_lvl, gamma, zcol = _conv_input(x, p, spec)
    patches = _pc.extract_patches(xpad, spec.kh, spec.kw, spec.sh, spec.sw)
    b, ho, wo, k = patches.shape
    y = _dispatch_rows(patches.reshape(-1, k), p, s, z, n_lvl, gamma, zcol,
                       name)
    return y.reshape(b, ho, wo, w_q.shape[-1]).to(x.dtype)


def serving_conv_oracle(x: Tensor, p: dict, spec) -> Tensor:
    """The integer convolution oracle of ``serving_conv``: the same
    quantizer and zcol row, but the integer sums run through an exact
    float64 convolution of the codes (``pann_conv.conv_exact``) instead of
    im2col and a matmul. Every backend of ``serving_conv`` equals it bit
    for bit. cuDNN is off for the call, so no FFT or Winograd algorithm
    can round the float64 sums."""
    w_q = p["w_q"]
    xpad, s, z, n_lvl, gamma, zcol = _conv_input(x, p, spec)
    q = quant.affine_encode(xpad, s, z, n_lvl)
    shift = (_scalar(p["plane_shift"], xpad) if "plane_shift" in p
             else xpad.new_zeros(()))
    with torch.backends.cudnn.flags(enabled=False):
        y_int = _pc.conv_exact(q, masked_codes(w_q, shift), spec.kh,
                               spec.kw, spec.sh, spec.sw)
    return _pm.epilogue(y_int, s, gamma, zcol).to(x.dtype)


def cache_planes_active(n_lvl) -> Tensor:
    """Live LOW bit-planes of a cache code space with ``n_lvl`` levels:
    codes <= n_lvl < 2^b zero every plane >= b = log2(n_lvl + 1)."""
    n = n_lvl.to(torch.float32).reshape(())
    return torch.ceil(torch.log2(n + 1.0) - 1e-6)


def decode_attention(q: Tensor, kv, backend, *, num_kv_heads: int,
                     window=None, softcap: float = 0.0,
                     k_nlvl=None, v_nlvl=None) -> Tensor:
    """Decode attention over a quantized KV cache. ``q``: (B, H, hd) fp
    queries (RoPE applied); ``kv``: a ``models.attention.QuantKVCache``.

    Queries are affine-quantized per tensor at the half-range ceiling;
    'fused'/'packed' both name the one bit-plane attention kernel, 'ref'
    the plain version. ``k_nlvl``/``v_nlvl`` (0-dim device tensors) let the
    kernel skip the dead high planes. Returns (B, H, hd) fp32."""
    name = parse_backend(backend or "ref")
    b, h, hd = q.shape
    g = h // num_kv_heads
    qf = q.to(torch.float32).reshape(b, num_kv_heads, g, hd)
    n127 = qf.new_full((), HALF_RANGE_LEVELS)
    lo, hi = quant.act_range_bounds(qf, include_zero=True)
    shards = local_ops.current_shards()
    if shards is not None:      # the range of every rank's heads and rows
        lo, hi = shards.reduce_range(lo, hi, model=True)
    s_q, z_q = quant.affine_scale_zp(lo, hi, n127)
    q_scale = s_q * qf.new_full((), float(hd) ** -0.5)
    qq = quant.affine_encode(qf, s_q, z_q, n127).to(torch.int32).contiguous()
    args = (qq, z_q, q_scale, kv.k_planes, kv.k_s, kv.k_z,
            kv.v_planes, kv.v_s, kv.v_z, kv.length)
    if name == "ref":
        out = _ref.decode_attention_ref(*args, window=window,
                                        softcap=softcap)
    else:
        k_pact = None if k_nlvl is None else cache_planes_active(k_nlvl)
        v_pact = None if v_nlvl is None else cache_planes_active(v_nlvl)
        out = _pa.decode_attention(*args, k_pact, v_pact, window=window,
                                   softcap=softcap)
    return out.reshape(b, h, hd)


# ---------------------------------------------------------------------------
# Offline split autotuning (ServeEngine(autotune=True) / launch --autotune)
# ---------------------------------------------------------------------------

def tune_projection(m: int, p: dict, backend: str,
                    planes_active: int | None = None) -> None:
    """Measure and cache the best K split of one projection's kernel at
    decode row count ``m`` (``kernels.autotune``): 'fused' tunes B1's
    prologue kernel, 'packed' B2's, 'ref' has nothing to tune. The
    operands are those ``serving_linear`` hands the kernel, on seeded
    rows on the store's device. Offline: call before ``warmup``, whose
    captures then read the cached split (``autotune.params_for``). On the
    CPU the heuristic is recorded untimed.

    ``planes_active`` keys a single-point tuning run whose live plane
    count is static; the ladder leaves it None (one kernel serves every
    rung, the shift is data), so its launches key on the full plane
    count."""
    name = parse_backend(backend)
    if name == "ref":
        return
    resolve_backend(name, p)
    w_q = p["w_q"]
    if w_q.ndim != 2:
        raise ValueError(f"tune_projection wants a (K, N) weight, got "
                         f"{tuple(w_q.shape)}")
    gen = torch.Generator(device=w_q.device)
    gen.manual_seed(0)
    xf = torch.randn((m, w_q.shape[0]), generator=gen, device=w_q.device)
    s, z, n_lvl = _act_scalars(xf, p)
    gamma, zcol = _gamma_zcol(p, s, z)
    ops = _kernel_operands(xf, p, s, z, n_lvl, gamma, zcol, name)
    x, pos = ops[0], ops[1]
    autotune.tune(m, x.shape[1], pos.shape[-1], pos.shape[0], name,
                  lambda params: _kernel(name)(*ops, params=params),
                  active=planes_active, device=w_q.device)
