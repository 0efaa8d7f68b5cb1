"""PANN bit-plane matmuls on unpacked planes (port of
``repro.kernels.pann_matmul``):

``pann_matmul_act`` — the fused activation-quant prologue (backend 'fused'):

    y[m, n] = ((q(x) @ W)[m, n] - zcol[n]) * s * gamma[n]
    q(x)    = clip(round(x / s) + z, 0, n_lvl)
    W       = sum_{p >= shift} 2^p (pos_p - neg_p)

``pann_matmul`` — the same product on int8 codes quantized beforehand
(``quantize_act``), with per-row scales and every plane live:

    y[m, n] = ((x_q @ W)[m, n] - zcol[n]) * s_x[m] * gamma[n]

Both take ``mode`` 'fused' (W rebuilt, one product) or 'planes' (the literal
Eq.-10 dataflow, per live plane p: acc += 2^p (q @ pos_p) - 2^p (q @ neg_p));
the sums are exact integers, so the modes agree bit for bit. Each launches
its CUDA kernel (``csrc/pann_matmul.cu``) on CUDA tensors and runs its
``*_plain`` version on CPU tensors. The plain version is what the kernel is
held against on the card.
"""
from __future__ import annotations

import functools

import torch

from repro_torch.core import quant
from repro_torch.kernels import autotune, build
from repro_torch.kernels.ref import int_matmul

Tensor = torch.Tensor

launches = 0                # pann_matmul_act launches since the last reset
pann_matmul_launches = 0    # pann_matmul launches since the last reset
acc_launches = 0            # pann_matmul_act_acc (accumulator mode) launches
epilogue_launches = 0       # pann_epilogue launches

MODES = ("fused", "planes")

# split-K sizing of the tile kernels: enough blocks for two waves on the
# H100's 132 SMs. Above DECODE_ROWS rows every matmul (B1/B4 here, B2/B5 in
# pann_matmul_packed, B6 in unsigned_matmul) runs the tensor-core tile
# kernel (csrc/pann_tc.cuh): a block covers TC_TILE = (rows, columns, K
# alignment), 128 x 128 outputs over K chunks of whole 64-row steps.
_TARGET_BLOCKS = 2 * 132
DECODE_ROWS = 8
_MAX_KCHUNK = 4096
TC_TILE = (128, 128, 64)

# The streaming decode kernels of the integer matmuls (M <= DECODE_ROWS,
# csrc/pann_common.cuh): a block is DECODE_WARPS warps over DECODE_COLS
# columns, the warps taking K steps of ``step`` rows in turn (4 for the
# unpacked planes and B6's int8 weight, 8 for the packed planes). Blocks a
# SM by rows of the row tile (4 or 8), as the kernels' __launch_bounds__
# promise.
DECODE_COLS = 128
DECODE_WARPS = 8
STEP_PLANES, STEP_PACKED = 4, 8
BLOCKS_PLANES = {4: 2, 8: 2}
BLOCKS_PACKED = {4: 3, 8: 2}
BLOCKS_SIGNED = {4: 4, 8: 2}
_DECODE_MIN_STEPS = 2       # K steps per warp, at least


def split_k(m: int, k: int, n: int) -> tuple[int, int]:
    """(ksplit, kchunk) of a tile launch (m > DECODE_ROWS): ksplit * kchunk
    >= k > (ksplit - 1) * kchunk, kchunk a multiple of TC_TILE's K
    alignment."""
    rows, cols, align = TC_TILE
    tiles = -(-n // cols) * -(-m // rows)
    ksplit = max(1, min(-(-_TARGET_BLOCKS // tiles), -(-k // 64)))
    kchunk = -(-(-(-k // ksplit)) // align) * align
    return -(-k // kchunk), kchunk


def decode_split(k: int, n: int, step: int, slots: int) -> tuple[int, int]:
    """(ksplit, kchunk) of a streaming decode launch on a card with
    ``slots`` resident blocks (SMs times blocks a SM): as many K splits as
    fill the slots once with the column tiles (never more blocks than
    slots, so no tail wave; one split where the column tiles alone fill
    them), each warp at least _DECODE_MIN_STEPS steps; kchunk a multiple of
    DECODE_WARPS * step (every warp the same number of steps) and at most
    _MAX_KCHUNK (the code panel in shared memory)."""
    align = DECODE_WARPS * step
    tiles = -(-n // DECODE_COLS)
    want = max(1, slots // tiles)
    kchunk = max(-(-k // want), _DECODE_MIN_STEPS * align)
    kchunk = min(-(-kchunk // align) * align, _MAX_KCHUNK)
    return -(-k // kchunk), kchunk


def rebuild_weight(planes_pos: Tensor, planes_neg: Tensor, shift=None
                   ) -> Tensor:
    """(K, N) int32 W = sum_{p >= shift} 2^p (pos_p - neg_p); ``shift`` is
    a 0-dim tensor, read on the device (None: every plane)."""
    weights = _plane_weights(planes_pos.shape[0], shift, planes_pos.device)
    w = torch.zeros(planes_pos.shape[1:], dtype=torch.int32,
                    device=planes_pos.device)
    for i in range(planes_pos.shape[0]):
        w += weights[i] * (planes_pos[i].to(torch.int32)
                           - planes_neg[i].to(torch.int32))
    return w


def _plane_weights(p: int, shift, device) -> Tensor:
    """(P,) int32 2^p for live planes p >= shift, 0 for dead ones."""
    ks = torch.arange(p, dtype=torch.int32, device=device)
    if shift is None:
        return 1 << ks
    sh = torch.round(shift).to(torch.int32)
    return torch.where(ks >= sh, 1 << ks, torch.zeros_like(ks))


def int_product(q: Tensor, planes_pos: Tensor, planes_neg: Tensor,
                shift=None, mode: str = "fused") -> Tensor:
    """The exact int32 (M, N) product of codes q (M, K) with the planes'
    weight: 'fused' rebuilds W and multiplies once; 'planes' multiplies
    each live plane, pos and neg apart, and adds 2^p times the difference."""
    if not check_mode(mode):
        return int_matmul(q, rebuild_weight(planes_pos, planes_neg, shift))
    weights = _plane_weights(planes_pos.shape[0], shift, q.device)
    acc = torch.zeros((q.shape[0], planes_pos.shape[2]), dtype=torch.int32,
                      device=q.device)
    for i in range(planes_pos.shape[0]):
        acc += (weights[i] * int_matmul(q, planes_pos[i])
                - weights[i] * int_matmul(q, planes_neg[i]))
    return acc


def epilogue(acc: Tensor, s: Tensor, gamma: Tensor, zcol=None) -> Tensor:
    """((acc - zcol) * s) * gamma in fp32 — the kernels' finalize; ``s`` is
    0-dim (per tensor) or (M, 1) (per row), ``zcol`` may be None."""
    if zcol is not None:
        acc = acc - zcol
    return acc.to(torch.float32) * s * gamma


def matmul_epilogue(q: Tensor, w: Tensor, s: Tensor, gamma: Tensor,
                    zcol: Tensor) -> Tensor:
    """Exact integer q @ w, then ((acc - zcol) * s) * gamma in fp32."""
    return epilogue(int_matmul(q, w), s, gamma, zcol)


def pann_matmul_act_plain(x: Tensor, planes_pos: Tensor, planes_neg: Tensor,
                          qparams: Tensor, gamma: Tensor, zcol: Tensor,
                          mode: str = "fused") -> Tensor:
    """Plain PyTorch version of the prologue kernel, on any device."""
    s, z, n_lvl, shift = qparams.unbind()
    q = quant.affine_encode(x, s, z, n_lvl)
    return epilogue(int_product(q, planes_pos, planes_neg, shift, mode), s,
                    gamma, zcol)


def pann_matmul_act_acc_plain(x: Tensor, planes_pos: Tensor,
                              planes_neg: Tensor, qparams: Tensor,
                              mode: str = "fused") -> Tensor:
    """Plain PyTorch version of the accumulator mode, on any device: the
    prologue kernel's exact int32 product, no epilogue."""
    s, z, n_lvl, shift = qparams.unbind()
    q = quant.affine_encode(x, s, z, n_lvl)
    return int_product(q, planes_pos, planes_neg, shift, mode)


def pann_epilogue_plain(sums: Tensor, qparams: Tensor, gamma: Tensor,
                        zcol: Tensor) -> Tensor:
    """Plain PyTorch version of the epilogue entry, on any device."""
    return epilogue(sums, qparams[0], gamma, zcol)


def pann_matmul_plain(x_q: Tensor, planes_pos: Tensor, planes_neg: Tensor,
                      s_x: Tensor, gamma: Tensor, zcol=None, *,
                      mode: str = "fused") -> Tensor:
    """Plain PyTorch version of the codes kernel, on any device."""
    return epilogue(int_product(x_q, planes_pos, planes_neg, None, mode),
                    s_x, gamma, zcol)


def check_operands(x: Tensor, planes: tuple, plane_dtype, k_rows: int,
                   gamma: Tensor, zcol) -> None:
    """Device, shape and contiguity checks shared by the matmul wrappers;
    ``k_rows`` is the planes' row count for this x; ``gamma`` (the
    accumulator mode's) and ``zcol`` may be None."""
    dev = x.device
    tensors = [x, *planes] + [t for t in (gamma, zcol) if t is not None]
    if any(t.device != dev for t in tensors):
        raise ValueError("all operands must be on one device")
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError("operands must be contiguous")
    if x.ndim != 2:
        raise ValueError(f"x must be (M, K), got {tuple(x.shape)}")
    pos, neg = planes
    if pos.dtype != plane_dtype or neg.dtype != plane_dtype \
            or pos.shape != neg.shape or pos.ndim != 3:
        raise ValueError(f"planes must be two equal (P, K', N) {plane_dtype} "
                         f"tensors, got {pos.dtype} {tuple(pos.shape)}")
    p, k_rows_have, n = pos.shape
    if k_rows_have != k_rows:
        raise ValueError(f"planes have {k_rows_have} rows, x needs {k_rows}")
    if not 1 <= p <= 7:
        raise ValueError(f"plane count {p} outside [1, 7]")
    if n % 4:
        raise ValueError(f"N = {n} must be a multiple of 4")
    if gamma is not None and (gamma.dtype != torch.float32
                              or gamma.shape != (n,)):
        raise ValueError(f"gamma must be ({n},) float32")
    if zcol is not None and (zcol.dtype != torch.int32
                             or zcol.shape != (n,)):
        raise ValueError(f"zcol must be ({n},) int32")


def check_args(x: Tensor, planes: tuple, plane_dtype, k_rows: int,
               qparams: Tensor, gamma: Tensor, zcol: Tensor) -> None:
    """Checks of the prologue kernels (fp32 x, per-tensor qparams)."""
    check_operands(x, planes, plane_dtype, k_rows, gamma, zcol)
    if x.dtype != torch.float32:
        raise ValueError(f"x must be float32, got {x.dtype}")
    if qparams.device != x.device or not qparams.is_contiguous() \
            or qparams.dtype != torch.float32 or qparams.shape != (4,):
        raise ValueError("qparams must be a (4,) float32 [s, z, n, shift]")


def check_codes_args(x_q: Tensor, planes: tuple, plane_dtype, k_rows: int,
                     s_x: Tensor, gamma: Tensor, zcol) -> None:
    """Checks of the codes kernels (int8 x_q, per-row s_x)."""
    check_operands(x_q, planes, plane_dtype, k_rows, gamma, zcol)
    if x_q.dtype != torch.int8:
        raise ValueError(f"x_q must be int8 codes, got {x_q.dtype}")
    if s_x.device != x_q.device or not s_x.is_contiguous() \
            or s_x.dtype != torch.float32 or s_x.shape != (x_q.shape[0], 1):
        raise ValueError(f"s_x must be ({x_q.shape[0]}, 1) float32")


def check_mode(mode: str) -> int:
    """The C entry's ``planes`` flag of a mode name."""
    if mode not in MODES:
        raise ValueError(f"mode must be one of {MODES}, got {mode!r}")
    return int(mode == "planes")


def _act_launcher():
    return build.entry("pann_matmul", "pann_matmul_act_launch",
                       (build.P,) * 10 + (build.I,) * 7 + (build.P,))


def _codes_launcher():
    return build.entry("pann_matmul", "pann_matmul_launch",
                       (build.P,) * 10 + (build.I,) * 7 + (build.P,))


def _acc_launcher():
    return build.entry("pann_matmul", "pann_matmul_act_acc_launch",
                       (build.P,) * 8 + (build.I,) * 7 + (build.P,))


def _epilogue_launcher():
    return build.entry("pann_matmul", "pann_epilogue_launch",
                       (build.P,) * 5 + (build.I,) * 2 + (build.P,))


@functools.cache
def sm_count(index: int) -> int:
    """The SM count of CUDA device ``index``."""
    return torch.cuda.get_device_properties(index).multi_processor_count


# (device index, stream) -> (acc, tickets) of the decode kernels, int32 and
# zero between launches: a kernel leaves them as it found them. One pair per
# stream, so launches on two streams never share one.
_decode_scratch: dict = {}


def decode_scratch(x: Tensor, n_acc: int, n_tickets: int) -> tuple:
    """The zeroed (acc, tickets) buffers of the decode kernels on x's
    device and current stream, grown to at least n_acc and n_tickets."""
    stream = torch.cuda.current_stream(x.device)
    key = (x.device.index, stream.cuda_stream)
    acc, tickets = _decode_scratch.get(key, (None, None))
    if acc is None or acc.numel() < n_acc or tickets.numel() < n_tickets:
        n_acc = max(n_acc, 0 if acc is None else acc.numel())
        n_tickets = max(n_tickets, 0 if tickets is None else tickets.numel())
        acc = torch.zeros(n_acc, dtype=torch.int32, device=x.device)
        tickets = torch.zeros(n_tickets, dtype=torch.int32, device=x.device)
        _decode_scratch[key] = (acc, tickets)
    return acc, tickets


def split_scratch(x: Tensor, n: int, step: int, blocks: dict,
                  params=None) -> tuple:
    """(ksplit, kchunk, partial, acc, tickets) of a matmul of x (M, K) with
    N columns: up to DECODE_ROWS rows the streaming decode kernel's split
    (K steps of ``step`` rows, ``blocks`` a SM by row tile, see
    ``decode_split``) and its zeroed sums and tickets, partial None; above
    it the tile kernel's split (``split_k``) and its (ksplit, M, N) int32
    partial sums, acc and tickets None. ``params`` (ksplit, kchunk)
    replaces the heuristic split (``kernels.autotune``)."""
    m, k = x.shape
    if m <= DECODE_ROWS:
        if params is None:
            slots = sm_count(x.device.index) * blocks[4 if m <= 4 else 8]
            params = decode_split(k, n, step, slots)
        acc, tickets = decode_scratch(x, m * n, -(-n // DECODE_COLS))
        return (*params, None, acc, tickets)
    ksplit, kchunk = split_k(m, k, n) if params is None else params
    partial = torch.empty((ksplit, m, n), dtype=torch.int32, device=x.device)
    return ksplit, kchunk, partial, None, None


def launch_product(launcher, what: str, x: Tensor, planes: tuple,
                   scale: Tensor, gamma: Tensor, zcol, *extra,
                   step: int = STEP_PLANES,
                   blocks: dict = BLOCKS_PLANES, backend=None,
                   params=None, sums: bool = False) -> Tensor:
    """Allocate y and the split-K scratch (``split_scratch``) and call one C
    entry point of the bit-plane matmuls: up to DECODE_ROWS rows the
    streaming decode kernel (one launch), above it the tensor-core tile
    kernel and the epilogue kernel; raises on a CUDA error. A serving
    launch names its ``backend`` ('fused' | 'packed') and reads its split
    from ``autotune.params_for``; ``params`` forces one (``autotune.tune``
    measures each candidate so), checked legal. ``sums``: the accumulator
    mode's entry, whose output is the (M, N) int32 sums (no gamma, zcol)."""
    m, k = x.shape
    p, _, n = planes[0].shape
    if params is not None:
        params = autotune.check_params(m, k, backend, params)
    elif backend is not None:
        params = autotune.params_for(m, k, n, p, backend, device=x.device)
    out = torch.empty((m, n), dtype=torch.int32 if sums else torch.float32,
                      device=x.device)
    ksplit, kchunk, partial, acc, tickets = split_scratch(x, n, step, blocks,
                                                          params)
    mid = (scale, out) if sums else (scale, gamma, zcol, out)
    ptrs = [build.ptr(t) for t in (x, *planes, *mid, partial, acc, tickets)]
    err = launcher(*ptrs, m, k, n, p, ksplit, kchunk, *extra,
                   build.stream_of(x))
    build.check(err, what)
    return out


def meta_product(name: str, x: Tensor, planes: tuple, mode: str = "fused",
                 sums: bool = False) -> Tensor:
    """A B1/B2 launch on meta tensors (``launch.dryrun``): the kernel's
    integer operations, 2 M K N for each product it runs (one on the
    rebuilt weight; 'planes' one per plane and sign), counted in
    ``build.meta_ops``, and its empty (M, N) output."""
    m, k = x.shape
    p, _, n = planes[0].shape
    passes = 2 * p if mode == "planes" else 1
    return build.meta_launch(name, 2 * m * k * n * passes, (m, n),
                             torch.int32 if sums else torch.float32)


def pann_matmul_act(x: Tensor, planes_pos: Tensor, planes_neg: Tensor,
                    qparams: Tensor, gamma: Tensor, zcol: Tensor,
                    mode: str = "fused", params=None) -> Tensor:
    """x (M, K) f32; planes_pos/neg (P, K, N) int8 in {0, 1}; qparams (4,)
    f32 [s, z, n_lvl, plane_shift] on the same device; gamma (N,) f32;
    zcol (N,) int32 -> (M, N) f32. CPU tensors run the plain version; CUDA
    tensors launch the kernel or raise. The launch's K split is the
    autotuner's for backend 'fused' (``autotune.params_for``), or
    ``params``."""
    if x.device.type == "cpu":
        return pann_matmul_act_plain(x, planes_pos, planes_neg, qparams,
                                     gamma, zcol, mode)
    if x.device.type == "meta":
        check_mode(mode)
        return meta_product("pann_matmul_act", x, (planes_pos, planes_neg),
                            mode)
    if x.device.type != "cuda":
        raise ValueError(f"no kernel for device {x.device}")
    planes = check_mode(mode)
    check_args(x, (planes_pos, planes_neg), torch.int8, x.shape[1], qparams,
               gamma, zcol)
    y = launch_product(_act_launcher(), "pann_matmul_act", x,
                       (planes_pos, planes_neg), qparams, gamma, zcol,
                       planes, backend="fused", params=params)
    global launches
    launches += 1
    return y


def pann_matmul(x_q: Tensor, planes_pos: Tensor, planes_neg: Tensor,
                s_x: Tensor, gamma: Tensor, zcol=None, *,
                mode: str = "fused") -> Tensor:
    """x_q (M, K) int8 codes >= 0; planes_pos/neg (P, K, N) int8 in {0, 1};
    s_x (M, 1) f32 per-row scales; gamma (N,) f32; zcol (N,) int32 or None
    -> (M, N) f32. CPU tensors run the plain version; CUDA tensors launch
    the kernel or raise."""
    if x_q.device.type == "cpu":
        return pann_matmul_plain(x_q, planes_pos, planes_neg, s_x, gamma,
                                 zcol, mode=mode)
    if x_q.device.type != "cuda":
        raise ValueError(f"no kernel for device {x_q.device}")
    planes = check_mode(mode)
    check_codes_args(x_q, (planes_pos, planes_neg), torch.int8, x_q.shape[1],
                     s_x, gamma, zcol)
    y = launch_product(_codes_launcher(), "pann_matmul", x_q,
                       (planes_pos, planes_neg), s_x, gamma, zcol, planes)
    global pann_matmul_launches
    pann_matmul_launches += 1
    return y


def pann_matmul_act_acc(x: Tensor, planes_pos: Tensor, planes_neg: Tensor,
                        qparams: Tensor, mode: str = "fused",
                        params=None) -> Tensor:
    """The accumulator mode of ``pann_matmul_act``: the same operands but
    gamma and zcol, the (M, N) int32 product sums out and no epilogue (a
    row-parallel projection's K shard, ``kernels.dispatch``). CPU tensors
    run the plain version; CUDA tensors launch the kernel or raise; its K
    split is backend 'fused''s, as the whole product's."""
    if x.device.type == "cpu":
        return pann_matmul_act_acc_plain(x, planes_pos, planes_neg, qparams,
                                         mode)
    if x.device.type == "meta":
        check_mode(mode)
        return meta_product("pann_matmul_act_acc", x,
                            (planes_pos, planes_neg), mode, sums=True)
    if x.device.type != "cuda":
        raise ValueError(f"no kernel for device {x.device}")
    planes = check_mode(mode)
    check_args(x, (planes_pos, planes_neg), torch.int8, x.shape[1], qparams,
               None, None)
    sums = launch_product(_acc_launcher(), "pann_matmul_act_acc", x,
                          (planes_pos, planes_neg), qparams, None, None,
                          planes, backend="fused", params=params, sums=True)
    global acc_launches
    acc_launches += 1
    return sums


def pann_epilogue(sums: Tensor, qparams: Tensor, gamma: Tensor,
                  zcol: Tensor) -> Tensor:
    """y = ((sums - zcol) * s) * gamma in fp32 (s = qparams[0]) for (M, N)
    int32 sums: the accumulator mode's epilogue after the sums of every K
    shard are added (B1 and B2 alike). CPU tensors run the plain version;
    CUDA tensors launch the kernel or raise."""
    if sums.device.type == "cpu":
        return pann_epilogue_plain(sums, qparams, gamma, zcol)
    m, n = sums.shape
    if sums.device.type == "meta":
        return build.meta_launch("pann_epilogue", 2 * m * n, (m, n),
                                 torch.float32)
    if sums.device.type != "cuda":
        raise ValueError(f"no kernel for device {sums.device}")
    tensors = (sums, qparams, gamma, zcol)
    if any(t.device != sums.device for t in tensors) \
            or not all(t.is_contiguous() for t in tensors):
        raise ValueError("operands must be contiguous, on one device")
    if sums.dtype != torch.int32 or sums.ndim != 2:
        raise ValueError(f"sums must be (M, N) int32, got {sums.dtype} "
                         f"{tuple(sums.shape)}")
    if gamma.dtype != torch.float32 or gamma.shape != (n,) \
            or zcol.dtype != torch.int32 or zcol.shape != (n,):
        raise ValueError(f"gamma must be ({n},) float32, zcol ({n},) int32")
    if qparams.dtype != torch.float32 or qparams.shape != (4,):
        raise ValueError("qparams must be a (4,) float32 [s, z, n, shift]")
    y = torch.empty((m, n), dtype=torch.float32, device=sums.device)
    err = _epilogue_launcher()(*(build.ptr(t) for t in (sums, qparams, gamma,
                                                        zcol, y)),
                               m, n, build.stream_of(sums))
    build.check(err, "pann_epilogue")
    global epilogue_launches
    epilogue_launches += 1
    return y
