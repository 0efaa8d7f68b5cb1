"""Launch-parameter autotuner of the serving matmuls (port of
``repro.kernels.autotune``).

The reference tunes its Pallas kernels' block shapes, DMA depth and grid
order; none of those exists on the card. What the port's B1
(``pann_matmul_act``, backend 'fused') and B2 (``pann_matmul_packed_act``,
backend 'packed') launches do choose is how K is split: (ksplit, kchunk),
the grid's K splits and the K rows each covers. ``kernels.pann_matmul``
picks it by heuristic (``decode_split`` up to ``DECODE_ROWS`` rows, from
the card's SM count; ``split_k`` above) unless this module's cache holds a
measured choice for the launch's shape. This module owns

  * the heuristic (``heuristic_params``) and the legal candidates
    (``candidate_params``: kchunk a multiple of the kernel's K step, every
    split non-empty, within the shared-memory code panel at decode);
  * a persistent cache of measured-best parameters keyed by
    ``device name | backend | MxKxN | planes | planes_active``
    (``params_for`` / ``record``);
  * the offline measurement (``tune``) that fills it.

Every candidate gives bit-identical results: the splits sum int32
partials exactly, and the fp32 epilogue runs once, on the full sum.
``tune`` checks it all the same and raises on a difference.

``params_for`` is read at every launch, so a CUDA graph captured after
tuning replays the tuned launch. It is pure in (arguments, cache state):
it never measures and never writes. ``tune`` runs offline
(``ServeEngine(autotune=True)`` before ``warmup``). It measures only on
the card, each candidate with a cold L2 (``_time_cold_ms``); on the CPU
it records the heuristic untimed, as the reference does off the TPU.

Cache location: ``$REPRO_TORCH_AUTOTUNE_CACHE`` if set, else
``~/.cache/repro_pann/autotune_torch.json``: the port's own file, apart
from the reference's ``$REPRO_AUTOTUNE_CACHE`` / ``autotune.json``, whose
CPU keys read the same and whose values are block shapes. The file is
versioned and rewritten atomically; a corrupt or foreign-version file is
ignored, never crashed on.
"""
from __future__ import annotations

import functools
import json
import os
import tempfile
from typing import Callable, Iterable, NamedTuple, Optional

import numpy as np
import torch

from repro_torch.kernels import pann_matmul as _pm

CACHE_VERSION = 1

_ENV_VAR = "REPRO_TORCH_AUTOTUNE_CACHE"

# the SM count the heuristic assumes where no card is asked (the CPU
# records the split an H100 would launch)
H100_SMS = 132

# candidate split counts; each becomes a kchunk rounded up to the kernel's
# K step, then the split count that kchunk gives
SPLITS = (1, 2, 3, 4, 6, 8, 12, 16, 24, 32, 48, 64)

TIMED_ITERS = 5
_L2_FLUSH_BYTES = 256 << 20        # > the H100's 50 MB L2
_SLEEP_CYCLES = 100_000_000        # the host enqueues ahead of the card

# process-local snapshot of the on-disk cache, loaded lazily and kept in
# sync by record(): key -> {"ksplit": s, "kchunk": c}
_cache: Optional[dict] = None

# what the last tune() of each key measured on the card:
# key -> {"heuristic": ..., "best": ..., "candidates": [(params, ms), ...]}
timings: dict = {}


class KernelParams(NamedTuple):
    """One tuning decision: the grid's K splits and the rows of each."""
    ksplit: int
    kchunk: int


def _as_params(value) -> KernelParams:
    if isinstance(value, dict):
        return KernelParams(int(value["ksplit"]), int(value["kchunk"]))
    ksplit, kchunk = value
    return KernelParams(int(ksplit), int(kchunk))


@functools.cache
def _cuda_name(index: int) -> str:
    return torch.cuda.get_device_name(index)


def _index(device: torch.device) -> int:
    return (device.index if device.index is not None
            else torch.cuda.current_device())


def _sms(device: torch.device) -> int:
    """The SM count of the CUDA device the heuristic splits for."""
    return _pm.sm_count(_index(device))


def device_kind(device=None) -> str:
    """The cache's namespace: the CUDA device's name ('NVIDIA H100 80GB
    HBM3', ...), 'cpu' for the CPU."""
    device = torch.device("cpu" if device is None else device)
    if device.type != "cuda":
        return device.type
    return _cuda_name(_index(device))


def cache_path() -> str:
    env = os.environ.get(_ENV_VAR)
    if env:
        return env
    return os.path.join(os.path.expanduser("~"), ".cache", "repro_pann",
                        "autotune_torch.json")


def cache_key(m: int, k: int, n: int, planes: int, backend: str,
              kind: str, active: Optional[int] = None) -> str:
    active = planes if active is None else active
    return f"{kind}|{backend}|{m}x{k}x{n}|p{planes}a{active}"


def _load() -> dict:
    global _cache
    if _cache is None:
        _cache = {}
        try:
            with open(cache_path()) as f:
                data = json.load(f)
            if isinstance(data, dict) and \
                    data.get("version") == CACHE_VERSION and \
                    isinstance(data.get("params"), dict):
                _cache = dict(data["params"])
        except (OSError, ValueError):
            pass
    return _cache


def _save() -> None:
    path = cache_path()
    folder = os.path.dirname(path) or "."
    os.makedirs(folder, exist_ok=True)
    payload = {"version": CACHE_VERSION, "params": _load()}
    fd, tmp = tempfile.mkstemp(dir=folder, suffix=".tmp")
    try:
        with os.fdopen(fd, "w") as f:
            json.dump(payload, f, indent=1, sort_keys=True)
        os.replace(tmp, path)
    except OSError:
        try:
            os.unlink(tmp)
        except OSError:
            pass


def clear_memory_cache() -> None:
    """Drop the process-local snapshot (tests; after external edits)."""
    global _cache
    _cache = None


def _geometry(backend: str) -> tuple[int, dict]:
    """(K rows a warp step, resident blocks a SM by row tile) of the
    backend's decode kernel."""
    if backend == "packed":
        return _pm.STEP_PACKED, _pm.BLOCKS_PACKED
    return _pm.STEP_PLANES, _pm.BLOCKS_PLANES


def _align(m: int, backend: str) -> int:
    """kchunk's multiple: whole warp steps of every warp at decode, the
    tile kernel's K alignment above DECODE_ROWS rows."""
    if m <= _pm.DECODE_ROWS:
        return _pm.DECODE_WARPS * _geometry(backend)[0]
    return _pm.TC_TILE[2]


def heuristic_params(m: int, k: int, n: int, backend: str,
                     sms: int = H100_SMS) -> KernelParams:
    """The launch's split without a tuned entry: ``decode_split`` on a
    card of ``sms`` SMs up to DECODE_ROWS rows, ``split_k`` above."""
    if m <= _pm.DECODE_ROWS:
        step, blocks = _geometry(backend)
        return KernelParams(*_pm.decode_split(
            k, n, step, sms * blocks[4 if m <= 4 else 8]))
    return KernelParams(*_pm.split_k(m, k, n))


def check_params(m: int, k: int, backend: str, params) -> KernelParams:
    """``params`` if it is a legal split of a launch of M x K, else
    ValueError: kchunk a positive multiple of the kernel's K step (and at
    most the decode kernel's shared-memory panel), ksplit * kchunk >= K >
    (ksplit - 1) * kchunk, so every split is non-empty."""
    p = _as_params(params)
    align = _align(m, backend)
    if p.kchunk <= 0 or p.kchunk % align or p.ksplit < 1 or \
            (m <= _pm.DECODE_ROWS and p.kchunk > _pm._MAX_KCHUNK) or \
            not p.ksplit * p.kchunk >= k > (p.ksplit - 1) * p.kchunk:
        raise ValueError(f"illegal split {tuple(p)} for a {backend} launch "
                         f"of M = {m}, K = {k} (kchunk a multiple of "
                         f"{align}, every split non-empty)")
    return p


def candidate_params(m: int, k: int, n: int, backend: str,
                     sms: int = H100_SMS) -> list[KernelParams]:
    """The legal splits measured: the heuristic's, and each split count of
    SPLITS turned into a kchunk rounded up to the kernel's K step (at most
    the decode panel), deduplicated, in ascending ksplit."""
    align = _align(m, backend)
    top = _pm._MAX_KCHUNK if m <= _pm.DECODE_ROWS else None
    out = {heuristic_params(m, k, n, backend, sms)}
    for want in SPLITS:
        kchunk = -(-(-(-k // want)) // align) * align
        if top is not None and kchunk > top:
            continue
        out.add(KernelParams(-(-k // kchunk), kchunk))
    return sorted(check_params(m, k, backend, p) for p in out)


def params_for(m: int, k: int, n: int, planes: int, backend: str,
               device=None, active: Optional[int] = None) -> KernelParams:
    """A launch's split: the measured best from the cache when present,
    the heuristic (on the device's SM count) otherwise. Pure in
    (arguments, cache state)."""
    kind = device_kind(device)
    hit = _load().get(cache_key(m, k, n, planes, backend, kind, active))
    if hit:
        return check_params(m, k, backend, hit)
    device = torch.device("cpu" if device is None else device)
    sms = _sms(device) if device.type == "cuda" else H100_SMS
    return heuristic_params(m, k, n, backend, sms)


def record(m: int, k: int, n: int, planes: int, backend: str, params,
           kind: str, active: Optional[int] = None) -> None:
    """Persist a tuning decision for ``params_for`` to find."""
    p = check_params(m, k, backend, params)
    _load()[cache_key(m, k, n, planes, backend, kind, active)] = {
        "ksplit": p.ksplit, "kchunk": p.kchunk}
    _save()


def _time_cold_ms(fn: Callable[[], object], iters: int) -> float:
    """Median device ms of ``fn`` over ``iters`` calls, each after an L2
    flush, CUDA events around the call only, behind a GPU sleep so the
    host enqueues every call before the card reaches them."""
    flush = torch.empty(_L2_FLUSH_BYTES, dtype=torch.uint8, device="cuda")
    events = [(torch.cuda.Event(enable_timing=True),
               torch.cuda.Event(enable_timing=True)) for _ in range(iters)]
    torch.cuda.synchronize()
    torch.cuda._sleep(_SLEEP_CYCLES)
    for start, end in events:
        flush.zero_()
        start.record()
        fn()
        end.record()
    torch.cuda.synchronize()
    return float(np.median([s.elapsed_time(e) for s, e in events]))


def tune(m: int, k: int, n: int, planes: int, backend: str,
         runner: Optional[Callable[[KernelParams], torch.Tensor]] = None,
         candidates: Optional[Iterable] = None,
         active: Optional[int] = None, device=None) -> KernelParams:
    """Offline: pick the fastest legal split of one launch shape and
    persist it. ``runner(params)`` launches the kernel with ``params`` and
    returns its output (``dispatch.tune_projection`` builds it). On the
    card each candidate runs once against the heuristic's output, which it
    must equal bit for bit (AssertionError otherwise), and is timed with a
    cold L2; the heuristic keeps a tie. On the CPU, or without a runner,
    the heuristic is recorded untimed. A cached entry short-circuits
    (warmup stays idempotent). A failing launch raises: nothing falls
    back."""
    kind = device_kind(device)
    key = cache_key(m, k, n, planes, backend, kind, active)
    hit = _load().get(key)
    if hit:
        return check_params(m, k, backend, hit)
    device = torch.device("cpu" if device is None else device)
    if runner is None or device.type != "cuda":
        best = heuristic_params(m, k, n, backend)
        record(m, k, n, planes, backend, best, kind, active)
        return best
    sms = _sms(device)
    heur = heuristic_params(m, k, n, backend, sms)
    cands = [check_params(m, k, backend, c) for c in
             (candidates if candidates is not None
              else candidate_params(m, k, n, backend, sms))]
    want = runner(heur)
    for c in cands:
        if not torch.equal(runner(c), want):
            raise AssertionError(f"split {tuple(c)} of {key} differs from "
                                 f"the heuristic's {tuple(heur)}")
    timed = [(c, _time_cold_ms(functools.partial(runner, c), TIMED_ITERS))
             for c in dict.fromkeys([heur, *cands])]
    best, best_ms = timed[0]
    for c, ms in timed[1:]:
        if ms < best_ms:
            best, best_ms = c, ms
    timings[key] = {"heuristic": (heur, timed[0][1]), "best": (best, best_ms),
                    "candidates": timed}
    record(m, k, n, planes, backend, best, kind, active)
    return best
