"""Build the CUDA kernels from ``repro_torch/csrc`` at first use and load
them with ctypes.

Each ``csrc/<name>.cu`` is compiled by its own ``nvcc`` process into
``<repo>/build/kernels/<name>-<hash>.so`` (the hash covers the source and
the flags), all started together so the build takes as long as the slowest
file. The sources expose a plain C interface — no PyTorch headers — which
keeps a build at seconds rather than minutes. Nothing is built when a
module is imported: the CPU tests import every module and have no nvcc.
"""
from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path

import torch

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "kernels"
SOURCES = ("pann_matmul", "pann_matmul_packed", "pann_attention",
           "quantize_act", "unsigned_matmul")

# IEEE division and rintf are kept (no --use_fast_math); products whose
# rounding matters use __fmul_rn in the sources, so fma contraction cannot
# change a result.
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_lock = threading.Lock()
_libs: dict = {}
build_log: dict = {}       # name -> nvcc's stderr (ptxas register report)
build_seconds: float = 0.0


def nvcc_path() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    cand = Path("/usr/local/cuda/bin/nvcc")
    if cand.exists():
        return str(cand)
    raise RuntimeError("nvcc not found: the CUDA kernels are built from "
                       "source at first use and need the CUDA toolkit")


def _target(name: str) -> Path:
    src = b"".join(f.read_bytes() for f in sorted(CSRC.glob("*.cu*")))
    src += name.encode()
    digest = hashlib.sha256(src + " ".join(NVCC_FLAGS).encode()).hexdigest()
    return BUILD_DIR / f"{name}-{digest[:16]}.so"


def library_path(name: str) -> Path:
    """The built library of ``csrc/<name>.cu`` for the current sources."""
    return _target(name)


def build_all() -> dict:
    """Compile every missing library in parallel and load all of them.
    Returns {name: ctypes.CDLL}. Raises with nvcc's output on failure."""
    global build_seconds
    with _lock:
        if len(_libs) == len(SOURCES):
            return dict(_libs)
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        t0 = time.perf_counter()
        procs = {}
        for name in SOURCES:
            out = _target(name)
            if out.exists():
                continue
            tmp = out.with_suffix(f".{os.getpid()}.tmp")
            cmd = [nvcc_path(), *NVCC_FLAGS, "-o", str(tmp),
                   str(CSRC / f"{name}.cu")]
            procs[name] = (subprocess.Popen(
                cmd, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                text=True), tmp, out)
        failed = []
        for name, (proc, tmp, out) in procs.items():
            stdout, stderr = proc.communicate()
            build_log[name] = stdout + stderr
            if proc.returncode != 0:
                failed.append(f"{name}: nvcc exit {proc.returncode}\n"
                              f"{stdout}{stderr}")
                continue
            os.replace(tmp, out)
        if failed:
            raise RuntimeError("kernel build failed:\n" + "\n".join(failed))
        build_seconds = time.perf_counter() - t0
        for name in SOURCES:
            _libs[name] = ctypes.CDLL(str(_target(name)))
        return dict(_libs)


def library(name: str) -> ctypes.CDLL:
    """The loaded library of ``csrc/<name>.cu``, building all at first use."""
    lib = _libs.get(name)
    if lib is None:
        lib = build_all()[name]
    return lib


@functools.cache
def entry(name: str, symbol: str, argtypes: tuple):
    """C entry point ``symbol`` of ``csrc/<name>.cu`` with its prototype
    set; resolved once, so a launch pays no ctypes setup."""
    fn = getattr(library(name), symbol)
    fn.argtypes = list(argtypes)
    fn.restype = I
    return fn


def ptr(t) -> ctypes.c_void_p:
    """A tensor's device pointer for a C entry point; None is a null."""
    return ctypes.c_void_p(None if t is None else t.data_ptr())


def stream_of(t) -> ctypes.c_void_p:
    """PyTorch's current CUDA stream on ``t``'s device."""
    return ctypes.c_void_p(torch.cuda.current_stream(t.device).cuda_stream)


# Integer (and epilogue) operations of the kernels a dry run launched on
# meta tensors, by kernel name (``launch.dryrun``): a kernel wrapper handed
# meta tensors builds nothing and launches nothing; it adds the kernel's
# operations here and returns an empty output of the kernel's shape.
meta_ops: dict = {}


def meta_launch(name: str, ops: int, shape: tuple, dtype) -> torch.Tensor:
    """Count a meta launch of kernel ``name`` (``ops`` operations) and
    return its empty meta output."""
    meta_ops[name] = meta_ops.get(name, 0) + int(ops)
    return torch.empty(shape, dtype=dtype, device="meta")


def check(err: int, what: str) -> None:
    """Raise if a C entry point returned a CUDA error code."""
    if err != 0:
        raise RuntimeError(f"{what}: CUDA error {err} at launch")


P = ctypes.c_void_p
I = ctypes.c_int
