"""Build and bind the hand-written CUDA kernels (``csrc/*.cu``).

Each source compiles with ``nvcc`` for ``sm_90a`` into its own
plain-C shared library (all sources in parallel, at first use, into the
package's ``_build/``) and loads with ctypes.  Every exported kernel
function launches on the stream it is given, allocates nothing and
returns ``cudaGetLastError()``; the few host helpers beside a kernel
(HELPERS) return their CUDA call's error; :func:`launch` raises when
that is not 0.
"""

from __future__ import annotations

import ctypes
import threading
import time

import torch

__all__ = ["HELPERS", "KERNELS", "build_kernels", "check_tensor",
           "count_launch",
           "i64_to_lanes", "i64_to_u32_bits", "lanes_to_i64", "launch",
           "stream_of", "u32_to_i64"]

_P = ctypes.c_void_p
_I = ctypes.c_int
_L = ctypes.c_int64
_U64 = ctypes.c_uint64

# source stem -> argtypes of its exported tpq_<stem>
KERNELS = {
    "unpack_u32": [_P, _P, _L, _I, _I, _P],
    "expand_hybrid": [_P, _P, _I, _P, _L, _I, _L, _I, _P],
    "page_dict_fixed": [_P, _L, _I, _P, _I, _P, _L, _P],
    "levels_to_validity": [_P, _L, _I, _I, _P, _P, _P, _P],
    "planes_to_words": [_P, _P, _P, _P, _P, _P, _P, _L, _I, _I, _P, _P],
    "unpack_u64": [_P, _P, _P, _L, _I, _P],
    "delta_scan": [_P, _P, _P, _P, _I, _L, _L, _U64, _P, _P, _P],
    "snappy_expand": [_P, _P, _I, _P, _L, ctypes.c_int32, _L, _L, _P, _P,
                      _P, _P, _P],
    "dict_bytes": [_P, _L, _P, _L, _P, _I, _L, _L, _P, _P, _L, _P],
    "bytes_from_blob": [_P, _L, _P, _L, _I, _P, _L, _I, _P],
    "delta_scatter": [_P, _P, _P, _P, _L, _L, _P, _P, _L, _P],
    "bss_to_lanes": [_P, _L, _I, _I, _I, _P, _P],
    "flba_to_lanes": [_P, _L, _I, _I, _I, _P, _P],
    "pack_bits": [_P, _P, _L, _P, _L, _I, _I, _P, _P],
    "bss_encode": [_P, _L, _I, _I, _I, _P, _P],
    "delta_encode": [_P, _L, _I, _L, _P, _P, _P, _P, _P, _P, _P],
    "dict_build": [_P, _I, _L, ctypes.c_uint32, _L, _I, _P, _P, _P, _P, _P,
                   _P, _P, _P],
    "min_max": [_P, _L, _I, _I, _P, _P, _P],
    "scatter_dense": [_P, _L, _P, _P, _L, _I, _P, _L, _P],
    "spmd_step": [_P, _L, _P, _P, _P, _P, _I, _P, _L, _I, _L, _L, _L, _I,
                  _I, _L, _P, _L, _L, _P],
    "byte_densify": [_P, _L, _P, _P, _L, _I, _P, _P, _L, _P, _L, _P, _L,
                     _P],
    "place_rows": [_P, _L, _P, _L, _L, _P, _P],
}

# host helpers beside a kernel: name -> (source stem, argtypes) of its
# exported tpq_<name>, which returns a cudaError_t as the kernels do
HELPERS = {
    "min_max_wait": ("min_max", [_P]),
    "min_max_mapped": ("min_max", [_P, ctypes.POINTER(ctypes.c_uint64)]),
}

NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC"]

_lock = threading.Lock()
_fns: dict = {}
_count_lock = threading.Lock()


def count_launch(wrapper) -> None:
    """Add one to ``wrapper.launches``, a kernel wrapper's count of its
    launches.  The writer's encode pool launches from several threads,
    where a bare ``+= 1`` can lose a count."""
    with _count_lock:
        wrapper.launches += 1


def build_kernels() -> float:
    """Compile (if needed) and load every kernel library; returns the
    seconds it took.  Raises RuntimeError when nvcc is missing or a
    build fails."""
    t0 = time.perf_counter()
    with _lock:
        if not _fns:
            from .._build import CSRC, build, find_nvcc

            nvcc = find_nvcc()
            if nvcc is None:
                raise RuntimeError(
                    "nvcc not found: the CUDA kernels build from "
                    "csrc/*.cu at first use")
            names = list(KERNELS)
            paths = build([(CSRC / f"{n}.cu", [nvcc] + NVCC_FLAGS)
                           for n in names])
            libs = {n: ctypes.CDLL(str(p)) for n, p in zip(names, paths)}
            signatures = {n: (n, a) for n, a in KERNELS.items()}
            signatures.update(HELPERS)
            for name, (stem, argtypes) in signatures.items():
                fn = getattr(libs[stem], f"tpq_{name}")
                fn.argtypes = argtypes
                fn.restype = ctypes.c_int
                _fns[name] = fn
    return time.perf_counter() - t0


def stream_of(t) -> int:
    """The raw handle of PyTorch's current stream on ``t``'s device (read
    without building a ``torch.cuda.Stream``, which costs more host time
    than a small kernel's launch)."""
    return torch._C._cuda_getCurrentRawStream(t.device.index)


def launch(name: str, *args) -> None:
    """Call ``tpq_<name>(*args)`` (a kernel's launch or a helper of
    HELPERS); raises RuntimeError on a CUDA error."""
    if not _fns:
        build_kernels()
    rc = _fns[name](*args)
    if rc != 0:
        raise RuntimeError(f"CUDA call tpq_{name} failed: cudaError {rc}")


def check_tensor(t, name: str, dtype, device) -> None:
    """Reject what the kernels do not take: wrong device, dtype, rank or
    a non-contiguous layout."""
    if t.device != device:
        raise ValueError(f"{name} is on {t.device}, expected {device}")
    if t.dtype != dtype:
        raise TypeError(f"{name} has dtype {t.dtype}, expected {dtype}")
    if t.dim() != 1 or not t.is_contiguous():
        raise ValueError(f"{name} must be a contiguous 1-D tensor")


# u32 words live in int32 tensors (same bits).  The plain versions do
# their u32 arithmetic in int64: CPU torch.uint32 has no shifts, adds or
# compares.

def u32_to_i64(t):
    return t.to(torch.int64) & 0xFFFFFFFF


def i64_to_u32_bits(v):
    """int64 values in [0, 2^32) -> the int32 tensor with the same bits."""
    return torch.where(v >= 1 << 31, v - (1 << 32), v).to(torch.int32)


# 64-bit lanes: (lo, hi) u32 pairs <-> int64 two's complement.  Sums of
# int64 tensors wrap mod 2^64, as the reference's carry arithmetic does.

def lanes_to_i64(lo, hi):
    """(lo, hi) u32 lanes (int32 tensors) -> int64 with the same bits."""
    return hi.to(torch.int64) * (1 << 32) + u32_to_i64(lo)


def i64_to_lanes(v):
    """int64 -> its (lo, hi) u32 lanes as int32 tensors."""
    return (i64_to_u32_bits(v & 0xFFFFFFFF),
            i64_to_u32_bits((v >> 32) & 0xFFFFFFFF))
