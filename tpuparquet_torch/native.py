"""Host C helpers of the PLAIN wire planners: bit packing and strided
lane/byte-plane passes.

``csrc/pack.c`` packs the delta-lane transport's offsets and
``csrc/plane.c`` scans and gathers the strided lanes and byte planes of
the plane transport, one C pass each (the numpy formulations cost
several passes per lane).  Both compile with the host C compiler at
first use and load with ctypes.  There is no numpy fallback: without a
compiler the planners raise.
"""

from __future__ import annotations

import ctypes
import shutil
import threading

import numpy as np

__all__ = ["NativePack", "NativePlane", "pack_native", "plane_native"]

_P = ctypes.c_void_p
_LL = ctypes.c_longlong

_lock = threading.Lock()
_objs: dict = {}


def _native(stem: str, cls):
    """The ``cls`` binding of ``csrc/<stem>.c``, built on first call."""
    with _lock:
        got = _objs.get(stem)
        if got is None:
            from ._build import CSRC, build

            cc = shutil.which("cc") or shutil.which("gcc")
            if cc is None:
                raise RuntimeError(
                    f"the PLAIN wire planners need a C compiler to build "
                    f"csrc/{stem}.c")
            (path,) = build([(CSRC / f"{stem}.c",
                              [cc, "-O3", "-shared", "-fPIC"])])
            got = _objs[stem] = cls(ctypes.CDLL(str(path)))
        return got


class NativePack:
    """ctypes binding of ``tpq_pack64``."""

    def __init__(self, lib: ctypes.CDLL):
        self._pack64 = lib.tpq_pack64
        self._pack64.restype = _LL
        self._pack64.argtypes = [_P, _LL, ctypes.c_int, _P]

    def pack(self, values: np.ndarray, width: int) -> np.ndarray:
        """LSB-first pack of a contiguous uint64 array; raises on a
        value that does not fit ``width`` bits."""
        v = np.ascontiguousarray(values, dtype=np.uint64)
        n = (v.size * width + 7) // 8
        out = np.empty(n + 8, dtype=np.uint8)  # word-writer slack
        rc = self._pack64(v.ctypes.data, v.size, width, out.ctypes.data)
        if rc == -1:
            raise ValueError(
                f"value {int(v.max())} does not fit in {width} bits")
        if rc != 0:
            raise ValueError(f"bit width {width} out of range 1..64")
        return out[:n]


class NativePlane:
    """ctypes bindings of the strided run-scan and gather passes."""

    def __init__(self, lib: ctypes.CDLL):
        self._scan32 = lib.tpq_run_scan32
        self._scan8 = lib.tpq_run_scan8
        self._gather32 = lib.tpq_lane_gather32
        self._gather8 = lib.tpq_lane_gather8
        for fn in (self._scan32, self._scan8):
            fn.restype = _LL
            fn.argtypes = [_P, _LL, _LL, _P, _P, _LL]
        for fn in (self._gather32, self._gather8):
            fn.restype = None
            fn.argtypes = [_P, _LL, _LL, _P]

    @staticmethod
    def _strided(arr: np.ndarray, esize: int):
        """(base pointer, element stride) for a 1-D strided view."""
        if arr.ndim != 1 or arr.itemsize != esize:
            raise ValueError("expected a 1-D view of the element type")
        return arr.ctypes.data, arr.strides[0]

    def run_scan(self, plane: np.ndarray, max_runs: int):
        """Run-table scan of a strided u32/u8 view.  Returns
        ``(ends[:n], vals[:n])`` — run k covers ``[ends[k-1], ends[k])``
        with value ``vals[k]`` — or None when the plane has more than
        ``max_runs`` runs (the table cannot beat shipping raw)."""
        cap = max(int(max_runs), 1)
        ends = np.empty(cap, dtype=np.int32)
        if plane.itemsize == 4:
            vals = np.empty(cap, dtype=np.uint32)
            base, stride = self._strided(plane, 4)
            n = self._scan32(base, plane.size, stride,
                             ends.ctypes.data, vals.ctypes.data, cap)
        else:
            vals = np.empty(cap, dtype=np.uint8)
            base, stride = self._strided(plane, 1)
            n = self._scan8(base, plane.size, stride,
                            ends.ctypes.data, vals.ctypes.data, cap)
        if n < 0:
            return None
        return ends[:n], vals[:n]

    def gather(self, plane: np.ndarray) -> np.ndarray:
        """Contiguous copy of a strided u32/u8 view (one pass)."""
        out = np.empty(plane.size, dtype=plane.dtype)
        if plane.itemsize == 4:
            base, stride = self._strided(plane, 4)
            self._gather32(base, plane.size, stride, out.ctypes.data)
        else:
            base, stride = self._strided(plane, 1)
            self._gather8(base, plane.size, stride, out.ctypes.data)
        return out


def pack_native() -> NativePack:
    """The bit packer (raises without a C compiler)."""
    return _native("pack", NativePack)


def plane_native() -> NativePlane:
    """The lane/plane passes (raises without a C compiler)."""
    return _native("plane", NativePlane)
