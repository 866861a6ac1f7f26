"""Host C helpers: bit packing, strided lane/byte-plane passes and the
BYTE_ARRAY passes.

``csrc/pack.c`` packs the delta-lane transport's offsets,
``csrc/plane.c`` scans and gathers the strided lanes and byte planes of
the plane transport, and ``csrc/bytes.c`` scans PLAIN BYTE_ARRAY length
prefixes, gathers and emits variable-length values and interns them for
the writer's dictionary, one C pass each (the numpy or Python
formulations cost several passes, or a loop per value).  Each compiles
with the host C compiler at first use and loads with ctypes.  There is
no numpy fallback: without a compiler they raise.
"""

from __future__ import annotations

import ctypes
import shutil
import threading

import numpy as np

__all__ = ["NativeBytes", "NativePack", "NativePlane", "TOO_MANY_DISTINCT",
           "bytes_native", "pack_native", "plane_native"]

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
                    f"tpuparquet_torch needs a C compiler to build "
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


# intern_var's answer when a column has more distinct values than the cap
TOO_MANY_DISTINCT = object()


def _u8(buf) -> np.ndarray:
    return np.ascontiguousarray(np.frombuffer(buf, dtype=np.uint8)
                                if not isinstance(buf, np.ndarray)
                                else buf.reshape(-1).view(np.uint8))


class NativeBytes:
    """ctypes bindings of ``csrc/bytes.c``."""

    def __init__(self, lib: ctypes.CDLL):
        self._scan = lib.tpq_byte_array_scan
        self._scan.restype = _LL
        self._scan.argtypes = [_P, _LL, _LL, _P, _P, _P, _P]
        self._emit = lib.tpq_byte_array_emit
        self._emit.restype = _LL
        self._emit.argtypes = [_P, _LL, _P, _LL, _P]
        self._gather = lib.tpq_gather_var
        self._gather.restype = _LL
        self._gather.argtypes = [_P, _LL, _P, _P, _LL, _P, _LL]
        self._intern = lib.tpq_intern_var
        self._intern.restype = _LL
        self._intern.argtypes = [_P, _LL, _P, _LL, _P, _LL, ctypes.c_int,
                                 _P, _LL, _P]

    def byte_array_scan(self, buf, count: int):
        """``(positions, offsets)`` of ``count`` PLAIN BYTE_ARRAY records
        (int64: each value's payload position, and the ``count + 1``
        cumulative offsets); raises ValueError on a truncated page."""
        if count < 0:
            raise ValueError(f"negative value count {count}")
        b = _u8(buf)
        positions = np.empty(max(count, 1), dtype=np.int64)[:count]
        offsets = np.zeros(count + 1, dtype=np.int64)
        err = ctypes.c_longlong()
        err_len = ctypes.c_longlong()
        rc = self._scan(b.ctypes.data, b.size, count, positions.ctypes.data,
                        offsets.ctypes.data, ctypes.byref(err),
                        ctypes.byref(err_len))
        if rc == -1:
            raise ValueError(f"PLAIN BYTE_ARRAY: truncated length prefix "
                             f"at value {err.value}")
        if rc == -2:
            raise ValueError(f"PLAIN BYTE_ARRAY: length {err_len.value} "
                             f"out of bounds at value {err.value}")
        if rc != 0:
            raise ValueError(f"byte-array scan failed (rc={rc})")
        return positions, offsets

    def byte_array_emit(self, data, offsets) -> np.ndarray:
        """PLAIN records (u32-LE prefix + bytes) of offsets + data."""
        d = _u8(data)
        offs = np.ascontiguousarray(offsets, dtype=np.int64)
        count = offs.size - 1
        total = 4 * count + int(offs[-1]) - int(offs[0])
        out = np.empty(max(total, 1), dtype=np.uint8)[:total]
        if self._emit(d.ctypes.data, d.size, offs.ctypes.data, count,
                      out.ctypes.data) != 0:
            raise ValueError("byte-array offsets out of bounds or value too "
                             "long for a u32 prefix")
        return out

    def gather_var(self, src, starts, lens, total: int) -> np.ndarray:
        """Concatenate the segments ``src[starts[i]:starts[i] + lens[i]]``
        (``total`` bytes)."""
        buf = _u8(src)
        s = np.ascontiguousarray(starts, dtype=np.int64)
        ln = np.ascontiguousarray(lens, dtype=np.int64)
        out = np.empty(max(total, 1), dtype=np.uint8)[:total]
        if self._gather(buf.ctypes.data, buf.size, s.ctypes.data,
                        ln.ctypes.data, s.size, out.ctypes.data, total) != 0:
            raise ValueError("segment out of bounds")
        return out

    def intern_var(self, data, offsets, max_d: int):
        """First-occurrence intern of variable byte values:
        ``(first value index per id int64[D], ids int32[n])``, or
        :data:`TOO_MANY_DISTINCT` past ``max_d`` distinct values."""
        buf = _u8(data)
        offs = np.ascontiguousarray(offsets, dtype=np.int64)
        n = offs.size - 1
        # at least 4x the distinct cap in slots keeps probe chains short;
        # a saturated table (unreachable at that sizing) retries doubled
        tbits = max(16, (4 * max_d - 1).bit_length())
        max_tbits = min(tbits + 3, 31)
        firsts = np.empty(max(max_d, 1), dtype=np.int64)
        indices = np.empty(max(n, 1), dtype=np.int32)[:n]
        while True:
            t = 1 << tbits
            slots = np.full(t, -1, dtype=np.int32)
            d = self._intern(buf.ctypes.data, buf.size, offs.ctypes.data, n,
                             slots.ctypes.data, t - 1, tbits,
                             firsts.ctypes.data, max_d, indices.ctypes.data)
            if d != -1 or tbits >= max_tbits:
                break
            tbits += 1
        if d == -2:
            return TOO_MANY_DISTINCT
        if d < 0:
            raise ValueError(f"byte column intern failed (rc={d})")
        return firsts[:d].copy(), indices


def bytes_native() -> NativeBytes:
    """The BYTE_ARRAY passes (raises without a C compiler)."""
    return _native("bytes", NativeBytes)


def pack_native() -> NativePack:
    """The bit packer (raises without a C compiler)."""
    return _native("pack", NativePack)


def plane_native() -> NativePlane:
    """The lane/plane passes (raises without a C compiler)."""
    return _native("plane", NativePlane)
