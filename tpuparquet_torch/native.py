"""Host C helpers: hybrid run scans, bit packing, DELTA_BINARY_PACKED
structure, strided lane/byte-plane passes and the BYTE_ARRAY passes.

``csrc/hybrid.c`` scans hybrid run headers into run tables, takes the
max and value counts of their bit-packed lanes and encodes hybrid
streams for the writer; ``csrc/pack.c`` packs bits (the delta-lane
transport's offsets, DELTA_BINARY_PACKED miniblocks), expands or
re-packs run tables and encodes hybrid streams of u64 values; ``csrc/delta.c`` walks the blocks of a
DELTA_BINARY_PACKED stream and gathers its miniblocks, rebuilds
DELTA_BYTE_ARRAY values and measures the writer's shared prefixes, and
decodes a whole DELTA_BINARY_PACKED stream in one pass; ``csrc/plane.c``
scans and gathers the strided lanes and byte planes of the plane
transport, and ``csrc/bytes.c`` scans PLAIN BYTE_ARRAY length prefixes,
gathers and emits variable-length values and interns them for the
writer's dictionary; ``csrc/intern.c`` interns small-range integer
columns, and ``csrc/page.c`` lays a written data page's body into one
buffer and takes its CRC, one C pass each (the numpy or Python formulations
cost several passes, or a loop per value).  Each compiles with the host
C compiler at first use and loads with ctypes.  There is no numpy
fallback: without a compiler they raise.
"""

from __future__ import annotations

import ctypes
import shutil
import threading

import numpy as np

from .errors import KernelBuildError

__all__ = ["NativeBytes", "NativeDelta", "NativeHybrid", "NativeIntern",
           "NativePack", "NativePage", "NativePlane", "TOO_MANY_DISTINCT",
           "bytes_native", "delta_native", "hybrid_native", "intern_native",
           "pack_native", "page_native", "plane_native"]

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
                raise KernelBuildError(
                    f"tpuparquet_torch needs a C compiler to build "
                    f"csrc/{stem}.c")
            (path,) = build([(CSRC / f"{stem}.c",
                              [cc, "-O3", "-shared", "-fPIC"])])
            got = _objs[stem] = cls(ctypes.CDLL(str(path)))
        return got


def _u8(buf) -> np.ndarray:
    return np.ascontiguousarray(np.frombuffer(buf, dtype=np.uint8)
                                if not isinstance(buf, np.ndarray)
                                else buf.reshape(-1).view(np.uint8))


def hybrid_encode_cap(count: int, width: int) -> int:
    """Output bound of one hybrid encode of ``count`` ``width``-bit
    values: packed groups, per-group headers and slack."""
    groups = (count + 7) // 8
    return groups * width + 5 * (groups + 2) + 32


class NativeHybrid:
    """ctypes bindings of ``csrc/hybrid.c``."""

    def __init__(self, lib: ctypes.CDLL):
        self._scan = lib.tpq_hybrid_scan
        self._scan.restype = ctypes.c_int
        self._scan.argtypes = [ctypes.c_char_p, ctypes.c_size_t,
                               ctypes.c_size_t, ctypes.c_int64, ctypes.c_int,
                               _P, _P, _P, _P, ctypes.c_int64, _P,
                               ctypes.c_size_t,
                               ctypes.POINTER(ctypes.c_int64),
                               ctypes.POINTER(ctypes.c_int64),
                               ctypes.POINTER(ctypes.c_size_t),
                               ctypes.POINTER(ctypes.c_size_t)]
        self._bp_stats = lib.tpq_bp_stats
        self._bp_stats.restype = ctypes.c_int
        self._bp_stats.argtypes = [ctypes.c_char_p, ctypes.c_size_t,
                                   ctypes.c_int, _P, _P, ctypes.c_int64,
                                   ctypes.c_uint32,
                                   ctypes.POINTER(ctypes.c_uint32),
                                   ctypes.POINTER(ctypes.c_int64)]
        self._encode32 = lib.tpq_hybrid_encode32
        self._encode32.restype = _LL
        self._encode32.argtypes = [_P, _LL, ctypes.c_int, _P, _LL,
                                   ctypes.POINTER(_LL)]

    def scan(self, buf, count: int, width: int, pos: int = 0):
        """Run table of ``count`` ``width``-bit values (width <= 32) from
        byte ``pos``: ``(run_ends, run_is_rle, run_value, run_bp_start,
        bp_bytes, n_bp_values, end_pos)``, as
        :func:`~tpuparquet_torch.cpu.hybrid.scan_hybrid` returns it."""
        data = _u8(buf)
        # every run takes at least one header byte
        cap_runs = max(min(count, max(data.size - pos, 0)) + 1, 1)
        bp_cap = max(data.size - pos, 1)
        ends = np.empty(cap_runs, dtype=np.int32)
        is_rle = np.empty(cap_runs, dtype=np.uint8)
        value = np.empty(cap_runs, dtype=np.uint32)
        bp_start = np.empty(cap_runs, dtype=np.int32)
        bp_out = np.empty(bp_cap, dtype=np.uint8)
        n_runs = ctypes.c_int64()
        n_bp = ctypes.c_int64()
        bp_len = ctypes.c_size_t()
        end_pos = ctypes.c_size_t()
        rc = self._scan(data.ctypes.data_as(ctypes.c_char_p), data.size, pos,
                        count, width, ends.ctypes.data, is_rle.ctypes.data,
                        value.ctypes.data, bp_start.ctypes.data, cap_runs,
                        bp_out.ctypes.data, bp_cap, ctypes.byref(n_runs),
                        ctypes.byref(n_bp), ctypes.byref(bp_len),
                        ctypes.byref(end_pos))
        if rc == -1:
            raise ValueError("truncated hybrid run")
        if rc == -2:
            raise ValueError("zero-length RLE run")
        if rc == -6:
            raise ValueError("RLE run value exceeds bit width")
        if rc != 0:
            raise ValueError(f"hybrid scan failed (rc={rc})")
        r = int(n_runs.value)
        return (ends[:r], is_rle[:r].astype(bool), value[:r], bp_start[:r],
                bp_out[: bp_len.value], int(n_bp.value), int(end_pos.value))

    def bp_stats(self, bp_bytes, width: int, starts, lens, target: int = 0):
        """``(max value or None, count of target)`` over the consumed lanes
        of bit-packed segments (``starts``/``lens`` in lanes)."""
        bp = _u8(bp_bytes)
        s = np.ascontiguousarray(starts, dtype=np.int64)
        ln = np.ascontiguousarray(lens, dtype=np.int64)
        mx = ctypes.c_uint32()
        cnt = ctypes.c_int64()
        rc = self._bp_stats(bp.ctypes.data_as(ctypes.c_char_p), bp.size,
                            width, s.ctypes.data, ln.ctypes.data, s.size,
                            target, ctypes.byref(mx), ctypes.byref(cnt))
        if rc == 1:
            return None, 0
        if rc != 0:
            raise ValueError(f"bit-packed segment out of bounds (rc={rc})")
        return int(mx.value), int(cnt.value)

    def encode32(self, values: np.ndarray, width: int) -> bytes:
        """Hybrid encode of u32 values at ``width`` (1..32), byte for byte
        :func:`~tpuparquet_torch.cpu.hybrid.encode_hybrid`'s output;
        raises on a value that does not fit."""
        v = np.ascontiguousarray(values, dtype=np.uint32)
        cap = hybrid_encode_cap(v.size, width)
        out = np.empty(cap, dtype=np.uint8)
        out_len = _LL()
        rc = self._encode32(v.ctypes.data, v.size, width, out.ctypes.data,
                            cap, ctypes.byref(out_len))
        if rc == -1:
            raise ValueError(
                f"value {int(v.max())} does not fit in {width} bits")
        if rc != 0:
            raise ValueError(f"hybrid encode failed (rc={rc})")
        return out[: out_len.value].tobytes()


class NativePack:
    """ctypes bindings of ``csrc/pack.c``."""

    def __init__(self, lib: ctypes.CDLL):
        self._pack64 = lib.tpq_pack64
        self._pack64.restype = _LL
        self._pack64.argtypes = [_P, _LL, ctypes.c_int, _P]
        self._delta_emit = lib.tpq_delta_emit
        self._delta_emit.restype = _LL
        self._delta_emit.argtypes = [_P, _P, _LL, _LL, _P, _LL, _LL, _P, _LL,
                                     ctypes.POINTER(_LL)]
        self._hybrid_encode = lib.tpq_hybrid_encode
        self._hybrid_encode.restype = _LL
        self._hybrid_encode.argtypes = [_P, _LL, ctypes.c_int, _P, _LL,
                                        ctypes.POINTER(_LL)]
        self._expand = lib.tpq_hybrid_expand32
        self._repack = lib.tpq_hybrid_repack
        for fn in (self._expand, self._repack):
            fn.restype = _LL
            fn.argtypes = [_P, _P, _P, _P, _LL, _P, _LL, _LL, _LL,
                           ctypes.c_int, _P]

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

    def hybrid_encode(self, values: np.ndarray, width: int) -> bytes:
        """Hybrid encode of u64 values at ``width`` (1..64) in one C pass,
        byte for byte :meth:`NativeHybrid.encode32`'s stream where both
        apply; raises on a value that does not fit."""
        v = np.ascontiguousarray(values, dtype=np.uint64)
        cap = hybrid_encode_cap(v.size, width)
        out = np.empty(cap, dtype=np.uint8)
        out_len = _LL()
        rc = self._hybrid_encode(v.ctypes.data, v.size, width,
                                 out.ctypes.data, cap, ctypes.byref(out_len))
        if rc == -1:
            raise ValueError(
                f"value {int(v.max())} does not fit in {width} bits")
        if rc != 0:
            raise ValueError(f"hybrid encode failed (rc={rc})")
        return out[: out_len.value].tobytes()

    def delta_emit(self, adj, widths, mb_size: int, min_deltas,
                   n_miniblocks: int) -> np.ndarray:
        """The per-block body of a DELTA_BINARY_PACKED stream (zigzag
        min_delta varints, width bytes, packed miniblocks) in one pass."""
        a = np.ascontiguousarray(adj, dtype=np.uint64).reshape(-1)
        w = np.ascontiguousarray(widths, dtype=np.uint8)
        md = np.ascontiguousarray(min_deltas, dtype=np.int64)
        packed_bytes = int((w.astype(np.int64) * mb_size).sum()) // 8
        cap = packed_bytes + md.size * (10 + n_miniblocks) + 16
        out = np.empty(cap, dtype=np.uint8)
        out_len = _LL()
        rc = self._delta_emit(a.ctypes.data, w.ctypes.data, w.size, mb_size,
                              md.ctypes.data, md.size, n_miniblocks,
                              out.ctypes.data, cap, ctypes.byref(out_len))
        if rc != 0:
            raise ValueError(f"delta emit failed (rc={rc})")
        return out[: out_len.value]

    @staticmethod
    def _run_table(scan, count: int, width: int):
        """C-ready run table of a scan, or None for the shapes the C
        passes do not take: widths past 32, no runs, or a table that
        does not cover ``count`` (no valid scan gives one)."""
        ends, is_rle, value, bp_start, bp_bytes = scan[:5]
        if not 0 < width <= 32 or not len(ends) or int(ends[-1]) < count:
            return None
        return (np.ascontiguousarray(ends, dtype=np.int32),
                np.ascontiguousarray(is_rle, dtype=np.uint8),
                np.ascontiguousarray(value, dtype=np.uint32),
                np.ascontiguousarray(bp_start, dtype=np.int32),
                _u8(bp_bytes))

    def hybrid_expand(self, scan, count: int, width: int):
        """A scan's run table expanded to ``(count,)`` u32 values, or
        None for the shapes :meth:`_run_table` refuses."""
        t = self._run_table(scan, count, width)
        if t is None:
            return None
        ends, rle, val, bps, bp = t
        out = np.empty(count, dtype=np.uint32)
        rc = self._expand(ends.ctypes.data, rle.ctypes.data, val.ctypes.data,
                          bps.ctypes.data, ends.size, bp.ctypes.data, bp.size,
                          int(scan[5]), count, width, out.ctypes.data)
        if rc != 0:
            raise ValueError(f"hybrid expand failed (rc={rc})")
        return out

    def hybrid_repack(self, scan, count: int, width: int):
        """A scan's values re-packed as ONE bit-packed run of ``count``
        lanes (bytes), without the expanded intermediate; None for the
        shapes :meth:`_run_table` refuses."""
        t = self._run_table(scan, count, width)
        if t is None:
            return None
        ends, rle, val, bps, bp = t
        n = (count * width + 7) // 8
        out = np.empty(n + 8, dtype=np.uint8)  # word-writer slack
        rc = self._repack(ends.ctypes.data, rle.ctypes.data, val.ctypes.data,
                          bps.ctypes.data, ends.size, bp.ctypes.data, bp.size,
                          int(scan[5]), count, width, out.ctypes.data)
        if rc == -1:
            raise ValueError(
                f"value {int(val.max())} does not fit in {width} bits")
        if rc != 0:
            raise ValueError(f"hybrid repack failed (rc={rc})")
        return out[:n]


class NativeDelta:
    """ctypes bindings of ``csrc/delta.c``."""

    _ERRORS = {-1: "truncated uvarint",
               -5: "truncated miniblock width list",
               -7: "truncated miniblock payload",
               -9: "uvarint too long"}

    def __init__(self, lib: ctypes.CDLL):
        self._scan = lib.tpq_delta_scan_blocks
        self._scan.restype = _LL
        self._scan.argtypes = [_P, _LL, _LL, _LL, _LL, _LL, ctypes.c_int,
                               _P, _P, _P, _P, _LL, _LL, ctypes.POINTER(_LL),
                               ctypes.POINTER(_LL), ctypes.POINTER(_LL)]
        self._gather = lib.tpq_gather_segments
        self._gather.restype = _LL
        self._gather.argtypes = [_P, _LL, _P, _LL, _LL, _P]
        self._dba = lib.tpq_dba_assemble
        self._dba.restype = _LL
        self._dba.argtypes = [_P, _P, _P, _LL, _P, _LL, _P,
                              ctypes.POINTER(_LL)]
        self._prefix = lib.tpq_common_prefix
        self._prefix.restype = None
        self._prefix.argtypes = [_P, _P, _LL, _P]
        self._decode = lib.tpq_delta_decode
        self._decode.restype = _LL
        self._decode.argtypes = [_P, _LL, _P, _LL, _P, _P, _P, _LL, _LL,
                                 _LL, _LL, ctypes.c_uint64, _P]

    def decode_all(self, data, st) -> np.ndarray | None:
        """The whole DELTA_BINARY_PACKED decode of a scanned structure
        (:class:`~tpuparquet_torch.cpu.delta.DeltaStructure`) in one C
        pass: every miniblock unpacked, the block's min_delta added, the
        prefix sum from ``first``.  Returns the ``(total,)`` u64 values
        (two's-complement wrap, byte for byte the JAX package's decode),
        or None when the pass declines a miniblock that overruns the data
        (the structure scan rejects those first)."""
        buf = _u8(data)
        md = np.ascontiguousarray(st.md_blocks, dtype=np.int64)
        w = np.ascontiguousarray(st.mb_w, dtype=np.int32)
        p = np.ascontiguousarray(st.mb_pos, dtype=np.int64)
        s = np.ascontiguousarray(st.mb_start, dtype=np.int64)
        out = np.empty(max(st.total, 1), dtype=np.uint64)[: st.total]
        rc = self._decode(buf.ctypes.data, buf.size, md.ctypes.data, md.size,
                          w.ctypes.data, p.ctypes.data, s.ctypes.data,
                          w.size, st.mb_size, st.block_size, st.total,
                          st.first & 0xFFFFFFFFFFFFFFFF, out.ctypes.data)
        return out if rc == 0 else None

    def gather_segments(self, src, positions, nbytes: int) -> np.ndarray:
        """The ``nbytes``-byte segments of ``src`` at ``positions``,
        concatenated."""
        buf = _u8(src)
        pos = np.ascontiguousarray(positions, dtype=np.int64)
        out = np.empty(pos.size * nbytes, dtype=np.uint8)
        if self._gather(buf.ctypes.data, buf.size, pos.ctypes.data, pos.size,
                        nbytes, out.ctypes.data) != 0:
            raise ValueError("miniblock payload out of bounds")
        return out

    def dba_assemble(self, prefix_lens, suffix_offs, suffix_data,
                     out_offsets, total: int) -> np.ndarray:
        """Front-coded DELTA_BYTE_ARRAY fill in one pass (``total`` output
        bytes); raises ValueError with the JAX assembler's messages on a
        malformed stream."""
        pl = np.ascontiguousarray(prefix_lens, dtype=np.int64)
        so = np.ascontiguousarray(suffix_offs, dtype=np.int64)
        sd = _u8(suffix_data)
        oo = np.ascontiguousarray(out_offsets, dtype=np.int64)
        out = np.empty(max(total, 1), dtype=np.uint8)[:total]
        err = _LL()
        rc = self._dba(pl.ctypes.data, so.ctypes.data, sd.ctypes.data,
                       sd.size, oo.ctypes.data, pl.size, out.ctypes.data,
                       ctypes.byref(err))
        if rc == -1:
            raise ValueError("DELTA_BYTE_ARRAY: first prefix must be 0")
        if rc == -2:
            raise ValueError(f"DELTA_BYTE_ARRAY: prefix {int(pl[err.value])} "
                             "longer than previous value")
        if rc != 0:
            raise ValueError(f"DELTA_BYTE_ARRAY assembly failed (rc={rc})")
        return out

    def common_prefix(self, data, offsets) -> np.ndarray:
        """int64 length of the prefix each value shares with the one
        before it (0 for the first) over offsets + data."""
        d = _u8(data)
        offs = np.ascontiguousarray(offsets, dtype=np.int64)
        n = offs.size - 1
        if n > 0 and (int(offs[0]) < 0 or int(offs[-1]) > d.size
                      or bool((offs[1:] < offs[:-1]).any())):
            raise ValueError("byte-array offsets out of bounds")
        out = np.empty(max(n, 1), dtype=np.int64)[:n]
        self._prefix(d.ctypes.data, offs.ctypes.data, n, out.ctypes.data)
        return out

    def scan_blocks(self, data, pos: int, n_deltas: int, mb_size: int,
                    n_miniblocks: int, max_width: int):
        """The block loop of a DELTA stream whose four header varints end
        at ``pos``: ``(md_blocks, mb_w, mb_pos, mb_start, end_pos)``;
        raises ValueError with the Python scanner's messages."""
        buf = _u8(data)
        block_size = mb_size * n_miniblocks
        # the caps are bounded by the bytes left too: each block takes at
        # least 1 + n_miniblocks bytes and each recorded miniblock at
        # least mb_size / 8, so a corrupt total cannot size the tables
        max_blocks = max(buf.size - pos, 0) // (1 + n_miniblocks) + 2
        cap_blocks = min(n_deltas // block_size + 2, max_blocks)
        max_mb = max(buf.size - pos, 0) // max(mb_size // 8, 1) + 2
        cap_mb = min(cap_blocks * n_miniblocks + 2, max_mb)
        md = np.empty(cap_blocks, dtype=np.int64)
        w = np.empty(cap_mb, dtype=np.int32)
        p = np.empty(cap_mb, dtype=np.int64)
        s = np.empty(cap_mb, dtype=np.int64)
        nb, nm, end = _LL(), _LL(), _LL()
        rc = self._scan(buf.ctypes.data, buf.size, pos, n_deltas, mb_size,
                        n_miniblocks, max_width, md.ctypes.data,
                        w.ctypes.data, p.ctypes.data, s.ctypes.data,
                        cap_blocks, cap_mb, ctypes.byref(nb),
                        ctypes.byref(nm), ctypes.byref(end))
        if rc == -6:
            raise ValueError(f"delta miniblock width > {max_width} for this "
                             "column's physical type")
        if rc != 0:
            raise ValueError(self._ERRORS.get(rc,
                                              f"delta scan failed (rc={rc})"))
        b, m = int(nb.value), int(nm.value)
        return md[:b], w[:m], p[:m], s[:m], int(end.value)


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


class NativePage:
    """ctypes bindings of ``csrc/page.c``: a data page's body laid into
    one buffer in one pass, and zlib's CRC-32 (slice-by-8)."""

    def __init__(self, lib: ctypes.CDLL):
        self._encode = lib.tpq_page_encode
        self._encode.restype = _LL
        self._encode.argtypes = [_P, _P, _LL, ctypes.c_int, ctypes.c_int,
                                 ctypes.c_int, _P, _LL, ctypes.c_int, _P, _LL,
                                 _P, _LL, ctypes.POINTER(_LL),
                                 ctypes.POINTER(_LL), ctypes.POINTER(_LL)]
        self._crc = lib.tpq_crc32
        self._crc.restype = ctypes.c_uint32
        self._crc.argtypes = [_P, _LL, ctypes.c_uint32]

    def crc32(self, buf, crc: int = 0) -> int:
        """``zlib.crc32(buf, crc)``."""
        b = _u8(buf)
        return int(self._crc(b.ctypes.data, b.size, crc & 0xFFFFFFFF))

    def encode(self, rep, dl, n: int, rep_width: int, def_width: int,
               v2: bool, idx, idx_width: int, values, out: np.ndarray):
        """Lay one data page's uncompressed body into ``out``: ``[rep
        stream][def stream][values]``, the level streams length-prefixed
        (V1) or bare (V2).  ``rep``/``dl`` are u32 levels or None (no
        stream); the values are ``idx`` (u32 dictionary indices, hybrid
        encoded behind their width byte) or ``values`` (encoded u8 bytes,
        copied).  Returns ``(rep_len, dl_len, val_len)``, framing
        included, or None when ``out`` is too small; raises on a level or
        index that does not fit its width."""
        def _c(a):
            # C walks n consecutive words from the base pointer
            return None if a is None else np.ascontiguousarray(a)

        def _p(a):
            return None if a is None else a.ctypes.data

        rep, dl, idx, values = _c(rep), _c(dl), _c(idx), _c(values)
        rep_len, dl_len, val_len = _LL(), _LL(), _LL()
        rc = self._encode(
            _p(rep), _p(dl), n, rep_width, def_width, 1 if v2 else 0,
            _p(idx), 0 if idx is None else idx.size, idx_width,
            _p(values), 0 if values is None else values.size,
            out.ctypes.data, out.size, ctypes.byref(rep_len),
            ctypes.byref(dl_len), ctypes.byref(val_len))
        if rc == -1:
            raise ValueError("level/index value does not fit its width")
        if rc != 0:
            return None
        return int(rep_len.value), int(dl_len.value), int(val_len.value)


class NativeIntern:
    """ctypes bindings of ``csrc/intern.c``."""

    def __init__(self, lib: ctypes.CDLL):
        self._range32 = lib.tpq_intern_range32
        self._range64 = lib.tpq_intern_range64
        for fn, lo_t in ((self._range32, ctypes.c_uint32),
                         (self._range64, ctypes.c_uint64)):
            fn.restype = _LL
            fn.argtypes = [_P, _LL, lo_t, _LL, _P, _P, _P]

    def intern_range(self, arr: np.ndarray, lo: int, rng: int):
        """First-occurrence intern of a 4- or 8-byte integer column whose
        values lie in ``[lo, lo + rng)`` (``lo`` and ``rng`` from its true
        minimum and maximum): ``(first index a value int64[D], ids
        int32[n])``.  Raises on a value outside the range."""
        fn = self._range64 if arr.itemsize == 8 else self._range32
        u = np.ascontiguousarray(arr).view(
            np.uint64 if arr.itemsize == 8 else np.uint32)
        mask = (1 << (8 * arr.itemsize)) - 1
        rank = np.full(rng, -1, dtype=np.int32)
        uniq_pos = np.empty(rng, dtype=np.int64)
        indices = np.empty(max(u.size, 1), dtype=np.int32)[: u.size]
        d = fn(u.ctypes.data, u.size, lo & mask, rng, rank.ctypes.data,
               uniq_pos.ctypes.data, indices.ctypes.data)
        if d < 0:
            raise ValueError(f"value outside interning range (rc={d})")
        return uniq_pos[:d].copy(), indices


def bytes_native() -> NativeBytes:
    """The BYTE_ARRAY passes (raises without a C compiler)."""
    return _native("bytes", NativeBytes)


def delta_native() -> NativeDelta:
    """The DELTA_BINARY_PACKED block scan and the DELTA_BYTE_ARRAY passes
    (raises without a C compiler)."""
    return _native("delta", NativeDelta)


def hybrid_native() -> NativeHybrid:
    """The hybrid run scanner (raises without a C compiler)."""
    return _native("hybrid", NativeHybrid)


def intern_native() -> NativeIntern:
    """The small-range integer intern (raises without a C compiler)."""
    return _native("intern", NativeIntern)


def page_native() -> NativePage:
    """The page body pass and the CRC (raises without a C compiler)."""
    return _native("page", NativePage)


def pack_native() -> NativePack:
    """The bit packer (raises without a C compiler)."""
    return _native("pack", NativePack)


def plane_native() -> NativePlane:
    """The lane/plane passes (raises without a C compiler)."""
    return _native("plane", NativePlane)
