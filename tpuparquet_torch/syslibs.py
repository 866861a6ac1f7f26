"""System-library codec bindings discovered via ctypes ``dlopen``.

GZIP binds the system zlib and ZSTD binds the system libzstd; both are
resolved at run time from the usual soname candidates, or from the path
in ``TPQ_ZLIB_LIB``/``TPQ_ZSTD_LIB`` for pinned or unusual installs.
Without an override, an accessor gives None when its library is absent,
and ``compress.py`` falls back to the stdlib ``zlib`` module (GZIP: the
same libz with the same parameters, so the same bytes) or the
``zstandard`` wheel (ZSTD).  An override that does not load raises
:class:`OSError` naming the path: the user asked for that library, and a
silent fallback would hide the mistake.  (The JAX package swallows that
error and falls back; this is a known difference.)

Every entry point releases the GIL across the library call (ctypes CDLL
semantics), so block-parallel compression and frame-parallel
decompression get real concurrency.
"""

from __future__ import annotations

import ctypes
import ctypes.util
import os
import threading

import numpy as np

__all__ = ["NativeZlib", "NativeZstd", "zlib_native", "zstd_native"]


def _as_u8(block) -> np.ndarray:
    """Zero-copy u8 view of bytes, a memoryview or an ndarray."""
    if isinstance(block, np.ndarray):
        return np.ascontiguousarray(block.reshape(-1).view(np.uint8))
    return np.frombuffer(block, dtype=np.uint8)


def _dlopen(env_var: str, candidates: tuple[str, ...]):
    """The first loadable library among the override and the sonames, or
    None.  An override that fails to load raises OSError naming it."""
    override = os.environ.get(env_var)
    if override:
        try:
            return ctypes.CDLL(override)
        except OSError as e:
            raise OSError(f"{env_var}={override}: the library does not "
                          f"load ({e})") from e
    for name in candidates:
        try:
            return ctypes.CDLL(name)
        except OSError:
            continue
    found = ctypes.util.find_library(candidates[0].split(".")[0][3:])
    if found:
        try:
            return ctypes.CDLL(found)
        except OSError:
            return None
    return None


def library_path(lib) -> str | None:
    """The file a loaded library came from (``/proc/self/maps`` on Linux),
    else its load name; None for None."""
    if lib is None:
        return None
    name = lib._lib._name
    try:
        with open("/proc/self/maps") as f:
            stem = os.path.basename(name).split(".so")[0]
            for line in f:
                path = line.split()[-1]
                if os.path.basename(path).startswith(stem + ".so"):
                    return path
    except OSError:
        pass
    return name


# ----------------------------------------------------------------------
# zlib (GZIP framing)
# ----------------------------------------------------------------------

_Z_OK = 0
_Z_STREAM_END = 1
_Z_FINISH = 4
_Z_DEFLATED = 8
_Z_DEFAULT_LEVEL = -1  # 6 inside zlib, as zlib.compressobj
_GZIP_WBITS = 31  # 15-bit window + gzip header/trailer
_DEF_MEM_LEVEL = 8  # zlib's DEF_MEM_LEVEL, what zlib.compressobj uses


class _ZStream(ctypes.Structure):
    _fields_ = [
        ("next_in", ctypes.c_void_p),
        ("avail_in", ctypes.c_uint),
        ("total_in", ctypes.c_ulong),
        ("next_out", ctypes.c_void_p),
        ("avail_out", ctypes.c_uint),
        ("total_out", ctypes.c_ulong),
        ("msg", ctypes.c_char_p),
        ("state", ctypes.c_void_p),
        ("zalloc", ctypes.c_void_p),
        ("zfree", ctypes.c_void_p),
        ("opaque", ctypes.c_void_p),
        ("data_type", ctypes.c_int),
        ("adler", ctypes.c_ulong),
        ("reserved", ctypes.c_ulong),
    ]


class NativeZlib:
    """Direct libz binding with gzip framing and caller-buffer I/O.

    ``compress_into`` runs deflate with exactly the parameters of
    ``zlib.compressobj(wbits=31)`` (default level, memLevel 8, default
    strategy), so this binding and the stdlib module write the same bytes
    from the same libz.  ``decompress_into`` inflates multi-member
    streams (RFC 1952 concatenation, what block-parallel compression
    writes)."""

    def __init__(self, lib: ctypes.CDLL):
        self._lib = lib
        ver = lib.zlibVersion
        ver.restype = ctypes.c_char_p
        ver.argtypes = []
        self._version = ver()
        for name in ("deflateInit2_", "inflateInit2_"):
            getattr(lib, name).restype = ctypes.c_int
        lib.deflateInit2_.argtypes = [
            ctypes.POINTER(_ZStream), ctypes.c_int, ctypes.c_int,
            ctypes.c_int, ctypes.c_int, ctypes.c_int,
            ctypes.c_char_p, ctypes.c_int,
        ]
        lib.inflateInit2_.argtypes = [
            ctypes.POINTER(_ZStream), ctypes.c_int,
            ctypes.c_char_p, ctypes.c_int,
        ]
        for name in ("deflate", "inflate", "deflateEnd", "inflateEnd",
                     "inflateReset"):
            getattr(lib, name).restype = ctypes.c_int
        lib.deflate.argtypes = [ctypes.POINTER(_ZStream), ctypes.c_int]
        lib.inflate.argtypes = [ctypes.POINTER(_ZStream), ctypes.c_int]
        lib.deflateEnd.argtypes = [ctypes.POINTER(_ZStream)]
        lib.inflateEnd.argtypes = [ctypes.POINTER(_ZStream)]
        lib.inflateReset.argtypes = [ctypes.POINTER(_ZStream)]

    def compress_bound(self, n: int) -> int:
        """Worst-case gzip size of ``n`` input bytes: deflate's stored
        blocks (5 bytes per 16 KiB window) + gzip header/trailer."""
        return n + (n >> 12) + (n >> 14) + (n >> 25) + 13 + 18

    def compress_into(self, src, out: np.ndarray,
                      level: int = _Z_DEFAULT_LEVEL) -> int:
        buf = _as_u8(src)
        if out.size < self.compress_bound(buf.size):
            raise ValueError("gzip: output buffer too small")
        strm = _ZStream()
        rc = self._lib.deflateInit2_(
            ctypes.byref(strm), level, _Z_DEFLATED, _GZIP_WBITS,
            _DEF_MEM_LEVEL, 0, self._version, ctypes.sizeof(_ZStream))
        if rc != _Z_OK:
            raise ValueError(f"gzip: deflateInit failed (rc={rc})")
        try:
            strm.next_in = ctypes.c_void_p(buf.ctypes.data)
            strm.avail_in = buf.size
            strm.next_out = ctypes.c_void_p(out.ctypes.data)
            strm.avail_out = out.size
            rc = self._lib.deflate(ctypes.byref(strm), _Z_FINISH)
            if rc != _Z_STREAM_END:
                raise ValueError(f"gzip: deflate failed (rc={rc})")
            return int(strm.total_out)
        finally:
            self._lib.deflateEnd(ctypes.byref(strm))

    def compress(self, data, level: int = _Z_DEFAULT_LEVEL) -> bytes:
        buf = _as_u8(data)
        out = np.empty(self.compress_bound(buf.size), dtype=np.uint8)
        return out[: self.compress_into(buf, out, level)].tobytes()

    def decompress_into(self, src, out: np.ndarray,
                        expected_size: int) -> int:
        """Inflate a (possibly multi-member) gzip stream into ``out``;
        returns the produced length (``expected_size`` on success)."""
        buf = _as_u8(src)
        if out.size < expected_size:
            raise ValueError("gzip: output buffer too small")
        strm = _ZStream()
        rc = self._lib.inflateInit2_(
            ctypes.byref(strm), _GZIP_WBITS, self._version,
            ctypes.sizeof(_ZStream))
        if rc != _Z_OK:
            raise ValueError(f"gzip: inflateInit failed (rc={rc})")
        produced = 0
        consumed = 0
        try:
            while True:
                strm.next_in = ctypes.c_void_p(buf.ctypes.data + consumed)
                strm.avail_in = buf.size - consumed
                strm.next_out = ctypes.c_void_p(out.ctypes.data + produced)
                # capped at the expected size: a lying stream must not
                # write past the caller's slab
                strm.avail_out = expected_size - produced
                strm.total_in = 0
                strm.total_out = 0
                rc = self._lib.inflate(ctypes.byref(strm), _Z_FINISH)
                produced += int(strm.total_out)
                consumed += int(strm.total_in)
                if rc == _Z_STREAM_END:
                    if consumed >= buf.size:
                        return produced
                    # the next member follows (one that overflows the
                    # expected size dies on avail_out == 0)
                    rc = self._lib.inflateReset(ctypes.byref(strm))
                    if rc != _Z_OK:
                        raise ValueError(
                            f"gzip: inflateReset failed (rc={rc})")
                    continue
                raise ValueError(f"gzip: inflate failed (rc={rc})")
        finally:
            self._lib.inflateEnd(ctypes.byref(strm))

    def decompress(self, src, expected_size: int) -> bytes:
        out = np.empty(max(expected_size, 1), dtype=np.uint8)
        n = self.decompress_into(src, out, expected_size)
        return out[:n].tobytes()


# ----------------------------------------------------------------------
# zstd
# ----------------------------------------------------------------------

_ZSTD_CONTENTSIZE_UNKNOWN = 2**64 - 1
_ZSTD_CONTENTSIZE_ERROR = 2**64 - 2


class NativeZstd:
    """Direct libzstd binding (the one-shot API) with caller-buffer I/O.

    One-shot ``ZSTD_compress``/``ZSTD_decompress`` are thread-safe (each
    call uses its own implicit context), and ``ZSTD_decompress`` decodes
    concatenated frames in one call, the property block-parallel
    compression relies on.  ``frame_spans`` gives the frame boundaries,
    so the read side can decompress frames concurrently."""

    def __init__(self, lib: ctypes.CDLL):
        self._lib = lib
        names = ("ZSTD_compress", "ZSTD_decompress",
                 "ZSTD_compressBound", "ZSTD_isError",
                 "ZSTD_getFrameContentSize",
                 "ZSTD_findFrameCompressedSize")
        for name in names:
            if not hasattr(lib, name):
                raise RuntimeError(f"libzstd too old: missing {name}")
        lib.ZSTD_compress.restype = ctypes.c_size_t
        lib.ZSTD_compress.argtypes = [
            ctypes.c_void_p, ctypes.c_size_t,
            ctypes.c_void_p, ctypes.c_size_t, ctypes.c_int,
        ]
        lib.ZSTD_decompress.restype = ctypes.c_size_t
        lib.ZSTD_decompress.argtypes = [
            ctypes.c_void_p, ctypes.c_size_t,
            ctypes.c_void_p, ctypes.c_size_t,
        ]
        lib.ZSTD_compressBound.restype = ctypes.c_size_t
        lib.ZSTD_compressBound.argtypes = [ctypes.c_size_t]
        lib.ZSTD_isError.restype = ctypes.c_uint
        lib.ZSTD_isError.argtypes = [ctypes.c_size_t]
        lib.ZSTD_getFrameContentSize.restype = ctypes.c_ulonglong
        lib.ZSTD_getFrameContentSize.argtypes = [
            ctypes.c_void_p, ctypes.c_size_t]
        lib.ZSTD_findFrameCompressedSize.restype = ctypes.c_size_t
        lib.ZSTD_findFrameCompressedSize.argtypes = [
            ctypes.c_void_p, ctypes.c_size_t]
        self._err_name = getattr(lib, "ZSTD_getErrorName", None)
        if self._err_name is not None:
            self._err_name.restype = ctypes.c_char_p
            self._err_name.argtypes = [ctypes.c_size_t]

    def _check(self, code: int, what: str) -> int:
        if self._lib.ZSTD_isError(ctypes.c_size_t(code)):
            detail = ""
            if self._err_name is not None:
                name = self._err_name(ctypes.c_size_t(code))
                detail = f": {name.decode()}" if name else ""
            raise ValueError(f"zstd: {what} failed{detail}")
        return code

    def compress_bound(self, n: int) -> int:
        return int(self._lib.ZSTD_compressBound(n))

    def compress_into(self, src, out: np.ndarray, level: int = 3) -> int:
        buf = _as_u8(src)
        if out.size < self.compress_bound(buf.size):
            raise ValueError("zstd: output buffer too small")
        rc = self._lib.ZSTD_compress(out.ctypes.data, out.size,
                                     buf.ctypes.data, buf.size, level)
        return self._check(int(rc), "compress")

    def compress(self, data, level: int = 3) -> bytes:
        buf = _as_u8(data)
        out = np.empty(self.compress_bound(buf.size), dtype=np.uint8)
        return out[: self.compress_into(buf, out, level)].tobytes()

    def decompress_into(self, src, out: np.ndarray,
                        expected_size: int) -> int:
        """One-shot decompress (concatenated frames too); returns the
        produced length.  The output is capped at ``expected_size``, so a
        lying stream cannot write past the caller's slab."""
        buf = _as_u8(src)
        if out.size < expected_size:
            raise ValueError("zstd: output buffer too small")
        rc = self._lib.ZSTD_decompress(
            out.ctypes.data, ctypes.c_size_t(expected_size),
            buf.ctypes.data, buf.size)
        return self._check(int(rc), "decompress")

    def decompress(self, src, expected_size: int) -> bytes:
        out = np.empty(max(expected_size, 1), dtype=np.uint8)
        n = self.decompress_into(src, out, expected_size)
        return out[:n].tobytes()

    def frame_spans(self, src):
        """``[(offset, compressed_len, content_len), ...]`` of each frame
        of a (possibly concatenated) zstd stream, or None when a frame's
        content size is not recorded (the read path then decodes the
        stream in one call).  Raises ValueError on a corrupt header."""
        buf = _as_u8(src)
        spans = []
        pos = 0
        while pos < buf.size:
            view = buf[pos:]
            clen = self._lib.ZSTD_findFrameCompressedSize(
                view.ctypes.data, view.size)
            if self._lib.ZSTD_isError(ctypes.c_size_t(clen)):
                raise ValueError("zstd: corrupt frame header")
            ulen = int(self._lib.ZSTD_getFrameContentSize(
                view.ctypes.data, view.size))
            if ulen in (_ZSTD_CONTENTSIZE_UNKNOWN,
                        _ZSTD_CONTENTSIZE_ERROR):
                return None
            spans.append((pos, int(clen), ulen))
            pos += int(clen)
        return spans


_lock = threading.Lock()
_zlib_inst: "NativeZlib | None | bool" = False  # False: not tried yet
_zstd_inst: "NativeZstd | None | bool" = False


def zlib_native() -> NativeZlib | None:
    """The process-wide libz binding, or None when no libz loads; raises
    OSError when ``TPQ_ZLIB_LIB`` names a library that does not load."""
    global _zlib_inst
    with _lock:
        if _zlib_inst is False:
            lib = _dlopen("TPQ_ZLIB_LIB",
                          ("libz.so.1", "libz.so", "libz.dylib"))
            try:
                _zlib_inst = NativeZlib(lib) if lib is not None else None
            except AttributeError:
                _zlib_inst = None
        return _zlib_inst


def zstd_native() -> NativeZstd | None:
    """The process-wide libzstd binding, or None when no libzstd loads;
    raises OSError when ``TPQ_ZSTD_LIB`` names a library that does not
    load."""
    global _zstd_inst
    with _lock:
        if _zstd_inst is False:
            lib = _dlopen("TPQ_ZSTD_LIB",
                          ("libzstd.so.1", "libzstd.so", "libzstd.dylib"))
            try:
                _zstd_inst = NativeZstd(lib) if lib is not None else None
            except (RuntimeError, AttributeError):
                _zstd_inst = None
        return _zstd_inst
