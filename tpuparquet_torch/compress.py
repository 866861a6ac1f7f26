"""Block codecs of the read and write path: UNCOMPRESSED and SNAPPY.

SNAPPY runs in C (``csrc/snappy.c``), compiled with the host C compiler
at first use and loaded with ctypes; the same library scans a block's
tags into the token tables of the device decompressor
(:func:`snappy_scan_tokens`).  There is no pure-Python fallback:
without a compiler, SNAPPY raises.  Any other codec raises
:class:`NotImplementedError` naming it.
"""

from __future__ import annotations

import ctypes
import shutil
import threading

import numpy as np

from .format.metadata import CompressionCodec
from .varint import read_uvarint

__all__ = ["compress_block", "decompress_block", "snappy_scan_tokens",
           "snappy_single_literal_view"]

# the format's shortest copy; the JAX package's writer uses the same
# floor, which keeps numeric pages' 4..7-byte matches
_MIN_MATCH = 4

_lock = threading.Lock()
_lib = None


def _snappy():
    """The loaded snappy library (built on first call)."""
    global _lib
    with _lock:
        if _lib is None:
            from ._build import CSRC, build

            cc = shutil.which("cc") or shutil.which("gcc")
            if cc is None:
                raise RuntimeError(
                    "SNAPPY needs a C compiler to build csrc/snappy.c")
            (path,) = build([(CSRC / "snappy.c",
                              [cc, "-O3", "-shared", "-fPIC"])])
            lib = ctypes.CDLL(str(path))
            size_t_p = ctypes.POINTER(ctypes.c_size_t)
            lib.tpq_snappy_decompress.restype = ctypes.c_int
            lib.tpq_snappy_decompress.argtypes = [
                ctypes.c_void_p, ctypes.c_size_t, ctypes.c_void_p,
                ctypes.c_size_t, size_t_p]
            lib.tpq_snappy_compress_opt.restype = ctypes.c_int
            lib.tpq_snappy_compress_opt.argtypes = [
                ctypes.c_void_p, ctypes.c_size_t, ctypes.c_void_p,
                ctypes.c_size_t, size_t_p, ctypes.c_int]
            lib.tpq_snappy_max_compressed_length.restype = ctypes.c_uint64
            lib.tpq_snappy_max_compressed_length.argtypes = [
                ctypes.c_uint64]
            lib.tpq_snappy_scan_tokens.restype = ctypes.c_int
            lib.tpq_snappy_scan_tokens.argtypes = [
                ctypes.c_void_p, ctypes.c_size_t, ctypes.c_void_p,
                ctypes.c_void_p, ctypes.c_int64, ctypes.c_void_p,
                ctypes.c_size_t, ctypes.POINTER(ctypes.c_int64), size_t_p,
                ctypes.POINTER(ctypes.c_uint64)]
            _lib = lib
        return _lib


def _u8(data) -> np.ndarray:
    if isinstance(data, np.ndarray):
        return np.ascontiguousarray(data.reshape(-1).view(np.uint8))
    return np.frombuffer(data, dtype=np.uint8)


def _check_codec(codec) -> CompressionCodec:
    codec = CompressionCodec(codec)
    if codec not in (CompressionCodec.UNCOMPRESSED,
                     CompressionCodec.SNAPPY):
        raise NotImplementedError(
            f"codec {codec.name} is not supported by tpuparquet_torch "
            "(UNCOMPRESSED and SNAPPY only)")
    return codec


def decompress_block(codec, payload, uncompressed_size: int,
                     arena=None) -> np.ndarray:
    """Decompress one page body to a u8 array of exactly
    ``uncompressed_size`` bytes; raises ValueError on corrupt input.
    With ``arena`` (a :class:`~tpuparquet_torch.kernels.arena.HostArena`)
    a SNAPPY block decompresses into a slab borrowed from it, valid until
    the arena's ``release_all``; else into a fresh array."""
    codec = _check_codec(codec)
    src = _u8(payload)
    if codec == CompressionCodec.UNCOMPRESSED:
        if src.size != uncompressed_size:
            raise ValueError(
                f"uncompressed page holds {src.size} bytes, header says "
                f"{uncompressed_size}")
        return src
    lib = _snappy()
    # 16 bytes of slack let the decoder use fixed-width copies
    out = (np.empty(uncompressed_size + 16, dtype=np.uint8) if arena is None
           else arena.borrow(uncompressed_size + 16))
    produced = ctypes.c_size_t(0)
    rc = lib.tpq_snappy_decompress(
        src.ctypes.data, src.size, out.ctypes.data, out.size,
        ctypes.byref(produced))
    if rc != 0:
        raise ValueError(f"snappy: corrupt block (code {rc})")
    if produced.value != uncompressed_size:
        raise ValueError(
            f"snappy: block holds {produced.value} bytes, header says "
            f"{uncompressed_size}")
    return out[:uncompressed_size]


def snappy_scan_tokens(block):
    """Parse a snappy block's tag stream without decompressing it:
    ``(tok_out_end, tok_src, literals, out_len)``.  Token ``i`` covers
    output bytes ``[tok_out_end[i-1], tok_out_end[i])``; ``tok_src[i]``
    is ``-(literal offset + 1)`` for a literal, else the output position
    its copy reads from.  Raises ValueError on a corrupt block."""
    lib = _snappy()
    buf = _u8(block)
    cap = max(buf.size, 1)  # every token takes at least one input byte
    tok_end = np.empty(cap, dtype=np.int64)
    tok_src = np.empty(cap, dtype=np.int64)
    lits = np.empty(cap, dtype=np.uint8)
    n_tok = ctypes.c_int64()
    lit_len = ctypes.c_size_t()
    out_len = ctypes.c_uint64()
    rc = lib.tpq_snappy_scan_tokens(
        buf.ctypes.data, buf.size, tok_end.ctypes.data, tok_src.ctypes.data,
        cap, lits.ctypes.data, lits.size, ctypes.byref(n_tok),
        ctypes.byref(lit_len), ctypes.byref(out_len))
    if rc != 0:
        raise ValueError(f"snappy: corrupt block (code {rc})")
    t = int(n_tok.value)
    return (tok_end[:t], tok_src[:t], lits[: lit_len.value],
            int(out_len.value))


def snappy_single_literal_view(block) -> np.ndarray | None:
    """The payload of a snappy block that is one literal token covering
    the whole block (an incompressible page: the payload IS the
    decompressed bytes), as a zero-copy view; None for any other
    block."""
    buf = _u8(block)
    try:
        total, pos = read_uvarint(buf, 0)
    except ValueError:
        return None
    if pos >= buf.size:
        return None
    tag = int(buf[pos])
    pos += 1
    if tag & 3:
        return None  # first token is a copy
    ln = tag >> 2
    if ln >= 60:
        extra = ln - 59
        if pos + extra > buf.size:
            return None
        ln = 0
        for i in range(extra):
            ln |= int(buf[pos + i]) << (8 * i)
        pos += extra
    ln += 1
    if ln != total or pos + ln != buf.size:
        return None  # not a single literal covering the whole block
    return buf[pos : pos + ln]


def compress_block(codec, data) -> bytes:
    codec = _check_codec(codec)
    src = _u8(data)
    if codec == CompressionCodec.UNCOMPRESSED:
        return src.tobytes()
    lib = _snappy()
    out = np.empty(lib.tpq_snappy_max_compressed_length(src.size),
                   dtype=np.uint8)
    produced = ctypes.c_size_t(0)
    rc = lib.tpq_snappy_compress_opt(
        src.ctypes.data, src.size, out.ctypes.data, out.size,
        ctypes.byref(produced), _MIN_MATCH)
    if rc != 0:
        raise ValueError(f"snappy: compress failed (code {rc})")
    return out[:produced.value].tobytes()
