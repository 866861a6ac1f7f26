"""RLE / bit-packed hybrid encoding (NumPy): run scan, expand, encode.

Wire format: a stream of runs, each headed by a uvarint ``h``:

* ``h & 1 == 1``: bit-packed run of ``(h >> 1) * 8`` values, LSB-first.
* ``h & 1 == 0``: RLE run of ``h >> 1`` copies of one value stored in
  ``ceil(width / 8)`` little-endian bytes.

Level streams of V1 pages, and the values of an RLE-encoded BOOLEAN page,
carry a 4-byte LE total-length prefix.  Decode
parses the run structure once into a run table (:func:`scan_hybrid`,
the host pass of the device plan) and expands it (:func:`expand_scan`);
encode (:func:`encode_hybrid`) chooses RLE for constant stretches of at
least 8 values, bit-packing elsewhere.  Widths up to 32 (levels,
dictionary indices) scan, expand and encode in C (``csrc/hybrid.c``,
``csrc/pack.c``), as the JAX package does; the Python scan and the
vectorised expand below are the plain versions the tests hold the C
passes to, and take wider values.
"""

from __future__ import annotations

import struct

import numpy as np

from ..varint import read_uvarint
from .bitpack import unpack

__all__ = [
    "as_uint32",
    "scan_hybrid",
    "expand_scan",
    "decode_hybrid",
    "decode_hybrid_prefixed",
    "slice_prefixed",
    "encode_hybrid",
    "encode_hybrid_prefixed",
]


def as_uint32(values) -> np.ndarray:
    """u32 array of non-negative level/index values (a reinterpreting
    view for int32 input, no copy)."""
    a = np.asarray(values)
    if a.dtype == np.int32:
        return a.view(np.uint32)
    return np.asarray(a, dtype=np.uint32)


def scan_hybrid(data, count: int, width: int, pos: int = 0):
    """Parse run headers into a run table.

    Returns ``(run_ends, run_is_rle, run_value, run_bp_start, bp_bytes,
    n_bp_values, end_pos)``: ``run_ends`` is the cumulative output count
    per run, ``bp_bytes`` the concatenated bit-packed segments and
    ``run_bp_start`` each run's value offset into that stream.  Widths up
    to 32 take the C scanner."""
    if width <= 32:
        from ..native import hybrid_native

        return hybrid_native().scan(data, count, width, pos)
    return _scan_hybrid_py(data, count, width, pos)


def _scan_hybrid_py(data, count: int, width: int, pos: int = 0):
    """The run-header scan in Python (widths past 32)."""
    buf = data.tobytes() if isinstance(data, np.ndarray) else bytes(data)
    vbytes = (width + 7) // 8
    vmask = (1 << width) - 1 if width else 0
    ends, is_rle, values, bp_starts, bp_segments = [], [], [], [], []
    filled = 0
    n_bp = 0
    while filled < count:
        h, pos = read_uvarint(buf, pos)
        if h & 1:
            n = (h >> 1) * 8
            nbytes = (n * width + 7) // 8
            if pos + nbytes > len(buf):
                raise ValueError("truncated bit-packed run")
            bp_segments.append(np.frombuffer(buf, np.uint8, nbytes, pos))
            bp_starts.append(n_bp)
            values.append(0)
            is_rle.append(False)
            pos += nbytes
            # the bit-packed stream keeps the run's full n lanes; the
            # consumers index through run_bp_start, never into padding
            n_bp += n
            filled += min(n, count - filled)
        else:
            n = h >> 1
            if n == 0:
                raise ValueError("zero-length RLE run")
            if pos + vbytes > len(buf):
                raise ValueError("truncated RLE run value")
            v = int.from_bytes(buf[pos : pos + vbytes], "little")
            if v & ~vmask:
                raise ValueError("RLE run value exceeds bit width")
            pos += vbytes
            values.append(v)
            is_rle.append(True)
            bp_starts.append(n_bp)
            filled += min(n, count - filled)
        ends.append(filled)
    bp_bytes = (np.concatenate(bp_segments) if bp_segments
                else np.zeros(0, dtype=np.uint8))
    return (
        np.asarray(ends, dtype=np.int32),
        np.asarray(is_rle, dtype=bool),
        np.asarray(values, dtype=np.uint32),
        np.asarray(bp_starts, dtype=np.int32),
        bp_bytes,
        n_bp,
        pos,
    )


def expand_scan(run_ends, run_is_rle, run_value, run_bp_start, bp_bytes,
                n_bp: int, count: int, width: int) -> np.ndarray:
    """Expand a run table to ``count`` u32 values: one fill or unpack for a
    single run, one repeat when every run is RLE, else one C pass (widths
    up to 32) or a vectorised search over the runs."""
    if count == 0 or len(run_ends) == 0:
        return np.zeros(count, dtype=np.uint32)
    if len(run_ends) == 1:
        if run_is_rle[0]:
            return np.full(count, run_value[0], dtype=np.uint32)
        return unpack(bp_bytes, n_bp, width)[:count]
    if run_is_rle.all():
        lens = np.diff(run_ends, prepend=np.int32(0))
        return np.repeat(run_value.astype(np.uint32), lens)[:count]
    from ..native import pack_native

    out = pack_native().hybrid_expand(
        (run_ends, run_is_rle, run_value, run_bp_start, bp_bytes, n_bp),
        count, width)
    if out is not None:
        return out
    unpacked = (unpack(bp_bytes, n_bp, width) if n_bp
                else np.zeros(1, dtype=np.uint32))
    idx = np.arange(count, dtype=np.int64)
    run = np.searchsorted(run_ends, idx, side="right")
    run = np.minimum(run, len(run_ends) - 1)
    run_start = np.where(run > 0, run_ends[run - 1], 0)
    bp_pos = np.minimum(run_bp_start[run] + (idx - run_start),
                        max(n_bp - 1, 0))
    return np.where(run_is_rle[run], run_value[run],
                    unpacked[bp_pos]).astype(np.uint32)


def decode_hybrid(data, count: int, width: int, pos: int = 0) -> np.ndarray:
    """Exactly ``count`` ``width``-bit values as u32 (scan, then expand);
    trailing bytes are ignored."""
    if width == 0:
        return np.zeros(count, dtype=np.uint32)
    return expand_scan(*scan_hybrid(data, count, width, pos)[:6], count,
                       width)


def slice_prefixed(data, pos: int = 0):
    """A 4-byte-LE-length-prefixed hybrid stream at ``pos``, checked
    against the buffer: ``(stream, end_pos)``, ``stream`` exactly the
    prefixed bytes."""
    if pos + 4 > len(data):
        raise ValueError("truncated hybrid length prefix")
    (size,) = struct.unpack_from("<I", data, pos)
    end = pos + 4 + size
    if end > len(data):
        raise ValueError(f"hybrid stream length {size} exceeds buffer")
    return data[pos + 4 : end], end


def decode_hybrid_prefixed(data, count: int, width: int, pos: int = 0):
    """The 4-byte-length-prefixed form: ``(values, end_pos)``."""
    stream, end = slice_prefixed(data, pos)
    return decode_hybrid(stream, count, width), end


def encode_hybrid(values, width: int) -> bytes:
    """Encode values with RLE for constant stretches >= 8, else
    bit-packing, in one C pass, byte for byte the JAX package's stream.
    Bit-packed runs cover groups of 8 values; the final partial group is
    padded with zeros (readers stop at the count).  Levels and dictionary
    indices arrive as (u)int32 and encode straight from their words
    (``csrc/hybrid.c``); any other array widens to u64 first
    (``csrc/pack.c``, widths up to 64), so a negative value wraps high
    and is refused.  int32 takes the u64 pass at width 32, where a
    negative's u32 view would fit."""
    v = np.asarray(values)
    if not 0 <= width <= 64:
        raise ValueError(f"hybrid width {width} out of range 0..64")
    if width == 0 or v.size == 0:
        return b""
    from ..native import hybrid_native, pack_native

    if width <= 32 and (v.dtype == np.uint32
                        or (v.dtype == np.int32 and width < 32)):
        return hybrid_native().encode32(as_uint32(v), width)
    return pack_native().hybrid_encode(np.asarray(v, dtype=np.uint64),
                                       width)


def encode_hybrid_prefixed(values, width: int) -> bytes:
    body = encode_hybrid(values, width)
    return struct.pack("<I", len(body)) + body
