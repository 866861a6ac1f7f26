"""Vectorized LSB-first bit-packing (NumPy).

Values occupy consecutive bits starting at the least-significant bit of
byte 0 (the "RLE/bit-packed hybrid" order used by dictionary indices and
levels).  Explode bytes to a little-endian bit matrix, regroup into
``width``-bit lanes, and reduce with powers of two — one implementation
for every width 0..64.
"""

from __future__ import annotations

import numpy as np

__all__ = ["unpack", "unpack_msb", "pack", "pack_msb"]


def _out_dtype(width: int):
    return np.uint64 if width > 32 else np.uint32


def unpack(data, count: int, width: int) -> np.ndarray:
    """Unpack ``count`` LSB-first ``width``-bit values from ``data``.

    Returns an unsigned array (uint32 for width<=32, else uint64).
    ``data`` may contain trailing padding bits/bytes; they are ignored.
    """
    if width == 0:
        return np.zeros(count, dtype=np.uint32)
    if not 0 < width <= 64:
        raise ValueError(f"bit width {width} out of range 0..64")
    buf = np.frombuffer(data, dtype=np.uint8)
    need_bits = count * width
    need_bytes = (need_bits + 7) // 8
    if len(buf) < need_bytes:
        raise ValueError(
            f"bit-packed input too short: need {need_bytes} bytes for "
            f"{count} x {width}-bit values, have {len(buf)}"
        )
    if width % 8 == 0:
        # Byte-aligned fast path: each value is width/8 little-endian bytes.
        k = width // 8
        padded = np.zeros((count, 8), dtype=np.uint8)
        padded[:, :k] = np.asarray(buf[:need_bytes]).reshape(count, k)
        return padded.view("<u8").reshape(count).astype(_out_dtype(width))
    bits = np.unpackbits(buf[:need_bytes], bitorder="little", count=need_bits)
    lanes = bits.reshape(count, width).astype(_out_dtype(width))
    weights = (np.uint64(1) << np.arange(width, dtype=np.uint64)).astype(
        _out_dtype(width)
    )
    return lanes @ weights if width > 1 else lanes[:, 0]


def pack(values, width: int) -> bytes:
    """Pack unsigned values into LSB-first ``width``-bit lanes.

    Output is padded with zero bits to a whole number of bytes."""
    if width == 0:
        return b""
    if not 0 < width <= 64:
        raise ValueError(f"bit width {width} out of range 0..64")
    v = np.asarray(values).astype(np.uint64, copy=False)
    _check_fits(v, width)
    if width % 8 == 0:
        k = width // 8
        vb = np.ascontiguousarray(v).view(np.uint8).reshape(-1, 8)
        return np.ascontiguousarray(vb[:, :k]).tobytes()
    # Stay in uint8 end to end: explode each value's 8 LE bytes to a 64-bit
    # row, keep the low `width` bits, and re-pack.  (A uint64 bit matrix
    # here would be 8x the memory and dominated encode time.)
    vb = np.ascontiguousarray(v).view(np.uint8).reshape(-1, 8)
    bits = np.unpackbits(vb, axis=1, bitorder="little")[:, :width]
    return np.packbits(bits.reshape(-1), bitorder="little").tobytes()


def unpack_msb(data, count: int, width: int) -> np.ndarray:
    """Unpack the deprecated BIT_PACKED (MSB-first) level encoding: value
    ``i`` is bits ``[i * width, (i + 1) * width)`` of the stream, most
    significant bit of each byte first."""
    if width == 0:
        return np.zeros(count, dtype=np.uint32)
    buf = np.frombuffer(data, dtype=np.uint8)
    need_bits = count * width
    need_bytes = (need_bits + 7) // 8
    if len(buf) < need_bytes:
        raise ValueError("bit-packed (msb) input too short")
    bits = np.unpackbits(buf[:need_bytes], bitorder="big", count=need_bits)
    lanes = bits.reshape(count, width).astype(_out_dtype(width))
    weights = (np.uint64(1) << np.arange(width - 1, -1, -1,
                                         dtype=np.uint64)).astype(
        _out_dtype(width))
    return lanes @ weights if width > 1 else lanes[:, 0]


def pack_msb(values, width: int) -> bytes:
    """Pack into the deprecated BIT_PACKED (MSB-first) encoding, the
    inverse of :func:`unpack_msb`; raises ValueError on a value wider
    than ``width`` bits."""
    if width == 0:
        return b""
    v = np.asarray(values).astype(np.uint64, copy=False)
    _check_fits(v, width)
    shifts = np.arange(width - 1, -1, -1, dtype=np.uint64)
    bits = ((v[:, None] >> shifts) & np.uint64(1)).astype(np.uint8)
    return np.packbits(bits.reshape(-1), bitorder="big").tobytes()


def _check_fits(v: np.ndarray, width: int) -> None:
    """Dropping high bits would silently corrupt the stream (e.g. a level 2
    written at width 1 reads back as 0 = null) — refuse instead."""
    if width < 64 and v.size and bool((v >> np.uint64(width)).any()):
        raise ValueError(
            f"value {int(v.max())} does not fit in {width} bits"
        )
