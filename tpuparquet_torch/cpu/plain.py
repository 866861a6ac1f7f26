"""PLAIN codec for every physical type.

Fixed-width values are little-endian on the wire, which is native on
every platform the port targets, so their decode is a zero-copy
reinterpret of the buffer: INT96 as ``(N, 3)`` u32 words,
FIXED_LEN_BYTE_ARRAY as ``(N, L)`` u8 rows.  BOOLEAN packs one bit a
value, LSB first.  BYTE_ARRAY values are ``(u32-LE length, bytes)``
records; they decode to offsets + data (:class:`ByteArrayColumn`, the
Arrow layout the device path keeps) with one C pass over the length
prefixes and one C gather (``csrc/bytes.c``).
"""

from __future__ import annotations

import numpy as np

from ..format.metadata import Type
from .bitpack import pack, unpack

__all__ = ["PHYSICAL_DTYPES", "ByteArrayColumn", "decode_plain",
           "encode_plain"]

PHYSICAL_DTYPES = {
    Type.INT32: np.dtype("<i4"),
    Type.INT64: np.dtype("<i8"),
    Type.FLOAT: np.dtype("<f4"),
    Type.DOUBLE: np.dtype("<f8"),
}


class ByteArrayColumn:
    """Arrow-style variable-length binary column: int64 offsets + byte data.

    ``offsets`` has ``N + 1`` entries; value ``i`` is
    ``data[offsets[i]:offsets[i+1]]``.
    """

    __slots__ = ("offsets", "data")

    def __init__(self, offsets: np.ndarray, data: np.ndarray):
        self.offsets = np.asarray(offsets, dtype=np.int64)
        self.data = np.asarray(data, dtype=np.uint8)

    def __len__(self) -> int:
        return len(self.offsets) - 1

    def __getitem__(self, i: int) -> bytes:
        return self.data[self.offsets[i] : self.offsets[i + 1]].tobytes()

    def lengths(self) -> np.ndarray:
        return np.diff(self.offsets)

    def to_list(self) -> list[bytes]:
        data = self.data.tobytes()
        offs = self.offsets
        return [data[offs[i] : offs[i + 1]] for i in range(len(self))]

    def __eq__(self, other):
        if not isinstance(other, ByteArrayColumn):
            return NotImplemented
        return (
            np.array_equal(self.offsets, other.offsets)
            and np.array_equal(self.data, other.data)
        )

    def __repr__(self):
        return f"ByteArrayColumn(n={len(self)}, nbytes={self.data.size})"


def decode_plain(ptype, data, count: int, type_length: int | None = None):
    """Decode ``count`` PLAIN values: a zero-copy view for fixed-width
    types (``type_length`` bytes a row for FIXED_LEN_BYTE_ARRAY), a bool
    array for BOOLEAN, a :class:`ByteArrayColumn` (its own copy of the
    bytes) for BYTE_ARRAY.  Trailing bytes are ignored."""
    buf = np.frombuffer(data, dtype=np.uint8)
    ptype = Type(ptype)
    if ptype == Type.BOOLEAN:
        return unpack(buf, count, 1).astype(np.bool_)
    if ptype in (Type.INT96, Type.FIXED_LEN_BYTE_ARRAY):
        row = 12 if ptype == Type.INT96 else type_length
        if not row:
            raise ValueError("FIXED_LEN_BYTE_ARRAY requires type_length")
        if buf.size < count * row:
            raise ValueError(f"PLAIN {ptype.name}: input too short")
        rows = buf[: count * row].reshape(count, row)
        return rows.view("<u4") if ptype == Type.INT96 else rows
    if ptype == Type.BYTE_ARRAY:
        from ..native import bytes_native

        nat = bytes_native()
        positions, offsets = nat.byte_array_scan(buf, count)
        return ByteArrayColumn(offsets, nat.gather_var(
            buf, positions, offsets[1:] - offsets[:-1], int(offsets[-1])))
    dt = PHYSICAL_DTYPES[ptype]
    need = count * dt.itemsize
    if buf.size < need:
        raise ValueError(
            f"PLAIN {ptype.name}: need {need} bytes for {count} "
            f"values, have {buf.size}")
    return buf[:need].view(dt)


def encode_plain(ptype, values) -> bytes:
    """PLAIN-encode an array (fixed-width types: a bool array, ``(N, 3)``
    u32 INT96 words, ``(N, L)`` u8 FIXED_LEN_BYTE_ARRAY rows) or a
    :class:`ByteArrayColumn` (BYTE_ARRAY, one C pass)."""
    ptype = Type(ptype)
    if ptype == Type.BYTE_ARRAY:
        from ..native import bytes_native

        return bytes_native().byte_array_emit(values.data,
                                              values.offsets).tobytes()
    if ptype == Type.BOOLEAN:
        return pack(np.asarray(values, dtype=np.bool_).astype(np.uint8), 1)
    if ptype == Type.INT96:
        return np.ascontiguousarray(values, dtype="<u4").tobytes()
    if ptype == Type.FIXED_LEN_BYTE_ARRAY:
        return np.ascontiguousarray(values, dtype=np.uint8).tobytes()
    return np.ascontiguousarray(values, dtype=PHYSICAL_DTYPES[ptype]) \
        .tobytes()
