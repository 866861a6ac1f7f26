"""Per-physical-type value handling: coercion, sort order, statistics.

A :class:`ValueHandler` knows one leaf's physical type and its sort
order (signed or unsigned integers, from ``UINT_n`` or an unsigned
``INTEGER`` logical type), coerces predicate constants to the column's
storage (:meth:`ValueHandler.coerce_one`; :meth:`ValueHandler.get_values`
for the row writer's values), turns a decoded column into Python values
for the row reader (:meth:`ValueHandler.to_pylist`), reduces a column to its
``(min, max)`` under that order and frames one value as the Statistics,
page index and bloom filter hold it: PLAIN, without a length prefix.
"""

from __future__ import annotations

import numpy as np

from ..cpu.plain import ByteArrayColumn
from ..format.metadata import ConvertedType, SchemaElement, Type
from ..kernels.encode import DeviceValues

__all__ = ["ValueHandler", "handler_for", "is_unsigned"]

_INT_RANGE = {
    Type.INT32: (-(2**31), 2**31 - 1),
    Type.INT64: (-(2**63), 2**63 - 1),
}

_UNSIGNED = (ConvertedType.UINT_8, ConvertedType.UINT_16,
             ConvertedType.UINT_32, ConvertedType.UINT_64)


def is_unsigned(element: SchemaElement) -> bool:
    """Unsigned statistics order: a UINT_n converted type or an unsigned
    INTEGER logical type."""
    if element.converted_type in _UNSIGNED:
        return True
    lt = element.logicalType
    return lt is not None and lt.INTEGER is not None \
        and not lt.INTEGER.isSigned


class ValueHandler:
    """Coercion and statistics of one leaf's physical type."""

    def __init__(self, element: SchemaElement):
        self.element = element
        self.ptype = Type(element.type)
        self.type_length = element.type_length
        self.unsigned = is_unsigned(element)

    def coerce_one(self, v):
        """One Python or numpy value in the column's storage form; raises
        TypeError for a value of the wrong kind, ValueError out of
        range."""
        p = self.ptype
        if p == Type.BOOLEAN:
            if isinstance(v, (bool, np.bool_)):
                return bool(v)
            raise TypeError(f"expected bool, got {type(v).__name__}")
        if p in (Type.INT32, Type.INT64):
            if isinstance(v, (bool, np.bool_)) or not isinstance(
                    v, (int, np.integer)):
                raise TypeError(f"expected int, got {type(v).__name__}")
            iv = int(v)
            lo, hi = _INT_RANGE[p]
            if self.unsigned:
                # unsigned logical values are stored two's-complement
                if not 0 <= iv <= 2 * hi + 1:
                    if not lo <= iv <= hi:
                        raise ValueError(f"{iv} out of range for u{p.name}")
                elif iv > hi:
                    iv -= 2 * (hi + 1)
                return iv
            if not lo <= iv <= hi:
                raise ValueError(f"{iv} out of range for {p.name}")
            return iv
        if p in (Type.FLOAT, Type.DOUBLE):
            if isinstance(v, (int, float, np.floating, np.integer)) \
                    and not isinstance(v, (bool, np.bool_)):
                return float(v)
            raise TypeError(f"expected float, got {type(v).__name__}")
        if p == Type.BYTE_ARRAY:
            if isinstance(v, str):
                return v.encode("utf-8")
            if isinstance(v, (bytes, bytearray, np.bytes_)):
                return bytes(v)
            raise TypeError(f"expected bytes/str, got {type(v).__name__}")
        if p == Type.FIXED_LEN_BYTE_ARRAY:
            if isinstance(v, str):
                v = v.encode("utf-8")
            if isinstance(v, (bytes, bytearray, np.bytes_)):
                b = bytes(v)
                if self.type_length and len(b) != self.type_length:
                    raise ValueError(
                        f"fixed_len_byte_array({self.type_length}) got "
                        f"{len(b)} bytes")
                return b
            raise TypeError(f"expected bytes, got {type(v).__name__}")
        if p == Type.INT96:
            if isinstance(v, (bytes, bytearray)) and len(v) == 12:
                return bytes(v)
            if isinstance(v, (tuple, list, np.ndarray)) and len(v) == 3:
                return np.asarray(v, dtype="<u4").tobytes()
            raise TypeError("INT96 expects 12 bytes or 3 uint32 words")
        raise TypeError(f"unsupported physical type {p}")

    def get_values(self, v, repeated: bool) -> list:
        """A row's value of the leaf as a list of coerced values: a scalar
        is one value; a repeated leaf takes a sequence too, each item one
        value."""
        if repeated and isinstance(v, (list, tuple, np.ndarray)):
            return [self.coerce_one(x) for x in v]
        return [self.coerce_one(v)]

    def to_pylist(self, column) -> list:
        """A decoded column as Python values: bools, ints (an unsigned
        column's as the non-negative int), floats, and bytes for BYTE_ARRAY,
        FIXED_LEN_BYTE_ARRAY and INT96 (its 12 bytes)."""
        p = self.ptype
        if isinstance(column, ByteArrayColumn):
            return column.to_list()
        arr = np.asarray(column)
        if p == Type.BOOLEAN:
            return [bool(x) for x in arr]
        if p in (Type.INT32, Type.INT64):
            if self.unsigned:
                udt = np.uint32 if p == Type.INT32 else np.uint64
                return [int(x) for x in arr.view(udt)]
            return [int(x) for x in arr]
        if p in (Type.FLOAT, Type.DOUBLE):
            return [float(x) for x in arr]
        if p in (Type.FIXED_LEN_BYTE_ARRAY, Type.INT96):
            if p == Type.INT96:
                arr = arr.view(np.uint8).reshape(len(arr), 12)
            return [bytes(row) for row in arr]
        raise TypeError(f"unsupported physical type {p}")

    def finalize(self, buffered: list):
        """Coerced values as the codec layer's column (a numpy array of
        the storage dtype, ``(N, L)`` u8 rows, ``(N, 3)`` u32 INT96
        words, or a :class:`ByteArrayColumn`)."""
        p = self.ptype
        if p == Type.BOOLEAN:
            return np.asarray(buffered, dtype=np.bool_)
        if p in (Type.INT32, Type.INT64, Type.FLOAT, Type.DOUBLE):
            return np.asarray(buffered, dtype={
                Type.INT32: np.int32, Type.INT64: np.int64,
                Type.FLOAT: np.float32, Type.DOUBLE: np.float64}[p])
        if p == Type.BYTE_ARRAY:
            return ByteArrayColumn.from_list(buffered)
        if p == Type.FIXED_LEN_BYTE_ARRAY:
            n = self.type_length or 0
            if not buffered:
                return np.empty((0, n), dtype=np.uint8)
            return np.frombuffer(b"".join(buffered), dtype=np.uint8) \
                .reshape(len(buffered), n)
        if p == Type.INT96:
            if not buffered:
                return np.empty((0, 3), dtype="<u4")
            return np.frombuffer(b"".join(buffered), dtype="<u4") \
                .reshape(len(buffered), 3)
        raise TypeError(f"unsupported physical type {p}")

    def min_max(self, column):
        """``(min, max)`` raw values under the column's sort order, or
        ``(None, None)`` for an empty column, an all-NaN float column and
        INT96 (whose order the spec leaves undefined)."""
        p = self.ptype
        if p == Type.INT96:
            return None, None
        if isinstance(column, DeviceValues):
            return column.min_max(unsigned=self.unsigned)
        if isinstance(column, ByteArrayColumn):
            if len(column) == 0:
                return None, None
            return _byte_array_min_max(column)
        arr = np.asarray(column)
        if arr.size == 0:
            return None, None
        if p == Type.FIXED_LEN_BYTE_ARRAY:
            return _refine_lex(arr, np.min), _refine_lex(arr, np.max)
        if self.unsigned and p in (Type.INT32, Type.INT64):
            u = arr.view(np.uint32 if p == Type.INT32 else np.uint64)
            return arr[int(np.argmin(u))], arr[int(np.argmax(u))]
        if p in (Type.FLOAT, Type.DOUBLE):
            finite = arr[~np.isnan(arr)]
            if finite.size == 0:
                return None, None
            return finite.min(), finite.max()
        return arr.min(), arr.max()

    def encode_stat_value(self, v) -> bytes | None:
        """One value PLAIN-encoded, without a length prefix."""
        p = self.ptype
        if v is None:
            return None
        if p == Type.BOOLEAN:
            return b"\x01" if v else b"\x00"
        if p == Type.INT32:
            return int(v).to_bytes(4, "little", signed=True)
        if p == Type.INT64:
            return int(v).to_bytes(8, "little", signed=True)
        if p == Type.FLOAT:
            return np.float32(v).tobytes()
        if p == Type.DOUBLE:
            return np.float64(v).tobytes()
        return bytes(v)

    def decode_stat_value(self, b: bytes | None):
        p = self.ptype
        if b is None:
            return None
        if p == Type.BOOLEAN:
            return bool(b[0]) if b else None
        if p in (Type.INT32, Type.INT64):
            return int.from_bytes(b, "little", signed=True)
        if p == Type.FLOAT:
            return float(np.frombuffer(b, dtype="<f4")[0])
        if p == Type.DOUBLE:
            return float(np.frombuffer(b, dtype="<f8")[0])
        return bytes(b)

    def stats_bytewise_comparable(self) -> bool:
        """False when the column's sort order is not the raw byte order
        of its statistics: DECIMAL over BYTE_ARRAY or FIXED_LEN_BYTE_ARRAY
        sorts as a signed big-endian number, FLOAT16 as an IEEE half.
        Pruning treats such bounds as absent."""
        el = self.element
        if el.type not in (Type.BYTE_ARRAY, Type.FIXED_LEN_BYTE_ARRAY):
            return True
        if el.converted_type == ConvertedType.DECIMAL:
            return False
        lt = el.logicalType
        return lt is None or lt.set_member()[0] not in ("DECIMAL",
                                                         "FLOAT16")

    def decode_stat_logical(self, b: bytes | None):
        """A Statistics or page-index bound as its logical value: an
        unsigned column's bound comes back as the non-negative int (the
        bytes hold its two's-complement storage)."""
        v = self.decode_stat_value(b)
        if (v is not None and self.unsigned
                and self.ptype in (Type.INT32, Type.INT64) and v < 0):
            v += 1 << (32 if self.ptype == Type.INT32 else 64)
        return v


def _refine_lex(rows: np.ndarray, reduce_fn) -> bytes:
    """The unsigned-lexicographic extreme (``reduce_fn`` ``np.min`` or
    ``np.max``) of a ``(k, L)`` byte matrix: candidates narrow one byte
    plane at a time; past 96 planes that leave several candidates, or
    rows of more than 4,096 bytes, a sort of the survivors decides."""
    if rows.dtype != np.uint8:
        rows = np.ascontiguousarray(rows).view(np.uint8)
    k, length = rows.shape
    cand = np.arange(k)
    bail = length > 4096
    if not bail:
        passes = 0
        for j in range(length):
            col = rows[cand, j]
            mn = int(col.min())
            mx = int(col.max())
            if mn != mx:
                cand = cand[col == (mn if reduce_fn is np.min else mx)]
                if cand.size == 1:
                    break
            passes += 1
            if passes > 96 and cand.size > 1:
                bail = True
                break
    if bail:
        sub = np.ascontiguousarray(rows[cand])
        view = np.sort(sub.view(np.dtype((np.void, length))).reshape(-1))
        return bytes(view[0] if reduce_fn is np.min else view[-1])
    return bytes(rows[int(cand[0])])


def _byte_array_min_max(col: ByteArrayColumn):
    """``(min, max)`` of variable-length bytes: each length group's
    extremes (:func:`_refine_lex` over its rows), then the least and the
    greatest of those under bytes order, where a value sorts after its
    own prefixes."""
    offs = np.asarray(col.offsets, dtype=np.int64)
    data = np.asarray(col.data)
    lens = offs[1:] - offs[:-1]
    mins: list = []
    maxs: list = []
    for length in np.unique(lens):
        length = int(length)
        sel = np.nonzero(lens == length)[0]
        if length == 0:
            mins.append(b"")
            maxs.append(b"")
            continue
        starts = offs[:-1][sel]
        if length > 4096 or sel.size < 8:
            vals = [bytes(data[int(s): int(s) + length]) for s in starts]
            mins.append(min(vals))
            maxs.append(max(vals))
            continue
        rows = data[starts[:, None] + np.arange(length, dtype=np.int64)]
        mins.append(_refine_lex(rows, np.min))
        maxs.append(_refine_lex(rows, np.max))
    return min(mins), max(maxs)


def handler_for(element: SchemaElement) -> ValueHandler:
    return ValueHandler(element)
