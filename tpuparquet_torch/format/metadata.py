"""Parquet metadata structures (thrift ``parquet.thrift``, format 2.8.0).

The wire structs are *declared* — each class lists ``(field_id, name,
type)`` tuples mirroring ``parquet.thrift`` — and a single generic
compact-protocol encoder/decoder in this module walks the declarations.
Unknown fields are skipped on read (forward compatibility), absent
optional fields are omitted on write.  This copy declares the structs the
read and write paths touch, with every logical type of the union, the
page encoding stats and a row group's sorting columns (which a rescue
copies), the page index (``ColumnIndex``, ``OffsetIndex``) and the bloom
filter header; fields it does not declare (encryption) are skipped on
read and never written.

Enums carry the exact numeric values from the spec (``parquet.thrift``:
``Type`` block at :32, ``ConvertedType`` :48, ``FieldRepetitionType`` :182,
``Encoding`` :407, ``CompressionCodec`` :479, ``PageType`` :489,
``BoundaryOrder`` :502).
"""

from __future__ import annotations

import enum

from .compact import CT, CompactReader, CompactWriter

__all__ = [
    "Type", "ConvertedType", "FieldRepetitionType", "Encoding",
    "CompressionCodec", "PageType", "Statistics", "StringType", "ListType",
    "MapType", "EnumType", "DateType", "NullType", "TimeType", "JsonType",
    "BsonType", "PageEncodingStats", "SortingColumn",
    "MilliSeconds", "MicroSeconds", "NanoSeconds", "TimeUnit",
    "TimestampType", "DecimalType", "IntType", "UUIDType", "Float16Type",
    "LogicalType", "SchemaElement", "BoundaryOrder",
    "DataPageHeader", "IndexPageHeader", "DictionaryPageHeader",
    "DataPageHeaderV2", "SplitBlockAlgorithm", "BloomFilterAlgorithm",
    "XxHash", "BloomFilterHash", "Uncompressed", "BloomFilterCompression",
    "BloomFilterHeader", "PageHeader", "KeyValue", "ColumnMetaData",
    "ColumnChunk", "RowGroup", "PageLocation", "OffsetIndex",
    "ColumnIndex", "TypeDefinedOrder", "ColumnOrder", "FileMetaData",
    "decode_struct", "encode_struct",
]


# --------------------------------------------------------------------------
# Enums
# --------------------------------------------------------------------------

class Type(enum.IntEnum):
    BOOLEAN = 0
    INT32 = 1
    INT64 = 2
    INT96 = 3
    FLOAT = 4
    DOUBLE = 5
    BYTE_ARRAY = 6
    FIXED_LEN_BYTE_ARRAY = 7


class ConvertedType(enum.IntEnum):
    UTF8 = 0
    MAP = 1
    MAP_KEY_VALUE = 2
    LIST = 3
    ENUM = 4
    DECIMAL = 5
    DATE = 6
    TIME_MILLIS = 7
    TIME_MICROS = 8
    TIMESTAMP_MILLIS = 9
    TIMESTAMP_MICROS = 10
    UINT_8 = 11
    UINT_16 = 12
    UINT_32 = 13
    UINT_64 = 14
    INT_8 = 15
    INT_16 = 16
    INT_32 = 17
    INT_64 = 18
    JSON = 19
    BSON = 20
    INTERVAL = 21


class FieldRepetitionType(enum.IntEnum):
    REQUIRED = 0
    OPTIONAL = 1
    REPEATED = 2


class Encoding(enum.IntEnum):
    PLAIN = 0
    PLAIN_DICTIONARY = 2
    RLE = 3
    BIT_PACKED = 4
    DELTA_BINARY_PACKED = 5
    DELTA_LENGTH_BYTE_ARRAY = 6
    DELTA_BYTE_ARRAY = 7
    RLE_DICTIONARY = 8
    BYTE_STREAM_SPLIT = 9


class CompressionCodec(enum.IntEnum):
    UNCOMPRESSED = 0
    SNAPPY = 1
    GZIP = 2
    LZO = 3
    BROTLI = 4
    LZ4 = 5  # deprecated Hadoop-framed LZ4 (undocumented framing)
    ZSTD = 6
    LZ4_RAW = 7  # raw LZ4 block format (what modern writers emit)


class PageType(enum.IntEnum):
    DATA_PAGE = 0
    INDEX_PAGE = 1
    DICTIONARY_PAGE = 2
    DATA_PAGE_V2 = 3


class BoundaryOrder(enum.IntEnum):
    UNORDERED = 0
    ASCENDING = 1
    DESCENDING = 2


# --------------------------------------------------------------------------
# Type descriptors
# --------------------------------------------------------------------------

class _TD:
    """Base type descriptor: knows its compact type id and how to read/write
    a value of that type *outside* a field header (i.e. as a container
    element or after the header was consumed)."""

    ct: int

    def read(self, r: CompactReader):
        raise NotImplementedError

    def write(self, w: CompactWriter, v) -> None:
        raise NotImplementedError


class _TBool(_TD):
    ct = CT.TRUE  # placeholder; bool fields are special-cased

    def read(self, r):
        return r.read_byte() == CT.TRUE

    def write(self, w, v):
        w.write_byte(CT.TRUE if v else CT.FALSE)


class _TI8(_TD):
    ct = CT.I8

    def read(self, r):
        b = r.read_byte()
        return b - 256 if b >= 128 else b

    def write(self, w, v):
        w.write_byte(v & 0xFF)


class _TVarint(_TD):
    def read(self, r):
        return r.read_zigzag()

    def write(self, w, v):
        w.write_zigzag(int(v))


class _TI16(_TVarint):
    ct = CT.I16


class _TI32(_TVarint):
    ct = CT.I32


class _TI64(_TVarint):
    ct = CT.I64


class _TDouble(_TD):
    ct = CT.DOUBLE

    def read(self, r):
        return r.read_double()

    def write(self, w, v):
        w.write_double(float(v))


class _TBinary(_TD):
    ct = CT.BINARY

    def read(self, r):
        return r.read_binary()

    def write(self, w, v):
        w.write_binary(bytes(v))


class _TString(_TD):
    ct = CT.BINARY

    def read(self, r):
        return r.read_binary().decode("utf-8", errors="replace")

    def write(self, w, v):
        w.write_binary(v.encode("utf-8"))


class _TEnum(_TD):
    ct = CT.I32

    def __init__(self, enum_cls):
        self.enum_cls = enum_cls

    def read(self, r):
        v = r.read_zigzag()
        try:
            return self.enum_cls(v)
        except ValueError:
            return v  # tolerate unknown enum values from future writers

    def write(self, w, v):
        w.write_zigzag(int(v))


class _TList(_TD):
    ct = CT.LIST

    def __init__(self, elem: _TD):
        self.elem = elem

    def read(self, r):
        etype, size = r.read_list_header()
        elem = self.elem
        if isinstance(elem, _TBool):
            return [r.read_byte() == CT.TRUE for _ in range(size)]
        return [elem.read(r) for _ in range(size)]

    def write(self, w, v):
        elem = self.elem
        ect = CT.TRUE if isinstance(elem, _TBool) else elem.ct
        w.write_list_header(ect, len(v))
        for x in v:
            elem.write(w, x)


class _TStruct(_TD):
    ct = CT.STRUCT

    def __init__(self, cls):
        self.cls = cls

    def read(self, r):
        return decode_struct(self.cls, r)

    def write(self, w, v):
        encode_struct(v, w)


BOOL = _TBool()
I8 = _TI8()
I16 = _TI16()
I32 = _TI32()
I64 = _TI64()
DOUBLE = _TDouble()
BINARY = _TBinary()
STRING = _TString()


# --------------------------------------------------------------------------
# Declarative struct machinery
# --------------------------------------------------------------------------

class ThriftStruct:
    """Base for declarative thrift structs.

    Subclasses set ``FIELDS = [(fid, name, type_descriptor), ...]`` in
    ``parquet.thrift`` order.  Instances hold each field as an attribute
    (``None`` = absent).  Equality compares all fields (handy in tests).
    """

    FIELDS: list = []
    # filled by __init_subclass__
    _BY_ID: dict = {}
    _NAMES: tuple = ()

    def __init_subclass__(cls, **kw):
        super().__init_subclass__(**kw)
        cls._BY_ID = {fid: (name, td) for fid, name, td in cls.FIELDS}
        cls._NAMES = tuple(name for _, name, _td in cls.FIELDS)

    def __init__(self, **kwargs):
        for name in self._NAMES:
            setattr(self, name, kwargs.pop(name, None))
        if kwargs:
            raise TypeError(
                f"{type(self).__name__}: unknown fields {sorted(kwargs)}"
            )

    def __eq__(self, other):
        if type(other) is not type(self):
            return NotImplemented
        return all(
            getattr(self, n) == getattr(other, n) for n in self._NAMES
        )

    def __repr__(self):
        parts = [
            f"{n}={getattr(self, n)!r}"
            for n in self._NAMES
            if getattr(self, n) is not None
        ]
        return f"{type(self).__name__}({', '.join(parts)})"

    # Convenience serialization entry points -------------------------------

    def to_bytes(self) -> bytes:
        w = CompactWriter()
        encode_struct(self, w)
        return w.getvalue()

    @classmethod
    def from_bytes(cls, buf, pos: int = 0):
        r = CompactReader(buf, pos)
        return decode_struct(cls, r)


def decode_struct(cls, r: CompactReader):
    obj = cls.__new__(cls)
    for name in cls._NAMES:
        setattr(obj, name, None)
    last_fid = 0
    by_id = cls._BY_ID
    while True:
        ctype, fid = r.read_field_header(last_fid)
        if ctype == CT.STOP:
            return obj
        entry = by_id.get(fid)
        if entry is None:
            # Unknown field: skip (bools carry their value in the header).
            r.skip(ctype)
        else:
            name, td = entry
            if isinstance(td, _TBool):
                if ctype in (CT.TRUE, CT.FALSE):
                    setattr(obj, name, ctype == CT.TRUE)
                else:  # declared/wire mismatch: skip by wire type
                    r.skip(ctype)
            elif ctype == td.ct:
                setattr(obj, name, td.read(r))
            else:
                # Wire type disagrees with the declaration (corrupt input or
                # schema evolution): always consume by the *wire* type so the
                # stream stays in sync, and leave the field absent.
                r.skip(ctype)
        last_fid = fid


def encode_struct(obj, w: CompactWriter) -> None:
    last_fid = 0
    for fid, name, td in obj.FIELDS:
        v = getattr(obj, name)
        if v is None:
            continue
        if isinstance(td, _TBool):
            w.write_field_header(CT.TRUE if v else CT.FALSE, fid, last_fid)
        else:
            w.write_field_header(td.ct, fid, last_fid)
            td.write(w, v)
        last_fid = fid
    w.write_stop()


def _S(cls) -> _TStruct:
    return _TStruct(cls)


# --------------------------------------------------------------------------
# The structs (field ids match parquet.thrift, apache-parquet-format-2.8.0)
# --------------------------------------------------------------------------

class Statistics(ThriftStruct):
    FIELDS = [
        (1, "max", BINARY),
        (2, "min", BINARY),
        (3, "null_count", I64),
        (4, "distinct_count", I64),
        (5, "max_value", BINARY),
        (6, "min_value", BINARY),
    ]


class StringType(ThriftStruct):
    FIELDS = []


class MapType(ThriftStruct):
    FIELDS = []


class ListType(ThriftStruct):
    FIELDS = []


class EnumType(ThriftStruct):
    FIELDS = []


class DateType(ThriftStruct):
    FIELDS = []


class NullType(ThriftStruct):
    FIELDS = []


class MilliSeconds(ThriftStruct):
    FIELDS = []


class MicroSeconds(ThriftStruct):
    FIELDS = []


class NanoSeconds(ThriftStruct):
    FIELDS = []


class TimeUnit(ThriftStruct):
    """Union: exactly one of MILLIS/MICROS/NANOS is set."""

    FIELDS = [
        (1, "MILLIS", _S(MilliSeconds)),
        (2, "MICROS", _S(MicroSeconds)),
        (3, "NANOS", _S(NanoSeconds)),
    ]


class TimestampType(ThriftStruct):
    FIELDS = [(1, "isAdjustedToUTC", BOOL), (2, "unit", _S(TimeUnit))]


class TimeType(ThriftStruct):
    FIELDS = [(1, "isAdjustedToUTC", BOOL), (2, "unit", _S(TimeUnit))]


class DecimalType(ThriftStruct):
    FIELDS = [(1, "scale", I32), (2, "precision", I32)]


class IntType(ThriftStruct):
    FIELDS = [(1, "bitWidth", I8), (2, "isSigned", BOOL)]


class JsonType(ThriftStruct):
    FIELDS = []


class BsonType(ThriftStruct):
    FIELDS = []


class UUIDType(ThriftStruct):
    FIELDS = []


class Float16Type(ThriftStruct):
    FIELDS = []


class LogicalType(ThriftStruct):
    """Union: exactly one member set (parquet.thrift:322-344)."""

    FIELDS = [
        (1, "STRING", _S(StringType)),
        (2, "MAP", _S(MapType)),
        (3, "LIST", _S(ListType)),
        (4, "ENUM", _S(EnumType)),
        (5, "DECIMAL", _S(DecimalType)),
        (6, "DATE", _S(DateType)),
        (7, "TIME", _S(TimeType)),
        (8, "TIMESTAMP", _S(TimestampType)),
        (10, "INTEGER", _S(IntType)),
        (11, "UNKNOWN", _S(NullType)),
        (12, "JSON", _S(JsonType)),
        (13, "BSON", _S(BsonType)),
        (14, "UUID", _S(UUIDType)),
        (15, "FLOAT16", _S(Float16Type)),
    ]

    def set_member(self):
        """``(name, value)`` of the union's member that is set, or
        ``(None, None)``."""
        for name in self._NAMES:
            v = getattr(self, name)
            if v is not None:
                return name, v
        return None, None


class SchemaElement(ThriftStruct):
    FIELDS = [
        (1, "type", _TEnum(Type)),
        (2, "type_length", I32),
        (3, "repetition_type", _TEnum(FieldRepetitionType)),
        (4, "name", STRING),
        (5, "num_children", I32),
        (6, "converted_type", _TEnum(ConvertedType)),
        (7, "scale", I32),
        (8, "precision", I32),
        (9, "field_id", I32),
        (10, "logicalType", _S(LogicalType)),
    ]


class DataPageHeader(ThriftStruct):
    FIELDS = [
        (1, "num_values", I32),
        (2, "encoding", _TEnum(Encoding)),
        (3, "definition_level_encoding", _TEnum(Encoding)),
        (4, "repetition_level_encoding", _TEnum(Encoding)),
        (5, "statistics", _S(Statistics)),
    ]


class IndexPageHeader(ThriftStruct):
    FIELDS = []


class DictionaryPageHeader(ThriftStruct):
    FIELDS = [
        (1, "num_values", I32),
        (2, "encoding", _TEnum(Encoding)),
        (3, "is_sorted", BOOL),
    ]


class DataPageHeaderV2(ThriftStruct):
    FIELDS = [
        (1, "num_values", I32),
        (2, "num_nulls", I32),
        (3, "num_rows", I32),
        (4, "encoding", _TEnum(Encoding)),
        (5, "definition_levels_byte_length", I32),
        (6, "repetition_levels_byte_length", I32),
        (7, "is_compressed", BOOL),  # default true when absent
        (8, "statistics", _S(Statistics)),
    ]


class SplitBlockAlgorithm(ThriftStruct):
    FIELDS = []


class BloomFilterAlgorithm(ThriftStruct):
    FIELDS = [(1, "BLOCK", _S(SplitBlockAlgorithm))]


class XxHash(ThriftStruct):
    FIELDS = []


class BloomFilterHash(ThriftStruct):
    FIELDS = [(1, "XXHASH", _S(XxHash))]


class Uncompressed(ThriftStruct):
    FIELDS = []


class BloomFilterCompression(ThriftStruct):
    FIELDS = [(1, "UNCOMPRESSED", _S(Uncompressed))]


class BloomFilterHeader(ThriftStruct):
    FIELDS = [
        (1, "numBytes", I32),
        (2, "algorithm", _S(BloomFilterAlgorithm)),
        (3, "hash", _S(BloomFilterHash)),
        (4, "compression", _S(BloomFilterCompression)),
    ]


class PageHeader(ThriftStruct):
    FIELDS = [
        (1, "type", _TEnum(PageType)),
        (2, "uncompressed_page_size", I32),
        (3, "compressed_page_size", I32),
        (4, "crc", I32),
        (5, "data_page_header", _S(DataPageHeader)),
        (6, "index_page_header", _S(IndexPageHeader)),
        (7, "dictionary_page_header", _S(DictionaryPageHeader)),
        (8, "data_page_header_v2", _S(DataPageHeaderV2)),
    ]


class KeyValue(ThriftStruct):
    FIELDS = [(1, "key", STRING), (2, "value", STRING)]


class PageEncodingStats(ThriftStruct):
    FIELDS = [
        (1, "page_type", _TEnum(PageType)),
        (2, "encoding", _TEnum(Encoding)),
        (3, "count", I32),
    ]


class SortingColumn(ThriftStruct):
    FIELDS = [
        (1, "column_idx", I32),
        (2, "descending", BOOL),
        (3, "nulls_first", BOOL),
    ]


class ColumnMetaData(ThriftStruct):
    FIELDS = [
        (1, "type", _TEnum(Type)),
        (2, "encodings", _TList(_TEnum(Encoding))),
        (3, "path_in_schema", _TList(STRING)),
        (4, "codec", _TEnum(CompressionCodec)),
        (5, "num_values", I64),
        (6, "total_uncompressed_size", I64),
        (7, "total_compressed_size", I64),
        (8, "key_value_metadata", _TList(_S(KeyValue))),
        (9, "data_page_offset", I64),
        (10, "index_page_offset", I64),
        (11, "dictionary_page_offset", I64),
        (12, "statistics", _S(Statistics)),
        (13, "encoding_stats", _TList(_S(PageEncodingStats))),
        (14, "bloom_filter_offset", I64),
        (15, "bloom_filter_length", I32),
    ]


class ColumnChunk(ThriftStruct):
    FIELDS = [
        (1, "file_path", STRING),
        (2, "file_offset", I64),
        (3, "meta_data", _S(ColumnMetaData)),
        (4, "offset_index_offset", I64),
        (5, "offset_index_length", I32),
        (6, "column_index_offset", I64),
        (7, "column_index_length", I32),
    ]


class RowGroup(ThriftStruct):
    FIELDS = [
        (1, "columns", _TList(_S(ColumnChunk))),
        (2, "total_byte_size", I64),
        (3, "num_rows", I64),
        (4, "sorting_columns", _TList(_S(SortingColumn))),
        (5, "file_offset", I64),
        (6, "total_compressed_size", I64),
        (7, "ordinal", I16),
    ]


class PageLocation(ThriftStruct):
    FIELDS = [
        (1, "offset", I64),
        (2, "compressed_page_size", I32),
        (3, "first_row_index", I64),
    ]


class OffsetIndex(ThriftStruct):
    FIELDS = [(1, "page_locations", _TList(_S(PageLocation)))]


class ColumnIndex(ThriftStruct):
    FIELDS = [
        (1, "null_pages", _TList(BOOL)),
        (2, "min_values", _TList(BINARY)),
        (3, "max_values", _TList(BINARY)),
        (4, "boundary_order", _TEnum(BoundaryOrder)),
        (5, "null_counts", _TList(I64)),
    ]


class TypeDefinedOrder(ThriftStruct):
    FIELDS = []


class ColumnOrder(ThriftStruct):
    FIELDS = [(1, "TYPE_ORDER", _S(TypeDefinedOrder))]


class FileMetaData(ThriftStruct):
    FIELDS = [
        (1, "version", I32),
        (2, "schema", _TList(_S(SchemaElement))),
        (3, "num_rows", I64),
        (4, "row_groups", _TList(_S(RowGroup))),
        (5, "key_value_metadata", _TList(_S(KeyValue))),
        (6, "created_by", STRING),
        (7, "column_orders", _TList(_S(ColumnOrder))),
    ]
