"""Data pages v1 and v2 and the dictionary page: CRC, level split, value
encoders, page writers.

Layouts:

* **V1 data page**: body = [rep levels (4-byte-length-prefixed RLE)]
  [def levels (same)] [encoded values]; the whole body is compressed.
* **V2 data page**: [rep levels][def levels][values]; the level streams
  carry no length prefix (the header gives their byte lengths) and stay
  uncompressed; only the values block is compressed, and only when
  ``is_compressed`` is not false.
* **Dictionary page**: PLAIN-encoded distinct values, whole body
  compressed; at most one per chunk, first.

A data page's compressed part goes through
:func:`~tpuparquet_torch.compress.page_compress`: with
``compress_workers > 1`` a large GZIP or ZSTD body splits into frames
compressed one a worker, as the JAX package's native page path splits
it; the dictionary page is always compressed whole, as there.

Data pages take the native page path: ``csrc/page.c`` lays the body
into one buffer in one pass, the codec compresses it in place and the
CRC runs in C, with no intermediate Python bytes
(:func:`_write_page_native`).  The file bytes
are the pure path's either way.  A page the native path cannot write
(a user's compressor registered on the codec, a short buffer, a value
the encoder refuses, or a fault fired at ``io.pages.page_write``) is
written by the pure path instead, before anything of it was written.
``pages_written`` counts every page, ``pages_assembled_native`` the
native ones, and ``write_encode_s``, ``write_compress_s`` and
``write_assemble_s`` the native path's stages.

The page CRC (``PageHeader.crc``) is the standard gzip-polynomial CRC32
over the page bytes as they appear in the file, stored as a signed i32.

:func:`decode_values` decodes a page's non-dictionary values on the host
(every encoding the port reads): the host decode of a unit the device
read degraded (``kernels/device.py`` ``cpu_fallback_values``), and of the
filtered read's pages.  :func:`decode_data_page_v1`,
:func:`decode_data_page_v2` and :func:`decode_dictionary_page` decode a
whole page on the host into a :class:`DecodedPage` (levels, and values
or dictionary indices), for ``io/chunk.py`` ``read_chunk``; a data page's
decompressed bytes are the fault site ``io.pages.page_decode``.  A data
page's write is the fault site ``io.pages.page_write``.
"""

from __future__ import annotations

import os
import struct
import time
import zlib

import numpy as np

from ..compress import builtin_uncompressed_registered, compress_block, \
    decompress_block, page_codec_settings, page_compress, \
    page_compress_bound, page_compress_into
from ..cpu.bss import decode_byte_stream_split, encode_byte_stream_split
from ..cpu.delta import decode_delta_binary_packed, \
    decode_delta_byte_array, decode_delta_length_byte_array, \
    encode_delta_binary_packed, encode_delta_byte_array, \
    encode_delta_length_byte_array
from ..cpu.hybrid import as_uint32, decode_hybrid_prefixed, encode_hybrid, \
    encode_hybrid_prefixed, scan_hybrid
from ..cpu.dictionary import decode_dict_indices, encode_dict_indices
from ..cpu.levels import decode_levels_bitpacked, decode_levels_raw, \
    decode_levels_v1
from ..cpu.plain import PHYSICAL_DTYPES, ByteArrayColumn, decode_plain, \
    encode_plain
from ..errors import CorruptPageError, TransientIOError
from ..faults import fault_point, filter_bytes
from ..format.compact import CompactWriter
from ..kernels.encode import DeviceValues
from ..native import hybrid_encode_cap, page_native
from ..stats import current_stats
from ..format.metadata import (
    CompressionCodec,
    DataPageHeader,
    DataPageHeaderV2,
    DictionaryPageHeader,
    Encoding,
    PageHeader,
    PageType,
    Type,
    encode_struct,
)

__all__ = [
    "DecodedPage",
    "SUPPORTED_DATA_ENCODINGS",
    "decode_data_page_v1",
    "decode_data_page_v2",
    "decode_dictionary_page",
    "crc_verify_default",
    "decode_values",
    "encode_values",
    "page_crc32",
    "page_crc_default",
    "verify_page_crc",
    "scan_levels_v1",
    "scan_levels_v2",
    "encode_dict_indices",
    "write_data_page_v1",
    "write_data_page_v2",
    "write_dictionary_page",
]


# Value encodings a column of each physical type may be written with, as
# in the JAX package's table
SUPPORTED_DATA_ENCODINGS = {
    Type.BOOLEAN: {Encoding.PLAIN, Encoding.RLE},
    Type.INT32: {Encoding.PLAIN, Encoding.DELTA_BINARY_PACKED,
                 Encoding.BYTE_STREAM_SPLIT},
    Type.INT64: {Encoding.PLAIN, Encoding.DELTA_BINARY_PACKED,
                 Encoding.BYTE_STREAM_SPLIT},
    Type.INT96: {Encoding.PLAIN},
    Type.FLOAT: {Encoding.PLAIN, Encoding.BYTE_STREAM_SPLIT},
    Type.DOUBLE: {Encoding.PLAIN, Encoding.BYTE_STREAM_SPLIT},
    Type.BYTE_ARRAY: {Encoding.PLAIN, Encoding.DELTA_LENGTH_BYTE_ARRAY,
                      Encoding.DELTA_BYTE_ARRAY},
    Type.FIXED_LEN_BYTE_ARRAY: {Encoding.PLAIN, Encoding.DELTA_BYTE_ARRAY,
                                Encoding.BYTE_STREAM_SPLIT},
}


def page_crc32(*segments) -> int:
    """CRC over the page's on-file body segments, as the SIGNED i32 the
    thrift field stores."""
    crc = 0
    for seg in segments:
        crc = zlib.crc32(seg, crc)
    return crc - (1 << 32) if crc >= (1 << 31) else crc


def page_crc_default() -> bool:
    """Write-side gate: emit ``PageHeader.crc``?  On unless
    ``TPQ_PAGE_CRC=0``; per writer, ``FileWriter(page_crc=...)``."""
    return os.environ.get("TPQ_PAGE_CRC", "1") != "0"


def crc_verify_default() -> bool:
    """Read-side gate: verify CRCs when a page header carries one?  On
    unless ``TPQ_PAGE_CRC_VERIFY=0``; per reader,
    ``FileReader(verify_crc=...)``."""
    return os.environ.get("TPQ_PAGE_CRC_VERIFY", "1") != "0"


def verify_page_crc(header: PageHeader, payload, *, enabled: bool = True,
                    column=None, page=None) -> bool:
    """Check ``payload`` against ``header.crc``; raises
    :class:`CorruptPageError` on mismatch and counts ``crc_mismatches``.
    Returns True when a CRC was present and checked (the caller counts
    ``pages_crc_verified``); a no-op when the header has none or
    ``enabled`` is false."""
    if header.crc is None or not enabled:
        return False
    want = header.crc & 0xFFFFFFFF
    got = zlib.crc32(payload) & 0xFFFFFFFF
    if got != want:
        from ..stats import current_stats

        st = current_stats()
        if st is not None:
            st.crc_mismatches += 1
        raise CorruptPageError(
            f"page CRC mismatch: header 0x{want:08x}, computed "
            f"0x{got:08x}", column=column, page=page)
    return True


def scan_levels_v1(raw, n: int, max_level: int, pos: int,
                   encoding=Encoding.RLE):
    """Split one V1 level stream off a page body.

    Returns ``(scan | None, host levels | None, end pos)``: the run table
    of a length-prefixed hybrid stream, left unexpanded, or the int32
    levels of a deprecated BIT_PACKED stream (``ceil(n * width / 8)``
    bytes, MSB-first), decoded on the host as the reference decodes them;
    both None when ``max_level == 0``, which has no stream.  Any other
    ``encoding`` (RLE, another value, a number outside the enum, or none)
    reads as RLE, as the reference's device plan reads it."""
    if max_level == 0:
        return None, None, pos
    width = int(max_level).bit_length()
    if encoding == Encoding.BIT_PACKED:
        nbytes = (n * width + 7) // 8
        return (None, decode_levels_bitpacked(raw[pos : pos + nbytes], n,
                                              max_level), pos + nbytes)
    if pos + 4 > len(raw):
        raise ValueError("truncated hybrid length prefix")
    (size,) = struct.unpack_from("<I", raw, pos)
    if pos + 4 + size > len(raw):
        raise ValueError(f"hybrid stream length {size} exceeds page")
    sc = scan_hybrid(raw[pos + 4 : pos + 4 + size], n, width)
    return sc, None, pos + 4 + size


def scan_levels_v2(payload, h: DataPageHeaderV2, n: int, max_rep: int,
                   max_def: int):
    """Split a V2 page into its level run tables and values block.
    Returns ``(rep scan | None, def scan | None, values offset)``; the
    levels are read from the uncompressed prefix (rep first), without a
    length prefix.  Raises ValueError when the header's level lengths
    overrun the page."""
    rl_len = h.repetition_levels_byte_length or 0
    dl_len = h.definition_levels_byte_length or 0
    if rl_len < 0 or dl_len < 0 or rl_len + dl_len > len(payload):
        raise ValueError("V2 level lengths exceed page size")
    rl = dl = None
    if max_rep:
        rl = scan_hybrid(payload[:rl_len], n, int(max_rep).bit_length())
    if max_def:
        dl = scan_hybrid(payload[rl_len : rl_len + dl_len], n,
                         int(max_def).bit_length())
    return rl, dl, rl_len + dl_len


def decode_values(ptype: Type, encoding: Encoding, data, count: int,
                  type_length=None):
    """Decode ``count`` non-dictionary values of one page on the host:
    a numpy array (``(N, 3)`` u32 for INT96, ``(N, L)`` u8 rows for
    FIXED_LEN_BYTE_ARRAY) or a :class:`ByteArrayColumn`."""
    if encoding == Encoding.PLAIN:
        return decode_plain(ptype, data, count, type_length)
    if encoding == Encoding.RLE:
        if ptype != Type.BOOLEAN:
            raise ValueError("RLE data encoding is boolean-only")
        vals, _ = decode_hybrid_prefixed(data, count, 1)
        return vals.astype(np.bool_)
    if encoding == Encoding.DELTA_BINARY_PACKED:
        if ptype not in (Type.INT32, Type.INT64):
            raise ValueError("DELTA_BINARY_PACKED is int32/int64-only")
        dtype = np.int32 if ptype == Type.INT32 else np.int64
        vals, _ = decode_delta_binary_packed(data, dtype)
        if vals.size != count:
            raise ValueError(
                f"delta stream has {vals.size} values, expected {count}")
        return vals
    if encoding == Encoding.DELTA_LENGTH_BYTE_ARRAY:
        if ptype != Type.BYTE_ARRAY:
            raise ValueError("DELTA_LENGTH_BYTE_ARRAY is byte_array-only")
        col, _ = decode_delta_length_byte_array(data, count)
        return col
    if encoding == Encoding.DELTA_BYTE_ARRAY:
        if ptype not in (Type.BYTE_ARRAY, Type.FIXED_LEN_BYTE_ARRAY):
            raise ValueError("DELTA_BYTE_ARRAY needs a byte-array type")
        col, _ = decode_delta_byte_array(data, count)
        if ptype == Type.FIXED_LEN_BYTE_ARRAY:
            n = type_length or 0
            if len(col) and (col.lengths() != n).any():
                raise ValueError("DELTA_BYTE_ARRAY: wrong fixed length")
            return col.data.reshape(count, n)
        return col
    if encoding == Encoding.BYTE_STREAM_SPLIT:
        if ptype == Type.FIXED_LEN_BYTE_ARRAY:
            n = type_length or 0
            need = count * n
            if len(data) < need:
                raise ValueError("BYTE_STREAM_SPLIT: input too short")
            streams = np.frombuffer(data, np.uint8,
                                    count=need).reshape(n, count)
            return np.ascontiguousarray(streams.T)
        dt = PHYSICAL_DTYPES.get(ptype)
        if dt is None:
            raise ValueError("BYTE_STREAM_SPLIT unsupported for this type")
        return decode_byte_stream_split(data, count, dt)
    raise ValueError(f"unsupported value encoding {encoding!r}")


class DecodedPage:
    """One decoded data page: its levels, and its values or its
    dictionary indices."""

    __slots__ = ("num_values", "rep_levels", "def_levels", "values",
                 "indices")

    def __init__(self, num_values, rep_levels, def_levels, values=None,
                 indices=None):
        self.num_values = num_values
        self.rep_levels = rep_levels
        self.def_levels = def_levels
        self.values = values
        self.indices = indices


_DICT_ENCODINGS = (Encoding.PLAIN_DICTIONARY, Encoding.RLE_DICTIONARY)


def decode_data_page_v1(header: PageHeader, payload, codec, node,
                        dictionary) -> DecodedPage:
    """A V1 data page on the host: the body decompressed whole, then the
    rep and def streams and the values."""
    h = header.data_page_header
    if h is None:
        raise CorruptPageError("DATA_PAGE header missing data_page_header")
    raw = decompress_block(codec, payload, header.uncompressed_page_size)
    raw = filter_bytes("io.pages.page_decode", raw)
    n = h.num_values
    if n is None or n < 0:
        raise CorruptPageError("DATA_PAGE header missing num_values")
    rep, pos = _decode_levels_dispatch_v1(
        raw, n, node.max_rep_level, h.repetition_level_encoding, 0)
    dl, pos = _decode_levels_dispatch_v1(
        raw, n, node.max_def_level, h.definition_level_encoding, pos)
    non_null = int((dl == node.max_def_level).sum()) if node.max_def_level \
        else n
    return _decode_page_values(h.encoding, raw[pos:], n, non_null, rep, dl,
                               node, dictionary)


def _decode_levels_dispatch_v1(raw, n: int, max_level: int, encoding,
                               pos: int):
    """One V1 level stream at ``pos``: ``(levels, end position)``."""
    if max_level == 0:
        return np.zeros(n, dtype=np.int32), pos
    if encoding == Encoding.BIT_PACKED:
        # deprecated MSB-first, no length prefix: width * n bits
        nbytes = (n * int(max_level).bit_length() + 7) // 8
        return (decode_levels_bitpacked(raw[pos : pos + nbytes], n,
                                        max_level), pos + nbytes)
    return decode_levels_v1(raw, n, max_level, pos)


def decode_data_page_v2(header: PageHeader, payload, codec, node,
                        dictionary) -> DecodedPage:
    """A V2 data page on the host: the levels read from the uncompressed
    prefix, the values block decompressed when ``is_compressed`` is not
    false, and ``num_nulls`` checked against the def levels."""
    h = header.data_page_header_v2
    if h is None:
        raise CorruptPageError(
            "DATA_PAGE_V2 header missing data_page_header_v2")
    n = h.num_values
    if n is None or n < 0:
        raise CorruptPageError("DATA_PAGE_V2 header missing num_values")
    payload = filter_bytes("io.pages.page_decode", payload)
    rl_len = h.repetition_levels_byte_length or 0
    dl_len = h.definition_levels_byte_length or 0
    if rl_len + dl_len > len(payload):
        raise CorruptPageError("V2 level lengths exceed page size")
    rep = decode_levels_raw(payload[:rl_len], n, node.max_rep_level)
    dl = decode_levels_raw(payload[rl_len : rl_len + dl_len], n,
                           node.max_def_level)
    values_seg = payload[rl_len + dl_len :]
    if h.is_compressed is not False:  # absent means compressed
        values_seg = decompress_block(
            codec, values_seg,
            header.uncompressed_page_size - rl_len - dl_len)
    else:
        # own the bytes: the payload may be a view of the source, which
        # decoded PLAIN values must not alias
        values_seg = bytes(values_seg)
    non_null = n - (h.num_nulls or 0)
    check = int((dl == node.max_def_level).sum()) if node.max_def_level \
        else n
    if check != non_null:
        raise CorruptPageError(
            f"V2 num_nulls {h.num_nulls} disagrees with def levels "
            f"({n - check} nulls)")
    return _decode_page_values(h.encoding, values_seg, n, non_null, rep, dl,
                               node, dictionary)


def _decode_page_values(encoding, data, n: int, non_null: int, rep, dl,
                        node, dictionary) -> DecodedPage:
    if encoding in _DICT_ENCODINGS:
        if dictionary is None:
            raise ValueError(
                "dictionary-encoded page but no dictionary page seen")
        return DecodedPage(n, rep, dl,
                           indices=decode_dict_indices(data, non_null))
    ptype = Type(node.element.type)
    if encoding not in SUPPORTED_DATA_ENCODINGS[ptype]:
        raise ValueError(
            f"encoding {Encoding(encoding).name} not valid for {ptype.name}")
    return DecodedPage(n, rep, dl, values=decode_values(
        ptype, encoding, data, non_null, node.element.type_length))


def decode_dictionary_page(header: PageHeader, payload, codec, node):
    """A dictionary page's PLAIN values, decompressed on the host."""
    h = header.dictionary_page_header
    if h is None:
        raise CorruptPageError("DICTIONARY_PAGE header missing its struct")
    if h.encoding not in (Encoding.PLAIN, Encoding.PLAIN_DICTIONARY):
        raise ValueError(f"dictionary page encoding {h.encoding} unsupported")
    if h.num_values is None or h.num_values < 0:
        raise CorruptPageError("DICTIONARY_PAGE header missing num_values")
    raw = decompress_block(codec, payload, header.uncompressed_page_size)
    return decode_plain(Type(node.element.type), raw, h.num_values,
                        node.element.type_length)


def _native_page_ctx(codec):
    """``(page pass, codec context or None)`` when the native page path
    writes the pure path's bytes for ``codec``, else None: a compressor
    a user registered on the codec (the UNCOMPRESSED slot included), or
    no native context for it
    (:func:`~tpuparquet_torch.compress.page_codec_settings`).  A chunk
    resolves it once for all its pages."""
    if codec == CompressionCodec.UNCOMPRESSED:
        return (page_native(), None) if builtin_uncompressed_registered() \
            else None
    pc = page_codec_settings(codec)
    return None if pc is None else (page_native(), pc)


def _native_values_view(ptype: Type, column, encoding) -> np.ndarray:
    """A page's values segment as u8 for the native page pass: a view of
    a PLAIN fixed-width numpy column (the bytes ``encode_plain`` would
    make), else the encoded bytes."""
    if encoding == Encoding.PLAIN and isinstance(column, np.ndarray):
        dt = PHYSICAL_DTYPES.get(ptype)
        if (ptype not in (Type.BOOLEAN, Type.FIXED_LEN_BYTE_ARRAY)
                and dt is not None and column.dtype == np.dtype(dt)
                and column.ndim == 1):
            return np.ascontiguousarray(column).view(np.uint8)
        if (ptype == Type.FIXED_LEN_BYTE_ARRAY
                and column.dtype == np.uint8 and column.ndim == 2):
            return np.ascontiguousarray(column).reshape(-1)
    return np.frombuffer(encode_values(ptype, encoding, column),
                         dtype=np.uint8)


def _write_page_native(out, node, column, rep, dl, codec, encoding, ctx, *,
                       v2: bool, num_rows=None, null_count=None,
                       dictionary_size=None, statistics=None,
                       page_crc=True, workers: int = 1):
    """One data page through the native path: the whole body encoded into
    one buffer (levels and dictionary indices or values, one C pass),
    compressed into another, its CRC taken in C, then the header and the
    body written with no intermediate Python bytes.  Returns the pure
    path's ``(compressed, uncompressed)`` sizes, or None when the page
    must take the pure path (a fault fired at ``io.pages.page_write``, a
    short buffer, a value the pass refuses): nothing was written then."""
    pg, pcodec = ctx
    st = current_stats()
    n = len(dl)
    try:
        fault_point("io.pages.page_write", column=".".join(node.path),
                    values=n)
        t0 = time.perf_counter() if st is not None else 0.0
        if dictionary_size is not None:
            idx = as_uint32(np.asarray(column))
            idx_width = max(int(dictionary_size - 1).bit_length(), 1) \
                if dictionary_size > 1 else 1
            values = None
            enc_kind = Encoding.RLE_DICTIONARY
        else:
            idx = None
            idx_width = 0
            values = _native_values_view(Type(node.element.type), column,
                                         encoding)
            enc_kind = encoding
        rep_w = int(node.max_rep_level).bit_length()
        def_w = int(node.max_def_level).bit_length()
        rep_arr = as_uint32(rep) if node.max_rep_level else None
        dl_arr = as_uint32(dl) if node.max_def_level else None
        cap = 16
        if rep_arr is not None:
            cap += 4 + hybrid_encode_cap(n, rep_w)
        if dl_arr is not None:
            cap += 4 + hybrid_encode_cap(n, def_w)
        cap += (1 + hybrid_encode_cap(idx.size, idx_width)
                if idx is not None else values.size)
        scratch = np.empty(cap, dtype=np.uint8)
        enc = pg.encode(rep_arr, dl_arr, n, rep_w, def_w, v2, idx,
                        idx_width, values, scratch)
        if enc is None:
            return None
        rep_len, dl_len, val_len = enc
        uncomp = rep_len + dl_len + val_len
        t1 = time.perf_counter() if st is not None else 0.0
        # V1 compresses the whole body, V2 the values segment only (its
        # levels stay raw in the file)
        lev = rep_len + dl_len
        if pcodec is None:  # UNCOMPRESSED
            segs = [scratch[:uncomp]]
        elif v2:
            outbuf = np.empty(page_compress_bound(pcodec, val_len, workers),
                              dtype=np.uint8)
            comp_vals = page_compress_into(pcodec, scratch[lev:uncomp],
                                           outbuf, workers)
            segs = [scratch[:lev], outbuf[:comp_vals]]
        else:
            outbuf = np.empty(page_compress_bound(pcodec, uncomp, workers),
                              dtype=np.uint8)
            comp = page_compress_into(pcodec, scratch[:uncomp], outbuf,
                                      workers)
            segs = [outbuf[:comp]]
        crc = None
        if page_crc:
            c = 0
            for seg in segs:
                c = pg.crc32(seg, c)
            crc = c - (1 << 32) if c >= (1 << 31) else c
        comp_total = sum(seg.size for seg in segs)
        t2 = time.perf_counter() if st is not None else 0.0
        if v2:
            ph = PageHeader(
                type=PageType.DATA_PAGE_V2,
                uncompressed_page_size=uncomp,
                compressed_page_size=comp_total,
                crc=crc,
                data_page_header_v2=DataPageHeaderV2(
                    num_values=n,
                    num_nulls=null_count,
                    num_rows=num_rows,
                    encoding=enc_kind,
                    definition_levels_byte_length=dl_len,
                    repetition_levels_byte_length=rep_len,
                    is_compressed=codec != CompressionCodec.UNCOMPRESSED,
                    statistics=statistics,
                ),
            )
        else:
            ph = PageHeader(
                type=PageType.DATA_PAGE,
                uncompressed_page_size=uncomp,
                compressed_page_size=comp_total,
                crc=crc,
                data_page_header=DataPageHeader(
                    num_values=n,
                    encoding=enc_kind,
                    definition_level_encoding=Encoding.RLE,
                    repetition_level_encoding=Encoding.RLE,
                    statistics=statistics,
                ),
            )
        hdr = _header_bytes(ph)
    except (TransientIOError, ValueError):
        # nothing of the page is written yet: the pure path writes it,
        # the same bytes
        return None
    out.write(hdr)
    for seg in segs:
        out.write(memoryview(seg))
    if st is not None:
        st.write_encode_s += t1 - t0
        st.write_compress_s += t2 - t1
        st.pages_assembled_native += 1
        st.write_assemble_s += time.perf_counter() - t2
    return len(hdr) + comp_total, len(hdr) + uncomp


def _record_page_written() -> None:
    """Every written page, on either path, counts ``pages_written``."""
    st = current_stats()
    if st is not None:
        st.pages_written += 1


def _header_bytes(ph: PageHeader) -> bytes:
    w = CompactWriter()
    encode_struct(ph, w)
    return w.getvalue()


def _rows_as_bytes(column) -> ByteArrayColumn:
    """``(N, L)`` FIXED_LEN_BYTE_ARRAY rows as a byte column."""
    n, length = column.shape
    return ByteArrayColumn(np.arange(n + 1, dtype=np.int64) * length,
                           np.ascontiguousarray(column).reshape(-1))


def encode_values(ptype: Type, encoding: Encoding, column) -> bytes:
    """Non-dictionary value encode of a page's non-null values; a
    :class:`DeviceValues` encodes on its device (PLAIN,
    DELTA_BINARY_PACKED, BYTE_STREAM_SPLIT) and counts
    ``pages_device_encoded``."""
    if isinstance(column, DeviceValues):
        return column.encode(ptype, encoding)
    if encoding == Encoding.PLAIN:
        return encode_plain(ptype, column)
    if encoding == Encoding.RLE:  # BOOLEAN only
        return encode_hybrid_prefixed(np.asarray(column, dtype=np.uint32), 1)
    if encoding == Encoding.DELTA_BINARY_PACKED:
        return encode_delta_binary_packed(column, is32=(ptype == Type.INT32))
    if encoding == Encoding.DELTA_LENGTH_BYTE_ARRAY:
        return encode_delta_length_byte_array(column)
    if encoding == Encoding.DELTA_BYTE_ARRAY:
        return encode_delta_byte_array(
            _rows_as_bytes(column) if ptype == Type.FIXED_LEN_BYTE_ARRAY
            else column)
    if encoding == Encoding.BYTE_STREAM_SPLIT:
        return encode_byte_stream_split(np.asarray(column))
    raise ValueError(f"unsupported value encoding {encoding!r}")


def _page_values(node, column, encoding, dictionary_size):
    """(encoded values, page encoding)."""
    if dictionary_size is not None:
        return (encode_dict_indices(column, dictionary_size),
                Encoding.RLE_DICTIONARY)
    return encode_values(Type(node.element.type), encoding, column), encoding


def write_data_page_v1(out, node, column, rep, dl, codec, *,
                       encoding=Encoding.PLAIN, dictionary_size=None,
                       statistics=None, page_crc=True,
                       compress_workers: int = 1,
                       native_ctx="auto") -> tuple[int, int]:
    """Append a V1 data page; returns (compressed, uncompressed) sizes
    including the header bytes.  ``column`` holds the non-null values
    (encoded with ``encoding``), or their dictionary indices when
    ``dictionary_size`` is given; ``rep``/``dl`` the levels of every slot
    (``rep`` is read only for a repeated column).  ``compress_workers``
    may split the body (:func:`~tpuparquet_torch.compress.
    page_compress`).  ``native_ctx`` is the chunk's
    :func:`_native_page_ctx` (None: the pure path; ``"auto"`` resolves
    it here)."""
    ctx = _native_page_ctx(codec) if native_ctx == "auto" else native_ctx
    if ctx is not None:
        res = _write_page_native(
            out, node, column, rep, dl, codec, encoding, ctx, v2=False,
            dictionary_size=dictionary_size, statistics=statistics,
            page_crc=page_crc, workers=compress_workers)
        if res is not None:
            _record_page_written()
            return res
    body = bytearray()
    if node.max_rep_level:
        body += encode_hybrid_prefixed(as_uint32(rep),
                                       int(node.max_rep_level).bit_length())
    if node.max_def_level:
        body += encode_hybrid_prefixed(as_uint32(dl),
                                       int(node.max_def_level).bit_length())
    values_b, enc = _page_values(node, column, encoding, dictionary_size)
    body += values_b
    comp = page_compress(codec, bytes(body), compress_workers)
    ph = PageHeader(
        type=PageType.DATA_PAGE,
        uncompressed_page_size=len(body),
        compressed_page_size=len(comp),
        crc=page_crc32(comp) if page_crc else None,
        data_page_header=DataPageHeader(
            num_values=len(dl),
            encoding=enc,
            definition_level_encoding=Encoding.RLE,
            repetition_level_encoding=Encoding.RLE,
            statistics=statistics,
        ),
    )
    hdr = _header_bytes(ph)
    out.write(hdr)
    out.write(comp)
    _record_page_written()
    return len(hdr) + len(comp), len(hdr) + len(body)


def write_data_page_v2(out, node, column, rep, dl, codec, *, null_count: int,
                       num_rows: int, encoding=Encoding.PLAIN,
                       dictionary_size=None, statistics=None,
                       page_crc=True, compress_workers: int = 1,
                       native_ctx="auto") -> tuple[int, int]:
    """Append a V2 data page (arguments as :func:`write_data_page_v1`;
    ``num_rows`` counts records, not level slots); only the values
    segment is compressed, and the CRC covers the level bytes and the
    compressed values as they appear in the file."""
    ctx = _native_page_ctx(codec) if native_ctx == "auto" else native_ctx
    if ctx is not None:
        res = _write_page_native(
            out, node, column, rep, dl, codec, encoding, ctx, v2=True,
            num_rows=num_rows, null_count=null_count,
            dictionary_size=dictionary_size, statistics=statistics,
            page_crc=page_crc, workers=compress_workers)
        if res is not None:
            _record_page_written()
            return res
    rl_b = (encode_hybrid(as_uint32(rep), int(node.max_rep_level).bit_length())
            if node.max_rep_level else b"")
    dl_b = (encode_hybrid(as_uint32(dl), int(node.max_def_level).bit_length())
            if node.max_def_level else b"")
    values_b, enc = _page_values(node, column, encoding, dictionary_size)
    comp = page_compress(codec, values_b, compress_workers)
    ph = PageHeader(
        type=PageType.DATA_PAGE_V2,
        uncompressed_page_size=len(rl_b) + len(dl_b) + len(values_b),
        compressed_page_size=len(rl_b) + len(dl_b) + len(comp),
        crc=page_crc32(rl_b, dl_b, comp) if page_crc else None,
        data_page_header_v2=DataPageHeaderV2(
            num_values=len(dl),
            num_nulls=null_count,
            num_rows=num_rows,
            encoding=enc,
            definition_levels_byte_length=len(dl_b),
            repetition_levels_byte_length=len(rl_b),
            is_compressed=codec != CompressionCodec.UNCOMPRESSED,
            statistics=statistics,
        ),
    )
    hdr = _header_bytes(ph)
    out.write(hdr)
    out.write(rl_b)
    out.write(dl_b)
    out.write(comp)
    _record_page_written()
    return (len(hdr) + ph.compressed_page_size,
            len(hdr) + ph.uncompressed_page_size)


def write_dictionary_page(out, node, dictionary, codec,
                          page_crc=True) -> tuple[int, int]:
    """PLAIN dictionary page; returns (compressed, uncompressed) sizes
    including the header bytes."""
    body = encode_plain(Type(node.element.type), dictionary)
    comp = compress_block(codec, body)
    ph = PageHeader(
        type=PageType.DICTIONARY_PAGE,
        uncompressed_page_size=len(body),
        compressed_page_size=len(comp),
        crc=page_crc32(comp) if page_crc else None,
        dictionary_page_header=DictionaryPageHeader(
            num_values=len(dictionary), encoding=Encoding.PLAIN),
    )
    hdr = _header_bytes(ph)
    out.write(hdr)
    out.write(comp)
    _record_page_written()
    return len(hdr) + len(comp), len(hdr) + len(body)
