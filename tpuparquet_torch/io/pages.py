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

The page CRC (``PageHeader.crc``) is the standard gzip-polynomial CRC32
over the page bytes as they appear in the file, stored as a signed i32.
"""

from __future__ import annotations

import os
import struct
import zlib

import numpy as np

from ..compress import compress_block, page_compress
from ..cpu.bss import encode_byte_stream_split
from ..cpu.delta import encode_delta_binary_packed, \
    encode_delta_byte_array, encode_delta_length_byte_array
from ..cpu.hybrid import as_uint32, encode_hybrid, encode_hybrid_prefixed, \
    scan_hybrid
from ..cpu.levels import decode_levels_bitpacked
from ..cpu.plain import ByteArrayColumn, encode_plain
from ..errors import CorruptPageError
from ..format.compact import CompactWriter
from ..kernels.encode import DeviceValues
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
    "SUPPORTED_DATA_ENCODINGS",
    "crc_verify_default",
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
    both None when ``max_level == 0``, which has no stream."""
    if max_level == 0:
        return None, None, pos
    width = int(max_level).bit_length()
    if encoding == Encoding.BIT_PACKED:
        nbytes = (n * width + 7) // 8
        return (None, decode_levels_bitpacked(raw[pos : pos + nbytes], n,
                                              max_level), pos + nbytes)
    if encoding != Encoding.RLE:
        raise NotImplementedError(
            f"level encoding {Encoding(encoding).name} is not supported "
            "by tpuparquet_torch (RLE, BIT_PACKED)")
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


def encode_dict_indices(indices, dict_size: int) -> bytes:
    """Dictionary indices as (bit-width byte + hybrid stream)."""
    width = max(int(dict_size - 1).bit_length(), 1) if dict_size > 1 else 1
    return bytes([width]) + encode_hybrid(as_uint32(indices), width)


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
                       compress_workers: int = 1) -> tuple[int, int]:
    """Append a V1 data page; returns (compressed, uncompressed) sizes
    including the header bytes.  ``column`` holds the non-null values
    (encoded with ``encoding``), or their dictionary indices when
    ``dictionary_size`` is given; ``rep``/``dl`` the levels of every slot
    (``rep`` is read only for a repeated column).  ``compress_workers``
    may split the body (:func:`~tpuparquet_torch.compress.
    page_compress`)."""
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
    return len(hdr) + len(comp), len(hdr) + len(body)


def write_data_page_v2(out, node, column, rep, dl, codec, *, null_count: int,
                       num_rows: int, encoding=Encoding.PLAIN,
                       dictionary_size=None, statistics=None,
                       page_crc=True,
                       compress_workers: int = 1) -> tuple[int, int]:
    """Append a V2 data page (arguments as :func:`write_data_page_v1`;
    ``num_rows`` counts records, not level slots); only the values
    segment is compressed, and the CRC covers the level bytes and the
    compressed values as they appear in the file."""
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
    return len(hdr) + len(comp), len(hdr) + len(body)
