"""Parquet file framing: magic bytes + footer read/write.

    "PAR1" | row groups ... | thrift(FileMetaData) | footer_len:int32 LE | "PAR1"

``read_file_metadata`` validates the magic at both ends, reads the 4-byte
little-endian footer length at EOF-8, then compact-thrift-decodes
``FileMetaData``.  Every framing failure raises
:class:`~tpuparquet_torch.errors.CorruptFooterError` with the rejecting
byte offset; ``FormatError`` is the same class under the reference's
older name.  The two reads are the fault sites ``format.footer.tail``
and ``format.footer.blob`` (``faults.py``).
"""

from __future__ import annotations

import os
import struct

from ..errors import CorruptFooterError
from ..faults import filter_bytes
from .compact import CompactWriter, ThriftError
from .metadata import FileMetaData, encode_struct

MAGIC = b"PAR1"

__all__ = ["MAGIC", "read_file_metadata", "write_footer", "FormatError"]

#: the reference's older name of the footer's error class
FormatError = CorruptFooterError


def _file_size(f) -> int:
    """The size of a seekable binary file object (its position kept)."""
    pos = f.tell()
    size = f.seek(0, os.SEEK_END)
    f.seek(pos)
    return size


def read_file_metadata(f) -> FileMetaData:
    """Read and validate the footer of a seekable binary file object."""
    size = _file_size(f)
    if size < len(MAGIC) * 2 + 4:
        raise CorruptFooterError(
            f"file too small to be parquet ({size} bytes)", offset=0)
    f.seek(0)
    if f.read(4) != MAGIC:
        raise CorruptFooterError("invalid magic at file head", offset=0)
    f.seek(size - 8)
    tail = filter_bytes("format.footer.tail", f.read(8))
    if len(tail) < 8 or tail[4:] != MAGIC:
        raise CorruptFooterError(
            f"invalid magic at file tail (offset {size - 4})",
            offset=size - 4)
    (footer_len,) = struct.unpack("<I", tail[:4])
    footer_start = size - 8 - footer_len
    if footer_len <= 0 or footer_start < 4:
        raise CorruptFooterError(
            f"invalid footer length {footer_len} (footer would start at "
            f"{footer_start} in a {size}-byte file)", offset=size - 8)
    f.seek(footer_start)
    buf = filter_bytes("format.footer.blob", f.read(footer_len))
    if len(buf) != footer_len:
        raise CorruptFooterError(
            f"short read of footer: {len(buf)}/{footer_len} bytes at "
            f"offset {footer_start}", offset=footer_start)
    try:
        meta = FileMetaData.from_bytes(buf)
    except ThriftError as e:
        raise CorruptFooterError(f"corrupt footer thrift: {e}",
                                 offset=footer_start) from e
    # compact thrift is permissive enough that corrupt bytes can decode
    # to an empty struct: enforce the fields parquet.thrift marks
    # `required` before trusting the result
    if (meta.version is None or not meta.schema or meta.num_rows is None
            or meta.row_groups is None):
        raise CorruptFooterError(
            "footer missing required FileMetaData fields",
            offset=footer_start)
    for rg in meta.row_groups:
        if rg.columns is None or rg.num_rows is None:
            raise CorruptFooterError("row group missing required fields",
                                     offset=footer_start)
        for cc in rg.columns:
            cm = cc.meta_data
            if cm is None:
                raise CorruptFooterError("column chunk missing metadata",
                                         offset=footer_start)
            if (cm.type is None or cm.codec is None
                    or not cm.path_in_schema or cm.num_values is None
                    or cm.data_page_offset is None
                    or cm.total_compressed_size is None):
                raise CorruptFooterError(
                    "column metadata missing required fields",
                    offset=footer_start)
            if (cm.num_values < 0 or cm.total_compressed_size < 0
                    or cm.data_page_offset < 0):
                raise CorruptFooterError(
                    "negative sizes in column metadata",
                    offset=footer_start)
    return meta


def write_footer(f, meta: FileMetaData) -> int:
    """Append thrift(FileMetaData) + length + magic; returns bytes written
    (the caller has written the leading magic already)."""
    w = CompactWriter()
    encode_struct(meta, w)
    blob = w.getvalue()
    f.write(blob)
    f.write(struct.pack("<I", len(blob)))
    f.write(MAGIC)
    return len(blob) + 8
