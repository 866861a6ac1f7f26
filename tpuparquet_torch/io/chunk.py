"""Column-chunk write: dictionary policy, statistics, pages.

:func:`write_chunk` emits a dictionary page when the column is written
PLAIN and the dictionary pays (the JAX package's policy: at most
``MAX_DICT_ENTRIES - 1`` distinct values, and dictionary + packed indices
smaller than the PLAIN values), then one data page (V1, or V2 with
``data_page_v2=True``) with the rep and def levels of every slot, and
returns the ``ColumnChunk`` metadata with sizes including page headers,
statistics and the encodings list.  A column written with another
encoding (RLE, the DELTA encodings, BYTE_STREAM_SPLIT), a BOOLEAN column
(PLAIN is already a bit a value) and a writer that disallows
dictionaries skip the dictionary, as in the JAX writer.  Statistics
follow the JAX policy: INT96 has no defined order and carries counts
only; FIXED_LEN_BYTE_ARRAY bounds are the unsigned-lexicographic extreme
rows, without the deprecated signed min/max fields; an unsigned integer
column (``UINT_n``, or ``INT(n, false)``) orders its bounds as unsigned,
keeps them in the signed storage type, and writes no deprecated fields.

A :class:`~tpuparquet_torch.kernels.encode.DeviceValues` column keeps its
values on its device: its statistics (KE5) and, for a small-range
integer column, its dictionary (:func:`~tpuparquet_torch.kernels.encode.
device_dict_build`, whose index stream crosses to the host only once the
size gate accepts it) compute there, as in the JAX writer.
"""

from __future__ import annotations

import numpy as np

from ..cpu.dictionary import build_dictionary, intern_byte_column
from ..cpu.plain import ByteArrayColumn
from ..format.metadata import (
    ColumnChunk,
    ColumnMetaData,
    ConvertedType,
    Encoding,
    SchemaElement,
    Statistics,
    Type,
)
from ..kernels.encode import DeviceValues, device_dict_build
from ..native import TOO_MANY_DISTINCT
from .pages import write_data_page_v1, write_data_page_v2, \
    write_dictionary_page

__all__ = ["MAX_DICT_ENTRIES", "is_unsigned", "write_chunk"]

MAX_DICT_ENTRIES = 1 << 15  # math.MaxInt16, as the JAX package

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


def _column_size(column) -> int:
    """PLAIN size of a column: records with their 4-byte prefixes for
    bytes, the array's bytes otherwise."""
    if isinstance(column, ByteArrayColumn):
        return int(column.data.size) + 4 * len(column)
    if isinstance(column, DeviceValues):
        return column.count * column.dtype.itemsize
    return int(column.nbytes)


def _size_gate(column, dictionary, indices, n: int):
    """Keep the dictionary only when it pays: fewer than
    ``MAX_DICT_ENTRIES`` entries, and dictionary + packed indices
    smaller than the PLAIN values.  ``indices`` may be a deferred pull
    (the device intern's), taken only when the dictionary is kept."""
    dsize = len(dictionary)
    if dsize >= MAX_DICT_ENTRIES:
        return None, None
    width = max((dsize - 1).bit_length(), 1)
    if _column_size(dictionary) + n * width // 8 >= _column_size(column):
        return None, None
    return dictionary, indices() if callable(indices) else indices


def _maybe_dictionary(column):
    """The JAX writer's dictionary heuristic: ``(dictionary, indices)``
    or ``(None, None)`` for PLAIN."""
    n = len(column)
    if n == 0:
        return None, None
    if isinstance(column, DeviceValues):
        built = device_dict_build(column)
        return (None, None) if built is None \
            else _size_gate(column, *built, n)
    if isinstance(column, ByteArrayColumn):
        # capped at MAX - 1: a column reaching MAX distinct values aborts
        # the intern in O(cap) instead of paying for a discarded one
        out = intern_byte_column(column, MAX_DICT_ENTRIES - 1)
        if out is TOO_MANY_DISTINCT:
            return None, None
        return _size_gate(column, *out, n)
    arr = column
    if n > 4096 and arr.ndim == 1:
        # strictly monotonic values are all distinct: reject without a
        # sort (elementwise compares — a diff could wrap)
        a, b = arr[1:], arr[:-1]
        if bool((a > b).all()) or bool((a < b).all()):
            return None, None
    if n > 1 << 17:
        # distinct(sample) is a lower bound on distinct(full): a strided
        # sample that already fails the gates proves the intern would
        # be discarded (random floats reject here)
        sample = arr[:: n // 65536][:65536]
        ds = int(np.unique(sample, axis=0 if arr.ndim == 2 else None)
                 .shape[0])
        width = max((ds - 1).bit_length(), 1)
        if ds >= MAX_DICT_ENTRIES or \
                ds * (arr.nbytes // n) + n * width // 8 >= arr.nbytes:
            return None, None
    return _size_gate(column, *build_dictionary(arr), n)


def _lex_min_max(rows: np.ndarray):
    """The (min, max) rows of a (k, L) u8 matrix in unsigned byte order,
    as bytes: candidates narrow one big-endian 8-byte word at a time."""
    k, length = rows.shape
    nw = (length + 7) // 8
    padded = np.zeros((k, 8 * nw), dtype=np.uint8)
    padded[:, :length] = rows
    words = padded.view(">u8")
    out = []
    for pick in (np.min, np.max):
        cand = np.arange(k)
        for j in range(nw):
            col = words[cand, j]
            cand = cand[col == pick(col)]
            if cand.size == 1:
                break
        out.append(rows[cand[0]].tobytes())
    return out


def _bytes_min_max(col: ByteArrayColumn):
    """The (min, max) values of a byte column in unsigned byte order:
    the extremes of each length group (:func:`_lex_min_max` over its
    rows), then the least and greatest of those, where a value sorts
    after its own prefixes."""
    offs = col.offsets.astype(np.int64)
    lens = np.diff(offs)
    mins, maxs = [], []
    for length in np.unique(lens):
        sel = np.nonzero(lens == length)[0]
        rows = col.data[offs[:-1][sel][:, None]
                        + np.arange(int(length), dtype=np.int64)]
        lo, hi = _lex_min_max(rows) if length else (b"", b"")
        mins.append(lo)
        maxs.append(hi)
    return min(mins), max(maxs)


def _statistics(ptype: Type, src, null_count: int, distinct,
                unsigned: bool = False):
    """Chunk statistics over ``src`` (the dictionary when there is one:
    every value appears in it).  Floats ignore NaN; bytes and
    fixed-length bytes carry lexicographic bounds, INT96 none; unsigned
    integers order as unsigned; byte types and unsigned integers write
    no deprecated signed-order min/max."""
    mn = mx = None
    if isinstance(src, DeviceValues):
        lo, hi = src.min_max(unsigned=unsigned)
        if lo is not None:
            mn, mx = lo.tobytes(), hi.tobytes()
    elif isinstance(src, ByteArrayColumn):
        if len(src):
            mn, mx = _bytes_min_max(src)
    elif ptype == Type.FIXED_LEN_BYTE_ARRAY:
        if len(src):
            mn, mx = _lex_min_max(src)
    elif unsigned and ptype in (Type.INT32, Type.INT64):
        if src.size:
            u = src.view(np.uint32 if ptype == Type.INT32 else np.uint64)
            mn = src[int(np.argmin(u))].tobytes()
            mx = src[int(np.argmax(u))].tobytes()
    elif ptype != Type.INT96:
        vals = src[~np.isnan(src)] if src.dtype.kind == "f" else src
        if vals.size:
            mn, mx = vals.min().tobytes(), vals.max().tobytes()
    st = Statistics(null_count=null_count, distinct_count=distinct,
                    min_value=mn, max_value=mx)
    if not unsigned and ptype not in (Type.BYTE_ARRAY,
                                      Type.FIXED_LEN_BYTE_ARRAY):
        st.min = st.min_value
        st.max = st.max_value
    return st


def write_chunk(out, node, column, rep, dl: np.ndarray, *, codec,
                encoding: Encoding = Encoding.PLAIN, page_crc: bool = True,
                null_count: int = 0, num_rows: int | None = None,
                data_page_v2: bool = False,
                allow_dict: bool = True,
                pipeline_workers: int = 1) -> ColumnChunk:
    """Write one column chunk at the current position of ``out`` (a
    position-tracking binary stream).  ``column`` holds the non-null
    values (an array of the physical dtype, or a
    :class:`ByteArrayColumn`), ``rep``/``dl`` the repetition and
    definition level of every slot (``rep`` None for a flat column),
    ``num_rows`` the records (default: one per slot).  The chunk's one
    data page takes ``pipeline_workers`` for the block-parallel split of
    its compressed body, as the JAX writer's single-page chunk does."""
    ptype = Type(node.element.type)
    pos0 = out.tell()
    dictionary, indices = (_maybe_dictionary(column)
                           if allow_dict and encoding == Encoding.PLAIN
                           and ptype != Type.BOOLEAN else (None, None))
    total_comp = total_uncomp = 0
    dict_page_offset = None
    distinct = None
    if dictionary is not None:
        dict_page_offset = pos0
        distinct = len(dictionary)
        c, u = write_dictionary_page(out, node, dictionary, codec,
                                     page_crc=page_crc)
        total_comp += c
        total_uncomp += u
    stats = _statistics(ptype, column if dictionary is None else dictionary,
                        null_count, distinct,
                        unsigned=is_unsigned(node.element))
    data_page_offset = out.tell()
    page_column = indices if dictionary is not None else column
    if data_page_v2:
        c, u = write_data_page_v2(
            out, node, page_column, rep, dl, codec, null_count=null_count,
            num_rows=len(dl) if num_rows is None else num_rows,
            encoding=encoding, dictionary_size=distinct, statistics=stats,
            page_crc=page_crc, compress_workers=pipeline_workers)
    else:
        c, u = write_data_page_v1(
            out, node, page_column, rep, dl, codec, encoding=encoding,
            dictionary_size=distinct, statistics=stats, page_crc=page_crc,
            compress_workers=pipeline_workers)
    total_comp += c
    total_uncomp += u
    encodings = [Encoding.RLE, encoding]
    if dictionary is not None:
        encodings.append(Encoding.RLE_DICTIONARY)
    cm = ColumnMetaData(
        type=ptype,
        encodings=encodings,
        path_in_schema=list(node.path),
        codec=codec,
        num_values=len(dl),
        total_uncompressed_size=total_uncomp,
        total_compressed_size=total_comp,
        data_page_offset=data_page_offset,
        dictionary_page_offset=dict_page_offset,
        statistics=stats,
    )
    return ColumnChunk(file_offset=pos0, meta_data=cm)
