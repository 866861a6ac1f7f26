"""Column-chunk read and write: the page loop, dictionary policy,
statistics, page splits, page index and bloom filter.

Read: :func:`read_chunk` walks every page of a chunk's byte range on the
host (at most one dictionary page, first), verifies page CRCs, decodes
each data page (``io/pages.py``) and concatenates the pages into one
:class:`ChunkData` (values, rep levels, def levels), gathering the
dictionary indices once a chunk.  With ``keep_rows=`` (the filtered
read's page pruning, flat columns only) a data page none of whose rows is
kept is skipped: its header is read, its body is neither checked,
decompressed nor decoded, and it counts ``pages_pruned``.  Each page's
payload is the fault site ``io.chunk.page_payload``.

Write: :func:`write_chunk` emits a dictionary page when the column is
written PLAIN and the dictionary pays (the JAX package's policy: at most
``MAX_DICT_ENTRIES - 1`` distinct values, and dictionary + packed indices
smaller than the PLAIN values), then one data page (V1, or V2 with
``data_page_v2=True``) with the rep and def levels of every slot, or with
``page_rows`` a data page every ``page_rows`` level slots of a flat
column, each with its own statistics; and returns the ``ColumnChunk``
metadata with sizes including page headers, statistics and the encodings
list.  A column written with another encoding (RLE, the DELTA encodings,
BYTE_STREAM_SPLIT), a BOOLEAN column (PLAIN is already a bit a value) and
a writer that disallows dictionaries skip the dictionary, as in the JAX
writer.  Statistics follow the JAX policy: INT96 has no defined order and
carries counts only; FIXED_LEN_BYTE_ARRAY bounds are the
unsigned-lexicographic extreme rows, without the deprecated signed
min/max fields; an unsigned integer column (``UINT_n``, or ``INT(n,
false)``) orders its bounds as unsigned, keeps them in the signed storage
type, and writes no deprecated fields.  ``page_index=True`` attaches the
chunk's ``(ColumnIndex, OffsetIndex)`` as ``cc._page_index`` and
``bloom=True`` a split-block bloom filter over its distinct values as
``cc._bloom``; the file writer serializes both after the row groups.

A :class:`~tpuparquet_torch.kernels.encode.DeviceValues` column keeps its
values on its device: its statistics (KE5) and, for a small-range
integer column, its dictionary (:func:`~tpuparquet_torch.kernels.encode.
device_dict_build`, whose index stream crosses to the host only once the
size gate accepts it) compute there, as in the JAX writer; its values
write as one page.
"""

from __future__ import annotations

import time
from concurrent.futures import ThreadPoolExecutor

import numpy as np

from ..cpu.dictionary import build_dictionary, gather, intern_byte_column
from ..cpu.plain import ByteArrayColumn
from ..errors import CorruptChunkError, CorruptPageError, ScanError
from ..faults import filter_bytes
from ..format.bloom import SplitBlockBloom, optimal_bytes, xxh64, \
    xxh64_rows
from ..format.compact import CompactReader
from ..format.metadata import (
    BoundaryOrder,
    ColumnChunk,
    ColumnIndex,
    ColumnMetaData,
    CompressionCodec,
    Encoding,
    KeyValue,
    OffsetIndex,
    PageHeader,
    PageLocation,
    PageType,
    Statistics,
    Type,
    decode_struct,
)
from ..kernels.encode import DeviceValues, device_dict_build
from ..native import TOO_MANY_DISTINCT
from ..obs import profiler as _profiler
from ..obs import recorder as _flightrec
from ..stats import current_stats, worker_stats
from .pages import (
    DecodedPage,
    _native_page_ctx,
    crc_verify_default,
    decode_data_page_v1,
    decode_data_page_v2,
    decode_dictionary_page,
    verify_page_crc,
    write_data_page_v1,
    write_data_page_v2,
    write_dictionary_page,
)
from .values import handler_for

__all__ = ["ChunkData", "MAX_BLOOM_DISTINCT", "MAX_DICT_ENTRIES",
           "read_chunk", "write_chunk"]

MAX_DICT_ENTRIES = 1 << 15  # math.MaxInt16, as the JAX package

# no bloom filter past this many distinct values a chunk: the filter
# would be megabytes and the column is not dictionary-like
MAX_BLOOM_DISTINCT = 1 << 16


# ----------------------------------------------------------------------
# Read
# ----------------------------------------------------------------------

class ChunkData:
    """A decoded column chunk: the codec layer's values (non-null only)
    and the rep and def levels of every slot."""

    __slots__ = ("values", "rep_levels", "def_levels", "num_values",
                 "null_count")

    def __init__(self, values, rep_levels, def_levels, null_count):
        self.values = values
        self.rep_levels = rep_levels
        self.def_levels = def_levels
        self.num_values = len(def_levels)
        self.null_count = null_count


def read_chunk(blob, cm: ColumnMetaData, node, verify_crc: bool | None = None,
               keep_rows=None):
    """Decode one column chunk on the host from ``blob`` (offsets in
    ``cm`` relative to it).  ``verify_crc`` gates the page CRC check
    (None: ``TPQ_PAGE_CRC_VERIFY``).

    ``keep_rows`` (a bool mask over the chunk's rows; flat columns only)
    skips the data pages whose rows are all False, and the return becomes
    ``(ChunkData, kept)``: ``kept`` holds the row indices of the decoded
    pages' rows, a page-granular superset of the True rows."""
    codec = cm.codec
    col_path = ".".join(cm.path_in_schema)
    if verify_crc is None:
        verify_crc = crc_verify_default()
    if keep_rows is not None:
        if node.max_rep_level:
            raise ValueError(f"page pruning needs a non-repeated column, "
                             f"not {col_path!r}")
        keep_rows = np.asarray(keep_rows, dtype=bool)
        if keep_rows.size != cm.num_values:
            raise ValueError(f"keep_rows has {keep_rows.size} entries for a "
                             f"{cm.num_values}-value chunk")
    kept_parts = []  # a kept page's (first row, rows)
    row_base = 0
    start = cm.data_page_offset
    if cm.dictionary_page_offset is not None:
        start = min(start, cm.dictionary_page_offset)
    end = start + cm.total_compressed_size
    if end > len(blob) or start < 0:
        raise CorruptChunkError("column chunk byte range out of bounds",
                                column=col_path)
    r = CompactReader(blob, start, end)
    dictionary = None
    pages: list[DecodedPage] = []
    values_read = 0
    page_i = 0  # every page walked: the error coordinate
    total = cm.num_values
    st = current_stats()
    ev = None if st is None else st.events
    if st is not None:
        st.chunks += 1
        st.bytes_compressed += cm.total_compressed_size
        st.bytes_uncompressed += cm.total_uncompressed_size or 0
        st.values += total
    while values_read < total:
        if r.pos >= end:
            raise CorruptChunkError(
                f"column chunk exhausted at {values_read}/{total} values",
                column=col_path)
        ph = decode_struct(PageHeader, r)
        if ph.compressed_page_size is None or ph.compressed_page_size < 0:
            raise CorruptPageError("page header missing compressed size",
                                   column=col_path, page=page_i)
        if r.pos + ph.compressed_page_size > end:
            raise CorruptPageError("page payload overruns column chunk",
                                   column=col_path, page=page_i)
        payload = blob[r.pos : r.pos + ph.compressed_page_size]
        if len(payload) != ph.compressed_page_size:
            raise CorruptPageError("page payload truncated",
                                   column=col_path, page=page_i)
        payload = filter_bytes("io.chunk.page_payload", payload,
                               column=col_path, page=page_i)
        r.pos += ph.compressed_page_size
        ptype = PageType(ph.type)
        if keep_rows is not None and ptype in (PageType.DATA_PAGE,
                                               PageType.DATA_PAGE_V2):
            h = (ph.data_page_header_v2 if ptype == PageType.DATA_PAGE_V2
                 else ph.data_page_header)
            n_pg = None if h is None else h.num_values
            if n_pg is not None and n_pg >= 0 \
                    and not keep_rows[row_base:row_base + n_pg].any():
                # no row of this page survives: its body is never
                # checked, decompressed nor decoded
                values_read += n_pg
                row_base += n_pg
                page_i += 1
                if st is not None:
                    st.pages_pruned += 1
                if _flightrec._active is not None:
                    _flightrec.flight("page_pruned", site="io.chunk",
                                      column=col_path, page=page_i - 1,
                                      values=n_pg)
                continue
        if verify_page_crc(ph, payload, enabled=verify_crc, column=col_path,
                           page=page_i) and st is not None:
            st.pages_crc_verified += 1
        try:
            if ptype == PageType.DICTIONARY_PAGE:
                if dictionary is not None:
                    raise CorruptChunkError(
                        "only one dictionary page allowed per chunk")
                if pages:
                    raise CorruptChunkError(
                        "dictionary page must precede data pages")
                dictionary = decode_dictionary_page(ph, payload, codec, node)
                # a dictionary away from the data pages: go on at
                # data_page_offset
                if r.pos != cm.data_page_offset:
                    r.pos = cm.data_page_offset
            elif ptype in (PageType.DATA_PAGE, PageType.DATA_PAGE_V2):
                v2 = ptype == PageType.DATA_PAGE_V2
                t_pg = time.perf_counter() if ev is not None else 0.0
                pg = (decode_data_page_v2 if v2
                      else decode_data_page_v1)(ph, payload, codec, node,
                                                dictionary)
                values_read += pg.num_values
                if keep_rows is not None:
                    kept_parts.append((row_base, pg.num_values))
                    row_base += pg.num_values
                pages.append(pg)
                # the page's coordinates ride the flight recorder (the
                # call guarded: this is the per-page loop)
                if _flightrec._active is not None:
                    _flightrec.flight("page", site="io.chunk",
                                      column=col_path, page=len(pages) - 1,
                                      values=pg.num_values)
                if st is not None:
                    st.pages += 1
                    st.hist("page_comp_bytes").record(
                        ph.compressed_page_size)
                    st.hist("page_uncomp_bytes").record(
                        ph.uncompressed_page_size)
                    if ev is not None:
                        h = ph.data_page_header_v2 if v2 \
                            else ph.data_page_header
                        ev.page(column=col_path, page=len(pages) - 1,
                                page_type="v2" if v2 else "v1",
                                encoding=Encoding(h.encoding).name,
                                codec=CompressionCodec(codec).name,
                                num_values=pg.num_values, non_null=None,
                                transport="cpu",
                                plan_s=time.perf_counter() - t_pg)
            elif ptype == PageType.INDEX_PAGE:
                page_i += 1
                continue  # index pages carry nothing to decode
            else:
                raise CorruptPageError(f"unexpected page type {ph.type}")
        except ScanError as e:
            raise e.annotate(column=col_path, page=page_i)
        except ValueError as e:
            # codec-layer domain errors become taxonomy errors with
            # coordinates
            raise CorruptPageError(str(e), column=col_path,
                                   page=page_i) from e
        page_i += 1
    if values_read != total:
        raise CorruptChunkError(
            f"chunk decoded {values_read} values, metadata says {total}",
            column=col_path)
    if not pages:
        rep = np.empty(0, dtype=np.int32)
        dl = np.empty(0, dtype=np.int32)
    elif len(pages) == 1:
        rep, dl = pages[0].rep_levels, pages[0].def_levels
    else:
        rep = np.concatenate([p.rep_levels for p in pages])
        dl = np.concatenate([p.def_levels for p in pages])
    null_count = int((dl != node.max_def_level).sum()) \
        if node.max_def_level else 0
    cd = ChunkData(_merge_page_values(pages, dictionary, node), rep, dl,
                   null_count)
    if keep_rows is None:
        return cd
    kept = (np.concatenate([np.arange(s, s + n, dtype=np.int64)
                            for s, n in kept_parts])
            if kept_parts else np.empty(0, dtype=np.int64))
    return cd, kept


def _merge_page_values(pages, dictionary, node):
    """The pages' values in order, each run of dictionary pages gathered
    once."""
    cols = []
    idx_parts = []
    for p in pages:
        if p.indices is not None:
            idx_parts.append(p.indices)
        elif p.values is not None:
            if idx_parts:
                cols.append(gather(dictionary, np.concatenate(idx_parts)))
                idx_parts = []
            cols.append(p.values)
    if idx_parts:
        cols.append(gather(dictionary, np.concatenate(idx_parts)))
    if not cols:
        return handler_for(node.element).finalize([])
    if len(cols) == 1:
        return cols[0]
    if isinstance(cols[0], ByteArrayColumn):
        offsets = [np.zeros(1, dtype=np.int64)]
        base = 0
        for c in cols:
            offsets.append(c.offsets[1:] + base)
            base += int(c.offsets[-1])
        return ByteArrayColumn(np.concatenate(offsets),
                               np.concatenate([c.data for c in cols]))
    return np.concatenate(cols)


# ----------------------------------------------------------------------
# Write
# ----------------------------------------------------------------------

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


def _statistics(handler, src, null_count: int, distinct) -> Statistics:
    """Chunk statistics over ``src`` (the dictionary when there is one:
    every value appears in it), bounds under the column's order
    (``ValueHandler.min_max``: NaN ignored, INT96 none, bytes
    lexicographic, unsigned integers as unsigned); byte types and
    unsigned integers write no deprecated signed-order min/max."""
    mn, mx = handler.min_max(src)
    st = Statistics(null_count=null_count, distinct_count=distinct,
                    min_value=handler.encode_stat_value(mn),
                    max_value=handler.encode_stat_value(mx))
    if not handler.unsigned and handler.ptype not in (
            Type.BYTE_ARRAY, Type.FIXED_LEN_BYTE_ARRAY):
        st.min = st.min_value
        st.max = st.max_value
    return st


def _page_bounds(node, page_column, n_values: int, page_rows: int):
    """The level-slot ranges of a chunk's data pages: one page, or
    ``page_rows`` slots a page for a flat column of host values (a
    repeated column's pages must break at records, and device values
    write whole)."""
    if (page_rows > 0 and n_values > page_rows and not node.max_rep_level
            and isinstance(page_column, (np.ndarray, ByteArrayColumn))):
        return [(a, min(a + page_rows, n_values))
                for a in range(0, n_values, page_rows)]
    return [(0, n_values)]


def _slice_column(column, va: int, vb: int):
    """Values ``[va, vb)`` of a page column, without a copy."""
    if isinstance(column, ByteArrayColumn):
        offs = column.offsets
        return ByteArrayColumn(offs[va:vb + 1] - offs[va],
                               column.data[offs[va]:offs[vb]])
    return column[va:vb]


def _page_statistics(handler, values, pg_null: int, chunk_stats,
                     dictionary):
    """One page's statistics in a split chunk: its own bounds for direct
    values; a dictionary page, or a page without values, takes the
    chunk's bounds (every page value is in the dictionary)."""
    if chunk_stats is None:
        return None
    if dictionary is not None or len(values) == 0:
        mn_b, mx_b = chunk_stats.min_value, chunk_stats.max_value
    else:
        mn, mx = handler.min_max(values)
        mn_b = handler.encode_stat_value(mn)
        mx_b = handler.encode_stat_value(mx)
    st = Statistics(null_count=pg_null, distinct_count=None,
                    min_value=mn_b, max_value=mx_b)
    if chunk_stats.min is not None:
        st.min = st.min_value
        st.max = st.max_value
    return st


def write_chunk(out, node, column, rep, dl: np.ndarray, *, codec,
                encoding: Encoding = Encoding.PLAIN, page_crc: bool = True,
                null_count: int = 0, num_rows: int | None = None,
                data_page_v2: bool = False,
                allow_dict: bool = True,
                write_stats: bool = True,
                page_index: bool = False,
                bloom: bool = False,
                page_rows: int = 0,
                pipeline_workers: int = 1,
                kv_metadata: dict | None = None) -> ColumnChunk:
    """Write one column chunk at the current position of ``out`` (a
    position-tracking binary stream).  ``column`` holds the non-null
    values (an array of the physical dtype, or a
    :class:`ByteArrayColumn`), ``rep``/``dl`` the repetition and
    definition level of every slot (``rep`` None for a flat column),
    ``num_rows`` the records (default: one per slot).  ``write_stats``
    off writes no statistics (and so no page index); ``page_rows`` > 0
    splits a flat column into pages of that many slots.  A one-page
    chunk takes ``pipeline_workers`` for the block-parallel split of its
    compressed body, as the JAX writer's does; a split chunk renders
    each next page on one worker while this thread writes the page
    before, when ``pipeline_workers`` > 1.  ``kv_metadata`` goes into the
    chunk's metadata, sorted by key."""
    ptype = Type(node.element.type)
    handler = handler_for(node.element)
    pos0 = out.tell()
    n_values = len(dl)
    dictionary, indices = (_maybe_dictionary(column)
                           if allow_dict and encoding == Encoding.PLAIN
                           and ptype != Type.BOOLEAN else (None, None))
    total_comp = total_uncomp = 0
    dict_page_offset = None
    distinct = None
    native_ctx = _native_page_ctx(codec)
    # stage marker: page writes emit no span while they run, so the
    # sampler needs one to put their stacks under "write"
    ptok = _profiler.stage_begin("write") \
        if _profiler._active is not None else None
    try:
        if dictionary is not None:
            dict_page_offset = pos0
            distinct = len(dictionary)
            c, u = write_dictionary_page(out, node, dictionary, codec,
                                         page_crc=page_crc)
            total_comp += c
            total_uncomp += u
        stats = (_statistics(handler, column if dictionary is None
                             else dictionary, null_count, distinct)
                 if write_stats else None)
        data_page_offset = out.tell()
        page_column = indices if dictionary is not None else column
        bounds = _page_bounds(node, page_column, n_values, page_rows)
        if len(bounds) == 1:
            if data_page_v2:
                c, u = write_data_page_v2(
                    out, node, page_column, rep, dl, codec,
                    null_count=null_count,
                    num_rows=n_values if num_rows is None else num_rows,
                    encoding=encoding, dictionary_size=distinct,
                    statistics=stats, page_crc=page_crc,
                    compress_workers=pipeline_workers,
                    native_ctx=native_ctx)
            else:
                c, u = write_data_page_v1(
                    out, node, page_column, rep, dl, codec,
                    encoding=encoding, dictionary_size=distinct,
                    statistics=stats, page_crc=page_crc,
                    compress_workers=pipeline_workers,
                    native_ctx=native_ctx)
            total_comp += c
            total_uncomp += u
            page_entries = [(stats, data_page_offset, c, 0)]
        else:
            u, page_entries = _write_split_pages(
                out, node, handler, page_column, dl, codec, encoding,
                bounds, distinct, stats, dictionary, data_page_v2,
                page_crc, pipeline_workers, native_ctx)
            total_comp += sum(e[2] for e in page_entries)
            total_uncomp += u
    finally:
        if ptok is not None:
            _profiler.stage_end(ptok)
    encodings = [Encoding.RLE, encoding]
    if dictionary is not None:
        encodings.append(Encoding.RLE_DICTIONARY)
    cm = ColumnMetaData(
        type=ptype,
        encodings=encodings,
        path_in_schema=list(node.path),
        codec=codec,
        num_values=n_values,
        total_uncompressed_size=total_uncomp,
        total_compressed_size=total_comp,
        data_page_offset=data_page_offset,
        dictionary_page_offset=dict_page_offset,
        statistics=stats,
        key_value_metadata=([KeyValue(key=k, value=v)
                             for k, v in sorted(kv_metadata.items())]
                            if kv_metadata else None),
    )
    cc = ColumnChunk(file_offset=pos0, meta_data=cm)
    if page_index and stats is not None:
        pi = _build_page_index(page_entries, n_values)
        if pi is not None:
            cc._page_index = pi
    if bloom:
        b = _build_bloom(handler, column, dictionary)
        if b is not None:
            cc._bloom = b
    return cc


def _write_split_pages(out, node, handler, page_column, dl, codec,
                       encoding, bounds, dict_size, chunk_stats, dictionary,
                       data_page_v2, page_crc, pipeline_workers, native_ctx):
    """The data pages of a split chunk, one a ``bounds`` entry, each with
    its own statistics.  With ``pipeline_workers`` > 1 one worker renders
    page N+1 while this thread writes page N (the same bytes).  Returns
    ``(uncompressed bytes, [(stats, offset, compressed size, first
    row)])``."""
    max_def = node.max_def_level
    if max_def:
        nnp = np.zeros(len(dl) + 1, dtype=np.int64)
        np.cumsum(dl == max_def, out=nnp[1:])
    rep0 = np.zeros(0, dtype=np.int32)  # flat columns: no rep stream

    def write_page(sink, a, b):
        va, vb = (int(nnp[a]), int(nnp[b])) if max_def else (a, b)
        vals = _slice_column(page_column, va, vb)
        pg_null = (b - a) - (vb - va)
        pg_stats = _page_statistics(
            handler, vals if dict_size is None else None, pg_null,
            chunk_stats, dictionary if dict_size is not None else None)
        if data_page_v2:
            c, u = write_data_page_v2(
                sink, node, vals, rep0, dl[a:b], codec, null_count=pg_null,
                num_rows=b - a, encoding=encoding, dictionary_size=dict_size,
                statistics=pg_stats, page_crc=page_crc,
                native_ctx=native_ctx)
        else:
            c, u = write_data_page_v1(
                sink, node, vals, rep0, dl[a:b], codec, encoding=encoding,
                dictionary_size=dict_size, statistics=pg_stats,
                page_crc=page_crc, native_ctx=native_ctx)
        return c, u, pg_stats

    def render(a, b):
        # one page into a buffer of its own, counted into a collector of
        # its own, merged when the page is appended
        buf = _CountingBuf()
        with worker_stats() as ws:
            c, u, pg_stats = write_page(buf, a, b)
        return buf.parts, c, u, pg_stats, ws

    entries = []
    total_uncomp = 0
    if pipeline_workers > 1:
        st = current_stats()
        # one page in flight beyond the one being written: at most two
        # page buffers alive
        with ThreadPoolExecutor(max_workers=1) as ex:
            futs = {j: ex.submit(render, *bounds[j])
                    for j in range(min(2, len(bounds)))}
            for i, (a, _b) in enumerate(bounds):
                parts, c, u, pg_stats, ws = futs.pop(i).result()
                off = out.tell()
                for part in parts:
                    out.write(part)
                if st is not None:
                    st.merge_from(ws)
                entries.append((pg_stats, off, c, a))
                total_uncomp += u
                if i + 2 < len(bounds):
                    futs[i + 2] = ex.submit(render, *bounds[i + 2])
    else:
        for a, b in bounds:
            off = out.tell()
            c, u, pg_stats = write_page(out, a, b)
            entries.append((pg_stats, off, c, a))
            total_uncomp += u
    return total_uncomp, entries


class _CountingBuf:
    """A position-tracking sink that keeps the written segments, so the
    coordinator appends them without a concatenation."""

    __slots__ = ("parts", "_pos")

    def __init__(self):
        self.parts = []
        self._pos = 0

    def tell(self) -> int:
        return self._pos

    def write(self, data) -> None:
        self.parts.append(bytes(data))
        self._pos += len(data)


def _build_page_index(page_entries, n_values: int):
    """``(ColumnIndex, OffsetIndex)`` from one ``(stats, offset,
    compressed size, first row)`` entry a data page: a one-page chunk's
    summary is its statistics (ASCENDING), a split chunk's pages carry
    their own (UNORDERED).  None when the column's order admits no index
    (INT96, or a page with values and no bounds)."""
    mins, maxs, null_pages, null_counts = [], [], [], []
    n_pages = len(page_entries)
    for i, (stats, _off, _size, first_row) in enumerate(page_entries):
        if stats is None:
            return None
        pg_values = (page_entries[i + 1][3] if i + 1 < n_pages
                     else n_values) - first_row
        all_null = (stats.null_count is not None
                    and stats.null_count == pg_values)
        if stats.min_value is None or stats.max_value is None:
            if not all_null:
                return None
            mins.append(b"")
            maxs.append(b"")
            null_pages.append(True)
        else:
            mins.append(stats.min_value)
            maxs.append(stats.max_value)
            null_pages.append(all_null)
        null_counts.append(stats.null_count)
    ci = ColumnIndex(
        null_pages=null_pages, min_values=mins, max_values=maxs,
        boundary_order=(BoundaryOrder.ASCENDING if n_pages == 1
                        else BoundaryOrder.UNORDERED),
        null_counts=(null_counts if all(c is not None for c in null_counts)
                     else None))
    oi = OffsetIndex(page_locations=[
        PageLocation(offset=off, compressed_page_size=size,
                     first_row_index=first_row)
        for (_st, off, size, first_row) in page_entries])
    return ci, oi


def _build_bloom(handler, column, dictionary):
    """A split-block bloom filter over the chunk's distinct values (the
    dictionary, when there is one, is that set), or None: INT96 and
    BOOLEAN, an empty chunk, or more than ``MAX_BLOOM_DISTINCT``
    values."""
    if handler.ptype in (Type.INT96, Type.BOOLEAN):
        return None
    src = dictionary if dictionary is not None else column
    if isinstance(src, DeviceValues):
        src = src.to_numpy()
    if isinstance(src, ByteArrayColumn):
        distinct = set(src.to_list())
        if not distinct or len(distinct) > MAX_BLOOM_DISTINCT:
            return None
        hashes = np.array([xxh64(v) for v in distinct], dtype=np.uint64)
    else:
        arr = np.asarray(src)
        if arr.size == 0:
            return None
        if arr.ndim == 2:  # FIXED_LEN_BYTE_ARRAY rows
            uniq = np.unique(np.ascontiguousarray(arr).view(
                np.dtype((np.void, arr.shape[1]))).reshape(-1))
        else:
            uniq = np.unique(arr)
        if uniq.size > MAX_BLOOM_DISTINCT:
            return None
        # each distinct value's PLAIN bytes, as encode_stat_value frames it
        hashes = xxh64_rows(np.ascontiguousarray(uniq).view(np.uint8)
                            .reshape(uniq.size, -1))
    b = SplitBlockBloom(optimal_bytes(hashes.size))
    b.insert_hashes(hashes)
    return b
