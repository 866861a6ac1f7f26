"""FileReader: footer, schema, column-chunk byte ranges and rows.

Opens a path, a byte-range source (``io/source.py``: a
:class:`~tpuparquet_torch.io.source.ByteRangeSource`, a ``file://``,
``emu://`` or ``http(s)://`` URI, or a bare path ``TPQ_SOURCE``
reroutes), a bytes-like object or a file object (read whole, from its
start).  A path stays open and each chunk's byte range is read from
it on demand (the seek and the read under the handle's lock, since the
plan workers of ``kernels/device.py`` read chunks of one reader at
once); the bytes of an in-memory source are held once and every chunk is
a zero-copy view of them.  Each chunk fetched counts ``bytes_read`` and
``read_s``; a path's range read is retried when it fails transiently
(``faults.retry_transient``, counted as ``io_retries``), an in-memory
view is not.  The open and the chunk reads are the fault sites
``io.reader.open``, ``io.reader.chunk_read`` and ``io.chunk.hang``
(``faults.py``).  Column names after the source restrict reading to those
dotted paths and their subtrees, as the reference's ``FileReader(source,
*columns)``; ``verify_crc`` gates the page CRC check as there (None: the
``TPQ_PAGE_CRC_VERIFY`` default, on unless ``0``).
:attr:`FileReader.plan_fingerprint` is the file's identity for the plan
cache (``kernels/plancache.py``); a salvaged reader has none, so
recovered metadata never fills or hits the cache.

The footer is untrusted on request.  ``strict_metadata`` (None:
``TPQ_STRICT_METADATA``, off) validates it against the file before use
(``format/validate.py``) and raises ``CorruptFooterError`` carrying the
findings on an error, counting ``metadata_rejects``.  ``salvage=True``
opens a file whose footer is torn or lies: a footer that does not decode
is rebuilt from the pages (``format/recover.py``, the schema from the
file's salvage hint or ``salvage_like``); one that decodes but fails
validation is either trimmed to its valid row-group prefix or rebuilt
from the pages, whichever keeps more row groups (a tie to the trim).
The reader is then :attr:`~FileReader.salvaged`, with a
:attr:`~FileReader.salvage_report`, and counts ``files_salvaged`` and
``row_groups_recovered``.

A path's chunk reads follow the time-domain policy of the reference:
``read_deadline`` (None: ``TPQ_READ_DEADLINE_S``, off) bounds each read
(``deadline.call_with_deadline``; an expiry is a transient error, so it
is retried), and ``mirrors`` (byte-identical replicas: paths or file
objects, opened at first use) hedge it: when the primary has not
answered after ``hedge_delay`` seconds (None: ``TPQ_HEDGE_DELAY_S``,
else the rolling p95 of observed reads, ``deadline.read_latency``), the
read is repeated against the next mirror and the first success wins
(``deadline.hedged_call``).  A read abandoned at its deadline may hold
the handle's lock forever, so the reader swaps in a fresh handle
(``_reopen_after_expiry``); two mirror wins in a row with no primary
read completing do the same.  A handle an abandoned read may still be
inside is never closed, only dropped.  Decoding is the device path's job
(``kernels/device.py``); :meth:`FileReader.read_row_group_arrays` is the
host decode (``io/chunk.py`` ``read_chunk``), the filtered read's oracle.

A byte-range source takes the remote read path.  Its footer, page-index
and bloom ranges go through the memory tier of the range caches
(``io/rangecache.py``, keyed by the source's etag and the range), its
chunk ranges through the disk tier; a miss fetches (retried, counted in
``remote_retry``) and counts ``remote_ranges_fetched`` and
``remote_bytes``.  :meth:`FileReader.prefetch_chunks` and
:meth:`FileReader.prefetch_ranges` coalesce a row group's missing chunk
ranges under ``TPQ_RANGE_COALESCE_GAP`` and fetch the spans in parallel
into the disk tier (``ranges_coalesced`` counts the requests a span
saved).  A corrupt page or chunk evicts the source's cached ranges from
both tiers, so a retry reads the store, not the poison.

The row API reads records on the host, as the reference does:
:meth:`FileReader.rows` and :meth:`FileReader.next_row` assemble them
(``io/store.py``) from each row group's :meth:`FileReader.
read_row_group_arrays`; :meth:`FileReader.pre_load` and
:meth:`FileReader.skip_row_group` move through the row groups.

Predicate pushdown reads three things here: :meth:`FileReader.page_index`
(each column's pages with their row ranges and logical bounds, checked
by ``format/validate.py`` ``validate_page_index``; a column whose index
does not read or does not check is left out, which prunes nothing),
:meth:`FileReader.bloom_filter` (a corrupt one reads as absent) and
:meth:`FileReader.prune_row_group`, the static verdict of one row group
(``filter.py``).  Both readers are the fault site ``format.pageindex``;
the page index is cached per reader and, under ``TPQ_PLAN_CACHE_MB``, in
the plan cache across reopens of the same file.
"""

from __future__ import annotations

import io
import os
import struct
import threading
import time
import zlib
from concurrent.futures import ThreadPoolExecutor

from ..deadline import call_with_deadline, hedge_delay_default, \
    hedged_call, read_deadline_default, read_latency
from ..errors import CorruptChunkError, CorruptFooterError, \
    CorruptPageError, DeadlineExceededError, ScanError, TransientIOError
from ..faults import fault_point, filter_bytes, retry_transient
from ..filter import PruneVerdict, _walk_leaves, bind_filter, \
    candidate_mask, may_match_stats, prune_enabled, \
    read_row_group_filtered, row_group_stats
from ..format.bloom import SplitBlockBloom
from ..format.compact import CompactReader, ThriftError
from ..format.footer import read_file_metadata
from ..format.metadata import BloomFilterHeader, ColumnIndex, \
    ColumnMetaData, FileMetaData, OffsetIndex, decode_struct
from ..format.recover import recover_file_metadata, salvage_valid_prefix
from ..format.schema import Schema
from ..format.validate import raise_on_errors, strict_metadata_default, \
    validate_metadata, validate_page_index
from ..kernels.plancache import invalidate_fingerprint, plan_cache, \
    plan_cache_budget
from ..obs import profiler as _profiler
from ..obs import recorder as _flightrec
from ..obs import trace as _trace
from ..obs.recorder import flight
from ..stats import current_stats, merge_worker_stats, worker_stats
from .chunk import ChunkData, read_chunk
from .rangecache import disk_cache, invalidate_source_caches, mem_cache
from .source import ByteRangeSource, RangeSourceFile, \
    coalesce_gap_default, coalesce_ranges, open_byte_source
from .store import assemble_record, attach_stores
from .values import handler_for

__all__ = ["FileReader"]

_FP_UNSET = object()  # plan_fingerprint not computed yet


class _IoHandle:
    """An open file, the lock that makes each seek and read pair atomic
    against the other plan workers, and a count of the reads in flight.
    The count tells an idle handle (safe to close) from one an abandoned
    deadline or hedge worker may still be blocked inside (left open:
    closing a buffered file would block on the lock the hung read
    holds).  ``owns``: the reader opened it, so it may close and reopen
    it."""

    __slots__ = ("f", "lock", "owns", "name", "inflight")

    def __init__(self, f: "RangeSourceFile | io.BufferedIOBase",
                 owns: bool, name=None):
        self.f = f
        self.lock = threading.Lock()
        self.owns = owns
        self.name = name
        self.inflight = 0   # under the reader's _count_lock


def _cached_range(source, start: int, size: int, fetch) -> bytes:
    """One absolute range of a byte-range source through the memory tier
    (keyed by the source's etag and the range); a miss calls ``fetch()``
    and counts ``remote_ranges_fetched`` and ``remote_bytes``."""
    key = source.etag() + (start, size)
    mc = mem_cache()
    data = None if mc is None else mc.get(key)
    if data is None:
        data = fetch()
        st = current_stats()
        if st is not None:
            st.remote_ranges_fetched += 1
            st.remote_bytes += size
        if mc is not None:
            mc.put(key, data)
    return data


class _MetaRangeFile:
    """A file object over a byte-range source whose every read is one
    absolute range through the memory tier (keyed by the source's etag),
    so reopens of one object (the fingerprint, a handle swapped after an
    expiry, a replica) cost no round trips.  A miss fetches with the
    retry ladder (``remote_retry``) and counts ``remote_ranges_fetched``
    and ``remote_bytes``.  Its position is its own."""

    def __init__(self, source):
        self.source = source
        self.name = source.uri
        self._pos = 0

    def read(self, size: int = -1) -> bytes:
        end = self.source.size()
        if size is None or size < 0:
            size = max(0, end - self._pos)
        else:
            size = min(size, max(0, end - self._pos))
        if size == 0:
            return b""
        start = self._pos
        data = _cached_range(
            self.source, start, size, lambda: retry_transient(
                lambda: self.source.get_range(start, size),
                counter="remote_retry"))
        self._pos += size
        return data

    def seek(self, offset: int, whence: int = os.SEEK_SET) -> int:
        if whence == os.SEEK_SET:
            self._pos = offset
        elif whence == os.SEEK_CUR:
            self._pos += offset
        elif whence == os.SEEK_END:
            self._pos = self.source.size() + offset
        else:
            raise ValueError(f"bad whence {whence}")
        return self._pos

    def tell(self) -> int:
        return self._pos


class FileReader:
    """Parquet file metadata + chunk access over a file, a byte-range
    source or a buffer."""

    def __init__(self, source, *columns: str,
                 verify_crc: bool | None = None,
                 strict_metadata: bool | None = None,
                 salvage: bool = False,
                 salvage_like=None,
                 mirrors=(),
                 hedge_delay: float | None = None,
                 read_deadline: float | None = None):
        self.verify_crc = verify_crc
        self._buf = None
        self._io = None
        self._mirrors = list(mirrors)
        # one handle a mirror, opened at first use: a read that never
        # hedges never touches its mirrors
        self._mirror_handles: list = [None] * len(self._mirrors)
        self._mirror_lock = threading.Lock()
        self._hedge_delay = hedge_delay
        self._read_deadline = (read_deadline if read_deadline is not None
                               else read_deadline_default())
        self._count_lock = threading.Lock()  # inflight and hedge streak
        # disk-tier keys a prefetch of this reader is fetching now, each
        # with the event its fetch sets when it ends
        self._prefetching: dict = {}
        self._prefetch_lock = threading.Lock()
        self._hedge_losses = 0  # mirror wins in a row, no primary read
        self.salvaged = False
        self.salvage_report = None
        self.metadata_findings = None
        self._plan_fp = _FP_UNSET
        # a byte-range source rides behind a file object, so the handle,
        # hedge and deadline machinery below serves it unchanged
        self._source = (source if isinstance(source, ByteRangeSource)
                        else open_byte_source(source)
                        if isinstance(source, str) else None)
        if self._source is not None:
            self.name = self._source.uri
            f = RangeSourceFile(self._source)
            try:
                fault_point("io.reader.open", file=self.name)
                self._size = self._source.size()
                self.meta = self._resolve_metadata(
                    _MetaRangeFile(self._source), f, strict_metadata,
                    salvage, salvage_like)
            except BaseException:
                f.close()
                raise
            self._io = _IoHandle(f, True, self.name)
        elif isinstance(source, (str, os.PathLike)):
            self.name = os.fspath(source)
            f = open(source, "rb")
            try:
                fault_point("io.reader.open", file=self.name)
                self._size = f.seek(0, os.SEEK_END)
                self.meta = self._resolve_metadata(
                    f, f, strict_metadata, salvage, salvage_like)
            except BaseException:
                f.close()
                raise
            self._io = _IoHandle(f, True, self.name)
        else:
            if hasattr(source, "read"):
                self.name = getattr(source, "name", None)
                source.seek(0)
                buf = source.read()
            else:
                self.name = None
                buf = bytes(source)
            self._buf = memoryview(buf)
            self._size = len(buf)
            fault_point("io.reader.open", file=self.name)
            self.meta = self._resolve_metadata(
                io.BytesIO(buf), self._buf, strict_metadata, salvage,
                salvage_like)
        self._pageindex_cache: dict = {}
        self._bloom_cache: dict = {}
        self.pageindex_findings: list = []
        self.schema = Schema.from_elements(self.meta.schema)
        attach_stores(self.schema)
        if columns:
            self.schema.set_selected_columns(*columns)
        self._rg_pos = 0          # the next row group the rows load
        self._loaded = False      # a row group is loaded into the stores
        self._current_rg = 0      # the last loaded (or next) row group
        self._current_record = 0
        self._rg_records = 0

    def _resolve_metadata(self, f, pages, strict_metadata, salvage,
                          salvage_like) -> FileMetaData:
        """The footer of ``f``, validated under ``strict_metadata`` and
        salvaged under ``salvage`` (the page scan reads ``pages``: the
        open file, or the in-memory view).  Errors name this file."""
        if strict_metadata is None:
            strict_metadata = strict_metadata_default()
        verify = self.verify_crc if self.verify_crc is not None else True
        try:
            meta = read_file_metadata(f)
        except CorruptFooterError as e:
            if not salvage:
                raise e.annotate(file=self.name)
            # the footer is unusable: rebuild it from the pages
            meta, report = recover_file_metadata(
                pages, like=salvage_like, verify_crc=verify)
            report["footer_error"] = str(e)
            self._mark_salvaged(meta, report)
            return meta
        if not (strict_metadata or salvage):
            return meta
        findings = validate_metadata(meta, self._size)
        self.metadata_findings = findings
        if not any(fd.is_error for fd in findings):
            return meta
        if salvage:
            # the footer decodes but lies.  Two routes: trim to the
            # valid row-group prefix (keeps the footer's richer
            # metadata), or rebuild from the pages (a lying footer over
            # intact pages loses nothing that way); whichever keeps more
            # row groups wins, a tie goes to the trim
            trimmed = salvage_valid_prefix(meta, self._size,
                                           findings=findings)
            if trimmed is not None and len(trimmed[0].row_groups) \
                    == len(meta.row_groups):
                # the trim kept everything: no page scan can beat it
                meta, report = trimmed
                self._mark_salvaged(meta, report)
                return meta
            try:
                rebuilt = recover_file_metadata(
                    pages, like=salvage_like, verify_crc=verify)
            except CorruptFooterError:
                rebuilt = None  # no donor and no hint
            best = None
            if trimmed is not None and (
                    rebuilt is None
                    or len(trimmed[0].row_groups)
                    >= len(rebuilt[0].row_groups)):
                best = trimmed
            elif rebuilt is not None:
                best = rebuilt
            if best is not None:
                meta, report = best
                self._mark_salvaged(meta, report)
                return meta
            # neither route is usable: the strict reject below
        flight("metadata_reject", site="io.reader.footer", file=self.name)
        st = current_stats()
        if st is not None:
            st.metadata_rejects += 1
            if st.events is not None:
                st.events.fault(site="io.reader.footer",
                                kind="metadata_reject", file=self.name)
        try:
            raise_on_errors(findings, file=self.name)
        except CorruptFooterError as e:
            raise e.annotate(file=self.name)
        return meta

    def _mark_salvaged(self, meta: FileMetaData, report: dict) -> None:
        flight("salvaged", site="io.reader.footer", file=self.name,
               row_groups=len(meta.row_groups or []),
               stop_reason=report.get("stop_reason"))
        self.salvaged = True
        self.salvage_report = report
        st = current_stats()
        if st is not None:
            st.files_salvaged += 1
            st.row_groups_recovered += len(meta.row_groups or [])
            if st.events is not None:
                st.events.fault(site="io.reader.footer", kind="salvaged",
                                file=self.name,
                                row_groups=len(meta.row_groups or []),
                                stop_reason=report.get("stop_reason"))

    @property
    def num_rows(self) -> int:
        return self.meta.num_rows

    def close(self) -> None:
        """Close the file and the mirrors this reader opened, or release
        the buffer (columns already decoded keep their device buffers).
        A handle an abandoned read is still inside is left to it."""
        with self._mirror_lock:
            dropped = list(self._mirror_handles)
            self._mirror_handles = [None] * len(self._mirrors)
        for h in dropped + [self._io]:
            if h is not None and h.owns:
                with self._count_lock:
                    idle = h.inflight == 0
                if idle:
                    h.f.close()
        self._buf = memoryview(b"") if self._buf is not None else None

    def __enter__(self):
        return self

    def __exit__(self, exc_type, exc, tb):
        self.close()

    def row_group_count(self) -> int:
        return len(self.meta.row_groups)

    def metadata(self) -> FileMetaData:
        return self.meta

    def key_value_metadata(self) -> dict:
        return {kv.key: kv.value
                for kv in (self.meta.key_value_metadata or [])}

    def column_meta_data(self, column: str) -> tuple[dict, ColumnMetaData]:
        """The file's key-value metadata and ``column``'s chunk metadata
        in the current row group of the row API."""
        rg = self.meta.row_groups[self._current_rg]
        for cc in rg.columns:
            if ".".join(cc.meta_data.path_in_schema) == column:
                return self.key_value_metadata(), cc.meta_data
        raise KeyError(f"no such column {column!r}")

    def current_row_group(self):
        return self.meta.row_groups[self._current_rg]

    def get_schema_definition(self):
        """The schema's DSL view (``str()`` of it is the text)."""
        return self.schema.definition()

    # -- the row API: records assembled on the host from a row group's
    # host decode (read_row_group_arrays), as the reference reads rows

    def pre_load(self) -> None:
        """Load the next row group now."""
        if not self._loaded:
            self._load_next()

    def skip_row_group(self) -> None:
        """Skip the rest of the current row group, or the next one when
        none is loaded."""
        if self._loaded:
            self._loaded = False
        else:
            self._rg_pos += 1

    def _load_next(self) -> None:
        if self._rg_pos >= len(self.meta.row_groups):
            raise EOFError("no more row groups")
        idx = self._rg_pos
        data = self.read_row_group_arrays(idx)
        for leaf in self.schema.leaves:
            cd = data.get(leaf.flat_name)
            if cd is None:
                leaf.store.mark_skipped()
            else:
                leaf.store.load_decoded(cd.values, cd.rep_levels,
                                        cd.def_levels)
        self._current_rg = idx
        self._rg_pos += 1
        self._loaded = True
        self._current_record = 0
        self._rg_records = self.meta.row_groups[idx].num_rows

    def next_row(self) -> dict:
        """The next record as a dict (groups as dicts, repeated fields as
        lists, nulls left out); EOFError at the end of the file."""
        while True:
            if not self._loaded:
                self._load_next()  # EOFError when none is left
            if self._current_record < self._rg_records:
                self._current_record += 1
                if self._current_record >= self._rg_records:
                    self._loaded = False  # the next call moves on
                return assemble_record(self.schema)
            self._loaded = False

    def rows(self):
        """Iterate over the records left."""
        while True:
            try:
                yield self.next_row()
            except EOFError:
                return

    def selected_chunks(self, rg):
        """``[(path, node, cm)]`` for the selected columns of a row
        group."""
        out = []
        for cc in rg.columns:
            cm = cc.meta_data
            path = ".".join(cm.path_in_schema)
            node = self.schema.leaf(path)
            if node is None:
                raise ValueError(f"column {path!r} not in schema")
            if not self.schema.is_selected(node):
                continue
            out.append((path, node, cm))
        return out

    @staticmethod
    def _chunk_start(cm) -> int:
        start = cm.data_page_offset
        if cm.dictionary_page_offset is not None:
            start = min(start, cm.dictionary_page_offset)
        return start

    def chunk_blob(self, cm, path: str):
        """One chunk's bytes as ``(memoryview, start_offset)``: a view of
        an in-memory source, a range read of a file under the
        time-domain policy (:meth:`_read_chunk_bytes`).  Thread-safe."""
        start = self._chunk_start(cm)
        size = cm.total_compressed_size
        if start < 0 or size < 0 or start + size > self._size:
            raise CorruptChunkError("column chunk overruns file",
                                    column=path, file=self.name)
        t0 = time.perf_counter()
        # off-CPU marker: a thread sampled inside the fetch (a hang, the
        # retry, hedge and deadline waits) waits on IO
        ptok = _profiler.wait_begin("io", "io.reader.chunk_read") \
            if _profiler._active is not None else None
        try:
            if self._io is None:
                fault_point("io.reader.chunk_read", column=path)
                fault_point("io.chunk.hang", file=self.name, column=path)
                blob = self._buf[start : start + size]
            else:
                # a source's chunk ranges live in the disk tier: a hit
                # skips the fetch, a miss fetches through the whole read
                # policy and fills the tier
                dcache = ckey = got = None
                if self._source is not None:
                    dcache = disk_cache()
                    if dcache is not None:
                        ckey = self._source.etag() + (start, size)
                        got = dcache.get(ckey)
                if got is None:
                    got = self._read_chunk_bytes(start, size, path)
                    if len(got) < size:
                        raise CorruptChunkError(
                            f"column chunk short read: {len(got)}/{size} "
                            "bytes", column=path, file=self.name)
                    if self._source is not None:
                        st = current_stats()
                        if st is not None:
                            st.remote_ranges_fetched += 1
                            st.remote_bytes += len(got)
                        if dcache is not None:
                            dcache.put(ckey, got)
                blob = memoryview(got)
        finally:
            if ptok is not None:
                _profiler.wait_end(ptok)
        blob = filter_bytes("io.reader.chunk_read", blob, column=path)
        dt = time.perf_counter() - t0
        st = current_stats()
        if st is not None:
            st.read_s += dt
            st.bytes_read += len(blob)
        # one flight record and one read span a chunk read (the calls
        # guarded: the off path skips building their arguments)
        if _flightrec._active is not None:
            _flightrec.flight("chunk_read", site="io.reader",
                              file=self.name, column=path, bytes=size)
        if _trace._active is not None:
            _trace.emit_span("read", t0, dt, file=self.name, column=path,
                             bytes=size)
        return blob, start

    def _read_range(self, start: int, size: int) -> bytes:
        """A small absolute byte range (page-index and bloom blobs);
        raises ValueError when it escapes the file."""
        if start < 0 or size <= 0:
            raise ValueError(f"bad byte range [{start}, {start + size})")
        if start + size > self._size:
            raise ValueError("byte range overruns the file")
        if self._io is None:
            return bytes(self._buf[start : start + size])
        if self._source is not None:
            # the page-index and bloom blobs live in the memory tier
            return _cached_range(self._source, start, size,
                                 lambda: self._source.get_range(start, size))
        with self._count_lock:
            h = self._io
            h.inflight += 1
        try:
            with h.lock:
                h.f.seek(start)
                out = h.f.read(size)
        finally:
            with self._count_lock:
                h.inflight -= 1
        if len(out) != size:
            raise ValueError(f"short read: {len(out)}/{size} bytes at "
                             f"{start}")
        return out

    def page_index(self, rg_index: int, columns=None) -> dict:
        """The parsed page index of one row group: ``{column: [(row_start,
        row_end, min, max, null_count, null_page)]}`` a data page, bounds
        as logical values (:func:`~tpuparquet_torch.filter.candidate_mask`'s
        input).  A column without an index, or whose index fails to read
        or to validate, is absent: no pruning.  ``columns`` restricts the
        result.  Cached per reader, and in the plan cache across reopens;
        a transient failure is cached by neither."""
        want = None if columns is None else set(columns)

        def view(parsed: dict) -> dict:
            return ({k: v for k, v in parsed.items() if k in want}
                    if want is not None else dict(parsed))

        cached = self._pageindex_cache.get(rg_index)
        if cached is not None:
            return view(cached)
        pc = plan_cache()
        pc_key = None
        if pc is not None and self.plan_fingerprint is not None:
            pc_key = (self.plan_fingerprint, rg_index, "__pageindex__")
            got = pc.lookup(pc_key)
            if got is not None:
                out = {col: pages for col, pages in got
                       if pages is not None}
                self._pageindex_cache[rg_index] = out
                return view(out)
        rg = self.meta.row_groups[rg_index]
        out: dict = {}
        absent: set = set()
        transient = False
        for cc in rg.columns:
            cm = cc.meta_data
            path = ".".join(cm.path_in_schema)
            if cc.column_index_offset is None \
                    or cc.column_index_length is None \
                    or cc.offset_index_offset is None \
                    or cc.offset_index_length is None:
                absent.add(path)
                continue
            node = self.schema.leaf(path)
            try:
                fault_point("format.pageindex", file=self.name, column=path)
                ci_blob = filter_bytes(
                    "format.pageindex",
                    retry_transient(lambda: self._read_range(
                        cc.column_index_offset, cc.column_index_length),
                        counter=self._retry_counter),
                    column=path)
                oi_blob = retry_transient(lambda: self._read_range(
                    cc.offset_index_offset, cc.offset_index_length),
                    counter=self._retry_counter)
                ci = ColumnIndex.from_bytes(ci_blob)
                oi = OffsetIndex.from_bytes(oi_blob)
                findings = validate_page_index(
                    ci, oi, cm, rg.num_rows, self._size,
                    element=None if node is None else node.element,
                    row_group=rg_index)
                errors = [f for f in findings if f.is_error]
                if errors:
                    self.pageindex_findings.extend(findings)
                    raise ValueError(
                        f"page index failed validation: {errors[0]}")
                handler = (handler_for(node.element)
                           if node is not None else None)
                if handler is not None \
                        and not handler.stats_bytewise_comparable():
                    handler = None  # bounds unusable: rows kept
                locs = oi.page_locations
                pages = []
                for i, loc in enumerate(locs):
                    r0 = loc.first_row_index
                    r1 = (locs[i + 1].first_row_index
                          if i + 1 < len(locs) else rg.num_rows)
                    null_page = bool(ci.null_pages[i])
                    if null_page or handler is None:
                        mn = mx = None
                    else:
                        mn = handler.decode_stat_logical(ci.min_values[i])
                        mx = handler.decode_stat_logical(ci.max_values[i])
                    nulls = (ci.null_counts[i]
                             if ci.null_counts is not None else None)
                    pages.append((r0, r1, mn, mx, nulls, null_page))
                out[path] = pages
            except (ScanError, OSError, ValueError, ThriftError,
                    IndexError, KeyError, TypeError, OverflowError) as e:
                # a corrupt or lying index degrades this column to no
                # pruning; a transient failure past its retries does too,
                # but is not remembered as an absent index
                if isinstance(e, (TransientIOError, OSError)) \
                        and not isinstance(e, ValueError):
                    transient = True
                absent.add(path)
                flight("pageindex_reject", site="format.pageindex",
                       file=self.name, row_group=rg_index, column=path,
                       error=type(e).__name__)
                st = current_stats()
                if st is not None and st.events is not None:
                    st.events.fault(site="format.pageindex",
                                    kind="pageindex_reject", file=self.name,
                                    row_group=rg_index, column=path,
                                    error=type(e).__name__)
        if not transient:
            self._pageindex_cache[rg_index] = out
            if pc_key is not None:
                pc.store(pc_key, [(col, out.get(col)) for col in
                                  sorted(out.keys() | absent)],
                         plan_cache_budget())
        return view(out)

    def bloom_filter(self, rg_index: int, column: str):
        """The split-block bloom filter of one column chunk, or None
        (absent or corrupt).  Cached per reader, but for a transient
        failure."""
        key = (rg_index, column)
        if key in self._bloom_cache:
            return self._bloom_cache[key]
        got = None
        transient = False
        for cc in self.meta.row_groups[rg_index].columns:
            cm = cc.meta_data
            if ".".join(cm.path_in_schema) != column:
                continue
            if cm.bloom_filter_offset is None:
                break
            try:
                fault_point("format.pageindex", file=self.name,
                            column=column)

                def read():
                    if cm.bloom_filter_length is not None:
                        return self._read_range(cm.bloom_filter_offset,
                                                cm.bloom_filter_length)
                    # no length (older writers): the header first, then
                    # exactly the bitset it announces
                    r = CompactReader(self._read_range(
                        cm.bloom_filter_offset,
                        min(256, self._size - cm.bloom_filter_offset)))
                    header = decode_struct(BloomFilterHeader, r)
                    return self._read_range(cm.bloom_filter_offset,
                                            r.pos + (header.numBytes or 0))

                blob = filter_bytes("format.pageindex",
                                    retry_transient(
                                        read, counter=self._retry_counter),
                                    column=column)
                got = SplitBlockBloom.from_bytes(blob)
            except (ScanError, OSError, ValueError, ThriftError,
                    IndexError, KeyError, TypeError, OverflowError) as e:
                if isinstance(e, (TransientIOError, OSError)) \
                        and not isinstance(e, ValueError):
                    transient = True
                flight("bloom_reject", site="format.pageindex",
                       file=self.name, row_group=rg_index, column=column,
                       error=type(e).__name__)
                got = None
            break
        if not transient:
            self._bloom_cache[key] = got
        return got

    def prune_row_group(self, f, rg_index: int, *, pages: bool = True):
        """The static pruning verdict of one row group against a filter
        (bound here): chunk statistics, then bloom filters (an ``==`` or
        ``IN`` refuted counts on the verdict's ``bloom_hits``), then the
        page index's candidate rows.  ``skip`` only when no row can
        match; with ``TPQ_PRUNE=0`` every row is a candidate."""
        bind_filter(f, self.schema)
        if not prune_enabled():
            return PruneVerdict()
        rg = self.meta.row_groups[rg_index]
        wanted = f.columns()
        stats = row_group_stats(rg, self.schema, wanted)
        hits = [0]

        def bloom_probe(column, probes):
            b = self.bloom_filter(rg_index, column)
            if b is None:
                return True
            h = next((leaf._h for leaf, _neg in _walk_leaves(f)
                      if leaf.column == column
                      and getattr(leaf, "_h", None) is not None), None)
            if h is None:
                return True
            for v in probes:
                try:
                    enc = h.encode_stat_value(v)
                except (TypeError, ValueError, OverflowError):
                    return True
                if enc is None or b.check(enc):
                    return True
            hits[0] += 1
            return False

        # bloom hits ride the verdict, not the collector: the scans prune
        # when they form their units and count at run start
        if not may_match_stats(f, stats, bloom_probe):
            return PruneVerdict(skip=True,
                                reason="bloom" if hits[0] else "stats",
                                bloom_hits=hits[0])
        if not pages:
            return PruneVerdict(bloom_hits=hits[0])
        pages_by_col = self.page_index(rg_index, columns=wanted)
        if not pages_by_col:
            return PruneVerdict(bloom_hits=hits[0])
        cand = candidate_mask(f, pages_by_col, rg.num_rows)
        if not cand.any():
            return PruneVerdict(skip=True, reason="pages",
                                pages_by_col=pages_by_col,
                                bloom_hits=hits[0])
        if cand.all():
            cand = None  # every row a candidate: no narrowing
        return PruneVerdict(candidate=cand, pages_by_col=pages_by_col,
                            bloom_hits=hits[0])

    def read_row_group_arrays(self, rg_index: int,
                              filter=None) -> dict[str, ChunkData]:
        """Decode the selected columns of one row group on the host into
        :class:`~tpuparquet_torch.io.chunk.ChunkData` (the filtered
        read's oracle).  With ``filter`` the late-materialized read runs
        (``filter.py`` ``read_row_group_filtered``): the chunks hold
        exactly the surviving rows."""
        if not 0 <= rg_index < len(self.meta.row_groups):
            raise IndexError(f"row group {rg_index} out of range (file has "
                             f"{len(self.meta.row_groups)})")
        st = current_stats()
        if st is not None:
            st.row_groups += 1
        try:
            if filter is not None:
                return read_row_group_filtered(self, rg_index, filter)[0]
            out = {}
            rg = self.meta.row_groups[rg_index]
            self.prefetch_chunks(rg)
            for path, node, cm in self.selected_chunks(rg):
                blob, start = self.chunk_blob(cm, path)
                out[path] = read_chunk(blob, _rebase(cm, start), node,
                                       verify_crc=self.verify_crc)
            return out
        except ScanError as e:
            if filter is None and isinstance(e, (CorruptPageError,
                                                 CorruptChunkError)):
                # the bytes no longer match the footer: drop the file's
                # cached plans (only a fingerprint already computed can
                # have any), and a source's cached ranges, which may
                # have served the bad bytes
                invalidate_fingerprint(self.cached_plan_fingerprint())
                self.drop_range_caches()
            raise e.annotate(row_group=rg_index, file=self.name)

    def drop_range_caches(self) -> None:
        """Evict this reader's source from both range-cache tiers (a
        no-op for a path or a buffer): the corruption hook, so a retry
        refetches from the store."""
        if self._source is not None:
            invalidate_source_caches(self._source.uri)

    def prefetch_chunks(self, rg) -> None:
        """Fetch the selected chunk ranges of one row group into the disk
        tier ahead of their reads (a no-op but for a byte-range source)."""
        if self._source is None:
            return
        self.prefetch_ranges([
            (self._chunk_start(cm), cm.total_compressed_size, path)
            for path, _node, cm in self.selected_chunks(rg)])

    def prefetch_ranges(self, entries) -> None:
        """Coalesce ``(start, size, path)`` requests not already in the
        disk tier under ``TPQ_RANGE_COALESCE_GAP`` and fetch the spans in
        parallel on the plan workers' budget, each member range stored in
        the tier.  Counts ``remote_ranges_fetched`` a span issued,
        ``ranges_coalesced`` the requests a span saved and
        ``remote_bytes`` the spans' bytes, gap bytes included.  A span
        that fails past its retries is not cached: the chunk read then
        fetches it again and raises with its coordinates.  A range that
        another thread's prefetch through this reader is fetching is
        waited for instead."""
        if self._source is None or not entries:
            return
        dcache = disk_cache()
        if dcache is None:
            return
        etag = self._source.etag()
        missing = [(s, n) for s, n, _p in entries
                   if not dcache.contains(etag + (s, n))]
        if not missing:
            return
        # a range another thread's prefetch through this reader is
        # fetching now (the scan server's planner ahead of the decode, or
        # the decode itself) is waited for, not fetched a second time
        mine, waits = [], []
        with self._prefetch_lock:
            for s, n in missing:
                ev = self._prefetching.get(etag + (s, n))
                if ev is not None:
                    waits.append(ev)
                elif not dcache.contains(etag + (s, n)):
                    # (a fetch that ended since the first look stored
                    # its ranges before it left the table)
                    self._prefetching[etag + (s, n)] = threading.Event()
                    mine.append((s, n))
        try:
            if mine:
                self._fetch_spans(mine, dcache, etag)
        finally:
            with self._prefetch_lock:
                for s, n in mine:
                    self._prefetching.pop(etag + (s, n)).set()
        for ev in waits:
            ev.wait()

    def _fetch_spans(self, missing, dcache, etag) -> None:
        """Fetch ``missing`` ``(start, size)`` ranges coalesced into spans
        and store each in the disk tier (:meth:`prefetch_ranges`)."""
        spans = coalesce_ranges(missing, coalesce_gap_default())

        def fetch_span(start, size):
            def one():
                if self._read_deadline:
                    return call_with_deadline(
                        lambda: self._source.get_range(start, size),
                        self._read_deadline, site="io.remote.range",
                        file=self.name)
                return self._source.get_range(start, size)
            try:
                return retry_transient(one, counter="remote_retry")
            except (ScanError, OSError):
                return None  # the chunk read fetches and raises it

        from ..kernels.device import _plan_threads

        n_workers = min(_plan_threads(), len(spans))
        if n_workers <= 1:
            fetched = [fetch_span(s, n) for s, n, _m in spans]
        else:
            like = current_stats()

            def task(start, size):
                # a collector a worker, merged after the join
                with worker_stats(like=like) as ws:
                    out = fetch_span(start, size)
                return out, ws

            with ThreadPoolExecutor(max_workers=n_workers) as ex:
                futs = [ex.submit(task, s, n) for s, n, _m in spans]
                fetched = []
                for fu in futs:
                    out, ws = fu.result()
                    merge_worker_stats(like, ws, failed=out is None)
                    fetched.append(out)
        st = current_stats()
        for (start, size, members), data in zip(spans, fetched):
            if data is None:
                continue
            if _flightrec._active is not None:
                _flightrec.flight(
                    "prefetch_span", site="io.reader", file=self.name,
                    start=start, size=size, members=len(members))
            if st is not None:
                st.remote_ranges_fetched += 1
                st.remote_bytes += size
                st.ranges_coalesced += len(members) - 1
            for mi in members:
                ms, mn = missing[mi]
                dcache.put(etag + (ms, mn),
                           bytes(data[ms - start : ms - start + mn]))

    @property
    def plan_fingerprint(self):
        """The plan cache's identity of this file (lazy; two plan workers
        that race to compute it compute the same value)."""
        if self._plan_fp is _FP_UNSET:
            self._plan_fp = self._compute_fingerprint()
        return self._plan_fp

    def cached_plan_fingerprint(self):
        """The fingerprint if already computed, else None (never reads
        the file)."""
        return None if self._plan_fp is _FP_UNSET else self._plan_fp

    def _compute_fingerprint(self):
        """``(CRC32 of the footer's thrift bytes, file size, footer
        length)``, or None when the tail cannot hold a footer.  A file's
        footer is read under the handle's lock, which the chunk reads
        take too; a source's through the memory tier, where the open
        left the footer's ranges."""
        size = self._size
        if size < 12 or self.salvaged:
            return None
        try:
            if self._source is not None:
                mf = _MetaRangeFile(self._source)
                mf.seek(size - 8)
                # the whole 8-byte tail: the range the footer read cached
                (flen,) = struct.unpack("<I", mf.read(8)[:4])
                if flen <= 0 or size - 8 - flen < 4:
                    return None
                mf.seek(size - 8 - flen)
                crc = zlib.crc32(mf.read(flen))
            elif self._io is None:
                (flen,) = struct.unpack("<I", self._buf[size - 8 : size - 4])
                if flen <= 0 or size - 8 - flen < 4:
                    return None
                crc = zlib.crc32(self._buf[size - 8 - flen : size - 8])
            else:
                with self._count_lock:
                    h = self._io
                    h.inflight += 1
                try:
                    with h.lock:
                        h.f.seek(size - 8)
                        (flen,) = struct.unpack("<I", h.f.read(4))
                        if flen <= 0 or size - 8 - flen < 4:
                            return None
                        h.f.seek(size - 8 - flen)
                        crc = zlib.crc32(h.f.read(flen))
                finally:
                    with self._count_lock:
                        h.inflight -= 1
        except (OSError, ValueError, struct.error):
            return None
        return (crc, size, flen)

    # -- timed, hedged, deadline-bounded chunk reads ----------------------

    def _read_chunk_bytes(self, start: int, size: int, path: str):
        """One chunk's bytes under the whole time-domain policy: retried
        with backoff (transient errors and deadline expiries alike),
        hedged against the mirrors after the hedge delay, each read
        bounded by ``read_deadline``."""

        def _read_primary(start=start, size=size, path=path):
            # the fault sites sit inside the retried callable, so an
            # injected fault takes the ladder a flaky store would; the
            # hang sits outside the handle's lock, so it models a slow
            # read without pinning the lock its siblings need
            fault_point("io.reader.chunk_read", column=path)
            fault_point("io.chunk.hang", file=self.name, column=path)
            # the handle is captured and counted under one lock: the
            # closers check the count under it before closing
            with self._count_lock:
                h = self._io
                h.inflight += 1
            try:
                with h.lock:
                    h.f.seek(start)
                    out = h.f.read(size)
            finally:
                with self._count_lock:
                    h.inflight -= 1
            # a primary read that completes, even on an abandoned
            # branch, proves the handle alive (_note_hedge_win)
            with self._count_lock:
                self._hedge_losses = 0
            return out

        if self._mirrors:
            branches = [_read_primary] + [
                (lambda mi=mi: self._mirror_read(mi, start, size, path))
                for mi in range(len(self._mirrors))]

            def _hedged():
                try:
                    return hedged_call(
                        branches, delay=self._resolve_hedge_delay(),
                        site="io.reader.chunk_read",
                        budget=self._read_deadline, tracker=read_latency,
                        on_win=self._note_hedge_win,
                        file=self.name, column=path)
                except DeadlineExceededError:
                    self._reopen_after_expiry()
                    raise

            return retry_transient(_hedged, counter=self._retry_counter)
        if self._read_deadline:
            def fn():
                try:
                    return call_with_deadline(
                        _read_primary, self._read_deadline,
                        site="io.reader.chunk_read", file=self.name,
                        column=path)
                except DeadlineExceededError:
                    self._reopen_after_expiry()
                    raise
        else:
            fn = _read_primary

        def _timed():
            t0 = time.monotonic()
            out = fn()
            # the reads that succeed feed the adaptive hedge delay
            read_latency.record(time.monotonic() - t0)
            return out

        return retry_transient(_timed, counter=self._retry_counter)

    @property
    def _retry_counter(self) -> str:
        """The counter the retry ladder bumps: ``remote_retry`` for a
        byte-range source, so a flaky store is told from a flaky disk."""
        return "remote_retry" if self._source is not None else "io_retries"

    def _note_hedge_win(self, i: int) -> None:
        """A mirror's win means the primary lost (slow or hung, which a
        win cannot tell apart).  Two mirror wins in a row with no primary
        read completing mean a wedged primary handle (a dead mount with
        no ``read_deadline`` to expire it): it is swapped out, so later
        reads do not each wait a hedge delay behind it."""
        if i == 0:
            return
        with self._count_lock:
            self._hedge_losses += 1
            wedged = self._hedge_losses >= 2
            if wedged:
                self._hedge_losses = 0
        if wedged:
            self._reopen_after_expiry()

    def _reopen_after_expiry(self) -> None:
        """Un-poison the reader after an abandoned read: a worker hung
        inside ``read()`` holds its handle's lock forever, so every later
        read would queue behind it.  The primary gets a fresh handle and
        lock, and the mirror handles this reader opened are dropped (a
        hedge branch may have been the hung one); a dropped handle is
        closed only when idle.  A byte-range source is reopened
        (``source.reopen()``); a file object given by the caller cannot
        be reopened."""
        with self._mirror_lock:
            for i, h in enumerate(self._mirror_handles):
                if h is not None and h.owns:
                    with self._count_lock:
                        idle = h.inflight == 0
                    if idle:
                        h.f.close()
                    self._mirror_handles[i] = None
        if self._io is None or not self._io.owns:
            return
        try:
            if self._source is not None:
                ns = self._source.reopen()
                f = RangeSourceFile(ns)
                self._source = ns
            else:
                f = open(self.name, "rb")
        except OSError:
            return  # keep the old handle; the retry ladder decides
        nh = _IoHandle(f, True, self.name)
        with self._count_lock:
            # swap and idle check at once against capture and count:
            # after the swap no reader can capture the old handle
            old = self._io
            self._io = nh
            idle = old.inflight == 0
        if idle:
            old.f.close()

    def _mirror_handle(self, mi: int) -> _IoHandle:
        h = self._mirror_handles[mi]
        if h is not None:
            return h
        # the open, which may block, happens outside the list's lock
        src = self._mirrors[mi]
        if hasattr(src, "read"):
            nh = _IoHandle(src, False, getattr(src, "name", None))
        else:
            bs = (src if isinstance(src, ByteRangeSource)
                  else open_byte_source(src) if isinstance(src, str)
                  else None)
            if bs is not None:
                nh = _IoHandle(RangeSourceFile(bs), True, bs.uri)
            else:
                nh = _IoHandle(open(src, "rb"), True, os.fspath(src))
        with self._mirror_lock:
            cur = self._mirror_handles[mi]
            if cur is None:
                self._mirror_handles[mi] = nh
                return nh
        if nh.owns:  # another branch opened it first
            nh.f.close()
        return cur

    def _mirror_read(self, mi: int, start: int, size: int, path: str):
        # capture and count with the handle re-checked under the list's
        # lock: the closers drop a handle from the list under it before
        # closing, so a listed handle is not mid-close
        while True:
            h = self._mirror_handle(mi)
            with self._mirror_lock:
                if self._mirror_handles[mi] is h:
                    with self._count_lock:
                        h.inflight += 1
                    break
        try:
            # the fault sites inside the counted region: an injected
            # error must still give the count back
            fault_point("io.reader.chunk_read", column=path)
            fault_point("io.chunk.hang", file=h.name, column=path)
            with h.lock:
                h.f.seek(start)
                return h.f.read(size)
        finally:
            with self._count_lock:
                h.inflight -= 1

    def _resolve_hedge_delay(self) -> float:
        if self._hedge_delay is not None:
            return self._hedge_delay
        env = hedge_delay_default()
        return env if env is not None else read_latency.hedge_delay()


def _rebase(cm: ColumnMetaData, base: int) -> ColumnMetaData:
    """A chunk's metadata with its offsets relative to a byte range
    starting at file offset ``base``."""
    out = ColumnMetaData(**{name: getattr(cm, name) for name in cm._NAMES})
    out.data_page_offset = cm.data_page_offset - base
    if cm.dictionary_page_offset is not None:
        out.dictionary_page_offset = cm.dictionary_page_offset - base
    return out
