"""FileReader subset: footer, schema and column-chunk byte ranges.

Opens a path, a bytes-like object or a file object (read whole, from
its start).  A path stays open and each chunk's byte range is read from
it on demand (the seek and the read under the handle's lock, since the
plan workers of ``kernels/device.py`` read chunks of one reader at
once); the bytes of an in-memory source are held once and every chunk is
a zero-copy view of them.  Each chunk fetched counts ``bytes_read`` and
``read_s``.  Column names after the source restrict reading to those
dotted paths and their subtrees, as the reference's ``FileReader(source,
*columns)``; ``verify_crc`` gates the page CRC check as there (None: the
``TPQ_PAGE_CRC_VERIFY`` default, on unless ``0``).
:attr:`FileReader.plan_fingerprint` is the file's identity for the plan
cache (``kernels/plancache.py``).  Decoding is the device path's job
(``kernels/device.py``).
"""

from __future__ import annotations

import io
import os
import struct
import threading
import time
import zlib

from ..errors import CorruptChunkError
from ..format.footer import read_file_metadata
from ..format.schema import Schema
from ..stats import current_stats

__all__ = ["FileReader"]

_FP_UNSET = object()  # plan_fingerprint not computed yet


class _IoHandle:
    """An open file and the lock that makes each seek and read pair
    atomic against the other plan workers."""

    __slots__ = ("f", "lock")

    def __init__(self, f):
        self.f = f
        self.lock = threading.Lock()


class FileReader:
    """Parquet file metadata + chunk access over a file or a buffer."""

    def __init__(self, source, *columns: str,
                 verify_crc: bool | None = None):
        self.verify_crc = verify_crc
        self._buf = None
        self._io = None
        if isinstance(source, (str, os.PathLike)):
            self.name = os.fspath(source)
            f = open(source, "rb")
            try:
                self.meta = read_file_metadata(f)
                self._size = f.seek(0, os.SEEK_END)
            except BaseException:
                f.close()
                raise
            self._io = _IoHandle(f)
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
            self.meta = read_file_metadata(io.BytesIO(buf))
        self._plan_fp = _FP_UNSET
        self.schema = Schema.from_elements(self.meta.schema)
        if columns:
            self.schema.set_selected_columns(*columns)

    def close(self) -> None:
        """Close the file, or release the buffer (columns already decoded
        keep their device buffers)."""
        if self._io is not None:
            with self._io.lock:
                self._io.f.close()
        self._buf = memoryview(b"") if self._buf is not None else None

    def __enter__(self):
        return self

    def __exit__(self, exc_type, exc, tb):
        self.close()

    def row_group_count(self) -> int:
        return len(self.meta.row_groups)

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

    def chunk_blob(self, cm, path: str):
        """One chunk's bytes as ``(memoryview, start_offset)``: a view of
        an in-memory source, a range read of a file.  Thread-safe."""
        start = cm.data_page_offset
        if cm.dictionary_page_offset is not None:
            start = min(start, cm.dictionary_page_offset)
        size = cm.total_compressed_size
        if start < 0 or size < 0 or start + size > self._size:
            raise CorruptChunkError("column chunk overruns file",
                                    column=path, file=self.name)
        t0 = time.perf_counter()
        if self._io is None:
            blob = self._buf[start : start + size]
        else:
            with self._io.lock:
                self._io.f.seek(start)
                blob = memoryview(self._io.f.read(size))
            if len(blob) < size:
                raise CorruptChunkError(
                    f"column chunk short read: {len(blob)}/{size} bytes",
                    column=path, file=self.name)
        st = current_stats()
        if st is not None:
            st.read_s += time.perf_counter() - t0
            st.bytes_read += len(blob)
        return blob, start

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
        take too."""
        size = self._size
        if size < 12:
            return None
        try:
            if self._io is None:
                (flen,) = struct.unpack("<I", self._buf[size - 8 : size - 4])
                if flen <= 0 or size - 8 - flen < 4:
                    return None
                crc = zlib.crc32(self._buf[size - 8 - flen : size - 8])
            else:
                with self._io.lock:
                    f = self._io.f
                    f.seek(size - 8)
                    (flen,) = struct.unpack("<I", f.read(4))
                    if flen <= 0 or size - 8 - flen < 4:
                        return None
                    f.seek(size - 8 - flen)
                    crc = zlib.crc32(f.read(flen))
        except (OSError, ValueError, struct.error):
            return None
        return (crc, size, flen)
