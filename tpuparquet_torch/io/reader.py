"""FileReader subset: footer, schema and column-chunk byte ranges.

Opens a path, a bytes-like object or a file object (read whole, from
its start); the file's bytes are held in memory and every chunk is a
zero-copy view of them.  Column names after the source restrict reading
to those dotted paths and their subtrees, as the reference's
``FileReader(source, *columns)``; ``verify_crc`` gates the page CRC
check as there (None: the ``TPQ_PAGE_CRC_VERIFY`` default, on unless
``0``).  Decoding is the device path's job (``kernels/device.py``).
"""

from __future__ import annotations

import io
import os

from ..errors import CorruptChunkError
from ..format.footer import read_file_metadata
from ..format.schema import Schema

__all__ = ["FileReader"]


class FileReader:
    """Parquet file metadata + chunk access over an in-memory buffer."""

    def __init__(self, source, *columns: str,
                 verify_crc: bool | None = None):
        self.verify_crc = verify_crc
        if isinstance(source, (str, os.PathLike)):
            self.name = os.fspath(source)
            with open(source, "rb") as f:
                buf = f.read()
        elif hasattr(source, "read"):
            self.name = getattr(source, "name", None)
            source.seek(0)
            buf = source.read()
        else:
            self.name = None
            buf = bytes(source)
        self._buf = memoryview(buf)
        self.meta = read_file_metadata(io.BytesIO(buf))
        self.schema = Schema.from_elements(self.meta.schema)
        if columns:
            self.schema.set_selected_columns(*columns)

    def close(self) -> None:
        """Release the file's bytes (columns already decoded keep their
        device buffers)."""
        self._buf = memoryview(b"")

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
        """One chunk's bytes as ``(memoryview, start_offset)``."""
        start = cm.data_page_offset
        if cm.dictionary_page_offset is not None:
            start = min(start, cm.dictionary_page_offset)
        if start < 0 or start + cm.total_compressed_size > len(self._buf):
            raise CorruptChunkError("column chunk overruns file",
                                    column=path, file=self.name)
        return self._buf[start : start + cm.total_compressed_size], start
