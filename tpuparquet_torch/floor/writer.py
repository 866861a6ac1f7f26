"""floor.Writer: Python objects (dataclasses) written to Parquet.

A thin wrapper over :class:`~tpuparquet_torch.io.writer.FileWriter`: an
object's ``marshal_parquet()`` supplies its row when it has one, else
dataclass reflection (``floor/reflect.py``) does.
"""

from __future__ import annotations

import dataclasses

from ..io.writer import FileWriter
from .reflect import objects_to_columns, schema_of, to_row

__all__ = ["Writer", "new_file_writer"]


class Writer:
    """Wraps a low-level :class:`FileWriter`."""

    def __init__(self, fw: FileWriter, _owned_file=None):
        self._fw = fw
        self._owned_file = _owned_file

    @property
    def file_writer(self) -> FileWriter:
        return self._fw

    def write(self, obj) -> None:
        """Write one object as a row.

        Marshalling order: an object with a
        ``marshal_parquet() -> dict`` method supplies the low-level row
        itself; otherwise dataclass/mapping reflection against the
        schema converts field values (strings, date/time/timestamp,
        UUID, LIST/MAP conventions).
        """
        m = getattr(obj, "marshal_parquet", None)
        if callable(m):
            row = m()
        else:
            row = to_row(obj, self._fw.schema)
        self._fw.add_data(row)

    def write_many(self, objs) -> None:
        for o in objs:
            self.write(o)

    def write_columns(self, objs, **flush_kw) -> None:
        """Bulk columnar write of objects: one row group per call, same
        decoded contents as :meth:`write_many` but without per-row dict
        building and shredding.  Flat fields, nested-dataclass STRUCT
        fields, dict MAP fields (primitive keys/values), and
        list-of-primitive fields (``list[int]``, ``list[str]``, ...)
        are supported; objects with a ``marshal_parquet`` hook, lists
        of structs, and maps with struct values need the row path
        (``write``/``write_many``)."""
        objs = list(objs)
        if not objs:
            return  # match write_many([]): no empty row group
        for o in objs:
            if callable(getattr(o, "marshal_parquet", None)):
                # the hook supplies custom rows that reflection would
                # silently diverge from — refuse loudly
                raise TypeError(
                    f"{type(o).__name__} defines marshal_parquet; the "
                    "columnar path reflects raw attributes — use "
                    "write/write_many")
        cols, masks, offs, emasks = objects_to_columns(
            objs, self._fw.schema)
        self._fw.write_columns(
            cols, masks=masks or None, offsets=offs or None,
            element_masks=emasks or None, **flush_kw)

    def flush_row_group(self, **kw) -> None:
        self._fw.flush_row_group(**kw)

    def close(self) -> None:
        try:
            self._fw.close()
        finally:
            if self._owned_file is not None:
                self._owned_file.close()
                self._owned_file = None

    def __enter__(self):
        return self

    def __exit__(self, exc_type, exc, tb):
        self.close()


def new_file_writer(path, schema=None, *, cls=None, **options) -> Writer:
    """Open ``path`` for object writing.

    ``schema`` may be any form :class:`FileWriter` accepts; or pass
    ``cls`` (a dataclass) to derive the schema via :func:`schema_of`.
    """
    if schema is None:
        if cls is None or not dataclasses.is_dataclass(cls):
            raise TypeError("new_file_writer needs a schema or a "
                            "dataclass cls to derive one from")
        schema = schema_of(cls)
    if isinstance(path, str):
        f = open(path, "wb")
        try:
            return Writer(FileWriter(f, schema, **options), _owned_file=f)
        except BaseException:
            f.close()
            raise
    return Writer(FileWriter(path, schema, **options))
