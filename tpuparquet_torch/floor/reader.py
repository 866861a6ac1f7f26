"""floor.Reader: Parquet rows read back into Python objects.

Iterates a :class:`~tpuparquet_torch.io.reader.FileReader`'s rows (the
row API) and fills dataclass instances, through an
``unmarshal_parquet(row)`` hook when the target has one;
:meth:`Reader.read_columns` builds a row group's objects from its
columns, decoded on the host.
"""

from __future__ import annotations

from ..io.reader import FileReader
from .reflect import decode_row, from_row

__all__ = ["Reader", "new_file_reader"]


class Reader:
    """Typed row iteration over a low-level :class:`FileReader`."""

    def __init__(self, fr: FileReader, cls=None):
        self._fr = fr
        self._cls = cls
        self._row = None

    @property
    def file_reader(self) -> FileReader:
        return self._fr

    def next(self) -> bool:
        """Advance to the next row; False at end of file."""
        try:
            self._row = self._fr.next_row()
            return True
        except EOFError:
            self._row = None
            return False

    def scan(self, target=None):
        """Deserialize the current row.

        * ``target`` with an ``unmarshal_parquet(row)`` method: the hook
          receives the raw row, returns target.
        * ``target`` a dataclass type (or the reader's bound ``cls``):
          returns a new instance via reflection.
        * no target: returns a logical-type-decoded plain dict.
        """
        if self._row is None:
            raise RuntimeError("scan before next(), or past end of file")
        if (target is not None and not isinstance(target, type)
                and callable(getattr(target, "unmarshal_parquet", None))):
            target.unmarshal_parquet(self._row)
            return target
        cls = target or self._cls
        if cls is None:
            return decode_row(self._row, self._fr.schema)
        return from_row(self._row, cls, self._fr.schema)

    def read_columns(self, rg_index: int, cls=None) -> list:
        """Bulk-materialize one row group's objects: columnar decode +
        per-leaf conversion, no per-row record assembly.  Flat, STRUCT
        (nested dataclass), MAP (dict), and list-of-primitive fields;
        same objects as iterating that row group."""
        from .reflect import objects_from_columns

        cls = cls or self._cls
        if cls is None:
            raise TypeError("read_columns needs a dataclass (bind cls "
                            "or pass one)")
        return objects_from_columns(
            self._fr.read_row_group_arrays(rg_index), cls,
            self._fr.schema,
            n_rows=self._fr.meta.row_groups[rg_index].num_rows)

    def __iter__(self):
        while self.next():
            yield self.scan()

    def close(self) -> None:
        self._fr.close()

    def __enter__(self):
        return self

    def __exit__(self, exc_type, exc, tb):
        self.close()


def new_file_reader(path, cls=None, *columns: str) -> Reader:
    """Open ``path`` for object reading."""
    return Reader(FileReader(path, *columns), cls=cls)
