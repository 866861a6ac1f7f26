"""FileWriter: the columnar write path for every physical type, flat or
in a LIST (one repeated level).

``write_columns`` takes whole columns (non-null values only: a bool
array for BOOLEAN, an integer or float array, ``(N, 3)`` u32 words for
INT96, ``(N, L)`` u8 rows for FIXED_LEN_BYTE_ARRAY, a
:class:`~tpuparquet_torch.cpu.plain.ByteArrayColumn` for binary leaves,
or for an int32, int64, float or double leaf a
:class:`~tpuparquet_torch.kernels.encode.DeviceValues` of its dtype,
whose statistics, dictionary intern and PLAIN, DELTA_BINARY_PACKED and
BYTE_STREAM_SPLIT pages compute on its device)
plus validity masks for optional columns, and for a LIST column its row
offsets and null-row and null-element masks, and writes one row group:
one column chunk per leaf, each a dictionary page when it is written
PLAIN and the dictionary pays (never for BOOLEAN, and not at all with
``allow_dict=False``), and one data page (V1, or V2 with
``data_page_v2=True``), UNCOMPRESSED, SNAPPY, GZIP, ZSTD or LZ4_RAW, with
statistics and page CRCs — the JAX package writer's policy for these
columns.

``column_encodings`` writes a column with another encoding the JAX
package's table allows for its type: RLE (BOOLEAN), DELTA_BINARY_PACKED,
DELTA_LENGTH_BYTE_ARRAY, DELTA_BYTE_ARRAY or BYTE_STREAM_SPLIT.

A row group's column chunks encode on a pool of ``encode_threads``
workers (default ``TPQ_WRITE_THREADS``, else the usable CPUs) when it
has more than one column and more than 65,536 values: each chunk renders
into a buffer of its own under a stats collector of its own, and the
calling thread appends the buffers in schema order, rebasing their
offsets, and merges the collectors, so the file and the counters are
those of the serial path.  With one worker or a small row group the
chunks write straight to the file one after another, and the whole
budget goes to the block-parallel split of a large GZIP or ZSTD page
(``compress.page_compress``); the pool keeps its pages whole, since its
workers already fill the budget.  A ``DeviceValues`` column's kernels
then launch from a pool thread, on the column's device.
"""

from __future__ import annotations

import contextlib
import io
import os
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch

from ..cpu.levels import list_levels
from ..cpu.plain import PHYSICAL_DTYPES, ByteArrayColumn
from ..format.footer import MAGIC, write_footer
from ..format.metadata import CompressionCodec, Encoding, FileMetaData, \
    RowGroup, Type
from ..format.schema import Schema
from ..kernels.encode import DeviceValues
from ..stats import current_stats, worker_stats
from .chunk import is_unsigned, write_chunk
from .pages import SUPPORTED_DATA_ENCODINGS, page_crc_default

__all__ = ["FileWriter"]

# a row group of at most this many values (level slots) encodes serially
_POOL_MIN_VALUES = 65536


def _write_threads() -> int:
    """Encode workers of a row group: ``TPQ_WRITE_THREADS`` (``1``: the
    serial path), else the usable CPUs."""
    v = os.environ.get("TPQ_WRITE_THREADS")
    if v is not None:
        try:
            return max(int(v), 1)
        except ValueError:
            pass  # a malformed override falls back to the default
    try:
        return len(os.sched_getaffinity(0)) or 1
    except (AttributeError, OSError):
        return os.cpu_count() or 1


def _on_device_of(column):
    """The current CUDA device set to a ``DeviceValues`` column's card for
    the block (a pool thread's current device is not the caller's)."""
    if isinstance(column, DeviceValues) and column.flat.device.type == "cuda":
        return torch.cuda.device(column.flat.device)
    return contextlib.nullcontext()


def _column_values(leaf, values):
    """A leaf's values in its physical representation; raises on a
    column of the wrong kind or out of the type's range."""
    if leaf.type == Type.BYTE_ARRAY:
        if not isinstance(values, ByteArrayColumn):
            raise TypeError(f"column {leaf.name!r}: expected a "
                            "ByteArrayColumn")
        return values
    if isinstance(values, DeviceValues):
        # device values stay on the device: checked by dtype only
        want = PHYSICAL_DTYPES.get(leaf.type) if leaf.type in (
            Type.INT32, Type.INT64, Type.FLOAT, Type.DOUBLE) else None
        if want is None or values.dtype != want:
            raise TypeError(f"{leaf.type.name} column cannot take "
                            f"DeviceValues[{values.dtype}]")
        return values
    vals = np.asarray(values)
    if leaf.type == Type.BOOLEAN:
        if vals.ndim != 1 or vals.dtype != np.bool_:
            raise TypeError(f"column {leaf.name!r}: expected a 1-D bool "
                            "array")
        return vals
    if leaf.type in (Type.INT96, Type.FIXED_LEN_BYTE_ARRAY):
        int96 = leaf.type == Type.INT96
        width, kind = (3, "u32") if int96 else (leaf.type_length, "u8")
        if vals.ndim != 2 or vals.shape[1] != width or vals.dtype != (
                np.dtype("<u4") if int96 else np.uint8):
            raise TypeError(f"column {leaf.name!r}: expected (N, {width}) "
                            f"{kind} rows")
        return vals
    dt = PHYSICAL_DTYPES[leaf.type]
    if vals.ndim != 1 or vals.dtype.kind not in ("f" if dt.kind == "f"
                                                 else "iu"):
        raise TypeError(f"column {leaf.name!r}: expected a 1-D "
                        f"{'float' if dt.kind == 'f' else 'integer'} array")
    if dt.kind == "f":
        return vals.astype(dt, copy=False)
    # an unsigned leaf takes its logical values or their signed storage
    udt = np.dtype(dt.str.replace("i", "u"))
    unsigned = is_unsigned(leaf.element)
    top = np.iinfo(udt if unsigned else dt).max
    if vals.size and (int(vals.min()) < np.iinfo(dt).min
                      or int(vals.max()) > top):
        raise ValueError(f"column {leaf.name!r}: values out of range for "
                         f"{leaf.type.name}")
    if unsigned and vals.dtype.kind == "u":
        return vals.astype(udt, copy=False).view(dt)
    return vals.astype(dt, copy=False)


class FileWriter:
    """Streaming Parquet writer over a binary file object.

    ``schema`` is a :class:`Schema` or a DSL string
    (``message m { required int64 a; optional int32 b; }``);
    ``column_encodings`` maps a leaf's dotted name to its value encoding
    (default PLAIN); ``allow_dict=False`` writes PLAIN columns without a
    dictionary; ``page_crc`` puts a CRC32 in every page header (None:
    on unless ``TPQ_PAGE_CRC=0``).  Use as a context manager or call
    :meth:`close`."""

    def __init__(self, f, schema, *,
                 codec: CompressionCodec = CompressionCodec.UNCOMPRESSED,
                 page_crc: bool | None = None, data_page_v2: bool = False,
                 column_encodings: dict | None = None,
                 allow_dict: bool = True,
                 encode_threads: int | None = None):
        self._f = f
        self._pos = 0
        self.schema = (schema if isinstance(schema, Schema)
                       else Schema.from_string(schema))
        tops = [leaf.path[0] for leaf in self.schema.leaves]
        for leaf in self.schema.leaves:
            if len(leaf.path) != 1 and not leaf.max_rep_level:
                raise NotImplementedError(
                    f"column {leaf.flat_name!r}: nested struct columns are "
                    "not supported by tpuparquet_torch")
            if leaf.max_rep_level and tops.count(leaf.path[0]) > 1:
                raise NotImplementedError(
                    f"column {leaf.flat_name!r}: repeated groups of several "
                    "leaves are not supported by tpuparquet_torch")
        self.column_encodings = {k: Encoding(v) for k, v in
                                 (column_encodings or {}).items()}
        for path, enc in self.column_encodings.items():
            leaf = self.schema.leaf(path)
            if leaf is None:
                raise ValueError(f"no such column {path!r}")
            if enc not in SUPPORTED_DATA_ENCODINGS[Type(leaf.type)]:
                raise ValueError(f"encoding {enc.name} not allowed for "
                                 f"column {path!r} ({leaf.type.name})")
        self.codec = CompressionCodec(codec)
        # page CRC32 in every PageHeader (None: TPQ_PAGE_CRC, on unless 0)
        self.page_crc = bool(page_crc_default() if page_crc is None
                             else page_crc)
        self.data_page_v2 = data_page_v2
        self.allow_dict = allow_dict
        self.encode_threads = (max(int(encode_threads), 1)
                               if encode_threads is not None else None)
        self.row_groups: list[RowGroup] = []
        self.total_rows = 0
        self._closed = False

    # position-tracking stream interface for the chunk layer
    def write(self, data) -> None:
        self._f.write(data)
        self._pos += len(data)

    def tell(self) -> int:
        return self._pos

    def write_columns(self, columns: dict, *, masks: dict | None = None,
                      offsets: dict | None = None,
                      element_masks: dict | None = None):
        """Write one row group.  ``columns`` maps leaf name -> the
        column's **non-null** values (in the representation the module
        docstring lists for the leaf's type); ``masks`` maps an optional
        leaf's name -> bool validity per row.

        A LIST column is keyed by its top-level field name: ``columns``
        holds its non-null elements, ``offsets`` the ``n_rows + 1`` slot
        ranges of its rows, ``masks`` its null rows (whose ranges must be
        empty) and ``element_masks`` its valid element slots; the levels
        are derived as the JAX writer derives them
        (:func:`~tpuparquet_torch.cpu.levels.list_levels`)."""
        if self._closed:
            raise ValueError("writer is closed")
        masks = masks or {}
        prepared = []
        n_rows = None
        for leaf in self.schema.leaves:
            rep = None
            if leaf.max_rep_level:
                key = leaf.path[0]
                if key not in columns:
                    raise ValueError(f"missing column {key!r}")
                if offsets is None or key not in offsets:
                    raise ValueError(f"repeated column {key!r} needs "
                                     "offsets= (row -> element ranges)")
                rep, dl, rows, n_vals = list_levels(
                    leaf, offsets[key], masks.get(key),
                    (element_masks or {}).get(key))
                vals = _column_values(leaf, columns[key])
                if len(vals) != n_vals:
                    raise ValueError(f"column {key!r}: {len(vals)} values vs "
                                     f"{n_vals} non-null elements")
            else:
                if leaf.name not in columns:
                    raise ValueError(f"missing column {leaf.name!r}")
                vals = _column_values(leaf, columns[leaf.name])
                mask = masks.get(leaf.name)
                if mask is not None:
                    if leaf.max_def_level == 0:
                        raise ValueError(
                            f"column {leaf.name!r} is required; a validity "
                            "mask is not allowed")
                    mask = np.asarray(mask, dtype=bool)
                    rows = mask.size
                    if int(mask.sum()) != len(vals):
                        raise ValueError(
                            f"column {leaf.name!r}: {len(vals)} values vs "
                            f"{int(mask.sum())} valid mask entries")
                    dl = mask.astype(np.int32) * leaf.max_def_level
                else:
                    rows = len(vals)
                    dl = np.full(rows, leaf.max_def_level, dtype=np.int32)
            if n_rows is None:
                n_rows = rows
            elif n_rows != rows:
                raise ValueError("column row counts differ")
            prepared.append((leaf, vals, rep, dl, dl.size - len(vals)))
        if self._pos == 0:
            self.write(MAGIC)

        def chunk(out, leaf, vals, rep, dl, nulls, workers):
            return write_chunk(
                out, leaf, vals, rep, dl, codec=self.codec,
                encoding=self.column_encodings.get(leaf.flat_name,
                                                   Encoding.PLAIN),
                page_crc=self.page_crc, null_count=nulls, num_rows=n_rows,
                data_page_v2=self.data_page_v2, allow_dict=self.allow_dict,
                pipeline_workers=workers)

        def render(job):
            # the chunk at position 0 of its own buffer, its counters in
            # a collector of its own (the active one is thread-local)
            buf = io.BytesIO()
            with worker_stats() as ws, _on_device_of(job[1]):
                cc = chunk(buf, *job, 1)
            return buf.getvalue(), cc, ws

        n_workers = (self.encode_threads if self.encode_threads is not None
                     else _write_threads())
        total_values = sum(len(job[3]) for job in prepared)
        if len(prepared) > 1 and n_workers > 1 \
                and total_values > _POOL_MIN_VALUES:
            sink = current_stats()
            chunks = []
            n_w = min(len(prepared), n_workers)
            with ThreadPoolExecutor(max_workers=n_w) as ex:
                # at most n_w + 1 chunks in flight (rendering, or rendered
                # and not yet appended), so a slow file does not hold
                # every column's bytes at once
                ahead = n_w + 1
                futs = {j: ex.submit(render, prepared[j])
                        for j in range(min(ahead, len(prepared)))}
                for i in range(len(prepared)):
                    blob, cc, ws = futs.pop(i).result()
                    base = self._pos
                    self.write(blob)
                    cc.file_offset += base
                    cm = cc.meta_data
                    cm.data_page_offset += base
                    if cm.dictionary_page_offset is not None:
                        cm.dictionary_page_offset += base
                    chunks.append(cc)
                    if sink is not None:
                        sink.merge_from(ws)
                    del blob
                    if i + ahead < len(prepared):
                        futs[i + ahead] = ex.submit(render,
                                                    prepared[i + ahead])
        else:
            chunks = [chunk(self, *job, n_workers) for job in prepared]
        total_bytes = sum(cc.meta_data.total_uncompressed_size
                          for cc in chunks)
        total_comp = sum(cc.meta_data.total_compressed_size for cc in chunks)
        self.row_groups.append(RowGroup(
            columns=chunks, total_byte_size=total_bytes,
            num_rows=n_rows or 0, total_compressed_size=total_comp,
            ordinal=len(self.row_groups)))
        self.total_rows += n_rows or 0

    def close(self) -> None:
        if self._closed:
            return
        if self._pos == 0:
            self.write(MAGIC)
        write_footer(self, FileMetaData(
            version=1,
            schema=self.schema.to_elements(),
            num_rows=self.total_rows,
            row_groups=self.row_groups,
            created_by="tpuparquet_torch",
        ))
        self._closed = True

    def __enter__(self):
        return self

    def __exit__(self, exc_type, exc, tb):
        if exc_type is None:
            self.close()
