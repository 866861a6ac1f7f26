"""FileWriter: the columnar write path for every physical type, flat,
in nested structs, or in one repeated level (a LIST of values, a LIST of
structs, a MAP).

``write_columns`` takes whole columns (non-null values only: a bool
array for BOOLEAN, an integer or float array, ``(N, 3)`` u32 words for
INT96, ``(N, L)`` u8 rows for FIXED_LEN_BYTE_ARRAY, a
:class:`~tpuparquet_torch.cpu.plain.ByteArrayColumn` for binary leaves,
or for an int32, int64, float or double leaf a
:class:`~tpuparquet_torch.kernels.encode.DeviceValues` of its dtype,
whose statistics, dictionary intern and PLAIN, DELTA_BINARY_PACKED and
BYTE_STREAM_SPLIT pages compute on its device; or, for any leaf, a
Python list of its values, coerced one by one as the JAX writer does)
plus validity masks for optional columns (and for the struct groups
above a nested leaf), and for a repeated column its row offsets and
null-row, null-element and null-element-group masks, and writes one row
group:
one column chunk per leaf, each a dictionary page when it is written
PLAIN and the dictionary pays (never for BOOLEAN, and not at all with
``allow_dict=False``), and one data page (V1, or V2 with
``data_page_v2=True``), UNCOMPRESSED, SNAPPY, GZIP, ZSTD or LZ4_RAW, with
statistics and page CRCs — the JAX package writer's policy for these
columns.

As the JAX writer's, and with its environment defaults: ``page_rows``
(``TPQ_PAGE_ROWS``, default 0: one page) splits a flat column's chunk
into data pages of that many level slots, each with its own statistics;
``page_index`` (``TPQ_PAGE_INDEX``, on unless ``0``; never without
``write_stats``) writes each chunk's ``ColumnIndex`` and ``OffsetIndex``,
and ``bloom_columns`` (``TPQ_BLOOM_COLUMNS``, comma-separated) a
split-block bloom filter of the named columns' chunks; both go between
the last row group and the footer (the blooms, then every column index,
then every offset index), their offsets recorded in the footer.
``salvage_hint`` (``TPQ_SALVAGE_HINT``, on unless ``0``) frames the
schema and codec right after the head magic when the schema has leaves
(``format/recover.py`` ``encode_salvage_hint``), so a torn file
salvages itself; every page, index and bloom offset lies behind it.
``version``, ``created_by`` (default ``"tpuparquet_torch"``) and
``kv_metadata`` (key-value pairs, written sorted by key) go into the
footer.  With the same ``created_by`` the two writers' default files
are equal byte for byte.

The row path takes records instead: :meth:`FileWriter.add_data`
shreds one (a dict of the top-level fields, groups as dicts, repeated
fields as lists) into the leaves' buffers (``io/store.py``), and
:meth:`FileWriter.flush_row_group` writes the buffered rows as one row
group, on its own or once their approximate size reaches
``max_row_group_size``, and at :meth:`FileWriter.close`.  The two paths
write the same chunks for the same values; a row group is one or the
other.

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
from ..format.dsl import SchemaDefinition
from ..format.footer import MAGIC, write_footer
from ..format.metadata import CompressionCodec, ConvertedType, Encoding, \
    FileMetaData, KeyValue, RowGroup, Type
from ..format.recover import encode_salvage_hint
from ..format.schema import Schema
from ..kernels.encode import DeviceValues
from ..obs import trace as _trace
from ..stats import current_stats, worker_stats
from .chunk import write_chunk
from .pages import SUPPORTED_DATA_ENCODINGS, page_crc_default
from .store import attach_stores, shred_record
from .values import handler_for, is_unsigned

__all__ = ["FileWriter"]

# a row group of at most this many values (level slots) encodes serially
_POOL_MIN_VALUES = 65536


def _write_threads() -> int:
    """Encode workers of a row group: the calling thread's tenant share
    under an active serve arbiter (one share bounds all of a tenant's
    workers), else ``TPQ_WRITE_THREADS`` (``1``: the serial path), else
    the usable CPUs."""
    from ..serve import arbiter as _arbiter

    share = _arbiter.write_budget()
    if share is not None:
        return share
    _arbiter.warn_if_oversubscribed()
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
    column of the wrong kind or out of the type's range.  A Python list
    is coerced value by value (str to UTF-8 bytes, 12-byte INT96, ...),
    as the JAX writer takes one."""
    if isinstance(values, list):
        h = handler_for(leaf.element)
        values = h.finalize([h.coerce_one(v) for v in values])
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


def _is_element_struct_leaf(leaf) -> bool:
    """Does a leaf of one repeated level sit inside an element group (the
    tuple-of-per-leaf-arrays contract, even with one leaf)?  False for
    the single-value list shapes: a bare repeated leaf, the 2-level
    legacy list, the canonical LIST of a primitive."""
    if leaf.is_repeated:
        return False  # bare repeated leaf, 2-level legacy element
    parent = leaf.parent
    if parent is not None and parent.is_repeated:
        gp = parent.parent
        if gp is not None and len(parent.children) == 1:
            el = gp.element
            lt = getattr(el, "logicalType", None)
            if getattr(el, "converted_type", None) == ConvertedType.LIST \
                    or (lt is not None and lt.set_member()[0] == "LIST"):
                return False  # the canonical LIST's single element
        return True  # a repeated struct group (MAP key_value too)
    return True  # an element group below the repeated node


def _prepare_struct(leaf, values, masks: dict):
    """A nested non-repeated leaf: ``(values, def levels, n_rows)``.

    Definition levels are derived outermost ancestor first: a row absent
    at group ``a`` stays at ``a``'s parent's level, as the JAX writer
    records a null group.  ``masks`` are keyed by dotted prefix (``"a"``,
    ``"a.b"``, the leaf's flat name); ``values`` holds only the fully
    present rows' values."""
    vals = _column_values(leaf, values)
    chain = []
    node = leaf
    while node is not None and node.parent is not None:
        chain.append(node)
        node = node.parent
    chain.reverse()
    prefixes = [".".join(n.name for n in chain[: i + 1])
                for i in range(len(chain))]
    # the first mask on the path knows the row count; an all-present
    # column falls back to its value count
    n_rows = None
    for pref in prefixes:
        m = masks.get(pref)
        if m is not None:
            n_rows = len(np.asarray(m))
            break
    if n_rows is None:
        n_rows = len(vals)
    present = np.ones(n_rows, dtype=bool)
    dl = np.zeros(n_rows, dtype=np.int32)
    for node, pref in zip(chain, prefixes):
        m = masks.get(pref)
        if node.is_required:
            if m is not None:
                raise ValueError(
                    f"{pref!r} is required; a validity mask is not "
                    "allowed")
            continue
        if m is not None:
            m = np.asarray(m, dtype=bool)
            if m.size != n_rows:
                raise ValueError(
                    f"mask {pref!r}: {m.size} entries vs {n_rows} rows")
            present &= m
        dl[present] = node.max_def_level
    nn = int(present.sum())
    if len(vals) != nn:
        raise ValueError(
            f"column {leaf.flat_name!r}: {len(vals)} values vs {nn} "
            "present rows (pass only non-null values)")
    return vals, dl, n_rows


class FileWriter:
    """Streaming Parquet writer over a binary file object.

    ``schema`` is a :class:`Schema`, a ``SchemaDefinition`` or a DSL string
    (``message m { required int64 a; optional int32 b; }``);
    ``column_encodings`` maps a leaf's dotted name to its value encoding
    (default PLAIN); ``allow_dict=False`` writes PLAIN columns without a
    dictionary; ``page_crc`` puts a CRC32 in every page header (None:
    on unless ``TPQ_PAGE_CRC=0``); ``write_stats=False`` writes no
    statistics; ``page_index``, ``bloom_columns``, ``page_rows`` and
    ``salvage_hint`` as the module docstring says (None: their
    environment defaults); ``max_row_group_size`` bounds the row path's
    row groups in approximate bytes (None: one row group a
    :meth:`flush_row_group`); ``version``, ``created_by`` and
    ``kv_metadata`` fill the footer.  Use as a context manager or call
    :meth:`close`."""

    def __init__(self, f, schema, *,
                 version: int = 1,
                 created_by: str = "tpuparquet_torch",
                 codec: CompressionCodec = CompressionCodec.UNCOMPRESSED,
                 kv_metadata: dict | None = None,
                 page_crc: bool | None = None, data_page_v2: bool = False,
                 column_encodings: dict | None = None,
                 allow_dict: bool = True,
                 write_stats: bool = True,
                 page_index: bool | None = None,
                 bloom_columns=None,
                 page_rows: int | None = None,
                 salvage_hint: bool | None = None,
                 encode_threads: int | None = None,
                 max_row_group_size: int | None = None):
        self._f = f
        self._pos = 0
        self.version = version
        self.created_by = created_by
        self.kv_metadata = dict(kv_metadata or {})
        if isinstance(schema, Schema):
            self.schema = schema
        elif isinstance(schema, SchemaDefinition):
            self.schema = Schema.from_definition(schema)
        else:
            self.schema = Schema.from_string(schema)
        attach_stores(self.schema)
        self.max_row_group_size = max_row_group_size
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
        self.write_stats = write_stats
        if page_index is None:
            page_index = os.environ.get("TPQ_PAGE_INDEX", "1") != "0"
        # a page index summarizes statistics: none without them
        self.page_index = bool(page_index) and write_stats
        if bloom_columns is None:
            bloom_columns = os.environ.get("TPQ_BLOOM_COLUMNS", "")
        if isinstance(bloom_columns, str):
            bloom_columns = bloom_columns.split(",")
        self.bloom_columns = {c.strip() for c in bloom_columns if c.strip()}
        for path in sorted(self.bloom_columns):
            if self.schema.leaf(path) is None:
                raise ValueError(
                    f"bloom_columns names no such column {path!r}")
        if page_rows is None:
            try:
                page_rows = int(os.environ.get("TPQ_PAGE_ROWS", "0"))
            except ValueError:
                page_rows = 0
        self.page_rows = max(int(page_rows), 0)
        if salvage_hint is None:
            salvage_hint = os.environ.get("TPQ_SALVAGE_HINT", "1") != "0"
        self.salvage_hint = bool(salvage_hint)
        self.encode_threads = (max(int(encode_threads), 1)
                               if encode_threads is not None else None)
        self.row_groups: list[RowGroup] = []
        self.total_rows = 0
        self._buffered_rows = 0
        self._approx_size = 0
        self._closed = False

    # position-tracking stream interface for the chunk layer
    def write(self, data) -> None:
        self._f.write(data)
        self._pos += len(data)

    def tell(self) -> int:
        return self._pos

    def write_columns(self, columns: dict, *, masks: dict | None = None,
                      offsets: dict | None = None,
                      element_masks: dict | None = None,
                      kv_metadata: dict | None = None,
                      kv_per_column: dict | None = None):
        """Write one row group.  ``columns`` maps leaf name -> the
        column's **non-null** values (in the representation the module
        docstring lists for the leaf's type); ``masks`` maps an optional
        leaf's name -> bool validity per row.

        A LIST column is keyed by its top-level field name: ``columns``
        holds its non-null elements, ``offsets`` the ``n_rows + 1`` slot
        ranges of its rows, ``masks`` its null rows (whose ranges must be
        empty) and ``element_masks`` its valid element slots; the levels
        are derived as the JAX writer derives them
        (:func:`~tpuparquet_torch.cpu.levels.list_levels`).

        Nested struct leaves (non-repeated groups on the path) are keyed
        by the dotted flat name (``"a.b"``) and take only the values of
        fully present rows; ``masks`` entries on the group prefixes
        (``"a"``) mark the rows where that whole group is null.

        Multi-leaf repeated groups (MAP ``key_value``, LIST of struct):
        ``columns[f]`` is a tuple of per-leaf arrays in schema leaf order
        (for a MAP: ``(keys, values)``) sharing ``offsets[f]``;
        ``element_masks[f]`` is then a dict keyed by leaf flat name
        (e.g. ``"m.key_value.value"``), where the element group's flat
        name marks null elements.

        ``kv_metadata`` goes into every chunk's metadata and
        ``kv_per_column`` (leaf name -> dict) into one chunk's, as
        :meth:`flush_row_group` puts them."""
        if self._closed:
            raise ValueError("writer is closed")
        if self._buffered_rows:
            raise ValueError("cannot mix write_columns with buffered rows")
        masks = masks or {}
        prepared = []
        n_rows = None
        rep_leaf_counts: dict[str, int] = {}
        rep_leaf_index: dict[str, int] = {}
        for leaf in self.schema.leaves:
            if leaf.max_rep_level:
                top = leaf.path[0]
                rep_leaf_counts[top] = rep_leaf_counts.get(top, 0) + 1
        for leaf in self.schema.leaves:
            rep = None
            if leaf.max_rep_level:
                key = leaf.path[0]
                if key not in columns:
                    raise ValueError(f"missing column {key!r}")
                if offsets is None or key not in offsets:
                    raise ValueError(f"repeated column {key!r} needs "
                                     "offsets= (row -> element ranges)")
                k_leaves = rep_leaf_counts[key]
                em = (element_masks or {}).get(key)
                gm = None
                if k_leaves > 1 or _is_element_struct_leaf(leaf):
                    # one tuple of per-leaf arrays in schema leaf order,
                    # sharing the offsets; element masks keyed by leaf
                    col = columns[key]
                    if not isinstance(col, (tuple, list)) \
                            or len(col) != k_leaves:
                        raise ValueError(
                            f"repeated group {key!r} has {k_leaves} "
                            "leaves; pass a tuple of per-leaf arrays "
                            "(schema leaf order)")
                    i = rep_leaf_index.get(key, 0)
                    rep_leaf_index[key] = i + 1
                    leaf_vals = col[i]
                    if isinstance(em, dict):
                        # the element group's flat name marks null
                        # elements (one level below null fields)
                        gm = em.get(leaf.parent.flat_name)
                        em = em.get(leaf.flat_name)
                    elif em is not None:
                        raise ValueError(
                            f"element_masks[{key!r}] must be a dict keyed "
                            "by leaf flat name for a multi-leaf group")
                else:
                    leaf_vals = columns[key]
                rep, dl, rows, n_vals = list_levels(
                    leaf, offsets[key], masks.get(key), em, group_null=gm)
                vals = _column_values(leaf, leaf_vals)
                if len(vals) != n_vals:
                    raise ValueError(f"column {key!r}: {len(vals)} values vs "
                                     f"{n_vals} non-null elements")
            elif len(leaf.path) != 1:
                # a nested struct leaf: keyed by its dotted flat name,
                # null ancestors marked by masks on the group prefixes
                if leaf.flat_name not in columns:
                    raise ValueError(f"missing column {leaf.flat_name!r}")
                vals, dl, rows = _prepare_struct(
                    leaf, columns[leaf.flat_name], masks)
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
        self._flush_prepared(prepared, n_rows or 0, kv_metadata or {},
                             kv_per_column or {})

    # -- the row path ------------------------------------------------------

    def add_data(self, row: dict) -> None:
        """Shred one record (a dict of the top-level fields; groups as
        dicts, repeated fields as lists) into the leaves' buffers; the
        buffered rows flush as a row group once their approximate size
        reaches ``max_row_group_size``."""
        if self._closed:
            raise ValueError("writer is closed")
        shred_record(self.schema, row)
        self._buffered_rows += 1
        self._approx_size += _approx_record_size(row)
        if self.max_row_group_size is not None \
                and self._approx_size >= self.max_row_group_size:
            self.flush_row_group()

    def current_row_group_size(self) -> int:
        """The approximate bytes of the buffered rows."""
        return self._approx_size

    def current_file_size(self) -> int:
        return self._pos

    def flush_row_group(self, *, kv_metadata: dict | None = None,
                        kv_per_column: dict | None = None) -> None:
        """Write the buffered rows as one row group (nothing when none is
        buffered).  ``kv_metadata`` goes into every chunk's metadata,
        ``kv_per_column`` (leaf name -> dict) into one chunk's, over
        it."""
        if self._buffered_rows == 0:
            return
        prepared = []
        for leaf in self.schema.leaves:
            store = leaf.store
            rep, dl = store.num_records_levels()
            prepared.append((leaf, store.handler.finalize(store.values),
                             rep if leaf.max_rep_level else None, dl,
                             int((dl != leaf.max_def_level).sum())))
        n_rows = self._buffered_rows
        # the buffers reset before the write, so a failed write does not
        # write them twice
        for leaf in self.schema.leaves:
            leaf.store.reset()
        self._buffered_rows = 0
        self._approx_size = 0
        self._flush_prepared(prepared, n_rows, kv_metadata or {},
                             kv_per_column or {})

    def _flush_prepared(self, prepared, n_rows: int, kv_global: dict,
                        kv_per_column: dict) -> None:
        """Write one row group of ``(leaf, values, rep, dl, nulls)``
        columns, in schema order."""
        if self._pos == 0:
            self._write_head()

        def chunk(out, leaf, vals, rep, dl, nulls, workers):
            kv = dict(kv_global)
            kv.update(kv_per_column.get(leaf.flat_name, {}))
            return write_chunk(
                out, leaf, vals, rep, dl, codec=self.codec,
                encoding=self.column_encodings.get(leaf.flat_name,
                                                   Encoding.PLAIN),
                page_crc=self.page_crc, null_count=nulls, num_rows=n_rows,
                data_page_v2=self.data_page_v2, allow_dict=self.allow_dict,
                write_stats=self.write_stats, page_index=self.page_index,
                bloom=leaf.flat_name in self.bloom_columns,
                page_rows=self.page_rows, pipeline_workers=workers,
                kv_metadata=kv)

        # pool workers re-enter the writing thread's trace context
        tctx = _trace.current_ctx()

        def render(job):
            # the chunk at position 0 of its own buffer, its counters in
            # a collector of its own (the active one is thread-local)
            buf = io.BytesIO()
            with _trace.adopt(tctx), worker_stats() as ws, \
                    _on_device_of(job[1]):
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
                    pi = getattr(cc, "_page_index", None)
                    if pi is not None:
                        # page locations were taken in the chunk's own
                        # buffer
                        for loc in pi[1].page_locations:
                            loc.offset += base
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
            num_rows=n_rows, total_compressed_size=total_comp,
            ordinal=len(self.row_groups)))
        self.total_rows += n_rows

    def _write_head(self) -> None:
        """The leading magic, then the salvage hint frame when it is on
        and the schema has leaves."""
        self.write(MAGIC)
        if self.salvage_hint and self.schema.leaves:
            self.write(encode_salvage_hint(self.schema, self.codec,
                                           created_by=self.created_by))

    def _write_indexes(self) -> None:
        """The bloom filters, then every column index, then every offset
        index (row groups in order, columns in schema order), between the
        last row group and the footer; their offsets and lengths go into
        the chunks' metadata."""
        for rg in self.row_groups:
            for cc in rg.columns:
                b = getattr(cc, "_bloom", None)
                if b is not None:
                    blob = b.to_bytes()
                    cc.meta_data.bloom_filter_offset = self._pos
                    cc.meta_data.bloom_filter_length = len(blob)
                    self.write(blob)
        for which in (0, 1):
            for rg in self.row_groups:
                for cc in rg.columns:
                    pi = getattr(cc, "_page_index", None)
                    if pi is None:
                        continue
                    blob = pi[which].to_bytes()
                    if which == 0:
                        cc.column_index_offset = self._pos
                        cc.column_index_length = len(blob)
                    else:
                        cc.offset_index_offset = self._pos
                        cc.offset_index_length = len(blob)
                    self.write(blob)

    def close(self) -> None:
        if self._closed:
            return
        self.flush_row_group()
        if self._pos == 0:
            self._write_head()  # an empty file is framed too
        self._write_indexes()
        kv = [KeyValue(key=k, value=v)
              for k, v in sorted(self.kv_metadata.items())] or None
        write_footer(self, FileMetaData(
            version=self.version,
            schema=self.schema.to_elements(),
            num_rows=self.total_rows,
            row_groups=self.row_groups,
            key_value_metadata=kv,
            created_by=self.created_by,
        ))
        self._closed = True

    def __enter__(self):
        return self

    def __exit__(self, exc_type, exc, tb):
        if exc_type is None:
            self.close()


def _approx_record_size(row) -> int:
    """A record's size for ``max_row_group_size``: in a dict a string or
    bytes value counts its length and 8, a nested dict or list its
    members' and 8, any other value 16; in a list each item its own
    size (a string or bytes item its length, any other scalar 8)."""
    if isinstance(row, dict):
        t = 0
        for v in row.values():
            c = v.__class__
            if c is str or c is bytes:
                t += len(v) + 8
            elif c is dict or c is list or c is tuple:
                t += _approx_record_size(v) + 8
            else:
                t += 16
        return t
    if isinstance(row, (list, tuple)):
        return sum(_approx_record_size(v) for v in row)
    if isinstance(row, (bytes, bytearray, str)):
        return len(row)
    return 8
