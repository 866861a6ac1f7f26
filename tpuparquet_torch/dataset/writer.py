"""DatasetWriter: hive-partitioned multi-file writes with an atomic
dataset commit.

Rows arrive as row-aligned column arrays, the partition columns among
them; the writer routes them by partition value into one streaming
:class:`~tpuparquet_torch.io.writer.FileWriter` file a partition under
``_tmp/``, rolls a partition to a fresh file once it crosses the
``TPQ_DATASET_TARGET_MB`` size target, and publishes everything in
:meth:`DatasetWriter.commit` through the manifest-journal protocol
(``dataset/manifest.py``):

1. each open file is *staged*: footer and fsync, then renamed within
   ``_tmp/`` to its content address ``part-<sha1>.parquet`` (a staged
   name asserts complete, durable content);
2. the journal (``_commit.json``) is written atomically, naming every
   staged file and its partition path;
3. each staged file moves into its ``key=value`` directory (fault site
   ``dataset.file.promote``), idempotently: a file whose final path
   exists was promoted by an earlier attempt;
4. the new manifest snapshot is written atomically (the previous
   snapshot's files and the new ones): this rename is the commit point;
5. the journal is cleared and old snapshots pruned.

A kill before step 2 leaves the previous snapshot and orphaned staging
files (swept to quarantine, or reused bit for bit by a re-run: content
addressing makes staging idempotent); a kill after it leaves a journal
from which ``DatasetWriter(root, ..., resume_from=root)`` finishes the
commit without the caller supplying the data again.  Readers resolve
only through manifests, so no state in between is ever visible.

One encode budget (``io/writer.py`` ``_write_threads``: the serve
arbiter's share when one is bound, else ``TPQ_WRITE_THREADS``, else the
usable CPUs) is split across the partitions one ``write_columns`` call
touches: ``k`` partition files encode at once on an outer pool, each
inner writer at ``max(1, W // k)`` encode threads.
"""

from __future__ import annotations

import copy
import hashlib
import itertools
import os

import numpy as np

from ..faults import fault_point
from ..format.dsl import SchemaDefinition, parse_schema_definition
from ..io.writer import FileWriter, _write_threads
from . import manifest as mf

__all__ = ["DatasetWriter", "target_bytes_default"]

# the partials' sequence numbers, one counter for the process: two
# writers on one root never open the same ``.partial.<pid>.<seq>``
_partial_seq = itertools.count(1)


def target_bytes_default() -> int:
    """A partition file's rolling size target (``TPQ_DATASET_TARGET_MB``,
    default 64 MiB): a partition past it rolls to a fresh file at the
    next write boundary."""
    try:
        v = float(os.environ.get("TPQ_DATASET_TARGET_MB", ""))
    except ValueError:
        return 64 * 1024 * 1024
    return max(int(v * 1024 * 1024), 1)


class _HashingTee:
    """A file object that feeds every write into an incremental SHA-1:
    the content address is known when the stream closes, without reading
    the staged bytes again."""

    __slots__ = ("_fh", "sha1")

    def __init__(self, fh):
        self._fh = fh
        self.sha1 = hashlib.sha1()

    def write(self, data):
        self.sha1.update(data)
        return self._fh.write(data)

    def flush(self):
        self._fh.flush()

    def fileno(self):
        return self._fh.fileno()


class _OpenPart:
    """One partition file in flight: its writer, hashing tee and
    routing.  The raw handle lives in the owning writer's ``_handles``,
    which :meth:`DatasetWriter.close` and :meth:`DatasetWriter.abort`
    release whole."""

    __slots__ = ("key", "partition", "partial", "tee", "writer", "rows")

    def __init__(self, key, partition, partial, tee, writer):
        self.key = key
        self.partition = partition
        self.partial = partial
        self.tee = tee
        self.writer = writer
        self.rows = 0


def _part_sort_key(key: tuple):
    """The partitions' order, for keys of mixed types (None first within
    a column)."""
    return tuple((v is None, str(v)) for v in key)


def _py_key(v):
    """A partition value as the manifest holds it: a Python scalar, text
    for bytes, None for the hive null partition."""
    if v is None:
        return None
    if isinstance(v, np.generic):
        return v.item()
    if isinstance(v, bytes):
        return v.decode("utf-8")
    return v


class DatasetWriter:
    """Write a hive-partitioned dataset with atomic snapshot commits.

    ``schema`` is the whole row schema (a DSL string or
    :class:`SchemaDefinition`), the ``partition_by`` columns included;
    data files are written without them (their values live in the
    directory names and the manifest).  Partition columns are top-level
    primitive leaves; the data columns are flat leaves.

    ``resume_from`` (the dataset root itself) takes up a crashed commit:
    a pending journal's files fold into this writer's commit, and data
    supplied again dedups against staged or promoted content by its
    address, so the resumed dataset equals an uninterrupted write byte
    for byte.  ``step_hook(label)`` is called before each protocol
    action (``stage``, ``journal``, each ``promote``, ``manifest``,
    ``clean``); ``writer_options`` go to every :class:`FileWriter`.

    As a context manager, a clean exit commits and an exception aborts
    (partials removed, staged files left for the orphan sweep).
    """

    def __init__(self, root, schema, partition_by, *,
                 target_mb=None, resume_from=None, manifest_keep=None,
                 step_hook=None, **writer_options):
        _, root_path = mf.split_root(root)
        self.root = root
        self.root_path = root_path
        if isinstance(partition_by, str):
            partition_by = (partition_by,)
        self.partition_by = tuple(partition_by)
        if isinstance(schema, str):
            schema = parse_schema_definition(schema)
        if not isinstance(schema, SchemaDefinition):
            raise TypeError(
                "schema must be a DSL string or SchemaDefinition, "
                f"not {type(schema).__name__}")
        self.schema = schema
        self._data_schema = self._split_schema(schema)
        self._target = int(target_mb * 1024 * 1024) \
            if target_mb is not None else target_bytes_default()
        self._keep = manifest_keep
        self._step_hook = step_hook
        self._writer_options = dict(writer_options)
        self._parts: dict = {}
        self._handles: dict = {}
        self._staged: list = []
        self._closed = False
        os.makedirs(os.path.join(root_path, mf.TMP_DIR), exist_ok=True)
        self._journal = None
        if resume_from:
            if isinstance(resume_from, str):
                _, resume_path = mf.split_root(resume_from)
                if os.path.abspath(resume_path) != \
                        os.path.abspath(root_path):
                    raise ValueError(
                        f"resume_from={resume_from!r} does not name "
                        f"this dataset root {root!r}")
            self._journal = mf.load_journal(root_path)

    # -- schema routing ---------------------------------------------------

    def _split_schema(self, sd: SchemaDefinition) -> SchemaDefinition:
        """The data files' schema: the whole schema less the partition
        columns, which must be top-level primitive leaves."""
        names = {c.name for c in sd.root.children}
        for k in self.partition_by:
            if k not in names:
                raise ValueError(
                    f"partition column {k!r} is not a top-level "
                    f"schema field")
        keep = []
        for c in sd.root.children:
            if c.name in self.partition_by:
                if c.children:
                    raise ValueError(
                        f"partition column {c.name!r} must be a "
                        f"primitive leaf, not a group")
                continue
            keep.append(copy.deepcopy(c))
        if not keep:
            raise ValueError(
                "schema has no data columns besides the partition "
                "keys")
        root = copy.deepcopy(sd.root)
        root.children = keep
        out = SchemaDefinition(root)
        out.validate()
        return out

    # -- writing ----------------------------------------------------------

    def write_columns(self, columns: dict, *, masks=None) -> None:
        """Route one batch of rows to their partition files.

        ``columns`` maps a column name to its row-aligned values (a
        numpy array, or a list for binary and string columns), the
        partition columns included: those are non-null, but a None
        value routes its row to the hive null partition.  ``masks`` maps
        a data column to its row-aligned validity (the values at null
        rows are ignored).  Each call appends one row group to each
        partition file it touches."""
        if self._closed:
            raise ValueError("dataset writer is closed")
        masks = masks or {}
        for k in self.partition_by:
            if k not in columns:
                raise ValueError(f"missing partition column {k!r}")
            if k in masks:
                raise ValueError(
                    f"partition column {k!r} cannot carry a mask; "
                    f"use None values for the hive null partition")
        data_names = [c.name for c in self._data_schema.root.children]
        for name in columns:
            if name not in data_names and \
                    name not in self.partition_by:
                raise ValueError(f"unknown column {name!r}")
        n_rows = None
        for name, vals in columns.items():
            n = len(vals)
            if n_rows is None:
                n_rows = n
            elif n != n_rows:
                raise ValueError(
                    f"column {name!r} has {n} rows, expected {n_rows}")
        if not n_rows:
            return
        groups = self._group_rows(columns, n_rows)
        self._flush_groups(groups, columns, masks)

    def _group_rows(self, columns, n_rows):
        """``(partition-value tuple, row indices)`` pairs in the
        partitions' order, each partition's rows ascending.  Integer and
        boolean key columns group in numpy; any other key goes row by
        row."""
        keys = [columns[k] for k in self.partition_by]
        if all(isinstance(v, np.ndarray) and v.dtype.kind in "biu"
               for v in keys):
            codes = np.zeros(n_rows, dtype=np.int64)
            uniqs = []
            for v in keys:
                u, inv = np.unique(v, return_inverse=True)
                codes = codes * len(u) + inv.reshape(-1)
                uniqs.append(u)
            order = np.argsort(codes, kind="stable")
            sorted_codes = codes[order]
            cuts = np.flatnonzero(np.diff(sorted_codes)) + 1
            out = []
            for idx in np.split(order, cuts):
                c = int(codes[idx[0]])
                key = []
                for u in reversed(uniqs):
                    c, j = divmod(c, len(u))
                    key.append(u[j].item())
                out.append((tuple(reversed(key)), idx.astype(np.int64)))
            return sorted(out, key=lambda t: _part_sort_key(t[0]))
        cols = [[_py_key(v) for v in (vals.tolist()
                                      if isinstance(vals, np.ndarray)
                                      else list(vals))]
                for vals in keys]
        buckets: dict = {}
        for i in range(n_rows):
            buckets.setdefault(tuple(c[i] for c in cols), []).append(i)
        return [(key, np.asarray(buckets[key], dtype=np.int64))
                for key in sorted(buckets, key=_part_sort_key)]

    def _slice(self, vals, mask, idx):
        """Row-aligned ``(vals, mask)`` -> the writer's non-null values
        and mask for the rows ``idx``."""
        if isinstance(vals, np.ndarray):
            sub = vals[idx]
        else:
            lst = list(vals)
            sub = [lst[i] for i in idx]
        if mask is None:
            return sub, None
        m = np.asarray(mask, dtype=bool)[idx]
        if isinstance(sub, np.ndarray):
            return sub[m], m
        return [v for v, keep in zip(sub, m) if keep], m

    def _open_part(self, key, partition) -> _OpenPart:
        # the pid keeps a live writer's partial apart from a dead one's
        # for the orphan sweep
        partial = os.path.join(
            self.root_path, mf.TMP_DIR,
            f".partial.{os.getpid()}.{next(_partial_seq)}")
        self._handles[key] = open(partial, "wb")
        tee = _HashingTee(self._handles[key])
        fw = FileWriter(tee, self._data_schema, **self._writer_options)
        part = _OpenPart(key, partition, partial, tee, fw)
        self._parts[key] = part
        return part

    def _flush_groups(self, groups, columns, masks) -> None:
        budget = _write_threads()
        share = max(1, budget // max(len(groups), 1))
        jobs = []
        for key, idx in groups:
            part = self._parts.get(key)
            if part is None:
                part = self._open_part(
                    key, dict(zip(self.partition_by, key)))
            part.writer.encode_threads = share
            cols = {}
            mks = {}
            for c in self._data_schema.root.children:
                name = c.name
                if name not in columns:
                    continue
                vals, m = self._slice(columns[name],
                                      masks.get(name), idx)
                cols[name] = vals
                if m is not None:
                    mks[name] = m
            jobs.append((part, cols, mks, len(idx)))

        def flush(part, cols, mks, n):
            part.writer.write_columns(cols, masks=mks or None)
            part.rows += n

        if len(jobs) > 1 and budget > 1:
            # partitions on an outer pool: each worker adopts the
            # caller's trace context and counts into a collector of its
            # own, merged into the caller's
            from concurrent.futures import ThreadPoolExecutor

            from ..obs import trace as _trace
            from ..stats import current_stats, worker_stats

            tctx = _trace.current_ctx()
            sink = current_stats()

            def run(job):
                with _trace.adopt(tctx), worker_stats() as ws:
                    flush(*job)
                return ws

            with ThreadPoolExecutor(
                    max_workers=min(len(jobs), budget)) as ex:
                for ws in ex.map(run, jobs):
                    if sink is not None:
                        sink.merge_from(ws)
        else:
            for job in jobs:
                flush(*job)
        # roll after the flush: the files depend only on the bytes
        # written, never on the threads' timing
        for key, _ in groups:
            part = self._parts.get(key)
            if part is not None and \
                    part.writer.current_file_size() >= self._target:
                self._stage_part(key)

    def write_partition(self, partition: dict, columns: dict, *,
                        masks=None, source_bytes=None) -> None:
        """Write row-aligned data columns (no partition columns) into
        one partition: the compaction's path.  The rows go in chunks so
        the size target still rolls files, a row's size estimated from
        ``source_bytes`` (the size of the files rewritten) when given."""
        if self._closed:
            raise ValueError("dataset writer is closed")
        if set(partition) != set(self.partition_by):
            raise ValueError(
                f"partition {sorted(partition)} does not match "
                f"partition_by {sorted(self.partition_by)}")
        masks = masks or {}
        n_rows = None
        for name, vals in columns.items():
            if n_rows is None:
                n_rows = len(vals)
            elif len(vals) != n_rows:
                raise ValueError(
                    f"column {name!r} has {len(vals)} rows, "
                    f"expected {n_rows}")
        if not n_rows:
            return
        est_row = max(int(source_bytes / n_rows), 1) \
            if source_bytes else 64
        chunk = max(self._target // (4 * est_row), 1)
        key = tuple(partition[k] for k in self.partition_by)
        idx_all = np.arange(n_rows, dtype=np.int64)
        for lo in range(0, n_rows, chunk):
            idx = idx_all[lo:lo + chunk]
            part = self._parts.get(key)
            if part is None:
                part = self._open_part(key, dict(partition))
            part.writer.encode_threads = None
            cols, mks = {}, {}
            for name, vals in columns.items():
                v, m = self._slice(vals, masks.get(name), idx)
                cols[name] = v
                if m is not None:
                    mks[name] = m
            part.writer.write_columns(cols, masks=mks or None)
            part.rows += len(idx)
            if part.writer.current_file_size() >= self._target:
                self._stage_part(key)

    # -- staging and the commit protocol ----------------------------------

    def _step(self, *label) -> None:
        """A protocol step's boundary (the kill sweep's hook)."""
        if self._step_hook is not None:
            self._step_hook(label)

    def _stage_part(self, key) -> dict:
        """Finish one partition file under its content address: on
        return ``_tmp/part-<sha1>.parquet`` is complete and durable (a
        ``.partial.*`` name never is)."""
        part = self._parts.pop(key)
        fh = self._handles[key]
        self._step("stage", part.partial)
        part.writer.close()  # footer
        fh.flush()
        os.fsync(fh.fileno())
        size = fh.tell()
        fh.close()
        del self._handles[key]
        digest = part.tee.sha1.hexdigest()[:16]
        name = f"part-{digest}.parquet"
        staged = os.path.join(self.root_path, mf.TMP_DIR, name)
        if os.path.exists(staged):
            # the same content is staged already (a resumed re-run):
            # keep it, drop the duplicate partial
            os.unlink(part.partial)
        else:
            os.replace(part.partial, staged)
            mf._fsync_dir(os.path.dirname(staged))
        pdir = mf.partition_dir(self.partition_by, part.partition)
        rel = f"{pdir}/{name}" if pdir else name
        entry = {"tmp": name, "path": rel,
                 "partition": part.partition,
                 "rows": part.rows, "bytes": size, "sha1": digest}
        self._staged.append(entry)
        return entry

    def _promote(self, entry: dict, tmp_refs: dict) -> None:
        """Move one staged file to its partition path; idempotent, so a
        resumed commit runs it again safely."""
        rel = entry["path"]
        final = os.path.join(self.root_path, rel)
        fault_point("dataset.file.promote", file=rel)
        # count down even when skipping: a resumed commit must consume
        # the staged copy at its last reference, or it reads as an orphan
        tmp_refs[entry["tmp"]] -= 1
        tmp = os.path.join(self.root_path, mf.TMP_DIR, entry["tmp"])
        if os.path.exists(final):
            # promoted by an earlier attempt; a resume that staged the
            # same content again leaves a duplicate of the published
            # file: consume it
            if tmp_refs[entry["tmp"]] <= 0 and os.path.exists(tmp):
                os.unlink(tmp)
            return
        os.makedirs(os.path.dirname(final) or self.root_path,
                    exist_ok=True)
        if tmp_refs[entry["tmp"]] > 0:
            # the same content under several partition paths: keep the
            # staged copy for the entries still to come
            os.link(tmp, final)
        else:
            os.replace(tmp, final)
        mf._fsync_dir(os.path.dirname(final))

    def commit(self, *, remove_paths=()):
        """Run the commit protocol; returns the new manifest version (or
        the current one when there is nothing to publish).  A resumed
        writer with no new data finishes what the journal recorded.
        ``remove_paths`` drops base files from the new snapshot (the
        compaction: the merged-away files stay on disk, named by older
        snapshots, until pruning and GC collect them)."""
        if self._closed:
            raise ValueError("dataset writer is closed")
        for key in sorted(self._parts, key=_part_sort_key):
            self._stage_part(key)
        new_files = {e["path"]: e for e in self._staged}
        base_body, base_ver, _ = mf.resolve_manifest(self.root)
        base_ver = base_ver or 0
        version = base_ver + 1
        if self._journal is not None:
            if base_ver >= self._journal["version"]:
                # the crashed run published its manifest: run its
                # cleanup, then commit any new data at the next version
                self._step("clean")
                mf.clear_journal(self.root_path)
                mf.prune_manifests(self.root_path, self._keep)
                self._journal = None
                if not new_files:
                    self._staged = []
                    return base_ver
            else:
                for e in self._journal["files"]:
                    new_files.setdefault(e["path"], dict(e))
                version = self._journal["version"]
                # a journaled compaction's drop list survives the crash,
                # or a resume would publish the merged-away files again
                remove_paths = set(remove_paths) | \
                    set(self._journal.get("remove_paths") or [])
        if not new_files:
            return base_ver if base_ver else None
        entries = [new_files[p] for p in sorted(new_files)]
        self._step("journal")
        mf.write_journal(self.root_path, {
            "version": version, "base_version": base_ver,
            "partition_keys": list(self.partition_by),
            "files": entries,
            "remove_paths": sorted(remove_paths)})
        tmp_refs: dict = {}
        for e in entries:
            tmp_refs[e["tmp"]] = tmp_refs.get(e["tmp"], 0) + 1
        for e in entries:
            self._step("promote", e["path"])
            self._promote(e, tmp_refs)
        base_files = list(base_body["files"]) if base_body else []
        removed = set(remove_paths)
        published = {p: {k: v for k, v in e.items() if k != "tmp"}
                     for p, e in new_files.items()}
        for e in base_files:
            if e["path"] not in removed:
                published.setdefault(e["path"], dict(e))
        self._step("manifest")
        mf.write_manifest(self.root_path, {
            "version": version,
            "partition_keys": list(self.partition_by),
            "schema": str(self.schema),
            "files": [published[p] for p in sorted(published)]})
        self._step("clean")
        mf.clear_journal(self.root_path)
        mf.prune_manifests(self.root_path, self._keep)
        self._journal = None
        self._staged = []
        return version

    # -- lifecycle --------------------------------------------------------

    def close(self):
        """Commit the pending data, then release every partition
        handle."""
        if self._closed:
            return
        try:
            self.commit()
        finally:
            self._release()

    def abort(self):
        """Discard without committing: every open partial is removed;
        staged content stays under ``_tmp/`` for the orphan sweep (an
        abort may leave the only copy of costly data)."""
        if self._closed:
            return
        partials = [p.partial for p in self._parts.values()]
        self._release()
        for p in partials:
            try:
                os.unlink(p)
            except OSError:
                pass

    def _release(self):
        self._closed = True
        for fh in self._handles.values():
            try:
                fh.close()
            except OSError:
                pass
        self._handles.clear()
        self._parts.clear()

    def __enter__(self):
        return self

    def __exit__(self, exc_type, exc, tb):
        if exc_type is None:
            self.close()
        else:
            self.abort()
