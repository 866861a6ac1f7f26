"""Dataset compaction: small files merged through the atomic commit.

:func:`compact_dataset` reads every data file of every partition back
(the host decode, ``FileReader.read_row_group_arrays``, bit for bit),
re-sorts each partition by a column when asked (so the per-page min/max
statistics that ``TPQ_PAGE_ROWS`` pages carry become tight and page
pruning fires), and rewrites each partition as rolling
``TPQ_DATASET_TARGET_MB`` files, published through the same
manifest-journal protocol as any write.  The new snapshot drops the
compacted files, so a compaction killed at any byte is invisible: the
prior snapshot still names the old files, untouched until the new
manifest is the newest valid one.

After the commit, snapshots past ``TPQ_DATASET_MANIFEST_KEEP`` are
pruned and the data files that no kept snapshot (nor a pending journal)
names are deleted (:func:`gc_unreferenced`): a collection of committed
state, not an orphan sweep (orphans under ``_tmp/`` are quarantined,
never deleted; ``manifest.sweep_orphans``).
"""

from __future__ import annotations

import os

import numpy as np

from ..cpu.plain import ByteArrayColumn
from ..format.schema import Schema
from ..io.reader import FileReader
from . import manifest as mf
from .writer import DatasetWriter

__all__ = ["compact_dataset", "gc_unreferenced"]


def _row_aligned(cd, max_def):
    """ChunkData (dense non-null values + def levels) -> row-aligned
    ``(values, mask)`` in the shape :meth:`DatasetWriter
    .write_columns` routing expects."""
    n = len(cd.def_levels)
    if max_def == 0:
        vals = cd.values
        if isinstance(vals, ByteArrayColumn):
            return vals.to_list(), None
        return np.asarray(vals), None
    mask = np.asarray(cd.def_levels) == max_def
    if isinstance(cd.values, ByteArrayColumn):
        dense = cd.values.to_list()
        out = [b""] * n
        j = 0
        for i in range(n):
            if mask[i]:
                out[i] = dense[j]
                j += 1
        return out, mask
    vals = np.asarray(cd.values)
    out = np.zeros(n, dtype=vals.dtype)
    out[mask] = vals
    return out, mask


def _concat(parts, masks):
    """Concatenate per-file row-aligned (values, mask) pairs."""
    if all(isinstance(p, np.ndarray) for p in parts):
        vals = np.concatenate(parts) if parts else np.array([])
    else:
        vals = []
        for p in parts:
            vals.extend(p.tolist() if isinstance(p, np.ndarray)
                        else list(p))
    if all(m is None for m in masks):
        return vals, None
    out = np.concatenate([
        m if m is not None else np.ones(len(p), dtype=bool)
        for p, m in zip(parts, masks)])
    return vals, out


def _sort_order(vals, mask):
    """Stable ascending order with nulls last."""
    n = len(vals)
    null = np.zeros(n, dtype=bool) if mask is None else ~np.asarray(
        mask, dtype=bool)
    if isinstance(vals, np.ndarray) and vals.dtype != object:
        key = vals.copy()
        # neutralize null slots so they cannot perturb the sort
        if n and null.any():
            key[null] = key[~null][0] if (~null).any() else key[0]
        return np.lexsort((np.arange(n), key, null))
    keyed = [(bool(null[i]), vals[i] if not null[i] else b"", i)
             for i in range(n)]
    keyed.sort(key=lambda t: (t[0], t[1]))
    return np.asarray([t[2] for t in keyed], dtype=np.int64)


def gc_unreferenced(root_path: str) -> list:
    """Delete data files referenced by NO retained snapshot and no
    pending journal (committed-state GC after manifest pruning).
    Returns the deleted relative paths."""
    referenced = set()
    for v in mf.list_manifest_versions(root_path):
        try:
            body = mf.load_envelope(
                os.path.join(root_path, mf.manifest_name(v)),
                mf.MANIFEST_FORMAT, display=mf.manifest_name(v))
        except Exception:
            continue  # a corrupt snapshot pins nothing
        for e in body.get("files", []):
            referenced.add(e["path"])
    try:
        journal = mf.load_journal(root_path)
    except Exception:
        journal = None
    if journal is not None:
        for e in journal["files"]:
            referenced.add(e["path"])
    removed = []
    for dirpath, dirnames, filenames in os.walk(root_path):
        dirnames[:] = [d for d in dirnames
                       if not d.startswith(("_", "."))]
        for name in filenames:
            if name.startswith(("_", ".")) or \
                    not name.endswith(".parquet"):
                continue
            full = os.path.join(dirpath, name)
            rel = os.path.relpath(full, root_path).replace(os.sep, "/")
            if rel not in referenced:
                os.unlink(full)
                removed.append(rel)
    # drop now-empty partition directories (bottom-up)
    for dirpath, dirnames, filenames in sorted(
            os.walk(root_path), key=lambda t: -len(t[0])):
        if dirpath == root_path or \
                os.path.basename(dirpath).startswith(("_", ".")):
            continue
        try:
            os.rmdir(dirpath)
        except OSError:
            pass
    return removed


def compact_dataset(root, *, sort_by=None, target_mb=None,
                    manifest_keep=None, step_hook=None,
                    **writer_options):
    """Merge each partition's files into rolling target-sized files,
    optionally re-sorted by ``sort_by``; commit atomically; GC.

    Returns a report dict: new manifest ``version``, ``files_before``
    / ``files_after``, ``rows``, ``gc`` (deleted paths)."""
    _, root_path = mf.split_root(root)
    body, version, _ = mf.resolve_manifest(root)
    if body is None:
        raise FileNotFoundError(
            f"{root!r} has no valid manifest snapshot to compact")
    dsl = body.get("schema")
    if not dsl:
        raise ValueError(
            f"{root!r} manifest records no schema (imported hive "
            f"dataset?) — compaction needs it to rewrite files")
    keys = body["partition_keys"]
    writer = DatasetWriter(root, dsl, keys, target_mb=target_mb,
                           manifest_keep=manifest_keep,
                           step_hook=step_hook, **writer_options)
    data_schema = Schema.from_definition(writer._data_schema)
    leaves = data_schema.leaves
    for leaf in leaves:
        if leaf.max_rep_level > 0 or leaf.parent is not data_schema.root:
            raise NotImplementedError(
                f"compaction supports flat top-level columns only "
                f"(column {leaf.flat_name!r})")
    if sort_by is not None and \
            sort_by not in {lf.flat_name for lf in leaves}:
        raise ValueError(f"sort_by names no data column {sort_by!r}")

    by_part: dict = {}
    for e in body["files"]:
        key = tuple(e["partition"][k] for k in keys)
        by_part.setdefault(key, []).append(e)

    total_rows = 0
    old_paths = [e["path"] for e in body["files"]]
    for key in sorted(by_part, key=lambda t: tuple(
            (v is None, str(v)) for v in t)):
        entries = by_part[key]
        cols: dict = {lf.flat_name: [] for lf in leaves}
        msks: dict = {lf.flat_name: [] for lf in leaves}
        part_rows = 0
        part_bytes = 0
        for e in entries:
            full = os.path.join(root_path, e["path"])
            part_bytes += os.path.getsize(full)
            with FileReader(full) as r:
                for rg in range(r.row_group_count()):
                    arrays = r.read_row_group_arrays(rg)
                    n = None
                    for lf in leaves:
                        cd = arrays[lf.flat_name]
                        vals, m = _row_aligned(cd, lf.max_def_level)
                        cols[lf.flat_name].append(vals)
                        msks[lf.flat_name].append(m)
                        n = len(cd.def_levels)
                    part_rows += n or 0
        merged: dict = {}
        mmask: dict = {}
        for name in cols:
            merged[name], mmask[name] = _concat(cols[name], msks[name])
        if sort_by is not None and part_rows:
            order = _sort_order(merged[sort_by], mmask.get(sort_by))
            for name in merged:
                v = merged[name]
                merged[name] = v[order] if isinstance(v, np.ndarray) \
                    else [v[i] for i in order]
                if mmask[name] is not None:
                    mmask[name] = np.asarray(mmask[name])[order]
        partition = dict(zip(keys, key))
        writer.write_partition(partition, merged,
                               masks={k: v for k, v in mmask.items()
                                      if v is not None},
                               source_bytes=part_bytes)
        total_rows += part_rows

    new_version = writer.commit(remove_paths=old_paths)
    writer._release()
    gc = gc_unreferenced(root_path)
    after, _, _ = mf.resolve_manifest(root)
    return {"version": new_version,
            "files_before": len(old_paths),
            "files_after": len(after["files"]) if after else 0,
            "rows": total_rows,
            "gc": gc}
