"""DatasetScan: scans of a partitioned dataset through its manifest.

The port of ``tpuparquet/dataset/scan.py``.  Partition-value pruning runs
against the manifest (no file opened), in front of each file's
statistics, bloom and page-index pruning, which run in front of the
exact predicate: each layer sees only what the one before could not rule
out.  A partition predicate is exact at file granularity (every row of a
file shares its partition values), so a conjunct on partition keys alone
is consumed by the pruning and never evaluated row by row.

Below the manifest it is a plain
:class:`~tpuparquet_torch.shard.scan.ShardedScan` over the surviving
files, whose sources ride the byte-range layer (``io/source.py``: a
dataset root may be ``file://`` or ``emu://``), with the manifest's and
the sweep's findings merged into the scan's
:class:`~tpuparquet_torch.faults.QuarantineReport`.
"""

from __future__ import annotations

import os

from ..errors import CorruptManifestError
from ..faults import QuarantineReport
from ..filter import And, Cmp, In, IsNull, Or, parse_filter
from ..shard.scan import ShardedScan
from ..stats import collect_stats, current_stats
from . import manifest as mf

__all__ = ["DatasetScan", "split_partition_filter",
           "partition_matches"]

_CMP = {
    "==": lambda a, b: a == b,
    "!=": lambda a, b: a != b,
    "<": lambda a, b: a < b,
    "<=": lambda a, b: a <= b,
    ">": lambda a, b: a > b,
    ">=": lambda a, b: a >= b,
}


def split_partition_filter(filter, keys):
    """Split a predicate into ``(partition_pred, residual)``.

    Top-level conjuncts referencing only partition ``keys`` go to the
    partition side (evaluated exactly, per file, against the
    manifest); conjuncts referencing only data columns go to the
    residual (the per-file pruning + exact layers).  A conjunct mixing
    both (an OR across the boundary) cannot be decided at either
    granularity alone and is rejected."""
    if filter is None:
        return None, None
    if isinstance(filter, str):
        filter = parse_filter(filter)
    keys = set(keys)
    part_side, data_side = [], []
    conjuncts = filter.parts if isinstance(filter, And) else [filter]
    for c in conjuncts:
        cols = c.columns()
        if cols <= keys:
            part_side.append(c)
        elif cols & keys:
            raise ValueError(
                f"predicate {c.describe()} mixes partition keys and "
                f"data columns in one disjunct — split it into "
                f"AND-able conjuncts")
        else:
            data_side.append(c)

    def fold(parts):
        if not parts:
            return None
        return parts[0] if len(parts) == 1 else And(parts)

    return fold(part_side), fold(data_side)


def partition_matches(pred, partition: dict) -> bool:
    """Exact evaluation of a partition-only predicate against one
    file's partition values (comparisons never match null, same as
    the row-level filter semantics)."""
    if pred is None:
        return True
    if isinstance(pred, And):
        return all(partition_matches(p, partition) for p in pred.parts)
    if isinstance(pred, Or):
        return any(partition_matches(p, partition) for p in pred.parts)
    v = partition.get(pred.column)
    if isinstance(pred, IsNull):
        return (v is not None) if pred.invert else (v is None)
    if v is None:
        return False
    if isinstance(pred, Cmp):
        try:
            return bool(_CMP[pred.op](v, pred.value))
        except TypeError:
            return pred.op == "!="  # cross-type: never equal
    if isinstance(pred, In):
        return v in pred.values
    raise TypeError(
        f"unsupported partition predicate {type(pred).__name__}")


class DatasetScan:
    """Scan a partitioned dataset through its newest valid manifest.

    ``root`` may be a bare path or a ``file://``/``emu://`` URI; a
    root with no tpq manifest falls back to hive directory discovery
    (interop: datasets written by pyarrow).  ``filter`` conjuncts on
    partition keys prune files against the manifest
    (``DecodeStats.dataset_files_pruned``); the rest flows to the
    inner :class:`ShardedScan` untouched — every per-file keyword
    (``on_error``, ``salvage``, ``resume_from``, ``mesh``, ...)
    passes through.

    ``sweep_orphans=True`` additionally quarantines staging orphans
    from crashed writes before scanning (findings ride
    :attr:`quarantine`; nothing is silently deleted).
    """

    def __init__(self, root, *columns, filter=None,
                 sweep_orphans: bool = False, **scan_kwargs):
        self.root = root
        self._pre_quarantine = QuarantineReport()
        if sweep_orphans:
            mf.sweep_orphans(root, quarantine=self._pre_quarantine)
        body, version, findings = mf.resolve_manifest(
            root, quarantine=self._pre_quarantine)
        if body is None:
            _, root_path = mf.split_root(root)
            if findings:
                raise CorruptManifestError(
                    f"no valid manifest snapshot in {root!r} "
                    f"({len(findings)} rejected)", file=root)
            if os.path.exists(os.path.join(root_path,
                                           mf.JOURNAL_NAME)):
                # a first commit died mid-protocol: half-promoted
                # files must NOT leak through hive discovery — the
                # snapshot-or-nothing contract says "nothing"
                raise FileNotFoundError(
                    f"{root!r} has a pending commit journal and no "
                    f"published snapshot — resume the write with "
                    f"DatasetWriter(resume_from=...) to finish it")
            body = mf.discover_hive(root_path)
            if body is None:
                raise FileNotFoundError(
                    f"{root!r} holds neither a manifest nor hive "
                    f"partition directories")
            version = 0
        self.manifest = body
        self.version = version
        self.findings = findings
        keys = body["partition_keys"]
        for c in columns:
            if c in keys:
                raise ValueError(
                    f"column {c!r} is a partition key: hive data "
                    f"files do not store it — read it from "
                    f".files() / .partitions instead")
        part_pred, residual = split_partition_filter(filter, keys)
        survivors, pruned = [], 0
        for e in body["files"]:
            if partition_matches(part_pred, e["partition"]):
                survivors.append(e)
            else:
                pruned += 1
        self.files_pruned = pruned
        st = current_stats()
        if st is not None and pruned:
            st.dataset_files_pruned += pruned
        self._entries = survivors
        self.sources = [e.get("uri") or mf.file_uri(root, e["path"])
                        for e in survivors]
        #: source string -> partition-value dict (what a consumer
        #: joins back to reconstruct partition columns)
        self.partitions = {s: dict(e["partition"])
                           for s, e in zip(self.sources, survivors)}
        self._scan = ShardedScan(self.sources, *columns,
                                 filter=residual, **scan_kwargs)

    # -- delegation -------------------------------------------------------

    def files(self):
        """The surviving ``(source, partition_dict, rows, bytes)``
        entries, in manifest order."""
        return [(s, dict(e["partition"]), e.get("rows"),
                 e.get("bytes"))
                for s, e in zip(self.sources, self._entries)]

    @property
    def units(self):
        return self._scan.units

    @property
    def readers(self):
        return self._scan.readers

    @property
    def quarantine(self) -> QuarantineReport:
        """Manifest/sweep findings + the inner scan's report, one
        report (dataset failures and file failures flow to the same
        place)."""
        out = QuarantineReport(self._pre_quarantine.as_dicts())
        out.merge_unique(self._scan.quarantine.as_dicts())
        return out

    def run_iter(self):
        yield from self._scan.run_iter()

    def run(self):
        return self._scan.run()

    def run_with_stats(self, events: bool = False):
        """:meth:`run` under a fresh collector (the dataset-level
        prune verdicts are folded in, so the counters a caller sees
        are complete for this run)."""
        with collect_stats(events=events) as st:
            if self.files_pruned:
                st.dataset_files_pruned += self.files_pruned
            results = self._scan.run()
        return results, st

    def state(self) -> dict:
        return self._scan.state()

    def request_stop(self) -> None:
        self._scan.request_stop()

    def gather_column(self, results, path, **kw):
        return self._scan.gather_column(results, path, **kw)

    def gather_byte_column(self, results, path, **kw):
        return self._scan.gather_byte_column(results, path, **kw)

    def close(self):
        self._scan.close()

    def __enter__(self):
        return self

    def __exit__(self, exc_type, exc, tb):
        self.close()
