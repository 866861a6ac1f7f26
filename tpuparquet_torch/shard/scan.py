"""Multi-file sharded scan, its durable cursor checkpoints, and the
gathers.

The port of ``tpuparquet/shard/scan.py``.  The scan unit is (file, row
group); units go round-robin over the mesh's slots and each decodes on
its slot's device through the read pipeline (:func:`pipelined_unit_scan`
over :func:`~tpuparquet_torch.kernels.device.pipelined_reads`: the
columns of the next units plan on a pool of workers while the calling
thread stages and launches the unit before).  Exchange between devices
happens only at :func:`gather_column` and :func:`gather_byte_column`:
each unit densifies straight into its row of its rg block (KS1, KS3),
and the block is copied to the mesh's other devices (replicated) or
permuted onto the target (KS4, ``gather_to=``); a target outside the
mesh (a sink device, such as the host beside a mesh of cards) takes
each unit's row straight (:func:`_assemble_direct`).

:class:`DurableScanMixin` holds what :class:`ShardedScan` and
``shard/distributed.py``'s ``MultiHostScan`` share: the unit loop, a
cooperative stop (:meth:`~DurableScanMixin.request_stop`), the durable
cursor checkpoints (``resume_from=``, ``checkpoint_every=``: the
reference's cursor files, byte for byte, with the quarantine report),
the scan's deadlines and the gathers with the scan's default placement.

``on_error="quarantine"`` decodes the units one at a time through the
resilient ladder (:func:`resilient_unit_scan`: transient reads retried,
dispatch retried, then the unit's values decoded on the host) and
isolates what still fails into a
:class:`~tpuparquet_torch.faults.QuarantineReport`; a file that fails to
open is quarantined whole (:func:`open_sources`).

``filter=`` (a ``filter.py`` expression) prunes row groups before the
units form (:func:`scan_units`: chunk statistics, bloom filters, the
page index), and each unit takes the late-materialized read
(:func:`~tpuparquet_torch.kernels.device.filtered_pipelined_reads`, or
one unit at a time in quarantine mode): only the surviving rows reach
the devices, so filtered units are uneven and may hold no row.  The
pruned row groups count when the run starts.

``salvage=True`` (quarantine mode) keeps the readable row-group prefix
of a torn file, ``strict_metadata`` validates every footer before use,
and a source given as a replica group ``[primary, mirror, ...]`` hedges
its chunk reads against the mirrors (``hedge_delay``, ``read_deadline``;
:func:`open_sources`).

Telemetry (``obs/``): a run is one trace (``TPQ_TRACE``) whose root
holds a ``unit`` span a unit (with its plan, read, transfer and dispatch
children) and the ``gather`` spans of the scan's gathers, exported at
the end of the run to ``TPQ_TRACE_EXPORT``; units decode under the
scan's own collector when the caller has none, folded into the live
metrics registry at each unit boundary; the flight recorder takes a
record a unit, pruned row group and quarantine; and a quarantine, a
salvage or an expired scan deadline appends an incident to the scan's
post-mortem file (``postmortem=``: a path, ``False`` for none, None for
the checkpoint's ``.postmortem.json`` or ``TPQ_POSTMORTEM_DIR``).  Each
run also ticks the scan's progress (``progress_export=``,
``TPQ_PROGRESS_EXPORT``: a JSON status file, ``obs/progress.py``), folds
each unit's counts into the label's attribution ledger
(``progress_label``, ``obs/attribution.py``), and, where armed, observes
unit and run walls into the latency digests (``TPQ_LATENCY_DIGEST``),
appends a ``scan_end`` frame to the time-series ring
(``TPQ_TIMESERIES_DIR``) and exports the sampling profile
(``TPQ_PROFILE_EXPORT``); the scan's gathers mark their ``gather`` stage
for the profiler.
"""

from __future__ import annotations

import contextlib
import json
import os
import threading
import time
import zlib

import numpy as np
import torch

from ..errors import QUARANTINE_ERRORS, DeadlineExceededError, \
    never_quarantine
from ..faults import QuarantineReport, retry_transient
from ..filter import bind_filter
from ..io.rangecache import invalidate_source_caches
from ..io.reader import FileReader
from ..kernels.decode import scatter_to_dense
from ..kernels.device import DeviceColumn, _usable_cpus, \
    filtered_pipelined_reads, pipelined_reads, \
    read_row_group_device_resilient
from ..kernels.gather import byte_densify, place_rows
from ..kernels.plancache import invalidate_fingerprint
from ..obs import digest as _digest
from ..obs import profiler as _profiler
from ..obs import recorder as _flightrec
from ..obs import timeseries as _timeseries
from ..obs import trace as _trace
from ..obs.postmortem import postmortem_path_for, record_incident
from ..obs.recorder import flight
from ..stats import current_stats
from .mesh import (
    Mesh,
    NamedSharding,
    Shard,
    ShardedTensor,
    dim0_partitions,
    make_mesh,
    placement_devices,
    resolve_out_sharding,
)

__all__ = ["ShardedScan", "DurableScanMixin", "scan_units", "open_sources",
           "cursor_state", "cursor_load", "save_cursor_file",
           "load_cursor_file", "host_cursor_path",
           "checkpoint_every_default", "gather_column",
           "gather_byte_column", "pipelined_unit_scan",
           "resilient_unit_scan"]

def scan_units(readers: list, filter=None, verdicts: dict | None = None,
               pruned: list | None = None) -> list[tuple[int, int]]:
    """Flatten files into ``(file_index, row_group_index)`` work units;
    ``None`` readers contribute none but keep the file indices.

    With ``filter`` (bound), a row group whose static verdict proves it
    empty forms no unit: its ``(file, rg, num_rows, reason, bloom_hits)``
    goes to ``pruned``, and each kept row group's verdict to
    ``verdicts[(file, rg)]``.  The verdicts are a function of the files'
    bytes, so every process of a multi-process scan derives the same
    units."""
    units = []
    for fi, r in enumerate(readers):
        if r is None:
            continue
        for rgi in range(r.row_group_count()):
            if filter is not None:
                v = r.prune_row_group(filter, rgi)
                if v.skip:
                    if pruned is not None:
                        pruned.append((fi, rgi,
                                       r.meta.row_groups[rgi].num_rows,
                                       v.reason, v.bloom_hits))
                    if _flightrec._active is not None:
                        _flightrec.flight("row_group_pruned",
                                          site="shard.scan", file=fi,
                                          row_group=rgi, reason=v.reason)
                    continue
                if verdicts is not None:
                    verdicts[(fi, rgi)] = v
            units.append((fi, rgi))
    return units


def _replicas(src) -> list:
    """A source entry is one source or a replica group ``[primary,
    mirror, ...]`` of byte-identical copies."""
    if isinstance(src, (list, tuple)):
        if not src:
            raise ValueError("empty replica group in sources")
        return list(src)
    return [src]


def open_sources(sources, columns, *, on_error: str = "raise",
                 quarantine: QuarantineReport | None = None,
                 salvage: bool = False,
                 strict_metadata: bool | None = None,
                 record_for=None, entry_extra: dict | None = None,
                 hedge_delay: float | None = None,
                 read_deadline: float | None = None,
                 postmortem: str | None = None) -> list:
    """Open each source (a path, a byte-range source or its URI, bytes or
    a file object) with the ``columns`` projection, a transient failure
    retried (``faults.retry_transient``).  Returns the readers aligned
    with ``sources``.  Under ``on_error="raise"`` a failure propagates; under
    ``"quarantine"`` a file that fails to open gets a file-level entry in
    ``quarantine`` (``disposition`` ``"quarantined"``, and ``path`` for a
    path source), counts ``files_quarantined``, and its reader is None.
    With ``salvage=True`` (quarantine mode only) a file that fails to
    open is first opened again through salvage (its own hint, else the
    first file that opened as the schema donor): its recovered row-group
    prefix is kept and its entry's ``disposition`` is ``"salvaged"``,
    with ``row_groups_recovered`` and the report's ``stop_reason`` and
    ``bytes_lost``.  ``strict_metadata`` is passed to every open.

    An entry may be a replica group ``[primary, mirror, ...]``: the first
    replica that opens becomes the reader, and the replicas after it
    become its hedge mirrors (``FileReader(mirrors=, hedge_delay=,
    read_deadline=)``); only when every replica fails is the file
    salvaged or quarantined, under the primary's error.

    ``record_for(i)`` selects the files this process records (each file
    once across a multi-process scan: the salvage, reject, fault and CRC
    counts of the others' opens are rolled back), ``entry_extra`` is
    merged into each entry.  Salvage is deterministic, so every process
    derives the same readers.  ``postmortem`` (a path or None) receives
    an incident a file this call salvages or quarantines
    (``obs/postmortem.py``).  A string source that fails to open has its
    cached ranges evicted from both tiers (``io/rangecache.py``) before
    its salvage.  Raw crash types propagate."""
    if salvage and on_error != "quarantine":
        # under "raise" the first open failure aborts before a salvage
        # could run: the request would be silently inert
        raise ValueError(
            "salvage=True requires on_error='quarantine' (under "
            "'raise' the first open failure aborts the scan)")
    readers: list = [None] * len(sources)
    failures: dict[int, BaseException] = {}
    donor = None

    def record(i):
        return record_for is None or record_for(i)

    @contextlib.contextmanager
    def counted_if_recorded(i):
        """The reader counts its own salvage and reject; a file this
        process does not record has its counts rolled back, so folded
        counters count each file once."""
        st = current_stats()
        if st is None or record(i):
            yield
            return
        rollback = ("files_salvaged", "row_groups_recovered",
                    "metadata_rejects", "crc_mismatches",
                    "faults_injected")
        before = [getattr(st, f) for f in rollback]
        n_faults = len(st.events.faults) if st.events is not None else None
        try:
            yield
        finally:
            for f, v in zip(rollback, before):
                setattr(st, f, v)
            if n_faults is not None:
                del st.events.faults[n_faults:]

    def open_group(reps):
        """The first replica that opens wins; the replicas not yet tried
        become its mirrors (one that failed to open is a known-bad copy
        that must not win a hedge).  All failing raises the primary's
        error."""
        first_err = None
        for j, rep in enumerate(reps):
            try:
                return retry_transient(lambda rep=rep, j=j: FileReader(
                    rep, *columns, strict_metadata=strict_metadata,
                    mirrors=reps[j + 1:], hedge_delay=hedge_delay,
                    read_deadline=read_deadline))
            except QUARANTINE_ERRORS as e:
                if never_quarantine(e):
                    raise
                if first_err is None:
                    first_err = e
        raise first_err

    for i, src in enumerate(sources):
        try:
            with counted_if_recorded(i):
                readers[i] = open_group(_replicas(src))
            if donor is None:
                donor = readers[i].meta
        except QUARANTINE_ERRORS as e:
            if never_quarantine(e) or on_error != "quarantine":
                raise
            failures[i] = e
    for i, err in sorted(failures.items()):
        primary = _replicas(sources[i])[0]
        path = primary if isinstance(primary, str) else None
        if path is not None:
            # a failed open may have read, or left, stale cached ranges:
            # the salvage below and the next scan read the store
            invalidate_source_caches(path)
        if salvage:
            try:
                with counted_if_recorded(i):
                    r = FileReader(primary, *columns, salvage=True,
                                   salvage_like=donor,
                                   strict_metadata=strict_metadata)
            except QUARANTINE_ERRORS as e2:
                if never_quarantine(e2):
                    raise
            else:
                readers[i] = r
                if record(i):
                    extra = {"disposition": "salvaged",
                             "row_groups_recovered": r.row_group_count()}
                    if path is not None:
                        extra["path"] = path
                    for k in ("stop_reason", "bytes_lost"):
                        if k in (r.salvage_report or {}):
                            extra[k] = r.salvage_report[k]
                    entry = quarantine.add_file(file=i, error=err, **extra)
                    if entry_extra:
                        entry.update(entry_extra)
                    record_incident(postmortem, {
                        "kind": "file_salvaged", "site": "shard.scan.file",
                        **entry})
                continue
        if not record(i):
            continue
        extra = {"disposition": "quarantined"}
        if path is not None:
            extra["path"] = path
        entry = quarantine.add_file(file=i, error=err, **extra)
        if entry_extra:
            entry.update(entry_extra)
        if _flightrec._active is not None:
            _flightrec.flight("file_quarantined", site="shard.scan.file",
                              **entry)
        record_incident(postmortem, {
            "kind": "file_quarantined", "site": "shard.scan.file", **entry})
        st = current_stats()
        if st is not None:
            st.files_quarantined += 1
            if st.events is not None:
                st.events.fault(site="shard.scan.file",
                                kind="file_quarantined", **entry)
    return readers


def cursor_state(units, next_key: str, next_value: int, **extra) -> dict:
    """Snapshot a JSON-serializable scan cursor (the reference's
    format)."""
    cur = {"version": 1, next_key: next_value,
           "units": [list(u) for u in units]}
    cur.update(extra)
    return cur


def cursor_load(cursor: dict, units, next_key: str, n_units: int,
                **expected) -> int:
    """Validate a cursor against this scan's shape; returns the resume
    position.  ``expected`` pins fields that must match exactly."""
    if cursor.get("version") != 1:
        raise ValueError(f"unknown cursor version {cursor.get('version')}")
    if [tuple(u) for u in cursor["units"]] != list(units):
        raise ValueError(
            "cursor does not match these sources: unit list differs "
            "(files changed since the cursor was taken?)"
        )
    for k, v in expected.items():
        if cursor.get(k) != v:
            raise ValueError(
                f"cursor {k} {cursor.get(k)!r} does not match this "
                f"run's {v!r}; resuming would misalign the unit "
                "assignment"
            )
    nxt = int(cursor[next_key])
    if not 0 <= nxt <= n_units:
        raise ValueError(f"cursor {next_key} {nxt} out of range")
    return nxt


# ----------------------------------------------------------------------
# Durable cursor checkpoints (the reference's file format)
# ----------------------------------------------------------------------

CURSOR_FILE_FORMAT = "tpq-cursor"
CURSOR_FILE_VERSION = 1


def _canonical(obj) -> bytes:
    """The bytes the integrity checksum covers: key-sorted JSON with
    pinned separators, the same before a write and after a read."""
    return json.dumps(obj, sort_keys=True, separators=(",", ":")).encode()


def checkpoint_every_default() -> int:
    """The auto-checkpoint cadence in completed units
    (``TPQ_CHECKPOINT_EVERY``, at least 1; default 16)."""
    try:
        v = int(os.environ.get("TPQ_CHECKPOINT_EVERY", ""))
    except ValueError:
        return 16
    return max(v, 1)


def save_cursor_file(cursor: dict, path: str) -> None:
    """Write a scan cursor durably and atomically: a versioned envelope
    with a CRC32 of the canonical cursor, written to a temporary file in
    the same directory, flushed, fsynced and renamed over ``path``, then
    the directory fsynced; a kill at any point leaves the previous
    checkpoint or the new one, never a torn file.  Counts
    ``checkpoints_written``."""
    doc = {"format": CURSOR_FILE_FORMAT,
           "file_version": CURSOR_FILE_VERSION,
           "crc32": zlib.crc32(_canonical(cursor)),
           "cursor": cursor}
    d = os.path.dirname(os.path.abspath(path)) or "."
    tmp = os.path.join(d, f".{os.path.basename(path)}.tmp.{os.getpid()}")
    try:
        with open(tmp, "w") as f:
            json.dump(doc, f, sort_keys=True)
            f.flush()
            os.fsync(f.fileno())
        os.replace(tmp, path)
    except BaseException:
        try:
            os.unlink(tmp)
        except OSError:
            pass
        raise
    # the rename itself is durable once the directory is synced (some
    # filesystems refuse a directory descriptor: best effort)
    try:
        dfd = os.open(d, os.O_RDONLY)
        try:
            os.fsync(dfd)
        finally:
            os.close(dfd)
    except OSError:
        pass
    st = current_stats()
    if st is not None:
        st.checkpoints_written += 1


def load_cursor_file(path: str) -> dict:
    """Read a :func:`save_cursor_file` checkpoint back, checking its
    format, version and checksum; raises ``ValueError`` on anything that
    is not a whole, untampered cursor."""
    with open(path) as f:
        try:
            doc = json.load(f)
        except json.JSONDecodeError as e:
            raise ValueError(
                f"checkpoint {path!r} is not valid JSON: {e}") from e
    if not isinstance(doc, dict) \
            or doc.get("format") != CURSOR_FILE_FORMAT:
        raise ValueError(f"{path!r} is not a tpq cursor checkpoint")
    if doc.get("file_version") != CURSOR_FILE_VERSION:
        raise ValueError(
            f"unknown checkpoint file_version "
            f"{doc.get('file_version')!r} in {path!r}")
    cursor = doc.get("cursor")
    if zlib.crc32(_canonical(cursor)) != doc.get("crc32"):
        raise ValueError(
            f"checkpoint {path!r} failed its integrity checksum")
    return cursor


def host_cursor_path(base: str, process_index: int) -> str:
    """The checkpoint file of process ``process_index`` of a
    multi-process scan: one file a process, so hosts never race."""
    return f"{base}.p{process_index}"


def pipelined_unit_scan(readers, units, device_for=None, start: int = 0,
                        filter=None, verdicts=None):
    """Yield ``(unit_index, {path: DeviceColumn})`` for ``units[start:]``
    (``(file, row group)`` pairs), unit k on ``device_for(k)``: the
    shared read pipeline of
    :func:`~tpuparquet_torch.kernels.device.pipelined_reads`, or with
    ``filter`` its late-materialized sibling
    :func:`~tpuparquet_torch.kernels.device.filtered_pipelined_reads`."""
    if filter is not None:
        yield from filtered_pipelined_reads(readers, units, device_for,
                                            start, filter=filter,
                                            verdicts=verdicts)
    else:
        yield from pipelined_reads(readers, units, device_for, start)


def resilient_unit_scan(readers, units, device_for, *, start: int = 0,
                        retries=None, quarantine: QuarantineReport,
                        entry_extra: dict | None = None,
                        unit_deadline: float | None = None,
                        postmortem: str | None = None,
                        filter=None, verdicts=None):
    """The quarantine-mode unit loop of both scan drivers: each unit of
    ``units[start:]`` decodes on its own through the resilient ladder
    (:func:`~tpuparquet_torch.kernels.device.
    read_row_group_device_resilient`: transient reads retried, dispatch
    retried, then the values decoded on the host).  A unit that still
    fails with one of ``errors.QUARANTINE_ERRORS`` gets an entry in
    ``quarantine`` (its unit, file, row group, error class and inner
    coordinates, ``entry_extra`` merged in), counts
    ``units_quarantined``, drops its file's cached plans, and yields
    ``(k, None)``; a decoded unit yields ``(k, columns)``.  Raw crash
    types propagate.

    ``unit_deadline`` bounds each unit's whole decode, retries and host
    decode included (``deadline.call_with_deadline``): a unit past it is
    quarantined as a ``DeadlineExceededError``; its abandoned worker
    runs on until its call returns.  ``filter`` and the units'
    ``verdicts`` pass to the resilient read (its filtered read).

    Each unit is a ``unit`` span that becomes the ambient context (the
    units decode one at a time on the calling thread, so the retry,
    degradation and deadline spans nest under it); a quarantined unit
    is a flight record, a fault event and an incident of the
    ``postmortem`` file."""
    from ..deadline import call_with_deadline

    for k in range(start, len(units)):
        fi, rgi = units[k]
        usp = _trace.open_span("unit", unit=k, file=fi, row_group=rgi) \
            if _trace._active is not None else None

        def decode(k=k, fi=fi, rgi=rgi):
            return read_row_group_device_resilient(
                readers[fi], rgi, retries=retries, device=device_for(k),
                filter=filter, verdict=(None if verdicts is None
                                        else verdicts.get((fi, rgi))))

        try:
            if unit_deadline:
                out = call_with_deadline(decode, unit_deadline,
                                         site="shard.scan.unit", file=fi,
                                         row_group=rgi)
            else:
                out = decode()
        except QUARANTINE_ERRORS as e:
            if never_quarantine(e):
                _trace.close_span(usp, status="error",
                                  error=type(e).__name__)
                raise
            entry = quarantine.add(unit=k, file=fi, row_group=rgi, error=e)
            if entry_extra:
                entry.update(entry_extra)
            # the file's bytes no longer match its footer: drop its
            # cached plans (only a fingerprint already computed can have
            # any; computing one here would read the file again)
            cached = getattr(readers[fi], "cached_plan_fingerprint", None)
            if cached is not None:
                invalidate_fingerprint(cached())
            # the post-mortem: the trigger's coordinates, the flight
            # recorder's tail and the metrics, beside the cursor
            flight("quarantined", site="shard.scan.unit", **entry)
            record_incident(postmortem, {
                "kind": "quarantined", "site": "shard.scan.unit", **entry})
            st = current_stats()
            if st is not None:
                st.units_quarantined += 1
                if st.events is not None:
                    st.events.fault(site="shard.scan.unit",
                                    kind="quarantined", **entry)
            _trace.close_span(usp, status="error", quarantined=True,
                              error=type(e).__name__)
            yield k, None
            continue
        except BaseException:
            # a raw crash propagates, never with a leaked context
            _trace.close_span(usp, status="error")
            raise
        _trace.close_span(usp)
        yield k, out


class DurableScanMixin:
    """The unit loop, cooperative stop, durable checkpoints and gathers
    that :class:`ShardedScan` and
    :class:`~tpuparquet_torch.shard.distributed.MultiHostScan` share, so
    their cadence cannot drift apart.  A scan class sets ``readers``,
    ``mesh``, ``devices``, ``out_sharding``, ``quarantine`` and
    ``retries``, calls :meth:`_init_durable` and, before forming its
    units, :meth:`_init_filter`, and provides ``state()``,
    :meth:`_progress`, :meth:`_advance` and :meth:`_unit_coords`
    (:meth:`_entry_extra` and :meth:`_count_pruned` optionally)."""

    def _progress(self) -> tuple[int, int]:
        """``(next unit, units)`` of this scan's cursor."""
        raise NotImplementedError

    def _advance(self, k: int) -> None:
        """Move the cursor past unit ``k`` (-1: to the start)."""
        raise NotImplementedError

    def _unit_coords(self, k: int) -> tuple[int, int]:
        """``(file_index, row_group_index)`` of this scan's unit k."""
        raise NotImplementedError

    def _entry_extra(self) -> dict | None:
        """Fields merged into each of this scan's quarantine entries."""
        return None

    def _init_filter(self, filter, readers) -> None:
        """Bind ``filter`` once against the first open file's schema;
        :func:`scan_units` then fills :attr:`_verdicts` and
        :attr:`_pruned`."""
        self.filter = filter
        self._verdicts: dict = {}
        self._pruned: list = []
        if filter is None:
            return
        for r in readers:
            if r is not None:
                bind_filter(filter, r.schema)
                break

    def _count_pruned(self, select_pruned=None, select_kept=None) -> None:
        """Fold the unit forming's pruning into the active collector: a
        pruned row group's rows, and every verdict's bloom hits (a kept
        row group's too: an ``Or`` branch a bloom refuted).  Called when
        a fresh run starts, so ``run_with_stats`` sees them; the
        selectors choose what this process counts (each row group once
        across a multi-process scan)."""
        st = current_stats()
        if self.filter is None or st is None:
            return
        hits = 0
        for j, (_fi, _rgi, n_rows, _reason, bh) in enumerate(self._pruned):
            if select_pruned is None or select_pruned(j):
                st.row_groups_pruned += 1
                st.rows_pruned += n_rows
                hits += bh
        for key, v in self._verdicts.items():
            if select_kept is None or select_kept(key):
                hits += v.bloom_hits
        st.bloom_hits += hits

    def _init_durable(self, *, on_error, unit_deadline, scan_deadline,
                      resume, resume_from, checkpoint_every,
                      checkpoint_path, postmortem=None) -> None:
        """Check and resolve the error policy, the deadlines and the
        checkpoint arguments (``checkpoint_path`` is the scan's own file:
        per process for the multi-process scan).  Call before opening
        sources: a bad argument fails cheap.  ``unit_deadline`` needs
        ``on_error="quarantine"`` (an expired unit is quarantined); the
        environment's defaults (``TPQ_UNIT_DEADLINE_S``,
        ``TPQ_SCAN_DEADLINE_S``) apply where the argument is None, the
        unit's only in quarantine mode.  ``postmortem`` is where the
        incidents go: a path, ``False`` for nowhere, None for
        :func:`~tpuparquet_torch.obs.postmortem.postmortem_path_for` of
        the checkpoint (beside it, else ``TPQ_POSTMORTEM_DIR``, else
        nowhere)."""
        from ..deadline import scan_deadline_default, unit_deadline_default

        if on_error not in ("raise", "quarantine"):
            raise ValueError(f"on_error must be 'raise' or 'quarantine', "
                             f"not {on_error!r}")
        if unit_deadline is not None and on_error != "quarantine":
            raise ValueError(
                "unit_deadline requires on_error='quarantine' (an "
                "expired unit is absorbed by the quarantine ladder)")
        if resume is not None and resume_from is not None:
            raise ValueError("pass resume= or resume_from=, not both")
        self.on_error = on_error
        self.unit_deadline = (unit_deadline if unit_deadline is not None
                              else unit_deadline_default()
                              if on_error == "quarantine" else None)
        self.scan_deadline = (scan_deadline if scan_deadline is not None
                              else scan_deadline_default())
        self._run_t0 = None
        self._checkpoint_path = checkpoint_path
        self._checkpoint_every = (checkpoint_every
                                  if checkpoint_every is not None
                                  else checkpoint_every_default())
        self._since_checkpoint = 0
        # request_stop() (from any thread) ends the loop at the next unit
        # boundary with the cursor flushed
        self._stop = threading.Event()
        self.stopped = False
        self._postmortem_path = (
            postmortem if isinstance(postmortem, str)
            else None if postmortem is False
            else postmortem_path_for(checkpoint_path))

    def _init_telemetry(self, n_units: int, progress_export: str | None,
                        label: str) -> None:
        """Arm the always-on surfaces: the scan's
        :class:`~tpuparquet_torch.obs.progress.ScanProgress` (exported to
        ``progress_export``, else ``TPQ_PROGRESS_EXPORT`` with the label's
        slug appended when it is not ``"scan"``, so concurrent scans and
        the processes of a multi-process scan do not share one file; ""
        for none), a collector of the scan's own that meters the units
        when the caller has none (live metrics on), its incremental
        registry fold, the label's attribution ledger, the end-of-run
        trace and profile export paths (``TPQ_TRACE_EXPORT``,
        ``TPQ_PROFILE_EXPORT``, suffixed the same way) and the
        time-series ring when ``TPQ_TIMESERIES_DIR`` appeared after
        import.  Call once the unit list exists."""
        from ..obs import attribution as _attribution
        from ..obs.live import LiveFold, live_enabled
        from ..obs.progress import (
            ScanProgress,
            label_slug,
            progress_export_default,
        )
        from ..stats import DecodeStats

        def suffixed(path):
            if path and label != "scan":
                return f"{path}.{label_slug(label)}"
            return path or None

        path = (progress_export if progress_export is not None
                else suffixed(progress_export_default()))
        self.progress = ScanProgress(n_units, label=label,
                                     export=path or None)
        self._live_stats = DecodeStats() if live_enabled() else None
        self._live_fold = LiveFold()
        # the ledger takes the same deltas as the registry, so the
        # ledgers sum to the registry's totals (and so needs the same
        # switch)
        self._ledger = (_attribution.ledger(label)
                        if live_enabled() else None)
        self._attr_fold = LiveFold()
        self._attr_src = None
        self._trace_export = suffixed(_trace.trace_export_default())
        self._trace_ctx = None
        self._profile_export = suffixed(
            _profiler.profile_export_default())
        _timeseries.maybe_start_ring()

    def _finish_telemetry(self, t_scan: float, troot, status: str) -> None:
        """A run's end on the longitudinal surfaces: the run's wall into
        the ``scan`` latency digest (the trace id as exemplar) and a
        ``scan_end`` frame on the time-series ring; each off by default
        behind one ``is None`` check."""
        if _digest._active is not None:
            _digest.observe(
                self.progress.label, "scan",
                int((time.monotonic() - t_scan) * 1e6),
                trace=(troot["trace"] if troot is not None else None),
                status=status)
        if _timeseries._active is not None:
            _timeseries.tick("scan_end")

    def _adopted(self):
        """The scan's collector installed for one bounded step, only when
        the caller has none of their own (whose scope then folds into the
        registry when it exits)."""
        from ..stats import adopt_stats

        if self._live_stats is not None and current_stats() is None:
            return adopt_stats(self._live_stats)
        return contextlib.nullcontext()

    def _fold_live(self) -> None:
        """Fold the scan collector's counts since the last fold into the
        live registry (at each unit boundary: a read of the registry
        mid-scan sees the units decoded so far) and the same delta into
        the label's ledger; a caller's own collector, whose scope folds
        into the registry when it exits, feeds the ledger through a
        baseline of its own.  The ledger also takes the arena's peak,
        and the progress frames the ledger's view and the armed
        profiler's brief."""
        delta = None
        if self._live_stats is not None:
            delta = self._live_fold.fold(self._live_stats)
        if _profiler._active is not None:
            self.progress.set_profile(_profiler._active.brief())
        led = self._ledger
        if led is None:
            return
        st = current_stats() or self._live_stats
        if st is not None:
            if st is self._live_stats:
                attr_delta = delta or {}
            else:
                if st is not self._attr_src:
                    from ..obs.live import LiveFold

                    self._attr_src = st
                    self._attr_fold = LiveFold()
                attr_delta = self._attr_fold.delta_only(st)
            if attr_delta:
                led.fold_delta(attr_delta)
        from ..kernels.arena import take_arena_peak

        led.note_peak(take_arena_peak())
        view = led.as_dict()
        self.progress.set_attribution({
            "cpu_s": view["cpu_s"],
            "bytes": view["bytes"],
            "peak_arena_bytes": led.peak_arena_bytes,
        })

    def _export_trace(self, troot) -> None:
        """Publish this run's spans and the process's attribution ledgers
        at its end (``TPQ_TRACE_EXPORT``), atomically; best effort."""
        if troot is None or self._trace_export is None:
            return
        tr = _trace._active
        if tr is None:
            return
        from ..obs.attribution import ledgers_snapshot
        from ..obs.export import write_trace_file

        write_trace_file(tr.snapshot(troot["trace"]), self._trace_export,
                         ledgers=ledgers_snapshot(), anchor=tr.anchor())

    def _export_profile(self) -> None:
        """Publish the sampling profile at a run's end
        (``TPQ_PROFILE_EXPORT``), with or without a trace; best
        effort."""
        p = _profiler._active
        if p is None or self._profile_export is None:
            return
        from ..obs.profiler import write_profile_file

        try:
            write_profile_file(p.to_state(), self._profile_export)
        except OSError:
            pass

    def _close_run(self, troot, t_scan: float, state: str,
                   status: str) -> None:
        """A run's end after its last fold and progress frame: the
        digest and ring feeds (``state``), the root span closed with
        ``status``, the trace and the profile exported."""
        self._finish_telemetry(t_scan, troot, state)
        _trace.end_trace(troot, status=status)
        self._export_trace(troot)
        self._export_profile()

    def device_for(self, unit_index: int) -> torch.device:
        return self.devices[unit_index % len(self.devices)]

    def run_iter(self):
        """Yield ``(unit_index, {path: DeviceColumn})`` from the cursor
        position, advancing the cursor past each unit: through
        :func:`pipelined_unit_scan`, or in quarantine mode through
        :func:`resilient_unit_scan`, which skips (and records) the units
        that fail, so the yielded indices name what decoded.  With
        ``resume_from=`` the cursor checkpoints every
        ``checkpoint_every`` units once the consumer has taken them, and
        at the end or on a stop; with a scan deadline the run stops
        between units once it is spent, raising
        ``DeadlineExceededError`` with the cursor flushed."""
        self._run_t0 = time.monotonic()
        nxt, n = self._progress()
        if nxt == 0:
            # a fresh run: the unit forming's pruning counts once (a
            # resumed run's was counted by the run it resumes)
            with self._adopted():
                self._count_pruned()
        units = [self._unit_coords(k) for k in range(n)]
        if self.on_error == "raise":
            gen = pipelined_unit_scan(self.readers, units, self.device_for,
                                      start=nxt, filter=self.filter,
                                      verdicts=self._verdicts)
        else:
            gen = resilient_unit_scan(
                self.readers, units, self.device_for, start=nxt,
                retries=self.retries, quarantine=self.quarantine,
                entry_extra=self._entry_extra(),
                unit_deadline=self.unit_deadline,
                postmortem=self._postmortem_path, filter=self.filter,
                verdicts=self._verdicts)
        yield from self._drive(gen)

    def run(self) -> list[dict[str, DeviceColumn]]:
        """Decode ALL units (position i of the result is unit i; in
        quarantine mode only the units that decoded, :attr:`quarantine`
        naming the rest); the cursor, and the units' quarantine entries,
        reset to the start first."""
        self._advance(-1)
        if self.on_error == "quarantine":
            self.quarantine = QuarantineReport(
                self._open_quarantine.as_dicts())
        return [out for _, out in self.run_iter()]

    def _drive(self, gen):
        """The unit loop around the unit generator ``gen``: a stop
        requested before a unit closes ``gen``, flushes the cursor and
        sets :attr:`stopped`; a quarantined unit (``None``) advances the
        cursor and ticks the progress but is not yielded; a checkpoint
        and the scan deadline's check follow each unit the consumer
        took, and the cursor is flushed at the end.  An early close of
        the loop closes ``gen`` and writes nothing.

        The run is one trace whose root span (``scan``) ends ``ok``,
        ``cancelled`` (a stop or an early close) or ``error``, and one
        run of :attr:`progress` (``done``, ``stopped`` or ``error``);
        each unit runs under the scan's collector when the caller has
        none, takes a flight record and a ``unit`` digest observation,
        and folds into the live registry and the label's ledger."""
        prog = self.progress
        nxt0, n_total = self._progress()
        if prog.units_done != nxt0 or prog.state != "pending":
            # a fresh drive of a used progress (run() after a partial
            # run_iter, a resume, a stopped run continued) restarts the
            # clock and the tallies, resumed units counted as done
            prog.restart(done=nxt0)
        prog.begin()
        troot = None
        if _trace._active is not None:
            troot = _trace.start_trace(prog.label, units=n_total,
                                       resumed_at=nxt0,
                                       usable_cpus=_usable_cpus())
        self._trace_ctx = _trace.ctx_of(troot)
        if self._ledger is not None:
            self._ledger.scans += 1
        t_scan = time.monotonic()
        try:
            with self._adopted():
                self._check_scan_deadline()
            while True:
                if self._stop.is_set():
                    gen.close()
                    with self._adopted():
                        self._flush_checkpoint()
                    self._fold_live()
                    self.stopped = True
                    prog.finish("stopped")
                    self._close_run(troot, t_scan, "stopped", "cancelled")
                    return
                nxt, _ = self._progress()
                prog.unit_started(nxt)
                t_unit = time.monotonic()
                try:
                    with self._adopted():
                        k, out = next(gen)
                except StopIteration:
                    prog.unit_cancelled(nxt)
                    break
                self._advance(k)
                fi, rgi = self._unit_coords(k)
                rows = (self.readers[fi].meta.row_groups[rgi].num_rows
                        if out is not None else 0)
                # staged bytes from the collector that metered the unit:
                # the caller's, else the scan's own
                st = current_stats() or self._live_stats
                prog.unit_done(k, rows=rows, quarantined=out is None,
                               bytes_staged=(st.bytes_staged
                                             if st is not None else None))
                if _flightrec._active is not None:
                    _flightrec.flight(
                        "unit_done" if out is not None
                        else "unit_quarantined", site="shard.scan",
                        unit=k, file=fi, row_group=rgi, rows=rows)
                if _digest._active is not None:
                    _digest.observe(
                        prog.label, "unit",
                        int((time.monotonic() - t_unit) * 1e6),
                        trace=(troot["trace"] if troot is not None
                               else None),
                        unit=k, file=fi, row_group=rgi)
                self._fold_live()
                if out is not None:
                    yield k, out
                with self._adopted():
                    self._maybe_checkpoint()
                    self._check_scan_deadline()
        except GeneratorExit:
            gen.close()  # joins the pipeline's pool at once
            prog.finish("stopped")
            self._fold_live()
            self._close_run(troot, t_scan, "stopped", "cancelled")
            raise
        except BaseException:
            gen.close()
            prog.finish("error")
            self._fold_live()
            self._close_run(troot, t_scan, "error", "error")
            raise
        gen.close()
        with self._adopted():
            self._flush_checkpoint()
        self._fold_live()
        prog.finish("done")
        self._close_run(troot, t_scan, "done", "ok")

    def _check_scan_deadline(self) -> None:
        """The whole scan's budget, checked between units: once spent, the
        cursor is flushed (with checkpoints on), ``deadline_exceeded``
        counts, and DeadlineExceededError is raised: resume to go on."""
        if not self.scan_deadline or self._run_t0 is None:
            return
        elapsed = time.monotonic() - self._run_t0
        if elapsed <= self.scan_deadline:
            return
        from ..deadline import record_expiry

        done, total = self._progress()
        record_expiry(current_stats(), "shard.scan", elapsed,
                      self.scan_deadline, {"next_unit": done})
        record_incident(self._postmortem_path, {
            "kind": "scan_deadline", "site": "shard.scan",
            "elapsed_s": round(elapsed, 3), "budget_s": self.scan_deadline,
            "next_unit": done, "units_total": total})
        self._flush_checkpoint()
        raise DeadlineExceededError(
            f"scan exceeded its {self.scan_deadline:g}s budget at "
            f"unit {done}/{total}; the cursor is intact — resume to "
            "continue",
            elapsed=elapsed, budget=self.scan_deadline, site="shard.scan")

    def request_stop(self) -> None:
        """Ask a running :meth:`run_iter` to stop before its next unit,
        with the durable cursor flushed; :attr:`stopped` then says so.
        Safe from any thread and before the run starts."""
        self._stop.set()

    def cursor_save(self, path: str | None = None) -> None:
        """Checkpoint :meth:`state` durably (:func:`save_cursor_file`) to
        ``path``, by default this scan's checkpoint file."""
        path = path if path is not None else self._checkpoint_path
        if path is None:
            raise ValueError("no checkpoint path: pass path= or "
                             "construct with resume_from=")
        save_cursor_file(self.state(), path)
        self._since_checkpoint = 0

    def _maybe_checkpoint(self) -> None:
        """Called once a unit after the consumer's step returned, so a
        checkpoint covers only units the consumer had: a crash re-decodes
        at most the units since the last checkpoint."""
        if self._checkpoint_path is None:
            return
        self._since_checkpoint += 1
        if self._since_checkpoint >= self._checkpoint_every:
            self.cursor_save()

    def _flush_checkpoint(self) -> None:
        if self._checkpoint_path is not None and self._since_checkpoint:
            self.cursor_save()

    def _gather_placement(self, out_sharding, gather_to):
        """An explicit per-call placement wins; else the scan's default."""
        if out_sharding is not None or gather_to is not None:
            return resolve_out_sharding(self.mesh, out_sharding, gather_to)
        return self.out_sharding

    def gather_column(self, results, path: str, *, out_sharding=None,
                      gather_to=None):
        """:func:`gather_column` over this scan's mesh, with the scan's
        default placement, under the scan's collector and trace context
        (its ``gather`` span joins the last run's trace)."""
        with self._adopted(), _trace.adopt(self._trace_ctx):
            out = gather_column(
                self.mesh, results, path,
                out_sharding=self._gather_placement(out_sharding,
                                                    gather_to))
        self._fold_live()
        return out

    def gather_byte_column(self, results, path: str, *, out_sharding=None,
                           gather_to=None):
        """:func:`gather_byte_column` over this scan's mesh, metered as
        :meth:`gather_column`."""
        with self._adopted(), _trace.adopt(self._trace_ctx):
            out = gather_byte_column(
                self.mesh, results, path,
                out_sharding=self._gather_placement(out_sharding,
                                                    gather_to))
        self._fold_live()
        return out

    def close(self):
        for r in self.readers:
            if r is not None:
                r.close()

    def __enter__(self):
        return self

    def __exit__(self, exc_type, exc, tb):
        self.close()


class ShardedScan(DurableScanMixin):
    """Decode many files' row groups data-parallel across a mesh.

    ``sources`` are paths, bytes or file objects, opened by the scan;
    ``columns`` optionally project.  :meth:`run` decodes every unit on its
    round-robin slot's device and returns per-unit ``{path:
    DeviceColumn}`` dicts, which stay on their devices until gathered.
    The default mesh is :func:`~tpuparquet_torch.shard.mesh.make_mesh`
    over this process's cards; a CPU mesh (``make_mesh(n,
    devices=["cpu"] * n)``) runs every kernel's plain version.

    Resumable: :meth:`state` snapshots a JSON cursor between
    :meth:`run_iter` steps; ``resume=`` continues from it.
    ``resume_from=path`` checkpoints the cursor durably to ``path`` every
    ``checkpoint_every`` units (``TPQ_CHECKPOINT_EVERY``, default 16) and
    at the end, and resumes from it when it exists; :meth:`cursor_save`
    checkpoints at once, :meth:`request_stop` ends a run at the next unit.
    Epoch shuffling: ``shuffle_seed=`` and ``epoch=`` permute the unit
    list deterministically, as the reference does (the same order for the
    same seed and epoch), before the cursor exists.  ``gather_to=`` (a
    device or an index into the local cards; env default
    ``TPQ_GATHER_TO``), ``out_sharding=`` (a ``NamedSharding`` over the
    consumer's mesh, a ``PartitionSpec`` over the scan mesh) or
    ``out_sharding="replicated"`` set the default placement of the
    gathers.

    Faults (``on_error``): ``"raise"`` (the default) aborts at the first
    failure, on the pipelined path.  ``"quarantine"`` decodes each unit on
    its own (transient reads retried with backoff, the device dispatch
    retried ``retries`` times, then the unit's values decoded on the
    host) and isolates a unit that still fails into :attr:`quarantine`
    (a :class:`~tpuparquet_torch.faults.QuarantineReport`), as it does a
    file that fails to open; decoded units are exact or absent.  The
    cursor carries the report.  ``unit_deadline`` (``TPQ_UNIT_DEADLINE_S``;
    quarantine mode only) bounds each unit's decode, and a unit past it
    is quarantined; ``scan_deadline`` (``TPQ_SCAN_DEADLINE_S``) bounds
    the run, checked between units, and raises ``DeadlineExceededError``
    with the cursor intact.  ``salvage=True`` (quarantine mode) keeps a
    torn file's readable row-group prefix (entry ``disposition``
    ``"salvaged"``), ``strict_metadata`` validates each footer, and a
    replica group ``[primary, mirror, ...]`` in ``sources`` hedges its
    chunk reads after ``hedge_delay`` seconds, each read bounded by
    ``read_deadline`` (:func:`open_sources`).

    ``filter=`` (a ``filter.py`` expression) forms units only of the row
    groups its static verdicts keep, and each unit holds only its
    surviving rows (the module docstring); a cursor resumes under the
    same filter, which gives the same units.

    Live telemetry: :attr:`progress` (a :class:`~tpuparquet_torch.obs.
    progress.ScanProgress`) ticks at every unit and is exported to
    ``progress_export`` (default ``TPQ_PROGRESS_EXPORT``, suffixed with
    the label's slug when ``progress_label`` is not ``"scan"``);
    ``progress_label`` also names the scan's gauges, ledger and
    digests."""

    def __init__(self, sources, *columns: str, mesh: Mesh | None = None,
                 resume=None, on_error: str = "raise",
                 retries: int | None = None,
                 salvage: bool = False,
                 strict_metadata: bool | None = None,
                 unit_deadline: float | None = None,
                 scan_deadline: float | None = None,
                 hedge_delay: float | None = None,
                 read_deadline: float | None = None,
                 resume_from: str | None = None,
                 checkpoint_every: int | None = None,
                 progress_export: str | None = None,
                 progress_label: str = "scan",
                 postmortem=None,
                 filter=None,
                 shuffle_seed: int | None = None, epoch: int = 0,
                 out_sharding=None, gather_to=None):
        self._init_durable(on_error=on_error, unit_deadline=unit_deadline,
                           scan_deadline=scan_deadline, resume=resume,
                           resume_from=resume_from,
                           checkpoint_every=checkpoint_every,
                           checkpoint_path=resume_from,
                           postmortem=postmortem)
        self.mesh = mesh if mesh is not None else make_mesh()
        # a bad placement must fail before any source opens
        self.out_sharding = resolve_out_sharding(self.mesh, out_sharding,
                                                 gather_to)
        # the files quarantined when they opened keep their own report,
        # so run() can reset the units' entries without losing them
        self._open_quarantine = QuarantineReport()
        self.readers = open_sources(
            sources, columns, on_error=on_error,
            quarantine=self._open_quarantine, salvage=salvage,
            strict_metadata=strict_metadata, hedge_delay=hedge_delay,
            read_deadline=read_deadline, postmortem=self._postmortem_path)
        self._init_filter(filter, self.readers)
        self.units = scan_units(self.readers, filter=self.filter,
                                verdicts=self._verdicts,
                                pruned=self._pruned)
        # progress_label keys the scan's gauges, ledger, digests and
        # export suffixes: concurrent scans pass distinct labels
        self._init_telemetry(len(self.units), progress_export,
                             progress_label)
        self.shuffle_seed = shuffle_seed
        self.epoch = int(epoch)
        if shuffle_seed is not None:
            import random

            # string-seeded Random hashes with sha512: the reference's
            # permutation, whatever PYTHONHASHSEED is
            random.Random(
                f"{int(shuffle_seed)}:{self.epoch}").shuffle(self.units)
        self.devices = list(self.mesh.devices.flat)
        self.retries = retries
        self.quarantine = QuarantineReport(self._open_quarantine.as_dicts())
        self._next_unit = 0
        if resume is None and resume_from is not None \
                and os.path.exists(resume_from):
            resume = load_cursor_file(resume_from)
        if resume is not None:
            self._load_cursor(resume)

    def _shuffle_identity(self) -> dict:
        if self.shuffle_seed is None:
            return {}
        return {"shuffle": [int(self.shuffle_seed), self.epoch]}

    def _load_cursor(self, cursor: dict) -> None:
        self._next_unit = cursor_load(cursor, self.units, "next_unit",
                                      len(self.units),
                                      **self._shuffle_identity())
        self.quarantine = QuarantineReport.from_dicts(
            cursor.get("quarantine"))
        # the sources were opened again: a file the cursor already lists
        # was rejected again, and must not be listed twice
        self.quarantine.merge_unique(self._open_quarantine.as_dicts())

    def state(self) -> dict:
        """JSON-serializable cursor: resume with ``ShardedScan(sources,
        ..., resume=state)``; decoding restarts at the first unit not yet
        yielded, and the quarantined units and files ride along."""
        return cursor_state(self.units, "next_unit", self._next_unit,
                            quarantine=self.quarantine.as_dicts(),
                            **self._shuffle_identity())

    def _progress(self) -> tuple[int, int]:
        return self._next_unit, len(self.units)

    def _advance(self, k: int) -> None:
        self._next_unit = k + 1

    def _unit_coords(self, k: int) -> tuple[int, int]:
        return self.units[k]

    def run_with_stats(self, events: bool = False):
        """:meth:`run` under a fresh collector: ``(results, stats)``;
        ``events=True`` attaches the per-page event log
        (``stats.events``)."""
        from ..stats import collect_stats

        with collect_stats(events=events) as st:
            results = self.run()
        return results, st


# ----------------------------------------------------------------------
# Gathers
# ----------------------------------------------------------------------

def _shard_major(n_true: int, n_rg: int, sp: int):
    """The reference's shard-major assembly of ``n_true`` round-robin
    units on an (n_rg, sp) mesh: ``(U, blocks, perm)`` — the padded unit
    count ``max(ceil(n_true / n_dev) * n_dev, n_dev)``, each rg block's
    units (those placed on its sp slots) and each unit's assembly row."""
    n_dev = n_rg * sp
    U = max(((n_true + n_dev - 1) // n_dev) * n_dev, n_dev)
    rows_per_block = U // n_rg
    blocks = [[u for u in range(n_true)
               if r * sp <= (u % n_dev) < (r + 1) * sp]
              for r in range(n_rg)]
    perm = np.empty(n_true, dtype=np.int64)
    for r, mine in enumerate(blocks):
        perm[mine] = r * rows_per_block + np.arange(len(mine))
    return U, blocks, perm


def _nbytes(shape, dtype) -> int:
    return int(np.prod(shape, dtype=np.int64)) * (
        torch.empty((), dtype=dtype).element_size())


def _count_gather(arrays, placement, mesh: Mesh) -> None:
    """Meter one gather as the reference does, off the output
    placements: ``gather_bytes_moved`` sums what every destination slot
    received (one slot's shard times the slots), and
    ``gather_bytes_replicated`` the excess over one copy of each global
    byte.  A replicated gather lands the whole global on each of the
    scan mesh's slots, a single device takes it once, a
    :class:`~tpuparquet_torch.shard.mesh.NamedSharding` gives each slot
    of its mesh its shard (padding included)."""
    st = current_stats()
    if st is None:
        return
    for a in arrays:
        nb = _nbytes(a.shape, a.dtype)
        if placement is None:
            per, slots = nb, mesh.devices.size
        elif isinstance(placement, NamedSharding):
            per = _nbytes(placement.shard_shape(a.shape), a.dtype)
            slots = placement.mesh.devices.size
        else:
            per, slots = nb, 1
        st.gather_bytes_moved += per * slots
        st.gather_bytes_replicated += max(0, per * slots - nb)


def _sync(devices) -> None:
    for d in devices:
        if d.type == "cuda":
            torch.cuda.synchronize(d)


def _dim0_only(placement) -> bool:
    """Does the placement split nothing but the unit axis?  Then a unit's
    whole row lives on each of its destination slots, and the gather may
    assemble straight onto them (:func:`_assemble_direct`)."""
    if isinstance(placement, NamedSharding):
        return all(placement.spec[i] is None
                   for i in range(1, len(placement.spec)))
    return True  # a single device


def _outside_mesh(placement, mesh: Mesh) -> bool:
    """Does the placement's device set differ from the scan mesh's?"""
    if isinstance(placement, NamedSharding):
        return placement.device_set != set(mesh.devices.flat)
    return placement not in mesh.distinct_devices()


def _assemble_and_gather(mesh: Mesh, n_true: int, streams, fill,
                         placement=None, out_row_shapes=None):
    """Assemble per-unit rows into ``(U, *row)`` globals and reshard them.

    ``streams`` is a list of ``(row_shape, dtype)``; ``fill(u, rows)``
    writes unit u's padded rows (one flat tensor a stream, on the unit's
    rg block device) in place.  Units are grouped shard-major, as in the
    reference: rg block r holds the units placed on its sp slots, on the
    device of its first slot; padding rows are zero.  Then, timed as
    ``gather_reshard_s``:

    * ``placement is None`` — each block is copied to every other
      distinct device of the mesh (the all-gather);
    * ``placement`` a device of the mesh — the blocks are copied to it
      and KS4 permutes the rows to unit order, rows past ``n_true`` zero;
    * a :class:`~tpuparquet_torch.shard.mesh.NamedSharding` over the scan
      mesh's devices, or one that splits more than the unit axis — the
      blocks are copied to the mesh's first device, KS4 permutes them to
      unit order (the unit axis padded with zero rows to a multiple of
      :func:`~tpuparquet_torch.shard.mesh.dim0_partitions`), and each
      slot of the consumer's mesh takes a copy of its shard;
    * a placement outside the mesh that splits only the unit axis (a sink
      device such as the host beside a mesh of cards, or a consumer
      mesh of other devices) — no global is built: each unit's row
      fills on its own slot's device, and the copies of the rows to their
      destination slots are the reshard (:func:`_assemble_direct`).

    ``out_row_shapes`` reshapes each stream's rows in a placed output.
    Returns ``(arrays, perm)``: replicated, ``arrays[i]`` is the global on
    the mesh's first device in assembly order and ``perm`` maps unit ->
    row; placed, ``arrays[i]`` is in unit order (a tensor on the device,
    or a :class:`~tpuparquet_torch.shard.mesh.ShardedTensor`)."""
    n_rg = mesh.shape["rg"]
    sp = mesh.shape.get("sp", 1)
    grid = mesh.devices.reshape(n_rg, sp)
    n_dev = n_rg * sp
    U, blocks, perm = _shard_major(n_true, n_rg, sp)
    t_parts = 1
    if placement is not None:
        t_parts = dim0_partitions(placement)
        while U % t_parts:
            U += n_dev
        if _outside_mesh(placement, mesh) and _dim0_only(placement):
            if getattr(placement, "type", None) == "meta":
                raise ValueError(f"gather_to={placement}: a meta device "
                                 "holds no data")
            slots = list(mesh.devices.flat)

            def unit_rows(u):
                rows = [torch.empty(tuple(shape), dtype=dtype,
                                    device=slots[u % len(slots)])
                        for shape, dtype in streams]
                fill(u, [r.view(-1) for r in rows])
                return rows

            padded = [unit_rows(u) for u in range(n_true)]
            st = current_stats()
            _sync(dict.fromkeys(slots))
            t0 = time.perf_counter()
            # stage marker over the window the gather span times
            ptok = _profiler.stage_begin("gather") \
                if _profiler._active is not None else None
            try:
                out = _assemble_direct(
                    placement,
                    [([rows[i] for rows in padded], shape, dtype)
                     for i, (shape, dtype) in enumerate(streams)],
                    n_true, t_parts, out_row_shapes)
                _sync(placement_devices(placement))
            finally:
                if ptok is not None:
                    _profiler.stage_end(ptok)
            t1 = time.perf_counter()
            if st is not None:
                st.gather_reshard_s += t1 - t0
            if _trace._active is not None:
                _trace.emit_span("gather", t0, t1 - t0, streams=len(out),
                                 direct=True)
            _count_gather(out, placement, mesh)
            return list(out), np.arange(n_true, dtype=np.int64)
    rpb = U // n_rg
    homes = [grid[r, 0] for r in range(n_rg)]
    named = isinstance(placement, NamedSharding)
    place_dev = grid[0, 0] if named else placement
    dests = (mesh.distinct_devices() if placement is None
             else list(dict.fromkeys(homes + [place_dev])))
    glob = {d: [torch.empty((U,) + tuple(shape), dtype=dtype, device=d)
                for shape, dtype in streams] for d in dests}
    for r, mine in enumerate(blocks):
        home = glob[homes[r]]
        for j, u in enumerate(mine):
            fill(u, [g[r * rpb + j].view(-1) for g in home])
        for g in home:
            g[r * rpb + len(mine) : (r + 1) * rpb] = 0
    st = current_stats()
    _sync(dests)
    t0 = time.perf_counter()
    ptok = _profiler.stage_begin("gather") \
        if _profiler._active is not None else None
    try:
        targets = dests if placement is None else [place_dev]
        for r in range(n_rg):
            rows = slice(r * rpb, (r + 1) * rpb)
            for d in targets:
                if d != homes[r]:
                    for g, src in zip(glob[d], glob[homes[r]]):
                        g[rows].copy_(src[rows])
        synced = targets
        if placement is None:
            out = glob[dests[0]]
        else:
            u_out = -(-max(n_true, 1) // t_parts) * t_parts
            out = [place_rows(g, perm, n_true, u_out)
                   for g in glob[place_dev]]
            if out_row_shapes is not None:
                out = [o.view((u_out,) + tuple(shp))
                       for o, shp in zip(out, out_row_shapes)]
            if named:
                out = [_cut_shards(o, placement) for o in out]
                synced = placement_devices(placement)
        _sync(dict.fromkeys(synced))
    finally:
        if ptok is not None:
            _profiler.stage_end(ptok)
    t1 = time.perf_counter()
    if st is not None:
        st.gather_reshard_s += t1 - t0
    if _trace._active is not None:
        _trace.emit_span("gather", t0, t1 - t0, streams=len(out),
                         placement=("replicated" if placement is None
                                    else "placed"))
    _count_gather(out, placement, mesh)
    return out, perm


def _cut_shards(full: torch.Tensor, sharding) -> ShardedTensor:
    """Each slot of ``sharding``'s mesh takes a copy of its piece of the
    unit-ordered global ``full`` (slots that share a device get their own
    copies, as the pieces of a sharded array are separate buffers)."""
    shards = []
    for dev, idx in sharding.slot_indices(full.shape):
        piece = full[idx]
        shards.append(Shard(dev, idx, torch.empty(
            piece.shape, dtype=full.dtype, device=dev).copy_(piece)))
    return ShardedTensor(full.shape, full.dtype, sharding, shards)


def _assemble_direct(placement, streams, n_true: int, t_parts: int = 1,
                     out_row_shapes=None):
    """Assembly onto a target outside the scan mesh that splits only the
    unit axis: each unit's padded row is copied once to each of its
    destination slots and stacked there in unit order; rows at or past
    ``n_true`` are zero, and the unit axis pads to a multiple of
    ``t_parts`` (at least one row).  No permute runs and no global is
    built.  ``streams`` is a list of ``(rows, row_shape, dtype)``,
    ``rows[u]`` unit u's padded row on any device; ``out_row_shapes``
    reshapes each stream's rows.  Returns one tensor a stream on a single
    device, or a :class:`~tpuparquet_torch.shard.mesh.ShardedTensor` a
    stream over a consumer mesh.

    A host slot fed from cards gets pinned memory, so each row's copy is
    one asynchronous DMA; the cards are synchronised once at the end."""
    u_out = -(-max(n_true, 1) // t_parts) * t_parts
    srcs = list(dict.fromkeys(r.device for rows, _, _ in streams
                              for r in rows[:n_true]))
    from_card = any(d.type == "cuda" for d in srcs)
    named = isinstance(placement, NamedSharding)
    outs = []
    for i, (rows, row_shape, dtype) in enumerate(streams):
        shp = tuple(row_shape if out_row_shapes is None
                    else out_row_shapes[i])
        gshape = (u_out,) + shp
        slots = (placement.slot_indices(gshape) if named
                 else [(placement, (slice(None),))])
        shards = []
        for dev, idx in slots:
            lo = idx[0].start or 0
            hi = u_out if idx[0].stop is None else idx[0].stop
            pin = dev.type == "cpu" and from_card
            out = torch.empty((hi - lo,) + tuple(row_shape), dtype=dtype,
                              device=dev, pin_memory=pin)
            for u in range(lo, min(hi, n_true)):
                out[u - lo].copy_(rows[u].view(tuple(row_shape)),
                                  non_blocking=pin)
            out[max(min(hi, n_true) - lo, 0):] = 0
            shards.append(Shard(dev, idx, out.view((hi - lo,) + shp)))
        outs.append(ShardedTensor(gshape, dtype, placement, shards) if named
                    else shards[0].data)
    if from_card:
        _sync(srcs)
    return tuple(outs)


def gather_column(mesh: Mesh, results: list, path: str, *,
                  out_sharding=None, gather_to=None):
    """Gather one fixed-width column across the mesh.

    Each unit's values densify straight into its row of its rg block
    (KS1: null slots 0, units padded to a common length L), then:

    * default — replicated: returns ``(values (U, L, lanes) u32 ndarray,
      per-unit true counts)``, the reference's contract;
    * ``gather_to=`` (a device, or an index into the local cards) — the
      column assembles on that device in unit order (KS4 on a device of
      the mesh; copies of each unit's row to a device outside it):
      returns ``(values, counts)`` with ``values`` a ``(U', L, lanes)``
      int32 tensor (u32 bits) on it, rows ``>= len(counts)`` zero;
    * ``out_sharding=`` a :class:`~tpuparquet_torch.shard.mesh.
      NamedSharding` over the consumer's mesh (or a bare
      :class:`~tpuparquet_torch.shard.mesh.PartitionSpec` over the scan
      mesh) — ``values`` is a :class:`~tpuparquet_torch.shard.mesh.
      ShardedTensor` of shape ``(U', L, lanes)`` under it, ``U'`` the
      unit count padded to a multiple of the spec's unit-axis partitions
      (padding rows zero); a later dimension the spec splits must
      divide.

    Metered as ``gather_bytes_moved`` / ``gather_bytes_replicated`` /
    ``gather_reshard_s``."""
    placement = resolve_out_sharding(mesh, out_sharding, gather_to,
                                     env_default=False)
    cols = [r[path] for r in results]
    if any(c.offsets is not None for c in cols):
        raise TypeError("gather_column handles fixed-width columns; "
                        "use gather_byte_column for BYTE_ARRAY")
    lanes = cols[0].lanes if cols else 1
    if any(c.lanes != lanes for c in cols):
        raise TypeError("gather_column units disagree on value width")
    counts = np.asarray([c.num_values for c in cols], dtype=np.int64)
    L = int(counts.max()) if len(counts) else 0

    def fill(u, rows):
        c = cols[u]
        dev = rows[0].device
        implicit = c._mask_p is None and c._pos_p is None
        scatter_to_dense(
            c.data.to(dev), None if implicit else c.mask.to(dev),
            None if implicit else c.positions.to(dev), lanes, out=rows[0])

    (gathered,), perm = _assemble_and_gather(
        mesh, len(cols), [((L * lanes,), torch.int32)], fill, placement,
        out_row_shapes=[(L, lanes)])
    if placement is not None:
        return gathered, counts
    out = gathered.cpu().numpy().view(np.uint32).reshape(
        gathered.shape[0], L, lanes)
    return out[perm], counts


def gather_byte_column(mesh: Mesh, results: list, path: str, *,
                       out_sharding=None, gather_to=None):
    """Gather one BYTE_ARRAY column across the mesh.

    Each unit densifies straight into its rows of its rg block (KS3):
    null slots become zero-length values, the offsets (per-unit relative,
    from 0) are edge-padded to Lmax + 1 with the unit's byte total, the
    bytes zero-padded to Bmax.  Placement as :func:`gather_column`; under
    a ``NamedSharding`` the offsets and the data land on the same slots,
    row for row, so the per-unit offsets need no rebase.
    Returns ``(offsets (U, Lmax + 1) int32, data (U, Bmax) u8,
    row_counts, byte_counts)``: numpy arrays when replicated, tensors on
    the target or :class:`~tpuparquet_torch.shard.mesh.ShardedTensor`\\ s
    (rows ``>= len(row_counts)`` zero) when placed.  Row i of
    unit u spans ``data[u, offsets[u, i]:offsets[u, i + 1]]``."""
    placement = resolve_out_sharding(mesh, out_sharding, gather_to,
                                     env_default=False)
    cols = [r[path] for r in results]
    if any(c.offsets is None for c in cols):
        raise TypeError("gather_byte_column handles BYTE_ARRAY columns; "
                        "use gather_column for fixed-width types")
    row_counts = np.asarray([c.num_values for c in cols], dtype=np.int64)
    byte_counts = np.asarray([c.n_bytes for c in cols], dtype=np.int64)
    L = int(row_counts.max()) + 1 if len(cols) else 1
    B = max(int(byte_counts.max()), 1) if len(cols) else 1

    def fill(u, rows):
        c = cols[u]
        dev = rows[0].device
        implicit = c.num_values == c.n_packed and c._mask_p is None
        byte_densify(c.offsets[: c.n_packed + 1].to(dev), c.n_packed,
                     None if implicit else c.mask.to(dev),
                     None if implicit else c.positions.to(dev),
                     c.data.to(dev), rows[0], rows[1])

    (o_g, d_g), perm = _assemble_and_gather(
        mesh, len(cols), [((L,), torch.int32), ((B,), torch.uint8)], fill,
        placement)
    if placement is not None:
        return o_g, d_g, row_counts, byte_counts
    return (o_g.cpu().numpy()[perm], d_g.cpu().numpy()[perm], row_counts,
            byte_counts)
