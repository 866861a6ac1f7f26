"""Decode counters of the device read path.

``with collect_stats() as st:`` around a read collects, on the calling
thread, the phase split of :func:`~tpuparquet_torch.kernels.device.
read_row_groups_device`: host planning (``plan_s``: page walk,
decompression, run-table scans), staging (``transfer_s``: pinned host
slab + one host-to-device copy per row group), device work
(``dispatch_s``: kernel launches up to the row group's fence) and the
bytes that crossed to the device (``bytes_staged``, counted as the JAX
stager counts them: each array at its staged length, padded by the
JAX piece split unless its plan fixed its length — run and token
tables, token literals, byte planes — though bytes ride the slab
zero-padded to whole words; BYTE_ARRAY offsets, uploaded on their own
as in the reference, are not counted), and the PLAIN pages each wire
transport carried, under the JAX package's counter names
(``pages_device_planes``, ``pages_device_delta_lanes``,
``pages_device_snappy``).  On the write side, ``pages_device_encoded``
counts the data pages whose values encoded on the device
(:class:`~tpuparquet_torch.kernels.encode.DeviceValues`), the JAX name.
``pages_host_values`` counts the data pages whose values no device kernel
takes (an encoding the device plan lacks for the column's type), decoded
on the host and staged as they are.

The writer counts, as the reference does: ``pages_written`` (every page,
dictionary pages included, on either page path), ``pages_assembled_native``
(the data pages whose body the one-pass C pipeline assembled,
``io/pages.py`` ``_write_page_native``), and that pipeline's seconds a
stage: ``write_encode_s`` (levels and values into one buffer),
``write_compress_s`` (the block compression and the page CRC) and
``write_assemble_s`` (the header and the writes); the pure page path
counts none of them.

``pages_crc_verified`` counts the pages whose header CRC was checked and
matched, ``crc_mismatches`` those that did not (the read then raises).
The gathers of ``shard/scan.py`` count, as in the reference:
``gather_bytes_moved``, the bytes of the gathered arrays that landed on
their destinations, summed over the destination slots of the mesh
(padding included; a replicated gather pays the array's bytes once per
slot, even where slots share one card); ``gather_bytes_replicated``, the
share of those that is a copy beyond the first; ``gather_reshard_s``, the
wall of the reshard step (the copies between the mesh's devices and the
placing kernel, after the rows were assembled; on a sink outside the
mesh, the copies of the units' rows to it).

``bytes_read`` and ``read_s`` count the chunk bytes the reader fetched
(zero-copy views of an in-memory source and range reads of a path
alike) and the wall spent fetching them.  ``plan_cache_hits``,
``plan_cache_misses`` and ``plan_cache_evictions`` count the plan cache's
lookups and LRU drops (``kernels/plancache.py``; all 0 while it is off).

``codec_split_blocks`` counts the blocks a GZIP or ZSTD page body was
split into on the write side, ``codec_split_frames`` the ZSTD frames
decoded one a worker on the read side (``compress.py``); a split body
read with one frame a worker counts as many frames as it was written
with blocks.

The device planner counts, as the reference does: ``chunks``,
``bytes_compressed``, ``bytes_uncompressed`` and ``values`` (the footer's
``num_values``, level slots included) a column chunk, ``pages`` a data
page, and ``row_groups`` a row group, on the coordinating thread once
its columns are merged.  ``checkpoints_written`` counts the durable scan
cursors written (``shard/scan.py`` ``save_cursor_file``).  ``wall_s`` is
the wall of the :func:`collect_stats` scope, set when it exits.

The fault layer counts under the reference's names: ``faults_injected``
(faults an ``inject_faults`` scope delivered), ``io_retries`` (retries of
a transient read, ``faults.retry_transient``), ``dispatch_retries`` and
``units_degraded`` (the resilient read's dispatch retries, and the units
it then decoded on the host), ``pages_degraded`` (data pages planned
with their values decoded on the host), ``units_quarantined`` and
``files_quarantined`` (what a quarantining scan isolated),
``deadline_exceeded`` (watched operations past their budget,
``deadline.py``), ``hedges_issued`` and ``hedges_won`` (replica reads a
hedged chunk read launched after its hedge delay, and those whose result
was used, ``deadline.hedged_call``).  The file-level robustness layer
counts ``files_salvaged`` and ``row_groups_recovered`` (files opened
through salvage, ``format/recover.py``, and the row groups they kept)
and ``metadata_rejects`` (footers the strict metadata check refused,
``format/validate.py``).  A failed attempt of the resilient read or of a
deadline worker folds in only :data:`_FAULT_OBSERVABILITY_FIELDS`
(:func:`merge_worker_stats`).

Remote sources count, as the reference does: ``remote_ranges_fetched``
(range requests issued to a byte-range source after coalescing; a cache
hit issues none), ``ranges_coalesced`` (requests a coalesced span saved:
a prefetch of R ranges fetched as M spans adds M and R - M),
``remote_bytes`` (the payload of every request issued, gap bytes
included) and ``remote_retry`` (the retry ladder's re-issues against a
remote source, the twin of ``io_retries``).  The range caches
(``io/rangecache.py``) count ``cache_{hits,misses,evictions}_{mem,disk}``
on the calling thread's collector: a tier's hits and misses add up to
its lookups.  A dataset scan counts ``dataset_files_pruned`` (files its
partition filter skipped, never opened) and ``dataset_orphans_swept``
(staging files and broken journals moved to ``_quarantine/``).

Predicate pushdown (``filter.py``) counts, as the reference does:
``row_groups_pruned`` (row groups a verdict skipped whole),
``pages_pruned`` (data pages skipped inside kept row groups, summed over
the chunks), ``rows_pruned`` (the rows of pruned row groups, and of each
kept row group the rows outside its page-index candidates, once a row
group), ``bloom_hits`` (bloom probes that answered "absent"),
``filter_rows_in`` and ``filter_rows_out`` (rows that entered the exact
predicate, and those that survived it).  :meth:`DecodeStats.summary`
reads them out.

:meth:`DecodeStats.to_state` and :meth:`DecodeStats.from_state` are the
exact wire form that ``shard/distributed.py`` ``allgather_stats`` folds
across processes: every counter unrounded, ``wall_s``, and the
histograms.

Telemetry (``obs/``): a collector records named log2-bucket histograms
(:meth:`DecodeStats.hist`: ``page_comp_bytes``, ``page_uncomp_bytes``,
``wire_ratio_permille``, ``stager_wave_us``) whenever it is active, and
``collect_stats(events=True)`` attaches a per-page event log
(``st.events``, ``obs/events.py``).  Every outermost :func:`collect_stats`
scope folds into the process's live metrics registry when it exits
(``obs/live.py`` :func:`~tpuparquet_torch.obs.live.fold_stats`, off with
``TPQ_LIVE_METRICS=0``); :func:`adopt_stats` lets the scan drivers meter
units into a collector of their own when the caller has none.

Planning runs on a pool of worker threads (``kernels/device.py``
``pipelined_reads``): each column's plan counts into a collector of its
own (:func:`worker_stats`), which the coordinating thread folds into its
collector (:meth:`DecodeStats.merge_from`) once the task has succeeded,
so no count is lost and none is counted twice.  ``plan_s`` is then the
worker-seconds of planning summed over the workers, which may exceed the
wall of the read.
"""

from __future__ import annotations

import contextlib
import threading
import time
from dataclasses import dataclass, field, fields

__all__ = ["DecodeStats", "adopt_stats", "collect_stats", "current_stats",
           "merge_worker_stats", "trace", "worker_stats"]


@dataclass
class DecodeStats:
    row_groups: int = 0
    chunks: int = 0
    pages: int = 0
    values: int = 0
    bytes_compressed: int = 0
    bytes_uncompressed: int = 0
    bytes_staged: int = 0
    plan_s: float = 0.0
    transfer_s: float = 0.0
    dispatch_s: float = 0.0
    pages_device_planes: int = 0
    pages_device_delta_lanes: int = 0
    pages_device_snappy: int = 0
    pages_device_encoded: int = 0
    pages_host_values: int = 0
    pages_crc_verified: int = 0
    crc_mismatches: int = 0
    gather_bytes_moved: int = 0
    gather_bytes_replicated: int = 0
    gather_reshard_s: float = 0.0
    bytes_read: int = 0
    read_s: float = 0.0
    plan_cache_hits: int = 0
    plan_cache_misses: int = 0
    plan_cache_evictions: int = 0
    codec_split_blocks: int = 0
    codec_split_frames: int = 0
    checkpoints_written: int = 0
    # the fault layer (faults.py, deadline.py, the resilient read and the
    # quarantining scan)
    faults_injected: int = 0
    io_retries: int = 0
    dispatch_retries: int = 0
    pages_degraded: int = 0
    units_degraded: int = 0
    units_quarantined: int = 0
    # the file-level robustness layer (format/validate.py, recover.py)
    files_salvaged: int = 0
    row_groups_recovered: int = 0
    files_quarantined: int = 0
    metadata_rejects: int = 0
    deadline_exceeded: int = 0
    hedges_issued: int = 0
    hedges_won: int = 0
    # remote byte-range sources (io/source.py, io/rangecache.py)
    remote_ranges_fetched: int = 0
    ranges_coalesced: int = 0
    remote_bytes: int = 0
    remote_retry: int = 0
    cache_hits_mem: int = 0
    cache_misses_mem: int = 0
    cache_evictions_mem: int = 0
    cache_hits_disk: int = 0
    cache_misses_disk: int = 0
    cache_evictions_disk: int = 0
    # partitioned datasets (dataset/)
    dataset_files_pruned: int = 0
    dataset_orphans_swept: int = 0
    # predicate pushdown (filter.py)
    row_groups_pruned: int = 0
    pages_pruned: int = 0
    rows_pruned: int = 0
    bloom_hits: int = 0
    filter_rows_in: int = 0
    filter_rows_out: int = 0
    # the write pipeline (io/pages.py)
    pages_written: int = 0
    pages_assembled_native: int = 0
    # (walls: merged and shipped, not compared by ``==``)
    write_encode_s: float = field(default=0.0, compare=False)
    write_compress_s: float = field(default=0.0, compare=False)
    write_assemble_s: float = field(default=0.0, compare=False)
    # the owning scope's wall: never merged (a worker's is not the
    # scope's), and not compared (two scopes of equal counts are equal)
    wall_s: float = field(default=0.0, compare=False)
    # telemetry (obs/): named log2-bucket histograms, recorded whenever
    # this collector is active, and the per-page event log, attached
    # only by collect_stats(events=True); neither is compared
    hists: dict = field(default_factory=dict, compare=False, repr=False)
    events: object = field(default=None, compare=False, repr=False)

    def merge_from(self, other: "DecodeStats") -> None:
        """Fold a worker collector's counts into this one (on the
        coordinating thread, after the worker is joined); ``wall_s`` stays
        this scope's.  Histograms merge bucket by bucket, and the
        worker's event log appends to this one."""
        for f in _MERGE_FIELDS:
            setattr(self, f, getattr(self, f) + getattr(other, f))
        for name, h in other.hists.items():
            self.hist(name).merge_from(h)
        if other.events is not None and self.events is not None:
            self.events.merge_from(other.events)

    def hist(self, name: str):
        """The named histogram (``obs.histogram.Histogram``), created at
        first use."""
        h = self.hists.get(name)
        if h is None:
            from .obs.histogram import Histogram

            h = self.hists[name] = Histogram()
        return h

    def histograms_dict(self) -> dict:
        """Sparse JSON form of every recorded histogram."""
        return {name: h.as_dict() for name, h in sorted(self.hists.items())}

    @property
    def values_per_sec(self) -> float:
        return self.values / self.wall_s if self.wall_s > 0 else 0.0

    @property
    def compression_ratio(self) -> float:
        if self.bytes_compressed == 0:
            return 1.0
        return self.bytes_uncompressed / self.bytes_compressed

    def as_dict(self) -> dict:
        """Every counter by name, the walls rounded to microseconds, and
        the derived selectivity, values a second and compression
        ratio (the profile's and the tools' view)."""
        return {
            "row_groups": self.row_groups,
            "chunks": self.chunks,
            "pages": self.pages,
            "pages_device_snappy": self.pages_device_snappy,
            "pages_device_planes": self.pages_device_planes,
            "pages_device_delta_lanes": self.pages_device_delta_lanes,
            "pages_device_encoded": self.pages_device_encoded,
            "pages_host_values": self.pages_host_values,
            "values": self.values,
            "bytes_compressed": self.bytes_compressed,
            "bytes_uncompressed": self.bytes_uncompressed,
            "bytes_staged": self.bytes_staged,
            "bytes_read": self.bytes_read,
            "read_s": round(self.read_s, 6),
            "pages_crc_verified": self.pages_crc_verified,
            "crc_mismatches": self.crc_mismatches,
            "faults_injected": self.faults_injected,
            "io_retries": self.io_retries,
            "dispatch_retries": self.dispatch_retries,
            "pages_degraded": self.pages_degraded,
            "units_degraded": self.units_degraded,
            "units_quarantined": self.units_quarantined,
            "files_salvaged": self.files_salvaged,
            "row_groups_recovered": self.row_groups_recovered,
            "files_quarantined": self.files_quarantined,
            "metadata_rejects": self.metadata_rejects,
            "deadline_exceeded": self.deadline_exceeded,
            "hedges_issued": self.hedges_issued,
            "hedges_won": self.hedges_won,
            "checkpoints_written": self.checkpoints_written,
            "pages_written": self.pages_written,
            "pages_assembled_native": self.pages_assembled_native,
            "write_encode_s": round(self.write_encode_s, 6),
            "write_compress_s": round(self.write_compress_s, 6),
            "write_assemble_s": round(self.write_assemble_s, 6),
            "codec_split_blocks": self.codec_split_blocks,
            "codec_split_frames": self.codec_split_frames,
            "row_groups_pruned": self.row_groups_pruned,
            "pages_pruned": self.pages_pruned,
            "rows_pruned": self.rows_pruned,
            "bloom_hits": self.bloom_hits,
            "dataset_files_pruned": self.dataset_files_pruned,
            "dataset_orphans_swept": self.dataset_orphans_swept,
            "filter_rows_in": self.filter_rows_in,
            "filter_rows_out": self.filter_rows_out,
            "selectivity": round(
                self.filter_rows_out / self.filter_rows_in, 6)
            if self.filter_rows_in else None,
            "gather_bytes_moved": self.gather_bytes_moved,
            "gather_bytes_replicated": self.gather_bytes_replicated,
            "gather_reshard_s": round(self.gather_reshard_s, 6),
            "plan_cache_hits": self.plan_cache_hits,
            "plan_cache_misses": self.plan_cache_misses,
            "plan_cache_evictions": self.plan_cache_evictions,
            "remote_ranges_fetched": self.remote_ranges_fetched,
            "ranges_coalesced": self.ranges_coalesced,
            "remote_bytes": self.remote_bytes,
            "remote_retry": self.remote_retry,
            "cache_hits_mem": self.cache_hits_mem,
            "cache_misses_mem": self.cache_misses_mem,
            "cache_evictions_mem": self.cache_evictions_mem,
            "cache_hits_disk": self.cache_hits_disk,
            "cache_misses_disk": self.cache_misses_disk,
            "cache_evictions_disk": self.cache_evictions_disk,
            "plan_s": round(self.plan_s, 6),
            "transfer_s": round(self.transfer_s, 6),
            "dispatch_s": round(self.dispatch_s, 6),
            "wall_s": round(self.wall_s, 6),
            "values_per_sec": round(self.values_per_sec, 1),
            "compression_ratio": round(self.compression_ratio, 3),
        }

    def summary(self) -> str:
        """One line: what was decoded and how fast, then a clause for
        each layer that counted something (FAULTS, TIME, WRITE, PRUNE,
        GATHER, PLAN CACHE, REMOTE, SALVAGE)."""
        d = self.as_dict()
        return (
            f"decoded {d['values']:,} values in {d['pages']} pages / "
            f"{d['chunks']} chunks / {d['row_groups']} row groups; "
            f"{d['bytes_compressed']:,}B -> {d['bytes_uncompressed']:,}B "
            f"(x{d['compression_ratio']}); "
            f"{d['wall_s']:.4f}s = {d['values_per_sec']:,.0f} values/s"
            + (f"; staged {d['bytes_staged']:,}B to device"
               if d["bytes_staged"] else "")
            + (f"; plan {d['plan_s']:.3f}s / transfer "
               f"{d['transfer_s']:.3f}s / dispatch {d['dispatch_s']:.3f}s"
               if d["transfer_s"] else "")
            + (f"; crc verified {d['pages_crc_verified']} pages"
               if d["pages_crc_verified"] else "")
            + (f"; FAULTS: {d['crc_mismatches']} crc mismatches, "
               f"{d['faults_injected']} injected, "
               f"{d['io_retries']} io retries, "
               f"{d['dispatch_retries']} dispatch retries, "
               f"{d['pages_degraded']}p/{d['units_degraded']}u degraded "
               f"to host, {d['units_quarantined']} quarantined"
               if (d["crc_mismatches"] or d["faults_injected"]
                   or d["io_retries"] or d["dispatch_retries"]
                   or d["pages_degraded"] or d["units_degraded"]
                   or d["units_quarantined"]) else "")
            + (f"; TIME: {d['deadline_exceeded']} deadlines exceeded, "
               f"{d['hedges_issued']} hedges issued "
               f"({d['hedges_won']} won), "
               f"{d['checkpoints_written']} checkpoints"
               if (d["deadline_exceeded"] or d["hedges_issued"]
                   or d["checkpoints_written"]) else "")
            + (f"; WRITE: {d['pages_written']} pages "
               f"({d['pages_assembled_native']} native), "
               f"encode {d['write_encode_s']:.3f}s / compress "
               f"{d['write_compress_s']:.3f}s / assemble "
               f"{d['write_assemble_s']:.3f}s"
               + (f", {d['codec_split_blocks']} split blocks"
                  if d["codec_split_blocks"] else "")
               if d["pages_written"] else "")
            + (f"; {d['codec_split_frames']} codec frames "
               f"decoded parallel" if d["codec_split_frames"] else "")
            + (f"; PRUNE: {d['row_groups_pruned']} row groups / "
               f"{d['pages_pruned']} pages / {d['rows_pruned']} rows "
               f"pruned, {d['bloom_hits']} bloom hits"
               + (f", selectivity {d['selectivity']:.4f} "
                  f"({d['filter_rows_out']:,}/{d['filter_rows_in']:,})"
                  if d["filter_rows_in"] else "")
               if (d["row_groups_pruned"] or d["pages_pruned"]
                   or d["rows_pruned"] or d["bloom_hits"]
                   or d["filter_rows_in"]) else "")
            + (f"; GATHER: {d['gather_bytes_moved']:,}B to consumers "
               f"({d['gather_bytes_replicated']:,}B replication), "
               f"reshard {d['gather_reshard_s']:.3f}s"
               if (d["gather_bytes_moved"] or d["gather_reshard_s"])
               else "")
            + (f"; PLAN CACHE: {d['plan_cache_hits']} hits / "
               f"{d['plan_cache_misses']} misses / "
               f"{d['plan_cache_evictions']} evictions"
               if (d["plan_cache_hits"] or d["plan_cache_misses"]
                   or d["plan_cache_evictions"]) else "")
            + (f"; REMOTE: {d['remote_ranges_fetched']} ranges "
               f"({d['ranges_coalesced']} coalesced away), "
               f"{d['remote_bytes']:,}B fetched, "
               f"{d['remote_retry']} retries; cache mem "
               f"{d['cache_hits_mem']}/{d['cache_misses_mem']}"
               f"/{d['cache_evictions_mem']} disk "
               f"{d['cache_hits_disk']}/{d['cache_misses_disk']}"
               f"/{d['cache_evictions_disk']} (hit/miss/evict)"
               if (d["remote_ranges_fetched"] or d["remote_retry"]
                   or d["cache_hits_mem"] or d["cache_misses_mem"]
                   or d["cache_hits_disk"] or d["cache_misses_disk"])
               else "")
            + (f"; SALVAGE: {d['files_salvaged']} files salvaged "
               f"({d['row_groups_recovered']} row groups recovered), "
               f"{d['files_quarantined']} files quarantined, "
               f"{d['metadata_rejects']} metadata rejects"
               if (d["files_salvaged"] or d["files_quarantined"]
                   or d["metadata_rejects"]) else "")
        )

    def to_state(self) -> dict:
        """The exact JSON-serializable state: every counter unrounded,
        ``wall_s`` and the histograms (the event log does not ship)."""
        d = {f: getattr(self, f) for f in _MERGE_FIELDS}
        d["wall_s"] = self.wall_s
        if self.hists:
            d["hists"] = self.histograms_dict()
        return d

    @classmethod
    def from_state(cls, d: dict) -> "DecodeStats":
        """A collector from :meth:`to_state` (keys it does not know are
        ignored, as the reference ignores them)."""
        from .obs.histogram import Histogram

        st = cls()
        for f in _MERGE_FIELDS:
            if f in d:
                setattr(st, f, d[f])
        st.wall_s = d.get("wall_s", 0.0)
        for name, h in (d.get("hists") or {}).items():
            st.hists[name] = Histogram.from_dict(h)
        return st


# the counters a merge or a fold adds up: every field but the scope's
# wall and the telemetry
_MERGE_FIELDS = tuple(f.name for f in fields(DecodeStats)
                      if f.name not in ("wall_s", "hists", "events"))


_tls = threading.local()


def current_stats() -> DecodeStats | None:
    """The active collector on this thread, or None."""
    return getattr(_tls, "active", None)


@contextlib.contextmanager
def collect_stats(events: bool = False):
    """Collect decode counters for the enclosed scope on this thread;
    ``wall_s`` is set to the scope's wall when it exits.  ``events=True``
    also attaches a per-page event log (``st.events``, an
    :class:`~tpuparquet_torch.obs.events.EventLog`).  On exit the scope
    folds into the live metrics registry (``obs/live.py``): a nested
    scope shadows the outer one and worker collectors merge into their
    coordinator, so each count lands there once."""
    prev = getattr(_tls, "active", None)
    st = DecodeStats()
    if events:
        from .obs.events import EventLog

        st.events = EventLog()
    t0 = time.perf_counter()
    _tls.active = st
    try:
        yield st
    finally:
        st.wall_s = time.perf_counter() - t0
        _tls.active = prev
        from .obs.live import fold_stats

        fold_stats(st)


@contextlib.contextmanager
def adopt_stats(st: DecodeStats):
    """Install an existing collector as this thread's active one for the
    block (no wall kept): the scan drivers meter their units into a
    collector of their own when the caller has none, so the live
    registry sees scans nobody wrapped in :func:`collect_stats`."""
    prev = getattr(_tls, "active", None)
    _tls.active = st
    try:
        yield st
    finally:
        _tls.active = prev


@contextlib.contextmanager
def worker_stats(like: DecodeStats | None = None):
    """A fresh collector for a pool worker's task, active on its thread;
    yields it.  The coordinating thread merges it into its own
    (:meth:`DecodeStats.merge_from`) after joining the task.  ``like`` is
    the coordinator's collector: when it carries an event log, the
    worker gets one of its own on the same clock (``t0``), so merged
    span times share one timeline."""
    prev = getattr(_tls, "active", None)
    st = DecodeStats()
    if like is not None and like.events is not None:
        from .obs.events import EventLog

        st.events = EventLog(t0=like.events.t0)
    _tls.active = st
    try:
        yield st
    finally:
        _tls.active = prev


# what a failed worker attempt may fold into its coordinator: the fault
# layer's own observations (faults delivered, CRC rejects, retries,
# expiries, hedges); anything else from a failed attempt would be a
# phantom count
_FAULT_OBSERVABILITY_FIELDS = ("faults_injected", "crc_mismatches",
                               "io_retries", "remote_retry",
                               "dispatch_retries",
                               "deadline_exceeded", "hedges_issued",
                               "hedges_won")


def merge_worker_stats(st: DecodeStats | None, ws: DecodeStats | None, *,
                       failed: bool) -> None:
    """Fold an attempt's collector ``ws`` into ``st``: everything when it
    succeeded, only :data:`_FAULT_OBSERVABILITY_FIELDS` when it failed,
    so a unit that retried N times counts its pages, values and bytes
    once (and of a failed one's event log only its fault records).  The
    resilient read's attempts and ``deadline.py``'s workers merge through
    here."""
    if st is None or ws is None:
        return
    if not failed:
        st.merge_from(ws)
        return
    for f in _FAULT_OBSERVABILITY_FIELDS:
        setattr(st, f, getattr(st, f) + getattr(ws, f))
    if st.events is not None and ws.events is not None:
        st.events.faults.extend(ws.events.faults)


@contextlib.contextmanager
def trace(log_dir: str):
    """A ``torch.profiler`` trace of the enclosed scope, written into
    ``log_dir`` as a Chrome trace (the reference's twin writes JAX's
    profiler trace): host activity, and the card's kernels and copies
    when CUDA is available.  The counters above stay host-side and
    cheap."""
    import torch
    from torch.profiler import ProfilerActivity, profile, \
        tensorboard_trace_handler

    acts = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(ProfilerActivity.CUDA)
    with profile(activities=acts,
                 on_trace_ready=tensorboard_trace_handler(log_dir)):
        yield
