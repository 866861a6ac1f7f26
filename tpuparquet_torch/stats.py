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
from dataclasses import dataclass, fields

__all__ = ["DecodeStats", "collect_stats", "current_stats",
           "worker_stats"]


@dataclass
class DecodeStats:
    bytes_staged: int = 0
    plan_s: float = 0.0
    transfer_s: float = 0.0
    dispatch_s: float = 0.0
    pages_device_planes: int = 0
    pages_device_delta_lanes: int = 0
    pages_device_snappy: int = 0
    pages_device_encoded: int = 0
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

    def merge_from(self, other: "DecodeStats") -> None:
        """Fold a worker collector's counts into this one (on the
        coordinating thread, after the worker is joined)."""
        for f in fields(self):
            setattr(self, f.name,
                    getattr(self, f.name) + getattr(other, f.name))


_tls = threading.local()


def current_stats() -> DecodeStats | None:
    """The active collector on this thread, or None."""
    return getattr(_tls, "active", None)


@contextlib.contextmanager
def collect_stats():
    """Collect decode counters for the enclosed scope on this thread."""
    prev = getattr(_tls, "active", None)
    st = DecodeStats()
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
    the coordinator's collector; it carries nothing a worker needs here
    (the reference copies its event log's clock, which the port does not
    keep)."""
    prev = getattr(_tls, "active", None)
    st = DecodeStats()
    _tls.active = st
    try:
        yield st
    finally:
        _tls.active = prev

