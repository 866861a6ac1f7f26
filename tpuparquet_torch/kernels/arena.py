"""Recycled host staging buffers for the device decode path.

Fresh multi-megabyte numpy allocations fault in new pages on every
write, which caps every first-touch copy at a fraction of warm-memory
bandwidth (measured ~3x slower on single-core hosts).  The plan phase
allocates the same page-sized buffers every row group — decompression
outputs, staging words — so a generation-scoped free list recycles them.

Lifetime contract: ``borrow`` hands out a whole slab per call (borrowers
never alias); ``release_all`` returns every outstanding slab to the free
list.  Callers must release only after every copy and kernel that reads
from these buffers has completed (the row group's
``torch.cuda.synchronize`` in ``kernels/device.py``
``_finish_row_group``).
"""

from __future__ import annotations

import threading

import numpy as np

__all__ = ["HostArena", "ArenaPool", "lease_arena", "return_arena",
           "trim_arena_pool", "set_arena_retention", "thread_arena",
           "discard_thread_arena",
           "arena_occupancy", "take_arena_peak"]


# ----------------------------------------------------------------------
# Process-wide occupancy watermark (attribution telemetry)
# ----------------------------------------------------------------------
# Outstanding borrowed slab bytes across every arena, and the high-water
# mark since the last take: the "peak arena bytes" of a scan's ledger
# (obs/attribution.py).  A borrow adds under a lock (a slab, not a
# page, at a time); the scans take the peak at unit boundaries.  An
# arena dropped without a release (the error paths' escape hatch)
# subtracts its outstanding bytes when it is collected.

_occ_lock = threading.Lock()
_occ_bytes = 0
_occ_peak = 0


def _occ_add(n: int) -> None:
    global _occ_bytes, _occ_peak
    with _occ_lock:
        _occ_bytes += n
        if _occ_bytes > _occ_peak:
            _occ_peak = _occ_bytes


def _occ_sub(n: int) -> None:
    global _occ_bytes
    with _occ_lock:
        _occ_bytes = max(_occ_bytes - n, 0)


def arena_occupancy() -> int:
    """Outstanding borrowed arena bytes right now (process-wide)."""
    with _occ_lock:
        return _occ_bytes


def take_arena_peak() -> int:
    """The occupancy high-water mark since the previous take; resets the
    mark to the current occupancy (so successive takes window the peak
    without under-reporting a borrow still outstanding).

    Process-wide: arenas are one shared pool, so with concurrent scans
    whichever takes a window first absorbs that window's peak.  A scan's
    ledger therefore reports the peak occupancy seen during its units,
    an upper bound on its own footprint."""
    global _occ_peak
    with _occ_lock:
        p = _occ_peak
        _occ_peak = _occ_bytes
        return p


class HostArena:
    """Best-fit free list of reusable u8 slabs."""

    __slots__ = ("_free", "_used", "_used_bytes", "max_slabs")

    def __init__(self, max_slabs: int = 64):
        self._free: list[np.ndarray] = []
        self._used: list[np.ndarray] = []
        self._used_bytes = 0
        self.max_slabs = max_slabs

    def borrow(self, nbytes: int) -> np.ndarray:
        """A u8 array of exactly ``nbytes``, backed by a recycled slab
        when one fits (smallest sufficient slab wins)."""
        best = -1
        for i, s in enumerate(self._free):
            if s.size >= nbytes and (
                best < 0 or s.size < self._free[best].size
            ):
                best = i
        if best >= 0:
            slab = self._free.pop(best)
        else:
            # round up so nearby page sizes share slabs
            cap = max(nbytes, 4096)
            cap = 1 << (cap - 1).bit_length()
            slab = np.empty(cap, dtype=np.uint8)
        self._used.append(slab)
        self._used_bytes += slab.size
        _occ_add(slab.size)
        return slab[:nbytes]

    def release_all(self) -> None:
        """Return every borrowed slab; keep only the largest slabs when
        over the cap so a one-off giant row group doesn't pin memory
        forever while small pages churn."""
        free = self._free + self._used
        self._used = []
        _occ_sub(self._used_bytes)
        self._used_bytes = 0
        if len(free) > self.max_slabs:
            free.sort(key=lambda s: s.size)
            free = free[-self.max_slabs:]
        self._free = free

    def __del__(self):
        # an arena dropped without a release (the error paths keep
        # slabs a copy may still read) must not pin the gauge; a
        # partial teardown at interpreter exit is tolerated
        try:
            if self._used_bytes:
                _occ_sub(self._used_bytes)
        except Exception:
            pass


class ArenaPool:
    """Process-wide pool of :class:`HostArena` leases for the
    column-parallel plan tasks.

    Each plan task leases a WHOLE arena for its duration, so racing
    planners never share a slab (the old per-unit arena would be
    written by several column planners at once).  Leases are returned
    only after the unit's transfers have drained
    (``_finish_row_group``'s ``torch.cuda.synchronize``), which is
    the same lifetime contract ``HostArena.release_all`` documents —
    the pool just moves the recycling boundary from thread-local to
    task-scoped.  Error paths simply DROP their lease references
    (never ``give_back``): the slabs may still back in-flight
    transfers, and numpy frees them once the last reference drops."""

    __slots__ = ("_lock", "_free", "max_arenas")

    def __init__(self, max_arenas: int = 8):
        self._lock = threading.Lock()
        self._free: list[HostArena] = []
        # retention cap on FREE arenas only (in-flight leases are
        # unbounded — they are the scan's working set); a wide-core
        # scan's give_backs beyond the cap free their slabs instead of
        # pinning high-watermark memory for the process lifetime
        self.max_arenas = max_arenas

    def lease(self) -> HostArena:
        with self._lock:
            if self._free:
                return self._free.pop()
        return HostArena()

    def give_back(self, arena: HostArena) -> None:
        """Recycle an arena (caller guarantees every transfer sourced
        from its slabs has completed)."""
        arena.release_all()
        with self._lock:
            if len(self._free) < self.max_arenas:
                self._free.append(arena)

    def trim(self, keep: int = 0) -> None:
        """Drop free arenas beyond ``keep`` (scan-end hook: long-lived
        processes should not carry a finished scan's slab high-water
        mark)."""
        with self._lock:
            del self._free[keep:]

    def set_retention(self, max_arenas: int) -> int:
        """Set the free-list cap; returns the previous cap.  The scan
        server raises it to its worker budget (each concurrent tenant
        worker leases an arena) and restores it on shutdown."""
        with self._lock:
            prev = self.max_arenas
            self.max_arenas = max(int(max_arenas), 0)
        return prev


_POOL = ArenaPool()


def lease_arena() -> HostArena:
    """Lease a per-task arena from the shared pool."""
    return _POOL.lease()


def return_arena(arena: HostArena) -> None:
    """Return a leased arena to the shared pool for recycling."""
    _POOL.give_back(arena)


def trim_arena_pool(keep: int = 0) -> None:
    """Release the shared pool's retained free arenas (see
    :meth:`ArenaPool.trim`); called by the pipelined reader when a
    scan ends, and available to long-lived hosts."""
    _POOL.trim(keep)


def set_arena_retention(max_arenas: int) -> int:
    """Set the shared pool's free-list cap (:meth:`ArenaPool.set_retention`);
    returns the previous cap."""
    return _POOL.set_retention(max_arenas)


_local = threading.local()


def thread_arena() -> HostArena:
    """The calling thread's own arena (one a thread: slabs are not
    shared by concurrent borrowers); ``kernels/device.py``
    ``decode_chunk_device`` borrows from it."""
    a = getattr(_local, "arena", None)
    if a is None:
        a = _local.arena = HostArena()
    return a


def discard_thread_arena() -> None:
    """Drop the calling thread's arena without releasing its slabs: on
    an error path a copy from them may still be in flight, so they are
    never recycled (numpy frees them once the last reference drops)."""
    _local.arena = None
