"""The scan server's prefetch planner: warm the disk tier ahead of a
job's cursor, as deep as its latency objective asks.

On a byte-range source a unit's time is mostly the store's round trips,
and the reader already owns the cure:
:meth:`~tpuparquet_torch.io.reader.FileReader.prefetch_chunks` fetches a
row group's chunk ranges coalesced and in parallel into the disk tier
and skips what the tier holds (over a shared tier, what another process
published too).  This module decides when, and how far ahead of the
cursor, to call it:

* **Depth**, at most ``TPQ_PREFETCH_DEPTH`` units (0 turns the planner
  off), comes from the job's latency signals: with the ``(label,
  "unit")`` digest's p99 at most a quarter of the job's
  ``unit_deadline`` one unit ahead is enough; past that the window
  deepens in proportion to p99 / deadline; and when the label's fast
  burn rate (``obs/slo.py`` over the time-series ring) is at least 1 the
  window goes to the maximum.  Without a deadline or digest data the
  window is the maximum.
* **Bytes**: at most ``TPQ_PREFETCH_BYTES_MB`` of prefetched row groups
  not yet consumed (the footer's ``total_byte_size``); the unit right
  after the cursor always goes, or a fat unit would never prefetch.
* **Threads**: the worker runs under the job's
  :func:`~tpuparquet_torch.serve.arbiter.tenant_scope`, so
  ``prefetch_ranges`` sizes its pool from the tenant's share.

A fetch runs under the worker's ``worker_stats`` collector, which
:meth:`PrefetchPlanner.close` (on the job's thread, inside the job's
``collect_stats``) merges: ``remote_ranges_fetched``, ``remote_bytes``
and the ``cache_*_disk`` counters of a prefetch land on the job's stats
once.  A range the decode asks for while the planner fetches it is
waited for, not fetched again (``FileReader.prefetch_ranges``).

The planner's condition variable is a leaf lock: the window's
bookkeeping only; every fetch and every digest or ring read happens
outside it.
"""

from __future__ import annotations

import os
import threading

from . import arbiter as _arbiter

__all__ = ["PrefetchPlanner", "prefetch_depth_default",
           "prefetch_bytes_default"]

#: units between two reads of the latency signals (a digest fold and a
#: ring read cost more than a unit's bookkeeping; the signals move
#: slower)
_REFRESH_UNITS = 16


def prefetch_depth_default() -> int:
    """``TPQ_PREFETCH_DEPTH``: the most units the planner warms ahead
    (default 2; ``0`` turns the server's prefetch off)."""
    v = os.environ.get("TPQ_PREFETCH_DEPTH")
    if v is None or v == "":
        return 2
    return max(0, int(v))


def prefetch_bytes_default() -> int:
    """``TPQ_PREFETCH_BYTES_MB`` in bytes: the cap on prefetched row-group
    bytes not yet consumed (default 64 MiB)."""
    v = os.environ.get("TPQ_PREFETCH_BYTES_MB")
    if v is None or v == "":
        return 64 * (1 << 20)
    return max(0, int(float(v) * (1 << 20)))


def _unit_est_bytes(readers, unit) -> int:
    """A ``(file, row_group)`` unit's size for the byte cap: the footer's
    row-group bytes, 0 when unknown."""
    fi, rgi = unit
    r = readers[fi] if fi < len(readers) else None
    if r is None:
        return 0
    try:
        return max(0, int(r.meta.row_groups[rgi].total_byte_size))
    except (AttributeError, IndexError, TypeError, ValueError):
        return 0


class PrefetchPlanner:
    """One a running job: a worker thread that keeps the chunk ranges of
    the next ``depth`` units in the disk tier.

    The job's thread calls :meth:`start` once, :meth:`note_progress`
    after each unit it consumed, and :meth:`close` on its own thread
    inside the job's stats scope (the worker's counters merge there and
    the thread is joined).  Every method is cheap; the fetches run on
    the planner's thread."""

    def __init__(self, readers, units, label: str, *,
                 start: int = 0,
                 unit_deadline: float | None = None,
                 max_depth: int | None = None,
                 byte_cap: int | None = None):
        self._readers = readers
        self._units = units
        self._label = label
        self._unit_deadline = unit_deadline
        self._max_depth = (max_depth if max_depth is not None
                           else prefetch_depth_default())
        self._byte_cap = (byte_cap if byte_cap is not None
                          else prefetch_bytes_default())
        self._cv = threading.Condition()
        self._cursor = start - 1   # the last unit the job consumed
        self._next = start         # the next unit to prefetch
        self._ahead: list = []     # (unit, est_bytes) in the window
        self._stop = False
        self._depth = 1            # set from the latency signals
        self._since_refresh = _REFRESH_UNITS  # read them on first use
        self._workers: list = []   # the worker's collector, for close()
        self._thread: threading.Thread | None = None

    # -- the job's side ---------------------------------------------------

    def start(self) -> "PrefetchPlanner":
        if self._max_depth <= 0 or not self._units:
            return self  # off: every method stays a no-op
        self._thread = threading.Thread(
            target=self._run, name=f"tpq-prefetch:{self._label}",
            daemon=True)
        self._thread.start()
        return self

    def note_progress(self, k: int) -> None:
        """Unit ``k`` was consumed: slide the window."""
        if self._thread is None:
            return
        with self._cv:
            if k > self._cursor:
                self._cursor = k
                self._ahead = [(u, b) for u, b in self._ahead if u > k]
            self._cv.notify_all()

    def close(self) -> None:
        """Stop and join the worker, then merge its counters into the
        calling thread's collector: call on the job's thread, inside
        the job's stats scope, after the scan loop."""
        if self._thread is None:
            return
        with self._cv:
            self._stop = True
            self._cv.notify_all()
        self._thread.join(30.0)
        self._thread = None
        from ..stats import current_stats, merge_worker_stats

        st = current_stats()
        for ws in self._workers:
            merge_worker_stats(st, ws, failed=False)
        self._workers = []

    # -- the latency signals ----------------------------------------------

    def _target_depth(self) -> int:
        """The window's depth now (the module docstring)."""
        depth = self._max_depth
        p99_s = self._digest_p99_s()
        if self._unit_deadline and p99_s is not None:
            pressure = p99_s / self._unit_deadline
            if pressure <= 0.25:
                depth = 1
            else:
                depth = max(1, min(self._max_depth,
                                   round(self._max_depth
                                         * min(pressure, 1.0))))
        burn = self._fast_burn()
        if burn is not None and burn >= 1.0:
            depth = self._max_depth
        return depth

    def _digest_p99_s(self) -> float | None:
        from ..obs import digest as _digest

        reg = _digest.digests()
        if reg is None:
            return None
        g = reg.snapshot().get((self._label, "unit"))
        if g is None or not g.n:
            return None
        return g.quantile(0.99) / 1e6  # the digests hold microseconds

    def _fast_burn(self) -> float | None:
        """This label's fast-window burn rate from the time-series ring
        and the SLO objectives; None when either is off."""
        from ..obs import slo as _slo
        from ..obs import timeseries as _timeseries

        ring = _timeseries.ring()
        if ring is None:
            return None
        try:
            objectives = [o for o in _slo.load_objectives()
                          if o["label"] == self._label]
            if not objectives:
                return None
            frames = _timeseries.load_ring(ring.dir)
            if not frames:
                return None
            report = _slo.evaluate(frames, objectives)
        except (OSError, ValueError, KeyError):
            return None
        for row in report["objectives"]:
            burn = (row.get("burn") or {}).get("fast")
            if burn is not None:
                return burn
        return None

    # -- the worker -------------------------------------------------------

    def _pick(self):
        """The next unit to warm, or None to wait.  Called under the cv,
        with the depth of the last read of the signals."""
        if self._next >= len(self._units):
            return None
        if self._next > self._cursor + self._depth:
            return None
        ahead_bytes = sum(b for _u, b in self._ahead)
        est = _unit_est_bytes(self._readers, self._units[self._next])
        if ahead_bytes > 0 and ahead_bytes + est > self._byte_cap:
            return None  # full by bytes; the first unit always goes
        k = self._next
        self._next += 1
        self._ahead.append((k, est))
        return k

    def _run(self) -> None:
        from ..stats import worker_stats

        with worker_stats() as ws, _arbiter.tenant_scope(self._label):
            # one collector for the thread's life, merged by close()
            # after the join, so no two threads touch it at once
            self._workers.append(ws)
            while True:
                with self._cv:
                    k = self._pick()
                    while k is None and not self._stop:
                        self._cv.wait(0.05)
                        k = self._pick()
                    if self._stop:
                        return
                if self._since_refresh >= _REFRESH_UNITS:
                    self._since_refresh = 0
                    depth = self._target_depth()  # outside the cv
                    with self._cv:
                        self._depth = depth
                self._since_refresh += 1
                fi, rgi = self._units[k]
                reader = (self._readers[fi]
                          if fi < len(self._readers) else None)
                if reader is None:
                    continue
                try:
                    reader.prefetch_chunks(reader.meta.row_groups[rgi])
                except Exception:  # noqa: BLE001 - advisory
                    # a prefetch never fails the scan: the unit's own
                    # read fetches again under the full retry policy and
                    # raises a real error with its coordinates
                    pass
