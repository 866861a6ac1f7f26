"""Deadlines: a watchdog that turns a hung operation into a bounded,
classified failure.

The port of ``tpuparquet/deadline.py``.  A read that never returns or a
dispatch that wedges must flow into the retry, host-decode and
quarantine ladder instead of stalling the scan:

* :class:`Watchdog` — one daemon thread (:func:`watchdog`, started
  lazily) that flips every watched operation past its budget to
  "expired" and wakes its waiter;
* :func:`call_with_deadline` — run a callable within a budget on a
  disposable worker thread; on expiry the worker is abandoned (Python
  cannot interrupt a blocked call) and the waiter raises the deadline
  error with ``elapsed``, ``budget`` and the coordinates.  An abandoned
  worker's result and counters are dropped whole;
* :func:`hedged_call` — tail-at-scale hedging over replica callables:
  the primary starts at once, a replica joins each time the hedge delay
  passes with no success (or a branch fails), and the first success
  wins (``hedges_issued``, ``hedges_won``);
* :class:`LatencyTracker` — a rolling window of read latencies whose
  p95 is the adaptive hedge delay (the process's :data:`read_latency`).

Every expiry, hedge and hedge won is a flight-recorder record and a
fault event (``obs/``); the deadline and hedge workers re-enter the
caller's trace context, each hedged branch is a ``read_replica`` span
(the losers ``cancelled``), and an expiry is a ``deadline_exceeded``
error span and, with the latency digests armed, an observation of the
``deadline`` label's digest.  Both workers also take the caller's serve
tenant binding (``serve/arbiter.py`` :func:`~tpuparquet_torch.serve.
tenant_scope`), so bounded work sizes its pools from the tenant's
share.

A hung read becomes :class:`~tpuparquet_torch.errors.DeadlineExceededError`
(transient: retried, then quarantined); a hung dispatch
:class:`~tpuparquet_torch.errors.DispatchDeadlineError` (a failed dispatch:
retried, then decoded on the host).

Budgets from the environment (unset, invalid or <= 0: off):
``TPQ_UNIT_DEADLINE_S`` (a scan unit), ``TPQ_SCAN_DEADLINE_S`` (a whole
scan), ``TPQ_READ_DEADLINE_S`` (a chunk read), ``TPQ_DISPATCH_DEADLINE_S``
(a device dispatch attempt), and ``TPQ_HEDGE_DELAY_S`` (a fixed hedge
delay; unset: the adaptive one).  With no budget set and no mirror
nothing here starts a thread.  Every expiry counts
``deadline_exceeded``.
"""

from __future__ import annotations

import atexit
import os
import queue
import threading
import time
import weakref

from .errors import DeadlineExceededError

__all__ = [
    "Watchdog",
    "watchdog",
    "call_with_deadline",
    "record_expiry",
    "hedged_call",
    "LatencyTracker",
    "read_latency",
    "unit_deadline_default",
    "scan_deadline_default",
    "read_deadline_default",
    "dispatch_deadline_default",
    "hedge_delay_default",
]

_COORD_KEYS = ("file", "row_group", "column", "page")


def _env_budget(name: str) -> float | None:
    """A budget in seconds from the environment; unset, invalid or <= 0
    is off (None)."""
    try:
        v = float(os.environ.get(name, ""))
    except ValueError:
        return None
    return v if v > 0 else None


def unit_deadline_default() -> float | None:
    """A scan unit's budget (``TPQ_UNIT_DEADLINE_S``); None: off."""
    return _env_budget("TPQ_UNIT_DEADLINE_S")


def scan_deadline_default() -> float | None:
    """A whole scan's budget (``TPQ_SCAN_DEADLINE_S``); None: off."""
    return _env_budget("TPQ_SCAN_DEADLINE_S")


def read_deadline_default() -> float | None:
    """A chunk read's budget (``TPQ_READ_DEADLINE_S``); None: off."""
    return _env_budget("TPQ_READ_DEADLINE_S")


def dispatch_deadline_default() -> float | None:
    """A device dispatch attempt's budget (``TPQ_DISPATCH_DEADLINE_S``);
    None: off."""
    return _env_budget("TPQ_DISPATCH_DEADLINE_S")


def hedge_delay_default() -> float | None:
    """A fixed hedge delay (``TPQ_HEDGE_DELAY_S``); None: adaptive (the
    rolling p95 of the observed read latency)."""
    return _env_budget("TPQ_HEDGE_DELAY_S")


# ----------------------------------------------------------------------
# Watchdog
# ----------------------------------------------------------------------

class _Op:
    """One watched operation in flight."""

    __slots__ = ("site", "budget", "deadline", "coords", "event", "state")

    def __init__(self, site: str, budget: float, coords: dict):
        self.site = site
        self.budget = budget
        self.deadline = 0.0      # monotonic expiry, set when registered
        self.coords = coords
        self.event = threading.Event()
        self.state = "pending"   # -> "done" | "expired", under the lock


class Watchdog(threading.Thread):
    """A daemon thread that expires the operations past their budget.
    ``pending -> done`` (the worker) and ``pending -> expired`` (the
    watchdog) happen under one condition variable, so a result racing an
    expiry has exactly one winner.  With nothing registered the thread
    sleeps."""

    def __init__(self):
        super().__init__(name="tpq-watchdog", daemon=True)
        self._cv = threading.Condition()
        self._ops: set[_Op] = set()

    def register(self, op: _Op) -> None:
        op.deadline = time.monotonic() + op.budget
        with self._cv:
            self._ops.add(op)
            self._cv.notify()

    def finish(self, op: _Op) -> bool:
        """The worker completed: True if the op was still pending (its
        result counts), False if it had expired (abandoned)."""
        with self._cv:
            self._ops.discard(op)
            if op.state == "pending":
                op.state = "done"
                op.event.set()
                return True
            return False

    def expire(self, op: _Op) -> bool:
        """Expire ``op`` now (the waiter's fallback should the watchdog
        itself be stuck)."""
        with self._cv:
            self._ops.discard(op)
            if op.state == "pending":
                op.state = "expired"
                op.event.set()
                return True
            return False

    def run(self):
        while True:
            with self._cv:
                now = time.monotonic()
                nxt = None
                for op in list(self._ops):
                    if now >= op.deadline:
                        self._ops.discard(op)
                        op.state = "expired"
                        op.event.set()
                    elif nxt is None or op.deadline < nxt:
                        nxt = op.deadline
                self._cv.wait(None if nxt is None
                              else max(nxt - time.monotonic(), 0.001))


_watchdog: Watchdog | None = None
_watchdog_lock = threading.Lock()


def watchdog() -> Watchdog:
    """The process's watchdog, started at first use (and again after a
    fork, which threads do not survive)."""
    global _watchdog
    w = _watchdog
    if w is not None and w.is_alive():
        return w
    with _watchdog_lock:
        w = _watchdog
        if w is None or not w.is_alive():
            w = Watchdog()
            w.start()
            _watchdog = w
    return w


# ----------------------------------------------------------------------
# Worker threads
# ----------------------------------------------------------------------

#: Live workers this module started.  An abandoned worker is a daemon; one
#: killed inside a CUDA call at interpreter exit can abort the process,
#: so exit first waits for them, up to a grace.
_workers: "weakref.WeakSet[threading.Thread]" = weakref.WeakSet()
_workers_lock = threading.Lock()
_EXIT_GRACE_S = 5.0


def _spawn_worker(target, name: str) -> threading.Thread:
    t = threading.Thread(target=target, daemon=True, name=name)
    with _workers_lock:
        _workers.add(t)
    t.start()
    return t


@atexit.register
def _drain_workers_at_exit() -> None:
    stop_at = time.monotonic() + _EXIT_GRACE_S
    with _workers_lock:
        pending = list(_workers)
    for t in pending:
        t.join(max(stop_at - time.monotonic(), 0.0))


# ----------------------------------------------------------------------
# Deadline-bounded calls
# ----------------------------------------------------------------------

def record_expiry(st, site: str, elapsed: float, budget: float,
                  coords: dict) -> None:
    """Record one expiry: a flight record and a zero-length error span
    (whatever collector is open), and on the collector ``st`` (None:
    nothing to count) ``deadline_exceeded`` and a fault event.  The
    watchdog paths here and the scan's whole-run budget both record
    through this.  With the latency digests armed, the expired wall also
    lands in the ``deadline`` label's digest of ``site``, apart from the
    scans' unit and scan series."""
    from .obs import digest as _digest
    from .obs.recorder import flight
    from .obs.trace import emit_span

    flight("deadline_exceeded", site=site, elapsed_s=round(elapsed, 3),
           budget_s=budget, **coords)
    emit_span("deadline_exceeded", time.perf_counter(), 0.0,
              status="error", site=site, elapsed_s=round(elapsed, 3),
              budget_s=budget, **coords)
    if _digest._active is not None:
        _digest.observe("deadline", site, int(elapsed * 1e6),
                        budget_s=budget, **_scan_coords(coords))
    if st is None:
        return
    st.deadline_exceeded += 1
    if st.events is not None:
        st.events.fault(site=site, kind="deadline_exceeded",
                        elapsed_s=round(elapsed, 3), budget_s=budget,
                        **coords)


def _scan_coords(coords: dict) -> dict:
    return {k: coords[k] for k in _COORD_KEYS if k in coords}


def call_with_deadline(fn, budget: float | None, *, site: str,
                       error=DeadlineExceededError, **coords):
    """Run ``fn()`` within ``budget`` seconds.

    ``budget`` None or <= 0 is a plain call (no thread).  Otherwise
    ``fn`` runs on a disposable daemon worker under a collector of its
    own (``worker_stats(like=)``), registered with the :func:`watchdog`.
    In time, its result or error propagates and its collector merges into
    the caller's (:func:`~tpuparquet_torch.stats.merge_worker_stats`: all
    of it on success, the fault layer's counts on a failure).  On expiry
    the worker is abandoned, ``deadline_exceeded`` counts on the caller's
    collector, and ``error`` is raised with ``elapsed``, ``budget``,
    ``site`` and the scan coordinates among ``coords``."""
    if budget is None or budget <= 0:
        return fn()
    from .obs import trace as _trace
    from .serve import arbiter as _arbiter
    from .stats import current_stats, merge_worker_stats, worker_stats

    st = current_stats()
    op = _Op(site, budget, coords)
    box: dict = {}
    wd = watchdog()
    # the worker re-enters the caller's trace context, so the bounded
    # work's spans parent under the caller's open span, and the caller's
    # tenant binding, so its plan pool sizes from the tenant's share
    tctx = _trace.current_ctx()
    tenant = _arbiter.current_binding()

    def run():
        try:
            with _trace.adopt(tctx), _arbiter.tenant_scope(tenant), \
                    worker_stats(like=st) as ws:
                try:
                    box["result"] = fn()
                except BaseException as e:  # noqa: BLE001 - re-raised
                    box["error"] = e
            box["stats"] = ws
        finally:
            wd.finish(op)

    start = time.monotonic()
    wd.register(op)
    _spawn_worker(run, f"tpq-deadline:{site}")
    # the slack covers a stuck watchdog: the waiter never blocks forever
    if not op.event.wait(budget + 1.0):
        wd.expire(op)
        op.event.wait(0.1)
    if op.state == "done":
        err = box.get("error")
        merge_worker_stats(st, box.get("stats"), failed=err is not None)
        if err is not None:
            raise err
        return box["result"]
    elapsed = time.monotonic() - start
    record_expiry(st, site, elapsed, budget, coords)
    raise error(
        f"{site} exceeded its {budget:g}s deadline "
        f"(hung for {elapsed:.3f}s)",
        elapsed=elapsed, budget=budget, site=site, **_scan_coords(coords))


# ----------------------------------------------------------------------
# Hedged calls
# ----------------------------------------------------------------------

def hedged_call(fns, *, delay: float, site: str,
                budget: float | None = None, tracker=None,
                on_win=None, **coords):
    """Tail-at-scale hedging over replica callables.

    ``fns[0]`` (the primary) starts at once; each time ``delay`` seconds
    pass with no completed branch, or a branch fails, the next replica
    starts.  The first branch to succeed wins: its result returns, its
    collector merges into the caller's, its latency goes into
    ``tracker``, and the slower branches are abandoned (replicas are
    byte-identical; the page CRC catches one that is not).  When every
    branch started has failed and none is left, the primary's error (or
    the first seen) is raised.  ``budget`` bounds the whole wall: past
    it :class:`~tpuparquet_torch.errors.DeadlineExceededError` is raised
    as by :func:`call_with_deadline`.

    Counts ``hedges_issued`` a replica started and ``hedges_won`` when a
    replica's result is used.  ``on_win(i)`` is called with the winning
    branch's index before the result returns (the reader's wedged
    primary detection)."""
    fns = list(fns)
    if len(fns) == 1 and (budget is None or budget <= 0):
        return fns[0]()
    from .obs import recorder as _flightrec
    from .obs import trace as _trace
    from .obs.recorder import flight
    from .serve import arbiter as _arbiter
    from .stats import current_stats, merge_worker_stats, worker_stats

    st = current_stats()
    # each branch's worker takes the caller's tenant binding, as the
    # deadline's worker does
    tenant = _arbiter.current_binding()
    q: queue.SimpleQueue = queue.SimpleQueue()
    starts: dict[int, float] = {}
    # one open span a branch under the caller's context, which the
    # branch's worker adopts; the winner closes "ok" and every abandoned
    # sibling "cancelled"
    branch_spans: dict[int, object] = {}

    def launch(i: int) -> None:
        starts[i] = time.monotonic()
        bsp = None
        if _trace._active is not None:
            bsp = _trace.open_span("read_replica", push=False, replica=i,
                                   site=site, **coords)
        branch_spans[i] = bsp
        bctx = _trace.ctx_of(bsp)

        def run():
            try:
                with _trace.adopt(bctx), _arbiter.tenant_scope(tenant), \
                        worker_stats(like=st) as ws:
                    try:
                        out = (True, fns[i]())
                    except BaseException as e:  # noqa: BLE001 - re-raised
                        out = (False, e)
                q.put((i, out[0], out[1], ws))
            except BaseException:  # interpreter teardown: dropped
                pass

        _spawn_worker(run, f"tpq-hedge:{site}:{i}")

    def close_branch(i: int, status: str) -> None:
        bsp = branch_spans.pop(i, None)
        if bsp is not None:
            _trace.close_span(bsp, status=status)

    def hedge_next() -> None:
        i = len(starts)
        flight("hedge_issued", site=site, replica=i, **coords)
        if st is not None:
            st.hedges_issued += 1
            if st.events is not None:
                st.events.fault(site=site, kind="hedge_issued", replica=i,
                                **coords)
        launch(i)

    t0 = time.monotonic()
    launch(0)
    errors: dict[int, BaseException] = {}
    done = 0
    while True:
        now = time.monotonic()
        if budget is not None and budget > 0 and now - t0 >= budget:
            elapsed = now - t0
            for i in list(branch_spans):
                close_branch(i, "cancelled")
            record_expiry(st, site, elapsed, budget, coords)
            raise DeadlineExceededError(
                f"{site} exceeded its {budget:g}s deadline with "
                f"{len(starts) - done} hedged read(s) still hung",
                elapsed=elapsed, budget=budget, site=site,
                **_scan_coords(coords))
        wait = None
        if len(starts) < len(fns):
            wait = max(t0 + len(starts) * delay - now, 0.0)
        if budget is not None and budget > 0:
            remaining = max(t0 + budget - now, 0.001)
            wait = remaining if wait is None else min(wait, remaining)
        try:
            i, ok, val, ws = q.get(timeout=wait)
        except queue.Empty:
            # hedge only once the hedge delay has passed: a wait the
            # budget cut short must not start a replica just before the
            # deadline raises
            if len(starts) < len(fns) and \
                    time.monotonic() >= t0 + len(starts) * delay:
                hedge_next()
            continue
        if ok:
            merge_worker_stats(st, ws, failed=False)
            if tracker is not None:
                tracker.record(time.monotonic() - starts[i])
            close_branch(i, "ok")
            for j in list(branch_spans):
                close_branch(j, "cancelled")  # the abandoned losers
            if i > 0:
                if _flightrec._active is not None:
                    _flightrec.flight("hedge_won", site=site, replica=i,
                                      **coords)
                if st is not None:
                    st.hedges_won += 1
                    if st.events is not None:
                        st.events.fault(site=site, kind="hedge_won",
                                        replica=i, **coords)
            if on_win is not None:
                on_win(i)
            return val
        merge_worker_stats(st, ws, failed=True)
        close_branch(i, "error")
        errors[i] = val
        done += 1
        if done == len(starts):
            if len(starts) < len(fns):
                hedge_next()     # every branch started failed: escalate
                continue
            raise errors.get(0, next(iter(errors.values())))


# ----------------------------------------------------------------------
# The rolling read-latency tracker (the adaptive hedge delay)
# ----------------------------------------------------------------------

class LatencyTracker:
    """A rolling window of observed latencies.  :meth:`hedge_delay` is
    the window's p95 (at least ``floor``) once ``min_samples`` exist,
    else ``default``: hedging at about the p95 bounds the extra replica
    load at about 5%.  Thread-safe; a record is O(1), a quantile sorts
    the window."""

    def __init__(self, window: int = 256, floor: float = 0.002,
                 default: float = 0.05, min_samples: int = 8):
        self._window = window
        self._floor = floor
        self._default = default
        self._min_samples = min_samples
        self._buf: list[float] = []
        self._pos = 0
        self._lock = threading.Lock()

    def record(self, seconds: float) -> None:
        with self._lock:
            if len(self._buf) < self._window:
                self._buf.append(seconds)
            else:
                self._buf[self._pos] = seconds
                self._pos = (self._pos + 1) % self._window

    def __len__(self) -> int:
        return len(self._buf)

    def quantile(self, q: float) -> float | None:
        with self._lock:
            if not self._buf:
                return None
            s = sorted(self._buf)
        i = min(int(q * len(s)), len(s) - 1)
        return s[i]

    def hedge_delay(self) -> float:
        if len(self._buf) < self._min_samples:
            return self._default
        return max(self.quantile(0.95), self._floor)

    def reset(self) -> None:
        with self._lock:
            self._buf = []
            self._pos = 0


#: The process's rolling window of chunk-read latencies: every reader
#: records into it, so the adaptive hedge delay follows the store's
#: current tail rather than one file's history.
read_latency = LatencyTracker()
