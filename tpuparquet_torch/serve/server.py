"""The multi-tenant scan server: bounded per-tenant queues over one
arbiter, with a graceful drain.

A :class:`ScanServer` owns (or adopts) a
:class:`~tpuparquet_torch.serve.arbiter.ResourceArbiter`, activates it
for the process, and runs tenants' scans at once over what the package
shares: the plan cache, the arena pool, the metrics registry and the
per-label ledgers and digests.  Each tenant has a FIFO queue bounded by
admission control; a round-robin scheduler starts at most one scan of a
tenant at a time (the arbiter shares the cores between tenants; a
tenant's own jobs run in turn, which keeps its queue estimate honest),
and each scan is a quarantine-mode
:class:`~tpuparquet_torch.shard.scan.ShardedScan` under
:func:`~tpuparquet_torch.serve.arbiter.tenant_scope`, with a durable
cursor in the server's state directory.  The scans run on ``mesh``
(default: the scan's own default, the card's mesh, which raises without
CUDA; a CPU mesh runs every kernel's plain version).

**Graceful drain** (``SIGTERM`` through
:meth:`ScanServer.install_signal_handlers`, or :meth:`ScanServer.
shutdown`): admissions are refused with a retryable ``"draining"``
:class:`~tpuparquet_torch.errors.AdmissionRejected`; each running scan
is asked to stop (``request_stop``: it ends its unit, flushes its
cursor and marks its progress ``stopped``); queued jobs that never
started come back ``drained``; telemetry is flushed.  A successor that
resubmits the same ``(tenant, job_id)`` jobs resumes every cursor, and
with a keyed sink the union of the outputs is exact and free of
duplicates.

The server's condition variable is a leaf lock, like the arbiter's:
queue bookkeeping only, never held across an admission, a scan, a
rebalance or a telemetry call.
"""

from __future__ import annotations

import contextlib
import os
import signal
import threading
import time
from collections import deque

import torch

from . import arbiter as _arbiter
from .arbiter import AdmissionRejected, ResourceArbiter

__all__ = ["ScanJob", "ScanServer", "state_dir_default"]


def state_dir_default() -> str | None:
    """The durable-cursor directory, ``TPQ_SERVE_STATE_DIR`` (None: no
    checkpoints, so jobs do not resume across a restart)."""
    return os.environ.get("TPQ_SERVE_STATE_DIR") or None


class ScanJob:
    """One admitted scan.

    ``wait(timeout)`` blocks until the job is terminal: ``done`` (every
    unit decoded), ``drained`` (stopped by a drain with its cursor
    flushed: resubmit on the successor to go on) or ``failed``
    (:attr:`error` holds the exception).  Without a ``sink`` the decoded
    units land in :attr:`outputs` keyed by unit index; with one,
    ``sink(unit_index, out)`` is called on the job's thread as each
    unit decodes (keyed atomic writes there make a consumer that
    survives a crash)."""

    def __init__(self, tenant: str, job_id: str, sources, columns,
                 options: dict, sink):
        self.tenant = tenant
        self.job_id = job_id
        self.sources = sources
        self.columns = columns
        self.options = options
        self.sink = sink
        self.outputs: dict = {} if sink is None else None
        self.state = "queued"
        self.error: BaseException | None = None
        self.units_done = 0
        self.units_total: int | None = None
        self.units_quarantined = 0
        self.quarantine = None     # the QuarantineReport after the run
        self.stats = None          # the job's DecodeStats
        self.est_bytes = 0
        self.scan = None           # the ShardedScan while it runs
        self._event = threading.Event()

    def wait(self, timeout: float | None = None) -> bool:
        return self._event.wait(timeout)

    @property
    def terminal(self) -> bool:
        return self.state in ("done", "drained", "failed")

    def _finish(self, state: str) -> None:
        self.state = state
        self._event.set()

    def as_dict(self) -> dict:
        return {
            "tenant": self.tenant, "job_id": self.job_id,
            "state": self.state,
            "units_done": self.units_done,
            "units_total": self.units_total,
            "error": (f"{type(self.error).__name__}: {self.error}"
                      if self.error is not None else None),
        }


def _on_card(scan):
    """The scan's card as the current CUDA device of the calling thread
    (the current device is per thread, and a job runs on a new one)."""
    dev = scan.devices[0]
    if dev.type == "cuda":
        return torch.cuda.device(dev)
    return contextlib.nullcontext()


class ScanServer:
    """A long-lived host of many tenants' scans (the module docstring).

    ``plan_cache_mb`` arms the shared plan cache at that budget for the
    server's life (tenants re-planning the same files is the hit pattern
    of a server); None leaves ``TPQ_PLAN_CACHE_MB`` in force.  The arena
    pool's free-list cap is raised to the worker budget while the server
    runs and restored on shutdown.  ``mesh`` is handed to every job's
    scan (None: the scan's default mesh)."""

    def __init__(self, *, arbiter: ResourceArbiter | None = None,
                 state_dir: str | None = None,
                 queue_bound: int | None = None,
                 rebalance_interval: float | None = None,
                 plan_cache_mb: float | None = None,
                 mesh=None):
        self._arb = arbiter if arbiter is not None else ResourceArbiter()
        _arbiter.activate(self._arb)
        self.mesh = mesh
        self.state_dir = (state_dir if state_dir is not None
                          else state_dir_default())
        if self.state_dir:
            os.makedirs(self.state_dir, exist_ok=True)
        self._queue_bound = (queue_bound if queue_bound is not None
                             else _arbiter.queue_bound_default())
        self._reb_interval = (
            rebalance_interval if rebalance_interval is not None
            else _arbiter.rebalance_interval_default())
        self._cv = threading.Condition()
        self._queues: dict[str, deque[ScanJob]] = {}
        self._running: dict[str, ScanJob] = {}
        self._rr: list[str] = []      # the round-robin order of tenants
        self._rr_pos = 0
        self._finished: list[ScanJob] = []
        self._job_threads: list[threading.Thread] = []
        self._draining = False
        self._closed = False
        self._drain_event = threading.Event()
        from ..kernels import arena as _arena
        from ..kernels import plancache as _plancache

        # the override found, restored on shutdown (None is an override
        # too: "none set"), when this server set one
        self._plan_cache_armed = plan_cache_mb is not None
        self._plancache_token = (
            _plancache.set_plan_cache_budget(plan_cache_mb)
            if self._plan_cache_armed else None)
        self._arena_keep_prev = _arena.set_arena_retention(
            self._arb.total_workers)
        self._scheduler = threading.Thread(
            target=self._schedule_loop, name="tpq-serve-sched",
            daemon=True)
        self._scheduler.start()

    # -- tenants ---------------------------------------------------------

    def add_tenant(self, label: str, *, weight: float = 1.0,
                   byte_budget: int | None = None,
                   latency_target_ms: float | None = None,
                   error_rate_target: float | None = None) -> None:
        """Register a tenant with the arbiter and give it a queue."""
        self._arb.register(
            label, weight=weight, byte_budget=byte_budget,
            latency_target_ms=latency_target_ms,
            error_rate_target=error_rate_target)
        with self._cv:
            if label not in self._queues:
                self._queues[label] = deque()
                self._rr.append(label)

    # -- submission ------------------------------------------------------

    @staticmethod
    def _estimate_bytes(sources) -> int:
        """A job's size for admission: the local files' sizes; a remote
        or an opened source counts 0 (an unknown size must not be
        refused)."""
        total = 0
        for s in sources if isinstance(sources, (list, tuple)) else [sources]:
            if isinstance(s, (str, os.PathLike)):
                try:
                    total += os.path.getsize(s)
                except OSError:
                    pass
        return total

    def _cursor_path(self, job: ScanJob) -> str | None:
        if not self.state_dir:
            return None
        from ..obs.progress import label_slug

        name = f"{label_slug(job.tenant)}__{label_slug(job.job_id)}.cursor"
        return os.path.join(self.state_dir, name)

    def submit(self, tenant: str, sources, *columns: str,
               job_id: str | None = None,
               unit_deadline: float | None = None,
               scan_deadline: float | None = None,
               retries: int | None = 0,
               checkpoint_every: int | None = None,
               filter=None, sink=None,
               est_bytes: int | None = None) -> ScanJob:
        """Admit and queue one scan of ``tenant``.

        Raises :class:`AdmissionRejected` (retryable) while draining,
        when the tenant's queue is full, or when its byte or deadline
        budget cannot take the job: a request never hangs.  ``job_id``
        names the durable cursor, so the same id on a successor resumes
        it.  ``est_bytes`` replaces the local files' sizes when the
        caller knows the read's size (a dataset's manifest records
        it)."""
        if self._draining or self._closed:
            raise AdmissionRejected(
                f"server is draining; resubmit tenant {tenant!r} "
                f"work to the successor", tenant=tenant,
                reason="draining", retry_after_s=5.0)
        est = est_bytes if est_bytes is not None \
            else self._estimate_bytes(sources)
        with self._cv:
            q = self._queues.get(tenant)
            depth = (len(q) if q is not None else 0) \
                + (1 if tenant in self._running else 0)
        # the admission outside the server's lock: the arbiter's lock is
        # a leaf of its own and the two never nest
        self._arb.admit(tenant, est_bytes=est, deadline_s=scan_deadline,
                        queue_depth=depth, queue_bound=self._queue_bound)
        if job_id is None:
            job_id = f"job{int(time.monotonic() * 1e6):x}"
        job = ScanJob(tenant, job_id, sources, columns, {
            "unit_deadline": unit_deadline,
            "scan_deadline": scan_deadline,
            "retries": retries,
            "checkpoint_every": checkpoint_every,
            "filter": filter,
        }, sink)
        job.est_bytes = est
        enqueued = False
        with self._cv:
            q = self._queues.get(tenant)
            if q is not None and not self._draining \
                    and len(q) < self._queue_bound:
                q.append(job)
                enqueued = True
                self._cv.notify_all()
        if not enqueued:
            self._arb.retract(tenant, est)
            raise AdmissionRejected(
                f"tenant {tenant!r} queue filled while admitting; "
                f"retry", tenant=tenant, reason="queue_full",
                retry_after_s=1.0)
        return job

    def submit_dataset(self, tenant: str, root, *columns: str,
                       filter=None, **kw) -> ScanJob:
        """Admit a scan of a partitioned dataset (``dataset/``).

        The files come from the newest valid manifest; the conjuncts of
        ``filter`` over partition keys prune files before the admission,
        whose byte charge is the manifest's recorded sizes of the files
        kept (exact for ``emu://`` members too, which a local stat cannot
        size).  The rest of the predicate and every :meth:`submit` option
        pass through; the job is a sharded scan of the files kept."""
        from ..dataset import manifest as mf
        from ..dataset.scan import (partition_matches,
                                    split_partition_filter)

        body, _version, findings = mf.resolve_manifest(root)
        if body is None:
            raise FileNotFoundError(
                f"{root!r} has no valid manifest snapshot"
                + (f" ({len(findings)} rejected)" if findings else ""))
        part_pred, residual = split_partition_filter(
            filter, body["partition_keys"])
        sources, est = [], 0
        for e in body["files"]:
            if partition_matches(part_pred, e["partition"]):
                sources.append(e.get("uri")
                               or mf.file_uri(root, e["path"]))
                est += int(e.get("bytes") or 0)
        return self.submit(tenant, sources, *columns, filter=residual,
                           est_bytes=est, **kw)

    # -- scheduling ------------------------------------------------------

    def _pick_locked(self) -> ScanJob | None:
        """Round robin: the next tenant with queued work and no running
        job.  Called under the cv."""
        n = len(self._rr)
        for i in range(n):
            label = self._rr[(self._rr_pos + i) % n]
            if label in self._running:
                continue
            q = self._queues.get(label)
            if q:
                self._rr_pos = (self._rr_pos + i + 1) % n
                job = q.popleft()
                self._running[label] = job
                return job
        return None

    def _schedule_loop(self) -> None:
        last_reb = time.monotonic()
        while True:
            job = None
            with self._cv:
                if self._closed:
                    return
                job = self._pick_locked()
                if job is None:
                    self._cv.wait(timeout=self._reb_interval)
            if self._closed:
                return
            if job is not None:
                if self._draining:
                    # admitted before the drain and never started: it
                    # goes back untouched to the successor (its cursor,
                    # if any, is intact)
                    with self._cv:
                        self._running.pop(job.tenant, None)
                        self._cv.notify_all()
                    job._finish("drained")
                    continue
                t = threading.Thread(
                    target=self._drive_job, args=(job,),
                    name=f"tpq-serve:{job.tenant}", daemon=True)
                with self._cv:
                    self._job_threads = [d for d in self._job_threads
                                     if d.is_alive()]
                    self._job_threads.append(t)
                t.start()
            now = time.monotonic()
            if now - last_reb >= self._reb_interval:
                # outside every lock of the server: the rebalance reads
                # the telemetry and takes the arbiter's leaf lock
                self._arb.rebalance()
                last_reb = now

    # -- a job's thread --------------------------------------------------

    @staticmethod
    def _maybe_prefetcher(scan, label: str, opts: dict):
        """A started :class:`~tpuparquet_torch.serve.prefetch.
        PrefetchPlanner` for the job when it can pay: the prefetch on,
        a disk tier to warm and a byte-range source to warm it from (a
        local file gains nothing); else None."""
        from ..io.rangecache import disk_cache
        from .prefetch import PrefetchPlanner, prefetch_depth_default

        if prefetch_depth_default() <= 0:
            return None
        if disk_cache() is None:
            return None
        if not any(r is not None and getattr(r, "_source", None)
                   is not None for r in scan.readers):
            return None
        start, _total = scan._progress()
        return PrefetchPlanner(
            scan.readers, scan.units, label, start=start,
            unit_deadline=opts.get("unit_deadline")).start()

    def _drive_job(self, job: ScanJob) -> None:
        from ..shard.scan import ShardedScan
        from ..stats import collect_stats

        label = job.tenant
        t0 = time.monotonic()
        scan = None
        opts = job.options
        try:
            with _arbiter.tenant_scope(label):
                scan = ShardedScan(
                    job.sources, *job.columns, mesh=self.mesh,
                    on_error="quarantine",
                    retries=opts.get("retries"),
                    unit_deadline=opts.get("unit_deadline"),
                    scan_deadline=opts.get("scan_deadline"),
                    filter=opts.get("filter"),
                    resume_from=self._cursor_path(job),
                    checkpoint_every=opts.get("checkpoint_every"),
                    progress_label=label)
                job.scan = scan
                job.units_total = len(scan.units)
                job.state = "running"
                if self._draining:
                    scan.request_stop()  # raced the drain's broadcast
                with _on_card(scan), collect_stats() as st:
                    planner = self._maybe_prefetcher(scan, label, opts)
                    try:
                        for k, out in scan.run_iter():
                            if job.sink is not None:
                                job.sink(k, out)
                            else:
                                job.outputs[k] = out
                            job.units_done += 1
                            if planner is not None:
                                planner.note_progress(k)
                    finally:
                        if planner is not None:
                            planner.close()
                job.stats = st
                job.quarantine = scan.quarantine
                # the scan's own tally decides: it counts the quarantined
                # units too, which never reach the sink
                job.units_done = scan.progress.units_done
                job.units_quarantined = scan.progress.units_quarantined
                final = "drained" if scan.stopped else "done"
        except BaseException as e:  # noqa: BLE001 - reported on the job
            job.error = e
            if scan is not None:
                job.quarantine = scan.quarantine
                job.units_done = scan.progress.units_done
                job.units_quarantined = scan.progress.units_quarantined
            final = "failed"
        finally:
            if scan is not None:
                scan.close()
            job.scan = None
        self._arb.note_job_done(label, time.monotonic() - t0,
                                ok=final == "done")
        # refund the admission's byte charge: those bytes are no longer
        # in flight, so a job shed for them clears the check on retry
        self._arb.release(label, job.est_bytes)
        with self._cv:
            self._running.pop(label, None)
            self._finished.append(job)
            self._cv.notify_all()
        job._finish(final)

    # -- waiting ---------------------------------------------------------

    def wait_idle(self, timeout: float | None = None) -> bool:
        """Block until no job is queued or running (or ``timeout``
        passes); True when idle."""
        deadline = (time.monotonic() + timeout
                    if timeout is not None else None)
        with self._cv:
            while self._running or any(self._queues.values()):
                rem = None
                if deadline is not None:
                    rem = deadline - time.monotonic()
                    if rem <= 0:
                        return False
                self._cv.wait(timeout=rem if rem is not None else 1.0)
            return True

    # -- drain and shutdown ----------------------------------------------

    def request_drain(self) -> None:
        """Begin a graceful drain; safe in a signal handler (it sets
        flags and events only, and takes no lock)."""
        self._draining = True
        for job in list(self._running.values()):
            scan = job.scan
            if scan is not None:
                scan.request_stop()
        self._drain_event.set()

    def drain(self, timeout: float | None = None) -> bool:
        """Refuse admissions, stop every running scan at its next unit
        with its cursor flushed, hand the queued jobs back ``drained``,
        flush the telemetry.  True when every job was terminal in
        time."""
        self.request_drain()
        deadline = (time.monotonic() + timeout
                    if timeout is not None else None)
        drained_q: list[ScanJob] = []
        ok = True
        with self._cv:
            for q in self._queues.values():
                while q:
                    drained_q.append(q.popleft())
            self._cv.notify_all()
        for job in drained_q:
            job._finish("drained")
        with self._cv:
            while self._running:
                rem = None
                if deadline is not None:
                    rem = deadline - time.monotonic()
                    if rem <= 0:
                        ok = False
                        break
                self._cv.wait(timeout=rem if rem is not None else 1.0)
        self._flush_telemetry()
        return ok

    def _flush_telemetry(self) -> None:
        """A last registry export (when its writer is armed) and a drain
        tick of the time-series ring; the scans wrote their own progress
        files and post-mortems."""
        from ..obs import live as _live
        from ..obs import timeseries as _timeseries

        try:
            _live.export_now()
        except OSError:
            pass
        _timeseries.tick("serve_drain")

    def shutdown(self, *, drain: bool = True,
                 timeout: float | None = None) -> bool:
        """Drain (unless ``drain=False``), stop the scheduler, give back
        the shared resources and deactivate the arbiter.  Idempotent."""
        ok = True
        if drain and not self._closed:
            ok = self.drain(timeout=timeout)
        self._draining = True
        with self._cv:
            self._closed = True
            job_threads = list(self._job_threads)
            self._cv.notify_all()
        self._scheduler.join(timeout=5.0)
        # a job is terminal a moment before its thread has
        # unwound; a process that exits in that window tears native state
        # down under a live thread, so a clean shutdown joins them
        for d in job_threads:
            d.join(timeout=5.0)
        from ..kernels import arena as _arena
        from ..kernels import plancache as _plancache

        _arena.set_arena_retention(self._arena_keep_prev)
        _arena.trim_arena_pool(0)
        if self._plan_cache_armed:
            _plancache.set_plan_cache_budget(self._plancache_token)
            self._plan_cache_armed = False
        _arbiter.deactivate(self._arb)
        return ok

    def __enter__(self):
        return self

    def __exit__(self, exc_type, exc, tb):
        self.shutdown()

    # -- signals and status ----------------------------------------------

    def install_signal_handlers(self, signals=(signal.SIGTERM,)) -> None:
        """Route ``SIGTERM`` (by default) to :meth:`request_drain`; pair
        with :meth:`serve_forever`.  Main thread only (CPython's rule
        for ``signal.signal``)."""

        def _handler(signum, frame):
            self.request_drain()

        for s in signals:
            signal.signal(s, _handler)

    def serve_forever(self, poll_s: float = 0.2) -> None:
        """Block until a drain is asked for (by a signal or another
        thread), then finish it and return."""
        while not self._drain_event.wait(timeout=poll_s):
            pass
        self.drain()

    @property
    def draining(self) -> bool:
        return self._draining

    def status(self) -> dict:
        """The status document (``parquet_tool tenants`` renders it):
        each tenant's arbiter accounting with its queued and running
        jobs, and the finished jobs."""
        with self._cv:
            queued = {lb: [j.as_dict() for j in q]
                      for lb, q in self._queues.items()}
            running = {lb: j.as_dict()
                       for lb, j in self._running.items()}
            finished = [j.as_dict() for j in self._finished]
        tenants = self._arb.tenants_state()
        for lb, row in tenants.items():
            row["queued"] = queued.get(lb, [])
            row["running"] = running.get(lb)
        return {
            "total_workers": self._arb.total_workers,
            "shares": self._arb.shares(),
            "draining": self._draining,
            "state_dir": self.state_dir,
            "tenants": tenants,
            "finished": finished,
        }

    def write_status(self, path: str) -> None:
        """The status document as JSON, written atomically, for viewers
        in other processes."""
        import json

        from ..obs.live import atomic_write_text

        atomic_write_text(path, json.dumps(self.status(), indent=2,
                                           sort_keys=True) + "\n")
