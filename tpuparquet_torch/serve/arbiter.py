"""One worker budget for a process that runs many scans at once.

A serve process runs several tenants' scans concurrently over one set of
cores.  Sized alone, each scan's pools would take ``TPQ_PLAN_THREADS``
(else every usable core), so N concurrent scans would run N times the
cores in planner threads.  The arbiter holds ONE budget
(``TPQ_SERVE_WORKERS``, default the usable cores) and splits it into an
integer share a tenant:

* **fair shares with floors**: largest-remainder apportionment over the
  tenants' weights; each registered tenant gets at least one worker, and
  the shares never sum past the budget while it covers the tenant count.
* **feedback**: :meth:`ResourceArbiter.rebalance` folds the attribution
  ledgers' bound verdict (``obs/attribution.py``), the latency digests'
  unit p99 (``obs/digest.py``) and the windowed error-budget burn rate
  (``obs/slo.py``) into the weights, each boost bounded.
* **admission control**: :meth:`ResourceArbiter.admit` sheds a job before
  it starts (a full queue, a spent byte budget, a deadline the backlog
  cannot meet) with a retryable :class:`AdmissionRejected`.

A scan joins by running under :func:`tenant_scope`, a thread-local
binding that ``deadline.call_with_deadline`` and ``deadline.hedged_call``
carry onto their workers as they carry the trace context.  The budget
readers (``kernels/device.py`` ``_plan_threads``, ``io/writer.py``
``_write_threads``, ``compress.py`` ``_decode_budget``) ask
:func:`plan_budget` first and fall back to their own knobs when no
arbiter is active or the thread is unbound, so a scan outside a server
sizes its pools as it always did.

The arbiter's lock is a leaf: nothing else is called while it is held
(``rebalance`` reads the telemetry before taking it), and the share map
is replaced whole, so :func:`plan_budget` reads it without a lock.
"""

from __future__ import annotations

import math
import os
import threading
import warnings
from contextlib import contextmanager

from ..errors import AdmissionRejected, ServeStateError

__all__ = [
    "AdmissionRejected",
    "ServeStateError",
    "ResourceArbiter",
    "activate",
    "active",
    "deactivate",
    "plan_budget",
    "write_budget",
    "current_binding",
    "tenant_scope",
    "serve_workers",
    "queue_bound_default",
    "rebalance_interval_default",
    "warn_if_oversubscribed",
]


def _usable_cpus() -> int:
    """The CPUs this process may run on (its affinity mask), without
    importing the device stack: the budget readers import this module."""
    try:
        return len(os.sched_getaffinity(0)) or 1
    except (AttributeError, OSError):
        return os.cpu_count() or 1


def serve_workers() -> int:
    """The worker budget of one serve process:
    ``TPQ_SERVE_WORKERS`` when set, else the usable core count."""
    v = os.environ.get("TPQ_SERVE_WORKERS")
    if v is not None:
        try:
            return max(int(v), 1)
        except ValueError:
            pass  # malformed override falls back to the default
    return _usable_cpus()


def queue_bound_default() -> int:
    """Per-tenant admission-queue depth bound (``TPQ_SERVE_QUEUE``,
    default 8): submissions past it are load-shed with a retryable
    :class:`AdmissionRejected` instead of queueing unboundedly."""
    v = os.environ.get("TPQ_SERVE_QUEUE")
    if v is not None:
        try:
            return max(int(v), 1)
        except ValueError:
            pass
    return 8


def rebalance_interval_default() -> float:
    """Seconds between the scan server's rebalances
    (``TPQ_SERVE_REBALANCE_S``, default 1.0, at least 0.05)."""
    v = os.environ.get("TPQ_SERVE_REBALANCE_S")
    if v is not None:
        try:
            return max(float(v), 0.05)
        except ValueError:
            pass
    return 1.0


class _TenantState:
    """Arbiter-side per-tenant record; every field is written only
    under the owning arbiter's lock."""

    __slots__ = (
        "label", "weight", "byte_budget", "latency_target_ms",
        "error_rate_target", "share", "bytes_admitted", "admitted",
        "rejected", "jobs_done", "jobs_failed", "est_job_s",
        "last_bound", "last_burn", "last_p99_ms", "_base_counters",
    )

    def __init__(self, label: str, weight: float, byte_budget,
                 latency_target_ms, error_rate_target):
        self.label = label
        self.weight = max(float(weight), 1e-6)
        self.byte_budget = byte_budget
        self.latency_target_ms = latency_target_ms
        self.error_rate_target = error_rate_target
        self.share = 1
        self.bytes_admitted = 0
        self.admitted = 0
        self.rejected = 0
        self.jobs_done = 0
        self.jobs_failed = 0
        self.est_job_s = None
        self.last_bound = None      # stage verdict, e.g. "plan-bound"
        self.last_burn = None       # windowed error-budget burn rate
        self.last_p99_ms = None     # unit p99 from the exact digests
        self._base_counters = {}    # ledger counters at last rebalance

    def as_dict(self) -> dict:
        return {
            "weight": self.weight,
            "share": self.share,
            "byte_budget": self.byte_budget,
            "bytes_admitted": self.bytes_admitted,
            "admitted": self.admitted,
            "rejected": self.rejected,
            "jobs_done": self.jobs_done,
            "jobs_failed": self.jobs_failed,
            "est_job_s": self.est_job_s,
            "bound": self.last_bound,
            "burn": self.last_burn,
            "p99_ms": self.last_p99_ms,
        }


class ResourceArbiter:
    """One global core budget apportioned into per-tenant shares.

    The share map is an immutable-by-convention dict REPLACED
    wholesale under the lock on every recompute; readers
    (:func:`plan_budget` on the unit hot path) take no lock at all —
    they read whichever complete map is current.  The arbiter lock is
    a leaf: nothing is called while holding it."""

    def __init__(self, total_workers: int | None = None):
        self.total_workers = (total_workers if total_workers is not None
                              else serve_workers())
        if self.total_workers < 1:
            raise ValueError("total_workers must be >= 1")
        self._lock = threading.Lock()
        self._tenants: dict[str, _TenantState] = {}
        self._shares: dict[str, int] = {}

    # -- tenant registry -------------------------------------------------

    def register(self, label: str, *, weight: float = 1.0,
                 byte_budget: int | None = None,
                 latency_target_ms: float | None = None,
                 error_rate_target: float | None = None) -> None:
        """Add (or re-weight) a tenant and recompute shares.

        ``byte_budget`` caps IN-FLIGHT admitted bytes (admission
        control, not a rate limit): :meth:`admit` charges the
        account, :meth:`release` refunds it when the job reaches a
        terminal state, so a shed job becomes admissible again once
        the budget frees up.  ``latency_target_ms`` /
        ``error_rate_target`` are this tenant's SLO targets — the
        adaptive loop boosts tenants violating them."""
        with self._lock:
            t = self._tenants.get(label)
            if t is None:
                t = _TenantState(label, weight, byte_budget,
                                 latency_target_ms, error_rate_target)
                self._tenants[label] = t
            else:
                t.weight = max(float(weight), 1e-6)
                t.byte_budget = byte_budget
                t.latency_target_ms = latency_target_ms
                t.error_rate_target = error_rate_target
            self._recompute_locked()

    def unregister(self, label: str) -> None:
        with self._lock:
            self._tenants.pop(label, None)
            self._recompute_locked()

    def tenants(self) -> list[str]:
        with self._lock:
            return sorted(self._tenants)

    def tenants_state(self) -> dict:
        """Per-tenant accounting snapshot."""
        with self._lock:
            return {t.label: t.as_dict()
                    for t in self._tenants.values()}

    # -- shares ----------------------------------------------------------

    def shares(self) -> dict[str, int]:
        return dict(self._shares)

    def share_of(self, label: str) -> int | None:
        """Lock-free: reads the current complete share map."""
        return self._shares.get(label)

    def _effective_weight(self, t: _TenantState) -> float:
        """Feedback-adjusted weight; every boost is BOUNDED so one
        pathological tenant cannot absorb the whole budget."""
        w = t.weight
        if t.last_burn is not None and t.last_burn > 1.0:
            # burning its error budget: more workers shorten the unit
            # critical path and the retry/quarantine backlog
            w *= min(1.0 + math.log2(t.last_burn + 1.0), 4.0)
        if t.last_bound == "plan-bound":
            w *= 1.5  # planner threads are the direct lever
        if (t.latency_target_ms and t.last_p99_ms
                and t.last_p99_ms > t.latency_target_ms):
            w *= min(t.last_p99_ms / t.latency_target_ms, 4.0)
        return w

    def _recompute_locked(self) -> None:
        tenants = list(self._tenants.values())
        if not tenants:
            self._shares = {}
            return
        n, total = len(tenants), self.total_workers
        if total <= n:
            # more tenants than workers: the floor IS the share —
            # bounded oversubscription (one worker each), never zero
            shares = {t.label: 1 for t in tenants}
        else:
            weights = {t.label: self._effective_weight(t)
                       for t in tenants}
            wsum = sum(weights.values())
            rest = total - n  # after the 1-worker floors
            quota = {lb: rest * w / wsum for lb, w in weights.items()}
            shares = {lb: 1 + int(q) for lb, q in quota.items()}
            leftover = total - sum(shares.values())
            # largest remainder, label-ordered for determinism
            order = sorted(quota, key=lambda lb: (-(quota[lb] % 1), lb))
            for lb in order[:leftover]:
                shares[lb] += 1
        for t in tenants:
            t.share = shares[t.label]
        self._shares = shares  # wholesale swap: lock-free readers

    # -- admission control -----------------------------------------------

    def admit(self, label: str, *, est_bytes: int = 0,
              deadline_s: float | None = None, queue_depth: int = 0,
              queue_bound: int | None = None) -> None:
        """Admit one job or raise :class:`AdmissionRejected`.

        Checks, in order: bounded queue (``queue_depth`` vs
        ``queue_bound``), in-flight byte budget, and the deadline
        budget — a job whose ``deadline_s`` the current backlog
        cannot meet (estimated from the tenant's recent job-duration
        EWMA) is shed NOW rather than admitted to time out in line.
        On success the tenant's byte account is charged; a caller
        that fails to enqueue must :meth:`retract`."""
        bound = (queue_bound if queue_bound is not None
                 else queue_bound_default())
        with self._lock:
            t = self._tenants.get(label)
            if t is None:
                raise KeyError(f"unknown tenant {label!r}: "
                               f"register() it before submitting")
            retry = t.est_job_s if t.est_job_s is not None else 1.0
            if queue_depth >= bound:
                t.rejected += 1
                raise AdmissionRejected(
                    f"tenant {label!r} queue is full "
                    f"({queue_depth}/{bound}); retry in {retry:.1f}s",
                    tenant=label, reason="queue_full",
                    retry_after_s=retry)
            if (t.byte_budget is not None
                    and t.bytes_admitted + est_bytes > t.byte_budget):
                t.rejected += 1
                raise AdmissionRejected(
                    f"tenant {label!r} byte budget exhausted "
                    f"({t.bytes_admitted}+{est_bytes} > "
                    f"{t.byte_budget}); retry in {retry:.1f}s",
                    tenant=label, reason="byte_budget",
                    retry_after_s=retry)
            if (deadline_s is not None and t.est_job_s is not None
                    and t.est_job_s * (queue_depth + 1) > deadline_s):
                t.rejected += 1
                raise AdmissionRejected(
                    f"tenant {label!r} backlog (~{t.est_job_s:.1f}s x "
                    f"{queue_depth + 1} jobs) cannot meet the "
                    f"{deadline_s:g}s deadline; retry in {retry:.1f}s",
                    tenant=label, reason="deadline_budget",
                    retry_after_s=retry)
            t.bytes_admitted += est_bytes
            t.admitted += 1

    def retract(self, label: str, est_bytes: int = 0) -> None:
        """Roll back one :meth:`admit` whose job never enqueued."""
        with self._lock:
            t = self._tenants.get(label)
            if t is None:
                return
            t.bytes_admitted = max(t.bytes_admitted - est_bytes, 0)
            t.admitted = max(t.admitted - 1, 0)
            t.rejected += 1

    def release(self, label: str, est_bytes: int = 0) -> None:
        """Refund one finished job's byte charge.

        Unlike :meth:`retract` this is the NORMAL end of an admitted
        job's life (done, failed, or drained — the bytes are no
        longer in flight either way), so it does not touch the
        admitted/rejected tallies."""
        with self._lock:
            t = self._tenants.get(label)
            if t is None:
                return
            t.bytes_admitted = max(t.bytes_admitted - est_bytes, 0)

    def note_job_done(self, label: str, seconds: float, *,
                      ok: bool = True) -> None:
        """Fold one finished job into the duration EWMA the deadline
        admission check prices the backlog with."""
        with self._lock:
            t = self._tenants.get(label)
            if t is None:
                return
            t.jobs_done += 1
            if not ok:
                t.jobs_failed += 1
            t.est_job_s = (seconds if t.est_job_s is None
                           else 0.5 * t.est_job_s + 0.5 * seconds)

    # -- adaptive feedback -----------------------------------------------

    def rebalance(self) -> dict[str, int]:
        """Recompute shares from live feedback and return the new map.

        Feedback is gathered from the obs registries BEFORE the
        arbiter lock is taken (leaf-lock discipline): the per-label
        ledger counters give the stage verdict and the
        WINDOWED error-budget burn (delta since the last rebalance),
        and the exact digests give the unit p99.  All three are
        optional — with telemetry off the arbiter degrades to static
        weighted fair sharing."""
        with self._lock:
            labels = list(self._tenants)
        if not labels:
            return {}
        from ..obs import attribution as _attr
        from ..obs import digest as _digest
        from ..obs.slo import error_rate

        led = _attr.ledgers_state()
        reg = _digest.digests()
        snap = reg.snapshot() if reg is not None else {}
        feedback = {}
        for label in labels:
            counters = (led.get(label) or {}).get("counters") or {}
            bound = _attr.stage_verdict(counters)
            d = snap.get((label, "unit"))
            p99_us = d.quantile(0.99) if d is not None and d.n else None
            feedback[label] = (bound, counters, p99_us)
        with self._lock:
            for label, (bound, counters, p99_us) in feedback.items():
                t = self._tenants.get(label)
                if t is None:
                    continue
                t.last_bound = bound
                t.last_p99_ms = (p99_us / 1000.0
                                 if p99_us is not None else None)
                window = {k: v - t._base_counters.get(k, 0)
                          for k, v in counters.items()}
                t._base_counters = dict(counters)
                rate, _, attempts = error_rate(window)
                t.last_burn = (rate / t.error_rate_target
                               if rate is not None and attempts
                               and t.error_rate_target else None)
            self._recompute_locked()
            return dict(self._shares)


# ----------------------------------------------------------------------
# Process-wide activation + thread binding
# ----------------------------------------------------------------------

_mod_lock = threading.Lock()
_active: ResourceArbiter | None = None
_binding = threading.local()


def activate(arb: ResourceArbiter) -> None:
    """Make ``arb`` the process's arbiter (one a process: two arbiters
    splitting the same cores apart would oversubscribe them again)."""
    global _active
    with _mod_lock:
        if _active is not None and _active is not arb:
            raise ServeStateError(
                "another ResourceArbiter is already active in this "
                "process; shut the other server down first")
        _active = arb


def deactivate(arb: ResourceArbiter) -> None:
    global _active
    with _mod_lock:
        if _active is arb:
            _active = None


def active() -> ResourceArbiter | None:
    return _active


@contextmanager
def tenant_scope(label: str | None):
    """Bind the calling thread to a tenant: thread-budget reads under
    this scope size from the tenant's arbiter share.  Re-entrant and
    restoring; ``label=None`` is the explicit unbind (a worker that
    adopted no binding)."""
    prev = getattr(_binding, "label", None)
    _binding.label = label
    try:
        yield
    finally:
        _binding.label = prev


def current_binding() -> str | None:
    """The calling thread's tenant label, for propagation onto worker
    threads (``deadline.call_with_deadline`` and ``deadline.hedged_call``
    capture it as they capture the trace context)."""
    return getattr(_binding, "label", None)


def plan_budget() -> int | None:
    """The calling thread's worker budget under the active arbiter,
    or None when no arbiter is active / the thread is unbound / the
    tenant is unknown — callers fall back to the legacy env knobs.
    Lock-free on purpose: this sits on the per-unit plan path."""
    arb = _active
    if arb is None:
        return None
    label = getattr(_binding, "label", None)
    if label is None:
        return None
    return arb.share_of(label)


def write_budget() -> int | None:
    """Writer-pool twin of :func:`plan_budget`: one tenant share
    bounds ALL of that tenant's workers — the library never runs the
    plan and encode pools for the same operation, so the share is not
    split between them."""
    return plan_budget()


# ----------------------------------------------------------------------
# Legacy-knob oversubscription guard
# ----------------------------------------------------------------------

_warn_lock = threading.Lock()
_warned_oversub = False


def warn_if_oversubscribed() -> int:
    """One-shot guard: when ``TPQ_PLAN_THREADS`` and
    ``TPQ_WRITE_THREADS`` are both set and together exceed the usable
    cores, warn once (pointing at the arbiter) and publish the excess as
    the live registry's ``threads_oversubscribed`` gauge.  Returns the
    excess (0: not oversubscribed, a knob unset or malformed)."""
    global _warned_oversub
    p = os.environ.get("TPQ_PLAN_THREADS")
    w = os.environ.get("TPQ_WRITE_THREADS")
    if not p or not w:
        return 0
    try:
        total = int(p) + int(w)
    except ValueError:
        return 0
    excess = total - _usable_cpus()
    if excess <= 0:
        return 0
    with _warn_lock:
        first = not _warned_oversub
        _warned_oversub = True
    if first:
        warnings.warn(
            f"TPQ_PLAN_THREADS+TPQ_WRITE_THREADS={total} exceeds the "
            f"{total - excess} usable core(s) by {excess}: concurrent "
            f"scan+write pools will contend; run under "
            f"tpuparquet_torch.serve.ResourceArbiter for one global "
            f"worker budget instead of per-pool knobs",
            RuntimeWarning, stacklevel=3)
    from ..obs.live import registry
    registry().gauge("threads_oversubscribed", float(excess))
    return excess


def _reset_oversub_warning() -> None:
    """Test hook: re-arm the one-shot warning."""
    global _warned_oversub
    with _warn_lock:
        _warned_oversub = False
