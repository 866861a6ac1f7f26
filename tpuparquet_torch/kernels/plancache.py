"""Footer-keyed plan cache: transport decisions survive re-reads.

The device plan phase runs a wire-cost competition per PLAIN
fixed-width page (snappy tokens vs byte-plane RLE vs delta lanes —
``kernels/device.py``): entropy sample windows, token scans, full
min/max passes.  Those decisions are deterministic given the file's
bytes, and the footer pins the file's identity — a re-read of an
unchanged file re-derives exactly the same verdicts.  This cache keys
the per-page *plan artifact* (transport choice + the small geometry
needed to rebuild it: delta width/min, per-lane plane specs) by
``(footer fingerprint, row group, column)`` so epoch-style training
re-reads skip the competition and go straight to committing the known
winner.  Staged bytes are NEVER cached — every read restages from the
file, so a hint can only change *which lossless transport* ships, not
the decoded bytes.

Budgeted LRU: ``TPQ_PLAN_CACHE_MB`` (default off — 0/unset disables
everything, lookups return None and nothing is stored).  Counters
``plan_cache_hits`` / ``plan_cache_misses`` / ``plan_cache_evictions``
ride :class:`~tpuparquet_torch.stats.DecodeStats` and merge exactly across
workers.  Invalidation:

* a rewritten file carries a new footer, so its key changes and stale
  entries age out of the LRU;
* a corruption event (CRC mismatch, corrupt page/chunk) during a plan
  drops every entry under that fingerprint
  (:func:`invalidate_fingerprint`) — the file on disk may no longer be
  what the footer claims.
"""

from __future__ import annotations

import os
import threading
from collections import OrderedDict

import numpy as np

__all__ = ["PlanCache", "plan_cache", "plan_cache_budget",
           "set_plan_cache_budget",
           "invalidate_fingerprint", "clear_plan_cache"]

_override_lock = threading.Lock()
_budget_override_mb: float | None = None


def set_plan_cache_budget(mb: float | None) -> float | None:
    """Set the budget in MB for the process, over ``TPQ_PLAN_CACHE_MB``
    (None clears the override): the scan server arms a shared plan cache
    for its lifetime without touching the environment.  Returns the
    previous override, which the server restores on shutdown."""
    global _budget_override_mb
    with _override_lock:
        prev = _budget_override_mb
        _budget_override_mb = mb
    return prev


def plan_cache_budget() -> int:
    """Cache byte budget (0 = disabled): the override of
    :func:`set_plan_cache_budget` when one is set, else
    ``TPQ_PLAN_CACHE_MB``.  Read per call so same-process A/B runs can
    flip it."""
    mb = _budget_override_mb
    if mb is not None:
        return max(int(float(mb) * (1 << 20)), 0)
    v = os.environ.get("TPQ_PLAN_CACHE_MB")
    if not v:
        return 0
    try:
        return max(int(float(v) * (1 << 20)), 0)
    except ValueError:
        return 0


def _entry_nbytes(record) -> int:
    """LRU accounting: approximate in-memory size of one column's page
    hint list (tuples of small ints/strings plus the per-lane plane
    specs, which may carry a tiny cost array)."""
    n = 96  # key + OrderedDict node overhead
    for h in record:
        n += 56
        if h is None:
            continue
        params = h[2] if len(h) > 2 else None
        if params is None:
            continue
        if isinstance(params, (list, tuple)):
            for p in params:
                n += 48
                if isinstance(p, tuple):
                    for q in p:
                        n += (q.nbytes if isinstance(q, np.ndarray)
                              else 28)
        else:
            n += 48
    return n


class PlanCache:
    """Thread-safe byte-budgeted LRU of per-column page-hint lists."""

    __slots__ = ("_lock", "_entries", "_bytes")

    def __init__(self):
        self._lock = threading.Lock()
        # key -> (record, nbytes); move_to_end on hit = LRU order
        self._entries: OrderedDict = OrderedDict()
        self._bytes = 0

    def lookup(self, key):
        """The cached hint list for ``key`` or None; counts
        hits/misses on the calling thread's active collector."""
        from ..stats import current_stats

        st = current_stats()
        with self._lock:
            got = self._entries.get(key)
            if got is not None:
                self._entries.move_to_end(key)
        if got is None:
            if st is not None:
                st.plan_cache_misses += 1
            return None
        if st is not None:
            st.plan_cache_hits += 1
        return got[0]

    def store(self, key, record, budget: int) -> None:
        """Insert/refresh ``key``; evicts LRU entries past ``budget``
        bytes (evictions counted on the calling thread's collector)."""
        nbytes = _entry_nbytes(record)
        if nbytes > budget:
            return  # one oversized entry must not flush the whole cache
        evicted = 0
        with self._lock:
            old = self._entries.pop(key, None)
            if old is not None:
                self._bytes -= old[1]
            self._entries[key] = (record, nbytes)
            self._bytes += nbytes
            while self._bytes > budget and self._entries:
                _, (_, nb) = self._entries.popitem(last=False)
                self._bytes -= nb
                evicted += 1
        if evicted:
            from ..stats import current_stats

            st = current_stats()
            if st is not None:
                st.plan_cache_evictions += evicted

    def invalidate_fingerprint(self, fingerprint) -> None:
        """Drop every entry of one file identity (corruption seen)."""
        if fingerprint is None:
            return
        with self._lock:
            stale = [k for k in self._entries if k[0] == fingerprint]
            for k in stale:
                _, nb = self._entries.pop(k)
                self._bytes -= nb

    def clear(self) -> None:
        with self._lock:
            self._entries.clear()
            self._bytes = 0

    @property
    def nbytes(self) -> int:
        return self._bytes

    def __len__(self) -> int:
        return len(self._entries)


_CACHE = PlanCache()


def plan_cache() -> PlanCache | None:
    """The process-wide cache when ``TPQ_PLAN_CACHE_MB`` enables it,
    else None (the hot path's single gate)."""
    return _CACHE if plan_cache_budget() > 0 else None


def invalidate_fingerprint(fingerprint) -> None:
    """Drop a file's cached plans (a corruption event) — valid
    whether or not the cache is currently enabled."""
    _CACHE.invalidate_fingerprint(fingerprint)


def clear_plan_cache() -> None:
    """Drop everything (tests / explicit reset)."""
    _CACHE.clear()
