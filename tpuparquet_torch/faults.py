"""Deterministic fault injection, retry with backoff, and the quarantine
report.

The port of ``tpuparquet/faults.py``.  Three parts:

* **Injection** — named fault sites in the read and dispatch paths fire
  deterministically (by site and occurrence count, no randomness) under
  an :func:`inject_faults` scope; one module-global ``is None`` check a
  site when no scope is active.  The sites carry the reference's names
  and context keys, so one rule fires at the same place in both
  packages.
* **Retry** — :func:`retry_transient` retries transient I/O with bounded
  exponential backoff (:func:`backoff_delays`, which the resilient device
  read shares).
* **Quarantine report** — :class:`QuarantineReport` holds the exact
  coordinates (file, row group, column, page) and error class of every
  unit or file a quarantining scan isolated.

Fault sites (``site`` of :meth:`FaultInjector.inject`) and their kinds:

====================================  =====================================
``format.footer.tail``                the 8-byte length and magic read
                                      (``format/footer.py``) — ``corrupt``,
                                      ``truncate``
``format.footer.blob``                the footer's thrift bytes —
                                      ``corrupt``, ``truncate``
``io.reader.open``                    ``FileReader.__init__`` —
                                      ``oserror``, ``transient``
``io.reader.chunk_read``              a column chunk's bytes
                                      (``FileReader.chunk_blob``; a path's
                                      range read is retried) — ``oserror``,
                                      ``transient``, ``corrupt``,
                                      ``truncate``
``io.chunk.hang``                     the same read — ``hang``
``io.chunk.page_payload``             the host chunk read's page loop
                                      (``io/chunk.py`` ``read_chunk``) —
                                      ``corrupt``, ``truncate``
``io.pages.page_decode``              a data page's bytes in the host
                                      page decoders — ``corrupt``,
                                      ``truncate``
``format.pageindex``                  the page index and bloom filter
                                      reads (``FileReader.page_index``,
                                      ``bloom_filter``; a failure reads as
                                      no index) — ``oserror``,
                                      ``transient``, ``corrupt``,
                                      ``truncate``
``io.pages.page_write``               a data page's native write (a
                                      firing drops the page to the pure
                                      path, which writes the same
                                      bytes) — ``transient``
``kernels.device.page_payload``       the device plan's page loop —
                                      ``corrupt``, ``truncate``
``kernels.device.page_dispatch``      the device plan, a data page —
                                      ``dispatch``
``kernels.device.unit_dispatch``      ``_finish_row_group``, a unit —
                                      ``dispatch``
``kernels.device.hang``               ``_finish_row_group`` — ``hang``
``io.remote.open``                    a byte-range source's open
                                      (``io/source.py``) — ``oserror``,
                                      ``transient``
``io.remote.throttle``                each range request, before the read
                                      (the HTTP 429 slot) — ``transient``
``io.remote.range``                   a range request's payload (a short
                                      response raises transient, never
                                      returns) — ``oserror``,
                                      ``transient``, ``corrupt``,
                                      ``truncate``
``dataset.manifest.load``             a manifest or commit journal's
                                      bytes (``dataset/manifest.py``) —
                                      ``oserror``, ``transient``,
                                      ``corrupt``, ``truncate``
``dataset.manifest.write``            before a manifest or journal
                                      envelope's write — ``oserror``,
                                      ``transient``
``dataset.file.promote``              a staged data file's move into its
                                      partition (``dataset/writer.py``)
                                      — ``oserror``, ``transient``
====================================  =====================================

Kinds: ``oserror`` raises ``OSError(EIO)``; ``transient``
:class:`~tpuparquet_torch.errors.TransientIOError`; ``dispatch``
:class:`~tpuparquet_torch.errors.DeviceDispatchError`; ``corrupt`` XORs
one byte of the stream (``offset=``, ``xor=``); ``truncate`` drops the
tail (``keep=``); ``hang`` blocks the calling thread (``seconds=``,
default 30) but returns as soon as its :func:`inject_faults` scope
exits, so no abandoned deadline worker outlives a test.  A rule fires on
the first ``times`` matching calls after skipping ``after``.

The active injector is process-global (the plan workers of
``kernels/device.py`` must see it); each delivered fault counts
``faults_injected`` on the firing thread's collector and is appended to
:attr:`FaultInjector.log`.
"""

from __future__ import annotations

import contextlib
import errno as _errno
import os
import sys
import threading
import time
import zlib

from .errors import DeviceDispatchError, TransientIOError

__all__ = [
    "FaultInjector",
    "inject_faults",
    "fault_point",
    "filter_bytes",
    "retry_transient",
    "backoff_delays",
    "is_transient",
    "QuarantineReport",
    "SITES",
    "ChaosSchedule",
    "chaos_scope",
]

#: Every instrumented site and the kinds it supports.  Sites match rules
#: by string equality, so a drifted name never fires: the tests check
#: the instrumented sites against this table.
SITES: dict[str, tuple] = {
    "io.reader.open": ("oserror", "transient"),
    "io.reader.chunk_read": ("oserror", "transient",
                             "corrupt", "truncate"),
    "io.chunk.page_payload": ("corrupt", "truncate"),
    "io.chunk.hang": ("hang",),
    "io.pages.page_decode": ("corrupt", "truncate"),
    "io.pages.page_write": ("transient",),
    "kernels.device.page_payload": ("corrupt", "truncate"),
    "kernels.device.page_dispatch": ("dispatch",),
    "kernels.device.unit_dispatch": ("dispatch",),
    "kernels.device.hang": ("hang",),
    "format.footer.tail": ("corrupt", "truncate"),
    "format.footer.blob": ("corrupt", "truncate"),
    "format.pageindex": ("oserror", "transient",
                         "corrupt", "truncate"),
    "io.remote.open": ("oserror", "transient"),
    "io.remote.throttle": ("transient",),
    "io.remote.range": ("oserror", "transient",
                        "corrupt", "truncate"),
    "dataset.manifest.write": ("oserror", "transient"),
    "dataset.manifest.load": ("oserror", "transient",
                              "corrupt", "truncate"),
    "dataset.file.promote": ("oserror", "transient"),
}

_active: "FaultInjector | None" = None


class _Rule:
    __slots__ = ("site", "kind", "times", "after", "kw", "match",
                 "seen", "fired")

    def __init__(self, site, kind, times, after, match, kw):
        self.site = site
        self.kind = kind
        self.times = times
        self.after = after
        self.match = match or {}
        self.kw = kw
        self.seen = 0    # matching calls observed
        self.fired = 0   # faults delivered


class FaultInjector:
    """A deterministic fault plan: rules added with :meth:`inject`, and a
    :attr:`log` of ``{"site", "kind", **ctx}`` for every fault
    delivered."""

    def __init__(self):
        self.rules: list[_Rule] = []
        self.log: list[dict] = []
        self._lock = threading.Lock()

    def inject(self, site: str, kind: str, *, times: int = 1,
               after: int = 0, match: dict | None = None, **kw) -> _Rule:
        """Arm a rule: at ``site``, deliver ``kind`` on the first
        ``times`` matching calls after skipping ``after``.  ``match``
        restricts by context equality (``match={"column": "a"}``); the
        rest of ``kw`` parameterizes the kind (``offset``/``xor`` for
        ``corrupt``, ``keep`` for ``truncate``, ``seconds`` for
        ``hang``)."""
        r = _Rule(site, kind, times, after, match, kw)
        with self._lock:
            self.rules.append(r)
        return r

    def _next_rule(self, site: str, ctx: dict,
                   kinds: tuple) -> "_Rule | None":
        with self._lock:
            for r in self.rules:
                if r.site != site or r.kind not in kinds:
                    continue
                if any(ctx.get(k) != v for k, v in r.match.items()):
                    continue
                r.seen += 1
                if r.seen <= r.after or r.fired >= r.times:
                    continue
                r.fired += 1
                self.log.append({"site": site, "kind": r.kind, **ctx})
                return r
        return None

    @staticmethod
    def _record_stats(site: str, kind: str, ctx: dict) -> None:
        from .obs.recorder import flight
        from .stats import current_stats

        # the flight recorder sees every delivered fault, collector or not
        flight(f"fault:{kind}", site=site, **ctx)
        st = current_stats()
        if st is not None:
            st.faults_injected += 1
            if st.events is not None:
                st.events.fault(site=site, kind=kind, **ctx)

    def fire_raise(self, site: str, ctx: dict) -> None:
        # byte kinds never match here: a site may host both hooks, and a
        # byte rule waits for the byte hook
        r = self._next_rule(site, ctx, ("oserror", "transient",
                                        "dispatch", "hang"))
        if r is None:
            return
        self._record_stats(site, r.kind, ctx)
        if r.kind == "hang":
            # a read or dispatch that never returns: block to the cap, or
            # until this injector's scope exits
            seconds = r.kw.get("seconds", 30.0)
            t0 = time.monotonic()
            while _active is self and time.monotonic() - t0 < seconds:
                time.sleep(0.005)
            return
        if r.kind == "oserror":
            raise OSError(_errno.EIO, f"injected I/O error at {site}")
        if r.kind == "transient":
            raise TransientIOError(
                f"injected transient fault at {site}", **_coords(ctx))
        raise DeviceDispatchError(
            f"injected device dispatch failure at {site}", **_coords(ctx))

    def fire_bytes(self, site: str, data, ctx: dict):
        r = self._next_rule(site, ctx, ("corrupt", "truncate"))
        if r is None:
            return data
        self._record_stats(site, r.kind, ctx)
        if r.kind == "truncate":
            keep = r.kw.get("keep", len(data) // 2)
            return bytes(data[:keep])
        buf = bytearray(data)
        if not buf:
            return data
        off = r.kw.get("offset", len(buf) // 2) % len(buf)
        buf[off] ^= r.kw.get("xor", 0xFF) or 0xFF
        return bytes(buf)


def _coords(ctx: dict) -> dict:
    return {k: ctx[k] for k in ("file", "row_group", "column", "page")
            if k in ctx}


@contextlib.contextmanager
def inject_faults():
    """A scope with a fresh active :class:`FaultInjector` (yields it).
    Process-global and not reentrant: one scope at a time."""
    global _active
    if _active is not None:
        raise RuntimeError("inject_faults scopes do not nest")
    inj = FaultInjector()
    _active = inj
    try:
        yield inj
    finally:
        _active = None


def fault_point(site: str, **ctx) -> None:
    """Instrumentation hook: may raise an injected fault (a no-op with no
    injector active)."""
    ch = _chaos
    if ch is not None:
        ch.perturb(site)
    inj = _active
    if inj is not None:
        inj.fire_raise(site, ctx)


def filter_bytes(site: str, data, **ctx):
    """Instrumentation hook for a byte stream: ``data`` itself (the
    common case, no copy), or an injected corruption or truncation of
    it."""
    ch = _chaos
    if ch is not None:
        ch.perturb(site)
    inj = _active
    if inj is not None:
        return inj.fire_bytes(site, data, ctx)
    return data


# ----------------------------------------------------------------------
# Schedule chaos: seeded interleaving perturbation at the fault sites
# ----------------------------------------------------------------------

_chaos: "ChaosSchedule | None" = None


class ChaosSchedule:
    """A seeded perturbation plan over the fault sites: each call may
    yield the GIL or sleep a few microseconds, as a pure function of
    (seed, site, occurrence), and the interpreter's switch interval is
    pinned to a seed-derived value.  What chaos runs assert is that the
    output does not change, not that the schedule repeats."""

    _SLEEP_MAX_S = 200e-6

    def __init__(self, seed: int):
        self.seed = int(seed)
        # racy counts only shift which perturbation a thread draws
        self._counts: dict[str, int] = {}
        self.perturbations = 0
        import random

        rng = random.Random(self.seed)
        self.switch_interval = 10 ** rng.uniform(-6.0, -4.0)

    def _draw(self, site: str, n: int) -> float:
        key = f"{self.seed}:{site}:{n}".encode()
        return (zlib.crc32(key) & 0xFFFFFFFF) / 0x100000000

    def perturb(self, site: str) -> None:
        n = self._counts.get(site, 0)
        self._counts[site] = n + 1
        u = self._draw(site, n)
        if u < 0.4:
            return
        self.perturbations += 1
        if u < 0.7:
            time.sleep(0)
        else:
            time.sleep((u - 0.7) / 0.3 * self._SLEEP_MAX_S)


@contextlib.contextmanager
def chaos_scope(seed: int | None = None):
    """A scope with an active :class:`ChaosSchedule` (yields it); ``seed``
    defaults to ``TPQ_CHAOS_SEED`` (else 0).  Process-global and not
    reentrant; composes with :func:`inject_faults` (chaos first)."""
    global _chaos
    if _chaos is not None:
        raise RuntimeError("chaos_scope scopes do not nest")
    if seed is None:
        seed = _env_int("TPQ_CHAOS_SEED", 0)
    sched = ChaosSchedule(seed)
    prev = sys.getswitchinterval()
    sys.setswitchinterval(sched.switch_interval)
    _chaos = sched
    try:
        yield sched
    finally:
        _chaos = None
        sys.setswitchinterval(prev)


# ----------------------------------------------------------------------
# Retry with bounded exponential backoff
# ----------------------------------------------------------------------

_TRANSIENT_ERRNOS = frozenset(
    getattr(_errno, name)
    for name in ("EIO", "EAGAIN", "EBUSY", "EINTR", "ETIMEDOUT",
                 "ENETRESET", "ECONNRESET", "ESTALE")
    if hasattr(_errno, name))

_PERMANENT_OS = (FileNotFoundError, PermissionError, IsADirectoryError,
                 NotADirectoryError)


def is_transient(exc: BaseException) -> bool:
    """Is this failure worth a retry?  A TransientIOError always; a plain
    OSError only for a retryable errno (a missing file does not heal)."""
    if isinstance(exc, TransientIOError):
        return True
    if isinstance(exc, _PERMANENT_OS):
        return False
    if isinstance(exc, (TimeoutError, InterruptedError, ConnectionError)):
        return True
    if isinstance(exc, OSError):
        return exc.errno in _TRANSIENT_ERRNOS
    return False


def _env_float(name: str, default: float) -> float:
    try:
        return float(os.environ.get(name, ""))
    except ValueError:
        return default


def _env_int(name: str, default: int) -> int:
    try:
        return int(os.environ.get(name, ""))
    except ValueError:
        return default


def backoff_delays(retries: int | None = None, base: float | None = None,
                   cap: float | None = None, jitter: float | None = None,
                   seed: int | None = None) -> list[float]:
    """The bounded exponential schedule ``[base * 2^0, base * 2^1, ...]``
    clamped to ``cap``, one entry a retry.  Defaults from the
    environment: ``TPQ_IO_RETRIES`` (3), ``TPQ_RETRY_BASE_S`` (0.01),
    ``TPQ_RETRY_MAX_S`` (0.5), ``TPQ_RETRY_JITTER`` (0.0: the exact
    schedule; else each delay spreads by up to that fraction, drawn from
    a local generator seeded by ``seed``, else ``TPQ_RETRY_SEED``, else
    the process id)."""
    if retries is None:
        retries = _env_int("TPQ_IO_RETRIES", 3)
    if base is None:
        base = _env_float("TPQ_RETRY_BASE_S", 0.01)
    if cap is None:
        cap = _env_float("TPQ_RETRY_MAX_S", 0.5)
    if jitter is None:
        jitter = _env_float("TPQ_RETRY_JITTER", 0.0)
    delays = [min(base * (2 ** i), cap) for i in range(max(retries, 0))]
    if jitter:
        import random

        if seed is None:
            seed = _env_int("TPQ_RETRY_SEED", os.getpid() ^ 0x7E9)
        rng = random.Random(seed)
        delays = [max(d * (1.0 + jitter * (2.0 * rng.random() - 1.0)), 0.0)
                  for d in delays]
    return delays


def retry_transient(fn, *, retries: int | None = None,
                    base: float | None = None, cap: float | None = None,
                    sleep=time.sleep, counter: str = "io_retries"):
    """Call ``fn()``, retrying a transient failure (:func:`is_transient`)
    up to ``retries`` times with bounded exponential backoff; a permanent
    error and the last attempt's error propagate unchanged.  Each retry
    counts ``DecodeStats.<counter>``.  A transient error that carries
    ``retry_after_s`` stretches that retry's sleep to it, bounded by the
    cap."""
    from .stats import current_stats

    if cap is None:
        cap = _env_float("TPQ_RETRY_MAX_S", 0.5)
    for delay in backoff_delays(retries, base, cap):
        try:
            return fn()
        except Exception as e:
            if not is_transient(e):
                raise
            hint = getattr(e, "retry_after_s", None)
            if hint is not None:
                delay = max(delay, min(float(hint), cap))
            st = current_stats()
            if st is not None:
                setattr(st, counter, getattr(st, counter) + 1)
            sleep(delay)
    return fn()


# ----------------------------------------------------------------------
# Quarantine report
# ----------------------------------------------------------------------

class QuarantineReport:
    """Where the bad units went: one entry a quarantined unit (or file),
    with its coordinates and error class; JSON-serializable
    (:meth:`as_dicts`, :meth:`from_dicts`), so it rides scan cursors and
    the cross-process all-gather."""

    def __init__(self, entries: list[dict] | None = None):
        self.entries: list[dict] = list(entries or [])

    def add(self, *, unit: int, file, row_group: int,
            error: BaseException) -> dict:
        entry = {"unit": unit, "file": file, "row_group": row_group,
                 "error": type(error).__name__, "message": str(error)}
        return self._finish(entry, error)

    def add_file(self, *, file, error: BaseException, **extra) -> dict:
        """A file-level entry: the whole file was rejected when it was
        opened (``unit`` and ``row_group`` are None)."""
        entry = {"unit": None, "file": file, "row_group": None,
                 "error": type(error).__name__, "message": str(error)}
        entry.update(extra)
        return self._finish(entry, error)

    def _finish(self, entry: dict, error: BaseException) -> dict:
        # a ScanError pins deeper: column, page, an inner file label
        coords = getattr(error, "coordinates", None)
        if callable(coords):
            for k, v in coords().items():
                if k == "file":
                    entry["file_detail"] = v
                elif k != "row_group":
                    entry[k] = v
        self.entries.append(entry)
        return entry

    def units(self) -> list[int]:
        """Unit ordinals of the unit-level entries."""
        return [e["unit"] for e in self.entries if e["unit"] is not None]

    def files(self) -> list:
        """Files with a file-level entry."""
        return [e["file"] for e in self.entries if e["unit"] is None]

    def __len__(self) -> int:
        return len(self.entries)

    def __bool__(self) -> bool:
        return bool(self.entries)

    def as_dicts(self) -> list[dict]:
        return [dict(e) for e in self.entries]

    @classmethod
    def from_dicts(cls, entries) -> "QuarantineReport":
        return cls([dict(e) for e in entries or []])

    def merge_from(self, other: "QuarantineReport") -> None:
        self.entries.extend(dict(e) for e in other.entries)

    # an entry's identity on resume: coordinates and error class, not the
    # message (a re-opened bad file may word its failure differently)
    _KEY_FIELDS = ("unit", "file", "row_group", "column", "page", "error")

    @classmethod
    def entry_key(cls, e: dict) -> tuple:
        return tuple(e.get(k) for k in cls._KEY_FIELDS)

    def merge_unique(self, entries) -> int:
        """Append the entries whose key is not present yet; returns how
        many were added (a resumed scan re-opens its sources, so a file
        already in the cursor's report is rejected again)."""
        seen = {self.entry_key(e) for e in self.entries}
        added = 0
        for e in entries or []:
            k = self.entry_key(e)
            if k in seen:
                continue
            seen.add(k)
            self.entries.append(dict(e))
            added += 1
        return added

    def summary(self) -> str:
        if not self.entries:
            return "quarantine: empty"
        lines = [f"quarantine: {len(self.entries)} entr(y/ies)"]
        for e in self.entries:
            at = ", ".join(f"{k}={e[k]}" for k in
                           ("file", "row_group", "column", "page")
                           if e.get(k) is not None)
            head = (f"unit {e['unit']}" if e.get("unit") is not None
                    else "file")
            lines.append(f"  {head} [{at}]: {e['error']}: {e['message']}")
        return "\n".join(lines)
