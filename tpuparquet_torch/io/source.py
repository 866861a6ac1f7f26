"""Byte-range sources: the object-store read contract.

The port of ``tpuparquet/io/source.py``.  :class:`ByteRangeSource` reads
exact byte ranges by offset (``get_range``, ``get_ranges``, ``size``,
``etag``, ``reopen``), with three backends:

* :class:`LocalByteRangeSource` (``file://``): a local file behind the
  range contract, so the remote read path (coalescing, the range caches,
  the retry a request) runs, and is held byte for byte, against a plain
  local read.
* :class:`EmulatedStoreSource` (``emu://``): an object store emulated
  over a local file.  Per-request latency, throttles (HTTP 429), resets,
  a slow replica and short responses fire on a counter of the source's
  own requests (no clock, no random draw), so a fault plan replays
  exactly; the ``TPQ_EMU_*`` knobs set them.
* :class:`HttpByteRangeSource` (``http://``, ``https://``): an HTTP range
  client on the standard library.  A HEAD gives the size and the ETag;
  each range is a conditional GET (``Range`` and ``If-Match``), so an
  object rewritten underneath answers 412 and the source refreshes its
  identity, drops its cached ranges and raises a transient error for
  the retry ladder.  Connections are kept alive in a pool of
  ``TPQ_HTTP_CONNS`` a source, each request bounded by
  ``TPQ_HTTP_TIMEOUT_S``; statuses map into the error taxonomy (429 and
  503 carry ``Retry-After`` as ``retry_after_s``).

Every range request passes the fault sites ``io.remote.throttle`` and
``io.remote.range`` and every open ``io.remote.open``, on any backend.  A
short response raises :class:`TransientIOError`: truncated bytes never
reach a decoder.

:func:`open_byte_source` resolves a source string: a ``scheme://`` URI
always, a bare path only when ``TPQ_SOURCE`` names a scheme, and then
the bare path stays the source's display name (cursors, quarantine
entries and fault-plan matches stay those of a local run).
:func:`coalesce_ranges` merges requested ranges whose gap is at most
``TPQ_RANGE_COALESCE_GAP`` bytes into one fetch.  :class:`RangeSourceFile`
is a seekable file object over a source, for the reader's footer,
salvage and hedged-read machinery.
"""

from __future__ import annotations

import http.client
import os
import threading
import time
import urllib.parse

from ..errors import TransientIOError
from ..faults import fault_point, filter_bytes, retry_transient
from ..obs import recorder as _flightrec

__all__ = [
    "ByteRangeSource",
    "LocalByteRangeSource",
    "EmulatedStoreSource",
    "HttpByteRangeSource",
    "RangeSourceFile",
    "coalesce_ranges",
    "coalesce_gap_default",
    "http_conns_default",
    "http_timeout_default",
    "open_byte_source",
    "parse_source_uri",
]

_SCHEMES = ("file", "emu", "http", "https")


def parse_source_uri(src):
    """``"emu:///data/f.parquet"`` -> ``("emu", "/data/f.parquet")``;
    ``None`` for a bare path; :class:`ValueError` for a scheme this
    build does not know (a typo'd scheme must fail loudly at open, not
    fall through to ``open()`` and produce ENOENT noise)."""
    if not isinstance(src, str):
        return None
    head, sep, rest = src.partition("://")
    if not sep:
        return None
    if head not in _SCHEMES:
        raise ValueError(f"unsupported source scheme {head!r} in {src!r} "
                         f"(known: {', '.join(_SCHEMES)})")
    return head, rest


def open_byte_source(src):
    """Resolve a source string to a :class:`ByteRangeSource`, or
    ``None`` when the classic local-``open()`` path should be used.

    Explicit ``scheme://`` URIs always resolve.  Bare paths resolve
    only when ``TPQ_SOURCE`` names a scheme (``file`` or ``emu``) —
    the reroute keeps the bare path as the source's display name so
    every path-keyed artifact (cursors, quarantine entries, fault-plan
    matches) is byte-identical to a local run.
    """
    parsed = parse_source_uri(src)
    if parsed is not None:
        scheme, path = parsed
        uri = src
    else:
        if not isinstance(src, str):
            return None
        scheme = os.environ.get("TPQ_SOURCE", "").strip().lower()
        if not scheme:
            return None
        if scheme not in _SCHEMES:
            raise ValueError(
                f"TPQ_SOURCE={scheme!r} is not a known scheme "
                f"(known: {', '.join(_SCHEMES)})")
        path = src
        uri = src  # bare path stays the display name (see docstring)
    if scheme in ("http", "https"):
        if parsed is not None:
            return HttpByteRangeSource(src, uri=uri)
        base = os.environ.get("TPQ_HTTP_BASE", "").strip()
        if not base:
            raise ValueError(
                "TPQ_SOURCE=http(s) reroutes bare paths and needs "
                "TPQ_HTTP_BASE (e.g. http://127.0.0.1:8080) to build "
                "the request URL")
        return HttpByteRangeSource(base.rstrip("/") + path, uri=uri)
    if scheme == "emu":
        return EmulatedStoreSource(path, uri=uri)
    return LocalByteRangeSource(path, uri=uri)


def coalesce_gap_default() -> int:
    """``TPQ_RANGE_COALESCE_GAP`` — merge two requested ranges into one
    fetch when the hole between them is at most this many bytes
    (default 256 KiB: on an object store a round trip costs far more
    than shipping a quarter-megabyte of dead bytes)."""
    v = os.environ.get("TPQ_RANGE_COALESCE_GAP")
    if not v:
        return 256 * 1024
    return max(0, int(v))


def coalesce_ranges(ranges, gap: int = 0):
    """Merge ``[(start, size), ...]`` into fetch spans under a gap
    threshold.

    Returns ``[(start, size, members), ...]`` where ``members`` lists
    the indices of the requested ranges served by that span.  Spans are
    disjoint and sorted, every requested byte is covered by exactly one
    span (overlapping requests are never double-fetched), and a
    requested range is always a contiguous slice of its span —
    ``data[rs - start : rs - start + rn]`` recovers it.
    """
    if gap < 0:
        raise ValueError(f"gap must be >= 0, got {gap}")
    order = sorted(range(len(ranges)),
                   key=lambda i: (ranges[i][0], ranges[i][1]))
    merged = []  # [start, end, [member indices]]
    for i in order:
        s, n = ranges[i]
        if s < 0 or n < 0:
            raise ValueError(f"bad range {(s, n)!r}")
        if merged and s <= merged[-1][1] + gap:
            m = merged[-1]
            m[1] = max(m[1], s + n)
            m[2].append(i)
        else:
            merged.append([s, s + n, [i]])
    return [(s, e - s, mem) for s, e, mem in merged]


class ByteRangeSource:
    """The object-store read contract: exact byte ranges by offset.

    Subclasses implement ``_read_raw(start, size)`` and set ``path``,
    ``uri``, ``_size`` and ``_etag`` in ``__init__``.  ``get_range``
    wraps every read with the registered remote fault sites and the
    short-response check; ``get_ranges`` is the multi-range batch hook
    (base implementation: sequential — a real S3/GCS backend would
    issue them concurrently; the reader's prefetch layer already
    parallelizes above this call).
    """

    scheme = "?"

    # -- subclass surface -------------------------------------------------
    def _read_raw(self, start: int, size: int) -> bytes:
        raise NotImplementedError

    def close(self) -> None:
        pass

    def reopen(self) -> "ByteRangeSource":
        """A fresh, independent source for the same object — used by
        handle un-poisoning and mirror opens."""
        raise NotImplementedError

    # -- contract ---------------------------------------------------------
    def size(self) -> int:
        return self._size

    def etag(self):
        """Cache identity: ``(path, size, mtime_ns)``.  Any rewrite of
        the object changes it, so stale cache entries can never serve a
        new file's reads."""
        return self._etag

    def get_range(self, start: int, size: int) -> bytes:
        """Exactly ``size`` bytes at ``start``.  A short response —
        injected, emulated, or real (EOF race with a concurrent
        truncate) — raises :class:`TransientIOError` so the retry
        ladder refetches; callers never see silently truncated data."""
        fault_point("io.remote.throttle", file=self.uri)
        fault_point("io.remote.range", file=self.uri,
                    start=start, size=size)
        data = self._read_raw(start, size)
        data = filter_bytes("io.remote.range", data, file=self.uri,
                            start=start, size=size)
        if len(data) != size:
            raise TransientIOError(
                f"short range response from {self.uri}: "
                f"{len(data)}/{size} bytes at offset {start}",
                file=self.uri)
        return data

    def get_ranges(self, ranges):
        """Batch fetch: ``[(start, size), ...] -> [bytes, ...]``."""
        return [self.get_range(s, n) for s, n in ranges]


class LocalByteRangeSource(ByteRangeSource):
    """``file://`` — a local file behind the range contract."""

    scheme = "file"

    def __init__(self, path: str, uri: str | None = None):
        self.path = path
        self.uri = uri if uri is not None else f"file://{path}"
        fault_point("io.remote.open", file=self.uri)
        self._f = open(path, "rb")
        try:
            self._lock = threading.Lock()  # serializes seek+read pairs
            self._closed = False
            st = os.fstat(self._f.fileno())
            self._size = st.st_size
            self._etag = (path, st.st_size, st.st_mtime_ns)
        except BaseException:
            # a failed __init__ returns no instance for anyone to
            # close: release the fd before the raise escapes
            self._f.close()
            raise

    def _read_raw(self, start: int, size: int) -> bytes:
        with self._lock:
            self._f.seek(start)
            return self._f.read(size)

    def close(self) -> None:
        with self._lock:
            if not self._closed:
                self._closed = True
                self._f.close()

    def reopen(self) -> "LocalByteRangeSource":
        return type(self)(self.path, uri=self.uri)


class EmulatedStoreSource(LocalByteRangeSource):
    """``emu://`` — object-store behavior modeled over a local file.

    Deterministic by construction: every fault fires on a per-instance
    request counter (throttle/reset/short on every Nth request), never
    on wall-clock or RNG, so a failing run replays exactly.  Knobs come
    from the constructor or their ``TPQ_EMU_*`` env defaults:

    * ``latency_ms`` / ``TPQ_EMU_LATENCY_MS`` — fixed per-request pause
      (the round-trip cost the coalescer exists to amortize).
    * ``throttle_every`` / ``TPQ_EMU_THROTTLE_EVERY`` — every Nth
      request fails like an HTTP 429 (:class:`TransientIOError`).
    * ``reset_every`` / ``TPQ_EMU_RESET_EVERY`` — every Nth request
      dies mid-flight (:class:`ConnectionResetError`).
    * ``short_every`` / ``TPQ_EMU_SHORT_EVERY`` — every Nth response
      returns half the requested bytes (detected upstream and retried).
    * ``slow_match`` + ``slow_ms`` / ``TPQ_EMU_SLOW_MATCH`` +
      ``TPQ_EMU_SLOW_MS`` — replicas whose path contains the substring
      pay an extra pause per request: the tail-latency replica the
      hedging machinery exists to route around.

    ``0`` / empty disables a knob.  Every injected fault is announced
    on the flight recorder (``emu_fault``) before it fires — no silent
    failures, per the no-silent-retries observability contract.
    """

    scheme = "emu"

    def __init__(self, path: str, uri: str | None = None, *,
                 latency_ms: float | None = None,
                 throttle_every: int | None = None,
                 reset_every: int | None = None,
                 short_every: int | None = None,
                 slow_match: str | None = None,
                 slow_ms: float | None = None):
        def _f(v, env, dflt):
            return float(os.environ.get(env) or dflt) if v is None else v

        def _i(v, env):
            return int(os.environ.get(env) or 0) if v is None else v

        self._latency_s = _f(latency_ms, "TPQ_EMU_LATENCY_MS", 0.0) / 1e3
        self._throttle_every = _i(throttle_every, "TPQ_EMU_THROTTLE_EVERY")
        self._reset_every = _i(reset_every, "TPQ_EMU_RESET_EVERY")
        self._short_every = _i(short_every, "TPQ_EMU_SHORT_EVERY")
        self._slow_match = (os.environ.get("TPQ_EMU_SLOW_MATCH", "")
                            if slow_match is None else slow_match)
        self._slow_s = _f(slow_ms, "TPQ_EMU_SLOW_MS", 50.0) / 1e3
        self._requests = 0  # guarded by _req_lock
        self._req_lock = threading.Lock()
        super().__init__(path, uri=uri if uri is not None
                         else f"emu://{path}")

    def _knobs(self) -> dict:
        return {
            "latency_ms": self._latency_s * 1e3,
            "throttle_every": self._throttle_every,
            "reset_every": self._reset_every,
            "short_every": self._short_every,
            "slow_match": self._slow_match,
            "slow_ms": self._slow_s * 1e3,
        }

    def reopen(self) -> "EmulatedStoreSource":
        return type(self)(self.path, uri=self.uri, **self._knobs())

    def _read_raw(self, start: int, size: int) -> bytes:
        with self._req_lock:
            self._requests += 1
            n = self._requests
        if self._latency_s > 0:
            time.sleep(self._latency_s)
        if self._slow_match and self._slow_match in self.path:
            time.sleep(self._slow_s)
        if self._throttle_every and n % self._throttle_every == 0:
            if _flightrec._active is not None:
                _flightrec.flight(
                    "emu_fault", site="io.remote.throttle",
                    fault="throttle", file=self.uri, request=n)
            raise TransientIOError(
                f"429 throttled (emulated, request {n}) on {self.uri}",
                file=self.uri)
        if self._reset_every and n % self._reset_every == 0:
            if _flightrec._active is not None:
                _flightrec.flight(
                    "emu_fault", site="io.remote.range", fault="reset",
                    file=self.uri, request=n)
            raise ConnectionResetError(
                f"connection reset (emulated, request {n}) on {self.uri}")
        data = super()._read_raw(start, size)
        if self._short_every and n % self._short_every == 0 and len(data) > 1:
            if _flightrec._active is not None:
                _flightrec.flight(
                    "emu_fault", site="io.remote.range", fault="short",
                    file=self.uri, request=n)
            return data[:len(data) // 2]
        return data


def http_conns_default() -> int:
    """``TPQ_HTTP_CONNS`` — bound on live keep-alive connections per
    source (default 4: enough for the prefetch pool to overlap spans
    without stampeding one origin host)."""
    v = os.environ.get("TPQ_HTTP_CONNS")
    return max(1, int(v)) if v else 4


def http_timeout_default() -> float:
    """``TPQ_HTTP_TIMEOUT_S`` — per-request socket deadline (connect
    and each read) on HTTP sources, default 30s.  A hung origin
    surfaces as a retryable :class:`TimeoutError`, never a stuck
    scan."""
    v = os.environ.get("TPQ_HTTP_TIMEOUT_S")
    return float(v) if v else 30.0


class _HttpConnPool:
    """Bounded keep-alive connection pool for one origin host.

    ``acquire`` hands out an idle connection or dials a new one while
    under the bound; past the bound it waits (bounded by the request
    timeout) for a release.  Network I/O always happens OUTSIDE the
    pool lock.  A connection that saw a protocol error or an
    unconsumed body is closed and discarded on release instead of
    being reused."""

    def __init__(self, host: str, port, tls: bool, timeout: float,
                 bound: int):
        self._host = host
        self._port = port
        self._tls = tls
        self._timeout = timeout
        self._bound = max(1, bound)
        self._cv = threading.Condition(threading.Lock())
        self._idle: list = []  # guarded by _cv
        self._total = 0        # guarded by _cv
        self._closed = False   # guarded by _cv

    def _connect(self):
        cls = (http.client.HTTPSConnection if self._tls
               else http.client.HTTPConnection)
        return cls(self._host, self._port, timeout=self._timeout)

    def acquire(self):
        deadline = time.monotonic() + self._timeout
        with self._cv:
            while True:
                if self._closed:
                    raise ValueError("connection pool is closed")
                if self._idle:
                    return self._idle.pop()
                if self._total < self._bound:
                    self._total += 1
                    break
                left = deadline - time.monotonic()
                if left <= 0 or not self._cv.wait(left):
                    raise TransientIOError(
                        f"connection pool exhausted: {self._bound} "
                        f"connections busy for {self._timeout:g}s",
                        file=self._host)
        try:
            return self._connect()
        except BaseException:
            with self._cv:
                self._total -= 1
                self._cv.notify()
            raise

    def release(self, conn, *, reusable: bool) -> None:
        with self._cv:
            if reusable and not self._closed:
                self._idle.append(conn)
                self._cv.notify()
                return
            self._total -= 1
            self._cv.notify()
        try:
            conn.close()
        except OSError:
            pass

    def close(self) -> None:
        with self._cv:
            self._closed = True
            drop, self._idle = self._idle, []
            self._total -= len(drop)
            self._cv.notify_all()
        for conn in drop:
            try:
                conn.close()
            except OSError:
                pass


class HttpByteRangeSource(ByteRangeSource):
    """``http://`` / ``https://`` — a real HTTP range client.

    Opens with a HEAD (size + served ``ETag``); every range read is a
    conditional GET (``Range`` + ``If-Match``), so a concurrent
    rewrite of the object surfaces as 412 — the handler refreshes the
    identity, invalidates both cache tiers for this source, and
    raises :class:`TransientIOError` for the retry ladder to refetch
    under the NEW identity; stale bytes can never serve a read.

    Status classification into the existing taxonomy (everything the
    scan stack above already knows how to absorb):

    * 206/200 — bytes (200 is sliced; a short slice trips the base
      class's short-response check).
    * 412/416 — identity/size stale → refresh + invalidate +
      :class:`TransientIOError`.
    * 429/503 — :class:`TransientIOError` carrying the parsed
      ``Retry-After`` hint (``retry_after_s``), which
      :func:`tpuparquet_torch.faults.retry_transient` honours.
    * other 5xx — :class:`TransientIOError`.
    * 404 — :class:`FileNotFoundError`; 401/403 —
      :class:`PermissionError`; other 4xx — :class:`OSError`
      (permanent: quarantine, don't retry).
    * resets / remote disconnects propagate as
      :class:`ConnectionError` (transient); short/incomplete bodies
      return their partial bytes and trip the short-response check.
    """

    scheme = "http"

    def __init__(self, url: str, uri: str | None = None, *,
                 timeout_s: float | None = None,
                 conns: int | None = None):
        split = urllib.parse.urlsplit(url)
        if split.scheme not in ("http", "https") or not split.hostname:
            raise ValueError(f"not an http(s) URL: {url!r}")
        self._url = url
        self.uri = uri if uri is not None else url
        self.path = self.uri
        self.scheme = split.scheme
        self._target = split.path or "/"
        if split.query:
            self._target += "?" + split.query
        self._timeout = (timeout_s if timeout_s is not None
                         else http_timeout_default())
        self._conns = conns if conns is not None else http_conns_default()
        self._pool = _HttpConnPool(
            split.hostname, split.port, split.scheme == "https",
            self._timeout, self._conns)
        self._id_lock = threading.Lock()  # guards the etag identity
        self._closed = False
        fault_point("io.remote.open", file=self.uri)
        try:
            size, tag = retry_transient(self._head)
        except BaseException:
            self._pool.close()
            raise
        self._size = size
        self._etag_header = tag
        self._etag = (self.path, size, tag)

    # -- identity ---------------------------------------------------------
    def _head(self):
        """HEAD the object: (size, etag-header-or-empty)."""
        conn = self._pool.acquire()
        reusable = False
        try:
            conn.request("HEAD", self._target)
            resp = conn.getresponse()
            resp.read()
            if resp.status == 200:
                reusable = True
                n = resp.getheader("Content-Length")
                if n is None:
                    # protocol violation from origin/proxy: let the
                    # retry ladder take a few swings, then quarantine
                    raise TransientIOError(
                        f"HEAD {self.uri}: origin sent no "
                        f"Content-Length", file=self.uri)
                return int(n), (resp.getheader("ETag") or "").strip()
            raise self._status_error(resp, verb="HEAD")
        except (ConnectionError, TimeoutError):
            raise
        except http.client.HTTPException as e:
            raise TransientIOError(
                f"HEAD {self.uri}: {e!r}", file=self.uri) from e
        finally:
            self._pool.release(conn, reusable=reusable)

    def _refresh_identity(self) -> None:
        """Re-HEAD after a 412/416: adopt the new (size, etag) and
        drop every cached range for this source — all before the
        transient raise hands control to the retry ladder."""
        size, tag = retry_transient(self._head)
        with self._id_lock:
            self._size = size
            self._etag_header = tag
            self._etag = (self.path, size, tag)
        from .rangecache import invalidate_source_caches

        invalidate_source_caches(self.uri)

    def _status_error(self, resp, *, verb: str = "GET",
                      start: int | None = None) -> BaseException:
        """Map a non-2xx response to the error taxonomy (the caller
        raises); transient errors carry a ``retry_after_s`` hint when
        the origin sent one."""
        status = resp.status
        at = "" if start is None else f" at offset {start}"
        msg = f"{verb} {self.uri}{at}: HTTP {status}"
        if status in (429, 503) or status >= 500:
            err = TransientIOError(msg, file=self.uri)
            hint = _parse_retry_after(resp.getheader("Retry-After"))
            if hint is not None:
                err.retry_after_s = hint
            return err
        if status == 404:
            return FileNotFoundError(msg)
        if status in (401, 403):
            return PermissionError(msg)
        return OSError(msg)

    # -- reads ------------------------------------------------------------
    def _read_raw(self, start: int, size: int) -> bytes:
        conn = self._pool.acquire()
        reusable = False
        try:
            with self._id_lock:
                tag = self._etag_header
            headers = {"Range": f"bytes={start}-{start + size - 1}"}
            if tag:
                headers["If-Match"] = tag
            conn.request("GET", self._target, headers=headers)
            resp = conn.getresponse()
            short = False
            try:
                body = resp.read()
            except (http.client.IncompleteRead,) as e:
                body, short = e.partial, True
            if resp.status == 206:
                reusable = not short
                return body  # short bodies trip the base length check
            if resp.status == 200:
                reusable = not short
                return body[start:start + size]
            if resp.status in (412, 416):
                self._refresh_identity()
                what = ("object changed under us (etag mismatch)"
                        if resp.status == 412 else
                        "range not satisfiable (stale size)")
                raise TransientIOError(
                    f"GET {self.uri} at offset {start}: HTTP "
                    f"{resp.status} — {what}; identity refreshed, "
                    f"caches invalidated", file=self.uri)
            raise self._status_error(resp, start=start)
        except (ConnectionError, TimeoutError):
            raise  # already transient in the taxonomy
        except http.client.HTTPException as e:
            raise TransientIOError(
                f"GET {self.uri} at offset {start}: {e!r}",
                file=self.uri) from e
        finally:
            self._pool.release(conn, reusable=reusable)

    # -- lifecycle --------------------------------------------------------
    def close(self) -> None:
        if not self._closed:
            self._closed = True
            self._pool.close()

    def reopen(self) -> "HttpByteRangeSource":
        return type(self)(self._url, uri=self.uri,
                          timeout_s=self._timeout, conns=self._conns)


def _parse_retry_after(value):
    """``Retry-After`` header -> seconds (or None): delta-seconds or
    an HTTP-date, clamped to >= 0."""
    if not value:
        return None
    value = value.strip()
    try:
        return max(0.0, float(value))
    except ValueError:
        pass
    try:
        import email.utils

        when = email.utils.parsedate_to_datetime(value)
    except (TypeError, ValueError):
        return None
    if when is None:
        return None
    return max(0.0, when.timestamp() - time.time())


class RangeSourceFile:
    """Seekable file-object facade over a :class:`ByteRangeSource`.

    Lets the entire existing reader stack — footer framing, fingerprint
    hashing, salvage scans, hedged/deadline-bounded chunk reads via
    ``_IoHandle`` — run unchanged against a remote source: every
    ``seek``+``read`` pair becomes one exact range request.  Position
    state is per-facade; concurrency control stays where it already
    lives (the reader's handle lock).
    """

    def __init__(self, source: ByteRangeSource):
        self.source = source
        self.name = source.uri
        self._pos = 0

    def read(self, size: int = -1) -> bytes:
        end = self.source.size()
        if size is None or size < 0:
            size = max(0, end - self._pos)
        else:
            size = min(size, max(0, end - self._pos))
        if size == 0:
            return b""
        data = self.source.get_range(self._pos, size)
        self._pos += size
        return data

    def seek(self, offset: int, whence: int = os.SEEK_SET) -> int:
        if whence == os.SEEK_SET:
            self._pos = offset
        elif whence == os.SEEK_CUR:
            self._pos += offset
        elif whence == os.SEEK_END:
            self._pos = self.source.size() + offset
        else:
            raise ValueError(f"bad whence {whence}")
        return self._pos

    def tell(self) -> int:
        return self._pos

    def readable(self) -> bool:
        return True

    def seekable(self) -> bool:
        return True

    def close(self) -> None:
        self.source.close()

    @property
    def closed(self) -> bool:
        return getattr(self.source, "_closed", False)
