"""Tiered range cache for remote byte-range sources.

The port of ``tpuparquet/io/rangecache.py``, with the same entry frame
and journal records, so a cache directory one package filled reads as
hits in the other.

Two tiers, two access costs:

* **Memory** (:class:`MemRangeCache`, ``TPQ_CACHE_MEM_MB``) — hot small
  ranges: footer framing bytes, metadata blobs, page-index/bloom
  sections.  These are re-read on every reopen (fingerprint hashing,
  handle un-poisoning, mirror opens), and on an object store each
  re-read is a full round trip.  Same byte-budgeted LRU discipline as
  ``kernels/plancache.py``, keyed by the source's *etag* — ``(path,
  size, mtime_ns)`` — plus the range, so a rewritten object can never
  be served stale bytes.

* **Disk** (:class:`DiskRangeCache`, ``TPQ_CACHE_DISK_DIR`` +
  ``TPQ_CACHE_DISK_MB``) — recently fetched column-chunk ranges.  One
  file per entry, written atomically (tmp + ``os.replace``) and
  CRC-verified on every read.  A torn file (process killed mid-write)
  or a bit-rotted payload can therefore never reach a decoder: torn
  framing self-heals silently (unlink + miss), while a CRC mismatch on
  well-formed framing is treated as *poisoning* — the entry is
  evicted, a ``cache_poison`` flight record and post-mortem incident
  are emitted, and the key is marked so the direct refetch is NOT
  immediately re-cached (degrade to uncached: if the payload keeps
  arriving corrupt, the cache must not amplify it).

Both tiers bump the exactly-merging ``cache_{hits,misses,evictions}_
{mem,disk}`` counters on the calling thread's collector, so
``cache_hits + cache_misses == lookups`` holds per tier by
construction.  :func:`invalidate_source_caches` drops both tiers for a
path — wired to the corruption/quarantine/salvage hooks.

**Cross-process sharing** (``TPQ_CACHE_DISK_SHARED=1``,
:class:`SharedDiskRangeCache`): N server processes over ONE cache
directory, so a fleet hits origin approximately once per span.  The
single-process tier already publishes entries atomically; sharing adds
the coordination the multi-writer regime needs:

* a **CRC-framed journaled index** (``index.tpqj``) — every publish/
  evict/poison appends a framed record under the directory lock; each
  process replays new records into its in-memory mirror, so eviction
  decisions (and poison pins) are visible fleet-wide without rescans.
  A torn tail (kill mid-append) is data-end for readers and is
  truncated by the next lock holder before it appends.
* a **lock file** (``index.lock``) with dead-holder recovery — the
  holder's pid rides in the file; a contender that finds a dead pid
  renames the stale lock aside (exactly one wins the rename) and
  retakes it, so a SIGKILL inside the critical section never wedges
  the fleet.
* **generation-stamped entries** — a publish never overwrites a live
  entry file in place; each publish gets a fresh
  ``<keyhash>.<pid>-<seq>.tpqc`` name, so a concurrent reader holding
  the OLD name sees either the complete old frame or ENOENT (a clean
  miss) — never a frame mid-replacement.
* **init self-heal** — a process joining (or restarting after a kill
  at ANY byte) takes the lock, truncates a torn journal tail, drops
  journal entries whose files are gone/torn, unlinks orphan files the
  journal never published, and compacts the journal when it has grown
  past its live set.

Only the process that journals an eviction bumps
``cache_evictions_disk`` (replaying processes just update their
mirror), so summing counters across the fleet stays exact — no
phantom evictions.
"""

from __future__ import annotations

import itertools
import json
import os
import threading
import time
import zlib
from collections import OrderedDict

from ..obs import recorder as _flightrec
from .source import parse_source_uri

__all__ = [
    "MemRangeCache",
    "DiskRangeCache",
    "SharedDiskRangeCache",
    "mem_cache",
    "disk_cache",
    "disk_cache_shared",
    "invalidate_source_caches",
    "reset_range_caches",
]

_MAGIC = b"TPQC1"
_SUFFIX = ".tpqc"
# magic + crc32(u32) + payload_len(u64) + key_len(u16), big-endian
_HDR = len(_MAGIC) + 4 + 8 + 2

# shared-index journal framing: magic + crc32(payload) u32 + len u32
_JMAGIC = b"TPQJ"
_JHDR = len(_JMAGIC) + 4 + 4
_JOURNAL = "index.tpqj"
_LOCKFILE = "index.lock"


def _bump(field: str, n: int = 1) -> None:
    from ..stats import current_stats

    st = current_stats()
    if st is not None:
        setattr(st, field, getattr(st, field) + n)


def _norm_path(src: str) -> str:
    """Cache keys store the backing *path*; accept either a path or a
    ``scheme://path`` URI at the invalidation hooks.  HTTP sources key
    on the full URL (there is no local backing path to strip to)."""
    parsed = parse_source_uri(src)
    if parsed is None or parsed[0] in ("http", "https"):
        return src
    return parsed[1]


def mem_cache_budget() -> int:
    """``TPQ_CACHE_MEM_MB`` in bytes (default 16 MiB; ``0`` disables).
    Read per call so tests and operators can flip it live."""
    v = os.environ.get("TPQ_CACHE_MEM_MB")
    if v is None or v == "":
        return 16 * (1 << 20)
    return max(0, int(float(v) * (1 << 20)))


def disk_cache_dir() -> str | None:
    return os.environ.get("TPQ_CACHE_DISK_DIR") or None


def disk_cache_budget() -> int:
    """``TPQ_CACHE_DISK_MB`` in bytes (default 256 MiB; ``0`` disables
    the disk tier even when a directory is configured)."""
    v = os.environ.get("TPQ_CACHE_DISK_MB")
    if v is None or v == "":
        return 256 * (1 << 20)
    return max(0, int(float(v) * (1 << 20)))


def disk_cache_shared() -> bool:
    """``TPQ_CACHE_DISK_SHARED=1`` — coordinate the disk tier across
    processes (journaled index + directory lock; see module
    docstring).  Off by default: a private cache dir needs none of
    the coordination cost."""
    return os.environ.get("TPQ_CACHE_DISK_SHARED", "") == "1"


class MemRangeCache:
    """Byte-budgeted LRU of ``key -> bytes`` (self-synchronized)."""

    def __init__(self, budget: int):
        self._budget = budget
        self._lock = threading.Lock()
        self._entries: OrderedDict = OrderedDict()
        self._bytes = 0

    def get(self, key):
        with self._lock:
            data = self._entries.get(key)
            if data is None:
                _bump("cache_misses_mem")
                return None
            self._entries.move_to_end(key)
        _bump("cache_hits_mem")
        return data

    def put(self, key, data: bytes) -> None:
        n = len(data)
        if n > self._budget:
            return
        evicted = 0
        with self._lock:
            old = self._entries.pop(key, None)
            if old is not None:
                self._bytes -= len(old)
            self._entries[key] = data
            self._bytes += n
            while self._bytes > self._budget and len(self._entries) > 1:
                _, dropped = self._entries.popitem(last=False)
                self._bytes -= len(dropped)
                evicted += 1
        if evicted:
            _bump("cache_evictions_mem", evicted)

    def invalidate_path(self, path: str) -> int:
        with self._lock:
            doomed = [k for k in self._entries if k[0] == path]
            for k in doomed:
                self._bytes -= len(self._entries.pop(k))
        if doomed:
            _bump("cache_evictions_mem", len(doomed))
        return len(doomed)

    def stats(self) -> dict:
        with self._lock:
            return {"entries": len(self._entries), "bytes": self._bytes,
                    "budget": self._budget}


class DiskRangeCache:
    """One CRC-framed file per cached range, LRU by entry mtime.

    Entry layout: ``TPQC1 | crc32(payload) u32 | payload_len u64 |
    key_len u16 | key json | payload`` (big-endian).  Writes go to a
    ``.tmp`` sibling and ``os.replace`` in, so a crash leaves either
    the old entry, the new entry, or a ``.tmp`` straggler that the next
    startup sweep removes — never a half-entry under the real name.
    """

    def __init__(self, directory: str, budget: int):
        self._dir = directory
        self._budget = budget
        self._lock = threading.Lock()
        # key -> [fname, total_file_bytes]; insertion order = LRU order
        self._index: OrderedDict = OrderedDict()
        self._bytes = 0
        self._no_recache: set = set()  # poisoned keys: skip next put
        os.makedirs(directory, exist_ok=True)
        self._sweep()

    # -- startup recovery -------------------------------------------------
    def _sweep(self) -> None:
        """Rebuild the index from disk: drop ``.tmp`` stragglers and
        entries whose framing no longer parses (torn by a crash)."""
        found = []
        for fn in os.listdir(self._dir):
            fp = os.path.join(self._dir, fn)
            if fn.endswith(".tmp"):
                _unlink_quiet(fp)
                continue
            if not fn.endswith(_SUFFIX):
                continue
            key = self._parse_header(fp)
            if key is None:
                _unlink_quiet(fp)  # torn entry: self-heal
                continue
            try:
                st = os.stat(fp)
            except OSError:
                continue
            found.append((st.st_mtime_ns, key, fn, st.st_size))
        for _, key, fn, nbytes in sorted(found):
            self._index[key] = [fn, nbytes]
            self._bytes += nbytes

    @staticmethod
    def _parse_header(fp: str):
        """Key tuple from an entry's header, or None if malformed.
        Validates framing only — payload CRC is checked at ``get``."""
        try:
            with open(fp, "rb") as f:
                hdr = f.read(_HDR)
                if len(hdr) < _HDR or hdr[:len(_MAGIC)] != _MAGIC:
                    return None
                o = len(_MAGIC) + 4
                plen = int.from_bytes(hdr[o:o + 8], "big")
                klen = int.from_bytes(hdr[o + 8:o + 10], "big")
                kraw = f.read(klen)
                if len(kraw) < klen:
                    return None
                if os.fstat(f.fileno()).st_size != _HDR + klen + plen:
                    return None
                return tuple(json.loads(kraw.decode()))
        except (OSError, ValueError):
            return None

    # -- entry naming -----------------------------------------------------
    @staticmethod
    def _fname(key) -> str:
        import hashlib

        raw = json.dumps(list(key)).encode()
        return hashlib.sha256(raw).hexdigest()[:40] + _SUFFIX

    # -- contract ---------------------------------------------------------
    def get(self, key):
        with self._lock:
            ent = self._index.get(key)
            if ent is not None:
                self._index.move_to_end(key)
        if ent is None:
            _bump("cache_misses_disk")
            return None
        fp = os.path.join(self._dir, ent[0])
        data, poisoned = self._read_entry(fp, key)
        if data is not None:
            _bump("cache_hits_disk")
            try:
                os.utime(fp)  # LRU persists across restarts
            except OSError:
                pass
            return data
        # unreadable entry: evict; on CRC poison also pin the key so
        # the direct refetch ships uncached (see module docstring)
        with self._lock:
            dropped = self._index.pop(key, None)
            if dropped is not None:
                self._bytes -= dropped[1]
            if poisoned:
                self._no_recache.add(key)
        _unlink_quiet(fp)
        _bump("cache_misses_disk")
        _bump("cache_evictions_disk")
        if poisoned:
            if _flightrec._active is not None:
                _flightrec.flight(
                    "cache_poison", site="io.remote.range",
                    file=key[0], start=key[3], size=key[4])
            from ..obs.postmortem import postmortem_path_for, \
                record_incident

            record_incident(postmortem_path_for(None), {
                "kind": "cache_poison", "file": key[0],
                "start": key[3], "size": key[4], "entry": fp,
            })
        return None

    def contains(self, key) -> bool:
        """Counter-free index peek for the prefetch planner.  No
        hit/miss bump: conservation (hits + misses == lookups) is
        pinned on ``get`` alone, and prefetch consults this before
        deciding what to fetch — it is not a lookup."""
        with self._lock:
            return key in self._index

    def _read_entry(self, fp: str, key):
        """(payload, poisoned): payload None when unreadable; poisoned
        True only for a CRC mismatch inside intact framing."""
        try:
            with open(fp, "rb") as f:
                blob = f.read()
        except OSError:
            return None, False
        if len(blob) < _HDR or blob[:len(_MAGIC)] != _MAGIC:
            return None, False
        o = len(_MAGIC)
        crc = int.from_bytes(blob[o:o + 4], "big")
        plen = int.from_bytes(blob[o + 4:o + 12], "big")
        klen = int.from_bytes(blob[o + 12:o + 14], "big")
        if len(blob) != _HDR + klen + plen:
            return None, False
        try:
            stored = tuple(json.loads(blob[_HDR:_HDR + klen].decode()))
        except ValueError:
            return None, False
        if stored != tuple(key):
            return None, False
        payload = blob[_HDR + klen:]
        if zlib.crc32(payload) & 0xFFFFFFFF != crc:
            return None, True  # bit rot: the poisoning case
        return payload, False

    def put(self, key, data: bytes) -> None:
        with self._lock:
            if key in self._no_recache:
                self._no_recache.discard(key)
                return
        kraw = json.dumps(list(key)).encode()
        total = _HDR + len(kraw) + len(data)
        if total > self._budget:
            return
        fn = self._fname(key)
        fp = os.path.join(self._dir, fn)
        tmp = f"{fp}.{os.getpid()}.{threading.get_ident()}.tmp"
        hdr = (_MAGIC
               + (zlib.crc32(data) & 0xFFFFFFFF).to_bytes(4, "big")
               + len(data).to_bytes(8, "big")
               + len(kraw).to_bytes(2, "big"))
        try:
            with open(tmp, "wb") as f:
                f.write(hdr)
                f.write(kraw)
                f.write(data)
            os.replace(tmp, fp)
        except OSError:
            _unlink_quiet(tmp)
            return
        evict = []
        with self._lock:
            old = self._index.pop(key, None)
            if old is not None:
                self._bytes -= old[1]
            self._index[key] = [fn, total]
            self._bytes += total
            while self._bytes > self._budget and len(self._index) > 1:
                k, (efn, ebytes) = self._index.popitem(last=False)
                self._bytes -= ebytes
                evict.append(efn)
        for efn in evict:
            _unlink_quiet(os.path.join(self._dir, efn))
        if evict:
            _bump("cache_evictions_disk", len(evict))

    def invalidate_path(self, path: str) -> int:
        with self._lock:
            doomed = [(k, ent) for k, ent in self._index.items()
                      if k[0] == path]
            for k, ent in doomed:
                self._index.pop(k, None)
                self._bytes -= ent[1]
        for _, ent in doomed:
            _unlink_quiet(os.path.join(self._dir, ent[0]))
        if doomed:
            _bump("cache_evictions_disk", len(doomed))
        return len(doomed)

    def stats(self) -> dict:
        with self._lock:
            return {"entries": len(self._index), "bytes": self._bytes,
                    "budget": self._budget, "dir": self._dir}


def _unlink_quiet(fp: str) -> None:
    try:
        os.unlink(fp)
    except OSError:
        pass


def _pid_alive(pid: int) -> bool:
    try:
        os.kill(pid, 0)
    except ProcessLookupError:
        return False
    except OSError:
        pass  # EPERM etc: someone owns it — treat as alive
    return True


def _writer_pid(fn: str) -> int | None:
    """The process that names itself in a shared tier's entry file
    (``<hash>.<pid:x>-<gen:x>.tpqc``) or temporary file (an entry's
    ``<entry>.<pid>.<thread>.tmp``, the journal's
    ``index.tpqj.<pid>.tmp``); None for a name of another form."""
    try:
        if fn.endswith(".tmp"):
            parts = fn[: -len(".tmp")].split(".")
            return int(parts[-2] if _SUFFIX + "." in fn else parts[-1])
        if fn.endswith(_SUFFIX):
            stamp = fn[: -len(_SUFFIX)].rsplit(".", 1)[1]
            return int(stamp.split("-")[0], 16)
    except (IndexError, ValueError):
        pass
    return None


class _DirLock:
    """Cross-process mutex on the cache directory: an ``O_EXCL`` lock
    file carrying the holder's pid, with dead-holder recovery — a
    contender that finds the recorded pid dead renames the stale lock
    aside (exactly one contender wins the rename) and retakes it.

    File-only on purpose: in-process contenders are serialized by the
    owning cache's ``_jlock``, so this class never touches threading
    primitives and the file only ever arbitrates between processes."""

    def __init__(self, directory: str):
        self._path = os.path.join(directory, _LOCKFILE)
        self._seq = itertools.count(1)  # stale-rename uniqifier

    def acquire(self, timeout: float = 30.0) -> bool:
        deadline = time.monotonic() + timeout
        delay = 0.0005
        while True:
            try:
                fd = os.open(self._path,
                             os.O_CREAT | os.O_EXCL | os.O_WRONLY)
            except FileExistsError:
                self._recover_if_stale()
                if time.monotonic() >= deadline:
                    return False
                time.sleep(delay)
                delay = min(delay * 2, 0.05)
                continue
            except OSError:
                return False
            try:
                os.write(fd, json.dumps(
                    {"pid": os.getpid()}).encode())
            finally:
                os.close(fd)
            return True

    def _recover_if_stale(self) -> None:
        try:
            with open(self._path, "rb") as f:
                holder = json.loads(f.read().decode() or "{}")
        except (OSError, ValueError):
            return  # mid-create or already recovered: retry the open
        pid = holder.get("pid")
        if not isinstance(pid, int) or _pid_alive(pid):
            return
        # dead holder: exactly one contender wins this rename; losers
        # see ENOENT and simply retry the O_EXCL create
        stale = (f"{self._path}.stale-{os.getpid()}"
                 f"-{threading.get_ident():x}-{next(self._seq)}")
        try:
            os.rename(self._path, stale)
        except OSError:
            return
        _unlink_quiet(stale)

    def release(self) -> None:
        _unlink_quiet(self._path)


def _jframe(record: dict) -> bytes:
    payload = json.dumps(record, sort_keys=True).encode()
    return (_JMAGIC
            + (zlib.crc32(payload) & 0xFFFFFFFF).to_bytes(4, "big")
            + len(payload).to_bytes(4, "big")
            + payload)


def _jparse(blob: bytes, offset: int = 0):
    """Parse journal frames from ``offset``; returns
    ``(records, end_offset)`` — ``end_offset`` stops at the first
    torn/corrupt frame (a kill mid-append), which readers treat as
    end-of-journal and the next lock holder truncates."""
    records = []
    pos = offset
    n = len(blob)
    while pos + _JHDR <= n:
        if blob[pos:pos + len(_JMAGIC)] != _JMAGIC:
            break
        o = pos + len(_JMAGIC)
        crc = int.from_bytes(blob[o:o + 4], "big")
        plen = int.from_bytes(blob[o + 4:o + 8], "big")
        end = pos + _JHDR + plen
        if end > n:
            break
        payload = blob[pos + _JHDR:end]
        if zlib.crc32(payload) & 0xFFFFFFFF != crc:
            break
        try:
            records.append(json.loads(payload.decode()))
        except ValueError:
            break
        pos = end
    return records, pos


class SharedDiskRangeCache(DiskRangeCache):
    """The disk tier, safe for N concurrent processes over one
    directory (``TPQ_CACHE_DISK_SHARED=1``; see module docstring for
    the journal / lock / generation design).

    Lock order: ``_jlock`` (serializes this process's directory-lock
    critical sections; the ``index.lock`` file is taken and dropped
    strictly inside it) is always OUTERMOST; the in-memory mirror
    lock (``_lock``) nests inside it or stands alone; ``_gen_lock``
    is a leaf.  ``__init__``/``_sweep`` take no threading locks at
    all — construction happens before the instance is published (the
    tier singleton builds it under the module lock)."""

    def __init__(self, directory: str, budget: int):
        self._dirlock = _DirLock(directory)
        self._jlock = threading.Lock()
        self._gen_lock = threading.Lock()
        self._gen = 0          # guarded by _gen_lock
        self._joff = 0         # journal replay offset; guarded by _lock
        self._jino = -1        # journal inode at last replay; _lock
        os.makedirs(directory, exist_ok=True)
        self._jpath = os.path.join(directory, _JOURNAL)
        super().__init__(directory, budget)

    # -- naming -----------------------------------------------------------
    def _next_fname(self, key) -> str:
        """Generation-stamped entry name: publishes never reuse a live
        name, so a reader on the old name gets the complete old frame
        or a clean ENOENT — never a torn replacement."""
        base = DiskRangeCache._fname(key)[: -len(_SUFFIX)]
        with self._gen_lock:
            self._gen += 1
            gen = self._gen
        return f"{base}.{os.getpid():x}-{gen:x}{_SUFFIX}"

    # -- init self-heal ----------------------------------------------------
    def _sweep(self) -> None:
        """Join (or rejoin after a kill at any byte): under the
        directory lock, truncate a torn journal tail, reconcile the
        journal with the directory, and compact when the journal has
        outgrown its live set.  Init-only, pre-publication: mutates
        the mirror and replay offsets directly, no threading locks
        (see the class docstring)."""
        if not self._dirlock.acquire():
            from ..errors import TransientIOError

            raise TransientIOError(
                f"shared-cache lock in {self._dir} not acquired "
                f"(held by a live process for too long)",
                file=os.path.join(self._dir, _LOCKFILE))
        try:
            records, end, ino = self._read_journal_file()
            self._joff, self._jino = end, ino
            live: OrderedDict = OrderedDict()
            for rec in records:
                self._apply_record(rec, live, None)
            # drop journal entries whose file is gone or torn
            doomed = []
            for key, (fn, _nb) in list(live.items()):
                fp = os.path.join(self._dir, fn)
                if self._parse_header(fp) != key:
                    doomed.append((key, fn))
            for key, fn in doomed:
                live.pop(key, None)
                _unlink_quiet(os.path.join(self._dir, fn))
            # unlink orphans: entry files the journal does not own
            # (kill between publish and journal append, or between an
            # eviction record and its unlink) and .tmp stragglers; but
            # a live process's: it may be publishing them now, and it
            # journals (or drops) them under the lock this join holds
            owned = {fn for fn, _nb in live.values()}
            for fn in os.listdir(self._dir):
                if not (fn.endswith(".tmp") or (fn.endswith(_SUFFIX)
                                                and fn not in owned)):
                    continue
                pid = _writer_pid(fn)
                if pid is not None and _pid_alive(pid):
                    continue
                _unlink_quiet(os.path.join(self._dir, fn))
            if doomed or len(records) > max(64, 4 * len(live)):
                self._compact_init(live)
            self._index = OrderedDict(live)
            self._bytes = sum(nb for _fn, nb in live.values())
        finally:
            self._dirlock.release()

    def _read_journal_file(self):
        """Read the whole journal and truncate a torn tail so appends
        always extend a well-formed file — MUST hold the directory
        lock.  Returns ``(records, end_offset, inode)``; storing the
        offsets is the caller's job (init writes the attributes
        directly, runtime callers update them under ``_lock``)."""
        try:
            with open(self._jpath, "rb") as f:
                blob = f.read()
                ino = os.fstat(f.fileno()).st_ino
        except OSError:
            return [], 0, -1
        records, end = _jparse(blob)
        if end < len(blob):
            try:
                with open(self._jpath, "r+b") as f:
                    f.truncate(end)
            except OSError:
                pass
        return records, end, ino

    def _compact_init(self, live: OrderedDict) -> None:
        """Rewrite the journal as one ``put`` per live entry (tmp +
        replace; concurrent replayers detect the inode change and
        rebuild their mirror from scratch).  Init-only, under the
        directory lock — offsets are written directly."""
        tmp = f"{self._jpath}.{os.getpid()}.tmp"
        try:
            with open(tmp, "wb") as f:
                for key, (fn, nb) in live.items():
                    f.write(_jframe({"op": "put", "key": list(key),
                                     "fn": fn, "bytes": nb}))
                f.flush()
                os.fsync(f.fileno())
            os.replace(tmp, self._jpath)
        except OSError:
            _unlink_quiet(tmp)
            return
        try:
            st = os.stat(self._jpath)
        except OSError:
            return
        self._joff = st.st_size
        self._jino = st.st_ino

    # -- journal replay ----------------------------------------------------
    @staticmethod
    def _apply_record(rec: dict, index: OrderedDict,
                      pins: set | None) -> None:
        op = rec.get("op")
        key = tuple(rec.get("key") or ())
        if not key:
            return
        if op == "put":
            index.pop(key, None)
            index[key] = [rec.get("fn"), int(rec.get("bytes") or 0)]
        elif op in ("evict", "poison"):
            index.pop(key, None)
            if op == "poison" and pins is not None:
                pins.add(key)

    def _replay(self) -> None:
        """Fold journal records appended by OTHER processes into the
        in-memory mirror (no counters: the journaling process already
        accounted its own operation — replay is bookkeeping, not an
        event)."""
        with self._lock:
            off, ino = self._joff, self._jino
        try:
            st = os.stat(self._jpath)
        except OSError:
            return
        if st.st_ino == ino and st.st_size <= off:
            return
        try:
            with open(self._jpath, "rb") as f:
                cur_ino = os.fstat(f.fileno()).st_ino
                if cur_ino != ino or st.st_size < off:
                    blob = f.read()  # compacted underneath us: rebuild
                    records, end = _jparse(blob)
                    with self._lock:
                        fresh: OrderedDict = OrderedDict()
                        for rec in records:
                            self._apply_record(rec, fresh,
                                               self._no_recache)
                        self._index = fresh
                        self._bytes = sum(nb for _fn, nb
                                          in fresh.values())
                        self._joff = end
                        self._jino = cur_ino
                    return
                f.seek(off)
                blob = f.read()
        except OSError:
            return
        records, end = _jparse(blob)
        if not records:
            return
        with self._lock:
            if self._jino != ino or self._joff != off:
                return  # another thread replayed first
            for rec in records:
                self._apply_record(rec, self._index, self._no_recache)
            self._bytes = sum(nb for _fn, nb in self._index.values())
            self._joff = off + end
            self._jino = ino

    def _append_locked(self, records: list[dict]) -> None:
        """Append records — MUST hold ``_jlock`` + the directory
        lock.  First replays to the journal's true end (truncating a
        torn tail a killed process left), so the mirror is current
        before the new records land and our own records are consumed
        here, not by a later replay."""
        try:
            st = os.stat(self._jpath)
        except OSError:
            st = None
        with self._lock:
            stale = (st is None or st.st_ino != self._jino
                     or st.st_size != self._joff)
        if stale:
            recs, end, ino = self._read_journal_file()
            with self._lock:
                fresh: OrderedDict = OrderedDict()
                for rec in recs:
                    self._apply_record(rec, fresh, self._no_recache)
                self._index = fresh
                self._bytes = sum(nb for _fn, nb in fresh.values())
                self._joff, self._jino = end, ino
        blob = b"".join(_jframe(r) for r in records)
        try:
            with open(self._jpath, "ab") as f:
                f.write(blob)
                f.flush()
                os.fsync(f.fileno())
                end = f.tell()
        except OSError:
            return
        with self._lock:
            for rec in records:
                self._apply_record(rec, self._index, None)
            self._bytes = sum(nb for _fn, nb in self._index.values())
            # the journal's end, not the old offset plus our records: a
            # replay on another thread of this process may have read
            # them (and moved the offset past them) since the write
            self._joff = end

    # -- contract ---------------------------------------------------------
    def get(self, key):
        self._replay()
        with self._lock:
            ent = self._index.get(key)
            if ent is not None:
                self._index.move_to_end(key)
        if ent is None:
            _bump("cache_misses_disk")
            return None
        fp = os.path.join(self._dir, ent[0])
        data, poisoned = self._read_entry(fp, key)
        if data is not None:
            _bump("cache_hits_disk")
            try:
                os.utime(fp)  # cross-process LRU signal
            except OSError:
                pass
            return data
        if not poisoned and not os.path.exists(fp):
            # a concurrent evictor won the race between our mirror
            # peek and the open: their journal record carries the
            # eviction — for us this is a plain miss (or a hit on the
            # replacement generation, one replay later)
            self._replay()
            with self._lock:
                ent2 = self._index.get(key)
            if ent2 is not None and ent2[0] != ent[0]:
                data2, _p = self._read_entry(
                    os.path.join(self._dir, ent2[0]), key)
                if data2 is not None:
                    _bump("cache_hits_disk")
                    return data2
            _bump("cache_misses_disk")
            return None
        # torn or poisoned entry: evict fleet-wide through the journal
        with self._jlock:
            held = self._dirlock.acquire()
            if held:
                try:
                    self._append_locked([{
                        "op": "poison" if poisoned else "evict",
                        "key": list(key), "fn": ent[0]}])
                    _unlink_quiet(fp)
                finally:
                    self._dirlock.release()
        if not held:
            with self._lock:
                if poisoned:
                    self._no_recache.add(key)
            _bump("cache_misses_disk")
            return None
        with self._lock:
            if poisoned:
                self._no_recache.add(key)
        _bump("cache_misses_disk")
        _bump("cache_evictions_disk")
        if poisoned:
            if _flightrec._active is not None:
                _flightrec.flight(
                    "cache_poison", site="io.remote.range",
                    file=key[0], start=key[3], size=key[4])
            from ..obs.postmortem import postmortem_path_for, \
                record_incident

            record_incident(postmortem_path_for(None), {
                "kind": "cache_poison", "file": key[0],
                "start": key[3], "size": key[4], "entry": fp,
            })
        return None

    def contains(self, key) -> bool:
        self._replay()
        with self._lock:
            return key in self._index

    def put(self, key, data: bytes) -> None:
        with self._lock:
            if key in self._no_recache:
                self._no_recache.discard(key)
                return
        kraw = json.dumps(list(key)).encode()
        total = _HDR + len(kraw) + len(data)
        if total > self._budget:
            return
        fn = self._next_fname(key)
        fp = os.path.join(self._dir, fn)
        tmp = f"{fp}.{os.getpid()}.{threading.get_ident()}.tmp"
        hdr = (_MAGIC
               + (zlib.crc32(data) & 0xFFFFFFFF).to_bytes(4, "big")
               + len(data).to_bytes(8, "big")
               + len(kraw).to_bytes(2, "big"))
        try:
            with open(tmp, "wb") as f:
                f.write(hdr)
                f.write(kraw)
                f.write(data)
                f.flush()
                os.fsync(f.fileno())
            os.replace(tmp, fp)
        except OSError:
            _unlink_quiet(tmp)
            return
        evict: list[str] = []
        n_evicted = 0
        with self._jlock:
            if not self._dirlock.acquire():
                _unlink_quiet(fp)  # degrade to uncached, not stale
                return
            try:
                # _append_locked would fold remote records in anyway,
                # but peek first: when another process already
                # published this key, keep ITS entry (first publisher
                # wins — that is the once-per-span fleet economy) and
                # drop ours
                self._replay()
                with self._lock:
                    existing = self._index.get(key)
                if existing is not None:
                    _unlink_quiet(fp)
                    return
                self._append_locked([{"op": "put", "key": list(key),
                                      "fn": fn, "bytes": total}])
                # budget eviction, decided under the directory lock
                # by cross-process LRU (entry mtime; hits os.utime
                # theirs)
                with self._lock:
                    over = self._bytes > self._budget \
                        and len(self._index) > 1
                while over:
                    victim = self._oldest_entry(exclude=key)
                    if victim is None:
                        break
                    vkey, vfn = victim
                    self._append_locked([
                        {"op": "evict",
                         "key": list(vkey), "fn": vfn}])
                    evict.append(vfn)
                    n_evicted += 1
                    with self._lock:
                        over = self._bytes > self._budget \
                            and len(self._index) > 1
            finally:
                self._dirlock.release()
        for efn in evict:
            _unlink_quiet(os.path.join(self._dir, efn))
        if n_evicted:
            _bump("cache_evictions_disk", n_evicted)

    def _oldest_entry(self, exclude=None):
        """LRU victim by entry-file mtime (the cross-process signal
        ``get`` refreshes); mirror order breaks ties.  Returns
        ``(key, fname)`` or None."""
        with self._lock:
            candidates = [(k, fn) for k, (fn, _nb)
                          in self._index.items() if k != exclude]
        best = None
        best_m = None
        for k, fn in candidates:
            try:
                m = os.stat(os.path.join(self._dir, fn)).st_mtime_ns
            except OSError:
                return k, fn  # file already gone: reap the record
            if best_m is None or m < best_m:
                best, best_m = (k, fn), m
        return best

    def invalidate_path(self, path: str) -> int:
        self._replay()
        with self._lock:
            doomed = [(k, ent[0]) for k, ent in self._index.items()
                      if k[0] == path]
        if not doomed:
            return 0
        with self._jlock:
            if not self._dirlock.acquire():
                return 0
            try:
                self._append_locked([
                    {"op": "evict", "key": list(k), "fn": fn}
                    for k, fn in doomed])
            finally:
                self._dirlock.release()
        for _k, fn in doomed:
            _unlink_quiet(os.path.join(self._dir, fn))
        _bump("cache_evictions_disk", len(doomed))
        return len(doomed)

    def stats(self) -> dict:
        self._replay()
        d = super().stats()
        d["shared"] = True
        return d


# -- process-wide tier singletons (env-keyed, rebuilt when config
# changes; mutated only under the module lock) --------------------------
_LOCK = threading.Lock()
_MEM: tuple | None = None   # (budget, MemRangeCache)
_DISK: tuple | None = None  # ((dir, budget, shared), DiskRangeCache)


def mem_cache() -> MemRangeCache | None:
    global _MEM
    budget = mem_cache_budget()
    if budget <= 0:
        return None
    with _LOCK:
        if _MEM is None or _MEM[0] != budget:
            _MEM = (budget, MemRangeCache(budget))
        return _MEM[1]


def disk_cache() -> DiskRangeCache | None:
    global _DISK
    d = disk_cache_dir()
    if d is None:
        return None
    budget = disk_cache_budget()
    if budget <= 0:
        return None
    shared = disk_cache_shared()
    with _LOCK:
        if _DISK is None or _DISK[0] != (d, budget, shared):
            cls = SharedDiskRangeCache if shared else DiskRangeCache
            _DISK = ((d, budget, shared), cls(d, budget))
        return _DISK[1]


def invalidate_source_caches(src: str) -> int:
    """Drop every cached range for a source from BOTH tiers — the
    corruption/quarantine/salvage invalidation hook.  Accepts a bare
    path or a ``scheme://`` URI; returns entries dropped."""
    path = _norm_path(src)
    n = 0
    m = mem_cache()
    if m is not None:
        n += m.invalidate_path(path)
    d = disk_cache()
    if d is not None:
        n += d.invalidate_path(path)
    return n


def reset_range_caches() -> None:
    """Test hook: forget both tier singletons (the next lookup rebuilds
    from the current env)."""
    global _MEM, _DISK
    with _LOCK:
        _MEM = None
        _DISK = None
