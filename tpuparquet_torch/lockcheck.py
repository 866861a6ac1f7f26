"""Runtime lock-order recorder (``TPQ_LOCKCHECK``): the dynamic half
of the port's concurrency gate.

The port of ``tpuparquet/lockcheck.py``.  The static pass
(``tpuparquet_torch/analyze/threads.py``) computes a *lock-acquisition
graph* ("while holding lock A, code may acquire lock B") by
whole-program AST analysis and rejects cycles.  Static analysis
over-approximates, so a clean static graph does not prove that it models
what runs.  This module checks it from the other side: with
``TPQ_LOCKCHECK=1`` in the environment, :func:`install` (invoked at the
top of ``tpuparquet_torch/__init__`` before any submodule or ``torch``
is imported) replaces ``threading.Lock``/``threading.RLock`` with
recording wrappers.  Every acquisition appends *held-set -> acquired*
edges to a process-global graph keyed by the lock's **creation site**
(``tpuparquet_torch/<file>:<line>`` of the ``threading.Lock()`` call),
the identity the static pass exports, so the two graphs compare
directly:

* a **cycle** among repo locks at runtime is a real (at least latent)
  deadlock and is recorded as a violation; ``TPQ_LOCKCHECK=strict``
  raises :class:`LockOrderError` at the acquisition that closed it;
* a recorded edge **absent from the static graph** means the static
  analysis missed a call path (``python -m tpuparquet_torch.analyze
  --verify-lockcheck DUMP``).

Scope: edges where both locks were created inside ``tpuparquet_torch/``
(or the repo's ``tests/``) are checked.  Foreign locks (the standard
library, ``concurrent.futures``, ``torch``) are recorded with their real
paths and kept out of the cycle and subgraph verdicts.  This module
imports neither ``torch`` nor any other module of the package, so
installing it first leaves every later lock wrapped.

When the sampling profiler arms (``obs/profiler.py``) it installs its
wait bracket here (:func:`set_wait_hooks`): a contended acquire then
samples as ``[lock-wait <site>]`` under its stage.

Env knobs: ``TPQ_LOCKCHECK`` (``1`` = record, ``strict`` = raise on a
cycle), ``TPQ_LOCKCHECK_OUT`` (dump the observed graph as JSON at
interpreter exit, written atomically).
"""

from __future__ import annotations

import atexit
import json
import os
import sys
import threading

__all__ = [
    "LockOrderError",
    "install",
    "uninstall",
    "installed",
    "set_wait_hooks",
    "edges",
    "locks_seen",
    "violations",
    "reset",
    "check_dag",
    "dump",
    "repo_site",
]

_REPO_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_REPO_PREFIXES = ("tpuparquet_torch/", "tests/")

# originals captured at import, before any patching
_RealLock = threading.Lock
_RealRLock = threading.RLock

_installed = False
_strict = False

# registry state, guarded by a REAL (unwrapped) lock so the recorder
# never records itself
_reg_lock = _RealLock()
_edges: dict[tuple, int] = {}       # (site_a, site_b) -> count
_sites: set = set()                 # every creation site seen
_violations: list[dict] = []

_tls = threading.local()            # .held: list of [site, depth]

#: Wait-edge hooks ``(begin, end)`` the sampling profiler installs
#: when it arms (:func:`set_wait_hooks`): a CONTENDED acquire — the
#: non-blocking first attempt failed — is bracketed so off-CPU samples
#: taken while the thread blocks attribute to this lock's creation
#: site (the same ``relpath:lineno`` identity the order graph keys
#: on).  One tuple, swapped atomically, so a reader never sees a
#: begin without its end.  None when no profiler is armed — the
#: acquire fast path is then one global load + ``is None``.
_wait_hooks: tuple | None = None


class LockOrderError(RuntimeError):
    """A lock acquisition closed a cycle in the observed lock-order
    graph (``TPQ_LOCKCHECK=strict``)."""


def repo_site(site: str) -> bool:
    """Is this creation site inside the repo (the package or its tests),
    as opposed to the standard library or ``torch``?  Cycle checks
    cover all repo locks; the static-subgraph comparison in
    ``tpuparquet_torch.analyze`` further restricts itself to the
    package."""
    return site.startswith(_REPO_PREFIXES)


def _caller_site() -> str:
    """Creation site of the lock: the IMMEDIATE caller of the patched
    constructor, repo-relative when inside the repo.  Deliberately not
    a walk to the nearest repo frame: a lock the stdlib creates on the
    repo's behalf (``threading.Thread``/``Event``/``Condition``
    internals) has no ``threading.Lock()`` call in repo source for the
    static pass to model, so it must stay foreign here or the
    runtime-subgraph check would flag edges static analysis can never
    see.  Only textual ``threading.Lock()``/``RLock()`` calls in repo
    files become repo sites — the exact set the AST pass keys on."""
    f = sys._getframe(2)
    this = __file__
    while f is not None and f.f_code.co_filename == this:
        f = f.f_back
    if f is None:
        return "<unknown>:0"
    fn = f.f_code.co_filename
    try:
        rel = os.path.relpath(fn, _REPO_ROOT)
    except ValueError:
        rel = fn
    if not rel.startswith(".."):
        fn = rel.replace(os.sep, "/")
    return f"{fn}:{f.f_lineno}"


def _held() -> list:
    h = getattr(_tls, "held", None)
    if h is None:
        h = _tls.held = []
    return h


def _would_cycle(a: str, b: str) -> list | None:
    """Path b -> ... -> a over repo-lock edges (callers hold
    ``_reg_lock``); adding a->b then closes the cycle."""
    if a == b:
        return [a, b]
    stack = [(b, [a, b])]
    seen = {b}
    while stack:
        node, path = stack.pop()
        for (x, y) in _edges:
            if x != node or y in seen:
                continue
            if not (repo_site(x) and repo_site(y)):
                continue
            if y == a:
                return path + [y]
            seen.add(y)
            stack.append((y, path + [y]))
    return None


def _record_acquire(site: str, reentrant: bool) -> None:
    held = _held()
    for ent in held:
        if ent[0] == site:
            if reentrant:
                ent[1] += 1
                return
            break  # non-reentrant self-acquire would deadlock for real
    cycle = None
    with _reg_lock:
        _sites.add(site)
        for ent in held:
            a = ent[0]
            if a == site:
                continue
            key = (a, site)
            fresh = key not in _edges
            _edges[key] = _edges.get(key, 0) + 1
            if fresh and repo_site(a) and repo_site(site):
                cycle = _would_cycle(a, site)
                if cycle is not None:
                    _violations.append(
                        {"kind": "lock-cycle", "cycle": cycle})
    held.append([site, 1])
    if cycle is not None and _strict:
        raise LockOrderError(
            "lock-order cycle closed at acquisition: "
            + " -> ".join(cycle))


def _record_release(site: str) -> None:
    held = _held()
    for i in range(len(held) - 1, -1, -1):
        if held[i][0] == site:
            held[i][1] -= 1
            if held[i][1] <= 0:
                del held[i]
            return


class _CheckedLock:
    """Recording wrapper over a real ``threading.Lock``."""

    _reentrant = False
    __slots__ = ("_inner", "_site", "__weakref__")

    def __init__(self, inner, site: str):
        self._inner = inner
        self._site = site

    def acquire(self, blocking: bool = True, timeout: float = -1):
        hooks = _wait_hooks
        if hooks is None or not blocking:
            got = self._inner.acquire(blocking, timeout)
        else:
            # profiler armed: try without blocking first — only a
            # CONTENDED acquire gets the wait bracket, so uncontended
            # locks never produce false off-CPU samples
            got = self._inner.acquire(False)
            if not got:
                tok = hooks[0]("lock", self._site)
                try:
                    got = self._inner.acquire(True, timeout)
                finally:
                    hooks[1](tok)
        if got:
            try:
                _record_acquire(self._site, self._reentrant)
            except LockOrderError:
                # strict verdict: fail the acquisition outright — the
                # caller sees the raise, so it must not be left
                # holding the lock (or the held-set record of it)
                _record_release(self._site)
                self._inner.release()
                raise
        return got

    def release(self) -> None:
        self._inner.release()
        _record_release(self._site)

    def locked(self) -> bool:
        return self._inner.locked()

    def _at_fork_reinit(self) -> None:
        # stdlib modules (concurrent.futures.thread, logging) register
        # this with os.register_at_fork — delegate, and drop any held
        # recording for this site in the child
        self._inner._at_fork_reinit()
        held = _held()
        held[:] = [ent for ent in held if ent[0] != self._site]

    def __enter__(self):
        self.acquire()
        return self

    def __exit__(self, *exc) -> None:
        self.release()

    def __repr__(self) -> str:
        return f"<lockcheck {type(self).__name__} {self._site}>"


class _CheckedRLock(_CheckedLock):
    """Recording wrapper over a real ``threading.RLock``; carries the
    owner/save/restore surface ``threading.Condition`` relies on."""

    _reentrant = True
    __slots__ = ()

    # Condition protocol -------------------------------------------------
    def _release_save(self):
        state = self._inner._release_save()
        _record_release(self._site)
        return state

    def _acquire_restore(self, state) -> None:
        hooks = _wait_hooks
        if hooks is None:
            self._inner._acquire_restore(state)
        else:
            # Condition.wait re-acquire: almost always contended (the
            # notifier holds the lock), so bracket it unconditionally
            tok = hooks[0]("lock", self._site)
            try:
                self._inner._acquire_restore(state)
            finally:
                hooks[1](tok)
        _record_acquire(self._site, True)

    def _is_owned(self) -> bool:
        return self._inner._is_owned()

    def _recursion_count(self) -> int:
        # multiprocessing's resource tracker (which torch starts) asks
        # its RLock for this at shutdown
        return self._inner._recursion_count()


def _lock_factory():
    return _CheckedLock(_RealLock(), _caller_site())


def _rlock_factory():
    return _CheckedRLock(_RealRLock(), _caller_site())


def install(strict: bool | None = None) -> None:
    """Patch ``threading.Lock``/``RLock`` with recording wrappers.
    Idempotent.  ``strict`` raises on a cycle at the closing
    acquisition (default: ``TPQ_LOCKCHECK=strict``)."""
    global _installed, _strict
    if strict is not None:
        _strict = bool(strict)
    else:
        _strict = os.environ.get("TPQ_LOCKCHECK", "") == "strict"
    if _installed:
        return
    threading.Lock = _lock_factory
    threading.RLock = _rlock_factory
    _installed = True
    out = os.environ.get("TPQ_LOCKCHECK_OUT")
    if out:
        atexit.register(dump, out)


def uninstall() -> None:
    """Restore the real constructors (already-wrapped locks keep
    recording — the registry stays consistent)."""
    global _installed
    threading.Lock = _RealLock
    threading.RLock = _RealRLock
    _installed = False


def installed() -> bool:
    return _installed


def set_wait_hooks(begin, end) -> None:
    """Install (or clear, with ``None, None``) the profiler's wait
    bracket around contended acquires.  The profiler calls this when
    it arms/disarms (``obs.profiler.set_profiling``); lockcheck keeps
    no dependency on obs — the hooks are opaque callables.  The swap
    is a single reference assignment (readers grab one snapshot), but
    it runs under ``_reg_lock`` anyway so two racing arm/disarm calls
    serialize."""
    global _wait_hooks
    with _reg_lock:
        _wait_hooks = (begin, end) if begin is not None else None


def enabled_from_env() -> bool:
    return os.environ.get("TPQ_LOCKCHECK", "") not in ("", "0")


def edges() -> list[tuple[str, str, int]]:
    """Observed (held, acquired, count) edges, sorted."""
    with _reg_lock:
        return sorted((a, b, n) for (a, b), n in _edges.items())


def locks_seen() -> list[str]:
    with _reg_lock:
        return sorted(_sites)


def violations() -> list[dict]:
    with _reg_lock:
        return [dict(v) for v in _violations]


def reset() -> None:
    """Forget every recorded edge/violation (tests)."""
    with _reg_lock:
        _edges.clear()
        _sites.clear()
        del _violations[:]


def check_dag() -> list[dict]:
    """Full-graph re-check over the repo-lock subgraph; returns cycle
    violations (the incremental acquire-time check should have caught
    them already — this is the belt to its braces)."""
    with _reg_lock:
        repo_edges = [(a, b) for (a, b) in _edges
                      if repo_site(a) and repo_site(b)]
    graph: dict[str, list[str]] = {}
    for a, b in repo_edges:
        graph.setdefault(a, []).append(b)
    out: list[dict] = []
    WHITE, GREY, BLACK = 0, 1, 2
    color = {n: WHITE for n in graph}

    def visit(n, path):
        color[n] = GREY
        for m in graph.get(n, ()):
            if color.get(m, WHITE) == GREY:
                out.append({"kind": "lock-cycle",
                            "cycle": path + [n, m]})
            elif color.get(m, WHITE) == WHITE:
                visit(m, path + [n])
        color[n] = BLACK
    for n in sorted(graph):
        if color[n] == WHITE:
            visit(n, [])
    return out


def snapshot() -> dict:
    """The observed graph as one JSON-ready document."""
    return {
        "locks": locks_seen(),
        "edges": [[a, b, n] for a, b, n in edges()],
        "violations": violations() + check_dag(),
    }


def dump(path: str) -> None:
    """Write :func:`snapshot` to ``path`` atomically."""
    doc = snapshot()
    tmp = f"{path}.{os.getpid()}.tmp"
    with open(tmp, "w", encoding="utf-8") as f:
        json.dump(doc, f, indent=1, sort_keys=True)
    os.replace(tmp, path)
