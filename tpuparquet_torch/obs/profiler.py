"""Sampling profiler whose samples carry the trace's context.

The port of ``tpuparquet/obs/profiler.py``.  The trace names the stage
that bounds a scan; the profiler names the function.  A background
daemon walks ``sys._current_frames()`` on a jittered grid
(``TPQ_PROFILE``, ``TPQ_PROFILE_HZ``; default off) and folds each
thread's stack into a mergeable trie keyed ``(label, stage)``.

Every sample carries the ambient context.  Contextvars cannot be read
across threads, so the profiler keeps its own mirror: :func:`ctx_push`
and :func:`ctx_pop` (called by ``obs/trace.py`` at every context push,
pop and adopt) keep a stack of open ``(trace, span, name)`` entries a
thread and a bounded ``trace -> label`` map, and :func:`stage_begin`/
:func:`stage_end` let the stages that emit their span only after
measuring (the row group's transfer and dispatch, the filtered route's
transfer, the gathers, a chunk's page writes) declare their stage while
the work runs.

**Off-CPU** samples count apart: :func:`wait_begin`/:func:`wait_end`
mark a thread as blocked, and the sampler appends a synthetic leaf
frame.  The chunk read marks its fetch as an ``io`` wait, so a hung read
(the ``io.chunk.hang`` fault included) samples as ``[io-wait
io.reader.chunk_read]`` under the ``read`` stage.  Arming installs
:func:`wait_begin`/:func:`wait_end` into the lock-order recorder's
wrappers (``lockcheck.py``, under ``TPQ_LOCKCHECK``), so a thread that
queues on a contended repo lock samples as ``[lock-wait
tpuparquet_torch/<file>:<line>]``, the lock's creation site.

Counts are integers: the buckets and the ``profile_samples``,
``profile_samples_offcpu`` and ``profile_drops`` counters fold by
elementwise adds (``to_state``/:func:`merge_profile_states`), and
``shard/distributed.py`` ``allgather_profiles`` folds processes over the
JSON wire of the digests.  Exports are atomic and routed by suffix
(:func:`write_profile_file`): ``*.collapsed`` is collapsed-stack text
(flamegraph.pl, speedscope), ``*.chrome.json``/``*.perfetto.json`` Chrome
trace events, anything else the native ``tpq-profile`` envelope
(:func:`load_profile_file`).  Frame names are paths relative to the
repository root (``tpuparquet_torch/...``) with the function's name.

Off (the default), every entry point is one module-global load and an
``is None`` check, and hot sites guard the call itself (``if
_profiler._active is not None:``).  Armed, the sampler owns the cost of
the walk, and the instrumented threads pay a dict or list poke at a
span, stage or wait boundary, never per value.

The exit-time flush takes ``live._flush_lock``, as the snapshot writer's
final flush does, so a profile export never interleaves with a ring
frame.
"""

from __future__ import annotations

import json
import os
import random
import sys
import threading
import time
from collections import deque

from .attribution import STAGE_OF

__all__ = [
    "Profiler", "profiler", "set_profiling", "profile_default",
    "profile_hz_default", "profile_export_default",
    "ctx_push", "ctx_pop", "span_note", "stage_begin", "stage_end",
    "wait_begin", "wait_end",
    "merge_profile_states", "write_profile_file", "load_profile_file",
    "collapsed_lines", "top_frames", "diff_states",
    "profile_consistency", "final_flush", "export_now",
]

PROFILE_FILE_FORMAT = "tpq-profile"

_DEFAULT_HZ = 50.0
_MAX_DEPTH = 96        # frames kept per sampled stack
_MAX_LABELS = 512      # bounded trace -> label map
_MAX_SPAN_STAGES = 4096  # bounded (trace, span) -> stage map
_REPO_ROOT = os.path.dirname(
    os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def profile_default() -> bool:
    """Profiler master switch (``TPQ_PROFILE``, default off — the
    armed sampler owns a thread, so arming is an explicit choice)."""
    return os.environ.get("TPQ_PROFILE", "0") != "0"


def profile_hz_default() -> float:
    """Sampling cadence from ``TPQ_PROFILE_HZ`` (default 50; clamped
    to [1, 1000] — above 1 kHz the walk cost dominates the signal)."""
    try:
        v = float(os.environ.get("TPQ_PROFILE_HZ", ""))
    except ValueError:
        return _DEFAULT_HZ
    if v <= 0:
        return _DEFAULT_HZ
    return min(max(v, 1.0), 1000.0)


def profile_export_default() -> str | None:
    """Flush/exit profile export path (``TPQ_PROFILE_EXPORT``;
    None=off)."""
    return os.environ.get("TPQ_PROFILE_EXPORT") or None


def _short_path(fn: str, cache: dict) -> str:
    s = cache.get(fn)
    if s is None:
        try:
            rel = os.path.relpath(fn, _REPO_ROOT)
        except ValueError:
            rel = fn
        if rel.startswith(".."):
            rel = os.path.basename(fn)
        s = cache[fn] = rel.replace(os.sep, "/")
    return s


class Profiler:
    """The armed sampler: per-``(label, stage)`` stack buckets with
    exact integer counts, the per-thread tag mirror the tracer feeds,
    and the wait/stage marker state.

    Thread model: the tag mirror (``_threads``/``_stages``/``_waits``)
    is written by the instrumented threads themselves (plain dict/list
    pokes — GIL-atomic, no locks on the instrumented path) and read by
    the sampler, which tolerates a momentarily-stale tag (a sample is
    a statistical observation, not a ledger entry).  The BUCKETS are
    the ledger: only the sampler writes them, under ``_lock``, and
    every snapshot/merge is an exact integer fold."""

    def __init__(self, hz: float = _DEFAULT_HZ):
        self.hz = float(hz)
        self.period = 1.0 / self.hz
        self._lock = threading.Lock()
        # (label, stage) -> {"samples", "offcpu", "stacks": {str: int}}
        self._buckets: dict = {}
        self.samples = 0
        self.samples_offcpu = 0
        self.drops = 0
        # tag mirror (written by instrumented threads, read by sampler)
        self._threads: dict = {}   # tid -> [(trace, span, name, stage)]
        self._stages: dict = {}    # tid -> [stage, ...] (hot-site hints)
        self._waits: dict = {}     # tid -> (kind, site)
        self._labels: dict = {}    # trace -> label (bounded)
        self._span_stage: dict = {}  # (trace, span) -> stage (bounded)
        # recent sample tags, for correlation checks and the live brief
        self.recent: deque = deque(maxlen=512)
        self._path_cache: dict = {}
        self._rng = random.Random(os.getpid())
        self._t0 = time.monotonic()
        self._rate_win: deque = deque(maxlen=64)  # (t, samples_total)
        self._pushed: dict = {}    # registry-mirror baselines
        self._stop = threading.Event()
        self._thread: threading.Thread | None = None

    # -- sampler lifecycle -------------------------------------------------

    def start(self) -> None:
        if self._thread is not None and self._thread.is_alive():
            return
        # Shrink the interpreter switch interval while armed: the
        # sampler needs the GIL to walk frames, and at the default 5ms
        # it acquires it preferentially when instrumented threads sit
        # in GIL-RELEASING C calls — every sample scheduled during a
        # pure-Python stretch slides forward into the next C call,
        # over-counting C-heavy stages.  A switch interval well under the sampling period
        # bounds that relocation to noise.  Restored on stop().
        self._prev_switch = sys.getswitchinterval()
        sys.setswitchinterval(max(min(self._prev_switch,
                                      self.period / 10.0), 1e-4))
        self._stop.clear()
        t = threading.Thread(target=self._run, daemon=True,
                             name="tpq-profiler")
        self._thread = t
        t.start()

    def stop(self) -> None:
        self._stop.set()
        t = self._thread
        if t is not None and t.is_alive():
            t.join(timeout=2.0)
        prev = getattr(self, "_prev_switch", None)
        if prev is not None:
            self._prev_switch = None
            sys.setswitchinterval(prev)

    def _delay(self) -> float:
        """One inter-sample sleep: the period grid jittered across the
        FULL period — uniform in ``[0.5p, 1.5p]``, mean exactly ``p``
        (the configured cadence), with the sample phase doing a random
        walk whose stationary distribution is uniform over the grid
        cell.  Small jitter is not enough: scan units run ~one sampler
        period long, and a phase that only wobbles 25% of the grid
        stays correlated with that structure for many samples,
        over-counting whichever stage beats against it."""
        return self.period * (0.5 + self._rng.random())

    def _run(self) -> None:
        while True:
            d = self._delay()
            due = time.monotonic() + d
            if self._stop.wait(d):
                return
            # Late-wakeup censoring: when the wait expires while an
            # instrumented thread holds the GIL (a long native call),
            # this thread only runs once that call RELEASES it — so a
            # late pass observes the process exactly at a GIL-release
            # boundary, not at its scheduled instant, over-counting
            # whichever code releases the GIL.  A pass that fires well past its due
            # time is a biased observation: record a drop instead of
            # a sample (the "no drops" certificate stays honest).
            if time.monotonic() - due > 0.25 * self.period:
                with self._lock:
                    self.drops += 1
                continue
            try:
                self.sample_once()
            except Exception:
                # the profiler must never take down the process it
                # observes; a failed pass is a dropped sample
                with self._lock:
                    self.drops += 1

    # -- one sampling pass -------------------------------------------------

    def _stack_of(self, frame) -> list[str]:
        cache = self._path_cache
        out: list[str] = []
        f = frame
        while f is not None and len(out) < _MAX_DEPTH:
            co = f.f_code
            out.append(f"{_short_path(co.co_filename, cache)}:"
                       f"{co.co_name}")
            f = f.f_back
        out.reverse()
        return out

    def _tag_of(self, tid: int):
        """(trace, span, label, stage) for one sampled thread, from
        the mirror — reads race the owner thread's pokes by design
        (worst case: one sample carries the just-closed tag)."""
        trace = span = None
        label = ""
        stage = None
        stk = self._threads.get(tid)
        if stk:
            try:
                trace, span = stk[-1][0], stk[-1][1]
                for ent in reversed(stk):
                    if ent[3] is not None:
                        stage = ent[3]
                        break
            except IndexError:
                pass  # emptied between check and read
        if trace is not None:
            label = self._labels.get(trace, "")
        hints = self._stages.get(tid)
        if hints:
            try:
                stage = hints[-1]
            except IndexError:
                pass
        return trace, span, label, stage

    def sample_once(self, now: float | None = None) -> int:
        """Walk every thread once; returns the samples recorded.
        Public so tests can drive the sampler deterministically without
        wall-clock waits."""
        t_wall = time.perf_counter()
        me = threading.get_ident()
        sampler = self._thread.ident if self._thread is not None else me
        frames = sys._current_frames()
        batch = []
        for tid, frame in frames.items():
            if tid == me or tid == sampler:
                continue
            trace, span, label, stage = self._tag_of(tid)
            wait = self._waits.get(tid)
            stack = self._stack_of(frame)
            offcpu = False
            if wait is not None:
                offcpu = True
                kind, site = wait
                stack.append(f"[{kind}-wait {site}]")
                if stage is None and kind == "io":
                    stage = "read"
            if stage is None:
                stage = "other"
            batch.append((label, stage, ";".join(stack), offcpu,
                          trace, span, stack[-1]))
        alive = frames.keys()
        with self._lock:
            for label, stage, stack, offcpu, trace, span, leaf in batch:
                b = self._buckets.get((label, stage))
                if b is None:
                    b = self._buckets[(label, stage)] = {
                        "samples": 0, "offcpu": 0, "stacks": {}}
                st = b["stacks"]
                st[stack] = st.get(stack, 0) + 1
                b["samples"] += 1
                self.samples += 1
                if offcpu:
                    b["offcpu"] += 1
                    self.samples_offcpu += 1
                self.recent.append({
                    "t": t_wall, "trace": trace, "span": span,
                    "label": label, "stage": stage, "offcpu": offcpu,
                    "leaf": leaf})
            # mirror-state hygiene rides the sampler (single writer):
            # dead threads' tags go, and the label map stays bounded
            for d in (self._threads, self._stages, self._waits):
                for tid in [t for t in d if t not in alive]:
                    d.pop(tid, None)
            while len(self._labels) > _MAX_LABELS:
                self._labels.pop(next(iter(self._labels)), None)
            while len(self._span_stage) > _MAX_SPAN_STAGES:
                self._span_stage.pop(next(iter(self._span_stage)),
                                     None)
            self._rate_win.append((time.monotonic(), self.samples))
        elapsed = time.perf_counter() - t_wall
        if elapsed > self.period:
            # the walk overran the cadence: the grid points we slept
            # through are samples that never happened — count them so
            # "no drops" certifies a complete sampling record
            with self._lock:
                self.drops += int(elapsed / self.period)
        self._mirror_registry()
        return len(batch)

    def _mirror_registry(self) -> None:
        """Push counter deltas + live gauges into the process metrics
        registry so ring frames and snapshot exports see the profiler
        without a surface of their own.  Exact:
        deltas from remembered baselines, applied on the sampler's own
        shard."""
        from . import live as _live

        if not _live.live_enabled():
            return
        reg = _live._registry
        base = self._pushed
        for name, v in (("profile_samples", self.samples),
                        ("profile_samples_offcpu", self.samples_offcpu),
                        ("profile_drops", self.drops)):
            d = v - base.get(name, 0)
            if d:
                reg.counter(name, d)
                base[name] = v
        br = self.brief()
        reg.gauge("profile_rate_hz", br["rate_hz"])
        reg.gauge("profile_offcpu_share", br["offcpu_share"])
        if br["top_frame"]:
            reg.gauge("profile_top_frame", br["top_frame"])

    # -- reading -----------------------------------------------------------

    def brief(self) -> dict:
        """The one-line live summary the progress frames carry:
        cumulative counters, the observed sample rate over the recent
        window, the off-CPU share, and the top self-time frame."""
        with self._lock:
            samples = self.samples
            offcpu = self.samples_offcpu
            drops = self.drops
            win = list(self._rate_win)
            top = None
            best = 0
            for b in self._buckets.values():
                for stack, n in b["stacks"].items():
                    leaf = stack.rsplit(";", 1)[-1]
                    if n > best:
                        best, top = n, leaf
        if len(win) >= 2 and win[-1][0] > win[0][0]:
            rate = (win[-1][1] - win[0][1]) / (win[-1][0] - win[0][0])
        else:
            up = max(time.monotonic() - self._t0, 1e-9)
            rate = samples / up
        return {
            "samples": samples,
            "offcpu": offcpu,
            "drops": drops,
            "rate_hz": round(rate, 2),
            "offcpu_share": round(offcpu / samples, 4) if samples else 0.0,
            "top_frame": top,
            "period_s": self.period,
        }

    def to_state(self) -> dict:
        """JSON-serializable exact state: the counters, the period,
        and the buckets nested ``{label: {stage: {...}}}``."""
        with self._lock:
            buckets: dict = {}
            for (label, stage), b in sorted(self._buckets.items()):
                buckets.setdefault(label, {})[stage] = {
                    "samples": b["samples"],
                    "offcpu": b["offcpu"],
                    "stacks": dict(b["stacks"]),
                }
            return {
                "period_s": self.period,
                "hz": self.hz,
                "counters": {
                    "profile_samples": self.samples,
                    "profile_samples_offcpu": self.samples_offcpu,
                    "profile_drops": self.drops,
                },
                "buckets": buckets,
            }

    def merge_state(self, d: dict) -> None:
        """Exact fold of another profiler's ``to_state`` into this
        one (elementwise integer adds, the digest discipline)."""
        with self._lock:
            c = d.get("counters") or {}
            self.samples += int(c.get("profile_samples", 0))
            self.samples_offcpu += int(
                c.get("profile_samples_offcpu", 0))
            self.drops += int(c.get("profile_drops", 0))
            for label, stages in (d.get("buckets") or {}).items():
                for stage, sb in stages.items():
                    b = self._buckets.get((label, stage))
                    if b is None:
                        b = self._buckets[(label, stage)] = {
                            "samples": 0, "offcpu": 0, "stacks": {}}
                    b["samples"] += int(sb.get("samples", 0))
                    b["offcpu"] += int(sb.get("offcpu", 0))
                    st = b["stacks"]
                    for stack, n in (sb.get("stacks") or {}).items():
                        st[stack] = st.get(stack, 0) + int(n)


# ----------------------------------------------------------------------
# Module gate — the one-is-None idiom (recorder/trace/digest shape)
# ----------------------------------------------------------------------

_lock = threading.Lock()

#: The active profiler, or None when off — the single gate every
#: entry point checks (one global load + ``is None``).  Armed from the
#: environment at import; reconfigure at runtime with
#: :func:`set_profiling`.
_active: Profiler | None = None

_atexit_registered = False


def profiler() -> Profiler | None:
    """The active profiler (None when off)."""
    return _active


def _install_hooks(p: Profiler | None) -> None:
    from .. import lockcheck as _lockcheck

    if p is None:
        _lockcheck.set_wait_hooks(None, None)
    else:
        _lockcheck.set_wait_hooks(wait_begin, wait_end)


def set_profiling(on: bool = True, *, hz: float | None = None,
                  start: bool = True) -> Profiler | None:
    """Runtime reconfigure: ``True`` installs a FRESH profiler (and
    starts its sampler thread unless ``start=False`` — tests drive
    ``sample_once`` by hand), ``False`` disarms and stops the sampler.
    Arming installs the lockcheck wait hooks and registers the atexit
    flush; returns the new profiler."""
    global _active, _atexit_registered
    with _lock:
        old = _active
        if old is not None:
            _active = None
            old.stop()
        if not on:
            _install_hooks(None)
            return None
        p = Profiler(hz if hz is not None else profile_hz_default())
        _active = p
        _install_hooks(p)
        if not _atexit_registered:
            import atexit

            atexit.register(final_flush)
            _atexit_registered = True
        if start:
            p.start()
        return p


def _init_from_env() -> None:
    if profile_default():
        set_profiling(True)


# (the env arming itself happens at the end of the module: arming
# installs wait_begin/wait_end into lockcheck, so every hook must be
# defined first)


# ----------------------------------------------------------------------
# Tag-mirror hooks (fed by obs.trace at every context transition)
# ----------------------------------------------------------------------

def ctx_push(trace, span, name, label=None) -> None:
    """Mirror one ambient-context push for the sampler.  Called from
    ``start_trace``/``open_span(push=True)``/``adopt`` under the
    tracer's guard; one list append a span, never per value."""
    p = _active
    if p is None:
        return
    tid = threading.get_ident()
    stk = p._threads.get(tid)
    if stk is None:
        stk = p._threads[tid] = []
    if name is not None:
        stage = STAGE_OF.get(name)
        p._span_stage[(trace, span)] = stage
    else:
        # an adopt joins a span opened elsewhere — resolve its stage
        # from the side-map the opening site registered
        stage = p._span_stage.get((trace, span))
    stk.append((trace, span, name, stage))
    if label is not None:
        p._labels[trace] = label


def ctx_pop(trace, span) -> None:
    """Mirror the matching pop: drops the entry (and anything stacked
    above it — a non-LIFO close truncates defensively, matching the
    tracer's own conditional-reset semantics)."""
    p = _active
    if p is None:
        return
    stk = p._threads.get(threading.get_ident())
    if not stk:
        return
    for i in range(len(stk) - 1, -1, -1):
        if stk[i][0] == trace and stk[i][1] == span:
            del stk[i:]
            return


def span_note(trace, span, name) -> None:
    """Register a ``push=False`` span's stage without touching any
    thread's mirror (the opener's ambient context is deliberately left
    alone) — workers that later :func:`adopt` the span's ctx then
    resolve its stage.  Called from ``open_span`` under the tracer's
    guard."""
    p = _active
    if p is None:
        return
    p._span_stage[(trace, span)] = STAGE_OF.get(name)


def stage_begin(stage: str):
    """Declare the calling thread to be inside a pipeline stage for
    the duration of a region (the hot stages — transfer, dispatch,
    page writes, gathers — only ``emit_span`` after measuring, so the
    span mirror alone can't see them while they run).  Returns a
    token for :func:`stage_end`; hot sites guard the call with
    ``_profiler._active is not None``."""
    p = _active
    if p is None:
        return None
    tid = threading.get_ident()
    lst = p._stages.get(tid)
    if lst is None:
        lst = p._stages[tid] = []
    lst.append(stage)
    return (p, tid)


def stage_end(token) -> None:
    """Close a :func:`stage_begin` region (None token = profiler was
    off at entry; a token from a since-replaced profiler pops its own
    instance's state)."""
    if token is None:
        return
    p, tid = token
    lst = p._stages.get(tid)
    if lst:
        try:
            lst.pop()
        except IndexError:
            pass


def wait_begin(kind: str, site: str):
    """Mark the calling thread as blocked (off-CPU) at ``site`` until
    :func:`wait_end`.  ``kind`` is ``"io"`` for the chunk fetch path
    (the reference also marks ``"lock"`` waits through its lock
    checker).  Nested waits restore the outer marker on exit."""
    p = _active
    if p is None:
        return None
    tid = threading.get_ident()
    prev = p._waits.get(tid)
    p._waits[tid] = (kind, site)
    return (p, tid, prev)


def wait_end(token) -> None:
    if token is None:
        return
    p, tid, prev = token
    if prev is None:
        p._waits.pop(tid, None)
    else:
        p._waits[tid] = prev


# ----------------------------------------------------------------------
# State algebra (cross-host folds) + analysis
# ----------------------------------------------------------------------

def _empty_state() -> dict:
    return {"period_s": 0.0, "hz": 0.0,
            "counters": {"profile_samples": 0,
                         "profile_samples_offcpu": 0,
                         "profile_drops": 0},
            "buckets": {}}


def merge_profile_states(states: list[dict]) -> dict:
    """Fold per-host ``to_state`` dicts into one exact fleet-wide
    state (counters and bucket/stack counts sum elementwise — the
    single-host profile of the union run).  The period comes from the
    first state carrying one; mixed-cadence merges keep their counts
    exact but the seconds view uses that first period."""
    out = _empty_state()
    for d in states:
        if not d:
            continue
        if not out["period_s"] and d.get("period_s"):
            out["period_s"] = float(d["period_s"])
            out["hz"] = float(d.get("hz") or 0.0)
        c = d.get("counters") or {}
        for k in out["counters"]:
            out["counters"][k] += int(c.get(k, 0))
        for label, stages in (d.get("buckets") or {}).items():
            for stage, sb in stages.items():
                b = out["buckets"].setdefault(label, {}).setdefault(
                    stage, {"samples": 0, "offcpu": 0, "stacks": {}})
                b["samples"] += int(sb.get("samples", 0))
                b["offcpu"] += int(sb.get("offcpu", 0))
                st = b["stacks"]
                for stack, n in (sb.get("stacks") or {}).items():
                    st[stack] = st.get(stack, 0) + int(n)
    return out


def _iter_buckets(state: dict, label=None, stage=None):
    for lb, stages in (state.get("buckets") or {}).items():
        if label is not None and lb != label:
            continue
        for st, b in stages.items():
            if stage is not None and st != stage:
                continue
            yield lb, st, b


def top_frames(state: dict, *, label=None, stage=None,
               n: int = 15) -> list[dict]:
    """Top frames by self samples over the matching buckets.  Each
    row: the frame, self/total sample counts (total counts a frame
    once per stack it appears in), the seconds view at the state's
    period, and the self share of the selection."""
    period = float(state.get("period_s") or 0.0)
    self_c: dict = {}
    total_c: dict = {}
    total = 0
    for _lb, _st, b in _iter_buckets(state, label, stage):
        for stack, cnt in (b.get("stacks") or {}).items():
            frames = stack.split(";")
            total += cnt
            leaf = frames[-1]
            self_c[leaf] = self_c.get(leaf, 0) + cnt
            for f in set(frames):
                total_c[f] = total_c.get(f, 0) + cnt
    rows = []
    for f, s in sorted(self_c.items(), key=lambda kv: (-kv[1], kv[0])):
        rows.append({
            "frame": f,
            "self": s,
            "total": total_c.get(f, s),
            "self_s": round(s * period, 6),
            "total_s": round(total_c.get(f, s) * period, 6),
            "share": round(s / total, 4) if total else 0.0,
        })
        if len(rows) >= n:
            break
    return rows


def diff_states(a: dict, b: dict, *, n: int = 15) -> list[dict]:
    """Weighted stack diff for regression localization: each state's
    stacks normalize to shares of its own sample total (so runs of
    different length compare), then per-frame share deltas (a frame
    counts once per stack) rank what grew from A to B."""
    def shares(state: dict) -> tuple[dict, int]:
        per: dict = {}
        total = 0
        for _lb, _st, bk in _iter_buckets(state):
            for stack, cnt in (bk.get("stacks") or {}).items():
                total += cnt
                for f in set(stack.split(";")):
                    per[f] = per.get(f, 0) + cnt
        return per, total

    pa, ta = shares(a)
    pb, tb = shares(b)
    rows = []
    for f in set(pa) | set(pb):
        sa = pa.get(f, 0) / ta if ta else 0.0
        sb = pb.get(f, 0) / tb if tb else 0.0
        rows.append({"frame": f, "share_a": round(sa, 4),
                     "share_b": round(sb, 4),
                     "delta": round(sb - sa, 4)})
    rows.sort(key=lambda r: (-abs(r["delta"]), r["frame"]))
    return rows[:n]


def profile_consistency(state: dict, stages_s: dict,
                        slack: float = 1.25) -> list[str]:
    """A cross-check of profile and trace: per-stage sampled seconds
    (samples x period) must not exceed the span-derived stage wall —
    a violation means the profile and the trace describe different
    runs (or the tag mirror is lying).  ``slack`` is multiplicative;
    the additive allowance is Poisson-scale (3 sqrt(n) samples, floor
    two periods): a 0.06s stage at 200 Hz expects ~12 samples with a
    ~3.5-sample standard deviation, so a fixed two-sample allowance
    would fire on pure counting noise while being irrelevant to a
    stage carrying thousands of samples."""
    period = float(state.get("period_s") or 0.0)
    if period <= 0:
        return []
    per_stage: dict = {}
    for _lb, st, b in _iter_buckets(state):
        per_stage[st] = per_stage.get(st, 0) + int(b.get("samples", 0))
    out = []
    for st, cnt in sorted(per_stage.items()):
        wall = float(stages_s.get(st) or 0.0)
        if wall <= 0:
            continue
        sampled = cnt * period
        noise = max(3.0 * (cnt ** 0.5), 2.0) * period
        if sampled > wall * slack + noise:
            out.append(
                f"stage {st}: {sampled:.3f}s of samples exceeds the "
                f"{wall:.3f}s span-derived wall — profile and trace "
                f"disagree")
    return out


# ----------------------------------------------------------------------
# Export surfaces (atomic, suffix-routed — the trace-file discipline)
# ----------------------------------------------------------------------

def collapsed_lines(state: dict) -> list[str]:
    """Collapsed-stack text: ``label;stage;frame;...;frame count``
    per line (flamegraph.pl / speedscope input), label ``-`` for
    untagged samples.  Deterministic order (sorted) so byte-identical
    states render byte-identical files."""
    lines = []
    for lb, st, b in sorted(_iter_buckets(state),
                            key=lambda t: (t[0], t[1])):
        prefix = f"{lb or '-'};{st}"
        for stack, cnt in sorted((b.get("stacks") or {}).items()):
            lines.append(f"{prefix};{stack} {cnt}")
    return lines


def profile_chrome_trace(state: dict) -> dict:
    """The aggregate trie as Chrome trace events: one track per
    ``(label, stage)``, stacks laid out sequentially with width
    ``count x period`` and frames nested by depth — a flamegraph a
    Perfetto tab can open next to the span trace."""
    period_us = float(state.get("period_s") or 0.0) * 1e6
    events = []
    tracks = []
    for lb, st, b in sorted(_iter_buckets(state),
                            key=lambda t: (t[0], t[1])):
        tid = len(tracks)
        tracks.append((lb, st))
        events.append({
            "name": "thread_name", "ph": "M", "pid": 0, "tid": tid,
            "args": {"name": f"{lb or '-'}/{st}"}})
        cursor = 0.0
        stacks = sorted((b.get("stacks") or {}).items(),
                        key=lambda kv: (-kv[1], kv[0]))
        for stack, cnt in stacks:
            width = max(cnt * period_us, 1.0)
            for depth, frame in enumerate(stack.split(";")):
                events.append({
                    "name": frame, "cat": "profile", "ph": "X",
                    "ts": round(cursor + depth * 0.01, 2),
                    "dur": round(max(width - depth * 0.02, 0.01), 2),
                    "pid": 0, "tid": tid,
                    "args": {"samples": cnt}})
            cursor += width
    return {"traceEvents": events, "displayTimeUnit": "ms"}


def write_profile_file(state: dict, path: str) -> bool:
    """Publish a profile state atomically (tmp + ``os.replace`` via
    :func:`~tpuparquet_torch.obs.live.atomic_write_text` — telemetry must
    never fail the work it describes).  Format by suffix:
    ``*.collapsed`` → collapsed-stack text, ``*.chrome.json`` /
    ``*.perfetto.json`` → Chrome trace events, else the native
    ``tpq-profile`` envelope :func:`load_profile_file` reads."""
    from .live import atomic_write_text

    if path.endswith(".collapsed"):
        body = "\n".join(collapsed_lines(state)) + "\n"
    elif path.endswith((".chrome.json", ".perfetto.json")):
        body = json.dumps(profile_chrome_trace(state), sort_keys=True)
    else:
        obj = {"format": PROFILE_FILE_FORMAT, "version": 1, **state}
        body = json.dumps(obj, sort_keys=True)
    return atomic_write_text(path, body)


def load_profile_file(path: str) -> dict:
    """Read back a native ``tpq-profile`` envelope (the analysis
    surfaces need the exact state; collapsed/Chrome exports are
    one-way render targets).  Raises ``ValueError`` otherwise."""
    with open(path) as f:
        try:
            doc = json.load(f)
        except json.JSONDecodeError as e:
            raise ValueError(
                f"profile file {path!r} is not valid JSON: {e}") from e
    if isinstance(doc, dict) and doc.get("format") == PROFILE_FILE_FORMAT:
        return doc
    raise ValueError(f"{path!r} is not a tpq profile export")


def export_now(path: str | None = None) -> str | None:
    """Write the active profiler's state (atomic); returns the path
    written, or None when the profiler is off or no path is
    configured (``TPQ_PROFILE_EXPORT``)."""
    p = _active
    if p is None:
        return None
    if path is None:
        path = profile_export_default()
    if not path:
        return None
    return path if write_profile_file(p.to_state(), path) else None


def final_flush() -> None:
    """The atexit flush: one last export, serialized with the
    snapshot writer's final flush through the shared
    :data:`live._flush_lock` so a profile export can never interleave
    with a metrics/timeseries frame mid-write.  Callable directly
    (tests, explicit shutdown)."""
    from . import live as _live

    if _active is None:
        return
    with _live._flush_lock:
        export_now()


_init_from_env()
