"""The sampling profiler and its stage markers (ROADMAP A.11 part 2):
tpuparquet_torch against the JAX package.

Random profile states made from numpy seeds go through both packages'
state algebra (``merge_profile_states``, ``Profiler.merge_state``,
``top_frames``, ``diff_states``, ``profile_consistency``) and exports
(collapsed stacks, Chrome trace events, the native envelope), which
agree to the byte.  The sampler is driven by hand (``set_profiling(True,
start=False)`` and ``sample_once``; no sampler thread, no sleeps): a
thread parked inside a traced span, a stage marker or an IO wait is
tagged with the same label, stage and off-CPU flag in both packages, its
stack's function names equal (the frames' file names are dropped: the
port's frames are under ``tpuparquet_torch/``).  Reads, scans and
filtered scans of the same files open the same stage and wait markers.
Tolerance: exact for every count, share and export.
"""

import os
import sys
import threading
import time
from types import SimpleNamespace

import numpy as np
import pytest

import tpuparquet.faults as jax_faults
import tpuparquet.filter as jax_filter
import tpuparquet.kernels.device as jax_device
import tpuparquet.shard.scan as jax_scan
from tpuparquet import FileReader as JaxFileReader
from tpuparquet.obs import attribution as jax_attribution
from tpuparquet.obs import live as jax_live
from tpuparquet.obs import profiler as jax_profiler
from tpuparquet.obs import trace as jax_trace
from tpuparquet_torch import faults as port_faults
from tpuparquet_torch import filter as port_filter
from tpuparquet_torch.cpu.plain import ByteArrayColumn
from tpuparquet_torch.format.metadata import CompressionCodec
from tpuparquet_torch.io.reader import FileReader
from tpuparquet_torch.io.writer import FileWriter
from tpuparquet_torch.kernels import device as port_device
from tpuparquet_torch.obs import attribution, live, profiler, trace
from tpuparquet_torch.shard import distributed as port_dist
from tpuparquet_torch.shard import make_mesh
from tpuparquet_torch.shard import scan as port_scan


JAX = SimpleNamespace(profiler=jax_profiler, trace=jax_trace,
                      live=jax_live, attribution=jax_attribution,
                      faults=jax_faults, filter=jax_filter,
                      device=jax_device, scan=jax_scan,
                      reader=lambda p: JaxFileReader(p), read_kw={},
                      scan_kw={})
PORT = SimpleNamespace(profiler=profiler, trace=trace, live=live,
                       attribution=attribution, faults=port_faults,
                       filter=port_filter, device=port_device,
                       scan=port_scan, reader=lambda p: FileReader(p),
                       read_kw={"device": "cpu"},
                       scan_kw={"mesh": make_mesh(8, devices=["cpu"] * 8)})
SIDES = (JAX, PORT)

SCHEMA = ("message test { required int64 a; required double b; "
          "optional binary s (STRING); }")
STAGES = sorted(set(attribution.STAGE_OF.values())) + ["other"]


def write_file(path, rows=160, rg_rows=40, seed=0):
    with open(path, "wb") as f, FileWriter(
            f, SCHEMA, codec=CompressionCodec.SNAPPY) as w:
        for lo in range(0, rows, rg_rows):
            j = np.arange(lo, lo + rg_rows)
            valid = j % 3 != 0
            strs = [f"r{x}".encode() for x in j[valid]]
            offs = np.zeros(len(strs) + 1, np.int64)
            np.cumsum([len(s) for s in strs], out=offs[1:])
            w.write_columns(
                {"a": (j + seed).astype(np.int64), "b": (j + seed) * 0.5,
                 "s": ByteArrayColumn(offs, np.frombuffer(
                     b"".join(strs), np.uint8))},
                masks={"s": valid})
    return str(path)


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    d = tmp_path_factory.mktemp("prof")
    return [write_file(d / f"f{i}.parquet", seed=i * 1000)
            for i in range(2)]


@pytest.fixture(autouse=True)
def profiling_off():
    """Each test starts with the profiler and tracing off in both
    packages and restores both switches (and the switch interval)
    after."""
    saved = [(s.profiler.profiler(), s.trace.tracer()) for s in SIDES]
    interval = sys.getswitchinterval()
    for side in SIDES:
        side.profiler.set_profiling(False)
        side.trace.set_tracing(False)
        side.live.reset_registry()
        side.attribution.reset_ledgers()
    yield
    for side, (p, tr) in zip(SIDES, saved):
        side.profiler.set_profiling(False)
        side.profiler._active = p
        side.trace.set_tracing(tr is not None)
        side.trace._ctx.set(None)
        side.live.reset_registry()
        side.attribution.reset_ledgers()
    sys.setswitchinterval(interval)


def random_state(rng, hz=100.0) -> dict:
    frames = [f"mod{i}.py:f{i}" for i in range(12)] + ["[io-wait x]"]
    buckets: dict = {}
    total = offc = 0
    for _ in range(int(rng.integers(1, 8))):
        label = ["", "scan", "job-2"][int(rng.integers(0, 3))]
        stage = STAGES[int(rng.integers(0, len(STAGES)))]
        b = buckets.setdefault(label, {}).setdefault(
            stage, {"samples": 0, "offcpu": 0, "stacks": {}})
        for _ in range(int(rng.integers(1, 6))):
            depth = int(rng.integers(1, 6))
            stack = ";".join(frames[int(i)]
                             for i in rng.integers(0, len(frames), depth))
            n = int(rng.integers(1, 50))
            b["stacks"][stack] = b["stacks"].get(stack, 0) + n
            b["samples"] += n
            total += n
            if stack.endswith("]"):
                b["offcpu"] += n
                offc += n
    return {"period_s": 1.0 / hz, "hz": hz,
            "counters": {"profile_samples": total,
                         "profile_samples_offcpu": offc,
                         "profile_drops": int(rng.integers(0, 3))},
            "buckets": buckets}


# ----------------------------------------------------------------------
# the state algebra and the exports
# ----------------------------------------------------------------------

@pytest.mark.parametrize("seed", range(4))
def test_state_algebra_as_reference(seed):
    rng = np.random.default_rng(seed)
    states = [random_state(rng, hz) for hz in (100.0, 50.0, 100.0)]
    merged = profiler.merge_profile_states(states + [{}, None])
    assert merged == jax_profiler.merge_profile_states(states + [{}, None])
    assert merged["counters"]["profile_samples"] == sum(
        s["counters"]["profile_samples"] for s in states)
    folded = []
    for side in SIDES:
        p = side.profiler.Profiler(100.0)
        for s in states:
            p.merge_state(s)
        br = p.brief()
        folded.append((p.to_state(), {k: br[k] for k in br
                                      if k != "rate_hz"}))
    assert folded[1] == folded[0]
    assert folded[1][0]["buckets"] == merged["buckets"]
    for kw in ({}, {"label": "scan"}, {"stage": "plan"},
               {"label": "job-2", "stage": "read", "n": 3}):
        assert profiler.top_frames(merged, **kw) == \
            jax_profiler.top_frames(merged, **kw)
    assert profiler.diff_states(states[0], states[1], n=40) == \
        jax_profiler.diff_states(states[0], states[1], n=40)
    stages_s = {st: float(rng.uniform(0, 2)) for st in STAGES}
    for slack in (1.25, 0.1):
        assert profiler.profile_consistency(merged, stages_s, slack) == \
            jax_profiler.profile_consistency(merged, stages_s, slack)
    assert profiler.profile_consistency({"period_s": 0}, stages_s) == []
    assert profiler.collapsed_lines(merged) == \
        jax_profiler.collapsed_lines(merged)
    assert profiler.profile_chrome_trace(merged) == \
        jax_profiler.profile_chrome_trace(merged)


@pytest.mark.parametrize("suffix", [".prof", ".collapsed", ".chrome.json",
                                    ".perfetto.json"])
def test_exports_as_reference(suffix, tmp_path):
    state = random_state(np.random.default_rng(9))
    bodies = []
    for side in SIDES:
        path = str(tmp_path / f"p{side is PORT}{suffix}")
        assert side.profiler.write_profile_file(state, path)
        with open(path, "rb") as f:
            bodies.append(f.read())
        if suffix == ".prof":
            doc = side.profiler.load_profile_file(path)
            assert doc["format"] == "tpq-profile"
            assert {k: doc[k] for k in state} == state
        else:
            with pytest.raises(ValueError, match="not"):
                side.profiler.load_profile_file(path)
    assert bodies[1] == bodies[0]


def test_export_now_and_final_flush(tmp_path, monkeypatch):
    path = str(tmp_path / "flush.prof")
    monkeypatch.setenv("TPQ_PROFILE_EXPORT", path)
    assert profiler.export_now() is None  # off
    profiler.final_flush()  # off: nothing
    p = profiler.set_profiling(True, start=False)
    p.merge_state(random_state(np.random.default_rng(1)))
    assert profiler.export_now() == path
    os.unlink(path)
    with live._flush_lock:
        t = threading.Thread(target=profiler.final_flush)
        t.start()
        t.join(timeout=0.2)
        # the flush waits for the lock the snapshot writer's flush holds
        assert t.is_alive() and not os.path.exists(path)
    t.join(timeout=10)
    assert not t.is_alive()
    assert profiler.load_profile_file(path)["counters"] == \
        p.to_state()["counters"]
    monkeypatch.delenv("TPQ_PROFILE_EXPORT")
    assert profiler.export_now() is None


def test_switches_as_reference(monkeypatch):
    for side in SIDES:
        P = side.profiler
        monkeypatch.setenv("TPQ_PROFILE_HZ", "5000")
        assert P.profile_hz_default() == 1000.0
        for bad in ("x", "-3", ""):
            monkeypatch.setenv("TPQ_PROFILE_HZ", bad)
            assert P.profile_hz_default() == 50.0
        monkeypatch.setenv("TPQ_PROFILE", "0")
        assert not P.profile_default()
        monkeypatch.setenv("TPQ_PROFILE", "1")
        assert P.profile_default()


def test_sampler_thread_arms_and_restores(monkeypatch):
    """The armed sampler shrinks the switch interval, samples the thread
    that waits for it, and stops with the interval restored."""
    before = sys.getswitchinterval()
    p = profiler.set_profiling(True, hz=500.0)
    try:
        assert sys.getswitchinterval() <= 0.0002 + 1e-9
        t0 = time.monotonic()
        while p.samples + p.drops == 0 and time.monotonic() - t0 < 10:
            time.sleep(0.01)
        assert p.samples + p.drops > 0
    finally:
        profiler.set_profiling(False)
    assert sys.getswitchinterval() == before
    assert not p._thread.is_alive()
    assert live.registry().snapshot()["counters"].get(
        "profile_samples", 0) == p.samples


def test_allgather_profiles_single_process():
    state = random_state(np.random.default_rng(3))
    assert port_dist.allgather_profiles(state) == \
        profiler.merge_profile_states([state])
    assert port_dist.allgather_profiles() == \
        profiler.merge_profile_states([{}])
    p = profiler.set_profiling(True, start=False)
    p.merge_state(state)
    assert port_dist.allgather_profiles() == \
        profiler.merge_profile_states([p.to_state()])


# ----------------------------------------------------------------------
# sample_once driven by hand
# ----------------------------------------------------------------------

def _names(stack: str) -> str:
    """A stack with each frame's file name dropped."""
    return ";".join(f.rsplit(":", 1)[-1] if not f.startswith("[") else f
                    for f in stack.split(";"))


def _probe_thread(side, hold, ready, how: str):
    """Park a thread inside the context ``how`` names, in ``side``'s
    tracer and profiler markers."""
    P, T = side.profiler, side.trace

    def body():
        root = T.start_trace("probe", units=1)
        if how == "span":
            h = T.open_span("plan", column="a")
            ready.set()
            hold.wait(10)
            T.close_span(h)
        elif how == "stage":
            tok = P.stage_begin("dispatch")
            ready.set()
            hold.wait(10)
            P.stage_end(tok)
        elif how == "io":
            tok = P.wait_begin("io", "io.reader.chunk_read")
            ready.set()
            hold.wait(10)
            P.wait_end(tok)
        elif how == "nested":
            outer = P.wait_begin("io", "outer")
            inner = P.wait_begin("io", "inner")
            P.wait_end(inner)
            ready.set()
            hold.wait(10)
            P.wait_end(outer)
        elif how == "adopted":
            h = T.open_span("unit", push=False, unit=0)
            with T.adopt(T.ctx_of(h)):
                ready.set()
                hold.wait(10)
            T.close_span(h)
        T.end_trace(root)

    return body


def _sample_probe(side, how: str, untraced: bool = False):
    """One hand-driven sample of a probe thread: its bucket (label,
    stage, counts, stacks by function name) and its recent entry."""
    P = side.profiler
    side.trace.set_tracing(not untraced)
    p = P.set_profiling(True, start=False)
    hold, ready = threading.Event(), threading.Event()
    t = threading.Thread(target=_probe_thread(side, hold, ready, how))
    t.start()
    try:
        assert ready.wait(10)
        assert p.sample_once() >= 1
    finally:
        hold.set()
        t.join(timeout=10)
    assert not t.is_alive()
    state = p.to_state()
    mine = {}
    for label, stages in state["buckets"].items():
        for stage, b in stages.items():
            stacks = {_names(s): n for s, n in b["stacks"].items()
                      if "body" in s}
            if stacks:
                mine[(label, stage)] = (sum(stacks.values()),
                                        b["offcpu"] if label else None,
                                        stacks)
    recent = [{k: r[k] for k in ("label", "stage", "offcpu")}
              for r in p.recent if r["label"] == "probe"]
    P.set_profiling(False)
    return mine, recent


@pytest.mark.parametrize("how", ["span", "stage", "io", "nested",
                                 "adopted"])
def test_sample_tagging_as_reference(how):
    got = [_sample_probe(side, how) for side in SIDES]
    assert got[1] == got[0]
    (label, stage), = got[1][0]
    want = {"span": "plan", "stage": "dispatch", "io": "read",
            "nested": "read", "adopted": "other"}[how]
    assert (label, stage) == ("probe", want)
    leaf = next(iter(got[1][0][(label, stage)][2])).split(";")[-1]
    if how in ("io", "nested"):
        assert leaf == ("[io-wait io.reader.chunk_read]" if how == "io"
                        else "[io-wait outer]")
        assert got[1][1] == [{"label": "probe", "stage": "read",
                              "offcpu": True}]
    else:
        assert not leaf.startswith("[")


def test_untraced_thread_lands_in_other():
    got = [_sample_probe(side, "stage", untraced=True) for side in SIDES]
    assert got[1] == got[0]
    assert list(got[1][0]) == [("", "dispatch")]


def test_marker_tokens_of_a_replaced_profiler():
    """A token taken under one profiler ends on that profiler's own
    state; a None token is a no-op; the off path returns None."""
    for side in SIDES:
        P = side.profiler
        assert P.stage_begin("plan") is None
        assert P.wait_begin("io", "x") is None
        P.stage_end(None)
        P.wait_end(None)
        P.ctx_push("t", 1, "plan")
        P.ctx_pop("t", 1)
        P.span_note("t", 1, "plan")
        old = P.set_profiling(True, start=False)
        tok = P.stage_begin("plan")
        P.set_profiling(True, start=False)
        P.stage_end(tok)
        assert old._stages[threading.get_ident()] == []


# ----------------------------------------------------------------------
# the markers on the read, scan, gather and write paths
# ----------------------------------------------------------------------

def _markers(side, monkeypatch, fn):
    """Run ``fn()`` with ``side``'s profiler armed (no sampler) and return
    the stage and wait markers it opened, counted."""
    P = side.profiler
    P.set_profiling(True, start=False)
    seen = {}
    lock = threading.Lock()
    stage_begin, wait_begin = P.stage_begin, P.wait_begin

    def sb(stage):
        with lock:
            seen[("stage", stage)] = seen.get(("stage", stage), 0) + 1
        return stage_begin(stage)

    def wb(kind, site):
        with lock:
            seen[(kind, site)] = seen.get((kind, site), 0) + 1
        return wait_begin(kind, site)

    with monkeypatch.context() as m:
        m.setattr(P, "stage_begin", sb)
        m.setattr(P, "wait_begin", wb)
        fn()
    P.set_profiling(False)
    return seen


@pytest.mark.parametrize("threads", [1, 4])
def test_read_markers_as_reference(corpus, threads, monkeypatch):
    monkeypatch.setenv("TPQ_PLAN_THREADS", str(threads))
    got = [_markers(side, monkeypatch, lambda side=side: list(
        side.device.read_row_groups_device(side.reader(corpus[0]),
                                           **side.read_kw)))
           for side in SIDES]
    assert got[1] == got[0]
    assert got[1] == {("stage", "transfer"): 4, ("stage", "dispatch"): 4,
                      ("io", "io.reader.chunk_read"): 12}


def test_scan_and_gather_markers_as_reference(corpus, monkeypatch):
    def run(side):
        scan = side.scan.ShardedScan(corpus, **side.scan_kw)
        results = scan.run()
        scan.gather_column(results, "a")
        scan.gather_column(results, "b", gather_to="cpu"
                           if side is PORT else jax_device_0())

    got = [_markers(side, monkeypatch, lambda side=side: run(side))
           for side in SIDES]
    assert got[1] == got[0]
    assert got[1][("stage", "gather")] == 2


def jax_device_0():
    import jax

    return jax.local_devices()[0]


def test_filtered_scan_markers_as_reference(corpus, monkeypatch):
    def run(side):
        f = side.filter.col("a") < 30
        side.scan.ShardedScan(corpus, filter=f, **side.scan_kw).run()

    got = [_markers(side, monkeypatch, lambda side=side: run(side))
           for side in SIDES]
    assert got[1] == got[0]
    assert got[1][("stage", "transfer")] >= 1


def test_write_markers(monkeypatch, tmp_path):
    """Each chunk the writer writes is one ``write`` stage."""
    got = _markers(PORT, monkeypatch, lambda: write_file(
        tmp_path / "w.parquet"))
    assert got == {("stage", "write"): 12}


def test_hung_read_samples_as_io_wait(corpus, monkeypatch):
    """A read hung by the ``io.chunk.hang`` fault samples off-CPU under
    ``[io-wait io.reader.chunk_read]`` and the ``read`` stage, in both
    packages (one plan worker: no other chunk read is in flight)."""
    monkeypatch.setenv("TPQ_PLAN_THREADS", "1")
    got = []
    for side in SIDES:
        p = side.profiler.set_profiling(True, start=False)
        err = []

        def run(side=side):
            try:
                with side.faults.inject_faults() as inj:
                    inj.inject("io.chunk.hang", "hang", times=1,
                               seconds=0.3)
                    side.device.read_row_group_device(
                        side.reader(corpus[0]), 0, **side.read_kw)
            except BaseException as e:  # reported below
                err.append(e)

        t = threading.Thread(target=run)
        t.start()
        t0 = time.monotonic()
        while not p._waits and time.monotonic() - t0 < 10:
            time.sleep(0.001)
        p.sample_once()
        t.join(timeout=30)
        assert not t.is_alive() and not err
        waits = {st: b["offcpu"] for lb, sts in p.to_state()[
            "buckets"].items() for st, b in sts.items() if b["offcpu"]}
        leaves = {r["leaf"] for r in p.recent if r["offcpu"]}
        side.profiler.set_profiling(False)
        got.append((waits, leaves))
    assert got[1] == got[0] == ({"read": 1},
                                {"[io-wait io.reader.chunk_read]"})


# ----------------------------------------------------------------------
# the scan's profile surfaces
# ----------------------------------------------------------------------

def test_scan_exports_profile_and_brief(corpus, tmp_path, monkeypatch):
    """An armed profiler: the scan's progress frames carry its brief,
    the run's end exports its state (``TPQ_PROFILE_EXPORT``, suffixed
    with the label's slug), and the profile's counters reach the
    registry; the reference exports the same files."""
    base = str(tmp_path / "scan.prof")
    monkeypatch.setenv("TPQ_PROFILE_EXPORT", base)
    names = []
    for side in SIDES:
        p = side.profiler.set_profiling(True, start=False)
        p.merge_state(random_state(np.random.default_rng(5)))
        path = str(tmp_path / f"progress{side is PORT}.json")
        scan = side.scan.ShardedScan(corpus, progress_export=path,
                                     progress_label="job 1",
                                     **side.scan_kw)
        scan.run()
        assert scan.progress.profile["samples"] == p.samples
        doc = side.profiler.load_profile_file(base + ".job_1")
        assert doc["counters"] == p.to_state()["counters"]
        names.append(sorted(os.listdir(tmp_path)))
        os.unlink(base + ".job_1")
        side.profiler.set_profiling(False)
    assert [n for n in names[1] if "prof" in n] == \
        [n for n in names[0] if "prof" in n] == ["scan.prof.job_1"]


def test_profiler_off_is_never_called(corpus, monkeypatch):
    """With the profiler off, a traced read and scan call none of its
    hooks: the guarded sites skip the calls."""
    def boom(*a, **k):
        raise AssertionError("profiler hook called while off")

    for name in ("ctx_push", "ctx_pop", "span_note", "stage_begin",
                 "wait_begin"):
        monkeypatch.setattr(profiler, name, boom)
    trace.set_tracing(True)
    list(port_device.read_row_groups_device(FileReader(corpus[0]),
                                            device="cpu"))
    port_scan.ShardedScan(corpus, **PORT.scan_kw).run()


# ----------------------------------------------------------------------
# lock-wait samples through the lock-order recorder's wrappers
# ----------------------------------------------------------------------

def _repo_lock(side):
    """A lock created at a site of ``side``'s package, wrapped by its
    recorder: the reference's at a synthetic site (its own test's form),
    the port's at a real one, the reader's handle lock."""
    if side is JAX:
        from tpuparquet import lockcheck as jax_lockcheck

        site = "tpuparquet/io/reader.py:67"
        return jax_lockcheck._CheckedLock(threading.Lock(), site), site
    import io as _io

    from tpuparquet_torch import lockcheck
    from tpuparquet_torch.io.reader import _IoHandle

    lockcheck.install(strict=False)
    try:
        lk = _IoHandle(_io.BytesIO(), False).lock
    finally:
        lockcheck.uninstall()
        lockcheck.reset()
    assert isinstance(lk, lockcheck._CheckedLock)
    return lk, lk._site


@pytest.mark.parametrize("side", SIDES, ids=["jax", "port"])
def test_contended_lock_samples_as_lock_wait(side):
    """Arming installs the wait hooks into the recorder's wrappers: a
    contended acquire brackets the blocking wait, so samples taken while
    a thread queues on the lock land on the lock's creation site."""
    lk, site = _repo_lock(side)
    if side is PORT:
        assert site.startswith("tpuparquet_torch/io/reader.py:")
    p = side.profiler.set_profiling(True, hz=50, start=False)
    held = threading.Event()
    release = threading.Event()

    def holder():
        lk.acquire()
        held.set()
        release.wait(5)
        lk.release()

    def contender():
        lk.acquire()
        lk.release()

    t1 = threading.Thread(target=holder)
    t1.start()
    assert held.wait(2)
    t2 = threading.Thread(target=contender)
    t2.start()
    leaf = f"[lock-wait {site}]"
    found = False
    try:
        deadline = time.monotonic() + 5.0
        while time.monotonic() < deadline and not found:
            p.sample_once()
            for stages in p.to_state()["buckets"].values():
                for b in stages.values():
                    if any(s.endswith(leaf) for s in b["stacks"]):
                        found = True
            if not found:
                time.sleep(0.005)
    finally:
        release.set()
        t2.join(5)
        t1.join(5)
    assert found, "no off-CPU sample landed on the lock site"
    assert p.to_state()["counters"]["profile_samples_offcpu"] >= 1


@pytest.mark.parametrize("side", SIDES, ids=["jax", "port"])
def test_uncontended_acquire_never_marks_offcpu(side):
    lk, _site = _repo_lock(side)
    p = side.profiler.set_profiling(True, hz=50, start=False)
    lk.acquire()
    lk.release()
    assert p._waits == {}


def test_arming_installs_and_disarming_clears_wait_hooks():
    from tpuparquet_torch import lockcheck

    profiler.set_profiling(True, start=False)
    assert lockcheck._wait_hooks == (profiler.wait_begin, profiler.wait_end)
    profiler.set_profiling(False)
    assert lockcheck._wait_hooks is None
