"""Scan progress, attribution ledgers and the arena's occupancy gauge
(ROADMAP A.11 part 2): tpuparquet_torch against the JAX package.

The same inputs, made from numpy seeds, go through both packages'
``kernels/arena.py`` gauge, ``obs/attribution.py`` (the counter views,
ledgers and their state algebra, and the span walk: ``span_tree``,
``exclusive_times``, ``unit_reports``, ``diagnose``,
``format_diagnosis``) and ``obs/progress.py`` (frames driven by hand).
Then the same small files are scanned by both packages' ``ShardedScan``
and ``MultiHostScan`` with a progress file: the final frames and the
ledgers agree, times excluded.  Tolerance: exact for every count, byte,
frame field and report.
"""

import gc
import json
import os
from concurrent.futures import ThreadPoolExecutor
from concurrent.futures import wait as futures_wait
from types import SimpleNamespace

import numpy as np
import pytest

import tpuparquet.kernels.arena as jax_arena
import tpuparquet.kernels.device as jax_device
import tpuparquet.shard.distributed as jax_dist
import tpuparquet.shard.scan as jax_scan
from tpuparquet.obs import attribution as jax_attribution
from tpuparquet.obs import live as jax_live
from tpuparquet.obs import progress as jax_progress
from tpuparquet.obs import trace as jax_trace
from tpuparquet_torch.cpu.plain import ByteArrayColumn
from tpuparquet_torch.format.metadata import CompressionCodec
from tpuparquet_torch.io.writer import FileWriter
from tpuparquet_torch.kernels import arena as port_arena
from tpuparquet_torch.kernels import device as port_device
from tpuparquet_torch.obs import attribution, live, progress, trace
from tpuparquet_torch.shard import distributed as port_dist
from tpuparquet_torch.shard import make_mesh
from tpuparquet_torch.shard import scan as port_scan
from tpuparquet_torch.stats import _MERGE_FIELDS, collect_stats


JAX = SimpleNamespace(arena=jax_arena, attribution=jax_attribution,
                      progress=jax_progress, live=jax_live, trace=jax_trace,
                      scan=jax_scan, dist=jax_dist, kw={})
PORT = SimpleNamespace(arena=port_arena, attribution=attribution,
                       progress=progress, live=live, trace=trace,
                       scan=port_scan, dist=port_dist,
                       kw={"mesh": make_mesh(8, devices=["cpu"] * 8)})
SIDES = (JAX, PORT)

SCHEMA = ("message test { required int64 a; required double b; "
          "optional binary s (STRING); }")
# frame fields that carry times, rates or the process
TIME_FRAME = {"ts", "pid", "elapsed_s", "rows_per_s", "ewma_unit_s",
              "eta_s", "stragglers"}
TIME_COUNTERS = {"plan_s", "transfer_s", "dispatch_s", "read_s",
                 "gather_reshard_s", "wall_s"}
# the counters both packages count (the port's collector has fewer)
COUNTERS = set(_MERGE_FIELDS) - TIME_COUNTERS


def write_file(path, rows=200, rg_rows=50, seed=0):
    """4 row groups of ``required int64 a; required double b; optional
    binary s (STRING)`` (every third ``s`` null)."""
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
    d = tmp_path_factory.mktemp("progress")
    return [write_file(d / f"f{i}.parquet", seed=i * 1000)
            for i in range(2)]


@pytest.fixture(autouse=True)
def fresh_telemetry():
    """Each test: fresh registries and ledgers, tracing off, in both
    packages; the same after."""
    for side in SIDES:
        side.live.reset_registry()
        side.attribution.reset_ledgers()
        side.trace.set_tracing(False)
    yield
    for side in SIDES:
        side.trace._init_from_env()
        side.live.reset_registry()
        side.attribution.reset_ledgers()


def ledger_view(states: dict) -> dict:
    """Ledger states without the time counters and the arena peak (the
    packages' slabs differ)."""
    return {label: {"scans": d["scans"],
                    "counters": {k: v for k, v in d["counters"].items()
                                 if k in COUNTERS and v}}
            for label, d in states.items()}


def frame_view(frame: dict) -> dict:
    out = {k: v for k, v in frame.items() if k not in TIME_FRAME}
    att = out.get("attribution")
    if att is not None:
        out["attribution"] = {"bytes": att["bytes"],
                              "cpu_s": sorted(att["cpu_s"])}
    return out


# ----------------------------------------------------------------------
# the arena's occupancy gauge
# ----------------------------------------------------------------------

@pytest.mark.parametrize("seed", [0, 1, 2])
def test_arena_gauge_as_reference(seed):
    """Random borrows and releases over three arenas (one dropped without
    a release): the occupancy and the windowed peaks move as the
    reference's."""
    rng = np.random.default_rng(seed)
    plan = [(int(rng.integers(0, 3)), int(rng.integers(1, 200_000)),
             bool(rng.random() < 0.2)) for _ in range(40)]
    seen = []
    for side in SIDES:
        a = side.arena
        # the gauge and the pool are process-wide: an arena an earlier
        # test left in a reference cycle is collected now, not by a gc
        # pass in the middle of the trail (gc stays off until it ends;
        # the dropped arena below is freed by its reference count), and
        # the pool's free arenas, whose recycled slabs an earlier test
        # sized, are dropped, so both sides lease fresh arenas
        gc.collect()
        a.trim_arena_pool()
        gc.disable()
        try:
            a.take_arena_peak()
            base = a.arena_occupancy()
            arenas = [a.lease_arena(), a.lease_arena(), a.HostArena()]
            trail = []
            for which, n, release in plan:
                if release:
                    if which == 2:
                        arenas[2].release_all()
                    else:
                        a.return_arena(arenas[which])
                        arenas[which] = a.lease_arena()
                else:
                    assert arenas[which].borrow(n).size == n
                trail.append(a.arena_occupancy() - base)
                if len(trail) % 7 == 0:
                    trail.append(("peak", a.take_arena_peak() - base))
            arenas[2] = None  # collected with its borrows outstanding
            for x in arenas[:2]:
                a.return_arena(x)
            trail.append(a.arena_occupancy() - base)
        finally:
            gc.enable()
        seen.append(trail)
    assert seen[1] == seen[0]
    assert seen[1][-1] == 0


# ----------------------------------------------------------------------
# attribution: counter views, ledgers, state algebra
# ----------------------------------------------------------------------

def _counters(rng) -> dict:
    keys = ["read_s", "plan_s", "transfer_s", "dispatch_s",
            "gather_reshard_s", "bytes_read", "bytes_staged",
            "gather_bytes_moved", "pages", "values", "row_groups",
            "units_quarantined", "deadline_exceeded", "hedges_issued",
            "hedges_won", "remote_ranges_fetched", "cache_hits_mem",
            "cache_hits_disk", "cache_misses_disk", "remote_retry"]
    out = {}
    for k in keys:
        if rng.random() < 0.7:
            out[k] = (round(float(rng.random() * 3), 6) if k.endswith("_s")
                      else int(rng.integers(0, 1000)))
    return out


@pytest.mark.parametrize("seed", range(6))
def test_counter_views_as_reference(seed):
    rng = np.random.default_rng(seed)
    c = _counters(rng)
    for verdict in (None, "read-bound", "plan-bound"):
        assert attribution.remote_report(c, verdict) == \
            jax_attribution.remote_report(c, verdict)
    assert attribution.stage_seconds(c) == jax_attribution.stage_seconds(c)
    assert attribution.stage_verdict(c) == jax_attribution.stage_verdict(c)
    assert attribution.stage_verdict({}) is None
    assert attribution.STAGE_OF == jax_attribution.STAGE_OF
    assert attribution.VERDICT_OF == jax_attribution.VERDICT_OF


@pytest.mark.parametrize("seed", range(3))
def test_ledgers_as_reference(seed):
    """Folds, peaks and scans on labelled ledgers, then the snapshot, the
    wire state and the fleet merge of three states."""
    rng = np.random.default_rng(seed)
    ops = [(f"l{int(rng.integers(0, 3))}", _counters(rng),
            int(rng.integers(0, 1 << 20))) for _ in range(12)]
    out = []
    for side in SIDES:
        at = side.attribution
        for label, delta, peak in ops:
            led = at.ledger(label)
            led.fold_delta({k: v for k, v in delta.items()
                            if not k.endswith("_s")})
            led.note_peak(peak)
            led.scans += 1
        state = at.ledgers_state()
        merged = at.merge_ledger_states([state, state, {}])
        out.append((at.ledgers_snapshot(), state,
                    {k: v.as_dict() for k, v in merged.items()},
                    at.ScanLedger.from_state(state["l0"]).to_state()
                    if "l0" in state else None))
    assert out[1] == out[0]
    snap, state, merged, _ = out[1]
    for label in snap:
        assert merged[label]["scans"] == 2 * snap[label]["scans"]
        assert merged[label]["peak_arena_bytes"] == \
            snap[label]["peak_arena_bytes"]


def random_spans(rng, n_units: int) -> list:
    """A scan trace: a root, units with plan/read/transfer/dispatch
    children at random offsets and lengths (some cancelled or errors), a
    few spans whose parent is missing, and gathers after the root."""
    spans = [{"trace": "t", "span": 1, "parent": None, "name": "scan",
              "t0": 0.0, "dur": 0.0, "status": "ok", "label": "scan",
              "usable_cpus": 4, "tid": 1}]
    sid = 2
    t = 0.01
    for u in range(n_units):
        udur = float(rng.uniform(0.01, 0.2)) * (6 if u == 3 else 1)
        unit = {"trace": "t", "span": sid, "parent": 1, "name": "unit",
                "t0": t, "dur": udur, "status": "ok", "unit": u,
                "file": u % 2, "row_group": u // 2, "tid": 1}
        spans.append(unit)
        usid = sid
        sid += 1
        for name in ("plan", "read", "decompress", "transfer", "dispatch",
                     "retry", "mystery"):
            if rng.random() < 0.3 and name not in ("plan", "transfer"):
                continue
            a = t + float(rng.uniform(0, udur))
            spans.append({
                "trace": "t", "span": sid, "parent": usid, "name": name,
                "t0": a, "dur": float(rng.uniform(0, udur)),
                "status": ("cancelled" if rng.random() < 0.1 else "ok"),
                "column": f"c{int(rng.integers(0, 3))}",
                "tid": int(rng.integers(1, 6))})
            sid += 1
        t += udur + float(rng.uniform(0, 0.01))
    spans[0]["dur"] = t
    spans.append({"trace": "t", "span": sid, "parent": 999, "name": "read",
                  "t0": 0.02, "dur": 0.001, "status": "ok", "tid": 2})
    spans.append({"trace": "t", "span": sid + 1, "parent": 1,
                  "name": "gather", "t0": t + 0.01, "dur": 0.05,
                  "status": "ok", "tid": 1})
    return spans


@pytest.mark.parametrize("seed,n_units", [(0, 2), (1, 6), (2, 12), (3, 30)])
def test_span_walk_as_reference(seed, n_units):
    spans = random_spans(np.random.default_rng(seed), n_units)
    assert attribution.span_tree(spans) == jax_attribution.span_tree(spans)
    assert attribution.exclusive_times(spans) == \
        jax_attribution.exclusive_times(spans)
    assert attribution.unit_reports(spans) == \
        jax_attribution.unit_reports(spans)
    p95s = {"unit": 0.1}
    d = attribution.diagnose(spans, p95s)
    assert d == jax_attribution.diagnose(spans, p95s)
    assert len(d["unit_rows"]) == n_units
    leds = {"scan": {"cpu_s": {"plan": 1.5, "read": 0.25},
                     "bytes": {"read": 10, "staged": 20, "moved": 30},
                     "pages": 7, "peak_arena_bytes": 4096,
                     "counters": {"remote_ranges_fetched": 3,
                                  "remote_bytes": 300}}}
    assert attribution.format_diagnosis(d, leds) == \
        jax_attribution.format_diagnosis(d, leds)


def test_diagnose_of_a_traced_scan_as_reference(corpus):
    """The JAX package's spans of a real traced scan, walked by both."""
    jax_trace.set_tracing(True)
    try:
        jax_scan.ShardedScan(corpus).run()
        spans = jax_trace.snapshot_spans()
    finally:
        jax_trace.set_tracing(False)
    d = attribution.diagnose(spans)
    assert d == jax_attribution.diagnose(spans)
    assert d["units"] == 8
    assert attribution.format_diagnosis(d) == \
        jax_attribution.format_diagnosis(d)
    assert attribution.diagnose([]) == jax_attribution.diagnose([])


# ----------------------------------------------------------------------
# progress frames driven by hand
# ----------------------------------------------------------------------

def test_label_slug_and_export_default(monkeypatch):
    for label in ("scan", "scan.p0", "a b/c", "", "tenant-7:x"):
        assert progress.label_slug(label) == jax_progress.label_slug(label)
    monkeypatch.delenv("TPQ_PROGRESS_EXPORT", raising=False)
    assert progress.progress_export_default() is None
    monkeypatch.setenv("TPQ_PROGRESS_EXPORT", "/x/p.json")
    assert progress.progress_export_default() == \
        jax_progress.progress_export_default() == "/x/p.json"


@pytest.mark.parametrize("seed", [0, 1])
def test_progress_frames_as_reference(seed, tmp_path):
    """The same ticks on both packages' ScanProgress: every exported and
    in-process frame agrees but its times, and the registry's gauges
    agree but the rate."""
    rng = np.random.default_rng(seed)
    n = 12
    ticks = []
    for u in range(n):
        ticks.append(("start", u))
        if rng.random() < 0.1:
            ticks.append(("cancel", u))
            continue
        ticks.append(("done", u, int(rng.integers(0, 500)),
                      bool(rng.random() < 0.2), int(rng.integers(0, 10**6))))
        if u == 5:
            ticks.append(("attr", {"cpu_s": {"plan": 0.5},
                                   "bytes": {"read": 3}}))
            ticks.append(("profile", {"samples": 4}))
        if u == 8:
            ticks.append(("restart", 4))
    frames = []
    for side in SIDES:
        path = str(tmp_path / f"{side is PORT}.json")
        p = side.progress.ScanProgress(n, label="scan.p1", export=path,
                                       min_export_interval=0.0)
        seen = [frame_view(p.snapshot())]
        p.begin()
        for t in ticks:
            if t[0] == "start":
                p.unit_started(t[1])
            elif t[0] == "cancel":
                p.unit_cancelled(t[1])
            elif t[0] == "done":
                p.unit_done(t[1], rows=t[2], quarantined=t[3],
                            bytes_staged=t[4])
            elif t[0] == "attr":
                p.set_attribution(t[1])
            elif t[0] == "profile":
                p.set_profile(t[1])
            else:
                p.restart(done=t[1])
                p.begin()
            seen.append(frame_view(
                side.progress.read_progress_file(path)))
        p.finish("done")
        seen.append(frame_view(side.progress.read_progress_file(path)))
        gauges = dict(side.live.registry().snapshot()["gauges"])
        gauges.pop("scan_p1_rows_per_s", None)
        frames.append((seen, gauges))
    assert frames[1] == frames[0]
    assert frames[1][0][-1]["state"] == "done"
    assert frames[1][1]["scan_p1_units_total"] == n


def test_read_progress_file_rejects_as_reference(tmp_path):
    bad = tmp_path / "bad.json"
    for body in ("{not json", json.dumps({"format": "other"})):
        bad.write_text(body)
        msgs = []
        for side in SIDES:
            with pytest.raises(ValueError) as e:
                side.progress.read_progress_file(str(bad))
            msgs.append(str(e.value))
        assert msgs[1] == msgs[0]


# ----------------------------------------------------------------------
# scans with a progress file: frames and ledgers against the reference
# ----------------------------------------------------------------------

def _scan_both(tmp_path, corpus, make, **kw):
    """Run ``make(side, export_path)``'s scan to its end in each
    package: ``[(final frame, ledger states, registry counters,
    collector or None)]``."""
    out = []
    for side in SIDES:
        path = str(tmp_path / f"{side is PORT}.progress.json")
        scan = make(side, path)
        results = [o for _, o in scan.run_iter()]
        assert len(results) == len(scan.units if hasattr(scan, "units")
                                   else scan.local_units)
        frame = side.progress.read_progress_file(path)
        out.append((frame, side.attribution.ledgers_state(),
                    side.live.registry().snapshot()["counters"], scan))
    return out


def test_sharded_scan_frames_and_ledgers_as_reference(corpus, tmp_path):
    got = _scan_both(tmp_path, corpus, lambda side, path:
                     side.scan.ShardedScan(corpus, progress_export=path,
                                           progress_label="job-1",
                                           **side.kw))
    (jf, jl, jc, _), (pf, pl, pc, scan) = got
    assert frame_view(pf) == frame_view(jf)
    assert pf["state"] == "done" and pf["units_done"] == 8
    assert pf["rows_done"] == 400
    assert ledger_view(pl) == ledger_view(jl)
    # conservation: the ledgers sum to the registry's totals, exactly
    led = pl["job-1"]["counters"]
    assert {k: v for k, v in pc.items() if k in COUNTERS} == \
        {k: v for k, v in led.items() if k in COUNTERS}
    # the frame's attribution is the ledger's bytes
    assert pf["attribution"]["bytes"] == {
        "read": led["bytes_read"], "staged": led["bytes_staged"],
        "moved": led.get("gather_bytes_moved", 0)}
    assert pl["job-1"]["peak_arena_bytes"] > 0
    assert scan.progress.label == "job-1"


def test_scan_under_a_user_collector_as_reference(corpus, tmp_path):
    """A caller's collector meters the units: the ledger follows it, and
    the frame's bytes_staged is the collector's."""
    out = []
    for side in SIDES:
        path = str(tmp_path / f"{side is PORT}.json")
        cs = (collect_stats if side is PORT
              else __import__("tpuparquet.stats",
                              fromlist=["x"]).collect_stats)
        with cs() as st:
            scan = side.scan.ShardedScan(corpus, progress_export=path,
                                         **side.kw)
            scan.run()
        frame = side.progress.read_progress_file(path)
        assert frame["bytes_staged"] == st.bytes_staged > 0
        assert side.attribution.ledgers_state()["scan"]["counters"][
            "bytes_staged"] == st.bytes_staged
        out.append((frame_view(frame),
                    ledger_view(side.attribution.ledgers_state())))
    assert out[1] == out[0]


def test_env_export_suffixed_by_label(corpus, tmp_path, monkeypatch):
    base = str(tmp_path / "status.json")
    monkeypatch.setenv("TPQ_PROGRESS_EXPORT", base)
    names = []
    for side in SIDES:
        side.scan.ShardedScan(corpus, progress_label="t a", **side.kw).run()
        side.scan.ShardedScan(corpus, **side.kw).run()
        names.append(sorted(os.listdir(tmp_path)))
        for f in tmp_path.iterdir():
            f.unlink()
    assert names[1] == names[0] == ["status.json", "status.json.t_a"]


def test_multihost_scan_progress_as_reference(corpus, tmp_path):
    got = _scan_both(tmp_path, corpus, lambda side, path:
                     side.dist.MultiHostScan(corpus, progress_export=path,
                                             **side.kw))
    (jf, jl, _, _), (pf, pl, _, _) = got
    assert frame_view(pf) == frame_view(jf)
    assert pf["label"] == "scan.p0" and pf["units_done"] == 8
    assert ledger_view(pl) == ledger_view(jl)


def test_restarted_run_frames_as_reference(corpus, tmp_path):
    """A stopped run_iter continued by run(): the progress restarts and
    ends done, the ledger counts two scans."""
    out = []
    for side in SIDES:
        path = str(tmp_path / f"{side is PORT}.json")
        scan = side.scan.ShardedScan(corpus, progress_export=path,
                                     **side.kw)
        it = scan.run_iter()
        next(it)
        it.close()
        mid = frame_view(side.progress.read_progress_file(path))
        scan.run()
        out.append((mid, frame_view(side.progress.read_progress_file(path)),
                    ledger_view(side.attribution.ledgers_state())))
    assert out[1] == out[0]
    assert out[1][0]["state"] == "stopped"
    assert out[1][1]["state"] == "done"
    assert out[1][2]["scan"]["scans"] == 2


@pytest.mark.parametrize("threads", [1])
def test_ledger_arena_peak_as_reference(corpus, threads, monkeypatch):
    """At one plan worker the arenas' borrows come in one order, and the
    ledger's peak arena occupancy equals the reference's.

    The order is pinned: a unit is finished (and its arenas returned)
    only once every plan task submitted so far has run, so the unit
    planned ahead always holds its slabs beside the unit in hand.  Left
    to the threads, whether the worker borrows the next unit's slabs
    before the calling thread returns this unit's is a race, which the
    port's quick CPU finish loses or wins by turns."""
    monkeypatch.setenv("TPQ_PLAN_THREADS", str(threads))
    plans = []
    submit = ThreadPoolExecutor.submit

    def tracked_submit(self, fn, *args, **kwargs):
        fut = submit(self, fn, *args, **kwargs)
        if getattr(fn, "__name__", "") == "_plan_column_task":
            plans.append(fut)
        return fut

    monkeypatch.setattr(ThreadPoolExecutor, "submit", tracked_submit)
    for mod in (jax_device, port_device):
        def finish(*args, _finish=mod._finish_row_group):
            futures_wait(list(plans))
            return _finish(*args)
        monkeypatch.setattr(mod, "_finish_row_group", finish)
    peaks = []
    for side in SIDES:
        # the gauge and the pool are process-wide: both sides lease fresh
        # arenas (the pool's free ones carry recycled slabs an earlier
        # test in this process sized), the peak window is closed before
        # the scan (else its first take reports an earlier test's peak),
        # and the peak is read above the borrows that live arenas still
        # hold (gc stays off during the scan, so none is collected in it)
        gc.collect()
        side.arena.trim_arena_pool()
        gc.disable()
        try:
            side.arena.take_arena_peak()
            base = side.arena.arena_occupancy()
            side.scan.ShardedScan(corpus, **side.kw).run()
        finally:
            gc.enable()
        peaks.append(side.attribution.ledgers_state()["scan"][
            "peak_arena_bytes"] - base)
    assert plans
    assert peaks[1] == peaks[0] > 0
