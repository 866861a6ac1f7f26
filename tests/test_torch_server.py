"""The scan server (``tpuparquet_torch/serve/server.py``) and its prefetch
planner (``serve/prefetch.py``) against the JAX package's.

Twins of ``tests/test_serve.py``'s ``TestScanServer``,
``TestServeRequeue`` and ``TestDrainResumeSweep``: the port's server, on
a mesh of CPU slots, gives every job's units bit for bit as the JAX
package's ``ShardedScan`` gives them, and its ``status()`` document is
the JAX server's for the same jobs (the state directory and the job
walls aside); draining refuses admissions with the same words; a greedy
tenant does not starve a meek one; a full queue sheds load; the serve
command requeues a shed job; and a child process server, stopped by
SIGTERM and then killed by SIGKILL, resumes on a successor to an exact
union of keyed outputs with no duplicate.  Without CUDA a server with no
mesh fails its jobs and decodes nothing on the CPU.

The prefetch planner's depth equals the reference's on the same digest
and burn states over seeded sweeps; the planner warms the disk tier
ahead of the cursor; and a job's remote and disk counters under
``emu://`` equal the JAX server's with the planner on and off.  The plan
cache a server arms, and the arena retention it raises, are restored on
shutdown.  Every comparison is exact.
"""

from __future__ import annotations

import argparse
import io
import json
import os
import signal
import subprocess
import sys
import time

import numpy as np
import pytest
import torch

from tpuparquet.io.rangecache import reset_range_caches as \
    jax_reset_range_caches
from tpuparquet.obs import digest as jax_digest
from tpuparquet.serve import ResourceArbiter as JaxArbiter
from tpuparquet.serve import ScanServer as JaxScanServer
from tpuparquet.serve import arbiter as jax_arbiter
from tpuparquet.serve import prefetch as jax_prefetch
from tpuparquet.shard import ShardedScan as JaxShardedScan
from tpuparquet_torch import FileWriter
from tpuparquet_torch.errors import AdmissionRejected
from tpuparquet_torch.io.rangecache import disk_cache, reset_range_caches
from tpuparquet_torch.io.reader import FileReader
from tpuparquet_torch.kernels import arena as port_arena
from tpuparquet_torch.kernels import plancache as port_plancache
from tpuparquet_torch.obs import digest as port_digest
from tpuparquet_torch.serve import ResourceArbiter, ScanServer
from tpuparquet_torch.serve import arbiter as port_arbiter
from tpuparquet_torch.serve import prefetch as port_prefetch
from tpuparquet_torch.shard import make_mesh
from tpuparquet_torch.stats import collect_stats

from test_torch_remote import same_units  # noqa: E402
from test_torch_remote import write_file as write_remote_file  # noqa: E402

N_RG = 3
N = 120
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TIMEOUT_S = 120


@pytest.fixture(autouse=True)
def _clean(monkeypatch):
    """No arbiter, plan-cache override, tier singleton or cache knob
    leaks between tests."""
    for k in list(os.environ):
        if k.startswith(("TPQ_CACHE_", "TPQ_EMU_", "TPQ_PREFETCH_",
                         "TPQ_SERVE_")) or k == "TPQ_PLAN_CACHE_MB":
            monkeypatch.delenv(k)
    reset_range_caches()
    jax_reset_range_caches()
    yield
    for arb in (port_arbiter, jax_arbiter):
        a = arb.active()
        if a is not None:
            arb.deactivate(a)
    port_plancache.set_plan_cache_budget(None)
    reset_range_caches()
    jax_reset_range_caches()


def cpu_mesh():
    return make_mesh(2, devices=["cpu"] * 2)


def write_file(path, n_rg: int = N_RG, base: int = 0) -> str:
    """The reference's server file: ``n_rg`` row groups of ``N`` int64."""
    buf = io.BytesIO()
    w = FileWriter(buf, "message m { required int64 a; }")
    for rg in range(n_rg):
        lo = base + rg * N
        w.write_columns({"a": np.arange(lo, lo + N, dtype=np.int64)})
    w.close()
    with open(path, "wb") as f:
        f.write(buf.getvalue())
    return str(path)


def oracle_units(paths) -> dict:
    """The JAX package's ``ShardedScan`` units of ``paths``."""
    return dict(JaxShardedScan(list(paths)).run_iter())


def same_outputs(ours: dict, paths, where=""):
    theirs = oracle_units(paths)
    assert sorted(ours) == sorted(theirs), where
    for k in theirs:
        same_units(ours[k], theirs[k], f"{where} unit {k}")


def normalized(doc: dict) -> dict:
    """A status document without what differs between two runs of the
    same jobs: the state directory, the job walls and the finished
    jobs' order."""
    doc = json.loads(json.dumps(doc))
    doc["state_dir"] = doc["state_dir"] is not None
    for row in doc["tenants"].values():
        row["est_job_s"] = row["est_job_s"] is not None
    doc["finished"] = sorted(doc["finished"],
                             key=lambda j: (j["tenant"], j["job_id"]))
    return doc


def run_pair(srv, paths: dict) -> dict:
    jobs = {}
    for lb, p in paths.items():
        srv.add_tenant(lb)
        jobs[lb] = srv.submit(lb, [p], job_id=f"job-{lb}")
    for lb, job in jobs.items():
        assert job.wait(TIMEOUT_S), f"{lb} never finished"
        assert job.state == "done", job.as_dict()
    assert srv.wait_idle(TIMEOUT_S)
    return jobs


class TestScanServer:
    def test_server_outputs_and_status_as_reference(self, tmp_path):
        paths = {f"tenant_{i}": write_file(tmp_path / f"t{i}.parquet",
                                           base=i * 1_000_000)
                 for i in range(2)}
        docs = []
        with JaxScanServer(arbiter=JaxArbiter(total_workers=2),
                           state_dir=str(tmp_path / "jax"),
                           rebalance_interval=1000.0) as srv:
            run_pair(srv, paths)
            docs.append(srv.status())
        with ScanServer(arbiter=ResourceArbiter(total_workers=2),
                        state_dir=str(tmp_path / "port"),
                        rebalance_interval=1000.0, mesh=cpu_mesh()) as srv:
            jobs = run_pair(srv, paths)
            docs.append(srv.status())
        for lb, p in paths.items():
            same_outputs(jobs[lb].outputs, [p], lb)
            assert jobs[lb].units_done == N_RG
            assert jobs[lb].units_quarantined == 0
            assert jobs[lb].stats.row_groups == N_RG
        assert normalized(docs[1]) == normalized(docs[0])
        assert sorted(os.listdir(tmp_path / "port")) == \
            sorted(os.listdir(tmp_path / "jax"))

    def test_draining_server_rejects_submissions(self, tmp_path):
        p = write_file(tmp_path / "f.parquet")
        seen = []
        for cls, arb in ((JaxScanServer, JaxArbiter),
                         (ScanServer, ResourceArbiter)):
            kw = {} if cls is JaxScanServer else {"mesh": cpu_mesh()}
            srv = cls(arbiter=arb(total_workers=1), **kw)
            try:
                srv.add_tenant("t")
                srv.request_drain()
                with pytest.raises(Exception) as ei:
                    srv.submit("t", [p])
                e = ei.value
                seen.append((type(e).__name__, str(e), e.reason,
                             e.retry_after_s, srv.draining))
            finally:
                srv.shutdown()
        assert seen[1] == seen[0]
        assert seen[1][2] == "draining" and seen[1][3] > 0

    def test_greedy_tenant_cannot_starve_the_meek(self, tmp_path):
        gp = write_file(tmp_path / "g.parquet")
        mp = write_file(tmp_path / "m.parquet", base=5_000_000)
        with ScanServer(arbiter=ResourceArbiter(total_workers=4),
                        queue_bound=8, mesh=cpu_mesh()) as srv:
            srv.add_tenant("greedy", weight=10_000.0)
            srv.add_tenant("meek", weight=1.0)
            greedy_jobs = [srv.submit("greedy", [gp], job_id=f"g{i}")
                           for i in range(4)]
            meek = srv.submit("meek", [mp])
            assert meek.wait(TIMEOUT_S) and meek.state == "done"
            assert srv.status()["shares"]["meek"] >= 1
            for j in greedy_jobs:
                assert j.wait(TIMEOUT_S) and j.state == "done"
        same_outputs(meek.outputs, [mp], "meek")
        for j in greedy_jobs:
            same_outputs(j.outputs, [gp], j.job_id)

    def test_queue_bound_sheds_load(self, tmp_path):
        p = write_file(tmp_path / "f.parquet")
        srv = ScanServer(arbiter=ResourceArbiter(total_workers=1),
                         queue_bound=1, mesh=cpu_mesh())
        try:
            srv.add_tenant("t")
            jobs = []
            rejected = None
            # the depth counts queued and running jobs: a bound of 1
            # refuses the third quick submission at the latest
            for i in range(3):
                try:
                    jobs.append(srv.submit("t", [p], job_id=f"j{i}"))
                except AdmissionRejected as e:
                    rejected = e
            assert rejected is not None
            assert rejected.reason == "queue_full"
            for j in jobs:
                assert j.wait(TIMEOUT_S) and j.state == "done"
        finally:
            srv.shutdown()

    def test_no_mesh_needs_a_card(self, tmp_path, monkeypatch):
        """No fallback: without CUDA a job of a server with no mesh
        fails with the mesh's words and decodes nothing."""
        monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
        p = write_file(tmp_path / "f.parquet")
        with ScanServer(arbiter=ResourceArbiter(total_workers=1)) as srv:
            srv.add_tenant("t")
            job = srv.submit("t", [p])
            assert job.wait(TIMEOUT_S)
        assert job.state == "failed"
        assert isinstance(job.error, RuntimeError)
        assert "CUDA" in str(job.error)
        assert job.outputs == {} and job.units_done == 0

    def test_submit_dataset_as_reference(self, tmp_path):
        """A manifest dataset's files, pruned by a partition filter before
        the admission and charged the manifest's bytes, as the JAX
        server's job reads them."""
        from tpuparquet.dataset import DatasetWriter
        from tpuparquet.filter import col as jax_col
        from tpuparquet_torch.filter import col

        root = tmp_path / "ds"
        w = DatasetWriter(str(root), "message rec { required int64 id; "
                          "required binary region (STRING); }", ["region"])
        w.write_columns({"id": np.arange(60, dtype=np.int64),
                         "region": [b"eu" if i % 3 else b"us"
                                    for i in range(60)]})
        w.commit()
        w._release()
        jobs = []
        for cls, arb, c, kw in (
                (JaxScanServer, JaxArbiter, jax_col, {}),
                (ScanServer, ResourceArbiter, col, {"mesh": cpu_mesh()})):
            with cls(arbiter=arb(total_workers=2), **kw) as srv:
                srv.add_tenant("t")
                job = srv.submit_dataset("t", str(root), "id",
                                         filter=c("region") == "eu")
                assert job.wait(TIMEOUT_S) and job.state == "done", \
                    job.as_dict()
                jobs.append(job)
        assert jobs[1].est_bytes == jobs[0].est_bytes > 0
        assert jobs[1].sources == jobs[0].sources
        assert sorted(jobs[1].outputs) == sorted(jobs[0].outputs)
        for k in jobs[0].outputs:
            same_units(jobs[1].outputs[k], jobs[0].outputs[k], f"unit {k}")
        with pytest.raises(FileNotFoundError):
            with ScanServer(mesh=cpu_mesh()) as srv:
                srv.add_tenant("t")
                srv.submit_dataset("t", str(tmp_path / "none"))

    def test_plan_cache_and_arena_knobs(self, tmp_path):
        """``plan_cache_mb`` arms the plan cache for the server's life (the
        same scan twice: the second job hits once a chunk) and the
        shutdown restores what was set before; the arena pool's
        retention is the worker budget while the server runs."""
        p = write_file(tmp_path / "f.parquet")
        before = port_arena.set_arena_retention(5)
        assert port_plancache.plan_cache_budget() == 0
        try:
            with ScanServer(arbiter=ResourceArbiter(total_workers=3),
                            plan_cache_mb=16, mesh=cpu_mesh()) as srv:
                assert port_plancache.plan_cache_budget() == 16 << 20
                assert port_arena._POOL.max_arenas == 3
                srv.add_tenant("t")
                first = srv.submit("t", [p], job_id="one")
                assert first.wait(TIMEOUT_S) and first.state == "done"
                second = srv.submit("t", [p], job_id="two")
                assert second.wait(TIMEOUT_S) and second.state == "done"
            chunks = second.stats.chunks
            assert chunks == N_RG
            assert second.stats.plan_cache_hits == chunks
            assert second.stats.plan_cache_misses == 0
            assert first.stats.plan_cache_misses == chunks
            assert port_plancache.plan_cache_budget() == 0
            assert port_arena._POOL.max_arenas == 5
        finally:
            port_arena.set_arena_retention(before)
            port_plancache.clear_plan_cache()

    def test_state_dir_default_and_cursor_names(self, tmp_path,
                                                 monkeypatch):
        from tpuparquet.serve import server as jax_server
        from tpuparquet_torch.serve import server as port_server

        monkeypatch.setenv("TPQ_SERVE_STATE_DIR", str(tmp_path / "st"))
        assert port_server.state_dir_default() == \
            jax_server.state_dir_default() == str(tmp_path / "st")
        monkeypatch.setenv("TPQ_SERVE_REBALANCE_S", "0.001")
        assert port_arbiter.rebalance_interval_default() == \
            jax_arbiter.rebalance_interval_default() == 0.05
        names = []
        for mod in (jax_server, port_server):
            job = mod.ScanJob("tenant a/b", "job 7", [], (), {}, None)
            srv = mod.ScanServer.__new__(mod.ScanServer)
            srv.state_dir = str(tmp_path / "st")
            names.append(srv._cursor_path(job))
        assert names[1] == names[0]


# ----------------------------------------------------------------------
# the serve command's requeue
# ----------------------------------------------------------------------

class TestServeRequeue:
    def test_byte_budget_shed_requeued_and_completes(self, tmp_path):
        """A job shed for the tenant's byte budget is held back and
        submitted again after its retry-after hint; both run: the JAX
        command's words and exit code, on the CPU mesh."""
        from tpuparquet.cli.parquet_tool import cmd_serve as jax_cmd_serve
        from tpuparquet_torch.cli.parquet_tool import cmd_serve

        p = write_file(tmp_path / "a.parquet")
        size = os.path.getsize(p)
        spec = {
            "workers": 2,
            "tenants": [{"label": "t", "byte_budget": int(size * 1.5)}],
            "jobs": [
                {"tenant": "t", "sources": [p], "columns": ["a"],
                 "job_id": "j1"},
                {"tenant": "t", "sources": [p], "columns": ["a"],
                 "job_id": "j2"},
            ],
        }
        sp = tmp_path / "spec.json"
        sp.write_text(json.dumps(spec))
        got = []
        old = signal.getsignal(signal.SIGTERM)
        try:
            for fn, kw in ((jax_cmd_serve, {}),
                           (cmd_serve, {"device": "cpu"})):
                buf = io.StringIO()
                rc = fn(argparse.Namespace(spec=str(sp), **kw), out=buf)
                got.append((rc, buf.getvalue()))
        finally:
            signal.signal(signal.SIGTERM, old)
        assert got[1] == got[0]
        rc, out = got[1]
        assert rc == 0, out
        assert "shed (byte_budget)" in out and "retrying in" in out
        assert out.count(": done") == 2
        assert "never admitted" not in out


# ----------------------------------------------------------------------
# the drain and resume sweep, in a child process
# ----------------------------------------------------------------------

N_TENANTS = 2

#: the child server: ``python -c CHILD STATE_DIR OUTDIR FILE...``.  One
#: tenant a file, each one job under the fixed id ``sweep`` on a CPU mesh
#: with a durable cursor; each unit is logged, then written atomically
#: under its key (``unit<k>.npy``) before the scan checkpoints past it.
#: SIGTERM drains.  Exit 0: every job done; 3: drained; 1: failed.
CHILD = r"""
import os, sys
import numpy as np
from tpuparquet_torch.serve import ScanServer
from tpuparquet_torch.shard import make_mesh


def sink_for(outdir):
    log = os.path.join(outdir, "decode.log")

    def sink(k, out):
        vals, _rep, _dl = out["a"].to_numpy()
        with open(log, "a") as f:
            f.write(f"{k}\n")
            f.flush()
            os.fsync(f.fileno())
        tmp = os.path.join(outdir, f".unit{k}.tmp.npy")
        np.save(tmp, np.asarray(vals).ravel())
        os.replace(tmp, os.path.join(outdir, f"unit{k}.npy"))

    return sink


state_dir, outdir = sys.argv[1], sys.argv[2]
server = ScanServer(state_dir=state_dir, rebalance_interval=0.1,
                    mesh=make_mesh(1, devices=["cpu"]))
server.install_signal_handlers()
jobs = []
for i, path in enumerate(sys.argv[3:]):
    tenant = f"tenant_{i}"
    tdir = os.path.join(outdir, tenant)
    os.makedirs(tdir, exist_ok=True)
    server.add_tenant(tenant)
    jobs.append(server.submit(tenant, [path], job_id="sweep",
                              checkpoint_every=1, sink=sink_for(tdir)))
for job in jobs:
    job.wait()
server.shutdown(drain=False)
states = {j.state for j in jobs}
sys.exit(0 if states == {"done"} else 1 if "failed" in states else 3)
"""


def _spawn(state_dir, outdir, paths):
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env.update(PYTHONPATH=REPO, TPQ_RETRY_BASE_S="0.001",
               TPQ_RETRY_MAX_S="0.002")
    return subprocess.Popen(
        [sys.executable, "-c", CHILD, str(state_dir), str(outdir)] + paths,
        cwd=REPO, env=env, stdout=subprocess.DEVNULL,
        stderr=subprocess.DEVNULL)


def _unit_files(outdir, tenant):
    tdir = os.path.join(str(outdir), tenant)
    if not os.path.isdir(tdir):
        return []
    return sorted((f for f in os.listdir(tdir)
                   if f.startswith("unit") and f.endswith(".npy")),
                  key=lambda s: int(s[4:-4]))


def _total_units(outdir):
    return sum(len(_unit_files(outdir, f"tenant_{i}"))
               for i in range(N_TENANTS))


def _wait_for(proc, cond, deadline):
    while not cond() and proc.poll() is None \
            and time.monotonic() < deadline:
        time.sleep(0.005)


class TestDrainResumeSweep:
    """SIGTERM (a graceful drain), then SIGKILL (a crash) of a child
    server mid-flight; each successor resumes every tenant's cursor; the
    union of each tenant's keyed outputs is complete, has no duplicate,
    and equals the JAX package's ``ShardedScan``."""

    def test_drain_kill_resume_union_exact(self, tmp_path):
        paths = [write_file(tmp_path / f"f{i}.parquet", base=i * 100_000)
                 for i in range(N_TENANTS)]
        outdir = tmp_path / "out"
        outdir.mkdir()
        state_dir = tmp_path / "state"
        total = N_TENANTS * N_RG
        kills = 0
        deadline = time.monotonic() + 300

        # round 1: SIGTERM once a unit has landed: a graceful drain
        # (cursors flushed, exit 3: resumable)
        proc = _spawn(state_dir, outdir, paths)
        _wait_for(proc, lambda: _total_units(outdir) >= 1, deadline)
        if proc.poll() is None:
            proc.send_signal(signal.SIGTERM)
            kills += 1
        rc = proc.wait(timeout=TIMEOUT_S)
        assert rc in (0, 3), f"drain run exited {rc}"

        # round 2: SIGKILL of the successor mid-flight: a crash
        if _total_units(outdir) < total:
            before = _total_units(outdir)
            proc = _spawn(state_dir, outdir, paths)
            _wait_for(proc, lambda: _total_units(outdir) >= before + 1,
                      deadline)
            if proc.poll() is None:
                proc.send_signal(signal.SIGKILL)
                kills += 1
            proc.wait(timeout=TIMEOUT_S)

        # an uninterrupted successor finishes every tenant
        proc = _spawn(state_dir, outdir, paths)
        assert proc.wait(timeout=TIMEOUT_S) == 0

        for i in range(N_TENANTS):
            tenant = f"tenant_{i}"
            assert _unit_files(outdir, tenant) == \
                [f"unit{k}.npy" for k in range(N_RG)]
            expected = oracle_units([paths[i]])
            for k in range(N_RG):
                got = np.load(os.path.join(str(outdir), tenant,
                                           f"unit{k}.npy"))
                want = np.asarray(expected[k]["a"].to_numpy()[0]).ravel()
                np.testing.assert_array_equal(got, want,
                                              err_msg=f"{tenant} unit {k}")
            # with checkpoint_every=1 a kill re-decodes at most one unit a
            # tenant (consumed, not yet checkpointed); a drain none
            with open(os.path.join(str(outdir), tenant,
                                   "decode.log")) as f:
                decoded = [int(line) for line in f if line.strip()]
            counts = {k: decoded.count(k) for k in set(decoded)}
            assert sorted(counts) == list(range(N_RG))
            assert sum(c - 1 for c in counts.values()) <= kills, \
                (tenant, decoded)


# ----------------------------------------------------------------------
# the prefetch planner
# ----------------------------------------------------------------------

def _planner(mod, *, max_depth, unit_deadline):
    return mod.PrefetchPlanner([], [(0, 0)], "lab", max_depth=max_depth,
                               unit_deadline=unit_deadline)


@pytest.mark.parametrize("seed", range(12))
def test_target_depth_as_reference(seed, monkeypatch):
    """The depth from the unit digest's p99 against the deadline and the
    fast burn rate, over seeded states of both."""
    rng = np.random.default_rng(seed)
    saved = (jax_digest.digests(), port_digest.digests())
    try:
        for dg in (jax_digest, port_digest):
            dg.set_digests(True)
        walls = rng.lognormal(9.0, 1.2, int(rng.integers(0, 60)))
        for us in walls.astype(np.int64):
            jax_digest.observe("lab", "unit", int(us))
            port_digest.observe("lab", "unit", int(us))
        for _ in range(8):
            max_depth = int(rng.integers(0, 7))
            deadline = (None if rng.random() < 0.2
                        else float(rng.choice([0.001, 0.01, 0.05, 0.2, 2.0])))
            burn = rng.choice([None, 0.3, 0.99, 1.0, 4.0])
            got = []
            for mod in (jax_prefetch, port_prefetch):
                p = _planner(mod, max_depth=max_depth,
                             unit_deadline=deadline)
                monkeypatch.setattr(p, "_fast_burn", lambda b=burn: b)
                got.append((p._digest_p99_s(), p._target_depth()))
            assert got[1] == got[0], (max_depth, deadline, burn)
    finally:
        jax_digest._active, port_digest._active = saved


def test_fast_burn_as_reference(tmp_path, monkeypatch):
    """The label's fast burn rate read from one time-series ring under
    one SLO file, by both planners."""
    from tpuparquet.obs import timeseries as jax_ts
    from tpuparquet.shard import ShardedScan
    from tpuparquet_torch.obs import timeseries as port_ts

    p = write_file(tmp_path / "f.parquet")
    ring = str(tmp_path / "ring")
    slo = tmp_path / "slo.json"
    slo.write_text(json.dumps([{"label": "lab",
                                "latency_target_ms": 0.000001,
                                "error_rate_target": 0.01}]))
    monkeypatch.setenv("TPQ_SLO_FILE", str(slo))
    saved = jax_digest.digests()
    try:
        jax_digest.set_digests(True)
        jax_ts.set_ring_dir(ring)
        ShardedScan([p], progress_label="lab").run()
        jax_ts.tick("test")
        port_ts.set_ring_dir(ring)
        got = [_planner(mod, max_depth=3, unit_deadline=None)._fast_burn()
               for mod in (jax_prefetch, port_prefetch)]
    finally:
        jax_ts.set_ring_dir(None)
        port_ts.set_ring_dir(None)
        jax_digest._active = saved
    assert got[0] is not None and got[1] == got[0]


def _emu_corpus(tmp_path, n=2):
    return ["emu://" + write_remote_file(tmp_path, name=f"r{i}.parquet",
                                         rows=480, groups=4, seed=50 + i)
            for i in range(n)]


def test_planner_warms_the_tier(tmp_path, monkeypatch):
    """The planner fetches the chunk ranges of the units ahead of the
    cursor into the disk tier, counted on the closing thread's
    collector; the reads then hit the tier and fetch nothing."""
    monkeypatch.setenv("TPQ_CACHE_DISK_DIR", str(tmp_path / "cache"))
    (src,) = _emu_corpus(tmp_path, 1)
    reader = FileReader(src)
    units = [(0, g) for g in range(reader.row_group_count())]
    dc = disk_cache()
    etag = reader._source.etag()

    def warm(g):
        return all(dc.contains(etag + (reader._chunk_start(cm),
                                       cm.total_compressed_size))
                   for _p, _n, cm in reader.selected_chunks(
                       reader.meta.row_groups[g]))

    with collect_stats() as st:
        p = port_prefetch.PrefetchPlanner([reader], units, "lab",
                                          max_depth=2).start()
        deadline = time.monotonic() + 30
        while not (warm(0) and warm(1)) and time.monotonic() < deadline:
            time.sleep(0.01)
        assert warm(0) and warm(1) and not warm(2)
        p.note_progress(1)
        while not warm(3) and time.monotonic() < deadline:
            time.sleep(0.01)
        assert warm(3)
        p.close()
    assert st.remote_ranges_fetched == 4
    with collect_stats() as st2:
        for g in range(4):
            reader.read_row_group_arrays(g)
    assert st2.remote_ranges_fetched == 0
    assert st2.cache_hits_disk == 8 and st2.cache_misses_disk == 0
    reader.close()


REMOTE = ("remote_ranges_fetched", "ranges_coalesced", "remote_bytes",
          "remote_retry", "cache_hits_disk", "cache_misses_disk",
          "cache_evictions_disk", "row_groups", "chunks", "values")


@pytest.mark.parametrize("depth", ["0", "2", "4"])
def test_prefetch_counters_as_reference(tmp_path, monkeypatch, depth):
    """A job over ``emu://`` sources with the disk tier armed, cold: the
    units and the remote and disk counters on the job's stats equal the
    JAX server's job, the planner on (each range fetched once, by
    whichever asks first) or off."""
    sources = _emu_corpus(tmp_path)
    monkeypatch.setenv("TPQ_PREFETCH_DEPTH", depth)
    got = []
    for name, cls, arb, kw in (
            ("jax", JaxScanServer, JaxArbiter, {}),
            ("port", ScanServer, ResourceArbiter, {"mesh": cpu_mesh()})):
        monkeypatch.setenv("TPQ_CACHE_DISK_DIR", str(tmp_path / name))
        reset_range_caches()
        jax_reset_range_caches()
        with cls(arbiter=arb(total_workers=2), **kw) as srv:
            srv.add_tenant("fleet")
            job = srv.submit("fleet", sources)
            assert job.wait(TIMEOUT_S) and job.state == "done", \
                job.as_dict()
        got.append(job)
    theirs, ours = got
    assert {k: getattr(ours.stats, k) for k in REMOTE} == \
        {k: getattr(theirs.stats, k) for k in REMOTE}
    assert ours.stats.cache_hits_disk == ours.stats.chunks == 16
    assert sorted(ours.outputs) == sorted(theirs.outputs)
    for k in theirs.outputs:
        same_units(ours.outputs[k], theirs.outputs[k], f"unit {k}")


@pytest.mark.parametrize("name,value,want", [
    ("TPQ_PREFETCH_DEPTH", None, 2), ("TPQ_PREFETCH_DEPTH", "0", 0),
    ("TPQ_PREFETCH_DEPTH", "5", 5), ("TPQ_PREFETCH_BYTES_MB", None, 64 << 20),
    ("TPQ_PREFETCH_BYTES_MB", "0.5", 1 << 19)])
def test_prefetch_knobs_as_reference(monkeypatch, name, value, want):
    if value is not None:
        monkeypatch.setenv(name, value)
    fn = ("prefetch_depth_default" if name == "TPQ_PREFETCH_DEPTH"
          else "prefetch_bytes_default")
    assert getattr(port_prefetch, fn)() == getattr(jax_prefetch, fn)() \
        == want
