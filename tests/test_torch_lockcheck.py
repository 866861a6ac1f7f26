"""The port's runtime lock-order recorder (``tpuparquet_torch/lockcheck.py``)
against the reference's (``tests/test_lockcheck.py``'s tests, twin for
twin), and its cross-validation against the port's static lock graph.

The two packages' recorders are never installed in one process: the unit
tests install the port's for one test and uninstall it after, and the
workload runs in a subprocess under ``TPQ_LOCKCHECK`` with the port
alone imported.
"""

import json
import os
import subprocess
import sys
import textwrap
import threading

import pytest

_REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if _REPO not in sys.path:
    sys.path.insert(0, _REPO)

from tpuparquet import lockcheck as jax_lockcheck  # noqa: E402
from tpuparquet_torch import lockcheck  # noqa: E402


@pytest.fixture
def recorder():
    """Install the port's wrappers for one test, restore and wipe after."""
    assert not jax_lockcheck.installed()
    lockcheck.reset()
    lockcheck.install(strict=False)
    try:
        yield lockcheck
    finally:
        lockcheck.uninstall()
        lockcheck.reset()


class TestRecorder:
    def test_nested_acquire_records_edge(self, recorder):
        la = threading.Lock()
        lb = threading.Lock()
        with la:
            with lb:
                pass
        e = recorder.edges()
        assert len(e) == 1 and e[0][2] == 1
        a, b, _ = e[0]
        assert a != b
        assert a.startswith("tests/test_torch_lockcheck.py:")
        assert b.startswith("tests/test_torch_lockcheck.py:")
        assert recorder.check_dag() == []

    def test_cycle_detected(self, recorder):
        la = threading.Lock()
        lb = threading.Lock()
        with la:
            with lb:
                pass
        with lb:
            with la:
                pass
        v = recorder.violations()
        assert v and v[0]["kind"] == "lock-cycle"

    def test_strict_raises_at_closing_acquisition(self, recorder):
        recorder.install(strict=True)
        la = threading.Lock()
        lb = threading.Lock()
        with la:
            with lb:
                pass
        with pytest.raises(lockcheck.LockOrderError):
            with lb:
                with la:
                    pass
        # the failed acquisition left nothing held
        assert not la.locked()

    def test_rlock_reentry_is_not_an_edge(self, recorder):
        rl = threading.RLock()
        with rl:
            with rl:
                assert rl._recursion_count() == 2
        assert recorder.edges() == []
        assert recorder.violations() == []

    def test_condition_wait_releases_held_entry(self, recorder):
        # Condition drives _release_save/_acquire_restore on the wrapped
        # RLock; a wait must not leave the site marked held
        cv = threading.Condition(threading.RLock())
        other = threading.Lock()

        def waker():
            with cv:
                cv.notify()

        with cv:
            t = threading.Thread(target=waker)
            t.start()
            cv.wait(timeout=5)
        t.join()
        with other:
            pass
        # no cv-site -> other-site edge: wait() dropped the hold
        repo_edges = [(a, b) for a, b, _n in recorder.edges()
                      if lockcheck.repo_site(a) and lockcheck.repo_site(b)]
        assert repo_edges == []
        assert recorder.check_dag() == []

    def test_repo_site_predicate(self):
        assert lockcheck.repo_site("tpuparquet_torch/io/reader.py:142")
        assert lockcheck.repo_site("tests/test_torch_lockcheck.py:10")
        assert not lockcheck.repo_site("tpuparquet/io/reader.py:66")
        assert not lockcheck.repo_site(
            "/usr/lib/python3.12/logging/__init__.py:226")
        assert not lockcheck.repo_site("<unknown>:0")
        # the reference's predicate is the twin, over its own package
        assert jax_lockcheck.repo_site("tpuparquet/io/reader.py:66")

    def test_foreign_cycle_not_a_violation(self, recorder):
        # a cycle whose edges touch a non-repo site (torch, the standard
        # library) must not trip the verdict
        for first, second in (("/usr/lib/x.py:1", "tpuparquet_torch/a.py:2"),
                              ("tpuparquet_torch/a.py:2", "/usr/lib/x.py:1")):
            lockcheck._record_acquire(first, False)
            lockcheck._record_acquire(second, False)
            lockcheck._record_release(second)
            lockcheck._record_release(first)
        assert recorder.violations() == []
        assert recorder.check_dag() == []

    def test_dump_roundtrip(self, recorder, tmp_path):
        la = threading.Lock()
        lb = threading.Lock()
        with la:
            with lb:
                pass
        out = tmp_path / "locks.json"
        recorder.dump(str(out))
        doc = json.loads(out.read_text())
        assert doc["edges"] and doc["violations"] == []
        assert set(doc) == {"locks", "edges", "violations"}
        assert not list(tmp_path.glob("*.tmp"))

    def test_at_fork_reinit_delegates(self, recorder):
        lk = threading.Lock()
        lk.acquire()
        lk._at_fork_reinit()
        assert not lk.locked()
        # the reinitialised lock is no longer held by this thread
        with threading.Lock():
            pass
        assert recorder.edges() == []

    def test_same_verdicts_as_reference(self):
        """The same choreography of acquisitions gives the two recorders
        the same edges and violations, the package name swapped."""
        seq = [("a", "b"), ("b", "c"), ("c", "a"), ("a", "x")]
        got = []

        def drive(mod, pkg):
            # a fresh thread: its held set starts empty
            for first, second in seq:
                s1 = (pkg + first + ".py:1" if first != "x"
                      else "/usr/lib/x.py:1")
                s2 = (pkg + second + ".py:1" if second != "x"
                      else "/usr/lib/x.py:1")
                mod._record_acquire(s1, False)
                mod._record_acquire(s2, False)
                mod._record_release(s2)
                mod._record_release(s1)

        for mod, pkg in ((jax_lockcheck, "tpuparquet/"),
                         (lockcheck, "tpuparquet_torch/")):
            mod.reset()
            try:
                t = threading.Thread(target=drive, args=(mod, pkg))
                t.start()
                t.join()
                snap = json.dumps(mod.snapshot(), sort_keys=True)
            finally:
                mod.reset()
            got.append(snap.replace(pkg, "<pkg>/"))
        assert got[0] == got[1]
        assert '"lock-cycle"' in got[1]


_WORKLOAD = textwrap.dedent("""
    import json, os, sys, tempfile, threading
    sys.path.insert(0, {repo!r})
    import tpuparquet_torch
    from tpuparquet_torch import lockcheck
    assert "tpuparquet" not in sys.modules
    assert lockcheck.installed() and threading.Lock is lockcheck._lock_factory
    from tpuparquet_torch import FileWriter, ShardedScan, make_mesh
    from tpuparquet_torch.io import rangecache

    # a package lock created at import is wrapped, at its own site
    assert isinstance(rangecache._LOCK, lockcheck._CheckedLock), \\
        rangecache._LOCK
    assert rangecache._LOCK._site.startswith("tpuparquet_torch/io/")

    root = tempfile.mkdtemp(prefix="tpq-lockcheck-")
    path = os.path.join(root, "t.parquet")
    with open(path, "wb") as f:
        w = FileWriter(f, "message m {{ required int64 k; "
                          "required double v; }}",
                       max_row_group_size=600)
        for j in range(160):
            w.add_data({{"k": j, "v": j * 0.5}})
        w.close()
    # plan-parallel local scan and an emulated remote scan on a 4-slot
    # CPU mesh: the reader's handle lock over a RangeSourceFile, the
    # byte-source locks and the progress and deadline locks
    os.environ["TPQ_PLAN_THREADS"] = "4"
    mesh = make_mesh(4, devices=["cpu"] * 4)
    for src in (path, "emu://" + path):
        with ShardedScan([src], mesh=mesh) as scan:
            units = scan.run()
        assert units and all("k" in u for u in units)
""")


def test_workload_dump_is_subgraph_of_static(tmp_path):
    out = tmp_path / "dump.json"
    env = dict(os.environ)
    env.update({"TPQ_LOCKCHECK": "strict", "TPQ_LOCKCHECK_OUT": str(out)})
    env.pop("PYTHONPATH", None)
    proc = subprocess.run(
        [sys.executable, "-c", _WORKLOAD.format(repo=_REPO)],
        env=env, capture_output=True, text=True, timeout=240)
    assert proc.returncode == 0, proc.stderr[-2000:]
    doc = json.loads(out.read_text())
    assert doc["violations"] == []
    assert any(s.startswith("tpuparquet_torch/") for s in doc["locks"])
    assert any(a.startswith("tpuparquet_torch/")
               and b.startswith("tpuparquet_torch/")
               for a, b, _n in doc["edges"])

    from tpuparquet_torch.analyze import RepoTree, threads

    problems = threads.verify_runtime_graph(RepoTree.from_disk(_REPO), doc)
    assert problems == [], "\n".join(problems)
