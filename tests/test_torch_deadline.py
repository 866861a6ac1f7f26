"""The port's deadlines against the JAX package's, on the CPU.

``deadline.call_with_deadline`` runs a call on a watched worker: in time
its result, error and counters come back; past its budget it raises with
the budget and coordinates and counts ``deadline_exceeded``.  A hung
chunk read under a unit deadline quarantines its unit as
``DeadlineExceededError``; a hung dispatch under a dispatch deadline is
retried, then decoded on the host; a scan deadline stops between units
with the cursor intact.  Each case runs in both packages under the same
injected hang (budgets of 0.05-0.5 s), and the counters, entries and
survivors agree.  Every test joins the workers it abandoned.
"""

from __future__ import annotations

import io
import re
import threading
import time

import numpy as np
import pytest

import tpuparquet.deadline as jax_deadline
from tpuparquet import errors as jax_errors
import tpuparquet.faults as jax_faults
from tpuparquet import FileReader as JaxFileReader
from tpuparquet import FileWriter as JaxFileWriter
from tpuparquet.kernels import device as jax_device
from tpuparquet.shard import ShardedScan as JaxShardedScan
from tpuparquet.stats import collect_stats as jax_collect_stats
from tpuparquet_torch import deadline as port_deadline
from tpuparquet_torch import errors as port_errors
from tpuparquet_torch import faults as port_faults
from tpuparquet_torch.io.reader import FileReader
from tpuparquet_torch.kernels import device as port_device
from tpuparquet_torch.shard import ShardedScan, make_mesh
from tpuparquet_torch.stats import collect_stats, current_stats

N_RG = 3
N = 200


@pytest.fixture(autouse=True)
def _fast_backoff_and_join(monkeypatch):
    """Millisecond backoff; afterwards every abandoned worker of either
    package is joined, so none outlives the test."""
    monkeypatch.setenv("TPQ_RETRY_BASE_S", "0.0005")
    monkeypatch.setenv("TPQ_RETRY_MAX_S", "0.002")
    yield
    for mod in (port_deadline, jax_deadline):
        mod._drain_workers_at_exit()
        with mod._workers_lock:
            assert not any(t.is_alive() for t in mod._workers)


def write_file(path) -> None:
    buf = io.BytesIO()
    w = JaxFileWriter(buf, "message m { required int64 a; }")
    for rg in range(N_RG):
        w.write_columns(
            {"a": np.arange(rg * N, rg * N + N, dtype=np.int64)})
    w.close()
    path.write_bytes(buf.getvalue())


def unit_values(out) -> np.ndarray:
    return np.asarray(out["a"].to_numpy()[0]).ravel()


def _mesh():
    return make_mesh(2, devices=["cpu"] * 2)


COUNTERS = ("faults_injected", "io_retries", "dispatch_retries",
            "pages_degraded", "units_degraded", "units_quarantined",
            "deadline_exceeded", "pages", "values")


def _counters(st) -> dict:
    return {k: getattr(st, k) for k in COUNTERS}


# ----------------------------------------------------------------------
# budgets and call_with_deadline
# ----------------------------------------------------------------------

@pytest.mark.parametrize("name,env", [
    ("unit_deadline_default", "TPQ_UNIT_DEADLINE_S"),
    ("scan_deadline_default", "TPQ_SCAN_DEADLINE_S"),
    ("dispatch_deadline_default", "TPQ_DISPATCH_DEADLINE_S")])
@pytest.mark.parametrize("raw", [None, "0.25", "0", "-1", "soon", "inf",
                                 "nan", " 2 ", "1e-3"])
def test_env_budgets_as_reference(monkeypatch, name, env, raw):
    if raw is None:
        monkeypatch.delenv(env, raising=False)
    else:
        monkeypatch.setenv(env, raw)
    assert getattr(port_deadline, name)() == getattr(jax_deadline, name)()


def test_no_budget_is_a_plain_call():
    calls = []
    assert port_deadline.call_with_deadline(
        lambda: calls.append(threading.current_thread()) or "x", None,
        site="t") == "x"
    assert port_deadline.call_with_deadline(lambda: "y", 0, site="t") == "y"
    assert calls == [threading.current_thread()]


def test_fast_call_returns_and_errors_propagate():
    assert port_deadline.call_with_deadline(lambda: 41 + 1, 5.0,
                                            site="t") == 42
    with pytest.raises(KeyError):
        port_deadline.call_with_deadline(lambda: {}["missing"], 5.0,
                                         site="t")


def test_expiry_raises_with_budget_and_coordinates():
    got = []
    for mod, stats, errors in (
            (port_deadline, collect_stats, port_errors),
            (jax_deadline, jax_collect_stats, jax_errors)):
        with stats() as st:
            with pytest.raises(errors.DeadlineExceededError) as ei:
                mod.call_with_deadline(lambda: time.sleep(0.5), 0.05,
                                       site="test.hang", column="a",
                                       row_group=2)
        e = ei.value
        assert e.budget == 0.05 and 0.05 <= e.elapsed < 0.5
        assert isinstance(e, errors.TransientIOError)
        got.append((e.column, e.row_group, e.site, st.deadline_exceeded,
                    re.sub(r"(hung for |elapsed_s=)[\d.]+", r"\1",
                           str(e))))
    assert got[0] == got[1] == (
        "a", 2, "test.hang", 1, got[0][4])


def test_worker_counts_merge_on_success_only_faults_on_failure():
    def work():
        st = current_stats()
        st.io_retries += 3
        st.pages += 5
        return "ok"

    def failing():
        st = current_stats()
        st.io_retries += 2
        st.pages += 7
        raise ValueError("bad")

    with collect_stats() as st:
        assert port_deadline.call_with_deadline(work, 5.0, site="t") == "ok"
        with pytest.raises(ValueError):
            port_deadline.call_with_deadline(failing, 5.0, site="t")
    assert (st.io_retries, st.pages) == (5, 5)


def test_watchdog_is_one_daemon_thread():
    w = port_deadline.watchdog()
    assert w is port_deadline.watchdog() and w.daemon and w.is_alive()


# ----------------------------------------------------------------------
# the hang matrix
# ----------------------------------------------------------------------

def test_hung_read_quarantined_under_a_unit_deadline(tmp_path):
    """No mirror: each hung unit costs its budget and lands in the
    report as DeadlineExceededError; the scan never stalls."""
    p = tmp_path / "f.parquet"
    write_file(p)
    got = []
    for faults, stats, cls, kw in (
            (port_faults, collect_stats, ShardedScan, {"mesh": _mesh()}),
            (jax_faults, jax_collect_stats, JaxShardedScan, {})):
        with stats() as st, faults.inject_faults() as inj:
            inj.inject("io.chunk.hang", "hang", times=1000, seconds=30.0)
            scan = cls([str(p)], on_error="quarantine", unit_deadline=0.15,
                       retries=0, **kw)
            t0 = time.monotonic()
            results = scan.run()
            wall = time.monotonic() - t0
        assert results == [] and wall < 10.0
        for e in scan.quarantine.entries:
            assert e["budget_s"] == 0.15 and e["elapsed_s"] >= 0.15
        got.append(([{k: v for k, v in e.items()
                      if k not in ("message", "elapsed_s")}
                     for e in scan.quarantine.entries], _counters(st)))
    assert got[0] == got[1]
    assert [e["error"] for e in got[0][0]] == \
        ["DeadlineExceededError"] * N_RG
    assert got[0][1]["units_quarantined"] == N_RG
    assert got[0][1]["deadline_exceeded"] >= N_RG


def test_hung_dispatch_retried_then_degraded(tmp_path):
    """``kernels.device.hang`` under a dispatch deadline: each device
    attempt is abandoned, retried once, then the unit decodes on the host
    (the degraded plan skips the hang site)."""
    p = tmp_path / "f.parquet"
    write_file(p)
    got = []
    for faults, stats, read, reader in (
            (port_faults, collect_stats,
             lambda r, **kw: port_device.read_row_group_device_resilient(
                 r, 0, device="cpu", **kw), FileReader(str(p))),
            (jax_faults, jax_collect_stats,
             lambda r, **kw: jax_device.read_row_group_device_resilient(
                 r, 0, **kw), JaxFileReader(str(p)))):
        with stats() as st, faults.inject_faults() as inj:
            inj.inject("kernels.device.hang", "hang", times=1000,
                       seconds=10.0)
            out = read(reader, retries=1, dispatch_deadline=0.05,
                       sleep=lambda s: None)
        np.testing.assert_array_equal(unit_values(out), np.arange(N))
        got.append(_counters(st))
    assert got[0] == got[1]
    assert got[0]["units_degraded"] == 1
    assert got[0]["dispatch_retries"] == 1
    assert got[0]["deadline_exceeded"] == 2  # the first attempt and one retry


def test_hung_unit_dispatch_quarantined_within_budget(tmp_path):
    """``kernels.device.hang`` on one unit of a quarantining scan with a
    unit deadline: that unit is quarantined as DeadlineExceededError
    within its budget plus 1 s, the others decode."""
    p = tmp_path / "f.parquet"
    write_file(p)
    with collect_stats() as st, port_faults.inject_faults() as inj:
        inj.inject("kernels.device.hang", "hang", times=1, after=1,
                   seconds=30.0)
        scan = ShardedScan([str(p)], mesh=_mesh(), on_error="quarantine",
                           unit_deadline=0.3)
        t0 = time.monotonic()
        got = dict(scan.run_iter())
        wall = time.monotonic() - t0
    assert sorted(got) == [0, 2] and wall < 0.3 + 1.0
    (e,) = scan.quarantine.entries
    assert (e["unit"], e["row_group"], e["error"]) == \
        (1, 1, "DeadlineExceededError")
    assert st.units_quarantined == 1 and st.deadline_exceeded == 1
    for k, out in got.items():
        np.testing.assert_array_equal(unit_values(out),
                                      np.arange(k * N, (k + 1) * N))


class _SteadyClock:
    """A scan module's ``time`` whose ``monotonic`` moves one microsecond
    a call (all else is the real module).  The deadline error's text
    carries the elapsed time rounded to milliseconds, so on the wall
    clock a pause of half a millisecond before the first check (a full
    garbage collection, a preempted worker on a loaded box) changes one
    side's text; on this clock both read ``elapsed_s=0.0``."""

    def __init__(self):
        self._t = 1000.0

    def monotonic(self) -> float:
        self._t += 1e-6
        return self._t

    def __getattr__(self, name):
        return getattr(time, name)


def test_scan_deadline_stops_between_units_resumable(tmp_path,
                                                     monkeypatch):
    import tpuparquet.shard.scan as jax_scan_mod
    import tpuparquet_torch.shard.scan as port_scan_mod

    for mod in (port_scan_mod, jax_scan_mod):
        monkeypatch.setattr(mod, "time", _SteadyClock())
    p = tmp_path / "f.parquet"
    write_file(p)
    errs = []
    for cls, kw in ((ShardedScan, {"mesh": _mesh()}), (JaxShardedScan, {})):
        scan = cls([str(p)], scan_deadline=1e-9, **kw)
        with pytest.raises(Exception, match="resume") as ei:
            scan.run()
        errs.append((type(ei.value).__name__, str(ei.value),
                     scan.state()))
    assert errs[0] == errs[1]
    assert errs[0][0] == "DeadlineExceededError"
    scan2 = ShardedScan([str(p)], mesh=_mesh(), resume=errs[0][2])
    got = dict(scan2.run_iter())
    assert sorted(got) == list(range(N_RG))


def test_scan_deadline_flushes_the_checkpoint(tmp_path):
    from tpuparquet_torch.shard.scan import load_cursor_file

    p = tmp_path / "f.parquet"
    write_file(p)
    ckpt = str(tmp_path / "c.ckpt")
    with collect_stats() as st:
        scan = ShardedScan([str(p)], mesh=_mesh(), scan_deadline=1e-9,
                           resume_from=ckpt)
        it = scan.run_iter()
        with pytest.raises(port_errors.DeadlineExceededError):
            # the first check runs before any unit; this run has a cursor
            # at 0 and nothing to flush, so no checkpoint is written yet
            next(it)
    assert st.deadline_exceeded == 1
    scan = ShardedScan([str(p)], mesh=_mesh(), resume_from=ckpt)
    it = scan.run_iter()
    next(it)
    scan._run_t0, scan.scan_deadline = time.monotonic() - 1.0, 0.5
    with pytest.raises(port_errors.DeadlineExceededError, match="1/3"):
        next(it)
    assert load_cursor_file(ckpt)["next_unit"] == 1


def test_unit_deadline_env_default_only_in_quarantine(monkeypatch,
                                                      tmp_path):
    p = tmp_path / "f.parquet"
    write_file(p)
    monkeypatch.setenv("TPQ_UNIT_DEADLINE_S", "2.5")
    assert ShardedScan([str(p)], mesh=_mesh()).unit_deadline is None
    s = ShardedScan([str(p)], mesh=_mesh(), on_error="quarantine")
    assert s.unit_deadline == 2.5
    assert JaxShardedScan([str(p)], on_error="quarantine").unit_deadline \
        == 2.5
    with pytest.raises(ValueError, match="quarantine"):
        ShardedScan([str(p)], mesh=_mesh(), unit_deadline=1.0)


def test_dispatch_deadline_error_classes():
    assert issubclass(port_errors.DispatchDeadlineError,
                      port_errors.DeviceDispatchError)
    assert issubclass(port_errors.DeadlineExceededError,
                      port_errors.TransientIOError)
