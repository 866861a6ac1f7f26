"""The port's fault layer against the JAX package's, on the CPU.

The same files (written by the JAX writer from a numpy seed) go through
both packages under the same injected faults, each package with its own
injector: transient reads retried, persistent failures and corruption
quarantined with their coordinates, a failing dispatch retried and then
degraded to the host decode, a torn footer quarantining its file.  Equal
(tolerance 0): every surviving unit's buffers, the fault counters, the
``QuarantineReport`` entries, and the cursor files with a quarantine,
byte for byte.  A degraded unit equals the healthy read.  The port's own
parts follow: the error taxonomy, the backoff schedule, the site
registry, a kernel build failure that no ladder may hide, chaos
invariance and a hang released by its scope.
"""

from __future__ import annotations

import io
import re
from pathlib import Path

import numpy as np
import pytest
import torch

import tpuparquet.faults as jax_faults
from tpuparquet import errors as jax_errors
from tpuparquet import CompressionCodec as JaxCodec
from tpuparquet import FileReader as JaxFileReader
from tpuparquet import FileWriter as JaxFileWriter
from tpuparquet.cpu.plain import ByteArrayColumn as JaxByteArrayColumn
from tpuparquet.kernels import device as jax_device
from tpuparquet.shard import MultiHostScan as JaxMultiHostScan
from tpuparquet.shard import ShardedScan as JaxShardedScan
from tpuparquet.stats import collect_stats as jax_collect_stats
from tpuparquet_torch import errors as port_errors
from tpuparquet_torch import faults as port_faults
from tpuparquet_torch.io.reader import FileReader
from tpuparquet_torch.kernels import device as port_device
from tpuparquet_torch.kernels.device import device_column_from_jax_numpy
from tpuparquet_torch.shard import MultiHostScan, ShardedScan, make_mesh
from tpuparquet_torch.shard import scan as port_scan
from tpuparquet_torch.stats import collect_stats

from test_torch_read import _jax_buffers  # noqa: E402

FAULT_COUNTERS = ("faults_injected", "io_retries", "dispatch_retries",
                  "pages_degraded", "units_degraded", "units_quarantined",
                  "files_quarantined", "deadline_exceeded",
                  "hedges_issued", "hedges_won")
READ_COUNTERS = ("chunks", "pages", "values", "bytes_compressed",
                 "pages_crc_verified", "crc_mismatches", "bytes_staged")
COUNTERS = FAULT_COUNTERS + READ_COUNTERS
REPO = Path(__file__).resolve().parents[1]


@pytest.fixture(autouse=True)
def _fast_backoff(monkeypatch):
    """Millisecond backoff, so retries do not sleep for real."""
    monkeypatch.setenv("TPQ_RETRY_BASE_S", "0.0005")
    monkeypatch.setenv("TPQ_RETRY_MAX_S", "0.002")


def make_file(n_rg: int = 3, n: int = 500, codec=JaxCodec.SNAPPY,
              **kw) -> bytes:
    """The reference's fault-test file: int64 ``a`` and an optional
    string ``s``, ``n`` rows a row group."""
    buf = io.BytesIO()
    w = JaxFileWriter(
        buf, "message m { required int64 a; optional binary s (STRING); }",
        codec=codec, max_row_group_size=n, **kw)
    for rg in range(n_rg):
        mask = (np.arange(n) % 7) != 0
        w.write_columns(
            {"a": np.arange(rg * n, rg * n + n, dtype=np.int64),
             "s": JaxByteArrayColumn.from_list(
                 [b"s%d" % (rg * n + i) for i in range(int(mask.sum()))])},
            masks={"s": mask})
    w.close()
    return buf.getvalue()


def corrupt_unit(data: bytes, rg: int) -> bytes:
    """One byte of row group ``rg``'s first chunk flipped mid-payload."""
    buf = bytearray(data)
    cm = JaxFileReader(io.BytesIO(data)).meta.row_groups[rg] \
        .columns[0].meta_data
    buf[cm.data_page_offset + cm.total_compressed_size // 2] ^= 0xFF
    return bytes(buf)


def _mesh():
    return make_mesh(2, devices=["cpu"] * 2)


def _counters(st) -> dict:
    return {k: getattr(st, k) for k in COUNTERS}


def assert_unit_same(ours: dict, theirs: dict, where="") -> None:
    """One unit of each package, buffer for buffer."""
    assert ours.keys() == theirs.keys(), where
    for name, col in ours.items():
        want = device_column_from_jax_numpy(_jax_buffers(theirs[name]))
        at = f"{where} {name}"
        assert (col.ptype, col.num_values, col.n_packed, col.n_bytes) == (
            want.ptype, want.num_values, want.n_packed, want.n_bytes), at
        a, b = col.padded_buffers(), want.padded_buffers()
        assert a.keys() == b.keys(), at
        for k in a:
            np.testing.assert_array_equal(a[k], b[k], err_msg=f"{at} {k}")


def assert_values_same(ours: dict, theirs: dict, where="") -> None:
    """One unit of each package, value for value (``to_numpy``): a
    degraded unit against a healthy one."""
    for name, col in ours.items():
        v, r, d = col.to_numpy()
        jv, jr, jd = theirs[name].to_numpy()
        np.testing.assert_array_equal(d, jd, err_msg=f"{where} {name}")
        if isinstance(jv, JaxByteArrayColumn):
            np.testing.assert_array_equal(v.offsets, jv.offsets)
            np.testing.assert_array_equal(v.data, jv.data)
        else:
            np.testing.assert_array_equal(np.asarray(v), np.asarray(jv),
                                          err_msg=f"{where} {name}")


def scan_both(src_for, rules=(), *, run_iter=False, **kw):
    """One scan in each package over ``src_for(package)`` sources under
    the same injected rules: ``(port results, port scan, port counters,
    JAX results, JAX scan, JAX counters)``; results are ``{unit: cols}``
    with ``run_iter``, else the list of ``run()``."""
    out = []
    for pkg in ("port", "jax"):
        faults = port_faults if pkg == "port" else jax_faults
        stats = collect_stats if pkg == "port" else jax_collect_stats
        cls = ShardedScan if pkg == "port" else JaxShardedScan
        extra = {"mesh": _mesh()} if pkg == "port" else {}
        with stats() as st, faults.inject_faults() as inj:
            for site, kind, rkw in rules:
                inj.inject(site, kind, **rkw)
            with cls(src_for(pkg), **extra, **kw) as s:
                res = dict(s.run_iter()) if run_iter else s.run()
        out += [res, s, _counters(st)]
    return out


# ----------------------------------------------------------------------
# taxonomy, retry, registry
# ----------------------------------------------------------------------

def test_taxonomy_as_reference():
    for name in ("TransientIOError", "DeviceDispatchError",
                 "DeadlineExceededError", "DispatchDeadlineError"):
        ours, theirs = getattr(port_errors, name), getattr(jax_errors, name)
        assert [c.__name__ for c in ours.__mro__] == \
            [c.__name__ for c in theirs.__mro__], name
    assert [c.__name__ for c in port_errors.QUARANTINE_ERRORS] == \
        [c.__name__ for c in jax_errors.QUARANTINE_ERRORS]
    e = port_errors.DispatchDeadlineError("x", elapsed=0.12345, budget=0.1,
                                          site="s", row_group=2)
    j = jax_errors.DispatchDeadlineError("x", elapsed=0.12345, budget=0.1,
                                         site="s", row_group=2)
    assert e.coordinates() == j.coordinates() and str(e) == str(j)
    assert port_errors.never_quarantine(RecursionError())
    assert not port_errors.never_quarantine(RuntimeError())


@pytest.mark.parametrize("name", ["KernelBuildError", "KernelLaunchError"])
def test_kernel_build_error_is_never_quarantined(name):
    from tpuparquet_torch import _build
    from tpuparquet_torch.kernels import _lib

    cls = getattr(port_errors, name)
    assert issubclass(cls, RuntimeError)
    assert _build.KernelBuildError is port_errors.KernelBuildError
    assert getattr(_lib, name) is cls
    assert port_errors.never_quarantine(cls("nvcc"))


@pytest.mark.parametrize("kw", [
    {"retries": 5, "base": 0.01, "cap": 0.05}, {"retries": 0},
    {"retries": 3, "base": 0.01, "cap": 1.0, "jitter": 0.5, "seed": 7},
    {}])
def test_backoff_as_reference(kw):
    assert port_faults.backoff_delays(**kw) == \
        jax_faults.backoff_delays(**kw)


@pytest.mark.parametrize("fails,exc", [(2, "transient"), (9, "transient"),
                                       (1, "missing"), (1, "eio")])
def test_retry_transient_as_reference(fails, exc):
    """Retried to success, exhausted, a permanent error at once, an
    EIO OSError retried: the same calls, sleeps, counts and errors."""
    got = []
    for faults, errors, stats in (
            (port_faults, port_errors, collect_stats),
            (jax_faults, jax_errors, jax_collect_stats)):
        calls, slept = [], []

        def fn():
            calls.append(1)
            if len(calls) <= fails:
                if exc == "missing":
                    raise FileNotFoundError("gone")
                if exc == "eio":
                    raise OSError(5, "eio")
                raise errors.TransientIOError("flaky")
            return "ok"

        with stats() as st:
            try:
                out = faults.retry_transient(fn, retries=3, base=0.01,
                                             cap=0.02, sleep=slept.append)
            except OSError as e:
                out = type(e).__name__
        got.append((out, len(calls), slept, st.io_retries))
    assert got[0] == got[1]


def test_sites_are_the_reference_sites():
    """Every registered site is the reference's, with its kinds, and is
    instrumented in the port's sources."""
    src = "\n".join(p.read_text() for p in
                    (REPO / "tpuparquet_torch").rglob("*.py")
                    if p.name != "faults.py")
    assert port_faults.SITES == jax_faults.SITES
    for site, kinds in port_faults.SITES.items():
        assert jax_faults.SITES[site] == kinds, site
        assert re.search(rf'"{re.escape(site)}"', src), site


# ----------------------------------------------------------------------
# the injection matrix
# ----------------------------------------------------------------------

def _paths(tmp_path, data: bytes, name="t.parquet"):
    path = tmp_path / name
    path.write_bytes(data)
    return lambda pkg: [str(path)]


def _blobs(*datas):
    return lambda pkg: [d if pkg == "port" else io.BytesIO(d)
                        for d in datas]


def test_transient_read_retried_to_success(tmp_path):
    src = _paths(tmp_path, make_file())
    ours, _, st, theirs, _, jst = scan_both(
        src, [("io.reader.chunk_read", "transient", {"times": 2})])
    assert st == jst
    assert st["io_retries"] == 2 and st["faults_injected"] == 2
    assert len(ours) == len(theirs) == 3
    for k in range(3):
        assert_unit_same(ours[k], theirs[k], f"unit {k}")


def test_in_memory_chunk_read_is_not_retried():
    """An in-memory source's chunk view is not retried, in either
    package: the transient fault quarantines its unit."""
    ours, s, st, theirs, js, jst = scan_both(
        _blobs(make_file()), [("io.reader.chunk_read", "transient", {})],
        on_error="quarantine")
    assert st == jst and st["io_retries"] == 0
    assert s.quarantine.as_dicts() == js.quarantine.as_dicts()
    assert s.quarantine.units() == [0]


def test_persistent_oserror_quarantines(tmp_path):
    src = _paths(tmp_path, make_file())
    ours, s, st, theirs, js, jst = scan_both(
        src, [("io.reader.chunk_read", "oserror", {"times": 1000})],
        on_error="quarantine")
    assert ours == [] and theirs == []
    assert st == jst and st["units_quarantined"] == 3
    assert s.quarantine.as_dicts() == js.quarantine.as_dicts()
    assert all(e["error"] == "OSError" for e in s.quarantine.entries)


def _read_port(reader, rg: int = 0):
    return port_device.read_row_group_device(reader, rg, device="cpu")


def _read_jax(reader, rg: int = 0):
    return jax_device.read_row_group_device(reader, rg)


def test_decode_errors_carry_coordinates():
    data = bytearray(make_file(n_rg=2))
    cm = JaxFileReader(io.BytesIO(bytes(data))).meta.row_groups[1] \
        .columns[0].meta_data
    data[cm.data_page_offset + cm.total_compressed_size // 2] ^= 0xFF
    errs = []
    for read, reader in ((_read_port, FileReader(bytes(data))),
                         (_read_jax, JaxFileReader(io.BytesIO(bytes(data))))):
        with pytest.raises(ValueError) as ei:
            for rg in range(2):
                read(reader, rg)
        errs.append((type(ei.value).__name__, str(ei.value)))
        assert (ei.value.row_group, ei.value.column) == (1, "a")
        assert ei.value.page is not None
    assert errs[0] == errs[1]


def test_raise_mode_still_raises():
    data = make_file()
    with port_faults.inject_faults() as inj:
        inj.inject("kernels.device.page_payload", "corrupt", times=1)
        r = FileReader(data)
        with pytest.raises(ValueError):
            for rg in range(r.row_group_count()):
                _read_port(r, rg)


@pytest.mark.parametrize("site", ["io.reader.chunk_read",
                                  "kernels.device.page_payload"])
@pytest.mark.parametrize("kind", ["corrupt", "truncate"])
def test_device_path_corruption_is_clean_and_typed(site, kind):
    data = make_file(n_rg=1)
    errs = []
    for faults, read, reader in (
            (port_faults, _read_port, FileReader(data)),
            (jax_faults, _read_jax, JaxFileReader(io.BytesIO(data)))):
        with faults.inject_faults() as inj:
            inj.inject(site, kind, times=1)
            with pytest.raises((ValueError, EOFError)) as ei:
                read(reader)
        e = ei.value
        errs.append((type(e).__name__, str(e),
                     getattr(e, "coordinates", dict)()))
        if isinstance(e, port_errors.ScanError):
            assert e.column is not None and e.row_group == 0
    assert errs[0] == errs[1]


@pytest.mark.parametrize("rule", [
    {"match": {"column": "s"}, "times": 1},
    {"times": 1, "after": 3},
])
def test_corruption_quarantined_with_coordinates(rule):
    data = make_file()
    ours, s, st, theirs, js, jst = scan_both(
        _blobs(data), [("kernels.device.page_payload", "corrupt", rule)],
        run_iter=True, on_error="quarantine")
    assert st == jst and st["units_quarantined"] == 1
    assert s.quarantine.as_dicts() == js.quarantine.as_dicts()
    e = s.quarantine.entries[0]
    assert e["error"] == "CorruptPageError" and "page" in e
    assert sorted(ours) == sorted(theirs) and len(ours) == 2
    for k in ours:
        assert_unit_same(ours[k], theirs[k], f"unit {k}")


def test_page_dispatch_fault_degrades_every_unit():
    data = make_file(n_rg=2)
    ours, s, st, theirs, js, jst = scan_both(
        _blobs(data),
        [("kernels.device.page_dispatch", "dispatch", {"times": 10_000})],
        on_error="quarantine")
    assert st == jst
    assert len(ours) == 2 and not s.quarantine
    assert st["units_degraded"] == 2 and st["dispatch_retries"] > 0
    # the failed attempts add only their faults: the pages counted are
    # the host attempts', every one degraded
    assert st["pages_degraded"] == st["pages"] > 0
    healthy = dict(jax_device.read_row_groups_device(
        JaxFileReader(io.BytesIO(data))))
    for k in range(2):
        assert_unit_same(ours[k], theirs[k], f"unit {k}")
        assert_values_same(ours[k], healthy[k], f"unit {k} healthy")


@pytest.mark.parametrize("times,degraded", [(1, 0), (3, 1)])
def test_unit_dispatch_retried_then_degraded(times, degraded):
    """``times`` failures on the second unit: retried with 2 retries
    (dispatch_retries), degraded once they are used up."""
    data = make_file(n_rg=3)
    ours, s, st, theirs, js, jst = scan_both(
        _blobs(data), [("kernels.device.unit_dispatch", "dispatch",
                        {"times": times, "after": 1})],
        on_error="quarantine", retries=2)
    assert st == jst
    assert st["dispatch_retries"] == min(times, 2)
    assert st["units_degraded"] == degraded
    assert len(ours) == 3 and not s.quarantine
    for k in range(3):
        assert_unit_same(ours[k], theirs[k], f"unit {k}")


def test_retries_do_not_inflate_counters():
    """A unit that retried twice and degraded counts its pages, values
    and chunks once; the failed attempts add only their faults."""
    data = make_file(n_rg=1)
    got = []
    for faults, stats, read, reader in (
            (port_faults, collect_stats,
             lambda r, **kw: port_device.read_row_group_device_resilient(
                 r, 0, device="cpu", **kw), FileReader(data)),
            (jax_faults, jax_collect_stats,
             lambda r, **kw: jax_device.read_row_group_device_resilient(
                 r, 0, **kw), JaxFileReader(io.BytesIO(data)))):
        with stats() as clean:
            read(reader)
        with stats() as st, faults.inject_faults() as inj:
            inj.inject("kernels.device.unit_dispatch", "dispatch",
                       times=10_000)
            out = read(reader, retries=2, sleep=lambda s: None)
        assert st.units_degraded == 1 and st.dispatch_retries == 2
        assert st.faults_injected == 3
        for k in ("pages", "values", "chunks", "pages_crc_verified"):
            assert getattr(st, k) == getattr(clean, k), k
        assert st.pages_degraded == st.pages
        got.append((_counters(st), _counters(clean), out))
    assert got[0][0] == got[1][0] and got[0][1] == got[1][1]
    assert_unit_same(got[0][2], got[1][2])


@pytest.mark.parametrize("name", ["KernelBuildError", "KernelLaunchError"])
def test_kernel_build_failure_is_not_retried_or_degraded(monkeypatch, name):
    """A kernel that does not build, or whose launch returns a CUDA
    error, raises through the ladder at once: no retry, no host decode,
    no quarantine."""
    cls = getattr(port_errors, name)
    calls = []

    def broken(*a, **kw):
        calls.append(1)
        raise cls("tpq_unpack_u32 failed: cudaError 1")

    monkeypatch.setattr(port_device, "read_row_group_device", broken)
    with collect_stats() as st:
        with pytest.raises(cls):
            port_device.read_row_group_device_resilient(
                FileReader(make_file(n_rg=1)), 0, device="cpu",
                sleep=lambda s: None)
        with pytest.raises(cls):
            ShardedScan([make_file(n_rg=1)], mesh=_mesh(),
                        on_error="quarantine").run()
    assert len(calls) == 2
    assert st.dispatch_retries == st.units_degraded == 0
    assert st.units_quarantined == 0


def test_other_runtime_errors_are_not_degraded(monkeypatch):
    """Only a failed dispatch takes the ladder: any other RuntimeError
    (here out of memory) is not retried and never decodes on the host;
    a quarantining scan absorbs it as the unit's error."""
    calls = []
    real = port_device.read_row_group_device

    def oom(reader, rg_index, **kw):
        calls.append(rg_index)
        if rg_index == 1:
            raise torch.OutOfMemoryError("CUDA out of memory")
        return real(reader, rg_index, **kw)

    monkeypatch.setattr(port_device, "read_row_group_device", oom)
    data = make_file(n_rg=3)
    with collect_stats() as st:
        with pytest.raises(torch.OutOfMemoryError):
            port_device.read_row_group_device_resilient(
                FileReader(data), 1, device="cpu", retries=2,
                sleep=lambda s: None)
        assert calls == [1]
        with ShardedScan([data], mesh=_mesh(), on_error="quarantine",
                         retries=2) as s:
            out = s.run()
    assert st.dispatch_retries == st.units_degraded == 0
    assert st.pages_degraded == 0 and st.units_quarantined == 1
    assert len(out) == 2 and s.quarantine.units() == [1]
    assert [e["error"] for e in s.quarantine.entries] == \
        ["OutOfMemoryError"]


@pytest.mark.parametrize("site,kind", [("format.footer.tail", "corrupt"),
                                       ("format.footer.blob", "corrupt"),
                                       ("format.footer.blob", "truncate"),
                                       ("io.reader.open", "oserror")])
def test_open_failure_quarantines_the_file(tmp_path, site, kind):
    """The second file fails to open: a file-level entry (with its path)
    and ``files_quarantined``; the first file's units decode."""
    a, b = tmp_path / "a.parquet", tmp_path / "b.parquet"
    a.write_bytes(make_file(n_rg=2))
    b.write_bytes(make_file(n_rg=2))
    rule = {"times": 1000, "match": {"file": str(b)}} \
        if site == "io.reader.open" else {"times": 1, "after": 1}
    ours, s, st, theirs, js, jst = scan_both(
        lambda pkg: [str(a), str(b)], [(site, kind, rule)],
        on_error="quarantine")
    assert st == jst and st["files_quarantined"] == 1
    assert s.quarantine.as_dicts() == js.quarantine.as_dicts()
    assert s.quarantine.files() == [1] and len(ours) == 2
    for k in range(2):
        assert_unit_same(ours[k], theirs[k], f"unit {k}")


def test_open_transient_retried(tmp_path):
    src = _paths(tmp_path, make_file(n_rg=2))
    ours, s, st, theirs, js, jst = scan_both(
        src, [("io.reader.open", "transient", {"times": 2})])
    assert st == jst and st["io_retries"] == 2 and len(ours) == 2


def test_open_failure_raises_without_quarantine():
    for scan, faults in ((lambda d: ShardedScan([d], mesh=_mesh()),
                          port_faults),
                         (lambda d: JaxShardedScan([io.BytesIO(d)]),
                          jax_faults)):
        with faults.inject_faults() as inj:
            inj.inject("format.footer.tail", "corrupt")
            with pytest.raises(ValueError, match="magic"):
                scan(make_file(n_rg=1))


def test_page_write_fault_changes_no_byte():
    """``io.pages.page_write`` firing on every data page: both writers
    write the bytes of an un-faulted write and count the faults."""
    from tpuparquet_torch.cpu.plain import ByteArrayColumn
    from tpuparquet_torch.io.writer import FileWriter

    def write(cls, bac, faults):
        buf = io.BytesIO()
        w = cls(buf, "message m { required int64 a; optional binary s "
                "(STRING); }")
        mask = np.arange(300) % 3 != 0
        items = [b"x%d" % i for i in range(int(mask.sum()))]
        offs = np.zeros(len(items) + 1, dtype=np.int64)
        np.cumsum([len(b) for b in items], out=offs[1:])
        w.write_columns({"a": np.arange(300, dtype=np.int64),
                         "s": bac(offs, np.frombuffer(b"".join(items),
                                                      np.uint8))},
                        masks={"s": mask})
        w.close()
        return buf.getvalue()

    got = []
    for cls, bac, faults, stats in (
            (FileWriter, ByteArrayColumn, port_faults, collect_stats),
            (JaxFileWriter, JaxByteArrayColumn, jax_faults,
             jax_collect_stats)):
        clean = write(cls, bac, faults)
        with stats() as st, faults.inject_faults() as inj:
            inj.inject("io.pages.page_write", "transient", times=1000)
            faulted = write(cls, bac, faults)
        assert faulted == clean
        got.append((clean, st.faults_injected))
    # the JAX writer's default files carry a salvage hint the port's do
    # not write (ROADMAP A.12), so only the counts compare across
    assert got[0][1] == got[1][1] == 2


# ----------------------------------------------------------------------
# quarantine semantics: cursors, resume, multi-process
# ----------------------------------------------------------------------

def test_quarantine_continues_and_identifies():
    data = corrupt_unit(make_file(n_rg=4), 2)
    ours, s, st, theirs, js, jst = scan_both(
        _blobs(data), run_iter=True, on_error="quarantine")
    assert st == jst and sorted(ours) == [0, 1, 3]
    assert s.quarantine.as_dicts() == js.quarantine.as_dicts()
    e = s.quarantine.entries[0]
    assert e["row_group"] == 2 and e["column"] == "a"
    for k in ours:
        assert_unit_same(ours[k], theirs[k], f"unit {k}")


def test_cursor_files_with_quarantine_byte_equal(tmp_path):
    """Checkpoints of both packages' quarantining scans, every unit and
    at the end: byte-equal files; each resumes from the other's."""
    data = corrupt_unit(make_file(n_rg=4), 1)
    files = {}
    for pkg, cls, kw in (("port", ShardedScan, {"mesh": _mesh()}),
                         ("jax", JaxShardedScan, {})):
        path = str(tmp_path / f"{pkg}.ckpt")
        src = data if pkg == "port" else io.BytesIO(data)
        with cls([src], on_error="quarantine", resume_from=path,
                 checkpoint_every=1, **kw) as s:
            it = s.run_iter()
            assert [next(it)[0], next(it)[0]] == [0, 2]
            it.close()
            s.cursor_save()
        files[pkg] = Path(path).read_bytes()
    assert files["port"] == files["jax"]
    cur = port_scan.load_cursor_file(str(tmp_path / "jax.ckpt"))
    assert cur["next_unit"] == 3
    assert [e["unit"] for e in cur["quarantine"]] == [1]
    with ShardedScan([data], mesh=_mesh(), on_error="quarantine",
                     resume_from=str(tmp_path / "jax.ckpt")) as s2:
        assert [k for k, _ in s2.run_iter()] == [3]
        assert s2.quarantine.units() == [1]
    assert Path(tmp_path / "jax.ckpt").read_bytes() != files["jax"]


def test_cursor_resumes_past_quarantined():
    data = corrupt_unit(make_file(n_rg=4), 1)
    curs = []
    for cls, src, kw in ((ShardedScan, data, {"mesh": _mesh()}),
                         (JaxShardedScan, io.BytesIO(data), {})):
        with cls([src], on_error="quarantine", **kw) as s:
            it = s.run_iter()
            assert next(it)[0] == 0 and next(it)[0] == 2
            curs.append(s.state())
    assert curs[0] == curs[1] and curs[0]["next_unit"] == 3
    with ShardedScan([data], mesh=_mesh(), on_error="quarantine",
                     resume=curs[1]) as s2:
        assert [k for k, _ in s2.run_iter()] == [3]
        assert s2.quarantine.units() == [1]


def test_resume_does_not_list_a_bad_file_twice(tmp_path):
    a, b = tmp_path / "a.parquet", tmp_path / "b.parquet"
    a.write_bytes(make_file(n_rg=2))
    b.write_bytes(make_file(n_rg=2)[:-3])  # a torn footer
    srcs = [str(a), str(b)]
    with ShardedScan(srcs, mesh=_mesh(), on_error="quarantine") as s:
        it = s.run_iter()
        next(it)
        cur = s.state()
    with JaxShardedScan(srcs, on_error="quarantine") as js:
        jt = js.run_iter()
        next(jt)
        assert js.state() == cur
    with ShardedScan(srcs, mesh=_mesh(), on_error="quarantine",
                     resume=cur) as s2:
        assert len(s2.quarantine) == 1 and s2.quarantine.files() == [1]


@pytest.mark.parametrize("kw,match", [
    ({"on_error": "ignore"}, "on_error must be"),
    ({"unit_deadline": 1.0}, "requires on_error='quarantine'")])
def test_invalid_arguments_rejected_as_reference(kw, match):
    data = make_file(n_rg=1)
    with pytest.raises(ValueError) as ours:
        ShardedScan([data], mesh=_mesh(), **kw)
    with pytest.raises(ValueError) as theirs:
        JaxShardedScan([io.BytesIO(data)], **kw)
    assert str(ours.value) == str(theirs.value)
    assert re.search(match, str(ours.value))


def test_multihost_single_process_quarantine(tmp_path):
    """One process of each package's MultiHostScan over a file with a
    corrupt unit: the same survivors, fleet entries, cursor and per-host
    checkpoint file, byte for byte."""
    data = corrupt_unit(make_file(n_rg=3), 0)
    base, jbase = str(tmp_path / "port"), str(tmp_path / "jax")
    s = MultiHostScan([data], mesh=_mesh(), on_error="quarantine",
                      resume_from=base, checkpoint_every=1)
    js = JaxMultiHostScan([io.BytesIO(data)], on_error="quarantine",
                          resume_from=jbase, checkpoint_every=1)
    got, want = dict(s.run_iter()), dict(js.run_iter())
    assert sorted(got) == sorted(want) == [1, 2]
    assert s.allgather_quarantine() == js.allgather_quarantine()
    fleet = s.allgather_quarantine()
    assert len(fleet) == 1 and fleet[0]["process_index"] == 0
    assert s.state() == js.state()
    assert Path(base + ".p0").read_bytes() == Path(jbase + ".p0").read_bytes()
    for k in got:
        assert_unit_same(got[k], want[k], f"unit {k}")


def test_fleet_counters_fold_the_fault_layer():
    from tpuparquet_torch.shard.distributed import allgather_stats
    from tpuparquet_torch.stats import DecodeStats

    data = corrupt_unit(make_file(n_rg=3), 1)
    with collect_stats() as st:
        with ShardedScan([data], mesh=_mesh(),
                         on_error="quarantine") as s:
            s.run()
    fleet = allgather_stats(st)
    assert fleet.units_quarantined == 1
    back = DecodeStats.from_state(st.to_state())
    for k in FAULT_COUNTERS:
        assert k in st.to_state() and getattr(back, k) == getattr(st, k)


# ----------------------------------------------------------------------
# coverage: the crash corpus and a mutation fuzz, quarantined
# ----------------------------------------------------------------------

CRASH_DIR = REPO / "tests" / "corpus" / "crash"


@pytest.mark.parametrize("name", sorted(
    p.name for p in CRASH_DIR.glob("*.bin")))
def test_crash_corpus_never_escapes_quarantine(name):
    data = (CRASH_DIR / name).read_bytes()
    s = ShardedScan([data], mesh=_mesh(), on_error="quarantine")
    res = s.run()  # must not raise
    js = JaxShardedScan([io.BytesIO(data)], on_error="quarantine")
    jres = js.run()
    assert len(res) == len(jres)
    key = port_faults.QuarantineReport.entry_key
    assert [key(e) for e in s.quarantine.entries] == \
        [key(e) for e in js.quarantine.entries]


def test_mutation_fuzz_never_wrong_only_fewer():
    raw = make_file(n_rg=3, n=400)
    exp = dict(jax_device.read_row_groups_device(
        JaxFileReader(io.BytesIO(raw))))
    footer_len = int.from_bytes(raw[-8:-4], "little")
    data_end = len(raw) - 8 - footer_len
    rng = np.random.default_rng(1234)
    quarantined = 0
    for trial in range(12):
        bad = bytearray(raw)
        for _ in range(int(rng.integers(1, 4))):
            bad[int(rng.integers(4, data_end))] ^= int(rng.integers(1, 256))
        with ShardedScan([bytes(bad)], mesh=_mesh(),
                         on_error="quarantine") as s:
            got = dict(s.run_iter())
        with JaxShardedScan([io.BytesIO(bytes(bad))],
                            on_error="quarantine") as js:
            want = dict(js.run_iter())
        assert sorted(got) == sorted(want), trial
        assert len(got) + len(s.quarantine) == 3, trial
        quarantined += len(s.quarantine)
        for k, out in got.items():
            assert_values_same(out, exp[k], f"trial {trial} unit {k}")
    assert quarantined > 0


# ----------------------------------------------------------------------
# the degraded decode
# ----------------------------------------------------------------------

@pytest.mark.parametrize("codec,v2,allow_dict", [
    (JaxCodec.UNCOMPRESSED, False, True),
    (JaxCodec.SNAPPY, False, False),
    (JaxCodec.SNAPPY, True, True),
    (JaxCodec.GZIP, True, False),
])
def test_forced_host_decode_as_reference(codec, v2, allow_dict):
    """Every column of a mixed table read under ``cpu_fallback_values``:
    the port's degraded buffers equal the reference's, the values equal
    the healthy read's, and every data page counts as degraded."""
    rng = np.random.default_rng(42)
    n = 800
    buf = io.BytesIO()
    w = JaxFileWriter(
        buf, "message m { required int64 a; optional int32 b; "
        "optional binary s (STRING); required double x; "
        "required boolean f; }",
        codec=codec, data_page_v2=v2, allow_dict=allow_dict)
    bm = rng.random(n) >= 0.3
    sm = rng.random(n) >= 0.2
    w.write_columns(
        {"a": rng.integers(-(2**50), 2**50, n),
         "b": rng.integers(0, 9, int(bm.sum())).astype(np.int32),
         "s": JaxByteArrayColumn.from_list(
             [b"w%d" % (i % 23) for i in range(int(sm.sum()))]),
         "x": rng.random(n), "f": rng.random(n) >= 0.5},
        masks={"b": bm, "s": sm})
    w.close()
    data = buf.getvalue()
    with collect_stats() as st, port_device.cpu_fallback_values():
        ours = port_device.read_row_group_device(FileReader(data), 0,
                                                 device="cpu")
    with jax_collect_stats() as jst, jax_device.cpu_fallback_values():
        theirs = jax_device.read_row_group_device(
            JaxFileReader(io.BytesIO(data)), 0)
    assert st.pages_degraded == st.pages > 0
    assert _counters(st) == _counters(jst)
    assert_unit_same(ours, theirs)
    healthy = port_device.read_row_group_device(FileReader(data), 0,
                                                device="cpu")
    for name, col in ours.items():
        v, _, d = col.to_numpy()
        hv, _, hd = healthy[name].to_numpy()
        np.testing.assert_array_equal(d, hd, err_msg=name)
        if hasattr(v, "offsets"):
            assert v == hv, name
        else:
            np.testing.assert_array_equal(v, hv, err_msg=name)


def test_degraded_mode_reaches_the_plan_workers(monkeypatch):
    """``pipelined_reads`` plans on worker threads: the caller's degraded
    mode (thread-local) must reach them."""
    monkeypatch.setenv("TPQ_PLAN_THREADS", "3")
    data = make_file(n_rg=2)
    with collect_stats() as st, port_device.cpu_fallback_values():
        out = dict(port_device.read_row_groups_device(FileReader(data),
                                                      device="cpu"))
    assert st.pages_degraded == st.pages > 0 and len(out) == 2


# ----------------------------------------------------------------------
# chaos and hangs
# ----------------------------------------------------------------------

def test_chaos_changes_no_output():
    data = make_file(n_rg=3)
    with ShardedScan([data], mesh=_mesh()) as s:
        want = s.run()
    for seed in (1, 2):
        with port_faults.chaos_scope(seed) as ch:
            with ShardedScan([data], mesh=_mesh()) as s:
                got = s.run()
        assert ch.perturbations > 0
        for k in range(3):
            for name in want[k]:
                a = got[k][name].padded_buffers()
                b = want[k][name].padded_buffers()
                for key in a:
                    np.testing.assert_array_equal(a[key], b[key])
    with port_faults.chaos_scope(0):
        with pytest.raises(RuntimeError, match="nest"):
            with port_faults.chaos_scope(1):
                pass


def test_hang_released_when_its_scope_exits():
    import threading
    import time

    with port_faults.inject_faults() as inj:
        inj.inject("io.chunk.hang", "hang", seconds=30.0)
        t = threading.Thread(target=port_faults.fault_point,
                             args=("io.chunk.hang",))
        t0 = time.monotonic()
        t.start()
        time.sleep(0.05)
        assert t.is_alive()
    t.join(2.0)
    assert not t.is_alive() and time.monotonic() - t0 < 2.0
    assert inj.log == [{"site": "io.chunk.hang", "kind": "hang"}]
    with port_faults.inject_faults():
        with pytest.raises(RuntimeError, match="nest"):
            with port_faults.inject_faults():
                pass


def test_quarantine_report_as_reference():
    entries = [{"unit": 3, "file": 0, "row_group": 1, "error": "OSError",
                "message": "x"},
               {"unit": None, "file": 2, "row_group": None,
                "error": "CorruptFooterError", "message": "y",
                "offset": 9}]
    ours = port_faults.QuarantineReport.from_dicts(entries)
    theirs = jax_faults.QuarantineReport.from_dicts(entries)
    assert ours.as_dicts() == theirs.as_dicts()
    assert ours.summary() == theirs.summary()
    assert ours.units() == [3] and ours.files() == [2]
    assert ours.merge_unique(entries + [dict(entries[0], message="z")]) \
        == theirs.merge_unique(entries + [dict(entries[0], message="z")]) \
        == 0
    e = port_errors.CorruptPageError("bad", column="a", page=2, file="f")
    je = jax_errors.CorruptPageError("bad", column="a", page=2, file="f")
    assert ours.add(unit=1, file=0, row_group=0, error=e) == \
        theirs.add(unit=1, file=0, row_group=0, error=je)


# ----------------------------------------------------------------------
# chip_smoke.py's phase 8, rehearsed on the CPU
# ----------------------------------------------------------------------

def test_chip_smoke_phase8_on_the_cpu(monkeypatch):
    """Phase 8's checks (8a over phase 6's 1x1 results, 8b, 8c) on meshes
    of ``cpu`` slots at a small size: the plain versions launch nothing,
    so only the launch requirements are left out."""
    import sys

    sys.path.insert(0, str(REPO))
    import chip_smoke

    dev = torch.device("cpu")
    wrappers = chip_smoke.kernel_wrappers()
    one = chip_smoke.shard_meshes(dev)[0][1]
    blob, groups = chip_smoke.build_config2(400_000, 4)
    blob4, groups4 = chip_smoke.build_config4(400_000, 4)
    fixed2 = list(groups[0][0])
    c2 = chip_smoke.check_sharded_scan(
        "6a", one, blob, [(c, {"payment_type": m}) for c, m in groups],
        fixed2, [], dev, wrappers, 400_000)
    c4 = chip_smoke.check_sharded_scan("6b", one, blob4, groups4,
                                       ["fare", "tip"], ["vendor", "note"],
                                       dev, wrappers, 400_000)
    chip_smoke.check_consumer_meshes(
        "8a", one, [("config 2", c2, fixed2, []),
                    ("config 4", c4, ["fare", "tip"], ["vendor", "note"])],
        FileReader(blob), dev, wrappers)
    chip_smoke.check_resilient("8b", one, blob, c2["results"], dev,
                               wrappers, unit=2, budget=0.5)
    chip_smoke.time_resilient("8c", one, blob, dev, c2["run_s"])
    assert len(chip_smoke.LADDER_CHECKED) >= 2
