"""Remote byte-range sources and the tiered range caches, against the JAX
package.

Mirrors ``tests/test_remote.py`` class by class: URI resolution, the
coalescer, the source contract (short responses, the ``io.remote.*``
fault sites, the emulator's schedules and flight records), byte identity
of ``emu://`` reads against local ones (host, device and sharded, with
and without the caches, under injected and emulated faults), the tiered
cache's accounting, cache poisoning and remote resilience.  Each case
writes its files from a numpy seed, runs the same read through both
packages (each over a cache directory of its own) and compares buffers,
the remote and cache counters and error classes and words exactly.  One
case fills a cache directory with one package and reads it as hits with
the other.
"""

from __future__ import annotations

import json
import os
import shutil
from types import SimpleNamespace

import numpy as np
import pytest

import tpuparquet.io.rangecache as jax_rc
import tpuparquet.io.source as jax_src
from tpuparquet import FileWriter as JaxFileWriter
from tpuparquet import errors as jax_errors
from tpuparquet import faults as jax_faults
from tpuparquet.filter import col as jax_col
from tpuparquet.io import FileReader as JaxFileReader
from tpuparquet.kernels import device as jax_device
from tpuparquet.obs import recorder as jax_rec
from tpuparquet.shard import ShardedScan as JaxShardedScan
from tpuparquet.shard import gather_column as jax_gather_column
from tpuparquet.shard import make_mesh as jax_make_mesh
from tpuparquet.stats import collect_stats as jax_collect_stats
import tpuparquet_torch.io.rangecache as port_rc
import tpuparquet_torch.io.source as port_src
from tpuparquet_torch import errors as port_errors
from tpuparquet_torch import faults as port_faults
from tpuparquet_torch.filter import col as port_col
from tpuparquet_torch.io.reader import FileReader
from tpuparquet_torch.kernels import device as port_device
from tpuparquet_torch.kernels.device import device_column_from_jax_numpy
from tpuparquet_torch.obs import recorder as port_rec
from tpuparquet_torch.shard import ShardedScan, gather_column, make_mesh
from tpuparquet_torch.stats import collect_stats

from test_torch_read import _jax_buffers  # noqa: E402

SCHEMA = "message m { required int64 a; optional int32 b; }"

JAX = SimpleNamespace(
    name="jax", src=jax_src, rc=jax_rc, FileReader=JaxFileReader,
    collect_stats=jax_collect_stats, faults=jax_faults, errors=jax_errors,
    rec=jax_rec, device=jax_device, col=jax_col, ShardedScan=JaxShardedScan,
    gather_column=jax_gather_column, mesh=lambda: jax_make_mesh(2, sp=1),
    dev={})
PORT = SimpleNamespace(
    name="port", src=port_src, rc=port_rc, FileReader=FileReader,
    collect_stats=collect_stats, faults=port_faults, errors=port_errors,
    rec=port_rec, device=port_device, col=port_col, ShardedScan=ShardedScan,
    gather_column=gather_column,
    mesh=lambda: make_mesh(2, devices=["cpu"] * 2), dev={"device": "cpu"})
PKGS = (JAX, PORT)

REMOTE = ("remote_ranges_fetched", "ranges_coalesced", "remote_bytes",
          "remote_retry", "cache_hits_mem", "cache_misses_mem",
          "cache_evictions_mem", "cache_hits_disk", "cache_misses_disk",
          "cache_evictions_disk")
COUNTERS = REMOTE + ("faults_injected", "io_retries", "bytes_read",
                     "row_groups", "chunks", "pages", "values")


@pytest.fixture(autouse=True)
def _fresh(monkeypatch):
    """No tier singleton leaks between tests; millisecond backoff; no
    source knob from the environment."""
    for k in list(os.environ):
        if k.startswith(("TPQ_CACHE_", "TPQ_EMU_", "TPQ_HTTP_")) or k in (
                "TPQ_SOURCE", "TPQ_RANGE_COALESCE_GAP", "TPQ_PLAN_THREADS"):
            monkeypatch.delenv(k)
    monkeypatch.setenv("TPQ_RETRY_BASE_S", "0.0005")
    monkeypatch.setenv("TPQ_RETRY_MAX_S", "0.002")
    for P in PKGS:
        P.rc.reset_range_caches()
    yield
    for P in PKGS:
        P.rc.reset_range_caches()


def write_file(tmp_path, name="f0.parquet", rows=400, groups=2, seed=0):
    """The reference's test file: int64 ``a`` and an optional int32
    ``b`` (null every 7th row), ``groups`` row groups, from a seed."""
    p = str(tmp_path / name)
    rng = np.random.default_rng(seed)
    per = rows // groups
    with open(p, "wb") as fh:
        w = JaxFileWriter(fh, SCHEMA)
        for _ in range(groups):
            mask = np.arange(per) % 7 != 0
            w.write_columns(
                {"a": rng.integers(-(2**40), 2**40, size=per),
                 "b": rng.integers(0, 1000, size=int(mask.sum()),
                                   dtype=np.int32)},
                masks={"b": mask})
        w.close()
    return p


def counters(st) -> dict:
    return {k: getattr(st, k) for k in COUNTERS}


def each(tmp_path, monkeypatch, fn, *, cache=True, env=None):
    """``fn(P)`` in each package, each over an empty cache directory of
    its own (``cache``) and fresh tier singletons: ``(jax, port)``."""
    out = []
    for P in PKGS:
        if cache:
            d = tmp_path / f"cache-{P.name}"
            shutil.rmtree(d, ignore_errors=True)
            d.mkdir()
            monkeypatch.setenv("TPQ_CACHE_DISK_DIR", str(d))
        for k, v in (env or {}).items():
            monkeypatch.setenv(k, v)
        P.rc.reset_range_caches()
        out.append(fn(P))
    return tuple(out)


def outcome(fn):
    """``fn()``'s value, or its error's class and words."""
    try:
        return ("ok", fn())
    except Exception as e:  # noqa: BLE001 - the outcome compared
        return (type(e).__name__, str(e))


def read_all(P, src, **kw):
    """Every row group of ``src`` through ``P``'s host decode."""
    r = P.FileReader(src, **kw)
    try:
        return [r.read_row_group_arrays(g)
                for g in range(len(r.meta.row_groups))]
    finally:
        r.close()


def same_arrays(a, b, where=""):
    assert len(a) == len(b), where
    for g, (x, y) in enumerate(zip(a, b)):
        assert x.keys() == y.keys(), where
        for path in x:
            for f in ("values", "def_levels", "rep_levels"):
                np.testing.assert_array_equal(
                    np.asarray(getattr(x[path], f)),
                    np.asarray(getattr(y[path], f)),
                    err_msg=f"{where} rg {g} {path} {f}")


def same_units(ours: dict, theirs: dict, where=""):
    """One unit (``{path: DeviceColumn}``) of each package, buffer for
    buffer."""
    assert ours.keys() == theirs.keys(), where
    for name, c in ours.items():
        want = device_column_from_jax_numpy(_jax_buffers(theirs[name]))
        at = f"{where} {name}"
        assert (c.ptype, c.num_values, c.n_packed, c.n_bytes) == (
            want.ptype, want.num_values, want.n_packed, want.n_bytes), at
        a, b = c.padded_buffers(), want.padded_buffers()
        assert a.keys() == b.keys(), at
        for k in a:
            np.testing.assert_array_equal(a[k], b[k], err_msg=f"{at} {k}")


def host_reads(tmp_path, monkeypatch, src, *, cache=True, env=None,
               **kw):
    """Both packages' host reads of ``src`` under a collector:
    ``(jax arrays, jax counters, port arrays, port counters)``, the
    arrays checked equal."""
    def run(P):
        with P.collect_stats() as st:
            got = read_all(P, src, **kw)
        return got, counters(st)

    (ja, jc), (pa, pc) = each(tmp_path, monkeypatch, run, cache=cache,
                              env=env)
    same_arrays(pa, ja)
    return ja, jc, pa, pc


# ----------------------------------------------------------------------
# URI resolution
# ----------------------------------------------------------------------

class TestUriResolution:
    @pytest.mark.parametrize("src", [
        "emu:///d/f.pq", "file:///d/f.pq", "http://h:1/f.pq",
        "https://h/x?y=1", "/plain/path.pq", b"bytes", "s3://bucket/f.pq",
        "gs://x"])
    def test_parse_as_reference(self, src):
        assert outcome(lambda: port_src.parse_source_uri(src)) == \
            outcome(lambda: jax_src.parse_source_uri(src))

    def test_unknown_scheme_fails_loudly(self):
        got = [outcome(lambda P=P: P.src.open_byte_source("s3://b/f.pq"))
               for P in PKGS]
        assert got[0] == got[1] and got[0][0] == "ValueError"

    def test_bare_path_stays_local_without_reroute(self):
        assert port_src.open_byte_source("/some/path.pq") is None
        assert port_src.open_byte_source(b"/some/path.pq") is None

    def test_bad_tpq_source_rejected(self, monkeypatch, tmp_path):
        monkeypatch.setenv("TPQ_SOURCE", "gcs")
        got = [outcome(lambda P=P: P.src.open_byte_source(
            str(tmp_path / "f.pq"))) for P in PKGS]
        assert got[0] == got[1] and "gcs" in got[0][1]

    @pytest.mark.parametrize("scheme", ["emu", "file"])
    def test_reroute_keeps_bare_display_name(self, monkeypatch, tmp_path,
                                             scheme):
        p = write_file(tmp_path)
        monkeypatch.setenv("TPQ_SOURCE", scheme)
        for P in PKGS:
            src = P.src.open_byte_source(p)
            assert src.scheme == scheme and src.uri == p == src.path
            src.close()
            r = P.FileReader(p)
            assert r.name == p
            r.close()
        _ja, jc, _pa, pc = host_reads(tmp_path, monkeypatch, p,
                                      env={"TPQ_SOURCE": scheme})
        assert pc == jc and pc["remote_ranges_fetched"] > 0

    def test_explicit_uri_resolves_without_env(self, tmp_path):
        p = write_file(tmp_path)
        for P in PKGS:
            src = P.src.open_byte_source("emu://" + p)
            assert type(src).__name__ == "EmulatedStoreSource"
            assert src.uri == "emu://" + p and src.path == p
            assert src.etag() == (p, os.path.getsize(p),
                                  os.stat(p).st_mtime_ns)
            src.close()


# ----------------------------------------------------------------------
# The coalescing planner primitive
# ----------------------------------------------------------------------

class TestCoalescer:
    @pytest.mark.parametrize("seed", range(6))
    @pytest.mark.parametrize("gap", [0, 1, 64, 4096])
    def test_spans_as_reference(self, seed, gap):
        rng = np.random.default_rng(seed)
        n = int(rng.integers(1, 40))
        ranges = [(int(rng.integers(0, 1 << 20)),
                   int(rng.integers(0, 5000))) for _ in range(n)]
        spans = port_src.coalesce_ranges(ranges, gap)
        assert spans == jax_src.coalesce_ranges(ranges, gap)
        assert sorted(m for _s, _z, mem in spans for m in mem) \
            == list(range(n))
        for (s1, z1, _), (s2, _z2, _) in zip(spans, spans[1:]):
            assert s1 + z1 + gap < s2

    @pytest.mark.parametrize("args", [([(0, 4)], -1), ([(-1, 4)], 0),
                                      ([(3, -2)], 0), ([], 0)])
    def test_bad_inputs_as_reference(self, args):
        assert outcome(lambda: port_src.coalesce_ranges(*args)) == \
            outcome(lambda: jax_src.coalesce_ranges(*args))

    @pytest.mark.parametrize("value", [None, "0", "4096", "-3"])
    def test_gap_default_as_reference(self, monkeypatch, value):
        if value is not None:
            monkeypatch.setenv("TPQ_RANGE_COALESCE_GAP", value)
        assert port_src.coalesce_gap_default() == \
            jax_src.coalesce_gap_default()


# ----------------------------------------------------------------------
# Source contract: short responses, fault sites, emulator schedules
# ----------------------------------------------------------------------

class TestSourceContract:
    def test_short_response_raises_transient(self, tmp_path):
        p = write_file(tmp_path)
        got = []
        for P in PKGS:
            src = P.src.LocalByteRangeSource(p)
            got.append(outcome(lambda: src.get_range(src.size() - 10, 100)))
            src.close()
        assert got[0] == got[1] and got[0][0] == "TransientIOError"

    def test_fault_sites_fire_on_any_backend(self, tmp_path):
        p = write_file(tmp_path)

        def run(P):
            seen = []
            with P.faults.inject_faults() as inj:
                inj.inject("io.remote.open", "oserror", times=1)
                seen.append(outcome(lambda: P.src.LocalByteRangeSource(p)))
            src = P.src.LocalByteRangeSource(p)
            with P.collect_stats() as st, P.faults.inject_faults() as inj:
                for kind in ("transient", "oserror", "truncate",
                             "corrupt"):
                    site = ("io.remote.throttle" if kind == "transient"
                            and not seen[1:] else "io.remote.range")
                    inj.inject(site, kind, times=1)
                    seen.append(outcome(lambda: src.get_range(0, 8)))
                seen.append(outcome(lambda: src.get_range(0, 4)))
                log = [dict(e) for e in inj.log]
            src.close()
            return seen, st.faults_injected, log

        theirs, ours = run(JAX), run(PORT)
        assert ours == theirs
        assert ours[1] == 4 and ours[0][-1] == ("ok", b"PAR1")

    def test_reader_retries_injected_range_faults(self, tmp_path,
                                                  monkeypatch):
        p = write_file(tmp_path)

        def run(P):
            with P.collect_stats() as st, P.faults.inject_faults() as inj:
                inj.inject("io.remote.range", "transient", times=2)
                got = read_all(P, "emu://" + p)
            return got, counters(st)

        (ja, jc), (pa, pc) = each(tmp_path, monkeypatch, run)
        same_arrays(pa, ja)
        assert pc == jc
        assert pc["remote_retry"] == 2 and pc["faults_injected"] == 2

    @pytest.mark.parametrize("knobs", [
        {"throttle_every": 3}, {"reset_every": 2}, {"short_every": 2},
        {"throttle_every": 2, "reset_every": 3, "short_every": 5}])
    def test_emulator_schedule_as_reference(self, tmp_path, knobs):
        p = write_file(tmp_path)
        got = []
        for P in PKGS:
            src = P.src.EmulatedStoreSource(p, **knobs)
            got.append([outcome(lambda: src.get_range(0, 8))
                        for _ in range(12)])
            assert src._requests == 12
            src.close()
        assert got[0] == got[1]
        assert len({o[0] for o in got[1]}) > 1

    @pytest.mark.parametrize("knob", ["throttle_every", "reset_every",
                                      "short_every"])
    def test_emulated_faults_hit_flight_recorder(self, tmp_path, knob):
        p = write_file(tmp_path)
        got = []
        for P in PKGS:
            prev = P.rec.recorder()
            P.rec.set_ring(64)
            try:
                src = P.src.EmulatedStoreSource(p, **{knob: 1})
                outcome(lambda: src.get_range(0, 8))
                src.close()
                recs = [{k: v for k, v in r.items()
                         if k not in ("t", "ts", "thread", "tid", "seq")}
                        for r in P.rec.recorder().snapshot()
                        if r.get("kind") == "emu_fault"]
            finally:
                P.rec._active = prev
            got.append(recs)
        assert got[0] == got[1] and len(got[1]) == 1

    @pytest.mark.parametrize("env", [
        {}, {"TPQ_EMU_LATENCY_MS": "0.5", "TPQ_EMU_THROTTLE_EVERY": "4",
             "TPQ_EMU_RESET_EVERY": "6", "TPQ_EMU_SHORT_EVERY": "9",
             "TPQ_EMU_SLOW_MATCH": "f0", "TPQ_EMU_SLOW_MS": "1"}])
    def test_emulator_knobs_from_env(self, tmp_path, monkeypatch, env):
        p = write_file(tmp_path)
        for k, v in env.items():
            monkeypatch.setenv(k, v)
        knobs = []
        for P in PKGS:
            src = P.src.EmulatedStoreSource(p)
            re = src.reopen()
            assert re._knobs() == src._knobs() and re.uri == src.uri
            knobs.append(src._knobs())
            src.close()
            re.close()
        assert knobs[0] == knobs[1]

    def test_range_source_file_facade(self, tmp_path):
        p = write_file(tmp_path)
        for P in PKGS:
            f = P.src.RangeSourceFile(P.src.LocalByteRangeSource(p))
            assert f.read(4) == b"PAR1"
            f.seek(-4, os.SEEK_END)
            assert f.read(4) == b"PAR1"
            assert f.read(10) == b""
            assert f.seek(3) == 3 and f.seek(2, os.SEEK_CUR) == 5
            with pytest.raises(ValueError):
                f.seek(0, 7)
            f.close()
            assert f.closed


# ----------------------------------------------------------------------
# Byte identity: emu:// reads against local ones, in both packages
# ----------------------------------------------------------------------

class TestByteIdentity:
    def test_reader_parity_cache_on_off_and_faulted(self, tmp_path,
                                                    monkeypatch):
        p = write_file(tmp_path, rows=600, groups=3)
        local = read_all(PORT, p)
        same_arrays(local, read_all(JAX, p))

        def legs(P):
            out = {}
            with P.collect_stats() as st:
                out["cached"] = read_all(P, "emu://" + p)
            out["cached_c"] = counters(st)
            with P.collect_stats() as st:
                out["again"] = read_all(P, "emu://" + p)
            out["again_c"] = counters(st)
            monkeypatch.setenv("TPQ_CACHE_DISK_MB", "0")
            monkeypatch.setenv("TPQ_CACHE_MEM_MB", "0")
            P.rc.reset_range_caches()
            with P.collect_stats() as st:
                out["uncached"] = read_all(P, "emu://" + p)
            out["uncached_c"] = counters(st)
            monkeypatch.delenv("TPQ_CACHE_DISK_MB")
            monkeypatch.delenv("TPQ_CACHE_MEM_MB")
            P.rc.reset_range_caches()
            with P.collect_stats() as st, P.faults.inject_faults() as inj:
                inj.inject("io.remote.range", "transient", times=2)
                inj.inject("io.remote.range", "truncate", times=1)
                out["faulted"] = read_all(P, "emu://" + p)
            out["faulted_c"] = counters(st)
            return out

        theirs, ours = each(tmp_path, monkeypatch, legs)
        for leg in ("cached", "again", "uncached", "faulted"):
            same_arrays(ours[leg], local, leg)
            assert ours[f"{leg}_c"] == theirs[f"{leg}_c"], leg
        assert ours["again_c"]["remote_ranges_fetched"] == 0
        assert ours["uncached_c"]["cache_hits_disk"] == 0
        assert ours["faulted_c"]["remote_retry"] == 3

    @pytest.mark.parametrize("gap", [None, "0"])
    @pytest.mark.parametrize("threads", ["1", "4"])
    @pytest.mark.parametrize("entry", ["row_group", "row_groups"])
    def test_device_read_parity(self, tmp_path, monkeypatch, gap, threads,
                                entry):
        """``read_row_group_device`` prefetches each row group's selected
        chunks, ``a`` and ``c`` around the unread ``b``: one span with
        ``b``'s bytes as its gap, or two spans with a gap of 0, fetched
        in parallel on the plan workers; ``read_row_groups_device``
        reads them through the plan pool.  Cold, then warm: equal
        buffers and counters."""
        p = str(tmp_path / "abc.parquet")
        rng = np.random.default_rng(5)
        with open(p, "wb") as fh:
            w = JaxFileWriter(fh, "message m { required int64 a; "
                              "optional int32 b; required int64 c; }")
            for _ in range(3):
                mask = rng.random(300) > 0.2
                w.write_columns({
                    "a": rng.integers(0, 2**40, size=300),
                    "b": rng.integers(0, 9, size=int(mask.sum()),
                                      dtype=np.int32),
                    "c": rng.integers(-50, 50, size=300)},
                    masks={"b": mask})
            w.close()
        env = {"TPQ_PLAN_THREADS": threads}
        if gap is not None:
            env["TPQ_RANGE_COALESCE_GAP"] = gap

        def run(P):
            passes = []
            for _ in range(2):
                r = P.FileReader("emu://" + p, "a", "c")
                with P.collect_stats() as st:
                    if entry == "row_group":
                        got = {g: P.device.read_row_group_device(
                            r, g, **P.dev) for g in range(3)}
                    else:
                        got = dict(P.device.read_row_groups_device(
                            r, **P.dev))
                r.close()
                passes.append((got, counters(st)))
            return passes

        theirs, ours = each(tmp_path, monkeypatch, run, env=env)
        for (pg, pc), (jg, jc) in zip(ours, theirs):
            assert pc == jc
            for g in jg:
                same_units(pg[g], jg[g], f"rg {g}")
        cold, warm = ours[0][1], ours[1][1]
        assert warm["remote_ranges_fetched"] == 0
        assert warm["cache_hits_disk"] == 6
        if entry == "row_group":
            spans = 3 if gap is None else 6
            assert cold["remote_ranges_fetched"] == spans
            assert cold["ranges_coalesced"] == 6 - spans
            assert (cold["remote_bytes"] > cold["bytes_read"]) == \
                (gap is None)

    def test_sharded_scan_parity_under_emulated_faults(
            self, tmp_path, monkeypatch):
        paths = [write_file(tmp_path, name=f"s{i}.parquet", rows=300,
                            groups=2, seed=10 + i) for i in range(2)]
        env = {"TPQ_EMU_THROTTLE_EVERY": "5", "TPQ_EMU_RESET_EVERY": "7",
               "TPQ_PLAN_THREADS": "1"}

        def run(P):
            mesh = P.mesh()
            with P.collect_stats() as st:
                with P.ShardedScan(["emu://" + q for q in paths],
                                   mesh=mesh) as s:
                    res = s.run()
                    g = P.gather_column(mesh, res, "a")
            return res, [np.asarray(x) for x in g], counters(st)

        (jr, jg, jc), (pr, pg, pc) = each(tmp_path, monkeypatch, run,
                                          env=env)
        assert pc == jc and pc["remote_retry"] > 0
        assert len(pr) == len(jr) == 4
        for k in range(4):
            same_units(pr[k], jr[k], f"unit {k}")
        for a, b in zip(pg, jg):
            np.testing.assert_array_equal(a, b)

    def test_sharded_scan_resume_over_emu(self, tmp_path, monkeypatch):
        paths = [write_file(tmp_path, name=f"r{i}.parquet", rows=200,
                            groups=2, seed=20 + i) for i in range(2)]
        uris = ["emu://" + q for q in paths]
        monkeypatch.setenv("TPQ_CACHE_DISK_DIR", str(tmp_path / "c"))
        (tmp_path / "c").mkdir()
        expected = JaxShardedScan(paths).run()
        scan1 = ShardedScan(uris, mesh=PORT.mesh())
        got = {}
        it = scan1.run_iter()
        for _ in range(2):
            k, out = next(it)
            got[k] = out
        it.close()
        cursor = json.loads(json.dumps(scan1.state()))
        scan1.close()
        with ShardedScan(uris, mesh=PORT.mesh(), resume=cursor) as scan2:
            for k, out in scan2.run_iter():
                assert k not in got
                got[k] = out
        assert sorted(got) == list(range(len(expected)))
        for k, ref in enumerate(expected):
            same_units(got[k], ref, f"unit {k}")

    @pytest.mark.parametrize("how", ["host", "device"])
    def test_filtered_read_parity(self, tmp_path, monkeypatch, how):
        p = write_file(tmp_path, rows=400, groups=2, seed=3)

        def run(P):
            f = P.col("b") > 500
            r = P.FileReader("emu://" + p)
            with P.collect_stats() as st:
                if how == "host":
                    got = [r.read_row_group_arrays(g, filter=f)
                           for g in range(2)]
                else:
                    got = dict(P.device.read_row_groups_device(
                        r, filter=f, **P.dev))
            r.close()
            return got, counters(st)

        (jg, jc), (pg, pc) = each(tmp_path, monkeypatch, run)
        # each stage prefetches its own columns (the filter's, then the
        # rest); the page index and bloom ranges go through the memory tier
        assert pc == jc and pc["cache_hits_disk"] == 4
        assert pc["remote_ranges_fetched"] == pc["cache_misses_mem"] + 4
        if how == "host":
            same_arrays(pg, jg)
            local = FileReader(p)
            same_arrays(pg, [local.read_row_group_arrays(
                g, filter=port_col("b") > 500) for g in range(2)])
        else:
            for g in jg:
                same_units(pg[g], jg[g], f"rg {g}")


# ----------------------------------------------------------------------
# The tiered cache: conservation, reopens, torn files, interchange
# ----------------------------------------------------------------------

class TestTieredCache:
    def test_conservation_and_exact_accounting(self, tmp_path,
                                               monkeypatch):
        p = write_file(tmp_path)

        def run(P):
            lookups = {"mem": 0, "disk": 0}

            def instrument(cache, tier):
                orig = cache.get

                def counted(key):
                    lookups[tier] += 1
                    return orig(key)
                cache.get = counted

            with P.collect_stats() as st:
                instrument(P.rc.mem_cache(), "mem")
                instrument(P.rc.disk_cache(), "disk")
                for _ in range(2):
                    read_all(P, "emu://" + p)
            return counters(st), lookups

        (jc, jl), (pc, pl) = each(tmp_path, monkeypatch, run)
        assert (pc, pl) == (jc, jl)
        assert pc["cache_hits_mem"] + pc["cache_misses_mem"] \
            == pl["mem"] > 0
        assert pc["cache_hits_disk"] + pc["cache_misses_disk"] \
            == pl["disk"] > 0

    def test_second_open_issues_zero_round_trips(self, tmp_path,
                                                 monkeypatch):
        p = write_file(tmp_path)

        def run(P):
            read_all(P, "emu://" + p)
            with P.collect_stats() as st:
                read_all(P, "emu://" + p)
            return counters(st)

        jc, pc = each(tmp_path, monkeypatch, run)
        assert pc == jc
        assert pc["remote_ranges_fetched"] == 0
        assert pc["cache_misses_mem"] == pc["cache_misses_disk"] == 0

    def test_coalescing_saves_round_trips(self, tmp_path, monkeypatch):
        p = write_file(tmp_path)
        _ja, jc, _pa, pc = host_reads(tmp_path, monkeypatch, "emu://" + p)
        assert pc == jc
        assert pc["ranges_coalesced"] == 2 and pc["cache_hits_disk"] == 4

    @pytest.mark.parametrize("env", [{"TPQ_CACHE_DISK_MB": "0"},
                                     {"TPQ_CACHE_MEM_MB": "0"},
                                     {"TPQ_CACHE_MEM_MB": "0.0001"}])
    def test_cache_knobs_as_reference(self, tmp_path, monkeypatch, env):
        p = write_file(tmp_path)

        def run(P):
            with P.collect_stats() as st:
                read_all(P, "emu://" + p)
                read_all(P, "emu://" + p)
            return counters(st), P.rc.disk_cache() is None, \
                P.rc.mem_cache() is None

        jc, pc = each(tmp_path, monkeypatch, run, env=env)
        assert pc == jc

    def test_etag_invalidates_on_rewrite(self, tmp_path, monkeypatch):
        p = write_file(tmp_path, seed=1)
        d = tmp_path / "c"
        d.mkdir()
        monkeypatch.setenv("TPQ_CACHE_DISK_DIR", str(d))
        read_all(PORT, "emu://" + p)
        os.unlink(p)
        assert write_file(tmp_path, rows=200, seed=2) == p
        same_arrays(read_all(PORT, "emu://" + p), read_all(JAX, p))

    def test_torn_cache_files_self_heal_on_restart(self, tmp_path,
                                                   monkeypatch):
        p = write_file(tmp_path)
        d = tmp_path / "c"
        d.mkdir()
        monkeypatch.setenv("TPQ_CACHE_DISK_DIR", str(d))
        read_all(PORT, "emu://" + p)
        entries = sorted(d.glob("*.tpqc"))
        assert len(entries) == 4
        (d / "orphan.tpqc.123.456.tmp").write_bytes(b"PART")
        torn = entries[0]
        torn.write_bytes(torn.read_bytes()[: torn.stat().st_size // 2])
        garbage = d / ("ff" * 20 + ".tpqc")
        garbage.write_bytes(b"not a cache entry")
        port_rc.reset_range_caches()
        with collect_stats() as st:
            got = read_all(PORT, "emu://" + p)
        same_arrays(got, read_all(JAX, p))
        assert not list(d.glob("*.tmp")) and not garbage.exists()
        # the footer's three ranges (a new process's memory tier) and
        # the torn entry's chunk
        assert st.cache_hits_disk == 4 and st.remote_ranges_fetched == 4

    def test_invalidate_source_caches_accepts_uris(self, tmp_path,
                                                   monkeypatch):
        p = write_file(tmp_path)

        def run(P):
            read_all(P, "emu://" + p)
            with P.collect_stats() as st:
                first = P.rc.invalidate_source_caches("emu://" + p)
                second = P.rc.invalidate_source_caches(p)
            return first, second, counters(st)

        jr, pr = each(tmp_path, monkeypatch, run)
        assert pr == jr and pr[0] == 7 and pr[1] == 0

    @pytest.mark.parametrize("shared", ["0", "1"])
    @pytest.mark.parametrize("filler", ["jax", "port"])
    def test_cache_directory_reads_across_packages(self, tmp_path,
                                                   monkeypatch, filler,
                                                   shared):
        """The entry frames (and the shared tier's journal) are the
        reference's: a directory one package filled reads as hits in the
        other, with no fetch."""
        p = write_file(tmp_path, rows=600, groups=3)
        d = tmp_path / "shared-dir"
        d.mkdir()
        monkeypatch.setenv("TPQ_CACHE_DISK_DIR", str(d))
        monkeypatch.setenv("TPQ_CACHE_DISK_SHARED", shared)
        fill, read = (JAX, PORT) if filler == "jax" else (PORT, JAX)
        read_all(fill, "emu://" + p)
        fill.rc.reset_range_caches()
        with read.collect_stats() as st:
            got = read_all(read, "emu://" + p)
        same_arrays(got, read_all(fill, p))
        c = counters(st)
        assert c["cache_hits_disk"] == 6 and c["cache_misses_disk"] == 0
        # the footer's ranges live in the memory tier, per process
        assert c["remote_ranges_fetched"] == c["cache_misses_mem"]
        assert len(list(d.glob("*.tpqc"))) == 6

    def test_entry_files_equal_the_reference(self, tmp_path, monkeypatch):
        p = write_file(tmp_path)

        def run(P):
            read_all(P, "emu://" + p)
            d = tmp_path / f"cache-{P.name}"
            return {e.name: e.read_bytes() for e in d.glob("*.tpqc")}

        assert each(tmp_path, monkeypatch, run)[1] == \
            each(tmp_path, monkeypatch, run)[0]


# ----------------------------------------------------------------------
# Cache poisoning
# ----------------------------------------------------------------------

def _flip_payload_byte(cache_dir):
    """Rot the payload of the largest entry: its framing stays valid,
    so only the CRC can catch it."""
    entry = max(cache_dir.glob("*.tpqc"), key=lambda e: e.stat().st_size)
    blob = bytearray(entry.read_bytes())
    blob[-1] ^= 0xFF
    entry.write_bytes(bytes(blob))
    return entry


class TestCachePoisoning:
    def test_crc_poison_evicts_and_degrades_to_direct(self, tmp_path,
                                                      monkeypatch):
        p = write_file(tmp_path)
        local = read_all(JAX, p)

        def run(P):
            pm = tmp_path / f"pm-{P.name}"
            pm.mkdir()
            monkeypatch.setenv("TPQ_POSTMORTEM_DIR", str(pm))
            read_all(P, "emu://" + p)
            entry = _flip_payload_byte(tmp_path / f"cache-{P.name}")
            P.rc.reset_range_caches()
            prev = P.rec.recorder()
            P.rec.set_ring(64)
            try:
                with P.collect_stats() as st:
                    got = read_all(P, "emu://" + p)
                poison = [{k: r[k] for k in ("site", "file", "start",
                                             "size")}
                          for r in P.rec.recorder().snapshot()
                          if r.get("kind") == "cache_poison"]
            finally:
                P.rec._active = prev
            incidents = [json.loads(f.read_text())["incidents"][-1]
                         ["trigger"] for f in pm.glob("*.json")]
            for t in incidents:
                t["entry"] = os.path.basename(t["entry"])
            exists = entry.exists()
            read_all(P, "emu://" + p)
            return (got, counters(st), poison, incidents, exists,
                    entry.exists())

        theirs, ours = each(tmp_path, monkeypatch, run)
        same_arrays(ours[0], local)
        assert ours[1:] == theirs[1:]
        c = ours[1]
        assert c["cache_evictions_disk"] == 1 and c["cache_misses_disk"] == 1
        assert ours[2] and ours[3][0]["kind"] == "cache_poison"
        # the poisoned key is not cached again at once; a later fetch is
        assert ours[4:] == (False, True)

    @pytest.mark.parametrize("how", ["host", "device"])
    def test_decode_corruption_evicts_both_tiers(self, tmp_path,
                                                 monkeypatch, how):
        """Bytes that pass the tier's CRC but fail the decode: the
        corrupt-page path evicts the source from both tiers, so the next
        read refetches clean bytes.  The error's class and words are the
        reference's."""
        p = write_file(tmp_path)

        def read(P, r, g):
            if how == "host":
                return r.read_row_group_arrays(g)
            return P.device.read_row_group_device(r, g, **P.dev)

        def run(P):
            with P.collect_stats() as st, P.faults.inject_faults() as inj:
                # after=3 skips the footer's three reads: the first
                # chunk span fetched is the poisoned one
                inj.inject("io.remote.range", "corrupt", times=1, after=3)
                r = P.FileReader("emu://" + p)
                err = outcome(lambda: [read(P, r, g) for g in range(2)])
                r.close()
            left = len(list((tmp_path / f"cache-{P.name}").glob("*.tpqc")))
            with P.collect_stats() as st2:
                r = P.FileReader("emu://" + p)
                got = [read(P, r, g) for g in range(2)]
                r.close()
            return err, counters(st), left, got, counters(st2)

        # one plan worker: a sibling column's read cannot refill the tier
        # after the eviction
        theirs, ours = each(tmp_path, monkeypatch, run,
                            env={"TPQ_PLAN_THREADS": "1"})
        assert ours[0] == theirs[0] and "Corrupt" in ours[0][0]
        assert ours[1:3] == theirs[1:3] and ours[4] == theirs[4]
        # the poisoned span's entries are gone (counted), and the re-read
        # fetches
        assert ours[2] == 0 and ours[1]["cache_evictions_disk"] > 0
        assert ours[4]["remote_ranges_fetched"] > 0
        if how == "host":
            same_arrays(ours[3], read_all(JAX, p))
        else:
            for g in range(2):
                same_units(ours[3][g], theirs[3][g], f"rg {g}")

    def test_failed_open_in_a_scan_evicts_the_source(self, tmp_path,
                                                     monkeypatch):
        """A quarantining scan's file that fails to open has its cached
        ranges dropped (both tiers), as the reference's."""
        good = write_file(tmp_path, name="good.parquet")
        bad = tmp_path / "bad.parquet"
        bad.write_bytes(b"PAR1" + b"\0" * 64)

        def run(P):
            read_all(P, "emu://" + good)
            kw = {} if P is JAX else {"mesh": P.mesh()}
            with P.collect_stats() as st:
                with P.ShardedScan(["emu://" + good, "emu://" + str(bad)],
                                   on_error="quarantine", **kw) as s:
                    res = s.run()
                    q = [(e["error"], e["disposition"])
                         for e in s.quarantine.as_dicts()]
            return len(res), q, counters(st)

        jr, pr = each(tmp_path, monkeypatch, run)
        assert pr == jr and pr[1] == [("CorruptFooterError", "quarantined")]


# ----------------------------------------------------------------------
# Hedged mirrors and reopens over remote sources
# ----------------------------------------------------------------------

class TestRemoteResilience:
    def test_hedged_read_with_slow_emulated_replica(self, tmp_path,
                                                    monkeypatch):
        p = write_file(tmp_path)
        slow = str(tmp_path / "slowcopy.parquet")
        shutil.copyfile(p, slow)
        monkeypatch.setenv("TPQ_EMU_SLOW_MATCH", "slowcopy")
        monkeypatch.setenv("TPQ_EMU_SLOW_MS", "200")
        local = read_all(JAX, p)

        def run(P):
            with P.collect_stats() as st:
                got = read_all(P, "emu://" + slow, mirrors=["emu://" + p],
                               hedge_delay=0.01)
            return got, st.hedges_issued, st.hedges_won

        (jg, jh, _jw), (pg, ph, pw) = each(tmp_path, monkeypatch, run,
                                           cache=False)
        same_arrays(pg, local)
        same_arrays(jg, local)
        assert ph > 0 and jh > 0 and pw > 0

    def test_sources_as_reader_and_mirror(self, tmp_path):
        """A ``ByteRangeSource`` instance as the reader's source and as
        its mirror: a slow primary loses its hedges to the mirror."""
        p = write_file(tmp_path)
        copy = str(tmp_path / "copy.parquet")
        shutil.copyfile(p, copy)
        primary = port_src.EmulatedStoreSource(p, slow_match="f0",
                                               slow_ms=100)
        mirror = port_src.EmulatedStoreSource(copy)
        r = FileReader(primary, mirrors=[mirror], hedge_delay=0.01)
        assert r.name == "emu://" + p
        with collect_stats() as st:
            got = [r.read_row_group_arrays(g) for g in range(2)]
        r.close()
        same_arrays(got, read_all(JAX, p))
        assert st.hedges_issued > 0

    def test_reopen_after_expiry_over_emu(self, tmp_path):
        p = write_file(tmp_path)
        r = FileReader("emu://" + p)
        old = r._source
        r._reopen_after_expiry()  # must not open("emu://...")
        assert r._source is not old and r._source.uri == old.uri
        same_arrays([r.read_row_group_arrays(g) for g in range(2)],
                    read_all(JAX, p))
        r.close()
        assert r._source._closed

    def test_fingerprint_keys_on_the_source(self, tmp_path, monkeypatch):
        """The plan cache's fingerprint of a remote file is the local
        file's, read through the memory tier with no fetch."""
        p = write_file(tmp_path)
        want = FileReader(p).plan_fingerprint
        r = FileReader("emu://" + p)
        with collect_stats() as st:
            assert r.plan_fingerprint == want
        assert st.remote_ranges_fetched == 0 and st.cache_hits_mem == 2
        r.close()

    def test_read_deadline_bounds_a_remote_read(self, tmp_path,
                                                monkeypatch):
        p = write_file(tmp_path)
        monkeypatch.setenv("TPQ_IO_RETRIES", "1")
        monkeypatch.setenv("TPQ_EMU_SLOW_MATCH", "f0")
        monkeypatch.setenv("TPQ_EMU_SLOW_MS", "300")

        def run(P):
            r = P.FileReader("emu://" + p, read_deadline=0.05)
            with P.collect_stats() as st:
                err = outcome(lambda: r.read_row_group_arrays(0))
            r.close()
            return err[0], st.deadline_exceeded, st.remote_retry

        jr, pr = each(tmp_path, monkeypatch, run, cache=False)
        assert pr == jr and pr[0] == "DeadlineExceededError"


def test_io_exports_as_reference():
    import tpuparquet.io as jax_io
    import tpuparquet_torch as port
    import tpuparquet_torch.io as port_io

    for name in ("open_byte_source", "parse_source_uri",
                 "invalidate_source_caches", "reset_range_caches",
                 "ByteRangeSource", "EmulatedStoreSource",
                 "LocalByteRangeSource", "coalesce_ranges"):
        assert hasattr(jax_io, name) and hasattr(port_io, name), name
    for name in ("open_byte_source", "parse_source_uri",
                 "invalidate_source_caches", "reset_range_caches",
                 "DatasetScan"):
        assert hasattr(port, name), name


def test_new_counters_merge_ship_and_compare_as_reference():
    from tpuparquet.stats import DecodeStats as JaxStats
    from tpuparquet.stats import merge_worker_stats as jax_merge
    from tpuparquet_torch.stats import DecodeStats, merge_worker_stats

    names = REMOTE + ("dataset_files_pruned", "dataset_orphans_swept")
    for i, n in enumerate(names):
        a, ja = DecodeStats(), JaxStats()
        w, jw = DecodeStats(), JaxStats()
        setattr(w, n, i + 3)
        setattr(jw, n, i + 3)
        merge_worker_stats(a, w, failed=True)
        jax_merge(ja, jw, failed=True)
        assert getattr(a, n) == getattr(ja, n), n
        a.merge_from(w)
        ja.merge_from(jw)
        assert getattr(a, n) == getattr(ja, n), n
        assert DecodeStats.from_state(a.to_state()) == a
        assert a != DecodeStats()
