"""The HTTP range source against the JAX package's, over the
deterministic fault server (``tools/httpfault.py``) on ``127.0.0.1``.

Mirrors ``tests/test_http_source.py``: byte identity over plain and
faulted origins, the Range/ETag/If-Match protocol, the status mapping
into the error taxonomy (with ``Retry-After``), the ``TPQ_SOURCE``
reroute of bare paths, the bounded connection pool, and exact remote and
cache counters.  Where a schedule keys on the server's request counter,
each package reads from a fresh server with the same plan.
"""

from __future__ import annotations

import contextlib
import os
import threading

import numpy as np
import pytest

from tools.httpfault import FaultHTTPServer, FaultPlan

from test_torch_remote import JAX, PKGS, PORT, counters, each, outcome, \
    read_all, same_arrays, same_units, write_file  # noqa: E402


@contextlib.contextmanager
def origin(root, plan=None):
    """A fault server over ``root`` on 127.0.0.1 (``srv.plan`` may be
    flipped between phases)."""
    srv = FaultHTTPServer(("127.0.0.1", 0), str(root), plan)
    t = threading.Thread(target=srv.serve_forever, daemon=True,
                         name="httpfault-test")
    t.start()
    try:
        yield srv
    finally:
        srv.shutdown()
        srv.server_close()
        t.join(10.0)


@pytest.fixture(autouse=True)
def _fresh(monkeypatch):
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


def _words(o, srv):
    """An outcome with the server's address taken out of its words."""
    return (o[0], o[1].replace(srv.base_url, "BASE")) \
        if isinstance(o[1], str) else o


class _Resp:
    def __init__(self, status, headers):
        self.status = status
        self._h = headers

    def getheader(self, name):
        return self._h.get(name)


class TestHttpSource:
    def test_identity_and_exact_ranges(self, tmp_path):
        p = write_file(tmp_path)
        with open(p, "rb") as f:
            blob = f.read()
        size = len(blob)
        with origin(tmp_path) as srv:
            got = []
            for P in PKGS:
                src = P.src.HttpByteRangeSource(f"{srv.base_url}/f0.parquet")
                try:
                    assert src.size() == size
                    assert src._etag_header.startswith('"')
                    assert src.etag() == (src.uri, size, src._etag_header)
                    for s, n in ((0, 64), (size - 10, 10),
                                 (size // 2, 100)):
                        assert src.get_range(s, n) == blob[s:s + n]
                    got.append(src._etag_header)
                finally:
                    src.close()
        assert got[0] == got[1]

    def test_full_read_byte_identical_to_local(self, tmp_path,
                                               monkeypatch):
        p = write_file(tmp_path)
        local = read_all(JAX, p)
        with origin(tmp_path) as srv:
            def run(P):
                with P.collect_stats() as st:
                    got = read_all(P, f"{srv.base_url}/f0.parquet")
                return got, counters(st)

            (jg, jc), (pg, pc) = each(tmp_path, monkeypatch, run)
        same_arrays(pg, local)
        same_arrays(jg, local)
        assert pc == jc and pc["cache_hits_disk"] == 4

    @pytest.mark.parametrize("plan", [
        dict(throttle_every=5, error_every=7, reset_every=11,
             short_every=13, retry_after_s=0.001),
        dict(throttle_every=3, retry_after_s=0.001),
        dict(short_every=4)])
    def test_retry_ladder_over_scripted_faults(self, tmp_path,
                                               monkeypatch, plan):
        p = write_file(tmp_path, rows=600, groups=3)
        local = read_all(JAX, p)

        def run(P):
            with origin(tmp_path, FaultPlan(**plan)) as srv:
                with P.collect_stats() as st:
                    got = read_all(P, f"{srv.base_url}/f0.parquet")
                return got, counters(st), srv._requests

        (jg, jc, jn), (pg, pc, pn) = each(tmp_path, monkeypatch, run)
        same_arrays(pg, local)
        assert (pc, pn) == (jc, jn)
        assert pc["remote_retry"] > 0 and pc["remote_ranges_fetched"] > 0

    @pytest.mark.parametrize("where", ["host", "device"])
    def test_device_and_cold_warm_reads(self, tmp_path, monkeypatch,
                                        where):
        p = write_file(tmp_path, rows=600, groups=3, seed=4)

        def run(P):
            with origin(tmp_path, FaultPlan(throttle_every=4,
                                            retry_after_s=0.001)) as srv:
                passes = []
                for _ in range(2):
                    r = P.FileReader(f"{srv.base_url}/f0.parquet")
                    with P.collect_stats() as st:
                        if where == "host":
                            got = [r.read_row_group_arrays(g)
                                   for g in range(3)]
                        else:
                            got = [P.device.read_row_group_device(
                                r, g, **P.dev) for g in range(3)]
                    r.close()
                    passes.append((got, counters(st)))
                return passes

        theirs, ours = each(tmp_path, monkeypatch, run)
        for (pg, pc), (jg, jc) in zip(ours, theirs):
            assert pc == jc
            if where == "host":
                same_arrays(pg, jg)
            else:
                for g in range(3):
                    same_units(pg[g], jg[g], f"rg {g}")
        assert ours[0][1]["remote_retry"] > 0
        assert ours[1][1]["remote_ranges_fetched"] == 0

    def test_sharded_scan_over_http(self, tmp_path, monkeypatch):
        paths = [write_file(tmp_path, name=f"s{i}.parquet", rows=300,
                            groups=2, seed=30 + i) for i in range(2)]
        monkeypatch.setenv("TPQ_PLAN_THREADS", "1")

        def run(P):
            with origin(tmp_path, FaultPlan(error_every=6)) as srv:
                mesh = P.mesh()
                with P.collect_stats() as st:
                    with P.ShardedScan(
                            [f"{srv.base_url}/{os.path.basename(q)}"
                             for q in paths], mesh=mesh) as s:
                        res = s.run()
                        g = P.gather_column(mesh, res, "a")
                return res, [np.asarray(x) for x in g], counters(st)

        (jr, jg, jc), (pr, pg, pc) = each(tmp_path, monkeypatch, run)
        assert pc == jc and pc["remote_retry"] > 0
        for k in range(len(jr)):
            same_units(pr[k], jr[k], f"unit {k}")
        for a, b in zip(pg, jg):
            np.testing.assert_array_equal(a, b)

    def test_404_maps_to_file_not_found(self, tmp_path):
        with origin(tmp_path) as srv:
            got = [_words(outcome(lambda P=P: P.src.HttpByteRangeSource(
                f"{srv.base_url}/absent.parquet")), srv) for P in PKGS]
        assert got[0] == got[1] and got[0][0] == "FileNotFoundError"

    @pytest.mark.parametrize("status", [400, 401, 403, 404, 410, 429, 500,
                                        502, 503, 504])
    @pytest.mark.parametrize("retry_after", [None, "2.5", "-4", "soon",
                                             "Wed, 21 Oct 2015 07:28:00 GMT"])
    def test_status_mapping_as_reference(self, status, retry_after):
        resp = _Resp(status, {} if retry_after is None
                     else {"Retry-After": retry_after})
        got = []
        for P in PKGS:
            src = object.__new__(P.src.HttpByteRangeSource)
            src.uri = "http://h/f.parquet"
            e = src._status_error(resp, verb="GET", start=17)
            got.append((type(e).__name__, str(e),
                        getattr(e, "retry_after_s", None)))
        assert got[0] == got[1]

    def test_unsatisfiable_range_is_transient(self, tmp_path):
        write_file(tmp_path)
        with origin(tmp_path) as srv:
            got = []
            for P in PKGS:
                src = P.src.HttpByteRangeSource(f"{srv.base_url}/f0.parquet")
                got.append(_words(outcome(
                    lambda: src._read_raw(src.size() + 1024, 16)), srv))
                src.close()
        assert got[0] == got[1] and got[0][0] == "TransientIOError"

    def test_retry_after_hint_parsed(self, tmp_path):
        write_file(tmp_path)
        with origin(tmp_path) as srv:
            for P in PKGS:
                src = P.src.HttpByteRangeSource(f"{srv.base_url}/f0.parquet")
                srv.plan = FaultPlan(throttle_every=1, retry_after_s=7.5)
                try:
                    with pytest.raises(P.errors.TransientIOError) as ei:
                        src._read_raw(0, 16)
                    assert ei.value.retry_after_s == pytest.approx(7.5)
                finally:
                    srv.plan = FaultPlan()
                    src.close()

    def test_etag_flip_answers_412_refreshes_and_recovers(
            self, tmp_path, monkeypatch):
        p = write_file(tmp_path)
        with open(p, "rb") as f:
            blob = f.read()

        def run(P):
            with origin(tmp_path) as srv:
                src = P.src.HttpByteRangeSource(f"{srv.base_url}/f0.parquet")
                try:
                    old = src._etag_header
                    srv.plan = FaultPlan(etag_flip_at=1)
                    err = _words(outcome(lambda: src._read_raw(0, 64)), srv)
                    assert src._etag_header != old
                    assert src._read_raw(0, 64) == blob[:64]
                finally:
                    src.close()
            return err

        jr, pr = each(tmp_path, monkeypatch, run)
        assert pr == jr and "etag" in pr[1]

    def test_reader_absorbs_midscan_etag_flip(self, tmp_path,
                                              monkeypatch):
        p = write_file(tmp_path, rows=600, groups=3)
        local = read_all(JAX, p)

        def run(P):
            with origin(tmp_path) as srv:
                r = P.FileReader(f"{srv.base_url}/f0.parquet")
                try:
                    srv.plan = FaultPlan(etag_flip_at=1)
                    with P.collect_stats() as st:
                        got = [r.read_row_group_arrays(g) for g in range(3)]
                finally:
                    r.close()
            return got, counters(st)

        (jg, jc), (pg, pc) = each(tmp_path, monkeypatch, run)
        same_arrays(pg, local)
        assert pc == jc and pc["remote_retry"] > 0

    def test_tpq_source_reroute_bare_paths(self, tmp_path, monkeypatch):
        # the reroute builds base + the absolute local path, so the origin
        # serves from /
        p = write_file(tmp_path)
        local = read_all(JAX, p)
        with origin("/") as srv:
            monkeypatch.setenv("TPQ_SOURCE", "http")
            monkeypatch.setenv("TPQ_HTTP_BASE", srv.base_url)
            for P in PKGS:
                src = P.src.open_byte_source(p)
                try:
                    assert src.path == p and src.uri == p
                finally:
                    src.close()
                same_arrays(read_all(P, p), local)

    def test_reroute_without_base_fails_loudly(self, tmp_path,
                                               monkeypatch):
        p = write_file(tmp_path)
        monkeypatch.setenv("TPQ_SOURCE", "http")
        got = [outcome(lambda P=P: P.src.open_byte_source(p)) for P in PKGS]
        assert got[0] == got[1] and "TPQ_HTTP_BASE" in got[0][1]

    @pytest.mark.parametrize("conns", [None, "1", "3"])
    def test_bounded_pool_reuses_connections(self, tmp_path, monkeypatch,
                                             conns):
        write_file(tmp_path)
        if conns is not None:
            monkeypatch.setenv("TPQ_HTTP_CONNS", conns)
        monkeypatch.setenv("TPQ_HTTP_TIMEOUT_S", "5")
        bound = int(conns) if conns else 4
        with origin(tmp_path) as srv:
            src = PORT.src.HttpByteRangeSource(f"{srv.base_url}/f0.parquet")
            try:
                assert src._conns == bound and src._timeout == 5.0
                for off in range(0, 256, 64):
                    src.get_range(off, 64)
                assert src._pool._total <= 1
            finally:
                src.close()
            assert PORT.src.http_conns_default() == \
                JAX.src.http_conns_default()
            assert PORT.src.http_timeout_default() == \
                JAX.src.http_timeout_default()

    def test_not_an_http_url(self):
        got = [outcome(lambda P=P: P.src.HttpByteRangeSource("ftp://x/y"))
               for P in PKGS]
        assert got[0] == got[1] and got[0][0] == "ValueError"
