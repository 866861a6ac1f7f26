"""Partitioned datasets, read side, against the JAX package.

Mirrors the scan side of ``tests/test_dataset.py``: datasets written by
the JAX package's ``DatasetWriter`` (the port has no writer) and by
pyarrow's hive layout are read by both packages' ``DatasetScan``, which
must agree on the resolved snapshot, the surviving files and their
partitions, every unit's buffers, the gathers and the counters
(``dataset_files_pruned`` among them), and on error classes and words.
Covered: partition pruning and the split of a filter, the degrade to an
older snapshot when the newest is corrupt, the pending-journal refusal,
``sweep_orphans`` (standalone and as the scan's option), the manifest's
fault site, an ``emu://`` root under throttles, and hive discovery.
"""

from __future__ import annotations

import os
import shutil
import signal
import subprocess
import sys
from types import SimpleNamespace

import numpy as np
import pytest

from tpuparquet import dataset as jax_ds
from tpuparquet.dataset import DatasetWriter
from tpuparquet.dataset import manifest as jax_mf
from tpuparquet.faults import QuarantineReport as JaxQuarantine
from tpuparquet.filter import col as jax_col
from tpuparquet.shard import ShardedScan as JaxShardedScan
from tpuparquet_torch import dataset as port_ds
from tpuparquet_torch.dataset import manifest as port_mf
from tpuparquet_torch.faults import QuarantineReport
from tpuparquet_torch.filter import col as port_col
from tpuparquet_torch.shard import ShardedScan

from test_torch_remote import JAX, PORT, outcome, same_units  # noqa: E402

SCHEMA = """message rec {
  required int64 id;
  optional binary tag (STRING);
  required binary region (STRING);
}"""

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CHILD = os.path.join(REPO, "tests", "dataset_child.py")

JAXD = SimpleNamespace(P=JAX, ds=jax_ds, mf=jax_mf, col=jax_col,
                       Q=JaxQuarantine, ShardedScan=JaxShardedScan)
PORTD = SimpleNamespace(P=PORT, ds=port_ds, mf=port_mf, col=port_col,
                        Q=QuarantineReport, ShardedScan=ShardedScan)
BOTH = (JAXD, PORTD)


@pytest.fixture(autouse=True)
def _fresh(monkeypatch):
    for k in list(os.environ):
        if k.startswith(("TPQ_CACHE_", "TPQ_EMU_")) or k == "TPQ_SOURCE":
            monkeypatch.delenv(k)
    monkeypatch.setenv("TPQ_RETRY_BASE_S", "0.0005")
    monkeypatch.setenv("TPQ_RETRY_MAX_S", "0.002")


def write_snapshot_a(root) -> list:
    """The reference's base snapshot: 40 rows over region=eu and
    region=us, a null tag every 5th row, committed as manifest v1."""
    ids = np.arange(40, dtype=np.int64)
    w = DatasetWriter(str(root), SCHEMA, ["region"])
    w.write_columns({
        "id": ids,
        "tag": [b"a-%02d" % i for i in range(40)],
        "region": [b"eu" if i % 2 else b"us" for i in range(40)],
    }, masks={"tag": np.array([i % 5 != 0 for i in range(40)])})
    assert w.commit() == 1
    w._release()
    return list(range(40))


def commit_more(root, ids, region=b"eu"):
    w = DatasetWriter(str(root), SCHEMA, ["region"])
    w.write_columns({"id": np.asarray(ids, dtype=np.int64),
                     "tag": [b"t%d" % i for i in ids],
                     "region": [region] * len(ids)})
    v = w.commit()
    w._release()
    return v


def _ids(vals, counts) -> list:
    out = []
    for u in range(vals.shape[0]):
        out.extend(np.asarray(vals[u, : counts[u]]).astype(np.uint32)
                   .view(np.uint8).view("<i8").ravel().tolist())
    return sorted(out)


def scan(D, root, *columns, **kw):
    """One ``DatasetScan`` of ``D``'s package on a two-slot mesh: what it
    resolved, its units, the ``id`` gather and the run's counters."""
    mesh = D.P.mesh()
    with D.ds.DatasetScan(str(root), *columns, mesh=mesh, **kw) as s:
        res, st = s.run_with_stats()
        got = {
            "version": s.version, "files": s.files(),
            "partitions": s.partitions, "pruned": s.files_pruned,
            "findings": [f.message for f in s.findings],
            "quarantine": s.quarantine.as_dicts(),
            "units": res,
            "ids": (_ids(*[np.asarray(a) for a in
                           s.gather_column(res, "id")])
                    if "id" in (columns or ("id",)) else None),
            "counters": {k: getattr(st, k) for k in (
                "dataset_files_pruned", "dataset_orphans_swept",
                "row_groups", "pages", "values", "bytes_read",
                "units_quarantined", "rows_pruned", "filter_rows_in",
                "filter_rows_out", "io_retries", "remote_retry")},
        }
    return got


def same_scan(ours, theirs):
    for k in ("version", "files", "partitions", "pruned", "findings",
              "quarantine", "ids", "counters"):
        assert ours[k] == theirs[k], k
    assert len(ours["units"]) == len(theirs["units"])
    for k, (a, b) in enumerate(zip(ours["units"], theirs["units"])):
        same_units(a, b, f"unit {k}")


def both_scans(root, *columns, **kw):
    theirs = scan(JAXD, root, *columns, **kw)
    ours = scan(PORTD, root, *columns, **kw)
    same_scan(ours, theirs)
    return ours


# ----------------------------------------------------------------------
# Round trip and partition pruning
# ----------------------------------------------------------------------

class TestRoundTrip:
    def test_write_scan_roundtrip(self, tmp_path):
        root = tmp_path / "ds"
        ids = write_snapshot_a(root)
        got = both_scans(root, "id", "tag")
        assert got["ids"] == ids and got["version"] == 1
        assert {p["region"] for p in got["partitions"].values()} \
            == {"eu", "us"}

    @pytest.mark.parametrize("filt,keep", [
        ("region == 'eu'", 1), ("region != 'eu'", 0),
        ("region in ('eu', 'us')", None), ("region > 'f'", 0),
        ("region == 'nowhere'", "none")])
    def test_partition_pruning_counts(self, tmp_path, filt, keep):
        root = tmp_path / "ds"
        write_snapshot_a(root)
        got = both_scans(root, "id", filter=filt)
        if keep == "none":
            assert got["pruned"] == 2 and got["units"] == []
        elif keep is None:
            assert got["pruned"] == 0 and got["ids"] == list(range(40))
        else:
            assert got["counters"]["dataset_files_pruned"] == 1
            assert got["ids"] == [i for i in range(40) if i % 2 == keep]

    def test_mixed_partition_and_data_filter(self, tmp_path):
        root = tmp_path / "ds"
        write_snapshot_a(root)
        theirs = scan(JAXD, root, "id", filter=(jax_col("region") == "us")
                      & (jax_col("id") < 10))
        ours = scan(PORTD, root, "id", filter=(port_col("region") == "us")
                    & (port_col("id") < 10))
        same_scan(ours, theirs)
        assert ours["ids"] == [0, 2, 4, 6, 8]

    @pytest.mark.parametrize("column", ["region", "id"])
    def test_partition_column_not_scannable(self, tmp_path, column):
        root = tmp_path / "ds"
        write_snapshot_a(root)
        got = [outcome(lambda D=D: D.ds.DatasetScan(
            str(root), column, mesh=D.P.mesh()).close()) for D in BOTH]
        assert got[0] == got[1]
        assert got[1][0] == ("ValueError" if column == "region" else "ok")

    @pytest.mark.parametrize("expr", [
        "region == 'us' or id < 10", "id < 3", "region == 'us'",
        "region == 'us' and id < 10", "(region == 'eu' or region == 'us')"
        " and id > 3 and tag is not null"])
    def test_split_partition_filter_as_reference(self, expr):
        got = []
        for D in BOTH:
            def split(D=D):
                part, rest = D.ds.split_partition_filter(expr, ["region"])
                return tuple(None if f is None else f.describe()
                             for f in (part, rest))
            got.append(outcome(split))
        assert got[0] == got[1]

    def test_null_partition_roundtrip(self, tmp_path):
        root = tmp_path / "ds"
        w = DatasetWriter(str(root), SCHEMA, ["region"])
        w.write_columns({"id": np.array([1, 2], dtype=np.int64),
                         "tag": [b"x", b"y"], "region": [b"eu", None]})
        w.commit()
        w._release()
        assert os.path.isdir(root / f"region={port_mf.HIVE_NULL}")
        theirs = scan(JAXD, root, "id",
                      filter=jax_col("region").is_null())
        ours = scan(PORTD, root, "id", filter=port_col("region").is_null())
        same_scan(ours, theirs)
        assert ours["ids"] == [2]

    @pytest.mark.parametrize("pred", ["== 'v'", "!= 'v'", "< 'w'",
                                      "is null", "is not null", "in",
                                      "== 3", "> 2.5"])
    @pytest.mark.parametrize("value", [None, "v", "z", 3, 2.5])
    def test_partition_matches_as_reference(self, pred, value):
        got = []
        for D in BOTH:
            c = D.col("k")
            p = {"== 'v'": c == "v", "!= 'v'": c != "v", "< 'w'": c < "w",
                 "is null": c.is_null(), "is not null": c.not_null(),
                 "in": c.isin(["v", 3]), "== 3": c == 3,
                 "> 2.5": c > 2.5}[pred]
            got.append(outcome(lambda: D.ds.partition_matches(
                p, {"k": value})))
        assert got[0] == got[1]


class TestScanParity:
    def test_bytes_and_counters_match_sharded_scan(self, tmp_path):
        root = tmp_path / "ds"
        write_snapshot_a(root)
        commit_more(root, range(100, 130), b"us")
        ds = scan(PORTD, root, "id", "tag")
        files = [src for src, _p, _r, _b in ds["files"]]
        with ShardedScan(files, "id", "tag", mesh=PORT.mesh()) as fs:
            units = fs.run()
        assert len(units) == len(ds["units"]) == 3
        for k, (a, b) in enumerate(zip(ds["units"], units)):
            for name in a:
                for x, y in zip(a[name].padded_buffers().values(),
                                b[name].padded_buffers().values()):
                    np.testing.assert_array_equal(x, y)


# ----------------------------------------------------------------------
# Snapshots, journals, orphans
# ----------------------------------------------------------------------

def _copies(root, tmp_path):
    """Two copies of a dataset root, one a package."""
    out = {}
    for D in BOTH:
        d = tmp_path / f"copy-{D.P.name}"
        shutil.copytree(root, d)
        out[D.P.name] = d
    return out


class TestQuarantine:
    def test_abort_leaves_orphans_sweep_quarantines(self, tmp_path):
        root = tmp_path / "ds"
        write_snapshot_a(root)
        w = DatasetWriter(str(root), SCHEMA, ["region"])
        w.write_columns({"id": np.array([100], dtype=np.int64),
                         "tag": [b"zz"], "region": [b"eu"]})
        w._stage_part(("eu",))  # staged but never committed
        w.abort()
        staged = sorted(os.listdir(root / port_mf.TMP_DIR))
        assert staged
        got = []
        for D, d in zip(BOTH, _copies(root, tmp_path).values()):
            q = D.Q()
            with D.P.collect_stats() as st:
                swept = D.mf.sweep_orphans(str(d), quarantine=q)
            assert os.listdir(d / port_mf.TMP_DIR) == []
            for rec in q.as_dicts():
                assert os.path.exists(os.path.join(str(d),
                                                   rec["swept_to"]))
            got.append((swept, q.as_dicts(), st.dataset_orphans_swept))
        assert got[0] == got[1]
        assert got[1][2] == len(staged) == len(got[1][0])

    @pytest.mark.parametrize("damage", ["corrupt", "version", "body",
                                        "escape"])
    def test_corrupt_newest_manifest_degrades(self, tmp_path, damage):
        root = tmp_path / "ds"
        ids = write_snapshot_a(root)
        assert commit_more(root, [99]) == 2
        m2 = root / port_mf.manifest_name(2)
        if damage == "corrupt":
            raw = bytearray(m2.read_bytes())
            raw[len(raw) // 2] ^= 0xFF
            m2.write_bytes(bytes(raw))
        else:
            import json

            doc = json.loads(m2.read_text())
            body = doc["body"]
            if damage == "version":
                body["version"] = 7
            elif damage == "body":
                body["partition_keys"] = "region"
            else:
                body["files"][0]["path"] = "../outside.parquet"
            doc["crc32"] = __import__("zlib").crc32(json.dumps(
                body, sort_keys=True, separators=(",", ":")).encode())
            m2.write_text(json.dumps(doc, sort_keys=True))
        got = both_scans(root, "id")
        assert got["version"] == 1 and got["ids"] == ids
        assert any(r.get("file", "").endswith(port_mf.manifest_name(2))
                   for r in got["quarantine"])
        assert [outcome(lambda D=D: [
            f.message for f in D.mf.resolve_manifest(str(root))[2]])
            for D in BOTH][0][1]

    @pytest.mark.parametrize("blob", [b'{"not": "an envelope"}', b"\xff\xfe",
                                      b""])
    def test_only_manifest_corrupt_raises(self, tmp_path, blob):
        root = tmp_path / "ds"
        write_snapshot_a(root)
        (root / port_mf.manifest_name(1)).write_bytes(blob)
        got = [outcome(lambda D=D: D.ds.DatasetScan(
            str(root), "id", mesh=D.P.mesh())) for D in BOTH]
        assert got[0] == got[1] and got[1][0] == "CorruptManifestError"

    @pytest.mark.parametrize("kind,kw", [
        ("corrupt", {"offset": 40, "xor": 0x5A}), ("truncate", {"keep": 30}),
        ("oserror", {}), ("transient", {"times": 2})])
    def test_manifest_load_fault_site(self, tmp_path, kind, kw):
        root = tmp_path / "ds"
        ids = write_snapshot_a(root)
        got = []
        for D in BOTH:
            with D.P.collect_stats() as st, \
                    D.P.faults.inject_faults() as inj:
                inj.inject("dataset.manifest.load", kind, **kw)
                o = outcome(lambda D=D: D.ds.DatasetScan(
                    str(root), "id", mesh=D.P.mesh()).version)
            got.append((o, st.faults_injected, st.io_retries))
        assert got[0] == got[1]
        # a transient load (and EIO) is retried to success; a corrupt or
        # torn one rejects the only snapshot, so the scan fails loudly
        assert (got[1][0][0] == "ok") == (kind in ("transient", "oserror"))
        assert both_scans(root, "id")["ids"] == ids

    def test_first_commit_killed_shows_nothing(self, tmp_path):
        """A first commit killed mid-protocol leaves a journal and no
        snapshot: the scan refuses, as the reference's, rather than
        discovering half-promoted hive files."""
        root = tmp_path / "ds"
        root.mkdir()
        env = dict(os.environ, JAX_PLATFORMS="cpu")
        proc = subprocess.Popen([sys.executable, CHILD, str(root), "3"],
                                cwd=REPO, env=env,
                                stdout=subprocess.DEVNULL,
                                stderr=subprocess.DEVNULL)
        try:
            assert proc.wait(timeout=120) == -signal.SIGKILL
        finally:
            if proc.poll() is None:
                proc.kill()
                proc.wait()
        assert os.path.exists(root / port_mf.JOURNAL_NAME)
        got = [outcome(lambda D=D: D.ds.DatasetScan(
            str(root), "id", mesh=D.P.mesh())) for D in BOTH]
        assert got[0] == got[1] and got[1][0] == "FileNotFoundError"
        assert "pending commit" in got[1][1]
        journal = [outcome(lambda D=D: sorted(
            e["path"] for e in D.mf.load_journal(str(root))["files"]))
            for D in BOTH]
        assert journal[0] == journal[1] and journal[1][0] == "ok"

    def test_scan_option_sweeps_orphans(self, tmp_path):
        root = tmp_path / "ds"
        ids = write_snapshot_a(root)
        w = DatasetWriter(str(root), SCHEMA, ["region"])
        w.write_columns({"id": np.array([7], dtype=np.int64),
                         "tag": [b"q"], "region": [b"us"]})
        w._stage_part(("us",))
        w.abort()
        (root / port_mf.JOURNAL_NAME).write_bytes(b"torn journal")
        got = []
        for D, d in zip(BOTH, _copies(root, tmp_path).values()):
            s = scan(D, d, "id", sweep_orphans=True)
            assert not (d / port_mf.JOURNAL_NAME).exists()
            # the copies' roots differ: compare the sources below them
            s["files"] = [(src.replace(str(d), "ROOT"), *rest)
                          for src, *rest in s["files"]]
            s["partitions"] = {k.replace(str(d), "ROOT"): v
                               for k, v in s["partitions"].items()}
            got.append(s)
        same_scan(got[1], got[0])
        assert got[1]["ids"] == ids
        assert {r["file"] for r in got[1]["quarantine"]} >= {
            port_mf.JOURNAL_NAME}


# ----------------------------------------------------------------------
# Remote roots and hive interop
# ----------------------------------------------------------------------

class TestRemoteDataset:
    @pytest.mark.parametrize("rule", [None, ("io.remote.throttle",
                                             "transient", 3)])
    def test_emu_root_scan(self, tmp_path, rule):
        root = tmp_path / "ds"
        ids = write_snapshot_a(root)
        uri = "emu://" + str(root)
        got = []
        for D in BOTH:
            with D.P.faults.inject_faults() as inj:
                if rule is not None:
                    inj.inject(rule[0], rule[1], times=rule[2])
                # the collector covers the construction: the manifest
                # read rides the byte-range source and its retries
                with D.P.collect_stats() as st:
                    s = scan(D, uri, "id")
            assert all(src.startswith("emu://")
                       for src, *_ in s["files"])
            got.append((s, st.io_retries, st.remote_retry,
                        st.faults_injected))
        same_scan(got[1][0], got[0][0])
        assert got[1][1:] == got[0][1:]
        assert got[1][0]["ids"] == ids
        assert (got[1][1] >= 1) == (rule is not None)


class TestPyarrowInterop:
    pa = pytest.importorskip("pyarrow")

    def _pads(self, root, nulls=False):
        import pyarrow as pa
        import pyarrow.dataset as pads

        regions = ["eu" if i % 2 else "us" for i in range(20)]
        if nulls:
            regions[3] = None
        table = pa.table({"id": pa.array(range(20), type=pa.int64()),
                          "region": pa.array(regions)})
        pads.write_dataset(table, str(root), format="parquet",
                           partitioning=pads.partitioning(
                               pa.schema([("region", pa.string())]),
                               flavor="hive"))

    @pytest.mark.parametrize("filt", ["region == 'eu'", None])
    def test_we_read_pyarrow_dataset(self, tmp_path, filt):
        root = tmp_path / "pads"
        self._pads(root)
        kw = {} if filt is None else {"filter": filt}
        got = both_scans(root, "id", **kw)
        assert got["version"] == 0  # the discovery manifest
        want = [i for i in range(20) if filt is None or i % 2]
        assert got["ids"] == want
        assert port_mf.discover_hive(str(root)) == \
            jax_mf.discover_hive(str(root))

    def test_inconsistent_depth_rejected(self, tmp_path):
        root = tmp_path / "pads"
        self._pads(root)
        odd = root / "region=eu" / "extra=1"
        odd.mkdir()
        shutil.copy(next((root / "region=eu").glob("*.parquet")), odd)
        got = [outcome(lambda D=D: D.mf.discover_hive(str(root)))
               for D in BOTH]
        assert got[0] == got[1] and got[1][0] == "CorruptManifestError"

    def test_empty_root_is_not_a_dataset(self, tmp_path):
        got = [outcome(lambda D=D: D.ds.DatasetScan(
            str(tmp_path), "id", mesh=D.P.mesh())) for D in BOTH]
        assert got[0] == got[1] and got[1][0] == "FileNotFoundError"

    @pytest.mark.parametrize("value", [None, "eu", "a/b c", 7, 2.5, b"x",
                                       "-3", "%41"])
    def test_hive_tokens_as_reference(self, value):
        tok = port_mf.hive_token(value)
        assert tok == jax_mf.hive_token(value)
        assert port_mf.parse_hive_token(tok) == jax_mf.parse_hive_token(tok)
        assert port_mf.partition_dir(["k"], {"k": value}) == \
            jax_mf.partition_dir(["k"], {"k": value})
