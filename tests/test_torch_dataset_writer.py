"""The port's dataset writer and compaction against the JAX package's.

Mirrors the write side of ``tests/test_dataset.py``: both packages'
``DatasetWriter`` and ``compact_dataset`` run the same writes on the same
numpy inputs (seeded) and must leave trees equal byte for byte (data
files, manifests, pruned snapshots), given the same ``created_by`` (the
port's writer defaults to ``"tpuparquet_torch"``, the JAX writer's to
``"tpuparquet"``).  Covered: string, int and null partitions, masks,
rolls at a small target, several commits, ``remove_paths``, commits of
one package on the other's snapshot, a journal the JAX writer left
resumed by the port, the kill sweep at every protocol step (the port's
child is ``python -c`` code below; the oracle is the JAX package's
``tests/dataset_child.py``), the two write fault sites, the split encode
budget with and without a tenant binding, ``compact_dataset``'s reports,
trees and refusals, and ``parquet_tool compact`` through both CLIs.
A run that must compare error words or absolute paths runs both
packages in the same directory, one after the other.
"""

from __future__ import annotations

import hashlib
import os
import shutil
import signal
import subprocess
import sys
from types import SimpleNamespace

import numpy as np
import pytest

from tpuparquet import dataset as jax_ds
from tpuparquet import faults as jax_faults
from tpuparquet.cli import parquet_tool as jax_tool
from tpuparquet.dataset import manifest as jax_mf
from tpuparquet.serve import arbiter as jax_arbiter
from tpuparquet_torch import dataset as port_ds
from tpuparquet_torch import faults as port_faults
from tpuparquet_torch.cli import parquet_tool as port_tool
from tpuparquet_torch.dataset import manifest as port_mf
from tpuparquet_torch.kernels.device import read_row_groups_device
from tpuparquet_torch.io.reader import FileReader
from tpuparquet_torch.serve import arbiter as port_arbiter
from tpuparquet_torch.shard import make_mesh

SCHEMA = """message rec {
  required int64 id;
  optional binary tag (STRING);
  required binary region (STRING);
}"""

INT_SCHEMA = """message rec {
  required int64 id;
  optional double x;
  required int32 k;
  required binary region (STRING);
}"""

CREATED_BY = "tpuparquet"
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
JAX_CHILD = os.path.join(REPO, "tests", "dataset_child.py")

JAX = SimpleNamespace(name="jax", ds=jax_ds, mf=jax_mf,
                      faults=jax_faults, tool=jax_tool, arb=jax_arbiter)
PORT = SimpleNamespace(name="port", ds=port_ds, mf=port_mf,
                       faults=port_faults, tool=port_tool,
                       arb=port_arbiter)
SIDES = (JAX, PORT)


@pytest.fixture(autouse=True)
def _fresh(monkeypatch):
    for k in list(os.environ):
        if k.startswith(("TPQ_DATASET_", "TPQ_CACHE_", "TPQ_EMU_")) \
                or k in ("TPQ_SOURCE", "TPQ_PAGE_ROWS", "TPQ_WRITE_THREADS"):
            monkeypatch.delenv(k)
    monkeypatch.setenv("TPQ_RETRY_BASE_S", "0.0005")
    monkeypatch.setenv("TPQ_RETRY_MAX_S", "0.002")
    yield
    for side in SIDES:
        a = side.arb.active()
        if a is not None:
            side.arb.deactivate(a)
        side.arb._reset_oversub_warning()


def writer(S, root, schema=SCHEMA, keys=("region",), **kw):
    return S.ds.DatasetWriter(str(root), schema, list(keys),
                              created_by=CREATED_BY, **kw)


def tree(root) -> dict:
    """Every file under ``root`` (relative path -> bytes); the staging
    and quarantine directories are empty after a commit."""
    out = {}
    for d, _, files in os.walk(root):
        for f in files:
            p = os.path.join(d, f)
            with open(p, "rb") as fh:
                out[os.path.relpath(p, root)] = fh.read()
    return out


def batch(rng, n, start=0):
    ids = np.arange(start, start + n, dtype=np.int64)
    regions = [[b"eu", b"us", b"ap"][int(i)] for i in rng.integers(0, 3, n)]
    return ({"id": ids,
             "tag": [b"t-%d" % i for i in ids],
             "region": regions},
            {"tag": rng.random(n) >= 0.2})


def commit(S, root, cols, masks=None, **kw):
    w = writer(S, root, **kw)
    w.write_columns(cols, masks=masks)
    v = w.commit()
    w._release()
    return v


# ----------------------------------------------------------------------
# the writes: trees byte for byte
# ----------------------------------------------------------------------

def _strings(S, root):
    rng = np.random.default_rng(1)
    return [commit(S, root, *batch(rng, 40))]


def _ints(S, root):
    rng = np.random.default_rng(2)
    n = 300
    x = rng.random(n)
    mask = rng.random(n) >= 0.3
    w = writer(S, root, INT_SCHEMA, ("k", "region"))
    w.write_columns({"id": np.arange(n, dtype=np.int64), "x": x,
                     "k": rng.integers(-2, 3, n).astype(np.int32),
                     "region": ["eu" if v else "us"
                                for v in rng.random(n) < 0.5]},
                    masks={"x": mask})
    v = w.commit()
    w._release()
    return [v]


def _int_keys(S, root):
    """Integer and boolean keys only: the writer groups them in numpy."""
    rng = np.random.default_rng(13)
    n = 400
    w = writer(S, root, """message rec {
      required int64 id;
      optional double x;
      required int32 k;
      required boolean b;
    }""", ("k", "b"))
    for i in range(2):
        w.write_columns({"id": np.arange(n * i, n * (i + 1), dtype=np.int64),
                         "x": rng.random(n),
                         "k": rng.integers(-12, 12, n).astype(np.int32),
                         "b": rng.random(n) < 0.3},
                        masks={"x": rng.random(n) >= 0.1})
    v = w.commit()
    w._release()
    return [v]


def _nulls(S, root):
    rng = np.random.default_rng(3)
    cols, masks = batch(rng, 50)
    cols["region"] = [None if i % 4 == 0 else r
                      for i, r in enumerate(cols["region"])]
    return [commit(S, root, cols, masks)]


def _rolls(S, root):
    rng = np.random.default_rng(4)
    w = writer(S, root, target_mb=0.002)
    for i in range(6):
        cols, masks = batch(rng, 80, start=80 * i)
        w.write_columns(cols, masks=masks)
    v = w.commit()
    w._release()
    return [v, len(tree(root))]


def _commits(S, root):
    rng = np.random.default_rng(5)
    return [commit(S, root, *batch(rng, 30, start=30 * i), manifest_keep=2)
            for i in range(4)]


def _removes(S, root):
    rng = np.random.default_rng(6)
    versions = [commit(S, root, *batch(rng, 30, start=30 * i))
                for i in range(2)]
    body, _, _ = S.mf.resolve_manifest(str(root))
    drop = [e["path"] for e in body["files"]
            if e["partition"]["region"] == "eu"]
    w = writer(S, root)
    cols, masks = batch(rng, 20, start=100)
    w.write_columns(cols, masks=masks)
    versions.append(w.commit(remove_paths=drop))
    w._release()
    return versions


@pytest.mark.parametrize("case", [_strings, _ints, _int_keys, _nulls,
                                  _rolls, _commits, _removes],
                         ids=["strings", "ints", "int keys", "null partition",
                              "rolls", "several commits", "remove_paths"])
def test_trees_equal(tmp_path, case):
    got = []
    for S in SIDES:
        root = tmp_path / S.name
        got.append((case(S, root), tree(root)))
    assert got[1][0] == got[0][0]
    assert got[1][1] == got[0][1]
    assert any(p.endswith(".parquet") for p in got[1][1])


@pytest.mark.parametrize("first", ["jax", "port"])
def test_commit_on_the_other_package_snapshot(tmp_path, first):
    """A snapshot of one package with a commit of the other on top equals
    either package's two commits."""
    order = SIDES if first == "jax" else SIDES[::-1]
    trees = []
    for pair in (order, (JAX, JAX), (PORT, PORT)):
        root = tmp_path / f"{pair[0].name}-{pair[1].name}"
        rng = np.random.default_rng(7)
        for i, S in enumerate(pair):
            commit(S, root, *batch(rng, 40, start=40 * i))
        trees.append(tree(root))
    assert trees[0] == trees[1] == trees[2]


class _Crash(Exception):
    pass


def test_port_resumes_a_journal_the_jax_writer_left(tmp_path):
    """The JAX writer dies after its first promote (the journal written,
    one file published); the port's ``resume_from=`` finishes the commit
    into the tree of an uninterrupted JAX commit."""
    rng = np.random.default_rng(8)
    base_cols = batch(rng, 40)
    more = batch(rng, 60, start=1000)
    oracle = tmp_path / "oracle"
    root = tmp_path / "ds"
    for r in (oracle, root):
        commit(JAX, r, *base_cols)
    commit(JAX, oracle, *more)
    seen = []

    def hook(label):
        seen.append(label[0])
        if seen.count("promote") == 2:
            raise _Crash

    w = writer(JAX, root, step_hook=hook)
    w.write_columns(*more[:1], masks=more[1])
    with pytest.raises(_Crash):
        w.commit()
    w._release()
    assert os.path.exists(root / "_commit.json")
    w = writer(PORT, root, resume_from=str(root))
    assert w.commit() == 2
    w._release()
    assert tree(root) == tree(oracle)


# ----------------------------------------------------------------------
# the kill sweep: the port's child killed at every protocol step
# ----------------------------------------------------------------------

CHILD = r"""
import os, signal, sys
import numpy as np
from tpuparquet_torch.dataset import DatasetWriter

SCHEMA = '''message rec {
  required int64 id;
  optional binary tag (STRING);
  required binary region (STRING);
}'''
N = 60
root, kill_at = sys.argv[1], int(sys.argv[2])
count = [0]


def hook(label):
    if count[0] == kill_at:
        os.kill(os.getpid(), signal.SIGKILL)
    count[0] += 1
    if kill_at < 0:
        print(":".join(str(p) for p in label), flush=True)


w = DatasetWriter(root, SCHEMA, ["region"], step_hook=hook,
                  resume_from=root, created_by="tpuparquet")
ids = np.arange(1000, 1000 + N, dtype=np.int64)
w.write_columns({"id": ids, "tag": [b"tag-%03d" % i for i in range(N)],
                 "region": [b"eu" if i % 3 == 0 else b"us"
                            for i in range(N)]},
                masks={"tag": np.array([i % 7 != 0 for i in range(N)])})
w.commit()
w._release()
"""


def _child_env() -> dict:
    env = dict(os.environ)
    env["JAX_PLATFORMS"] = "cpu"
    for k in ("TPQ_CHAOS_SEED", "TPQ_LOCKCHECK", "PYTHONPATH"):
        env.pop(k, None)
    return env


def _run(cmd, want_kill: bool):
    proc = subprocess.Popen(cmd, cwd=REPO, env=_child_env(),
                            stdout=subprocess.PIPE, stderr=subprocess.PIPE)
    try:
        out, err = proc.communicate(timeout=120)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.communicate()
    want = -signal.SIGKILL if want_kill else 0
    assert proc.returncode == want, err.decode()[-2000:]
    return [ln for ln in out.decode().splitlines() if ln.strip()]


def port_child(root, kill_at: int):
    return _run([sys.executable, "-c", CHILD, str(root), str(kill_at)],
                kill_at >= 0)


def _ids(root) -> list:
    with port_ds.DatasetScan(str(root), "id",
                             mesh=make_mesh(1, devices=["cpu"])) as s:
        return sorted(int(v) for out in s.run()
                      for v in out["id"].to_numpy()[0])


def _published(root) -> dict:
    body, _, _ = port_mf.resolve_manifest(str(root))
    out = {}
    for e in body["files"]:
        with open(os.path.join(str(root), e["path"]), "rb") as f:
            digest = hashlib.sha256(f.read()).hexdigest()
        out[e["path"]] = (e["partition"], e["rows"], e["bytes"], e["sha1"],
                          digest)
    return out


def test_kill_at_every_step_then_resume(tmp_path):
    base = tmp_path / "base"
    commit(JAX, base, *batch(np.random.default_rng(9), 40))
    a_ids = _ids(base)
    oracle = tmp_path / "oracle"
    shutil.copytree(base, oracle)
    steps = _run([sys.executable, JAX_CHILD, str(oracle), "-1"], False)
    assert [s.split(":")[0] for s in steps] == [
        "stage", "stage", "journal", "promote", "promote", "manifest",
        "clean"]
    oracle_ids, oracle_state = _ids(oracle), _published(oracle)
    assert len(oracle_ids) == len(a_ids) + 60
    for kill_at in range(len(steps)):
        root = tmp_path / f"k{kill_at}"
        shutil.copytree(base, root)
        port_child(root, kill_at)
        assert _ids(root) in (a_ids, oracle_ids), kill_at
        port_child(root, -1)
        assert _ids(root) == oracle_ids, kill_at
        assert _published(root) == oracle_state, kill_at
        q = port_faults.QuarantineReport()
        port_mf.sweep_orphans(str(root), quarantine=q)
        assert os.listdir(root / port_mf.TMP_DIR) == []
        for rec in q.as_dicts():
            assert os.path.exists(os.path.join(str(root), rec["swept_to"]))


def test_first_commit_kill_shows_nothing(tmp_path):
    root = tmp_path / "ds"
    root.mkdir()
    port_child(root, 3)  # the first promote
    with pytest.raises(FileNotFoundError, match="pending commit"):
        port_ds.DatasetScan(str(root), "id")
    port_child(root, -1)
    assert len(_ids(root)) == 60


# ----------------------------------------------------------------------
# the write fault sites
# ----------------------------------------------------------------------

@pytest.mark.parametrize("site,after", [
    ("dataset.manifest.write", 0), ("dataset.manifest.write", 1),
    ("dataset.file.promote", 0), ("dataset.file.promote", 1)],
    ids=["journal write", "manifest write", "first promote",
         "second promote"])
@pytest.mark.parametrize("kind", ["oserror", "transient"])
def test_write_fault_sites(tmp_path, site, after, kind):
    """An injected fault fails the commit with the same error in both
    packages and leaves the same tree; a resume then publishes the same
    snapshot."""
    rng = np.random.default_rng(10)
    base = batch(rng, 30)
    more = batch(rng, 30, start=500)
    root = tmp_path / "ds"
    got = []
    for S in SIDES:
        commit(S, root, *base)
        w = writer(S, root)
        w.write_columns(more[0], masks=more[1])
        with S.faults.inject_faults() as inj:
            inj.inject(site, kind, times=1, after=after)
            with pytest.raises(OSError) as ei:
                w.commit()
        w._release()
        failed = tree(root)
        w = writer(S, root, resume_from=str(root))
        version = w.commit()
        w._release()
        got.append((type(ei.value).__name__, str(ei.value), failed,
                    version, tree(root)))
        shutil.move(str(root), str(tmp_path / f"done-{S.name}"))
    assert got[1] == got[0]


# ----------------------------------------------------------------------
# the split encode budget
# ----------------------------------------------------------------------

@pytest.mark.parametrize("bound", [False, True],
                         ids=["write threads", "tenant share"])
def test_split_encode_budget(tmp_path, monkeypatch, bound):
    """``k`` partitions of one call encode at ``max(1, W // k)`` threads
    each, ``W`` from ``TPQ_WRITE_THREADS`` or the bound tenant's share."""
    import contextlib

    monkeypatch.setenv("TPQ_WRITE_THREADS", "7")
    got = []
    for S in SIDES:
        rng = np.random.default_rng(11)
        scope, arb, budget = contextlib.nullcontext(), None, 7
        if bound:
            arb = S.arb.ResourceArbiter(total_workers=10)
            arb.register("a")
            arb.register("b", weight=4.0)
            S.arb.activate(arb)
            scope, budget = S.arb.tenant_scope("b"), arb.share_of("b")
        shares = []
        try:
            with scope:
                w = writer(S, tmp_path / S.name)
                for n_parts in (1, 2, 3):
                    cols, masks = batch(rng, 200)
                    cols["region"] = [[b"eu", b"us", b"ap"][i % n_parts]
                                      for i in range(200)]
                    w.write_columns(cols, masks=masks)
                    shares.append(sorted(p.writer.encode_threads
                                         for p in w._parts.values()))
                w.abort()
        finally:
            if arb is not None:
                S.arb.deactivate(arb)
        assert shares == [[budget], [budget // 2] * 2,
                          [max(1, budget // 3)] * 3]
        got.append((budget, shares))
    assert got[1] == got[0]


# ----------------------------------------------------------------------
# compaction
# ----------------------------------------------------------------------

def _small_files(S, root):
    rng = np.random.default_rng(12)
    for i in range(3):
        commit(S, root, *batch(rng, 50, start=50 * i))


@pytest.mark.parametrize("sort_by,target_mb", [("id", None),
                                               ("tag", None),
                                               (None, 0.002)],
                         ids=["by id", "by tag with nulls", "rolls"])
def test_compact_reports_and_trees_equal(tmp_path, sort_by, target_mb):
    got = []
    for S in SIDES:
        root = tmp_path / "ds"
        _small_files(S, root)
        rep = S.ds.compact_dataset(str(root), sort_by=sort_by,
                                   target_mb=target_mb, manifest_keep=1,
                                   created_by=CREATED_BY)
        got.append((rep, tree(root)))
        shutil.move(str(root), str(tmp_path / f"done-{S.name}"))
    assert got[1] == got[0]
    rep = got[1][0]
    assert rep["files_before"] == 9 and rep["rows"] == 150 and rep["gc"]


def _no_manifest(S, root):
    os.makedirs(root)


def _no_schema(S, root):
    os.makedirs(root)
    S.mf.write_manifest(str(root), {"version": 1,
                                    "partition_keys": ["region"],
                                    "files": []})


def _nested(S, root):
    os.makedirs(root)
    S.mf.write_manifest(str(root), {
        "version": 1, "partition_keys": ["region"], "files": [],
        "schema": "message m { optional group l (LIST) { repeated group "
                  "list { optional int64 element; } } required binary "
                  "region (STRING); }"})


@pytest.mark.parametrize("make,sort_by,err", [
    (_no_manifest, None, FileNotFoundError),
    (_no_schema, None, ValueError),
    (_nested, None, NotImplementedError),
    (_small_files, "nope", ValueError)],
    ids=["no manifest", "no schema", "nested column", "unknown sort_by"])
def test_compact_refusals(tmp_path, make, sort_by, err):
    got = []
    for S in SIDES:
        root = tmp_path / "ds"
        make(S, root)
        with pytest.raises(err) as ei:
            S.ds.compact_dataset(str(root), sort_by=sort_by)
        got.append((type(ei.value).__name__, str(ei.value), tree(root)))
        shutil.move(str(root), str(tmp_path / f"done-{S.name}"))
    assert got[1] == got[0]


@pytest.mark.parametrize("argv,make", [
    (["compact", "--sort-by", "id", "--keep", "1"], _small_files),
    (["compact", "--target-mb", "1"], _small_files),
    (["compact"], _no_manifest)], ids=["sorted", "target", "no manifest"])
def test_compact_cli(tmp_path, capsys, monkeypatch, argv, make):
    monkeypatch.setenv("TPQ_PAGE_ROWS", "16")
    got = []
    for S in SIDES:
        root = tmp_path / "ds"
        make(S, root)
        capsys.readouterr()
        rc = S.tool.main(argv + [str(root)])
        got.append((rc, capsys.readouterr().out, tree(root)
                    if os.path.isdir(root) else None))
        if os.path.isdir(root):
            shutil.move(str(root), str(tmp_path / f"done-{S.name}"))
    # the CLI writes with each package's default created_by, so the new
    # files' bytes and names differ; test_compact_reports_and_trees_equal
    # compares them under one created_by
    assert got[1][:2] == got[0][:2]
    assert (got[1][2] is None) == (got[0][2] is None)
    if got[1][2] is not None:
        assert len(got[1][2]) == len(got[0][2])


def test_compacted_dataset_reads_back(tmp_path):
    """The port's compaction sorted by ``id``: the host decode of the new
    files gives every row once, ascending within each partition."""
    root = tmp_path / "ds"
    _small_files(PORT, root)
    port_ds.compact_dataset(str(root), sort_by="id", manifest_keep=1)
    body, _, _ = port_mf.resolve_manifest(str(root))
    ids = []
    for e in body["files"]:
        r = FileReader(os.path.join(str(root), e["path"]))
        part = np.concatenate([out["id"].to_numpy()[0] for _, out in
                               read_row_groups_device(r, device="cpu")])
        assert np.all(np.diff(part) > 0)
        ids.extend(part.tolist())
    assert sorted(ids) == list(range(150))


# ----------------------------------------------------------------------
# chip_smoke.py's phase 16, rehearsed on the CPU
# ----------------------------------------------------------------------

def test_chip_smoke_phase16_on_the_cpu(monkeypatch):
    """Phase 16's checks at a small size on a mesh of a ``cpu`` slot:
    the plain versions launch nothing, so only the launch requirements
    are left out.  Small targets make the write roll and the pages split
    as the full size does."""
    import torch

    sys.path.insert(0, REPO)
    import chip_smoke

    monkeypatch.setattr(chip_smoke, "_need", lambda *a, **k: None)
    _, groups = chip_smoke.build_config2(400_000, 8)
    cpu = torch.device("cpu")
    wrappers = chip_smoke.kernel_wrappers()
    chip_smoke.check_dataset(groups, make_mesh(1, devices=["cpu"]), cpu,
                             wrappers, target_mb=0.05, compact_mb=0.5,
                             page_rows=1024)
    chip_smoke.check_floor(groups, cpu, wrappers, n_objects=8000,
                           n_row_path=1000)
