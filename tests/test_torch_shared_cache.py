"""The shared disk tier (``TPQ_CACHE_DISK_SHARED=1``) across processes,
against the JAX package.

Mirrors ``tests/test_shared_cache.py``: concurrent processes under chaos
seeds, a second wave that is all hits, SIGKILL anywhere then self-heal,
and a poisoned entry evicted fleet-wide, each certified by a digest of
every decoded array against the uncached oracle and by the fleet's
``cache_*_disk`` counters summed exactly.  The port's child processes
run :data:`CHILD` (``python -c``), code in this file; the JAX package's
run ``tests/shared_cache_child.py``.  A fleet may mix the two packages
over one directory (their entry frames and journal records are the
same), and a child of each package, alone on the same files, counts the
same.  Two of the port's servers over one tier keep each span's origin
fetches to one a process (the reference's ``TestFleetOriginEconomy``),
a process that joins the tier sweeps only dead writers' files, and a
replay during a put's append leaves the journal offset at its end.
Every child has a timeout of its own.
"""

from __future__ import annotations

import glob
import hashlib
import json
import os
import signal
import subprocess
import sys
import time

import numpy as np
import pytest

from tpuparquet.io import FileReader as JaxFileReader

from test_torch_remote import write_file  # noqa: E402

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
JAX_CHILD = os.path.join(REPO, "tests", "shared_cache_child.py")

FILES, GROUPS, COLS = 3, 2, 2
SPANS = FILES * GROUPS * COLS  # one entry a column chunk
TIMEOUT_S = 120

COUNTERS = ("cache_hits_disk", "cache_misses_disk", "cache_evictions_disk",
            "cache_hits_mem", "cache_misses_mem", "remote_ranges_fetched",
            "remote_bytes", "remote_retry", "ranges_coalesced")

#: the port's child: ``python -c CHILD OUT CORPUS_JSON``.  Reads every row
#: group of every source on the host through the process's range caches
#: (the ``TPQ_CACHE_*`` environment), under ``chaos_scope`` when
#: ``TPQ_CHAOS_SEED`` is set, and writes the digest of every decoded
#: array (the reference child's fold) and the counters to OUT.
CHILD = r"""
import contextlib, hashlib, json, os, sys
import numpy as np
from tpuparquet_torch.faults import chaos_scope
from tpuparquet_torch.io.reader import FileReader
from tpuparquet_torch.stats import collect_stats

out, corpus = sys.argv[1], sys.argv[2]
COUNTERS = %r
with open(corpus) as f:
    sources = json.load(f)["sources"]


def fold(h, arr):
    a = np.ascontiguousarray(np.asarray(arr))
    h.update(str(a.dtype).encode())
    h.update(str(a.shape).encode())
    h.update(a.tobytes())


h = hashlib.sha256()
ctx = chaos_scope() if os.environ.get("TPQ_CHAOS_SEED") \
    else contextlib.nullcontext()
with ctx, collect_stats() as st:
    for uri in sources:
        r = FileReader(uri)
        try:
            for g in range(len(r.meta.row_groups)):
                arrays = r.read_row_group_arrays(g)
                for path in sorted(arrays):
                    c = arrays[path]
                    h.update(path.encode())
                    fold(h, c.values)
                    fold(h, c.def_levels)
                    fold(h, c.rep_levels)
        finally:
            r.close()
result = {"pid": os.getpid(), "digest": h.hexdigest(),
          "counters": {k: getattr(st, k) for k in COUNTERS},
          "lockcheck": []}
with open(out + ".tmp", "w") as f:
    json.dump(result, f)
os.replace(out + ".tmp", out)
""" % (COUNTERS,)


def _corpus(tmp_path):
    return [write_file(tmp_path, name=f"f{i}.parquet", rows=240,
                       groups=GROUPS, seed=1000 + i) for i in range(FILES)]


def _oracle_digest(paths):
    """The uncached local read's digest, the children's fold."""
    h = hashlib.sha256()
    for p in paths:
        r = JaxFileReader(p)
        try:
            for g in range(len(r.meta.row_groups)):
                arrays = r.read_row_group_arrays(g)
                for path in sorted(arrays):
                    c = arrays[path]
                    h.update(path.encode())
                    for arr in (c.values, c.def_levels, c.rep_levels):
                        a = np.ascontiguousarray(np.asarray(arr))
                        h.update(str(a.dtype).encode())
                        h.update(str(a.shape).encode())
                        h.update(a.tobytes())
        finally:
            r.close()
    return h.hexdigest()


def _env(cache_dir, *, chaos_seed=None, emu_faults=False):
    env = {k: v for k, v in os.environ.items()
           if not k.startswith(("TPQ_CACHE_", "TPQ_EMU_", "TPQ_CHAOS",
                                "TPQ_LOCKCHECK", "PYTHONPATH"))}
    env.update({"JAX_PLATFORMS": "cpu", "TPQ_CACHE_DISK_DIR": str(cache_dir),
                "TPQ_CACHE_DISK_SHARED": "1", "TPQ_CACHE_DISK_MB": "256",
                "TPQ_RETRY_BASE_S": "0.001", "TPQ_RETRY_MAX_S": "0.004",
                "PYTHONPATH": REPO})
    if chaos_seed is not None:
        env["TPQ_CHAOS_SEED"] = str(chaos_seed)
    if emu_faults:
        env["TPQ_EMU_THROTTLE_EVERY"] = "7"
        env["TPQ_EMU_RESET_EVERY"] = "11"
        env["TPQ_EMU_SHORT_EVERY"] = "13"
    return env


def _spawn(pkg, corpus_json, out, env):
    cmd = ([sys.executable, "-c", CHILD, str(out), corpus_json]
           if pkg == "port"
           else [sys.executable, JAX_CHILD, "read", corpus_json, str(out)])
    return subprocess.Popen(cmd, cwd=REPO, env=env,
                            stdout=subprocess.PIPE, stderr=subprocess.PIPE)


def _finish(proc, what):
    try:
        out, err = proc.communicate(timeout=TIMEOUT_S)
    except subprocess.TimeoutExpired:
        proc.kill()
        out, err = proc.communicate()
        raise AssertionError(f"{what}: no end in {TIMEOUT_S} s\n"
                             f"{err.decode()[-3000:]}")
    assert proc.returncode == 0, (
        f"{what} rc={proc.returncode}\n{out.decode()}\n"
        f"{err.decode()[-3000:]}")


def _kill(proc):
    proc.kill()
    try:
        proc.wait(TIMEOUT_S)
    finally:
        for s in (proc.stdout, proc.stderr):
            s.close()


def _result(out):
    with open(out) as f:
        r = json.load(f)
    assert r["lockcheck"] == [], r["lockcheck"]
    return r


def _run(pkg, corpus_json, out, env, what=None):
    p = _spawn(pkg, corpus_json, out, env)
    _finish(p, what or f"{pkg} child")
    return _result(out)


def _setup(tmp_path):
    paths = _corpus(tmp_path)
    corpus_json = str(tmp_path / "corpus.json")
    with open(corpus_json, "w") as f:
        json.dump({"sources": ["emu://" + p for p in paths]}, f)
    cache = tmp_path / "cache"
    cache.mkdir()
    return paths, corpus_json, cache


def _entries(cache):
    return glob.glob(str(cache / "*.tpqc"))


class TestSharedCacheContention:
    @pytest.mark.parametrize("pair,seed", [(("port", "port"), 101),
                                           (("port", "port"), 202),
                                           (("port", "jax"), 303)])
    def test_two_processes_chaos_byte_identity_and_conservation(
            self, tmp_path, pair, seed):
        paths, corpus_json, cache = _setup(tmp_path)
        oracle = _oracle_digest(paths)
        procs, outs = [], []
        for i, pkg in enumerate(pair):
            out = tmp_path / f"r{i}.json"
            procs.append(_spawn(pkg, corpus_json, out,
                                _env(cache, chaos_seed=seed + i,
                                     emu_faults=True)))
            outs.append(out)
        for i, p in enumerate(procs):
            _finish(p, f"child {i} ({pair[i]}, seed {seed})")
        results = [_result(o) for o in outs]
        assert all(r["digest"] == oracle for r in results)
        fleet = {k: sum(r["counters"][k] for r in results)
                 for k in COUNTERS}
        # one disk lookup a chunk a process, each a hit or a miss
        assert fleet["cache_hits_disk"] + fleet["cache_misses_disk"] \
            == 2 * SPANS
        # chunk fetches: what exceeds the footer's reads (a memory miss
        # is one fetch); each process fetches a span at most once
        fetches = fleet["remote_ranges_fetched"] - fleet["cache_misses_mem"]
        assert 0 < fetches <= 2 * SPANS
        assert fleet["cache_evictions_disk"] == 0
        assert len(_entries(cache)) == SPANS
        assert not os.path.exists(cache / "index.lock")

    @pytest.mark.parametrize("warm,second", [("jax", "port"),
                                             ("port", "jax"),
                                             ("port", "port")])
    def test_second_wave_is_all_hits(self, tmp_path, warm, second):
        paths, corpus_json, cache = _setup(tmp_path)
        oracle = _oracle_digest(paths)
        r1 = _run(warm, corpus_json, tmp_path / "warm.json", _env(cache))
        r2 = _run(second, corpus_json, tmp_path / "second.json",
                  _env(cache))
        assert r1["digest"] == r2["digest"] == oracle
        assert r2["counters"]["cache_hits_disk"] == SPANS
        assert r2["counters"]["cache_misses_disk"] == 0
        # the footers' ranges only: the memory tier is per process
        assert r2["counters"]["remote_ranges_fetched"] == \
            r2["counters"]["cache_misses_mem"]

    def test_a_child_counts_as_the_reference(self, tmp_path):
        """One child of each package, alone over a directory of its own,
        under the same emulated faults: equal digests and counters."""
        paths, corpus_json, _cache = _setup(tmp_path)
        got = {}
        for pkg in ("jax", "port"):
            d = tmp_path / f"cache-{pkg}"
            d.mkdir()
            env = _env(d, emu_faults=True)
            # a source's five requests meet a throttle and a reset
            env.update(TPQ_EMU_THROTTLE_EVERY="3", TPQ_EMU_RESET_EVERY="4")
            got[pkg] = _run(pkg, corpus_json, tmp_path / f"{pkg}.json", env)
        assert got["port"]["digest"] == got["jax"]["digest"] == \
            _oracle_digest(paths)
        assert got["port"]["counters"] == got["jax"]["counters"]
        assert got["port"]["counters"]["remote_retry"] > 0


class TestKillResumeSweep:
    @pytest.mark.parametrize("kill_ms", [30, 90, 180])
    def test_sigkill_anywhere_self_heals_byte_identical(self, tmp_path,
                                                        kill_ms):
        paths, corpus_json, cache = _setup(tmp_path)
        oracle = _oracle_digest(paths)
        env = _env(cache, chaos_seed=303, emu_faults=True)
        # a slow origin, so the kill lands mid-scan
        env["TPQ_EMU_LATENCY_MS"] = "5"
        victim = _spawn("port", corpus_json, tmp_path / "victim.json", env)
        time.sleep(kill_ms / 1e3)
        _kill(victim)
        r = _run("port", corpus_json, tmp_path / "after.json",
                 _env(cache, chaos_seed=404, emu_faults=True),
                 f"post-kill child (kill at {kill_ms} ms)")
        assert r["digest"] == oracle
        assert r["counters"]["cache_evictions_disk"] == 0
        assert not os.path.exists(cache / "index.lock")
        r2 = _run("jax", corpus_json, tmp_path / "again.json", _env(cache),
                  "second post-kill child (the reference's)")
        assert r2["digest"] == oracle

    def test_kill_both_processes_concurrently(self, tmp_path):
        paths, corpus_json, cache = _setup(tmp_path)
        oracle = _oracle_digest(paths)
        env = _env(cache, emu_faults=True)
        env["TPQ_EMU_LATENCY_MS"] = "5"
        victims = [_spawn("port", corpus_json, tmp_path / f"v{i}.json", env)
                   for i in range(2)]
        time.sleep(0.12)
        for v in victims:
            v.send_signal(signal.SIGKILL)
        for v in victims:
            _kill(v)
        r = _run("port", corpus_json, tmp_path / "survivor.json",
                 _env(cache), "survivor child")
        assert r["digest"] == oracle
        assert not os.path.exists(cache / "index.lock")


class TestPoisonFleetVisibility:
    def test_poisoned_entry_refetched_direct_by_every_process(self,
                                                              tmp_path):
        paths, corpus_json, cache = _setup(tmp_path)
        oracle = _oracle_digest(paths)
        _run("jax", corpus_json, tmp_path / "warm.json", _env(cache))
        entries = sorted(_entries(cache))
        assert len(entries) == SPANS
        victim = entries[0]
        with open(victim, "r+b") as f:
            f.seek(-1, os.SEEK_END)
            last = f.read(1)
            f.seek(-1, os.SEEK_END)
            f.write(bytes([last[0] ^ 0xFF]))
        # one process after the other keeps the one-shot pin deterministic
        results = [_run("port", corpus_json, tmp_path / f"p{i}.json",
                        _env(cache), f"poison child {i}") for i in range(2)]
        assert all(r["digest"] == oracle for r in results)
        assert not os.path.exists(victim)
        assert SPANS - 1 <= len(_entries(cache)) <= SPANS
        # the detector journaled one eviction and did not re-cache at
        # once; the next process replayed it, evicting nothing itself
        assert results[0]["counters"]["cache_evictions_disk"] == 1
        assert results[1]["counters"]["cache_evictions_disk"] == 0


#: the port's server child: ``python -c SERVE_CHILD OUT CORPUS_JSON``.  A
#: one-tenant ``ScanServer`` job over the corpus on a CPU mesh, its
#: prefetch planner on (``TPQ_PREFETCH_DEPTH``); writes the digest of every
#: unit's arrays, in unit order, and the job's counters to OUT.
SERVE_CHILD = r"""
import hashlib, json, os, sys
import numpy as np
from tpuparquet_torch.serve import ResourceArbiter, ScanServer
from tpuparquet_torch.shard import make_mesh

out, corpus = sys.argv[1], sys.argv[2]
COUNTERS = %r
with open(corpus) as f:
    sources = json.load(f)["sources"]
h = hashlib.sha256()
server = ScanServer(arbiter=ResourceArbiter(total_workers=2),
                    mesh=make_mesh(1, devices=["cpu"]))
try:
    server.add_tenant("fleet")
    job = server.submit("fleet", sources)
    assert job.wait(300.0), "serve job did not finish"
    assert job.state == "done", f"job state {job.state}: {job.error}"
    for k in sorted(job.outputs):
        h.update(str(k).encode())
        for path in sorted(job.outputs[k]):
            h.update(path.encode())
            for part in job.outputs[k][path].to_numpy():
                a = np.ascontiguousarray(np.asarray(part))
                h.update(str(a.dtype).encode())
                h.update(str(a.shape).encode())
                h.update(a.tobytes())
finally:
    server.shutdown(drain=False)
result = {"pid": os.getpid(), "digest": h.hexdigest(),
          "counters": {k: getattr(job.stats, k) for k in COUNTERS},
          "lockcheck": []}
with open(out + ".tmp", "w") as f:
    json.dump(result, f)
os.replace(out + ".tmp", out)
""" % (COUNTERS,)


class TestFleetOriginEconomy:
    """Two server processes over one shared disk tier, each job's
    prefetch planner warming it: the servers decode the same bytes as
    the JAX package's server; each coalesced span reached the origin at
    most once a process, and the shared tier took the rest."""

    def test_two_servers_one_cache_origin_once_per_span(self, tmp_path):
        paths, corpus_json, cache = _setup(tmp_path)
        procs, outs = [], []
        for i in range(2):
            out = tmp_path / f"s{i}.json"
            env = _env(cache)
            env["TPQ_PREFETCH_DEPTH"] = "2"
            procs.append(subprocess.Popen(
                [sys.executable, "-c", SERVE_CHILD, str(out), corpus_json],
                cwd=REPO, env=env, stdout=subprocess.PIPE,
                stderr=subprocess.PIPE))
            outs.append(out)
        for i, p in enumerate(procs):
            _finish(p, f"server {i}")
        results = [_result(o) for o in outs]
        d = tmp_path / "jax-cache"
        d.mkdir()
        ref = tmp_path / "jax.json"
        p = subprocess.Popen(
            [sys.executable, JAX_CHILD, "serve", corpus_json, str(ref)],
            cwd=REPO, env=_env(d), stdout=subprocess.PIPE,
            stderr=subprocess.PIPE)
        _finish(p, "the JAX package's server")
        assert results[0]["digest"] == results[1]["digest"] == \
            _result(ref)["digest"]
        n_spans = len(_entries(cache))
        assert n_spans == SPANS
        hits = sum(r["counters"]["cache_hits_disk"] for r in results)
        misses = sum(r["counters"]["cache_misses_disk"] for r in results)
        assert misses <= 2 * n_spans
        assert hits + misses == 2 * SPANS and hits > 0
        # a chunk range fetched at most once a process: the footer's
        # ranges are the memory tier's misses
        for r in results:
            c = r["counters"]
            assert c["remote_ranges_fetched"] - c["cache_misses_mem"] \
                <= SPANS
        assert sum(r["counters"]["cache_evictions_disk"]
                   for r in results) == 0
        assert not os.path.exists(cache / "index.lock")


class TestSharedTierRaces:
    def test_join_sweeps_only_the_dead_writers_files(self, tmp_path):
        """A process that joins the shared tier sweeps the entry and
        temporary files the journal does not own only when their writer
        is dead: a live writer may be between its entry's rename and its
        journal record, or mid-write of its temporary file, and a sweep
        of those made its put fail or its record name a missing file (a
        fleet miss: two processes over one tier missed 1 chunk of 80 in
        about one run of 20)."""
        from tpuparquet_torch.io.rangecache import SharedDiskRangeCache

        live = subprocess.Popen([sys.executable, "-c",
                                 "import time; time.sleep(120)"])
        dead = subprocess.Popen([sys.executable, "-c", "pass"])
        dead.wait(TIMEOUT_S)
        d = tmp_path / "c"
        d.mkdir()
        try:
            SharedDiskRangeCache(str(d), 1 << 20)  # the first member
            h = "ab" * 20
            names = {}
            for who, pid in (("live", live.pid), ("dead", dead.pid)):
                entry = f"{h}.{pid:x}-1.tpqc"
                names[who] = [entry, f"{h}.{pid:x}-2.tpqc.{pid}.77.tmp",
                              f"index.tpqj.{pid}.tmp"]
                for fn in names[who]:
                    (d / fn).write_bytes(b"PART")
            (d / ("ff" * 20 + ".tpqc")).write_bytes(b"no writer")
            SharedDiskRangeCache(str(d), 1 << 20)  # a second one joins
            left = set(os.listdir(d))
            assert set(names["live"]) <= left
            assert not set(names["dead"]) & left
            assert "ff" * 20 + ".tpqc" not in left
        finally:
            live.kill()
            live.wait(TIMEOUT_S)

    def test_a_replay_during_an_append_keeps_the_offset(self, tmp_path,
                                                        monkeypatch):
        """A replay on another thread between a put's journal write and
        its offset update took the new records, and the put then moved
        the offset past them again: the offset stood beyond the journal's
        end, later replays read nothing, and another process's puts went
        unseen (a second put of the same key, an orphaned entry file)."""
        from tpuparquet_torch.io import rangecache as rc

        d = tmp_path / "c"
        d.mkdir()
        ours = rc.SharedDiskRangeCache(str(d), 1 << 20)
        theirs = rc.SharedDiskRangeCache(str(d), 1 << 20)
        fsync = os.fsync

        def fsync_then_replay(fd):
            fsync(fd)
            ours._replay()  # what a reading thread may do at this point

        monkeypatch.setattr(rc.os, "fsync", fsync_then_replay)
        ours.put(("etag", 0, 4), b"abcd")
        monkeypatch.setattr(rc.os, "fsync", fsync)
        assert ours._joff == os.path.getsize(d / "index.tpqj")
        theirs.put(("etag", 8, 4), b"efgh")  # another process's put
        assert ours.contains(("etag", 8, 4))
        assert ours.get(("etag", 8, 4)) == b"efgh"
