"""The command-line tools of tpuparquet_torch (``cli/parquet_tool.py`` and
``cli/csv2parquet.py``) against the JAX package's.

Every ported subcommand runs on the same files, progress exports, rings,
profiles, traces and status documents in both packages: the exit codes
and the outputs are equal, with the timings of ``verify`` and
``profile`` masked.  The cases are those of ``tests/test_cli.py`` and the
CLI cases of ``test_live_obs.py`` (``top``), ``test_profiler.py``
(``flame``, ``doctor --profile``), ``test_salvage.py`` (``rescue``),
``test_timeseries.py`` (``watch``, ``slo``) and ``test_trace.py``
(``doctor``).  Files that the tools write (``split``'s parts,
``rescue``'s output, ``csv2parquet``'s file, ``serve``'s unit files) are
equal byte for byte or array for array.  The device paths run with
``--device cpu``; without it and without CUDA, ``verify`` raises.
"""

from __future__ import annotations

import contextlib
import io
import json
import os
import re
import subprocess
import sys
import time

import numpy as np
import pytest
import torch

from tpuparquet import CompressionCodec as JaxCodec
from tpuparquet import FileWriter as JaxFileWriter
from tpuparquet.cli import csv2parquet as jax_c2p
from tpuparquet.cli import parquet_tool as jax_pt
from tpuparquet.obs import progress as jax_progress
from tpuparquet_torch.cli import csv2parquet as c2p
from tpuparquet_torch.cli import parquet_tool as pt
from tpuparquet_torch.obs import progress as port_progress

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

SAMPLE = """message m {
    required int64 id;
    optional binary name (STRING);
    optional group tags (LIST) { repeated group list {
        optional binary element (STRING); } }
}"""


@pytest.fixture()
def sample_file(tmp_path):
    """``tests/test_cli.py``'s sample: 25 records, a null name every 5th,
    one tag each, SNAPPY."""
    p = str(tmp_path / "sample.parquet")
    with open(p, "wb") as f:
        w = JaxFileWriter(f, SAMPLE, codec=JaxCodec.SNAPPY)
        for i in range(25):
            w.add_data({
                "id": i,
                "name": f"name-{i}".encode() if i % 5 else None,
                "tags": {"list": [{"element": b"t%d" % i}]},
            })
        w.close()
    return p


def run(mod, *argv):
    """``mod.main(argv)``: ``(rc, stdout, stderr)``, or the raised
    error's class and words in place of the rc."""
    out, err = io.StringIO(), io.StringIO()
    with contextlib.redirect_stdout(out), contextlib.redirect_stderr(err):
        try:
            rc = mod.main(list(argv))
        except Exception as e:  # noqa: BLE001 - the outcome compared
            rc = (type(e).__name__, str(e))
    return rc, out.getvalue(), err.getvalue()


def both(*argv, port_argv=()):
    """The JAX tool's and the port's outcome of ``argv`` (the port's with
    ``port_argv`` after the subcommand), held equal; the port's."""
    theirs = run(jax_pt, *argv)
    ours = run(pt, *(argv[:1] + tuple(port_argv) + argv[1:]))
    assert ours == theirs
    return ours


# ----------------------------------------------------------------------
# sizes, records, metadata
# ----------------------------------------------------------------------

@pytest.mark.parametrize("s", ["1024", "1KB", "1KiB", "100MB", "2GiB",
                               " 5MB ", "", "abc", "12XB", "3PiB"])
def test_human_to_bytes_as_reference(s):
    def outcome(fn):
        try:
            return fn(s)
        except ValueError as e:
            return str(e)

    assert outcome(pt.human_to_bytes) == outcome(jax_pt.human_to_bytes)


@pytest.mark.parametrize("argv", [
    ["rowcount"], ["schema"], ["cat"], ["cat", "--trace"], ["head"],
    ["head", "-n", "2"], ["head", "-n", "0"], ["meta"],
    ["meta", "--strict"]], ids=" ".join)
def test_inspect_commands_as_reference(sample_file, argv):
    if argv == ["cat", "--trace"]:
        # the decode summary on stderr carries the wall: masked
        got = [run(mod, *argv, sample_file) for mod in (jax_pt, pt)]
        wall = re.compile(r"[0-9.]+s = [0-9,]+ values/s")
        assert [(rc, out, wall.sub("-", err)) for rc, out, err in got][1] \
            == [(rc, out, wall.sub("-", err)) for rc, out, err in got][0]
        assert got[1][2].startswith("decoded 75 values")
        return
    rc, out, _err = both(*argv, sample_file)
    assert rc == 0 and (out or argv[-1] == "0")


def test_inspect_nested_and_logical_file(tmp_path):
    """``cat``, ``meta`` and ``schema`` of structs, a MAP, unsigned and
    logical types, statistics and a bloom filter."""
    schema = """message m {
        required int32 d (DATE);
        optional group loc { required double lat; optional int32 z
            (INT(16, false)); }
        optional group mm (MAP) { repeated group key_value {
            required binary key (STRING); optional int64 value; } }
        optional binary j (JSON);
    }"""
    p = str(tmp_path / "n.parquet")
    rng = np.random.default_rng(2)
    with open(p, "wb") as f:
        w = JaxFileWriter(f, schema, bloom_columns=["d"], page_rows=7)
        for i in range(30):
            row = {"d": int(rng.integers(0, 20000))}
            if i % 3:
                row["loc"] = {"lat": float(rng.random()),
                              "z": int(rng.integers(0, 65536))}
            if i % 4:
                row["mm"] = {"key_value": [
                    {"key": b"k%d" % j, "value": j} for j in range(i % 3)]}
            if i % 2:
                row["j"] = b'{"a": %d}' % i
            w.add_data(row)
        w.close()
    for argv in (["cat"], ["meta"], ["meta", "--strict"], ["schema"]):
        rc, out, _ = both(*argv, p)
        assert rc == 0 and out


def test_missing_file_errors(tmp_path):
    rc, _out, err = both("rowcount", str(tmp_path / "nope.parquet"))
    assert rc == 1 and "parquet-tool:" in err


# ----------------------------------------------------------------------
# split
# ----------------------------------------------------------------------

@pytest.mark.parametrize("args", [
    ["-s", "600", "-c", "none"], ["-s", "1", "-c", "none"],
    ["-s", "2KB", "-r", "300", "-c", "snappy"],
    ["-s", "100MB", "-c", "gzip"]], ids=" ".join)
def test_split_parts_as_reference(sample_file, tmp_path, args):
    """The same parts, byte for byte, and the same words."""
    outs = []
    for name, mod in (("jax", jax_pt), ("port", pt)):
        target = tmp_path / name
        target.mkdir()
        rc, out, _ = run(mod, "split", *args, "-t", str(target),
                         sample_file)
        assert rc == 0
        parts = sorted(os.listdir(target))
        outs.append((out.replace(str(target), "<t>"), parts,
                     [(target / q).read_bytes() for q in parts]))
    assert outs[1] == outs[0]
    ids = []
    for blob in outs[1][2]:
        from tpuparquet_torch.io.reader import FileReader

        ids += [row["id"] for row in FileReader(blob).rows()]
    assert ids == list(range(25))
    if args[1] == "1":
        assert len(outs[1][1]) == 25  # a part a row, no empty last part


def test_split_empty_input(tmp_path):
    p = str(tmp_path / "empty.parquet")
    with open(p, "wb") as f:
        JaxFileWriter(f, SAMPLE).close()
    outs = []
    for name, mod in (("jax", jax_pt), ("port", pt)):
        target = tmp_path / name
        target.mkdir()
        assert run(mod, "split", "-t", str(target), p)[0] == 0
        outs.append([(q, (target / q).read_bytes())
                     for q in sorted(os.listdir(target))])
    assert outs[1] == outs[0] and len(outs[1]) == 1


# ----------------------------------------------------------------------
# csv2parquet
# ----------------------------------------------------------------------

CSV = """id,name,score,flag,blob
1,alpha,1.5,true,{"a": 1}
2,beta,2.5,false,{"b": 2}
3,,3.5,true,
"""


def c2p_both(tmp_path, text, *args):
    """Both converters on ``text``: their rc and stderr held equal, and
    their output files equal byte for byte (or both absent)."""
    src = tmp_path / "in.csv"
    src.write_text(text)
    got = []
    for name, mod in (("jax", jax_c2p), ("port", c2p)):
        dst = tmp_path / f"{name}.parquet"
        err = io.StringIO()
        with contextlib.redirect_stderr(err):
            rc = mod.main(["--input", str(src), "--output", str(dst),
                           *args])
        got.append((rc, err.getvalue().replace(str(dst), "<out>"),
                    dst.read_bytes() if dst.exists() else None))
    assert got[1] == got[0]
    return got[1]


@pytest.mark.parametrize("text,args", [
    (CSV, ["--typehints",
           "id=int64,score=double,flag=boolean,blob=json"]),
    (CSV, ["--typehints", "id=uint8,score=float", "--compression", "zstd",
           "--rowgroup-size", "40"]),
    ("a,b\nx,y\n", []),
    ("a;b\n1;2\n", ["--delimiter", ";", "--typehints", "a=int32,b=int32"]),
    ("a,b\n" + "".join(f"{i},{i * 7}\n" for i in range(500)),
     ["--typehints", "a=int16,b=uint64", "--rowgroup-size", "1000",
      "--created-by", "someone", "-v"]),
], ids=["hints", "zstd-small-groups", "strings", "delimiter", "sizes"])
def test_csv2parquet_files_as_reference(tmp_path, text, args):
    rc, _err, blob = c2p_both(tmp_path, text, *args)
    assert rc == 0 and blob is not None


def test_csv2parquet_records(tmp_path):
    from tpuparquet_torch.io.reader import FileReader

    _, _, blob = c2p_both(tmp_path, CSV, "--typehints",
                          "id=int64,score=double,flag=boolean,blob=json")
    rows = list(FileReader(blob).rows())
    assert rows[0] == {"id": 1, "name": b"alpha", "score": 1.5,
                       "flag": True, "blob": b'{"a": 1}'}
    assert rows[2] == {"id": 3, "score": 3.5, "flag": True}


@pytest.mark.parametrize("text,args", [
    ("c\n128\n", ["--typehints", "c=int8"]),
    ("c\n-1\n", ["--typehints", "c=uint8"]),
    ("c\n40000\n", ["--typehints", "c=int16"]),
    ("c\n-5\n", ["--typehints", "c=uint32"]),
    ("c\nmaybe\n", ["--typehints", "c=boolean"]),
    ("c\n{bad\n", ["--typehints", "c=json"]),
    ("a\n1\n", ["--typehints", "zz=int64"]),
    ("a\n1\n", ["--typehints", "a=decimal128"]),
    ("a,b\n1\n", []),
    ("a,a\n1,2\n", []),
    ("a b,c\n1,2\n", []),
    ("a\n1\n", ["--delimiter", "||"]),
    ("c\nnotanint\n", ["--typehints", "c=int64"]),
    ("", []),
], ids=["int8", "uint8", "int16", "uint32", "bool", "json", "hint-missing",
        "hint-unknown", "fields", "duplicate", "identifier", "delimiter",
        "notanint", "empty"])
def test_csv2parquet_rejects_as_reference(tmp_path, text, args):
    rc, err, blob = c2p_both(tmp_path, text, *args)
    assert rc == 1 and err.startswith("csv2parquet:") and blob is None


def test_parse_type_hints_as_reference():
    for s in ("a=int64, b=json,,", "a=string"):
        assert c2p.parse_type_hints(s) == jax_c2p.parse_type_hints(s)
    assert c2p.derive_schema(["a", "b"], {"b": "uint16"}) == \
        jax_c2p.derive_schema(["a", "b"], {"b": "uint16"})
    assert sorted(c2p.TYPES) == sorted(jax_c2p.TYPES)


# ----------------------------------------------------------------------
# verify and profile (the device paths on the CPU)
# ----------------------------------------------------------------------

_TIMES = re.compile(r"cpu [0-9.]+ms  device [0-9.]+ms")


def verify_both(path):
    theirs = run(jax_pt, "verify", path)
    ours = run(pt, "verify", "--device", "cpu", path)
    mask = [(r[0], _TIMES.sub("cpu -  device -", r[1]), r[2])
            for r in (theirs, ours)]
    assert mask[1] == mask[0]
    return ours


def test_verify_as_reference(sample_file):
    rc, out, _ = verify_both(sample_file)
    assert rc == 0 and "all row groups bit-exact" in out


@pytest.mark.parametrize("case", ["multi", "nan", "planes"])
def test_verify_files_as_reference(tmp_path, case):
    p = tmp_path / f"{case}.parquet"
    r = np.random.default_rng(5)
    with open(p, "wb") as f:
        if case == "multi":
            w = JaxFileWriter(f, "message m { required int64 a; "
                              "optional binary s (STRING); }",
                              codec=JaxCodec.SNAPPY)
            for _ in range(3):
                sm = r.random(300) >= 0.2
                w.write_columns(
                    {"a": r.integers(0, 10**9, size=300),
                     "s": [b"v%d" % i for i in range(int(sm.sum()))]},
                    masks={"s": sm})
        elif case == "nan":
            w = JaxFileWriter(f, "message m { required double x; }")
            w.write_columns({"x": np.array([1.0, np.nan, -np.inf, 3.5])})
        else:
            # PLAIN int64 large enough for the byte-plane transport
            w = JaxFileWriter(f, "message m { required int64 t; "
                              "optional int32 k; }", allow_dict=False)
            n = 40_000
            mask = r.random(n) >= 0.1
            w.write_columns({"t": 1_700_000_000_000 + np.arange(n) * 1000,
                             "k": r.integers(0, 5, int(mask.sum()))
                             .astype(np.int32)}, masks={"k": mask})
        w.close()
    rc, out, _ = verify_both(str(p))
    assert rc == 0, out


def test_verify_without_a_card_raises(sample_file, monkeypatch):
    """No fallback: the device path needs CUDA unless ``--device cpu``."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    rc, _out, _err = run(pt, "verify", sample_file)
    assert rc[0] == "RuntimeError" and "CUDA" in rc[1]
    rc, _out, _err = run(pt, "profile", sample_file)
    assert rc[0] == "RuntimeError"


def _untimed(obj, key=""):
    """A profile digest without its walls and timing histograms; the JAX
    side's ``native_fallbacks`` counter (the port has no native
    fallback) dropped."""
    if isinstance(obj, dict):
        return {k: _untimed(v, k) for k, v in obj.items()
                if not (k.endswith(("_s", "_us", "_ms"))
                        or k in ("values_per_sec", "native_fallbacks",
                                 "cpu_s"))}
    if isinstance(obj, list):
        return [_untimed(v) for v in obj]
    return obj


@pytest.mark.parametrize("device_path", [False, True],
                         ids=["cpu-oracle", "device-path"])
def test_profile_json_as_reference(sample_file, device_path):
    args = [] if device_path else ["--cpu"]
    theirs = run(jax_pt, "profile", "--json", *args, sample_file)
    ours = run(pt, "profile", "--json", *args, "--device", "cpu",
               sample_file)
    assert ours[0] == theirs[0] == 0
    a, b = json.loads(theirs[1]), json.loads(ours[1])
    assert _untimed(b) == _untimed(a)
    assert b["counters"]["row_groups"] == 1
    assert {r["column"]: r["values"] for r in b["columns"]}["id"] == 25


def test_profile_filter_table_as_reference(sample_file):
    """The human table with a pushed-down filter: the same rows and
    sections, the walls aside."""
    theirs = run(jax_pt, "profile", "--filter", "id > 20", sample_file)
    ours = run(pt, "profile", "--device", "cpu", "--filter", "id > 20",
               sample_file)
    num = re.compile(r"[0-9]+\.[0-9]+s|[0-9.]+ms|[0-9,]+ values/s|"
                     r"[0-9]+\.[0-9]+")
    assert ours[0] == theirs[0] == 0
    assert [num.sub("#", line) for line in ours[1].splitlines()] == \
        [num.sub("#", line) for line in theirs[1].splitlines()]
    assert "pruning:" in ours[1]


def test_profile_saved_events_as_reference(sample_file, tmp_path):
    """A saved event log replays to the same digest in both tools, and
    the port writes the log and the Perfetto trace the JAX tool
    writes."""
    ev = str(tmp_path / "pages.jsonl")
    trace = str(tmp_path / "p.json")
    rc, out, _ = run(pt, "profile", "--cpu", "--events", ev, "--perfetto",
                     trace, sample_file)
    assert rc == 0 and os.path.exists(ev) and os.path.exists(trace)
    assert "wrote page events" in out
    a = run(jax_pt, "profile", "--json", "--from-events", ev)
    b = run(pt, "profile", "--json", "--from-events", ev)
    assert b[0] == a[0] == 0
    assert _untimed(json.loads(b[1])) == _untimed(json.loads(a[1]))
    assert "counters" not in json.loads(b[1])
    rc, out, _ = both("profile", "--from-events", ev)
    assert rc == 0 and "id" in out
    # the replay takes no file; the profile needs one of the two
    assert both("profile", "--from-events", ev, sample_file)[0] == 1
    assert both("profile")[0] == 1


def test_profile_json_stdout_stays_json(sample_file, tmp_path):
    """``--json`` with ``--events`` in a process of its own: stdout is one
    JSON document, the status line goes to stderr."""
    ev = str(tmp_path / "pages.jsonl")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["PYTHONPATH"] = REPO
    res = subprocess.run(
        [sys.executable, "-m", "tpuparquet_torch.cli.parquet_tool",
         "profile", "--json", "--cpu", "--events", ev, sample_file],
        capture_output=True, text=True, timeout=300, cwd=REPO, env=env)
    assert res.returncode == 0, res.stderr[-500:]
    assert json.loads(res.stdout)["file"] == sample_file
    assert "wrote page events" in res.stderr


# ----------------------------------------------------------------------
# top, watch, slo
# ----------------------------------------------------------------------

def _progress_file(path, *, done=False):
    p = port_progress.ScanProgress(4, export=str(path),
                                   min_export_interval=0.0, label="lab")
    p.begin()
    for k in range(4 if done else 1):
        p.unit_started(k)
        p.unit_done(k, rows=10)
    if done:
        p.finish()
    return str(path)


def test_top_as_reference(tmp_path):
    running = _progress_file(tmp_path / "r.json")
    done = _progress_file(tmp_path / "d.json", done=True)
    for argv in (["top", "--once", running], ["top", "--once", done],
                 ["top", "--once", running, done],
                 ["top", "--once", str(tmp_path / "nope.json")],
                 ["top", done]):
        rc, out, _ = both(*argv)
        assert rc == (1 if "nope" in argv[-1] else 0)
    assert "state=done" in both("top", "--once", done)[1]


def test_top_flags_stale_and_dead_writers_as_reference(tmp_path):
    """A backdated frame is STALE (rc 0); a file whose mtime is old means
    a dead writer (rc 1, the words on stderr)."""
    path = _progress_file(tmp_path / "s.json")
    doc = jax_progress.read_progress_file(path)
    doc["ts"] -= 3600
    (tmp_path / "s.json").write_text(json.dumps(doc))
    rc, out, _ = both("top", "--once", path)
    assert rc == 0 and "STALE" in out
    old = time.time() - 3600
    os.utime(path, (old, old))
    rc, _out, err = both("top", "--once", path)
    assert rc == 1 and "dead" in err


@pytest.fixture()
def ring(tmp_path):
    """A time-series ring recorded by a port scan labelled ``lab``, with
    the latency digests on."""
    from tpuparquet_torch.obs import digest as port_digest
    from tpuparquet_torch.obs import timeseries as port_ts
    from tpuparquet_torch.shard import ShardedScan, make_mesh

    p = str(tmp_path / "w.parquet")
    with open(p, "wb") as f:
        w = JaxFileWriter(f, "message m { required int64 a; }")
        for g in range(3):
            w.write_columns({"a": np.arange(g * 50, g * 50 + 50)})
        w.close()
    saved = port_digest.digests()
    ring_dir = str(tmp_path / "ring")
    try:
        port_digest.set_digests(True)
        port_ts.set_ring_dir(ring_dir)
        ShardedScan([p], mesh=make_mesh(1, devices=["cpu"]),
                    progress_label="lab").run()
        port_ts.tick("test")
    finally:
        port_ts.set_ring_dir(None)
        port_digest._active = saved
    return ring_dir


def test_watch_and_slo_as_reference(ring, tmp_path, monkeypatch):
    monkeypatch.delenv("TPQ_SLO_FILE", raising=False)
    rc, out, _ = both("watch", "--once", ring)
    assert rc == 0 and "lab" in out
    assert both("watch", "--once", str(tmp_path / "nothing"))[0] == 1
    ok = tmp_path / "ok.json"
    ok.write_text(json.dumps([{"label": "lab",
                               "latency_target_ms": 10 ** 6,
                               "error_rate_target": 1.0}]))
    rc, out, _ = both("slo", "report", "--slo", str(ok), ring)
    assert rc == 0 and "OK" in out
    got = [run(mod, "slo", "report", "--json", "--slo", str(ok), ring)
           for mod in (jax_pt, pt)]
    docs = [json.loads(out) for _rc, out, _err in got]
    for d in docs:
        d.pop("ts")  # the evaluation's clock
    assert got[1][0] == got[0][0] == 0 and docs[1] == docs[0]
    bad = tmp_path / "bad.json"
    bad.write_text(json.dumps([{"label": "lab",
                                "latency_target_ms": 0.000001}]))
    rc, out, _ = both("slo", "report", "--slo", str(bad), ring)
    assert rc == 2 and "VIOLATED" in out
    rc, out, _ = both("watch", "--once", "--slo", str(ok), ring)
    assert rc == 0 and "budget lab" in out
    assert both("slo", "report", ring)[0] == 1  # no objectives


# ----------------------------------------------------------------------
# flame and doctor
# ----------------------------------------------------------------------

def _profile(tmp_path, name, samples, offcpu, drops, stacks, **kw):
    from tpuparquet_torch.obs.profiler import write_profile_file

    from test_profiler import _host_state  # noqa: E402

    path = str(tmp_path / name)
    assert write_profile_file(_host_state(samples, offcpu, drops, stacks,
                                          **kw), path)
    return path


def test_flame_as_reference(tmp_path):
    p = _profile(tmp_path, "p.prof", 6, 2, 1, {"f;g": 4, "f;h": 2})
    a = _profile(tmp_path, "a.prof", 10, 0, 0, {"f;g": 5, "f;h": 5})
    b = _profile(tmp_path, "b.prof", 10, 0, 0, {"f;g": 9, "f;h": 1})
    for argv, rc in ((["flame", p], 0), (["flame", "--json", p], 0),
                     (["flame", "--collapsed", p], 0),
                     (["flame", "--stage", "read", p], 0),
                     (["flame", "--stage", "nope", p], 1),
                     (["flame", "--label", "scan", "-n", "1", p], 0),
                     (["flame", "--diff", a, b], 0),
                     (["flame", "--diff", a, b, "--json"], 0),
                     (["flame"], 1)):
        assert both(*argv)[0] == rc, argv
    assert "+40.00%" in both("flame", "--diff", a, b)[1]


def test_doctor_as_reference(tmp_path):
    from tpuparquet_torch.obs.export import write_trace_file

    from test_trace import ORIGIN_HEAVY, synthetic_trace  # noqa: E402

    plain = str(tmp_path / "t.json")
    write_trace_file(synthetic_trace(), plain,
                     ledgers={"golden": {"cpu_s": {}}})
    remote = str(tmp_path / "r.json")
    write_trace_file(synthetic_trace(), remote, ledgers={
        "golden": {"cpu_s": {}, "counters": ORIGIN_HEAVY}})
    empty = str(tmp_path / "e.json")
    write_trace_file([], empty)
    prof = _profile(tmp_path, "p.prof", 6, 2, 1, {"f;g": 4, "f;h": 2})
    for argv, rc in ((["doctor", plain], 0), (["doctor", "--json", plain], 0),
                     (["doctor", remote], 0),
                     (["doctor", "--json", remote], 0),
                     (["doctor", "--trace-id", "t-1", plain], 0),
                     (["doctor", "--trace-id", "nope", plain], 1),
                     (["doctor", "--profile", prof, plain], 0),
                     (["doctor", "--json", "--profile", prof, plain], 0),
                     (["doctor", empty], 1)):
        assert both(*argv)[0] == rc, argv
    out = both("doctor", remote)[1]
    assert "STRAGGLER unit 4" in out and "ORIGIN-BOUND" in out


def test_doctor_on_a_port_scan_export(tmp_path, monkeypatch):
    """A trace a port scan exported (``TPQ_TRACE_EXPORT``) reads the same
    in both doctors."""
    from tpuparquet_torch.obs import trace as port_trace
    from tpuparquet_torch.shard import ShardedScan, make_mesh

    p = str(tmp_path / "f.parquet")
    with open(p, "wb") as f:
        w = JaxFileWriter(f, "message m { required int64 a; }")
        for g in range(4):
            w.write_columns({"a": np.arange(g * 40, g * 40 + 40)})
        w.close()
    path = tmp_path / "scan.trace.json"
    monkeypatch.setenv("TPQ_TRACE_EXPORT", str(path))
    saved = port_trace._active
    try:
        port_trace.set_tracing(True)
        ShardedScan([p], mesh=make_mesh(1, devices=["cpu"])).run()
    finally:
        port_trace._active = saved
    assert path.exists()
    rc, out, _ = both("doctor", str(path))
    assert rc == 0 and "verdict:" in out and "ledger[scan]" in out
    assert both("doctor", "--json", str(path))[0] == 0


# ----------------------------------------------------------------------
# rescue
# ----------------------------------------------------------------------

def test_rescue_as_reference(tmp_path):
    """A torn file's recoverable row groups, rescued by both tools into
    equal files with equal words; a clean file copied; the input kept
    safe."""
    from test_torch_salvage import make_file, rg_end_offsets  # noqa: E402

    data = make_file("jax")
    ends = rg_end_offsets(data)
    torn = tmp_path / "torn.parquet"
    torn.write_bytes(data[: ends[1] + 3])
    clean = tmp_path / "clean.parquet"
    clean.write_bytes(data)
    for src in (torn, clean):
        got = []
        for name, mod in (("jax", jax_pt), ("port", pt)):
            out = tmp_path / f"{src.stem}-{name}.parquet"
            rc, text, _ = run(mod, "rescue", str(src), str(out))
            got.append((rc, text.replace(str(out), "<out>"),
                        out.read_bytes()))
        assert got[1] == got[0]
        assert got[1][0] == 0
    assert both("rescue", str(torn), str(torn))[0] == 1
    assert torn.read_bytes() == data[: ends[1] + 3]


# ----------------------------------------------------------------------
# serve and tenants
# ----------------------------------------------------------------------

def _serve_files(tmp_path):
    paths = []
    for i in range(2):
        p = str(tmp_path / f"s{i}.parquet")
        with open(p, "wb") as f:
            w = JaxFileWriter(f, "message m { required int64 a; "
                              "optional int32 b; }")
            for g in range(3):
                mask = np.arange(60) % 4 != 0
                w.write_columns(
                    {"a": np.arange(60) + 1000 * (g + 10 * i),
                     "b": np.arange(int(mask.sum()), dtype=np.int32)},
                    masks={"b": mask})
            w.close()
        paths.append(p)
    return paths


def test_serve_and_tenants_as_reference(tmp_path):
    """A two-tenant spec with sink directories and a status export: exit
    0, the same words, unit files with the same arrays, and the
    ``tenants`` table of the export."""
    import signal

    paths = _serve_files(tmp_path)
    outs = []
    old = signal.getsignal(signal.SIGTERM)
    try:
        for name, mod in (("jax", jax_pt), ("port", pt)):
            spec = {
                "workers": 2,
                "state_dir": str(tmp_path / name / "state"),
                "status_export": str(tmp_path / name / "status.json"),
                "tenants": [{"label": "light", "weight": 1.0},
                            {"label": "heavy", "weight": 3.0}],
                "jobs": [{"tenant": t, "job_id": f"j{i}", "sources": [p],
                          "columns": ["a", "b"], "checkpoint_every": 1,
                          "sink_dir": str(tmp_path / name / t / f"j{i}")}
                         for i, p in enumerate(paths)
                         for t in ("light", "heavy")],
            }
            sp = tmp_path / f"{name}.json"
            sp.write_text(json.dumps(spec))
            extra = [] if mod is jax_pt else ["--device", "cpu"]
            rc, out, _ = run(mod, "serve", *extra, str(sp))
            units = {}
            for root, _dirs, files in os.walk(tmp_path / name):
                for fn in files:
                    if fn.startswith("unit") and fn.endswith(".npz"):
                        rel = os.path.relpath(os.path.join(root, fn),
                                              tmp_path / name)
                        with np.load(os.path.join(root, fn)) as z:
                            units[rel] = {k: z[k] for k in z.files}
            status = str(tmp_path / name / "status.json")
            outs.append((rc, sorted(out.splitlines()), units, status))
    finally:
        signal.signal(signal.SIGTERM, old)
    (rc0, lines0, units0, st0), (rc1, lines1, units1, st1) = outs
    assert rc1 == rc0 == 0
    assert lines1 == lines0
    assert sorted(units1) == sorted(units0) and len(units1) == 12
    for rel in units0:
        assert units1[rel].keys() == units0[rel].keys(), rel
        for k in units0[rel]:
            np.testing.assert_array_equal(units1[rel][k], units0[rel][k])
    tables = []
    for st in (st0, st1):
        doc = json.load(open(st))
        doc["state_dir"] = "<state>"
        for row in doc["tenants"].values():
            # the job walls and the stage verdict the rebalance read
            # from them
            row["est_job_s"] = row["bound"] = None
        doc["finished"].sort(key=lambda j: (j["tenant"], j["job_id"]))
        path = str(tmp_path / f"norm-{len(tables)}.json")
        with open(path, "w") as f:
            json.dump(doc, f)
        tables.append(path)
    assert json.load(open(tables[1])) == json.load(open(tables[0]))
    for argv in (["tenants", tables[1]], ["tenants", "--json", tables[1]]):
        rc, out, _ = both(*argv)
        assert rc == 0 and "heavy" in out
