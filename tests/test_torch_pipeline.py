"""The port's pipelined read against the JAX package's, on the CPU.

``read_row_groups_device`` plans each column on a pool of
``TPQ_PLAN_THREADS`` workers while the calling thread stages and
launches the row group before (``pipelined_reads``).  At 1, 2 and 4
workers, three files read by both packages (the port with
``device="cpu"``) must agree buffer for buffer (tolerance 0), and so must
``bytes_staged``, the routing counters, ``pages_crc_verified`` and
``bytes_read``: a config-2-shaped SNAPPY file of three row groups
(dictionary int32 columns, PLAIN int64 timestamps), the transport mix
(every wire transport engages) and the string mix in two row groups.
Then: an early-closed read joins its pool, an error in the second row
group comes after the first is yielded, the worker count parses as the
reference's, the plan cache (``TPQ_PLAN_CACHE_MB``) hits and misses as
the reference's and drops a corrupt file's entries, and ``FileReader``
over a path reads each chunk's range with the reference's
``bytes_read`` and ``plan_fingerprint``.
"""

import io
import sys
import threading
from pathlib import Path

import numpy as np
import pytest
import torch

from tpuparquet import CompressionCodec as JaxCodec
from tpuparquet import FileWriter as JaxFileWriter
from tpuparquet.io.reader import FileReader as JaxFileReader
from tpuparquet.kernels import device as jax_device
from tpuparquet.kernels import plancache as jax_plancache
from tpuparquet.native import pack_native as jax_pack_native
from tpuparquet.native import snappy_native as jax_snappy_native
from tpuparquet.stats import collect_stats as jax_collect_stats
from tpuparquet_torch.errors import CorruptPageError
from tpuparquet_torch.io.reader import FileReader
from tpuparquet_torch.kernels import device as port_device
from tpuparquet_torch.kernels import plancache as port_plancache
from tpuparquet_torch.kernels.device import device_column_from_jax_numpy, \
    read_row_group_device, read_row_groups_device
from tpuparquet_torch.shard import ShardedScan, make_mesh
from tpuparquet_torch.stats import collect_stats

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
import chip_smoke  # noqa: E402
from test_torch_read import _jax_buffers, _taxi_groups, _write, \
    _write_groups  # noqa: E402

ROUTING = ("pages_device_snappy", "pages_device_delta_lanes",
           "pages_device_planes")
COUNTERS = ("bytes_staged", "pages_crc_verified", "bytes_read") + ROUTING
CACHE = ("plan_cache_hits", "plan_cache_misses")
THREADS = (1, 2, 4)


@pytest.fixture(autouse=True)
def _defaults(monkeypatch):
    """The JAX package's defaults: every transport on, no plan cache."""
    for k in chip_smoke.TRANSPORT_ENV + ("TPQ_PLAN_CACHE_MB",
                                         "TPQ_PLAN_THREADS"):
        monkeypatch.delenv(k, raising=False)


def _natives_present() -> bool:
    return jax_pack_native() is not None and jax_snappy_native() is not None


def _config2() -> bytes:
    return _write(JaxFileWriter, JaxCodec.SNAPPY, _taxi_groups(n_groups=3))


def _strings() -> bytes:
    return _write_groups("jax", chip_smoke.STRINGS_SCHEMA,
                         chip_smoke.strings_groups(40_000, 2))


def _jax_read(blob, counters=COUNTERS):
    """The JAX package's read of ``blob``: ``({rg: {path: numpy
    buffers}}, {counter: value})``."""
    with jax_collect_stats() as jst:
        out = {rg: {p: _jax_buffers(c) for p, c in cols.items()}
               for rg, cols in jax_device.read_row_groups_device(
                   JaxFileReader(io.BytesIO(blob)))}
    return out, {k: getattr(jst, k) for k in counters}


def _port_read(reader, counters=COUNTERS):
    with collect_stats() as st:
        out = dict(read_row_groups_device(reader, device="cpu"))
    return out, {k: getattr(st, k) for k in counters}


def _assert_same(ours: dict, theirs: dict) -> None:
    assert ours.keys() == theirs.keys()
    for rg, cols in ours.items():
        assert cols.keys() == theirs[rg].keys()
        for name, col in cols.items():
            want = device_column_from_jax_numpy(theirs[rg][name])
            where = f"rg {rg} {name}"
            assert (col.ptype, col.num_values, col.n_packed, col.n_bytes) \
                == (want.ptype, want.num_values, want.n_packed,
                    want.n_bytes), where
            a, b = col.padded_buffers(), want.padded_buffers()
            assert a.keys() == b.keys(), where
            for k in a:
                assert a[k].dtype == b[k].dtype, (where, k)
                np.testing.assert_array_equal(a[k], b[k],
                                              err_msg=f"{where} {k}")


def _assert_same_counters(got: dict, want: dict) -> None:
    if not _natives_present():  # the JAX package routes otherwise
        got = {k: v for k, v in got.items() if k not in ROUTING
               and k != "bytes_staged"}
        want = {k: want[k] for k in got}
    assert got == want


@pytest.fixture(scope="module")
def files():
    """name -> (blob, the JAX package's read)."""
    blobs = {"config 2": _config2(),
             "transport mix": chip_smoke.build_mix(1_000_000, 1)[0],
             "string mix": _strings()}
    return {name: (blob, _jax_read(blob)) for name, blob in blobs.items()}


# ----------------------------------------------------------------------
# the pipeline at every thread count
# ----------------------------------------------------------------------

@pytest.mark.parametrize("threads", THREADS)
@pytest.mark.parametrize("name", ["config 2", "transport mix", "string mix"])
def test_read_matches_jax_at_thread_count(files, name, threads,
                                          monkeypatch):
    monkeypatch.setenv("TPQ_PLAN_THREADS", str(threads))
    blob, (theirs, want) = files[name]
    ours, got = _port_read(FileReader(blob))
    _assert_same(ours, theirs)
    _assert_same_counters(got, want)
    assert got["pages_crc_verified"] > 0
    assert got["bytes_read"] == sum(
        cc.meta_data.total_compressed_size
        for rg in FileReader(blob).meta.row_groups for cc in rg.columns)


def test_routing_engages(files):
    """The files exercise what they are for: every transport on the mix,
    the planes on config 2's timestamps, the tokens on the string mix."""
    assert files["transport mix"][1][1]["pages_device_planes"] >= 1
    _, got = _port_read(FileReader(files["transport mix"][0]))
    assert {k: got[k] for k in ROUTING} == {
        "pages_device_snappy": 2, "pages_device_delta_lanes": 2,
        "pages_device_planes": 1}
    _, got = _port_read(FileReader(files["config 2"][0]))
    assert got["pages_device_planes"] == 3
    _, got = _port_read(FileReader(files["string mix"][0]))
    assert got["pages_device_snappy"] == 4


def test_serial_row_group_equals_pipeline(files, monkeypatch):
    """``read_row_group_device`` (planned on the calling thread) gives
    the pipeline's buffers and counters."""
    monkeypatch.setenv("TPQ_PLAN_THREADS", "4")
    blob, _ = files["config 2"]
    reader = FileReader(blob)
    piped, want = _port_read(reader)
    with collect_stats() as st:
        serial = {rg: read_row_group_device(reader, rg, device="cpu")
                  for rg in range(reader.row_group_count())}
    assert {k: getattr(st, k) for k in COUNTERS} == want
    for rg, cols in serial.items():
        for name, col in cols.items():
            a, b = col.padded_buffers(), piped[rg][name].padded_buffers()
            assert a.keys() == b.keys()
            for k in a:
                np.testing.assert_array_equal(a[k], b[k])


def _pool_threads() -> list:
    return [t for t in threading.enumerate()
            if t.name.startswith("ThreadPoolExecutor")]


def test_early_close_joins_the_pool(files, monkeypatch):
    monkeypatch.setenv("TPQ_PLAN_THREADS", "4")
    before = _pool_threads()
    reads = read_row_groups_device(FileReader(files["config 2"][0]),
                                   device="cpu")
    rg, cols = next(reads)
    assert rg == 0 and cols
    assert len(_pool_threads()) > len(before)
    reads.close()
    assert _pool_threads() == before


def _flip_in_rg(blob: bytes, rg: int) -> bytes:
    """``blob`` with one byte of row group ``rg``'s first column's last
    page flipped (its CRC then fails)."""
    out = bytearray(blob)
    cm = FileReader(blob).meta.row_groups[rg].columns[0].meta_data
    out[cm.data_page_offset + cm.total_compressed_size - 1] ^= 0x40
    return bytes(out)


@pytest.mark.parametrize("threads", THREADS)
def test_error_in_second_row_group(files, threads, monkeypatch):
    """Row group 0 is yielded; then row group 1's CRC error is raised
    with its coordinates, as the reference raises it."""
    monkeypatch.setenv("TPQ_PLAN_THREADS", str(threads))
    before = _pool_threads()
    blob = _flip_in_rg(files["config 2"][0], 1)
    reads = read_row_groups_device(FileReader(blob), device="cpu")
    rg, _ = next(reads)
    assert rg == 0
    with pytest.raises(CorruptPageError, match="CRC") as e:
        next(reads)
    assert (e.value.row_group, e.value.column) == (1, "pickup_ts")
    theirs = jax_device.read_row_groups_device(
        JaxFileReader(io.BytesIO(blob)))
    assert next(theirs)[0] == 0
    with pytest.raises(ValueError, match="CRC") as je:
        next(theirs)
    assert je.value.column == "pickup_ts"
    assert _pool_threads() == before


@pytest.mark.parametrize("value", [None, "1", "3", "0", "-2", "abc", "64"])
def test_plan_threads_as_reference(value, monkeypatch):
    if value is not None:
        monkeypatch.setenv("TPQ_PLAN_THREADS", value)
    assert port_device._usable_cpus() == jax_device._usable_cpus()
    assert port_device._plan_threads() == jax_device._plan_threads()


def test_usable_cpus_follow_affinity(monkeypatch):
    import os

    monkeypatch.setattr(os, "sched_getaffinity", lambda pid: {0, 3, 5})
    assert port_device._usable_cpus() == jax_device._usable_cpus() == 3
    assert port_device._plan_threads() == 3


def test_scan_runs_through_the_pipeline(files, monkeypatch):
    """``ShardedScan.run()`` at 1 and 4 workers gives the same units as
    serial reads; ``run_iter`` advances the cursor as it yields."""
    blobs = [files["config 2"][0], files["string mix"][0]]
    mesh = make_mesh(2, devices=["cpu"] * 2)
    runs = []
    for threads in (1, 4):
        monkeypatch.setenv("TPQ_PLAN_THREADS", str(threads))
        with ShardedScan(blobs, mesh=mesh) as scan:
            runs.append(scan.run())
    readers = [FileReader(b) for b in blobs]
    serial = [read_row_group_device(readers[f], rg, device="cpu")
              for f, r in enumerate(readers)
              for rg in range(r.row_group_count())]
    for run in runs:
        assert len(run) == len(serial) == 5
        for got, want in zip(run, serial):
            assert got.keys() == want.keys()
            for name in got:
                a = got[name].padded_buffers()
                b = want[name].padded_buffers()
                for k in a:
                    np.testing.assert_array_equal(a[k], b[k])
    with ShardedScan(blobs, mesh=mesh) as scan:
        it = scan.run_iter()
        k, _ = next(it)
        assert k == 0 and scan.state()["next_unit"] == 1
        it.close()


# ----------------------------------------------------------------------
# the plan cache
# ----------------------------------------------------------------------

@pytest.fixture
def plan_cache_on(monkeypatch):
    monkeypatch.setenv("TPQ_PLAN_CACHE_MB", "64")
    port_plancache.clear_plan_cache()
    jax_plancache.clear_plan_cache()
    yield
    port_plancache.clear_plan_cache()
    jax_plancache.clear_plan_cache()


@pytest.mark.parametrize("name", ["config 2", "transport mix", "string mix"])
def test_plan_cache_as_reference(files, name, plan_cache_on, monkeypatch):
    """Cold, then warm: the same hits and misses as the reference's, the
    warm pass every chunk a hit, the routing and the buffers of the cold
    pass (and of a read without the cache)."""
    monkeypatch.setenv("TPQ_PLAN_THREADS", "2")
    blob, (theirs, want) = files[name]
    n_chunks = sum(len(rg.columns) for rg in FileReader(blob).meta.row_groups)
    for warm in (False, True):
        jout, jgot = _jax_read(blob, COUNTERS + CACHE)
        ours, got = _port_read(FileReader(blob), COUNTERS + CACHE)
        _assert_same(ours, theirs)
        _assert_same(ours, jout)
        assert {k: got[k] for k in CACHE} == {k: jgot[k] for k in CACHE}
        assert {k: got[k] for k in CACHE} == (
            {"plan_cache_hits": n_chunks, "plan_cache_misses": 0} if warm
            else {"plan_cache_hits": 0, "plan_cache_misses": n_chunks})
        _assert_same_counters({k: got[k] for k in COUNTERS}, want)


def _one_column_file() -> bytes:
    """One row group of one PLAIN int64 column with page CRCs."""
    rng = np.random.default_rng(8)
    buf = io.BytesIO()
    w = JaxFileWriter(buf, "message m { required int64 a; }",
                      codec=JaxCodec.SNAPPY)
    w.write_columns({"a": rng.integers(-2**40, 2**40, 5000)})
    w.close()
    return buf.getvalue()


def _entries(cache, fingerprint) -> int:
    return sum(1 for k in cache._entries if k[0] == fingerprint)


def test_corrupt_page_drops_fingerprint_entries(plan_cache_on):
    blob = _one_column_file()
    bad = _flip_in_rg(blob, 0)
    fp = FileReader(blob).plan_fingerprint
    assert fp is not None and FileReader(bad).plan_fingerprint == fp
    assert JaxFileReader(io.BytesIO(blob)).plan_fingerprint == fp
    _port_read(FileReader(blob))
    _jax_read(blob)
    assert _entries(port_plancache._CACHE, fp) == 1
    assert _entries(jax_plancache._CACHE, fp) == 1
    with pytest.raises(CorruptPageError):
        _port_read(FileReader(bad))
    with pytest.raises(ValueError):
        _jax_read(bad)
    assert _entries(port_plancache._CACHE, fp) == 0
    assert _entries(jax_plancache._CACHE, fp) == 0


def test_plan_cache_off_by_default(files):
    port_plancache.clear_plan_cache()
    _, got = _port_read(FileReader(files["config 2"][0]), CACHE)
    assert got == {"plan_cache_hits": 0, "plan_cache_misses": 0}
    assert len(port_plancache._CACHE) == 0


def test_plan_cache_evicts_past_budget(files, monkeypatch):
    """A budget below one chunk's hints stores nothing; one that holds a
    few chunks evicts as the reference's does."""
    blob = files["config 2"][0]
    for mb in ("0.0001", "0.002"):
        monkeypatch.setenv("TPQ_PLAN_CACHE_MB", mb)
        port_plancache.clear_plan_cache()
        jax_plancache.clear_plan_cache()
        keys = ("plan_cache_misses", "plan_cache_evictions")
        _, got = _port_read(FileReader(blob), keys)
        _, jgot = _jax_read(blob, keys)
        assert got == jgot
        assert len(port_plancache._CACHE) == len(jax_plancache._CACHE)
    port_plancache.clear_plan_cache()
    jax_plancache.clear_plan_cache()


# ----------------------------------------------------------------------
# range reads
# ----------------------------------------------------------------------

@pytest.mark.parametrize("name", ["config 2", "string mix"])
def test_path_reader_reads_ranges(files, name, tmp_path):
    blob, (theirs, want) = files[name]
    path = tmp_path / "f.parquet"
    path.write_bytes(blob)
    reader = FileReader(str(path))
    assert reader._buf is None  # the file stays on disk
    ours, got = _port_read(reader)
    _assert_same(ours, theirs)
    _assert_same_counters(got, want)
    with jax_collect_stats() as jst:
        list(jax_device.read_row_groups_device(JaxFileReader(str(path))))
    assert got["bytes_read"] == jst.bytes_read
    mem, mgot = _port_read(FileReader(blob))
    assert mgot == got
    for rg, cols in ours.items():
        for col_name, col in cols.items():
            a = col.padded_buffers()
            b = mem[rg][col_name].padded_buffers()
            for k in a:
                np.testing.assert_array_equal(a[k], b[k])
    reader.close()
    assert reader._io.f.closed


@pytest.mark.parametrize("source", ["path", "bytes"])
def test_plan_fingerprint_as_reference(files, source, tmp_path):
    blob = files["string mix"][0]
    path = tmp_path / "f.parquet"
    path.write_bytes(blob)
    ours = FileReader(str(path) if source == "path" else blob)
    theirs = JaxFileReader(str(path) if source == "path"
                           else io.BytesIO(blob))
    assert ours.cached_plan_fingerprint() is None
    assert ours.plan_fingerprint == theirs.plan_fingerprint is not None
    assert ours.cached_plan_fingerprint() == ours.plan_fingerprint


def test_range_reads_from_threads_agree(files, tmp_path):
    """More threads than cores, switching every microsecond, read the
    chunks of one path reader at once and get the bytes of the file
    (each seek and read under the handle's lock)."""
    import os

    blob = files["config 2"][0]
    path = tmp_path / "f.parquet"
    path.write_bytes(blob)
    reader = FileReader(str(path))
    n = 2 * (os.cpu_count() or 1) + 1
    chunks = [(p, cm) for rg in reader.meta.row_groups
              for p, _, cm in reader.selected_chunks(rg)] * 4
    got = [None] * len(chunks)

    def work(i0):
        for i in range(i0, len(chunks), n):
            p, cm = chunks[i]
            b, start = reader.chunk_blob(cm, p)
            got[i] = (bytes(b), start)

    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        ts = [threading.Thread(target=work, args=(i,)) for i in range(n)]
        for t in ts:
            t.start()
        for t in ts:
            t.join(timeout=120)
    finally:
        sys.setswitchinterval(interval)
    assert not any(t.is_alive() for t in ts)
    for (p, cm), (b, start) in zip(chunks, got):
        assert b == blob[start : start + cm.total_compressed_size]
    reader.close()


def test_device_for_places_each_unit(files):
    """``pipelined_reads`` stages unit k on ``device_for(k)``."""
    reader = FileReader(files["config 2"][0])
    seen = []

    def device_for(k):
        seen.append(k)
        return torch.device("cpu")

    out = list(port_device.pipelined_reads(
        [reader], [(0, 2), (0, 0), (0, 1)], device_for, start=1))
    assert [k for k, _ in out] == [1, 2] and seen == [1, 2]
