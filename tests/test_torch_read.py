"""The slice as a whole: tpuparquet_torch's device read path against the
JAX package's, buffer for buffer.

A config-2-shaped file (bench.py's NYC-Taxi generator at 2 x 34,000 rows,
so ``pickup_ts`` holds more than MAX_DICT_ENTRIES distinct values and is
written PLAIN, while the small-range columns are dictionary-encoded and
``payment_type`` is optional) is read by ``read_row_groups_device`` of
both packages, in the JAX package's no-wire-transport configuration
(``TPQ_DEVICE_SNAPPY/PLANES/DELTA=0``) and in its default one, where
PLAIN pages take the byte-plane, delta-lane and snappy-token transports.
With the transports on, the routing counters and the staged bytes must
match too.  The transport mix (``chip_smoke.build_mix``, 200,000 rows in
one row group) is a file on which every route engages.  A config-4-shaped
file (bench.py's generator at 2 x 40,000 rows: dictionary strings beside
PLAIN doubles, data page v2) and the string mix (40,000 rows of distinct
URLs, which ship snappy tokens for K8 then K10, and random hex tokens,
which ship raw; V1 and V2) hold the BYTE_ARRAY and V2 paths to the same
standard.
"""

import io
import sys
from pathlib import Path

import numpy as np
import pytest

from tpuparquet import CompressionCodec as JaxCodec
from tpuparquet import Encoding as JaxEncoding
from tpuparquet import FileWriter as JaxFileWriter
from tpuparquet.cpu.plain import ByteArrayColumn as JaxByteArrayColumn
from tpuparquet.io.reader import FileReader as JaxFileReader
from tpuparquet.kernels.device import read_row_groups_device as \
    jax_read_row_groups_device
from tpuparquet.native import pack_native as jax_pack_native
from tpuparquet.native import snappy_native as jax_snappy_native
from tpuparquet.stats import collect_stats as jax_collect_stats
from tpuparquet_torch.cpu.hybrid import encode_hybrid
from tpuparquet_torch.errors import CorruptChunkError, CorruptPageError
from tpuparquet_torch.format.compact import CompactReader
from tpuparquet_torch.format.metadata import CompressionCodec, Encoding, \
    PageHeader, decode_struct
from tpuparquet_torch.io.chunk import MAX_DICT_ENTRIES
from tpuparquet_torch.io.reader import FileReader
from tpuparquet_torch.io.writer import FileWriter
from tpuparquet_torch.kernels.device import device_column_from_jax_numpy, \
    read_row_group_device, read_row_groups_device
from tpuparquet_torch.stats import collect_stats

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
import chip_smoke  # noqa: E402

TRANSPORT_ENV = chip_smoke.TRANSPORT_ENV
COUNTERS = ("pages_device_snappy", "pages_device_delta_lanes",
            "pages_device_planes")

TAXI = """message taxi {
    required int64 pickup_ts;
    required int32 passenger_count;
    required int32 rate_code;
    required int64 trip_distance_mm;
    optional int32 payment_type;
}"""
ROWS = 34_000


def _taxi_groups(rows=ROWS, n_groups=2, seed=42):
    """bench.py build_config2's generator."""
    rng = np.random.default_rng(seed)
    groups = []
    for _ in range(n_groups):
        pay_mask = rng.random(rows) >= 0.05
        groups.append(({
            "pickup_ts": 1_700_000_000_000
            + rng.integers(0, 3_600_000, size=rows).cumsum(),
            "passenger_count": rng.integers(1, 7, size=rows, dtype=np.int32),
            "rate_code": rng.integers(1, 6, size=rows, dtype=np.int32),
            "trip_distance_mm": rng.integers(100, 50_000, size=rows),
            "payment_type": rng.integers(0, 5, size=int(pay_mask.sum()),
                                         dtype=np.int32),
        }, {"payment_type": pay_mask}))
    return groups


def _write(writer_cls, codec, groups, schema=TAXI, **kw):
    buf = io.BytesIO()
    w = writer_cls(buf, schema, codec=codec, **kw)
    for cols, masks in groups:
        w.write_columns(cols, masks=masks)
    w.close()
    return buf.getvalue()


@pytest.fixture(scope="module")
def taxi():
    groups = _taxi_groups()
    return groups, {
        "jax": _write(JaxFileWriter, JaxCodec.SNAPPY, groups),
        "port": _write(FileWriter, CompressionCodec.SNAPPY, groups),
    }


@pytest.fixture
def no_transports(monkeypatch):
    for k in TRANSPORT_ENV:
        monkeypatch.setenv(k, "0")


@pytest.fixture
def transports(monkeypatch):
    """The JAX package's defaults: every transport on."""
    for k in TRANSPORT_ENV:
        monkeypatch.delenv(k, raising=False)


def _jax_buffers(col) -> dict:
    out = {"ptype": col.ptype, "num_values": col.num_values,
           "n_packed": col.n_packed,
           "data": np.asarray(col._data_p),
           "mask": None if col._mask_p is None else np.asarray(col._mask_p),
           "positions": (None if col._pos_p is None
                         else np.asarray(col._pos_p)),
           "rep_levels": (None if col._rep_p is None
                          else np.asarray(col._rep_p)),
           "def_levels": (None if col._def_p is None
                          else np.asarray(col._def_p))}
    if col.offsets is not None:
        out["offsets"] = np.asarray(col.offsets)
        out["n_bytes"] = col.n_bytes
    return out


def _assert_same_column(ours, theirs, where):
    assert (ours.ptype, ours.num_values, ours.n_packed, ours.n_bytes) == \
        (theirs.ptype, theirs.num_values, theirs.n_packed,
         theirs.n_bytes), where
    a, b = ours.padded_buffers(), theirs.padded_buffers()
    assert a.keys() == b.keys(), where
    for k in a:
        assert a[k].dtype == b[k].dtype, (where, k)
        np.testing.assert_array_equal(a[k], b[k], err_msg=f"{where} {k}")


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_buffers_match_jax_device_read(taxi, no_transports, writer):
    groups, files = taxi
    blob = files[writer]
    theirs = dict(jax_read_row_groups_device(JaxFileReader(io.BytesIO(blob))))
    ours = dict(read_row_groups_device(FileReader(blob), device="cpu"))
    assert ours.keys() == theirs.keys() == {0, 1}
    for rg in ours:
        assert ours[rg].keys() == theirs[rg].keys()
        for name, col in ours[rg].items():
            _assert_same_column(
                col, device_column_from_jax_numpy(
                    _jax_buffers(theirs[rg][name])), f"rg {rg} {name}")


def _read_both(blob):
    """Both packages' device reads of ``blob`` (the port's on the CPU),
    each under a stats collector."""
    with jax_collect_stats() as jst:
        theirs = dict(jax_read_row_groups_device(
            JaxFileReader(io.BytesIO(blob))))
    with collect_stats() as st:
        ours = dict(read_row_groups_device(FileReader(blob), device="cpu"))
    assert ours.keys() == theirs.keys()
    for rg in ours:
        assert ours[rg].keys() == theirs[rg].keys()
        for name, col in ours[rg].items():
            _assert_same_column(
                col, device_column_from_jax_numpy(
                    _jax_buffers(theirs[rg][name])), f"rg {rg} {name}")
    return ours, st, jst


def _natives_present() -> bool:
    return jax_pack_native() is not None and jax_snappy_native() is not None


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_buffers_match_jax_device_read_with_transports(taxi, transports,
                                                       writer):
    """The default configuration: ``pickup_ts``, the one PLAIN column at
    this size, takes a transport in each row group (the planes, at 34,000
    rows a page), and every buffer, the routing and the staged bytes
    agree."""
    _, files = taxi
    ours, st, jst = _read_both(files[writer])
    assert ours.keys() == {0, 1}
    if _natives_present():
        assert {k: getattr(st, k) for k in COUNTERS} == \
            {k: getattr(jst, k) for k in COUNTERS}
        assert st.bytes_staged == jst.bytes_staged
    assert sum(getattr(st, k) for k in COUNTERS) == 2


@pytest.fixture(scope="module")
def mix():
    blob, groups = chip_smoke.build_mix(1_000_000, 1)
    return blob, groups


def test_transport_mix_matches_jax(mix, transports):
    """Every route engages: tokens for ``tok`` and (past its levels)
    ``tok_opt``, delta lanes for ``seq32`` (width 7) and ``wide_delta``
    (width 39), planes for ``lanes_raw``.  The JAX package reads the
    port-written bytes and routes them the same way."""
    blob, groups = mix
    ours, st, jst = _read_both(blob)
    cols, mask = groups[0]
    assert mask.size == 200_000
    for name, col in ours[0].items():
        vals, _rep, dl = col.to_numpy()
        np.testing.assert_array_equal(vals, cols[name], err_msg=name)
        if name == "tok_opt":
            np.testing.assert_array_equal(dl, mask.astype(np.int32))
    routing = {k: getattr(st, k) for k in COUNTERS}
    assert routing == {"pages_device_snappy": 2,
                       "pages_device_delta_lanes": 2,
                       "pages_device_planes": 1}
    if not _natives_present():
        pytest.skip("the JAX package's C helpers are not built here, so "
                    "its routing differs")
    assert routing == {k: getattr(jst, k) for k in COUNTERS}
    assert st.bytes_staged == jst.bytes_staged


def test_transport_switches_read_per_plan(mix, monkeypatch):
    """The switches are read at each plan, as in the JAX package: one
    process reads the mix with each transport off in turn, and the
    values stay the same."""
    blob, groups = mix
    cols, _ = groups[0]
    reader = FileReader(blob)
    for off, counter in (("TPQ_DEVICE_SNAPPY", "pages_device_snappy"),
                         ("TPQ_DEVICE_DELTA", "pages_device_delta_lanes"),
                         ("TPQ_DEVICE_PLANES", "pages_device_planes")):
        for k in TRANSPORT_ENV:
            monkeypatch.setenv(k, "0" if k == off else "1")
        with collect_stats() as st:
            out = read_row_group_device(reader, 0, device="cpu")
        assert getattr(st, counter) == 0
        for name, col in out.items():
            np.testing.assert_array_equal(col.to_numpy()[0], cols[name])


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_values_match_cpu_oracle(taxi, writer):
    groups, files = taxi
    blob = files[writer]
    oracle = JaxFileReader(io.BytesIO(blob))
    for rg, out in read_row_groups_device(FileReader(blob), device="cpu"):
        want = oracle.read_row_group_arrays(rg)
        cols, masks = groups[rg]
        for name, col in out.items():
            vals, rep, dl = col.to_numpy()
            np.testing.assert_array_equal(vals, np.asarray(want[name].values))
            np.testing.assert_array_equal(vals, cols[name])
            np.testing.assert_array_equal(rep, want[name].rep_levels)
            np.testing.assert_array_equal(dl, want[name].def_levels)
            mask = masks.get(name, np.ones(ROWS, bool))
            np.testing.assert_array_equal(col.mask.numpy(), mask)
            # positions index the packed values of valid slots
            pos = col.positions.numpy()
            np.testing.assert_array_equal(vals[pos[mask]], cols[name])


def test_file_shape_is_config2(taxi):
    """pickup_ts is PLAIN (too many distinct values), the small-range
    columns are dictionary-encoded."""
    _, files = taxi
    meta = FileReader(files["port"]).meta
    enc = {".".join(cc.meta_data.path_in_schema):
           Encoding.RLE_DICTIONARY in cc.meta_data.encodings
           for cc in meta.row_groups[0].columns}
    assert enc == {"pickup_ts": False, "passenger_count": True,
                   "rate_code": True, "trip_distance_mm": True,
                   "payment_type": True}
    assert ROWS > MAX_DICT_ENTRIES


def test_multi_page_chunks_match_jax(no_transports):
    """Several data pages per chunk (the JAX writer's page_rows): page
    parts merge as in the JAX package."""
    groups = _taxi_groups(rows=5000, n_groups=1, seed=3)
    blob = _write(JaxFileWriter, JaxCodec.SNAPPY, groups, page_rows=1500)
    theirs = dict(jax_read_row_groups_device(JaxFileReader(io.BytesIO(blob))))
    ours = dict(read_row_groups_device(FileReader(blob), device="cpu"))
    for name, col in ours[0].items():
        _assert_same_column(col, device_column_from_jax_numpy(
            _jax_buffers(theirs[0][name])), name)


def test_multi_page_chunks_match_jax_with_transports(transports):
    """Several PLAIN pages per chunk, each competing on its own: the
    page parts the transports rebuild merge as in the JAX package."""
    groups = _taxi_groups(rows=5000, n_groups=1, seed=3)
    blob = _write(JaxFileWriter, JaxCodec.SNAPPY, groups, page_rows=1500)
    _, st, jst = _read_both(blob)
    assert sum(getattr(st, k) for k in COUNTERS) > 0
    if _natives_present():
        assert {k: getattr(st, k) for k in COUNTERS} == \
            {k: getattr(jst, k) for k in COUNTERS}


def test_stats_phases_counted(taxi):
    _, files = taxi
    with collect_stats() as st:
        read_row_group_device(FileReader(files["port"]), 0, device="cpu")
    assert st.bytes_staged > 0 and st.plan_s > 0
    assert st.transfer_s > 0 and st.dispatch_s > 0


def test_corrupt_page_fails_crc(taxi):
    _, files = taxi
    blob = bytearray(files["port"])
    cm = FileReader(bytes(blob)).meta.row_groups[0].columns[0].meta_data
    blob[cm.data_page_offset + cm.total_compressed_size // 2] ^= 0xFF
    with pytest.raises(CorruptPageError):
        read_row_group_device(FileReader(bytes(blob)), 0, device="cpu")


def test_out_of_range_dictionary_index_rejected():
    """A width that can express indices past the dictionary is checked
    on the host before any launch."""

    groups = [({"v": np.array([1, 2, 3] * 300, dtype=np.int32)}, {})]
    blob = bytearray(_write(FileWriter, CompressionCodec.UNCOMPRESSED,
                            groups, schema="message m { required int32 v; }",
                            page_crc=False))
    cm = FileReader(bytes(blob)).meta.row_groups[0].columns[0].meta_data
    # the data page body: [width byte][hybrid indices]; index 3 is out of
    # range for the 3-entry dictionary at the same width 2
    body = bytes([2]) + encode_hybrid(np.full(900, 3, np.uint32), 2)
    r = CompactReader(bytes(blob), cm.data_page_offset)
    ph = decode_struct(PageHeader, r)
    old = blob[r.pos : r.pos + ph.compressed_page_size]
    assert len(body) <= len(old)
    blob[r.pos : r.pos + len(body)] = body
    with pytest.raises(CorruptChunkError, match="out of range"):
        read_row_group_device(FileReader(bytes(blob)), 0, device="cpu")


@pytest.mark.parametrize("what", ["gzip", "zstd", "lz4_raw", "dlba", "dba",
                                  "boolean"])
def test_unsupported_input_raises_not_implemented(what):
    """Inputs of later slices raise; none of these is one any more.  The
    GZIP, ZSTD and LZ4_RAW codecs, DELTA_LENGTH_BYTE_ARRAY and
    DELTA_BYTE_ARRAY strings and a BOOLEAN column, which earlier slices
    refused, now read as the JAX package reads them (the codecs that
    still raise, LZO, BROTLI and Hadoop-framed LZ4, are held in
    ``tests/test_torch_codecs.py``)."""
    groups = [({"v": np.arange(100, dtype=np.int64)}, {})]
    schema, codec, kw = "message m { required int64 v; }", JaxCodec.SNAPPY, {}
    if what in ("gzip", "zstd", "lz4_raw"):
        codec = JaxCodec[what.upper()]
    elif what in ("dlba", "dba"):
        schema = "message m { required binary v; }"
        groups = [({"v": JaxByteArrayColumn.from_list(
            [b"x%d" % i for i in range(100)])}, {})]
        kw = {"column_encodings": {"v": JaxEncoding.DELTA_LENGTH_BYTE_ARRAY
                                   if what == "dlba"
                                   else JaxEncoding.DELTA_BYTE_ARRAY}}
    elif what == "boolean":
        schema = "message m { required boolean v; }"
        groups = [({"v": np.arange(100) % 3 == 0}, {})]
    blob = _write(JaxFileWriter, codec, groups, schema=schema, **kw)
    ours, _, _ = _read_both(blob)
    got, want = ours[0]["v"].to_numpy()[0], groups[0][0]["v"]
    if what in ("boolean", "gzip", "zstd", "lz4_raw"):
        np.testing.assert_array_equal(got, want)
    else:
        np.testing.assert_array_equal(got.offsets, want.offsets)
        np.testing.assert_array_equal(got.data, want.data)


# ----------------------------------------------------------------------
# Data page v2, doubles and BYTE_ARRAY strings
# ----------------------------------------------------------------------

def _jax_groups(groups):
    """The generators' ``(offsets, data)`` string columns as the JAX
    package's ByteArrayColumn."""
    return [({k: JaxByteArrayColumn(*v) if isinstance(v, tuple) else v
              for k, v in cols.items()}, masks) for cols, masks in groups]


def _write_groups(writer, schema, groups, **kw) -> bytes:
    if writer == "jax":
        return _write(JaxFileWriter, JaxCodec.SNAPPY, _jax_groups(groups),
                      schema=schema, **kw)
    return _write(FileWriter, CompressionCodec.SNAPPY,
                  chip_smoke._port_columns(groups), schema=schema, **kw)


@pytest.fixture(scope="module")
def config4():
    groups = chip_smoke.config4_groups(40_000, 2)
    return groups, {w: _write_groups(w, chip_smoke.CONFIG4_SCHEMA, groups,
                                     data_page_v2=True)
                    for w in ("jax", "port")}


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_config4_matches_jax(config4, transports, writer):
    """Strings by dictionary (K9), doubles PLAIN, an optional string
    column, V2 pages: every buffer, the staged bytes and the routing (no
    transport wins) equal the JAX package's."""
    groups, files = config4
    ours, st, jst = _read_both(files[writer])
    assert ours.keys() == {0, 1}
    assert {k: getattr(st, k) for k in COUNTERS} == dict.fromkeys(COUNTERS,
                                                                  0)
    if _natives_present():
        assert {k: getattr(jst, k) for k in COUNTERS} == \
            dict.fromkeys(COUNTERS, 0)
        assert st.bytes_staged == jst.bytes_staged
    assert ours[0]["vendor"].lanes is None and ours[0]["fare"].lanes == 2


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_config4_matches_cpu_oracle(config4, writer):
    groups, files = config4
    blob = files[writer]
    oracle = JaxFileReader(io.BytesIO(blob))
    for rg, out in read_row_groups_device(FileReader(blob), device="cpu"):
        want = oracle.read_row_group_arrays(rg)
        cols, masks = groups[rg]
        for name, col in out.items():
            vals, _rep, dl = col.to_numpy()
            ref = want[name].values
            if name in ("vendor", "note"):
                np.testing.assert_array_equal(vals.offsets, ref.offsets)
                np.testing.assert_array_equal(vals.data, ref.data)
                np.testing.assert_array_equal(vals.offsets, cols[name][0])
                np.testing.assert_array_equal(vals.data, cols[name][1])
            else:
                assert vals.dtype == np.dtype("<f8")
                np.testing.assert_array_equal(vals.view(np.uint64),
                                              ref.view(np.uint64))
                np.testing.assert_array_equal(vals, cols[name])
            np.testing.assert_array_equal(dl, want[name].def_levels)
        np.testing.assert_array_equal(out["note"].mask.numpy(),
                                      masks["note"])


@pytest.fixture(scope="module")
def strings():
    return chip_smoke.strings_groups(40_000, 1)


@pytest.mark.parametrize("v2", [False, True])
def test_string_mix_matches_jax(strings, transports, v2):
    """``url`` and ``url_opt`` (past its levels) take the snappy tokens
    and K10; ``token`` ships raw.  Buffers, routing and staged bytes equal
    the JAX package's, for V1 and V2 pages."""
    blob = _write_groups("jax", chip_smoke.STRINGS_SCHEMA, strings,
                         data_page_v2=v2)
    ours, st, jst = _read_both(blob)
    cols, masks = strings[0]
    for name, col in ours[0].items():
        vals = col.to_numpy()[0]
        np.testing.assert_array_equal(vals.offsets, cols[name][0])
        np.testing.assert_array_equal(vals.data, cols[name][1])
    np.testing.assert_array_equal(ours[0]["token"].mask.numpy(),
                                  masks["token"])
    routing = {k: getattr(st, k) for k in COUNTERS}
    assert routing == {"pages_device_snappy": 2,
                       "pages_device_delta_lanes": 0,
                       "pages_device_planes": 0}
    if not _natives_present():
        pytest.skip("the JAX package's C helpers are not built here, so "
                    "its routing differs")
    assert routing == {k: getattr(jst, k) for k in COUNTERS}
    assert st.bytes_staged == jst.bytes_staged


def test_string_mix_without_device_snappy_ships_bytes(strings,
                                                      no_transports):
    """With ``TPQ_DEVICE_SNAPPY=0`` every string page ships its bytes,
    and the buffers still equal the JAX package's."""
    blob = _write_groups("port", chip_smoke.STRINGS_SCHEMA, strings)
    _, st, jst = _read_both(blob)
    assert st.pages_device_snappy == 0
    assert st.bytes_staged == jst.bytes_staged


@pytest.mark.parametrize("v2", [False, True])
def test_multi_page_string_chunks_match_jax(transports, v2):
    """Several data pages per string chunk (the JAX writer's page_rows):
    dictionary and PLAIN pages merge as in the JAX package, offsets
    rebased."""
    groups = chip_smoke.config4_groups(5000, 1, seed=9)
    strs = chip_smoke.strings_groups(5000, 1, seed=9)
    for schema, g in ((chip_smoke.CONFIG4_SCHEMA, groups),
                      (chip_smoke.STRINGS_SCHEMA, strs)):
        blob = _write_groups("jax", schema, g, page_rows=1500,
                             data_page_v2=v2)
        ours, st, jst = _read_both(blob)
        if _natives_present():
            assert st.bytes_staged == jst.bytes_staged
        for name, col in ours[0].items():
            vals = col.to_numpy()[0]
            want = g[0][0][name]
            if isinstance(want, tuple):
                np.testing.assert_array_equal(vals.offsets, want[0])
                np.testing.assert_array_equal(vals.data, want[1])
            else:
                np.testing.assert_array_equal(vals, want)


@pytest.mark.parametrize("what", ["config4", "strings", "strings v2"])
def test_string_page_plans_match_jax(config4, strings, transports, what):
    """Each string page's plan, array for array: the dictionary's offsets
    and bytes, the index and level streams, the token tables and padded
    offsets or the raw bytes — with their padding flags — equal the JAX
    planner's on the same chunk bytes."""
    from tpuparquet.kernels.device import _Stager as JaxStager
    from tpuparquet.kernels.device import plan_chunk_device as jax_plan
    from tpuparquet_torch.kernels.device import _Stager, plan_chunk_device

    if not _natives_present():
        pytest.skip("the JAX package's C helpers are not built here, so "
                    "its plans differ")
    if what == "config4":
        blob = config4[1]["port"]
    else:
        blob = _write_groups("port", chip_smoke.STRINGS_SCHEMA, strings,
                             data_page_v2=what.endswith("v2"))
    ours, theirs = FileReader(blob), JaxFileReader(io.BytesIO(blob))
    planned = []
    for path, node, cm in ours.selected_chunks(ours.meta.row_groups[0]):
        if cm.type != 6:  # BYTE_ARRAY
            continue
        planned.append(path)
        chunk, start = ours.chunk_blob(cm, path)
        stg, jstg = _Stager(), JaxStager()
        plan_chunk_device(chunk, cm, node, start, stg)
        jax_plan(bytes(chunk), cm, theirs.schema.leaf(path), start, jstg)
        assert len(stg.arrays) == len(jstg.arrays), path
        for i, ((a, pad), b) in enumerate(zip(stg.arrays, jstg.arrays)):
            assert pad == (i not in jstg.no_pad), (path, i)
            b = np.ascontiguousarray(b).reshape(-1)
            assert a.itemsize == b.itemsize, (path, i)
            np.testing.assert_array_equal(a.view(np.uint8),
                                          b.view(np.uint8), err_msg=path)
    assert len(planned) == (2 if what == "config4" else 3)


def test_v2_num_nulls_mismatch_raises():
    """A V2 header whose num_nulls disagrees with its def levels is
    corrupt."""
    groups = [({"v": np.arange(900, dtype=np.int32)},
               {"v": np.arange(1000) % 10 != 0})]
    blob = bytearray(_write(FileWriter, CompressionCodec.UNCOMPRESSED,
                            groups, schema="message m { optional int32 v; }",
                            page_crc=False, data_page_v2=True))
    reader = FileReader(bytes(blob))
    cm = reader.meta.row_groups[0].columns[0].meta_data
    r = CompactReader(bytes(blob), cm.data_page_offset)
    ph = decode_struct(PageHeader, r)
    assert ph.data_page_header_v2.num_nulls == 100
    # the page header's num_nulls field: rewrite 100 as 99 (both one
    # zigzag varint byte) in place
    hdr = bytes(blob[cm.data_page_offset : r.pos])
    at = hdr.index(bytes([0x15, 200]))  # field 2, i32, zigzag(100)
    blob[cm.data_page_offset + at + 1] = 198  # zigzag(99)
    with pytest.raises(ValueError, match="num_nulls"):
        read_row_group_device(FileReader(bytes(blob)), 0, device="cpu")
