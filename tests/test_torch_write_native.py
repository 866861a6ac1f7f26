"""The native page path of the writer (``csrc/page.c`` through
``io/pages.py`` ``_write_page_native``) and the one-pass host passes
beside it (``csrc/intern.c``, ``csrc/pack.c`` ``tpq_hybrid_encode``,
``csrc/delta.c`` ``tpq_delta_decode``), held against the JAX package.

The cases of ``tests/test_write_native.py``: the file bytes never change
with the page path (native, or the pure one forced), the encode workers
or the page split, and equal the JAX writer's (same ``created_by``); the
files read back (here, through the JAX package and pyarrow), their CRCs,
page index and bloom filters hold; a fault at ``io.pages.page_write`` drops a page to the pure
path with the same bytes; ``pages_written``, ``pages_assembled_native``
and the stage seconds account for every page as the reference's do.
Inputs come from seeded numpy generators; every comparison is exact.
"""

from __future__ import annotations

import io
import zlib

import numpy as np
import pytest

from tpuparquet import CompressionCodec as JaxCodec
from tpuparquet import FileReader as JaxFileReader
from tpuparquet import FileWriter as JaxFileWriter
from tpuparquet.cpu import delta as jax_delta
from tpuparquet.cpu import dictionary as jax_dictionary
from tpuparquet.cpu import hybrid as jax_hybrid
from tpuparquet.cpu.plain import ByteArrayColumn as JaxByteArrayColumn
from tpuparquet.faults import inject_faults as jax_inject_faults
from tpuparquet.stats import collect_stats as jax_collect_stats
from tpuparquet_torch import faults as port_faults
from tpuparquet_torch.cpu import delta as port_delta
from tpuparquet_torch.cpu import dictionary as port_dictionary
from tpuparquet_torch.cpu import hybrid as port_hybrid
from tpuparquet_torch.cpu.plain import ByteArrayColumn
from tpuparquet_torch.format.compact import CompactReader
from tpuparquet_torch.format.metadata import CompressionCodec, PageHeader, \
    decode_struct
from tpuparquet_torch.io import chunk as port_chunk
from tpuparquet_torch.io import pages as port_pages
from tpuparquet_torch.io.reader import FileReader
from tpuparquet_torch.io.writer import FileWriter
from tpuparquet_torch.native import delta_native, page_native
from tpuparquet_torch.stats import collect_stats

SCHEMA = """message taxi {
    required int64 pickup_ts;
    required int32 passenger_count;
    required int32 rate_code;
    required int64 trip_distance_mm;
    optional int32 payment_type;
    required binary vendor (STRING);
    optional double tip;
}"""

# the counters both writers keep for the write pipeline
WRITE_COUNTERS = ("pages_written", "pages_assembled_native",
                  "faults_injected", "codec_split_blocks")
CODECS = ["SNAPPY", "UNCOMPRESSED", "GZIP", "ZSTD", "LZ4_RAW"]


def _pure_pages(mp):
    """Force the pure page path: no chunk gets a native page context."""
    for mod in (port_pages, port_chunk):
        mp.setattr(mod, "_native_page_ctx", lambda codec: None)


def _columns(bac, n=20_000, seed=52):
    rng = np.random.default_rng(seed)
    pay_mask = rng.random(n) >= 0.05
    tip_mask = rng.random(n) >= 0.3
    vocab = [f"vendor-{i:03d}".encode() for i in range(50)]
    return {
        "pickup_ts": 1_700_000_000_000
        + rng.integers(0, 3_600_000, size=n).cumsum(),
        "passenger_count": rng.integers(1, 7, size=n, dtype=np.int32),
        "rate_code": rng.integers(1, 6, size=n, dtype=np.int32),
        "trip_distance_mm": rng.integers(100, 50_000, size=n),
        "payment_type": rng.integers(
            0, 5, size=int(pay_mask.sum()), dtype=np.int32),
        "vendor": bac.from_list(
            [vocab[i] for i in rng.integers(0, len(vocab), size=n)]),
        "tip": rng.random(int(tip_mask.sum())) * 20.0,
    }, {"payment_type": pay_mask, "tip": tip_mask}


def build(codec="SNAPPY", **kw) -> bytes:
    cols, masks = _columns(ByteArrayColumn)
    buf = io.BytesIO()
    w = FileWriter(buf, SCHEMA, codec=CompressionCodec[codec], **kw)
    w.write_columns(cols, masks=masks)
    w.close()
    return buf.getvalue()


def build_jax(codec="SNAPPY", **kw) -> bytes:
    cols, masks = _columns(JaxByteArrayColumn)
    buf = io.BytesIO()
    w = JaxFileWriter(buf, SCHEMA, codec=JaxCodec[codec],
                      created_by="tpuparquet_torch", **kw)
    w.write_columns(cols, masks=masks)
    w.close()
    return buf.getvalue()


def _counts(st) -> dict:
    return {k: getattr(st, k) for k in WRITE_COUNTERS}


def _pages(blob: bytes):
    """Every page of the file: ``(header, body bytes)``."""
    r = JaxFileReader(io.BytesIO(blob))
    out = []
    for rg in r.meta.row_groups:
        for cc in rg.columns:
            cm = cc.meta_data
            start = cm.data_page_offset
            if cm.dictionary_page_offset is not None:
                start = min(start, cm.dictionary_page_offset)
            end = start + cm.total_compressed_size
            cr = CompactReader(blob, start, end)
            while cr.pos < end:
                ph = decode_struct(PageHeader, cr)
                out.append((ph, blob[cr.pos:cr.pos + ph.compressed_page_size]))
                cr.pos += ph.compressed_page_size
    return out


def _dict_pages(blob: bytes) -> int:
    return sum(1 for ph, _ in _pages(blob) if ph.dictionary_page_header)


# ----------------------------------------------------------------------
# byte parity
# ----------------------------------------------------------------------

class TestByteParity:
    @pytest.mark.parametrize("threads", [1, 2, 4])
    @pytest.mark.parametrize("page_rows", [0, 3_000])
    def test_parity_snappy_v1(self, monkeypatch, threads, page_rows):
        native = build(encode_threads=threads, page_rows=page_rows)
        with monkeypatch.context() as m:
            _pure_pages(m)
            pure = build(encode_threads=threads, page_rows=page_rows)
        assert native == pure == build_jax(encode_threads=threads,
                                           page_rows=page_rows)

    @pytest.mark.parametrize("codec", CODECS)
    @pytest.mark.parametrize("v2", [False, True], ids=["v1", "v2"])
    def test_parity_codec_matrix(self, monkeypatch, codec, v2):
        with collect_stats() as st:
            native = build(codec, data_page_v2=v2)
        with jax_collect_stats() as jst:
            theirs = build_jax(codec, data_page_v2=v2)
        _pure_pages(monkeypatch)
        with collect_stats() as pst:
            pure = build(codec, data_page_v2=v2)
        assert native == pure == theirs
        assert _counts(st) == _counts(jst)
        assert st.pages_assembled_native == \
            st.pages_written - _dict_pages(native) > 0
        assert pst.pages_assembled_native == 0
        assert pst.pages_written == st.pages_written

    def test_parity_gzip_native_codecs_off(self, monkeypatch):
        """``TPQ_NATIVE_CODECS=0`` takes the native page path off (no
        codec context), as in the reference; GZIP's stdlib bytes differ,
        its values do not."""
        with collect_stats() as st:
            a = build("GZIP")
        monkeypatch.setenv("TPQ_NATIVE_CODECS", "0")
        with collect_stats() as st2:
            b = build("GZIP")
        assert st.pages_assembled_native > 0
        assert st2.pages_assembled_native == 0 and st2.pages_written > 0
        ra = FileReader(a).read_row_group_arrays(0)
        rb = FileReader(b).read_row_group_arrays(0)
        for name in ("pickup_ts", "tip"):
            np.testing.assert_array_equal(np.asarray(ra[name].values),
                                          np.asarray(rb[name].values))

    def test_parity_list_column(self, monkeypatch):
        """A repeated column (rep levels through the native pass)."""
        rng = np.random.default_rng(7)
        n = 3_000
        counts = rng.integers(0, 5, size=n)
        offs = np.zeros(n + 1, dtype=np.int64)
        np.cumsum(counts, out=offs[1:])
        vals = rng.integers(0, 1000, size=int(offs[-1]))

        def one(cls, **kw):
            buf = io.BytesIO()
            w = cls(buf, "message m { repeated int64 xs; }",
                    codec=(CompressionCodec.SNAPPY if cls is FileWriter
                           else JaxCodec.SNAPPY), **kw)
            w.write_columns({"xs": vals}, offsets={"xs": offs})
            w.close()
            return buf.getvalue()

        native = one(FileWriter)
        theirs = one(JaxFileWriter, created_by="tpuparquet_torch")
        _pure_pages(monkeypatch)
        assert native == one(FileWriter) == theirs

    def test_device_values_columns(self, monkeypatch):
        """Columns read back as ``DeviceValues`` (the plain versions on the
        CPU) take the native path too, byte for byte the numpy file."""
        from tpuparquet_torch.kernels.device import read_row_groups_device

        blob = build()
        reader = FileReader(blob)
        ((_, cols),) = read_row_groups_device(reader, device="cpu")
        # strings stay numpy (as_values takes fixed-width columns)
        dv = {name: (col.as_values() if name != "vendor"
                     else col.to_numpy()[0])
              for name, col in cols.items()}
        masks = {name: col.mask.numpy() for name, col in cols.items()
                 if reader.schema.leaf(name).max_def_level}

        def one():
            buf = io.BytesIO()
            w = FileWriter(buf, SCHEMA, codec=CompressionCodec.SNAPPY)
            w.write_columns(dv, masks=masks)
            w.close()
            return buf.getvalue()

        with collect_stats() as st:
            got = one()
        _pure_pages(monkeypatch)
        assert got == one() == blob
        assert st.pages_device_encoded > 0
        assert st.pages_assembled_native == \
            st.pages_written - _dict_pages(got)


# ----------------------------------------------------------------------
# read-back, CRC, page index, bloom
# ----------------------------------------------------------------------

class TestReadBack:
    @pytest.mark.parametrize("page_rows", [0, 3_000])
    def test_reads_as_written(self, page_rows):
        cols, masks = _columns(ByteArrayColumn)
        blob = build(page_rows=page_rows)
        for reader in (FileReader(blob), JaxFileReader(io.BytesIO(blob))):
            a = reader.read_row_group_arrays(0)
            np.testing.assert_array_equal(
                np.asarray(a["pickup_ts"].values), cols["pickup_ts"])
            np.testing.assert_array_equal(
                np.asarray(a["payment_type"].values), cols["payment_type"])
            np.testing.assert_array_equal(
                np.asarray(a["vendor"].values.offsets),
                cols["vendor"].offsets)

    def test_pyarrow_reads_and_verifies_checksums(self):
        pq = pytest.importorskip("pyarrow.parquet")
        cols, _ = _columns(ByteArrayColumn)
        single = pq.read_table(io.BytesIO(build()),
                               page_checksum_verification=True)
        multi = pq.read_table(io.BytesIO(build(page_rows=3_000)),
                              page_checksum_verification=True)
        assert single.equals(multi)
        np.testing.assert_array_equal(single["pickup_ts"].to_numpy(),
                                      cols["pickup_ts"])


class TestCrcIndexBloom:
    @pytest.mark.parametrize("v2", [False, True], ids=["v1", "v2"])
    def test_crc_values_are_zlib(self, v2):
        checked = 0
        for ph, body in _pages(build(data_page_v2=v2, page_rows=3_000)):
            assert ph.crc is not None
            assert ph.crc & 0xFFFFFFFF == zlib.crc32(body)
            checked += 1
        assert checked >= 9

    def test_crc_catches_corruption(self):
        blob = bytearray(build())
        cm = FileReader(bytes(blob)).meta.row_groups[0].columns[0].meta_data
        cr = CompactReader(bytes(blob), cm.data_page_offset,
                           cm.data_page_offset + cm.total_compressed_size)
        decode_struct(PageHeader, cr)
        blob[cr.pos + 10] ^= 0xFF
        from tpuparquet_torch.errors import CorruptPageError

        with pytest.raises(CorruptPageError, match="CRC"):
            FileReader(bytes(blob)).read_row_group_arrays(0)

    def test_multipage_page_index(self):
        cols, _ = _columns(ByteArrayColumn)
        n = len(cols["pickup_ts"])
        blob = build(page_rows=3_000)
        ours = FileReader(blob).page_index(0, columns=["pickup_ts"])
        theirs = JaxFileReader(io.BytesIO(blob)).page_index(
            0, columns=["pickup_ts"])
        pages = ours["pickup_ts"]
        assert [tuple(p) for p in pages] == \
            [tuple(p) for p in theirs["pickup_ts"]]
        n_pages = -(-n // 3_000)
        assert [p[0] for p in pages] == [i * 3_000 for i in range(n_pages)]
        assert pages[1][2] == cols["pickup_ts"][3_000]
        assert pages[0][3] == cols["pickup_ts"][2_999]

    def test_multipage_pruning_skips_pages(self):
        from tpuparquet_torch.filter import col

        cols, _ = _columns(ByteArrayColumn)
        lo = int(cols["pickup_ts"][0])
        with collect_stats() as st:
            out = FileReader(build(page_rows=3_000)).read_row_group_arrays(
                0, filter=(col("pickup_ts") <= lo))
        assert st.pages_pruned > 0
        assert len(out["pickup_ts"].values) >= 1

    def test_bloom_written_and_hits(self):
        blob = build(bloom_columns=["vendor"])
        assert blob == build_jax(bloom_columns=["vendor"])
        b = FileReader(blob).bloom_filter(0, "vendor")
        assert b is not None and b.check(b"vendor-001")
        assert not b.check(b"no-such-vendor")


# ----------------------------------------------------------------------
# the io.pages.page_write fault
# ----------------------------------------------------------------------

class TestFaultFallback:
    def test_all_pages_fall_back(self, monkeypatch):
        """Every data page's native attempt faulted: the pure path writes
        each, the bytes are an unfaulted write's, and the counters equal
        the reference's under the same rule."""
        with monkeypatch.context() as m:
            _pure_pages(m)
            pure = build()
        with port_faults.inject_faults() as inj, collect_stats() as st:
            inj.inject("io.pages.page_write", "transient", times=100)
            faulted = build()
        with jax_inject_faults() as inj, jax_collect_stats() as jst:
            inj.inject("io.pages.page_write", "transient", times=100)
            theirs = build_jax()
        assert faulted == pure == theirs
        assert _counts(st) == _counts(jst)
        assert st.pages_assembled_native == 0 and st.faults_injected > 0

    def test_single_page_falls_back(self):
        clean = build()
        with port_faults.inject_faults() as inj, collect_stats() as st:
            inj.inject("io.pages.page_write", "transient", times=1)
            faulted = build()
        with jax_inject_faults() as inj, jax_collect_stats() as jst:
            inj.inject("io.pages.page_write", "transient", times=1)
            build_jax()
        assert faulted == clean
        assert _counts(st) == _counts(jst)
        assert st.faults_injected == 1
        assert st.pages_assembled_native == \
            st.pages_written - _dict_pages(clean) - 1


# ----------------------------------------------------------------------
# counters
# ----------------------------------------------------------------------

class TestCounters:
    @pytest.mark.parametrize("threads", [1, 4])
    @pytest.mark.parametrize("page_rows", [0, 3_000])
    def test_every_page_accounted(self, threads, page_rows):
        with collect_stats() as st:
            blob = build(encode_threads=threads, page_rows=page_rows)
        with jax_collect_stats() as jst:
            build_jax(encode_threads=threads, page_rows=page_rows)
        assert _counts(st) == _counts(jst)
        assert st.pages_written == len(_pages(blob))
        assert st.pages_assembled_native == \
            st.pages_written - _dict_pages(blob)
        assert min(st.write_encode_s, st.write_compress_s,
                   st.write_assemble_s) > 0.0

    def test_stage_seconds_move_only_with_native(self, monkeypatch):
        _pure_pages(monkeypatch)
        with collect_stats() as st:
            build()
        assert st.pages_assembled_native == 0 and st.pages_written > 0
        assert (st.write_encode_s, st.write_compress_s,
                st.write_assemble_s) == (0.0, 0.0, 0.0)

    def test_counters_merge_and_ship(self):
        with collect_stats() as st:
            build(encode_threads=4, page_rows=3_000)
        state = st.to_state()
        for k in WRITE_COUNTERS + ("write_encode_s", "write_compress_s",
                                   "write_assemble_s"):
            assert state[k] == getattr(st, k)
        from tpuparquet.stats import DecodeStats as JaxDecodeStats

        jst = JaxDecodeStats.from_state(state)
        assert _counts(jst) == _counts(st)

    def test_user_compressor_takes_the_pure_path(self):
        """A compressor registered on the codec keeps the page bytes: the
        native path steps aside, as the reference's does."""
        from tpuparquet_torch import compress

        class Flip(compress.BlockCompressor):
            def compress_block(self, b):
                return bytes(x ^ 0x5A for x in b)

            def decompress_block(self, b, n):
                return bytes(x ^ 0x5A for x in b)

        saved = compress._registry[int(CompressionCodec.UNCOMPRESSED)]
        compress.register_block_compressor(CompressionCodec.UNCOMPRESSED,
                                           Flip())
        try:
            assert not compress.builtin_uncompressed_registered()
            with collect_stats() as st:
                blob = build("UNCOMPRESSED")
            assert st.pages_assembled_native == 0
            a = FileReader(blob).read_row_group_arrays(0)
        finally:
            compress.register_block_compressor(
                CompressionCodec.UNCOMPRESSED, saved)
        assert compress.builtin_uncompressed_registered()
        cols, _ = _columns(ByteArrayColumn)
        np.testing.assert_array_equal(np.asarray(a["pickup_ts"].values),
                                      cols["pickup_ts"])
        assert blob != build("UNCOMPRESSED")


# ----------------------------------------------------------------------
# the page pass, the CRC, the intern, the u64 hybrid encode, the decode
# ----------------------------------------------------------------------

@pytest.mark.parametrize("seed", range(4))
def test_crc32_is_zlibs(seed):
    rng = np.random.default_rng(seed)
    pg = page_native()
    for n in (0, 1, 7, 8, 9, 63, 1000, 65_537):
        b = rng.integers(0, 256, n, dtype=np.uint8)
        start = int(rng.integers(0, 1 << 32))
        assert pg.crc32(b, start) == zlib.crc32(b.tobytes(), start)
        assert pg.crc32(b[1:]) == zlib.crc32(b[1:].tobytes())


@pytest.mark.parametrize("dtype", ["int32", "int64", "uint32", "uint64",
                                   "int16", "uint16"])
@pytest.mark.parametrize("seed", range(3))
def test_small_range_intern_as_reference(dtype, seed):
    """The dictionary build of a small-range integer column (C for 4- and
    8-byte values): the same dictionary, order and indices."""
    rng = np.random.default_rng(seed)
    info = np.iinfo(dtype)
    lo = int(rng.integers(max(info.min, -1 << 40),
                          min(info.max, 1 << 40) - 1300))
    for n, span in ((1, 1), (5_000, 37), (5_000, 300), (300, 1200)):
        v = (lo + rng.integers(0, span, n)).astype(dtype)
        d, i = port_dictionary.build_dictionary(v)
        jd, ji = jax_dictionary.build_dictionary(v)
        assert d.dtype == jd.dtype and i.dtype == ji.dtype
        np.testing.assert_array_equal(d, jd)
        np.testing.assert_array_equal(i, ji)
    extremes = np.array([info.min, info.max, info.min], dtype=dtype)
    np.testing.assert_array_equal(
        port_dictionary.build_dictionary(extremes)[1],
        jax_dictionary.build_dictionary(extremes)[1])


HYBRID_CASES = [(w, dt) for dt in ("uint32", "int32", "int64", "uint64")
                for w in (1, 3, 8, 13, 31, 32, 33, 47, 63, 64)
                if w <= 8 * np.dtype(dt).itemsize]


@pytest.mark.parametrize("width,dtype", HYBRID_CASES)
def test_hybrid_encode_as_reference(width, dtype):
    """``encode_hybrid`` at every width the dtype holds: u32 and int32
    through the u32 pass, the rest through the u64 pass
    (``tpq_hybrid_encode``), byte for byte the reference's stream."""
    rng = np.random.default_rng(width)
    top = min((1 << width) - 1, np.iinfo(dtype).max)
    for n in (1, 7, 8, 9, 1_000, 4_099):
        v = rng.integers(0, top, n, dtype=np.uint64, endpoint=True) \
            .astype(dtype)
        v[n // 3:n // 3 + min(n // 2, 40)] = v[n // 3]
        assert port_hybrid.encode_hybrid(v, width) == \
            bytes(jax_hybrid.encode_hybrid(v, width))
    if width < 64:
        bad = np.array([0, 1 << width], dtype=np.uint64)
        for enc in (port_hybrid.encode_hybrid, jax_hybrid.encode_hybrid):
            with pytest.raises(ValueError, match="does not fit"):
                enc(bad, width)


@pytest.mark.parametrize("dtype", [np.int32, np.int64])
@pytest.mark.parametrize("seed", range(4))
def test_delta_decode_as_reference(dtype, seed):
    """``decode_delta_binary_packed`` (one C pass) equals the reference's
    decode and its own numpy form, wraps included."""
    rng = np.random.default_rng(seed)
    info = np.iinfo(dtype)
    for n in (1, 2, 129, 513, 70_001):
        v = rng.integers(info.min, info.max, n, dtype=dtype, endpoint=True)
        if seed % 2:
            v = np.sort(v)
        blob = port_delta.encode_delta_binary_packed(v)
        got, end = port_delta.decode_delta_binary_packed(blob, dtype)
        want, jend = jax_delta.decode_delta_binary_packed(blob, dtype)
        np.testing.assert_array_equal(got, v)
        np.testing.assert_array_equal(got, want)
        assert got.dtype == want.dtype and end == jend == len(blob)


def test_delta_decode_declines_an_overrun(monkeypatch):
    """A structure whose miniblock runs past the data makes the C pass
    decline (None), and the decode raises rather than read past it."""
    v = np.random.default_rng(5).integers(0, 1 << 20, 1_000)
    blob = port_delta.encode_delta_binary_packed(v)
    st = port_delta.scan_delta_structure(blob)
    st.mb_pos = list(np.asarray(st.mb_pos) + len(blob))
    assert delta_native().decode_all(blob, st) is None
    monkeypatch.setattr(port_delta, "scan_delta_structure",
                        lambda data, pos=0: st)
    with pytest.raises(ValueError, match="delta miniblock overruns the data"):
        port_delta.decode_delta_binary_packed(blob, np.int64)
