"""GZIP, ZSTD and LZ4_RAW in tpuparquet_torch against the JAX package.

Every comparison has a tolerance of 0.  The codecs both ways (the port's
compressed bytes equal the JAX package's, and each side decodes the
other's), with native codecs on and under ``TPQ_NATIVE_CODECS=0``;
multi-member GZIP and multi-frame ZSTD; corrupt input raising
``CompressionError``, and ``CorruptChunkError`` with coordinates inside a
device read; ``TPQ_ZSTD_LEVEL``; the block-parallel split at
``TPQ_COMPRESS_BLOCK_KB=64`` with its ``codec_split_blocks`` and
``codec_split_frames`` counts; the failed ``TPQ_ZSTD_LIB`` override (a
known difference: the port raises); column chunks written by
``FileWriter`` in each codec at ``encode_threads`` 1 and 4, byte for
byte; pyarrow-written files in the three codecs read by both packages'
device reads, buffer for buffer, with the staged bytes and routing
counters; ``ShardedScan`` over a ZSTD file; and the launch counters
under threads.
"""

import io
import sys
import threading
import zlib
from pathlib import Path

import numpy as np
import pyarrow as pa
import pyarrow.parquet as pq
import pytest

from tpuparquet import CompressionCodec as JaxCodec
from tpuparquet import FileWriter as JaxFileWriter
from tpuparquet import compress as jax_compress
from tpuparquet.errors import CorruptChunkError as JaxCorruptChunkError
from tpuparquet.io.reader import FileReader as JaxFileReader
from tpuparquet.kernels.device import read_row_groups_device as \
    jax_read_row_groups_device
from tpuparquet.kernels.arena import lease_arena as jax_lease_arena
from tpuparquet.kernels.arena import return_arena as jax_return_arena
from tpuparquet.stats import collect_stats as jax_collect_stats
from tpuparquet_torch import compress, syslibs
from tpuparquet_torch.errors import CorruptChunkError
from tpuparquet_torch.format.metadata import CompressionCodec, Encoding
from tpuparquet_torch.io.reader import FileReader
from tpuparquet_torch.io.writer import FileWriter
from tpuparquet_torch.kernels import _lib
from tpuparquet_torch.kernels.arena import HostArena
from tpuparquet_torch.kernels.device import read_row_group_device, \
    read_row_groups_device
from tpuparquet_torch.stats import collect_stats

sys.path.insert(0, str(Path(__file__).resolve().parent))

from test_torch_encode import _build, _chunks, _same_as_jax  # noqa: E402
from test_torch_shard import _gather_both, _same, _scans  # noqa: E402
from test_torch_types import COUNTERS, assert_matches_oracle, \
    read_both  # noqa: E402

C = CompressionCodec
CODECS = ("GZIP", "ZSTD", "LZ4_RAW")


def _jax(codec):
    return JaxCodec(int(codec))


def _payloads():
    rng = np.random.default_rng(61)
    return {
        "empty": b"",
        "byte": b"\x07",
        "text": b"the quick brown fox jumps over the lazy dog " * 400,
        "ints": np.arange(20_000, dtype=np.int64).tobytes(),
        "noise": rng.integers(0, 256, 70_000, dtype=np.uint8).tobytes(),
        "runs": np.repeat(rng.integers(0, 9, 300, dtype=np.uint8),
                          rng.integers(1, 500, 300)).tobytes(),
    }


PAYLOADS = _payloads()


@pytest.fixture(params=["native", "fallback"])
def native(request, monkeypatch):
    """Both legs of ``TPQ_NATIVE_CODECS``."""
    monkeypatch.setenv("TPQ_NATIVE_CODECS",
                       "1" if request.param == "native" else "0")
    return request.param == "native"


# ----------------------------------------------------------------------
# the codecs, both ways
# ----------------------------------------------------------------------

@pytest.mark.parametrize("name", list(PAYLOADS))
@pytest.mark.parametrize("codec", CODECS + ("SNAPPY",))
def test_codec_both_ways_as_jax(codec, name, native):
    """SNAPPY and LZ4_RAW stay in C under ``TPQ_NATIVE_CODECS=0``; the
    JAX package's LZ4_RAW mirror writes the C codec's bytes, its snappy
    mirror other (valid) bytes."""
    d = PAYLOADS[name]
    ours = compress.compress_block(C[codec], d)
    theirs = jax_compress.compress_block(_jax(C[codec]), d)
    assert (ours == bytes(theirs)) or (codec == "SNAPPY" and not native)
    got = compress.decompress_block(C[codec], theirs, len(d))
    assert got.tobytes() == d
    assert bytes(jax_compress.decompress_block(_jax(C[codec]), ours,
                                               len(d))) == d


@pytest.mark.parametrize("codec", ["GZIP", "ZSTD"])
def test_native_and_fallback_decode_each_other(codec, monkeypatch):
    d = PAYLOADS["ints"]
    monkeypatch.setenv("TPQ_NATIVE_CODECS", "1")
    nat = compress.compress_block(C[codec], d)
    monkeypatch.setenv("TPQ_NATIVE_CODECS", "0")
    fb = compress.compress_block(C[codec], d)
    assert fb == bytes(jax_compress.compress_block(_jax(C[codec]), d))
    assert compress.decompress_block(C[codec], nat, len(d)).tobytes() == d
    monkeypatch.setenv("TPQ_NATIVE_CODECS", "1")
    assert compress.decompress_block(C[codec], fb, len(d)).tobytes() == d


def test_gzip_multi_member(native):
    d = b"alpha" * 4000 + b"beta" * 4000
    body = b"".join(compress.compress_block(C.GZIP, p)
                    for p in (d[:10_000], d[10_000:15_000], d[15_000:]))
    assert compress.decompress_block(C.GZIP, body, len(d)).tobytes() == d
    assert bytes(jax_compress.decompress_block(JaxCodec.GZIP, body,
                                               len(d))) == d


@pytest.mark.parametrize("workers", [1, 4])
def test_zstd_multi_frame(workers, native):
    """Frames one a worker (native, ``workers`` 4, counted like the
    JAX package's), or in one call; the wheel streams across frames."""
    d = np.arange(30_000, dtype=np.int64).tobytes()
    body = b"".join(compress.compress_block(C.ZSTD, p)
                    for p in (d[:100_000], d[100_000:150_000], d[150_000:]))
    arena = HostArena()
    with collect_stats() as st:
        got = compress.decompress_block(C.ZSTD, body, len(d), arena,
                                        workers=workers)
    assert got.tobytes() == d
    frames = 3 if native and workers > 1 else 0
    assert st.codec_split_frames == frames
    if native:
        jarena = jax_lease_arena()
        try:
            with jax_collect_stats() as jst:
                want = jax_compress.decompress_block_into(
                    JaxCodec.ZSTD, np.frombuffer(body, np.uint8), len(d),
                    jarena, workers=workers)
            assert want.tobytes() == d
            assert jst.codec_split_frames == frames
        finally:
            jax_return_arena(jarena)


@pytest.mark.parametrize("codec", CODECS)
def test_decompress_into_arena_slab(codec, native):
    """The C and system libraries decode into a slab the arena lends;
    the stdlib and the wheel hand back their own bytes."""
    d = PAYLOADS["text"]
    arena = HostArena()
    body = compress.compress_block(C[codec], d)
    got = compress.decompress_block(C[codec], body, len(d), arena)
    assert got.tobytes() == d
    in_slab = np.shares_memory(got, arena._used[0]) if arena._used \
        else False
    assert in_slab == (native or codec == "LZ4_RAW")


# ----------------------------------------------------------------------
# corrupt input
# ----------------------------------------------------------------------

LZ4_MALFORMED = [
    b"\x10",                    # literal run of 1, no payload
    b"\xf0",                    # 15-extension announced, truncated
    b"\xff" * 20,               # runaway 255-chain
    bytes([0x00, 0x00, 0x00]),  # bytes after the final literal token
    bytes([0x10, ord("a"), 0x00, 0x00]),  # offset 0
    bytes([0x10, ord("a"), 0x05, 0x00]),  # offset 5 > output pos 1
    bytes([0x1f, ord("a")]),    # match-length extension truncated
    bytes([0x10, ord("a"), 0x01]),        # offset truncated
]


@pytest.mark.parametrize("i", range(len(LZ4_MALFORMED)))
def test_lz4_malformed_raises_as_jax(i):
    blob = LZ4_MALFORMED[i]
    with pytest.raises(compress.CompressionError):
        compress.decompress_block(C.LZ4_RAW, blob, 64)
    with pytest.raises(jax_compress.CompressionError):
        jax_compress.decompress_block(JaxCodec.LZ4_RAW, blob, 64)


def test_lz4_truncations_raise():
    d = b"the quick brown fox " * 50
    blob = compress.compress_block(C.LZ4_RAW, d)
    for cut in range(len(blob)):
        with pytest.raises(compress.CompressionError):
            compress.decompress_block(C.LZ4_RAW, blob[:cut], len(d))


@pytest.mark.parametrize("codec", ["GZIP", "ZSTD"])
def test_corrupt_raises_as_jax(codec, native):
    good = compress.compress_block(C[codec], b"y" * 1000)
    for bad, size in ((b"\x12\x34\x56\x78garbage", 100),
                      (good[: len(good) // 2], 1000),
                      (good, 999), (good, 1001)):
        with pytest.raises(compress.CompressionError):
            compress.decompress_block(C[codec], bad, size)
        with pytest.raises(jax_compress.CompressionError):
            jax_compress.decompress_block(_jax(C[codec]), bad, size)


def _page_payload_span(blob: bytes):
    """(start, end) of the first data page's payload in a one-column
    file."""
    from tpuparquet_torch.format.compact import CompactReader
    from tpuparquet_torch.format.metadata import PageHeader, decode_struct

    cm = FileReader(blob).meta.row_groups[0].columns[0].meta_data
    r = CompactReader(blob, cm.data_page_offset)
    ph = decode_struct(PageHeader, r)
    return r.pos, r.pos + ph.compressed_page_size


@pytest.mark.parametrize("codec", CODECS)
def test_corrupt_page_is_a_corrupt_chunk(codec):
    """A codec error inside a device read: CorruptChunkError with the
    column and row group, as the JAX package's read raises."""
    n = 5000
    blob = _build("message m { required int64 v; }",
                  {"v": np.arange(n, dtype=np.int64) % 97},
                  codec=C[codec], allow_dict=False, page_crc=False)
    a, b = _page_payload_span(blob)
    bad = bytearray(blob)
    bad[a:b] = (b"\xff" if codec == "LZ4_RAW" else b"\x00") * (b - a)
    with pytest.raises(CorruptChunkError) as e:
        read_row_group_device(FileReader(bytes(bad)), 0, device="cpu")
    assert (e.value.column, e.value.row_group) == ("v", 0)
    with pytest.raises(JaxCorruptChunkError):
        list(jax_read_row_groups_device(JaxFileReader(io.BytesIO(
            bytes(bad)))))


@pytest.mark.parametrize("codec", ["LZO", "BROTLI", "LZ4"])
def test_unsupported_codecs_raise_naming_them(codec):
    with pytest.raises(NotImplementedError, match=codec):
        compress.compress_block(C[codec], b"abc")
    with pytest.raises(NotImplementedError, match=codec):
        compress.decompress_block(C[codec], b"abc", 3)
    with pytest.raises(NotImplementedError, match=codec):
        _build("message m { required int32 v; }",
               {"v": np.arange(10, dtype=np.int32)}, codec=C[codec])


# ----------------------------------------------------------------------
# knobs
# ----------------------------------------------------------------------

@pytest.mark.parametrize("level", ["1", "19", "-3", "junk"])
def test_zstd_level_as_jax(level, native, monkeypatch):
    d = b"level knob payload " * 3000
    monkeypatch.setenv("TPQ_ZSTD_LEVEL", level)
    ours = compress.compress_block(C.ZSTD, d)
    assert ours == bytes(jax_compress.compress_block(JaxCodec.ZSTD, d))
    assert compress.decompress_block(C.ZSTD, ours, len(d)).tobytes() == d


def test_zstd_level_changes_size(monkeypatch):
    d = b" ".join(b"w%d" % (i * 7919 % 1013) for i in range(40_000))
    monkeypatch.setenv("TPQ_ZSTD_LEVEL", "1")
    c1 = compress.compress_block(C.ZSTD, d)
    monkeypatch.setenv("TPQ_ZSTD_LEVEL", "19")
    c19 = compress.compress_block(C.ZSTD, d)
    assert len(c19) < len(c1)


def test_failed_zstd_override_raises(monkeypatch):
    """A known difference: the JAX package falls back to the wheel when
    ``TPQ_ZSTD_LIB`` names a library that does not load; the port
    raises, naming the path."""
    monkeypatch.setenv("TPQ_ZSTD_LIB", "/nonexistent/libzstd.so")
    monkeypatch.setattr(syslibs, "_zstd_inst", False)
    with pytest.raises(OSError, match="/nonexistent/libzstd.so"):
        syslibs.zstd_native()
    with pytest.raises(OSError, match="TPQ_ZSTD_LIB"):
        compress.compress_block(C.ZSTD, b"abc")
    monkeypatch.setattr(syslibs, "_zlib_inst", False)
    monkeypatch.setenv("TPQ_ZLIB_LIB", "/nonexistent/libz.so")
    with pytest.raises(OSError, match="/nonexistent/libz.so"):
        syslibs.zlib_native()
    # without an override the system libraries load again
    monkeypatch.delenv("TPQ_ZSTD_LIB")
    monkeypatch.delenv("TPQ_ZLIB_LIB")
    monkeypatch.setattr(syslibs, "_zstd_inst", False)
    monkeypatch.setattr(syslibs, "_zlib_inst", False)
    assert syslibs.zstd_native() is not None
    assert syslibs.zlib_native() is not None
    monkeypatch.setattr(syslibs, "_zstd_inst", False)
    monkeypatch.setattr(syslibs, "_zlib_inst", False)


def test_override_names_a_library_that_loads(monkeypatch):
    path = syslibs.library_path(syslibs.zstd_native())
    assert path is not None and "zstd" in path
    monkeypatch.setenv("TPQ_ZSTD_LIB", path)
    monkeypatch.setattr(syslibs, "_zstd_inst", False)
    d = PAYLOADS["text"]
    assert compress.compress_block(C.ZSTD, d) == bytes(
        jax_compress.compress_block(JaxCodec.ZSTD, d))
    monkeypatch.setattr(syslibs, "_zstd_inst", False)


# ----------------------------------------------------------------------
# the block-parallel split
# ----------------------------------------------------------------------

@pytest.mark.parametrize("codec", ["GZIP", "ZSTD"])
@pytest.mark.parametrize("workers", [1, 2, 4])
def test_split_bytes_and_counts_as_jax(codec, workers, monkeypatch):
    monkeypatch.setenv("TPQ_COMPRESS_BLOCK_KB", "64")
    d = np.arange(80_000, dtype=np.int64).tobytes()  # 640 KB: 10 blocks
    src = np.frombuffer(d, dtype=np.uint8)
    ctx = compress.page_codec_settings(C[codec])
    jctx = jax_compress.page_codec_settings(_jax(C[codec]))
    out = np.empty(compress.page_compress_bound(ctx, src.size, workers),
                   np.uint8)
    jout = np.empty(jax_compress.page_compress_bound(jctx, src.size,
                                                     workers), np.uint8)
    with collect_stats() as st:
        n = compress.page_compress_into(ctx, src, out, workers)
    with jax_collect_stats() as jst:
        jn = jax_compress.page_compress_into(jctx, src, jout, workers)
    assert out[:n].tobytes() == jout[:jn].tobytes()
    assert st.codec_split_blocks == jst.codec_split_blocks == \
        (10 if workers > 1 else 0)
    if workers == 1:  # one worker: the single frame of compress_block
        assert out[:n].tobytes() == compress.compress_block(C[codec], d)
    assert compress.page_compress(C[codec], d, workers) == out[:n].tobytes()
    with collect_stats() as st:
        got = compress.decompress_block(C[codec], out[:n], len(d),
                                        workers=4)
    assert got.tobytes() == d
    assert st.codec_split_frames == (10 if workers > 1
                                     and codec == "ZSTD" else 0)


@pytest.mark.parametrize("codec", ["LZ4_RAW", "SNAPPY", "UNCOMPRESSED"])
def test_other_codecs_never_split(codec, monkeypatch):
    monkeypatch.setenv("TPQ_COMPRESS_BLOCK_KB", "64")
    d = np.zeros(500_000, dtype=np.uint8).tobytes()
    ctx = compress.page_codec_settings(C[codec])
    jctx = jax_compress.page_codec_settings(_jax(C[codec]))
    # SNAPPY and LZ4_RAW hand the native page path a context, as the
    # reference's do, which is never splittable
    assert (ctx is None) == (jctx is None)
    assert ctx is None or not ctx.splittable
    with collect_stats() as st:
        got = compress.page_compress(C[codec], d, workers=8)
    assert got == compress.compress_block(C[codec], d)
    assert st.codec_split_blocks == 0


def test_no_split_with_native_codecs_off(monkeypatch):
    monkeypatch.setenv("TPQ_COMPRESS_BLOCK_KB", "64")
    monkeypatch.setenv("TPQ_NATIVE_CODECS", "0")
    d = np.arange(80_000, dtype=np.int64).tobytes()
    for codec in ("GZIP", "ZSTD"):
        assert compress.page_codec_settings(C[codec]) is None
        assert jax_compress.page_codec_settings(_jax(C[codec])) is None
        with collect_stats() as st:
            got = compress.page_compress(C[codec], d, workers=8)
        assert got == compress.compress_block(C[codec], d)
        assert st.codec_split_blocks == 0


def test_split_body_reads_on_the_wheel(monkeypatch):
    """A split ZSTD body decodes on the wheel too (it streams across
    frames)."""
    monkeypatch.setenv("TPQ_COMPRESS_BLOCK_KB", "64")
    d = np.arange(50_000, dtype=np.int64).tobytes()
    body = compress.page_compress(C.ZSTD, d, workers=4)
    monkeypatch.setenv("TPQ_NATIVE_CODECS", "0")
    assert compress.decompress_block(C.ZSTD, body, len(d)).tobytes() == d


# ----------------------------------------------------------------------
# files: the writer
# ----------------------------------------------------------------------

SCHEMA = """message m {
    required int64 ts;
    required double fare;
    optional int64 dist;
    required int32 code;
    required binary tag;
}"""


def _columns(n: int, seed: int = 21):
    from tpuparquet.cpu.plain import ByteArrayColumn as JaxByteArrayColumn
    from tpuparquet_torch.cpu.plain import ByteArrayColumn

    rng = np.random.default_rng(seed)
    dm = rng.random(n) >= 0.2
    words = [b"alpha", b"beta", b"gamma", b"delta", b""]
    tags = [words[k] for k in rng.integers(0, 5, n)]
    vals = {
        "ts": 1_700_000_000_000 + rng.integers(0, 60_000, n).cumsum(),
        "fare": np.round(rng.random(n) * 100, 1),
        "dist": rng.integers(0, 10**9, size=int(dm.sum())),
        "code": rng.integers(-100, 100, n, dtype=np.int32),
    }
    offs = np.concatenate([[0], np.cumsum([len(t) for t in tags])])
    data = np.frombuffer(b"".join(tags), dtype=np.uint8)
    port = dict(vals, tag=ByteArrayColumn(offs, data))
    jax = dict(vals, tag=JaxByteArrayColumn(offs, data))
    return port, jax, {"dist": dm}


def _write_both(codec, n=15_000, seed=21, schema=SCHEMA, **kw):
    """The same row group written by both writers; returns
    ``(port file, JAX file, port stats, JAX stats)``."""
    port_cols, jax_cols, masks = _columns(n, seed) if schema is SCHEMA \
        else kw.pop("cols")
    buf = io.BytesIO()
    with collect_stats() as st:
        w = FileWriter(buf, schema, codec=C[codec], **kw)
        w.write_columns(port_cols, masks=masks)
        w.close()
    jbuf = io.BytesIO()
    jkw = dict(kw)
    if "column_encodings" in jkw:
        from tpuparquet.format.metadata import Encoding as JaxEncoding

        jkw["column_encodings"] = {c: JaxEncoding(int(e)) for c, e in
                                   jkw["column_encodings"].items()}
    with jax_collect_stats() as jst:
        w = JaxFileWriter(jbuf, schema, codec=_jax(C[codec]), **jkw)
        w.write_columns(jax_cols, masks=masks)
        w.close()
    return buf.getvalue(), jbuf.getvalue(), st, jst


@pytest.mark.parametrize("threads", [1, 4])
@pytest.mark.parametrize("allow_dict", [True, False], ids=["dict", "plain"])
@pytest.mark.parametrize("v2", [False, True], ids=["v1", "v2"])
@pytest.mark.parametrize("codec", CODECS + ("SNAPPY",))
def test_writer_chunks_as_jax(codec, v2, allow_dict, threads):
    """Each column chunk equals the JAX writer's byte for byte; 75,000
    values, so ``encode_threads=4`` takes the pool.  The PLAIN ``tag``
    chunk carries the string min/max, as the JAX writer's does."""
    ours, theirs, st, jst = _write_both(
        codec, data_page_v2=v2, allow_dict=allow_dict,
        encode_threads=threads)
    assert _chunks(ours, FileReader) == _chunks(theirs, JaxFileReader)
    assert st.codec_split_blocks == jst.codec_split_blocks == 0
    got = read_row_groups_device(FileReader(ours), device="cpu")
    assert_matches_oracle(dict(got), ours, f"{codec} v2={v2}")


@pytest.mark.parametrize("codec", CODECS)
def test_pool_and_serial_files_equal(codec):
    one, _, st1, _ = _write_both(codec, encode_threads=1)
    four, _, st4, _ = _write_both(codec, encode_threads=4)
    assert one == four
    assert st1 == st4


@pytest.mark.parametrize("leg", ["native", "fallback"])
@pytest.mark.parametrize("v2", [False, True], ids=["v1", "v2"])
@pytest.mark.parametrize("codec", ["GZIP", "ZSTD"])
def test_split_page_file_as_jax(codec, v2, leg, monkeypatch):
    """One column, one PLAIN page of 480 KB: at 4 workers the serial path
    splits it into 64 KiB blocks (not under ``TPQ_NATIVE_CODECS=0``), and
    the chunk, the counters and the read equal the JAX package's."""
    monkeypatch.setenv("TPQ_COMPRESS_BLOCK_KB", "64")
    monkeypatch.setenv("TPQ_NATIVE_CODECS", "1" if leg == "native" else "0")
    n = 60_000
    v = np.random.default_rng(3).integers(0, 1 << 20, n).cumsum()
    schema = "message m { required int64 v; }"
    cols = ({"v": v}, {"v": v}, None)
    ours, theirs, st, jst = _write_both(
        codec, schema=schema, cols=cols, data_page_v2=v2, allow_dict=False,
        encode_threads=4)
    assert _chunks(ours, FileReader) == _chunks(theirs, JaxFileReader)
    blocks = 8 if leg == "native" else 0
    assert st.codec_split_blocks == jst.codec_split_blocks == blocks
    got, rst, rjst = read_both(ours, f"{codec} split")
    assert_matches_oracle(got, ours, f"{codec} split")
    np.testing.assert_array_equal(got[0]["v"].to_numpy()[0], v)
    frames = blocks if codec == "ZSTD" else 0
    assert rst.codec_split_frames == rjst.codec_split_frames == frames
    assert rst.pages_device_delta_lanes == 1


@pytest.mark.parametrize("codec", CODECS)
def test_device_values_files_as_jax(codec):
    """``DeviceValues`` columns (the plain versions, on the CPU) at 4
    encode workers: the file equals the numpy file and, chunk for chunk,
    the JAX writer's ``DeviceValues`` file."""
    rng = np.random.default_rng(8)
    n = 14_000
    vals = {"ts": 1_700_000_000_000 + rng.integers(0, 60_000, n).cumsum(),
            "fare": rng.random(n) * 100,
            "score": rng.random(n).astype(np.float32),
            "code": rng.integers(-100, 100, n, dtype=np.int32),
            "small": rng.integers(0, 9, n).astype(np.int64)}
    schema = """message m { required int64 ts; required double fare;
        required float score; required int32 code; required int64 small; }"""
    for threads in (1, 4):
        _same_as_jax(schema, vals, codec=C[codec], encode_threads=threads,
                     column_encodings={"ts": Encoding.DELTA_BINARY_PACKED,
                                       "score": Encoding.BYTE_STREAM_SPLIT})


def test_write_threads_env(monkeypatch):
    from tpuparquet_torch.io import writer

    monkeypatch.setenv("TPQ_WRITE_THREADS", "3")
    assert writer._write_threads() == 3
    monkeypatch.setenv("TPQ_WRITE_THREADS", "0")
    assert writer._write_threads() == 1
    monkeypatch.setenv("TPQ_WRITE_THREADS", "junk")
    assert writer._write_threads() >= 1
    assert FileWriter(io.BytesIO(), SCHEMA, encode_threads=0)\
        .encode_threads == 1


# ----------------------------------------------------------------------
# files: pyarrow's, read by both packages
# ----------------------------------------------------------------------

def _pyarrow_table(n: int = 3000) -> pa.Table:
    rng = np.random.default_rng(77)
    null = rng.random(n) < 0.1
    words = np.array(["north", "south", "east", "west"])
    return pa.table({
        "i32": pa.array(rng.integers(-1000, 1000, n, dtype=np.int32)),
        "i64n": pa.array(rng.integers(-2**40, 2**40, n), mask=null),
        "ts": pa.array(1_700_000_000 + rng.integers(0, 50, n).cumsum()),
        "f64": pa.array(rng.random(n)),
        "s": pa.array(words[rng.integers(0, 4, n)]),
        "u": pa.array([f"id-{i}-{rng.integers(1e6)}" for i in range(n)]),
        "b": pa.array(rng.random(n) < 0.5),
    })


@pytest.mark.parametrize("dict_on", [True, False], ids=["dict", "plain"])
@pytest.mark.parametrize("version", ["1.0", "2.0"])
@pytest.mark.parametrize("codec", ["gzip", "zstd", "lz4"])
def test_pyarrow_files_as_jax(codec, version, dict_on):
    table = _pyarrow_table()
    buf = io.BytesIO()
    pq.write_table(table, buf, compression=codec, use_dictionary=dict_on,
                   data_page_version=version, data_page_size=4096)
    blob = buf.getvalue()
    want = {"gzip": C.GZIP, "zstd": C.ZSTD, "lz4": C.LZ4_RAW}[codec]
    assert FileReader(blob).meta.row_groups[0].columns[0].meta_data.codec \
        == want
    where = f"pyarrow {codec} v{version} dict={dict_on}"
    ours, _, _ = read_both(blob, where)
    assert_matches_oracle(ours, blob, where)
    one = read_row_group_device(FileReader(blob), 0, device="cpu")
    for name, col in one.items():
        a, b = col.padded_buffers(), ours[0][name].padded_buffers()
        assert a.keys() == b.keys()
        for k in a:
            np.testing.assert_array_equal(a[k], b[k])
        vals = col.to_numpy()[0]
        ref = table.column(name).to_numpy(zero_copy_only=False)
        valid = ~np.asarray(table.column(name).is_null())
        if hasattr(vals, "offsets"):
            assert vals.to_list() == [x.encode() for x in ref[valid]]
        else:
            np.testing.assert_array_equal(vals.astype(ref.dtype),
                                          ref[valid])


@pytest.mark.parametrize("codec", CODECS)
def test_plain_int_pages_take_the_transports_as_jax(codec):
    """A PLAIN int page of any codec takes byte planes or delta lanes
    where the JAX package's does (only the snappy tokens need SNAPPY)."""
    rng = np.random.default_rng(4)
    n = 40_000
    schema = "message m { required int64 ts; required int32 w; }"
    cols = {"ts": 1_700_000_000_000 + rng.integers(0, 1000, n).cumsum(),
            "w": rng.integers(0, 200, n, dtype=np.int32)}
    blob = _build(schema, cols, codec=C[codec], allow_dict=False)
    ours, st, jst = read_both(blob, codec)
    assert {k: getattr(st, k) for k in COUNTERS} == \
        {k: getattr(jst, k) for k in COUNTERS}
    assert (st.pages_device_delta_lanes + st.pages_device_planes,
            st.pages_device_snappy) == (2, 0)
    for name, v in cols.items():
        np.testing.assert_array_equal(ours[0][name].to_numpy()[0], v)


def test_sharded_scan_over_zstd_as_jax(monkeypatch):
    monkeypatch.setenv("TPQ_COMPRESS_BLOCK_KB", "64")
    rng = np.random.default_rng(9)
    blobs = []
    for s in range(2):
        buf = io.BytesIO()
        w = JaxFileWriter(buf, "message m { required int64 a; "
                          "optional int32 b; }", codec=JaxCodec.ZSTD)
        for _ in range(2):
            m = rng.random(700) > 0.1
            w.write_columns({"a": rng.integers(-2**40, 2**40, 700),
                             "b": rng.integers(0, 9, int(m.sum()),
                                               dtype=np.int32)},
                            masks={"b": m})
        w.close()
        blobs.append(buf.getvalue())
    jm, pm, theirs, ours = _scans(blobs, 8, None)
    for path in ("a", "b"):
        want, got = _gather_both("gather_column", jm, pm, theirs, ours, path)
        _same(got[0], want[0])
        np.testing.assert_array_equal(got[1], want[1])


# ----------------------------------------------------------------------
# launch counters under threads
# ----------------------------------------------------------------------

def test_launch_counter_loses_no_count_across_threads():
    def wrapper():
        pass

    wrapper.launches = 0
    per, n_threads = 20_000, 8
    start = threading.Barrier(n_threads)

    def bump():
        start.wait(timeout=30)
        for _ in range(per):
            _lib.count_launch(wrapper)

    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=bump) for _ in range(n_threads)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
        assert not any(t.is_alive() for t in threads)
    finally:
        sys.setswitchinterval(old)
    assert wrapper.launches == per * n_threads


def test_every_wrapper_counts_through_the_lock():
    """No kernel wrapper bumps its count outside ``count_launch``."""
    root = Path(__file__).resolve().parents[1] / "tpuparquet_torch"
    bare = [p.name for p in (root / "kernels").glob("*.py")
            if ".launches += 1" in p.read_text() and p.name != "_lib.py"]
    assert bare == []
    assert sum(p.read_text().count("count_launch(")
               for p in (root / "kernels").glob("*.py")
               if p.name != "_lib.py") == 22


def test_gzip_stdlib_and_native_write_the_same_bytes():
    d = PAYLOADS["runs"]
    nat = compress.compress_block(C.GZIP, d)
    co = zlib.compressobj(wbits=31)
    assert nat == co.compress(d) + co.flush()


# ----------------------------------------------------------------------
# the codec registry
# ----------------------------------------------------------------------

class _Rot13(compress.BlockCompressor):
    """A user's codec: every byte shifted by 13."""

    def compress_block(self, b):
        return bytes((x + 13) % 256 for x in b)

    def decompress_block(self, b, n):
        return bytes((x - 13) % 256 for x in b)


class _JaxRot13(jax_compress.BlockCompressor):
    compress_block = _Rot13.compress_block
    decompress_block = _Rot13.decompress_block


@pytest.fixture()
def user_codec():
    """Registers ``_Rot13`` on a codec in both packages for the test and
    puts back what each registry held."""
    saved = []

    def register(codec):
        for mod, cls, c in ((compress, _Rot13, C[codec]),
                            (jax_compress, _JaxRot13, JaxCodec[codec])):
            with mod._registry_lock:
                saved.append((mod, int(c), mod._registry.get(int(c))))
            mod.register_block_compressor(c, cls())

    yield register
    for mod, key, old in reversed(saved):
        with mod._registry_lock:
            if old is None:
                mod._registry.pop(key, None)
            else:
                mod._registry[key] = old


def test_builtins_registered_as_jax():
    assert compress.registered_codecs() == [
        C(int(c)) for c in jax_compress.registered_codecs()]
    assert compress.builtin_uncompressed_registered() is \
        jax_compress.builtin_uncompressed_registered() is True
    for codec in ("UNCOMPRESSED", "SNAPPY", "GZIP", "ZSTD", "LZ4_RAW"):
        assert isinstance(compress.get_block_compressor(C[codec]),
                          compress.BlockCompressor)


@pytest.mark.parametrize("codec", ["LZO", "BROTLI", "LZ4"])
def test_unregistered_codec_raises_as_jax(codec):
    for mod, c in ((compress, C[codec]), (jax_compress, JaxCodec[codec])):
        with pytest.raises(mod.CompressionError,
                           match=f"{codec} is not registered"):
            mod.get_block_compressor(c)


@pytest.mark.parametrize("name", list(PAYLOADS))
def test_builtin_slots_code_as_the_module(name):
    """A built-in slot's compressor writes and reads this module's
    bytes."""
    d = PAYLOADS[name]
    for codec in ("UNCOMPRESSED", "SNAPPY", "GZIP", "ZSTD", "LZ4_RAW"):
        slot = compress.get_block_compressor(C[codec])
        blob = slot.compress_block(d)
        assert blob == compress.compress_block(C[codec], d)
        assert slot.decompress_block(blob, len(d)) == d


@pytest.mark.parametrize("codec", ["LZ4", "BROTLI", "SNAPPY"])
def test_user_compressor_as_jax(codec, user_codec):
    """A user's compressor on a codec id, built-in or not: both
    directions go through it in both packages, the same bytes; the
    native page path gives way (no page context)."""
    user_codec(codec)
    d = PAYLOADS["text"]
    ours = compress.compress_block(C[codec], d)
    assert ours == bytes(jax_compress.compress_block(JaxCodec[codec], d))
    assert compress.decompress_block(C[codec], ours, len(d)).tobytes() == d
    assert C[codec] in compress.registered_codecs()
    assert compress.page_codec_settings(C[codec]) is None
    assert jax_compress.page_codec_settings(JaxCodec[codec]) is None
    with pytest.raises(compress.CompressionError, match="decompressed size"):
        compress.decompress_block(C[codec], ours, len(d) + 1)


def test_user_compressor_writes_and_reads_files_as_jax(user_codec):
    """A file written through a user's SNAPPY compressor: both writers
    write the same bytes, and both packages read it back on the host."""
    user_codec("SNAPPY")
    ours, theirs, st, jst = _write_both("SNAPPY", n=3_000,
                                        created_by="tpuparquet_torch")
    assert ours == theirs
    assert st.pages_assembled_native == jst.pages_assembled_native == 0
    a = FileReader(ours).read_row_group_arrays(0)
    b = JaxFileReader(io.BytesIO(ours)).read_row_group_arrays(0)
    assert a.keys() == b.keys()
    for k in a:
        va, vb = a[k].values, b[k].values
        if hasattr(vb, "offsets"):
            np.testing.assert_array_equal(va.offsets, vb.offsets)
            np.testing.assert_array_equal(va.data, vb.data)
        else:
            np.testing.assert_array_equal(np.asarray(va), np.asarray(vb))


def test_uncompressed_slot_taken_by_a_user(user_codec):
    user_codec("UNCOMPRESSED")
    assert compress.builtin_uncompressed_registered() is \
        jax_compress.builtin_uncompressed_registered() is False
    ours, theirs, st, jst = _write_both("UNCOMPRESSED", n=3_000,
                                        created_by="tpuparquet_torch")
    assert ours == theirs and st.pages_assembled_native == 0
