"""Device encode: tpuparquet_torch's write-side kernels against the JAX
package, bit for bit.

Each class is the counterpart of the class of the same name in
``tests/test_encode_device.py``, with the same parameters and seeds: the
same numpy-made inputs go through the JAX function and the port's (on
the CPU, the kernels' plain versions) and the outputs are equal with a
tolerance of 0 — packed words, byte streams, delta pages, dictionaries
and indices, min/max scalars, and whole files: a file written from
``DeviceValues`` equals the port's file from the same numpy values byte
for byte, and each of its column chunks equals the JAX writer's
``DeviceValues`` chunk byte for byte (page headers, statistics and
bodies; the files differ in ``created_by`` and the JAX page index).
Beyond the counterparts: KE1 at every width 1-64, KE3's lanes against
``_delta_phase1_*``, KE4 at ranges 1, 7 and 2^16 with a negative low
bound, KE5 on NaN, infinities and signed zeros.
"""

import io
import sys
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpuparquet import CompressionCodec as JaxCodec
from tpuparquet import FileReader as JaxFileReader
from tpuparquet import FileWriter as JaxFileWriter
from tpuparquet.cpu.bitpack import pack
from tpuparquet.cpu.bss import encode_byte_stream_split
from tpuparquet.cpu.delta import decode_delta_binary_packed, \
    encode_delta_binary_packed
from tpuparquet.format.metadata import Encoding as JaxEncoding
from tpuparquet.kernels import encode as jax_encode
from tpuparquet_torch import DeviceValues, bss_encode_device, \
    delta_encode_device, pack_u32_device, pack_u64_device
from tpuparquet_torch.format.metadata import CompressionCodec, Encoding
from tpuparquet_torch.io.reader import FileReader
from tpuparquet_torch.io.writer import FileWriter
from tpuparquet_torch.kernels.device import read_row_group_device
from tpuparquet_torch.kernels.encode import bss_tile_rows, delta_phase1, \
    device_dict_build, dict_build, pack_bits
from tpuparquet_torch.stats import collect_stats

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
import chip_smoke  # noqa: E402

# KE3's edges on the card (chip_smoke.KE3_CASES): the 4 blocks of 128
# deltas a warp takes, a CTA's 32
_KE3_EDGES = [c for name in ("warp edges", "CTA edges")
              for c in chip_smoke.KE3_CASES[name][0]]


rng = np.random.default_rng(21)


def _t(a: np.ndarray) -> torch.Tensor:
    """A numpy array of 4-byte words as a CPU int32 tensor (same bits)."""
    a = np.ascontiguousarray(a).reshape(-1)
    return torch.from_numpy(a.view(np.int32).copy() if a.size
                            else np.zeros(0, np.int32))


def _u32(t: torch.Tensor) -> np.ndarray:
    return t.numpy().view(np.uint32)


def _dv(vals: np.ndarray) -> DeviceValues:
    return DeviceValues(_t(np.ascontiguousarray(vals).view("<u4")),
                        vals.dtype)


def _jdv(vals: np.ndarray):
    return jax_encode.DeviceValues(
        jnp.asarray(np.ascontiguousarray(vals).view("<u4")), vals.dtype)


class TestPackDevice:
    @pytest.mark.parametrize("width", list(range(1, 33)))
    @pytest.mark.parametrize("n", [1, 31, 32, 33, 777])
    def test_pack_u32_matches_cpu(self, width, n):
        vals = rng.integers(0, 1 << width, size=n, dtype=np.uint64)
        want = pack(vals, width)
        lo = vals.astype(np.uint32)
        got = _u32(pack_u32_device(_t(lo), width, n))
        ref = np.asarray(jax_encode.pack_u32_device(jnp.asarray(lo), width,
                                                    n))
        np.testing.assert_array_equal(got, ref)
        assert got.tobytes()[: len(want)] == want
        assert not any(got.tobytes()[len(want):])

    @pytest.mark.parametrize("width", [33, 40, 47, 56, 63, 64])
    @pytest.mark.parametrize("n", [1, 32, 33, 500])
    def test_pack_u64_matches_cpu(self, width, n):
        vals = rng.integers(0, 1 << min(width, 63), size=n, dtype=np.uint64)
        want = pack(vals, width)
        lo = (vals & 0xFFFFFFFF).astype(np.uint32)
        hi = (vals >> 32).astype(np.uint32)
        got = _u32(pack_u64_device(_t(lo), _t(hi), width, n))
        ref = np.asarray(jax_encode.pack_u64_device(
            jnp.asarray(lo), jnp.asarray(hi), width, n))
        np.testing.assert_array_equal(got, ref)
        assert got.tobytes()[: len(want)] == want

    def test_padding_never_leaks(self):
        """Values past count must not contaminate the stream."""
        vals = np.full(40, (1 << 7) - 1, dtype=np.uint32)
        got = _u32(pack_u32_device(_t(vals), 7, 3)).tobytes()
        want = pack(np.array([127, 127, 127], dtype=np.uint64), 7)
        assert got[: len(want)] == want
        assert not any(got[len(want):])

    @pytest.mark.parametrize("width", list(range(1, 65)))
    def test_pack_u64_every_width(self, width):
        """KE1's plain version at every width, a count no multiple of 32,
        over longer (padded) lanes whose tail must not leak, and bits
        above the width masked off, as the JAX function masks them."""
        r = np.random.default_rng(width)
        vals = r.integers(0, 2**63, size=800, dtype=np.uint64) * 2 + 1
        lo = (vals & 0xFFFFFFFF).astype(np.uint32)
        hi = (vals >> 32).astype(np.uint32)
        got = _u32(pack_u64_device(_t(lo), _t(hi), width, 777))
        ref = np.asarray(jax_encode.pack_u64_device(
            jnp.asarray(lo), jnp.asarray(hi), width, 777))
        np.testing.assert_array_equal(got, ref)
        masked = vals[:777] & np.uint64((1 << width) - 1 if width < 64
                                        else 2**64 - 1)
        want = pack(masked, width)
        assert got.tobytes()[: len(want)] == want


def _bss_cases():
    """Typed values (also against the host encoder), then raw lane words
    with k < 4 * lanes at counts 1-6 and one short of and one past KE2's
    tile of rows."""
    for dt, k, lanes in ((np.float32, 4, 1), (np.float64, 8, 2),
                         (np.int32, 4, 1), (np.int64, 8, 2)):
        yield pytest.param(dt, k, lanes, 500,
                           id=f"{np.dtype(dt).name}-{k}-{lanes}")
    for k, lanes in ((4, 2), (3, 1), (9, 3), (16, 4)):
        T = bss_tile_rows(lanes)
        for count in (1, 2, 3, 5, 6, T - 1, T + 1):
            yield pytest.param(None, k, lanes, count,
                               id=f"words-{k}-{lanes}-{count}")


class TestBssEncodeDevice:
    @pytest.mark.parametrize("dt,k,lanes,count", list(_bss_cases()))
    def test_matches_cpu(self, dt, k, lanes, count):
        if dt is None:
            flat = rng.integers(0, 2**32, size=count * lanes,
                                dtype=np.uint32)
        else:
            vals = (rng.random(count) * 1000).astype(dt)
            flat = np.ascontiguousarray(vals).view(np.uint32)
        got = bss_encode_device(_t(flat), count, k, lanes)
        assert got.dtype == torch.uint8
        ref = np.asarray(jax_encode.bss_encode_device(jnp.asarray(flat),
                                                      count, k, lanes))
        np.testing.assert_array_equal(got.numpy(), ref)
        if dt is not None:
            assert got.numpy().tobytes() == encode_byte_stream_split(vals)


class TestDeltaEncodeDevice:
    @pytest.mark.parametrize("vals", [
        np.array([], dtype=np.int64),
        np.array([7], dtype=np.int64),
        np.array([5, 5], dtype=np.int64),
        np.arange(129, dtype=np.int64) * -3,
        np.full(128, 42, dtype=np.int64),
        np.array([np.iinfo(np.int64).min, np.iinfo(np.int64).max, 0, -1, 1],
                 dtype=np.int64),
    ], ids=["empty", "one", "two", "129", "const128", "extremes"])
    def test_byte_identical(self, vals):
        want = encode_delta_binary_packed(vals)
        flat = vals.view(np.uint32) if vals.size else np.zeros(0, np.uint32)
        got = delta_encode_device(_t(flat), vals.size)
        assert got == want
        assert got == jax_encode.delta_encode_device(jnp.asarray(flat),
                                                     vals.size)
        dec, _ = decode_delta_binary_packed(got, np.int64)
        np.testing.assert_array_equal(dec, vals)

    def test_timestamps_and_wide(self):
        for vals in (
            1_700_000_000_000
            + rng.integers(0, 3_600_000, size=5000, dtype=np.int64).cumsum(),
            rng.integers(-(2**62), 2**62, size=3000, dtype=np.int64),
        ):
            want = encode_delta_binary_packed(vals)
            got = delta_encode_device(_t(vals.view(np.uint32)), vals.size)
            assert got == want
            assert got == jax_encode.delta_encode_device(
                jnp.asarray(vals.view(np.uint32)), vals.size)

    @pytest.mark.parametrize("vals", [
        np.array([], dtype=np.int32),
        np.array([-7], dtype=np.int32),
        np.arange(-300, 300, dtype=np.int32) * 1000,
        np.array([np.iinfo(np.int32).min, np.iinfo(np.int32).max, 0, -1],
                 dtype=np.int32),
    ], ids=["empty", "one", "ramp", "extremes"])
    def test_int32_byte_identical(self, vals):
        """The is32 path wraps deltas at 32 bits exactly like the host
        encoder (full-range int32 data must not emit 33-bit widths)."""
        want = encode_delta_binary_packed(vals, is32=True)
        flat = vals.view(np.uint32) if vals.size else np.zeros(0, np.uint32)
        got = delta_encode_device(_t(flat), vals.size, is32=True)
        assert got == want
        assert got == jax_encode.delta_encode_device(jnp.asarray(flat),
                                                     vals.size, is32=True)
        dec, _ = decode_delta_binary_packed(got, np.int32)
        np.testing.assert_array_equal(dec, vals)

    def test_int32_random(self):
        vals = rng.integers(np.iinfo(np.int32).min, np.iinfo(np.int32).max,
                            size=3000, dtype=np.int32)
        want = encode_delta_binary_packed(vals, is32=True)
        got = delta_encode_device(_t(vals.view(np.uint32)), vals.size,
                                  is32=True)
        assert got == want

    @pytest.mark.parametrize("is32", [False, True], ids=["i64", "i32"])
    @pytest.mark.parametrize("count", [2, 129, 1000, 5003] + _KE3_EDGES)
    def test_phase1_lanes_match_jax(self, count, is32):
        """KE3's outputs equal ``_delta_phase1_*`` lane for lane over the
        true blocks (the JAX shapes are bucket-padded), at extremes that
        wrap; also at the edges of the 4 blocks a warp of the kernel
        takes and of a CTA's 32."""
        _phase1_vs_jax(count, is32, offset=False)

    @pytest.mark.parametrize("is32", [False, True], ids=["i64", "i32"])
    @pytest.mark.parametrize(
        "count", chip_smoke.KE3_CASES["odd word offset"][0])
    def test_phase1_odd_word_offset_matches_jax(self, count, is32):
        """The same, on values that start one word into their buffer (a
        view, which the kernel loads as scalars)."""
        _phase1_vs_jax(count, is32, offset=True)


def _phase1_vs_jax(count: int, is32: bool, offset: bool) -> None:
    r = np.random.default_rng(count)
    dt = np.int32 if is32 else np.int64
    vals = r.integers(np.iinfo(dt).min, np.iinfo(dt).max, size=count,
                      dtype=dt, endpoint=True)
    vals[::7] = np.iinfo(dt).max
    flat = vals.view(np.uint32)
    lanes = 1 if is32 else 2
    nb = (count - 2) // 128 + 1
    padded = jax_encode._pad_flat(jnp.asarray(flat), lanes,
                                  jax_encode._bucket_blocks(count))
    want = (jax_encode._delta_phase1_i32 if is32
            else jax_encode._delta_phase1_i64)(padded, count)
    src = _t(np.concatenate([[5], flat, [6]]).astype(np.uint32))[
        1 : 1 + flat.size] if offset else _t(flat)
    got = delta_phase1(src, count, is32)
    sizes = ((nb, 4 * nb, 128 * nb) if is32 else
             (nb, nb, 4 * nb, 4 * nb, 128 * nb, 128 * nb))
    assert len(got) == len(want) == len(sizes)
    for g, w, size in zip(got, want, sizes):
        assert g.numel() == size
        np.testing.assert_array_equal(
            g.numpy().view(np.uint32),
            np.asarray(w)[:size].view(np.uint32))


def _build(schema, vals_by_col, masks=None, device=False, writer="port",
           **wkw):
    """A file of one row group: the port's writer (numpy or
    ``DeviceValues`` columns) or the JAX writer (``device``: its
    ``DeviceValues``)."""
    buf = io.BytesIO()
    if writer == "jax":
        wkw = dict(wkw)
        if "codec" in wkw:
            wkw["codec"] = JaxCodec(int(wkw["codec"]))
        if "column_encodings" in wkw:
            wkw["column_encodings"] = {
                c: JaxEncoding(int(e))
                for c, e in wkw["column_encodings"].items()}
        w = JaxFileWriter(buf, schema, **wkw)
        cols = {k: _jdv(v) if device else v for k, v in vals_by_col.items()}
    else:
        w = FileWriter(buf, schema, **wkw)
        cols = {k: _dv(v) if device else v for k, v in vals_by_col.items()}
    w.write_columns(cols, masks=masks)
    w.close()
    return buf.getvalue()


def _chunks(blob: bytes, reader) -> list:
    """Every column chunk's bytes (pages: headers, statistics, bodies)."""
    r = reader(io.BytesIO(blob))
    out = []
    for rg in r.meta.row_groups:
        for cc in rg.columns:
            cm = cc.meta_data
            start = cm.data_page_offset
            if cm.dictionary_page_offset is not None:
                start = min(start, cm.dictionary_page_offset)
            out.append(blob[start : start + cm.total_compressed_size])
    return out


def _same_as_jax(schema, vals, masks=None, **kw) -> bytes:
    """The port's DeviceValues file: byte-identical to its numpy file,
    and chunk for chunk to the JAX writer's DeviceValues file."""
    dev = _build(schema, vals, masks=masks, device=True, **kw)
    assert dev == _build(schema, vals, masks=masks, device=False, **kw)
    jax_blob = _build(schema, vals, masks=masks, device=True, writer="jax",
                      **kw)
    assert _chunks(dev, FileReader) == _chunks(jax_blob, JaxFileReader)
    return dev


class TestDeviceValuesWriter:
    """write_columns with DeviceValues: the produced FILE must be
    byte-identical to the host path (stats, pages, footer included)."""

    SCHEMA = """message m {
        required int64 ts;
        required double fare;
        optional int64 dist;
        required float score;
        required int32 code;
    }"""

    def _vals(self, n=4000):
        dm = rng.random(n) >= 0.2
        return {
            "ts": 1_700_000_000_000
            + rng.integers(0, 60_000, n).cumsum(),
            "fare": rng.random(n) * 100,
            "dist": rng.integers(0, 10**9, size=int(dm.sum())),
            "score": rng.random(n).astype(np.float32),
            "code": rng.integers(-100, 100, n, dtype=np.int32),
        }, {"dist": dm}

    @pytest.mark.parametrize("v2", [False, True], ids=["v1", "v2"])
    @pytest.mark.parametrize("codec", [CompressionCodec.UNCOMPRESSED,
                                       CompressionCodec.SNAPPY])
    def test_byte_identical_files(self, v2, codec):
        vals, masks = self._vals()
        kw = dict(codec=codec, data_page_v2=v2, allow_dict=False,
                  column_encodings={
                      "ts": Encoding.DELTA_BINARY_PACKED,
                      "fare": Encoding.BYTE_STREAM_SPLIT,
                      "code": Encoding.DELTA_BINARY_PACKED,
                  })
        with collect_stats() as st:
            _build(self.SCHEMA, vals, masks=masks, device=True, **kw)
        assert st.pages_device_encoded == 5
        _same_as_jax(self.SCHEMA, vals, masks=masks, **kw)

    @pytest.mark.parametrize("a64,f64", [
        (np.array([], np.int64), np.array([], np.float64)),
        (np.array([5], np.int64), np.array([np.nan], np.float64)),
        (np.array([np.iinfo(np.int64).min, np.iinfo(np.int64).max],
                  np.int64),
         np.array([np.inf, -np.inf], np.float64)),
    ], ids=["empty", "nan", "extremes"])
    def test_edge_stats(self, a64, f64):
        schema = "message m { required int64 a; required double f; }"
        _same_as_jax(schema, {"a": a64, "f": f64}, allow_dict=False,
                     column_encodings={"a": Encoding.DELTA_BINARY_PACKED})

    def test_float32_nan_stats(self):
        schema = "message m { required float f; }"
        for f32 in (np.array([np.nan, 2.5, -1.0], np.float32),
                    np.array([np.nan, np.nan], np.float32),
                    np.array([np.inf, -np.inf, 0.0], np.float32)):
            _same_as_jax(schema, {"f": f32}, allow_dict=False)

    def test_unsigned_stat_order(self):
        schema = "message m { required int64 u (INT(64, false)); }"
        uv = np.array([1, -1, 5], np.int64)  # -1 == u64 max
        _same_as_jax(schema, {"u": uv}, allow_dict=False)

    def test_readback(self):
        vals, masks = self._vals(1000)
        blob = _build(self.SCHEMA, vals, masks=masks, device=True,
                      codec=CompressionCodec.SNAPPY, allow_dict=False,
                      column_encodings={"ts": Encoding.DELTA_BINARY_PACKED})
        cols = read_row_group_device(FileReader(blob), 0, device="cpu")
        np.testing.assert_array_equal(cols["ts"].to_numpy()[0], vals["ts"])
        np.testing.assert_array_equal(cols["dist"].to_numpy()[0],
                                      vals["dist"])
        np.testing.assert_array_equal(
            np.asarray(JaxFileReader(io.BytesIO(blob))
                       .read_row_group_arrays(0)["ts"].values), vals["ts"])

    def test_device_values_rejects_dtype_mismatch(self):
        schema = "message m { required int32 a; }"
        w = FileWriter(io.BytesIO(), schema)
        dv = DeviceValues(torch.zeros(8, dtype=torch.int32), np.int64)
        with pytest.raises(TypeError, match="DeviceValues"):
            w.write_columns({"a": dv})
        with pytest.raises(TypeError, match="DeviceValues supports"):
            DeviceValues(torch.zeros(8, dtype=torch.int32), np.int16)
        with pytest.raises(TypeError, match="1-D int32"):
            DeviceValues(torch.zeros(8, dtype=torch.int64), np.int64)
        with pytest.raises(ValueError, match="not a multiple of 2"):
            DeviceValues(torch.zeros(7, dtype=torch.int32), np.int64)

    @pytest.mark.parametrize("f", [np.array([0.0, -0.0]),
                                   np.array([-0.0, 0.0, 2.0, -1.0])],
                             ids=["pos_first", "neg_first"])
    def test_signed_zero_stats(self, f):
        """-0.0 and +0.0 compare equal, but their statistic bytes differ.
        The device path orders them as XLA does (minimum -0.0, maximum
        +0.0, whatever their order), as ``jnp.nanmin``/``jnp.nanmax``; the
        host writer keeps numpy's ``min()``/``max()``, which depends on
        the order.  The port matches the JAX writer on each path."""
        if f.size > 2:
            f = f[:2]
        mn, mx = _dv(f).min_max()
        assert np.signbit(mn) and not np.signbit(mx)
        jmn, jmx = jnp.nanmin(jnp.asarray(f)), jnp.nanmax(jnp.asarray(f))
        assert (np.signbit(np.asarray(jmn)), np.signbit(np.asarray(jmx))) \
            == (True, False)
        schema = "message m { required double f; }"
        blobs = {(w, d): _build(schema, {"f": f}, device=d, writer=w,
                                allow_dict=False)
                 for w in ("port", "jax") for d in (False, True)}
        for d in (False, True):
            assert _chunks(blobs["port", d], FileReader) == \
                _chunks(blobs["jax", d], JaxFileReader)
        st = FileReader(blobs["port", True]).meta.row_groups[0].columns[0] \
            .meta_data.statistics
        assert (st.min_value, st.max_value) == (np.float64(-0.0).tobytes(),
                                                np.float64(0.0).tobytes())
        host = FileReader(blobs["port", False]).meta.row_groups[0] \
            .columns[0].meta_data.statistics
        assert (host.min_value, host.max_value) == (f.min().tobytes(),
                                                    f.max().tobytes())


class TestDeviceFullCircle:
    """The data loop: file -> device decode -> compute on the device ->
    device encode -> file, with no raw value bytes crossing to the host
    between the two files (only wire bytes and statistics).
    ``DeviceColumn.data`` is the DeviceValues lane layout."""

    def test_read_compute_write(self):
        rng_ = np.random.default_rng(33)
        n = 3000
        base = rng_.integers(0, 10**6, size=n)
        buf = io.BytesIO()
        w = FileWriter(buf, "message m { required int64 v; }")
        w.write_columns({"v": base})
        w.close()

        col = read_row_group_device(FileReader(buf.getvalue()), 0,
                                    device="cpu")["v"]
        # compute on the lane words: v * 2 in 64-bit lane arithmetic
        lanes2 = col.data.reshape(-1, 2).to(torch.int64) & 0xFFFFFFFF
        lo = (lanes2[:, 0] << 1) & 0xFFFFFFFF
        hi = ((lanes2[:, 1] << 1) | (lanes2[:, 0] >> 31)) & 0xFFFFFFFF
        doubled = torch.stack([lo, hi], dim=1).reshape(-1)
        doubled = torch.where(doubled >= 1 << 31, doubled - (1 << 32),
                              doubled).to(torch.int32)

        out = io.BytesIO()
        w2 = FileWriter(out, "message m { required int64 v; }",
                        column_encodings={"v": Encoding.DELTA_BINARY_PACKED},
                        allow_dict=False)
        with collect_stats() as st:
            w2.write_columns({"v": DeviceValues(doubled, np.int64)})
            w2.close()
        assert st.pages_device_encoded > 0
        got = read_row_group_device(FileReader(out.getvalue()), 0,
                                    device="cpu")["v"].to_numpy()[0]
        np.testing.assert_array_equal(got, base * 2)

    def test_as_values_bridge(self):
        """DeviceColumn.as_values: decode -> write with zero layout
        plumbing; output byte-identical to writing the numpy values, and
        chunk for chunk to the JAX package's same loop."""
        from tpuparquet.kernels.device import read_row_group_device as \
            jax_read_row_group_device

        rng_ = np.random.default_rng(44)
        vals = rng_.integers(-(2**50), 2**50, size=2000)
        buf = io.BytesIO()
        w = FileWriter(buf, "message m { required int64 v; }")
        w.write_columns({"v": vals})
        w.close()
        col = read_row_group_device(FileReader(buf.getvalue()), 0,
                                    device="cpu")["v"]
        jcol = jax_read_row_group_device(
            JaxFileReader(io.BytesIO(buf.getvalue())), 0)["v"]

        def write(v, cls=FileWriter, enc=Encoding):
            o = io.BytesIO()
            ww = cls(o, "message m { required int64 v; }",
                     column_encodings={"v": enc.DELTA_BINARY_PACKED},
                     allow_dict=False)
            ww.write_columns({"v": v})
            ww.close()
            return o.getvalue()

        dv = col.as_values()
        assert dv.count == 2000 and dv.flat.numel() == 4000
        assert write(dv) == write(vals)
        assert _chunks(write(dv), FileReader) == _chunks(
            write(jcol.as_values(), JaxFileWriter, JaxEncoding),
            JaxFileReader)

    @pytest.mark.parametrize("schema,row", [
        ("message m { required binary s; }", {"s": b"x"}),
        ("message m { required boolean s; }", {"s": True}),
        ("message m { required int96 s; }",
         {"s": np.array([[1, 2, 3]], np.uint32)}),
        ("message m { required fixed_len_byte_array(4) s; }",
         {"s": np.array([[1, 2, 3, 4]], np.uint8)}),
    ], ids=["bytes", "boolean", "int96", "flba"])
    def test_as_values_rejects_bytes(self, schema, row):
        from tpuparquet.kernels.device import read_row_group_device as \
            jax_read_row_group_device

        buf = io.BytesIO()
        w = JaxFileWriter(buf, schema)
        if isinstance(row["s"], np.ndarray):
            w.write_columns(row)
        else:
            w.add_data(row)
        w.close()
        col = read_row_group_device(FileReader(buf.getvalue()), 0,
                                    device="cpu")["s"]
        with pytest.raises(TypeError, match="as_values") as ours:
            col.as_values()
        jcol = jax_read_row_group_device(
            JaxFileReader(io.BytesIO(buf.getvalue())), 0)["s"]
        with pytest.raises(TypeError) as theirs:
            jcol.as_values()
        if "as_values" in str(theirs.value):
            assert str(ours.value) == str(theirs.value)


class TestDeviceDictEncode:
    """Device-side dictionary interning: small-range integer
    DeviceValues columns dict-encode without pulling the unpacked
    column, byte-identical to the host path."""

    def _write(self, schema, col, writer="port"):
        buf = io.BytesIO()
        if writer == "jax":
            w = JaxFileWriter(buf, schema, codec=JaxCodec.SNAPPY)
        else:
            w = FileWriter(buf, schema, codec=CompressionCodec.SNAPPY)
        w.write_columns({"v": col})
        w.close()
        return buf.getvalue()

    def _encodings(self, blob):
        return [Encoding(e) for e in FileReader(blob).meta.row_groups[0]
                .columns[0].meta_data.encodings]

    def _both(self, schema, vals) -> bytes:
        """The port's DeviceValues file: its numpy file's bytes, the JAX
        DeviceValues file's chunks."""
        dev = self._write(schema, _dv(vals))
        assert dev == self._write(schema, vals)
        assert _chunks(dev, FileReader) == _chunks(
            self._write(schema, _jdv(vals), "jax"), JaxFileReader)
        return dev

    def test_int64_dicty_byte_identical(self):
        rng = np.random.default_rng(5)
        vals = (np.int64(1) << 40) + rng.integers(0, 50, 60_000)
        dev = self._both("message m { required int64 v (INT(64,true)); }",
                         vals)
        assert Encoding.RLE_DICTIONARY in self._encodings(dev)
        np.testing.assert_array_equal(read_row_group_device(
            FileReader(dev), 0, device="cpu")["v"].to_numpy()[0], vals)

    def test_int32_dicty_byte_identical(self):
        rng = np.random.default_rng(6)
        vals = rng.integers(-3, 4, 50_000).astype(np.int32)
        self._both("message m { required int32 v; }", vals)

    def test_wide_range_stays_plain(self):
        rng = np.random.default_rng(7)
        vals = rng.integers(-(2**60), 2**60, 20_000)
        dev = self._both("message m { required int64 v (INT(64,true)); }",
                         vals)
        assert Encoding.RLE_DICTIONARY not in self._encodings(dev)

    def test_floats_never_dict(self):
        rng = np.random.default_rng(8)
        vals = np.repeat(rng.random(10), 2000)
        dev = self._write("message m { required double v; }", _dv(vals))
        assert Encoding.RLE_DICTIONARY not in self._encodings(dev)
        assert _chunks(dev, FileReader) == _chunks(self._write(
            "message m { required double v; }", _jdv(vals), "jax"),
            JaxFileReader)

    def test_wide_range_few_distinct_known_divergence(self):
        # KNOWN divergence, kept from the JAX package: the host
        # interner's np.unique path still dict-encodes wide-range
        # few-distinct columns; the device intern cannot and stays
        # non-dict
        vals = np.where(np.arange(20_000) % 2 == 0,
                        -(2**60), 2**60).astype(np.int64)
        schema = "message m { required int64 v (INT(64,true)); }"
        host = self._write(schema, vals)
        dev = self._write(schema, _dv(vals))
        assert Encoding.RLE_DICTIONARY in self._encodings(host)
        assert Encoding.RLE_DICTIONARY not in self._encodings(dev)
        assert _chunks(dev, FileReader) == _chunks(
            self._write(schema, _jdv(vals), "jax"), JaxFileReader)
        np.testing.assert_array_equal(read_row_group_device(
            FileReader(dev), 0, device="cpu")["v"].to_numpy()[0], vals)

    def test_hbm_resident_round_trip_byte_identical(self):
        # file -> device decode -> as_values -> device dictionary
        # re-encode: the column never leaves the device unpacked and the
        # output file is byte-identical to the original
        rng = np.random.default_rng(9)
        vals = (np.int64(1) << 40) + rng.integers(0, 50, 40_000)
        schema = "message m { required int64 v (INT(64,true)); }"
        b1 = self._write(schema, vals)
        col = read_row_group_device(FileReader(b1), 0, device="cpu")["v"]
        assert self._write(schema, col.as_values()) == b1

    def test_unsigned_small_range_byte_identical(self):
        # unsigned logical values above the sign boundary, stored two's
        # complement: the intern's signed-range math still engages (both
        # bounds negative, small span) and stats stay unsigned-ordered
        import struct

        rng = np.random.default_rng(11)
        logical = (np.uint64(2**63)
                   + rng.integers(0, 40, 30_000).astype(np.uint64))
        stored = logical.view(np.int64)
        dev = self._both("message m { required int64 v (INT(64,false)); }",
                         stored)
        st = FileReader(dev).meta.row_groups[0].columns[0] \
            .meta_data.statistics
        assert struct.unpack("<Q", st.min_value)[0] == int(logical.min())
        assert struct.unpack("<Q", st.max_value)[0] == int(logical.max())
        assert st.min is None and st.max is None

    @pytest.mark.parametrize("rng_size,lo,layout", [
        pytest.param(1, 0, None, id="1-0"),
        pytest.param(7, -3, None, id="7--3"),
        pytest.param(1 << 16, -(1 << 40), None, id="65536--1099511627776"),
        pytest.param(1 << 16, 5, None, id="65536-5"),
        pytest.param(None, None, "hot value", id="hot-7"),
        pytest.param(None, None, "hot value, range 2^16", id="hot-65536"),
        pytest.param(None, None, "range R - 1", id="small-range-1"),
        pytest.param(None, None, "range R", id="small-range"),
        pytest.param(None, None, "range R + 1", id="small-range+1"),
        pytest.param(None, None, "warp and block edges", id="edges-64"),
        pytest.param(None, None, "warp and block edges, range 8192",
                     id="edges-8192")])
    @pytest.mark.parametrize("dt", [np.int32, np.int64])
    def test_dict_build_matches_jax(self, rng_size, lo, layout, dt):
        """KE4's plain version: dictionary, size and indices equal
        ``device_dict_build``'s at ranges 1, 7 and 2^16, with a negative
        low bound; and on the card's edges (``chip_smoke.DICT_CASES``):
        one hot value, ranges around the kernel's shared-memory threshold
        (``encode.dict_small_range``, R) and first occurrences at the last
        index of a warp and of a block."""
        r = np.random.default_rng(rng_size if layout is None
                                  else len(layout))
        if layout is None:
            if dt == np.int32 and lo < -(1 << 31):
                lo = -(1 << 20)
            n = 3 * rng_size + 1000
            vals = (lo + r.integers(0, rng_size, n)).astype(dt)
            vals[r.integers(0, n)] = lo + rng_size - 1  # the full range
            vals[r.integers(0, n)] = lo
        else:
            vals = chip_smoke.dict_values(r, layout, dt)
            n = vals.size
            lo = int(vals.min())
            rng_size = int(vals.max()) - lo + 1
        got, pull = device_dict_build(_dv(vals))
        want, jpull = jax_encode.device_dict_build(_jdv(vals))
        assert got.dtype == want.dtype
        np.testing.assert_array_equal(got, want)
        np.testing.assert_array_equal(pull(), jpull())
        order, dsize, idx = dict_build(_dv(vals).flat, vals.itemsize // 4, n,
                                       lo & 0xFFFFFFFF, rng_size)
        assert dsize == want.size == order.numel()
        np.testing.assert_array_equal(got[pull()], vals)


@pytest.mark.parametrize("vals,unsigned", [
    (np.array([np.nan, 2.5, -1.0], np.float32), False),
    (np.array([np.nan, np.nan], np.float32), False),
    (np.array([np.nan, np.nan]), False),
    (np.array([np.inf, -np.inf, 0.0], np.float32), False),
    (np.array([np.inf, np.nan, -np.inf]), False),
    (np.array([0.0, -0.0, 0.0]), False),
    (np.array([-0.0, 0.0], np.float32), False),
    (np.array([-0.0, -0.0]), False),
    (np.array([], np.float64), False),
    (np.array([], np.int32), False),
    (np.array([1, -1, 5], np.int64), False),
    (np.array([1, -1, 5], np.int64), True),
    (np.array([1, -1, 5], np.int32), True),
    (np.array([np.iinfo(np.int64).min, np.iinfo(np.int64).max], np.int64),
     True),
    (np.array([np.iinfo(np.int32).min, 0, np.iinfo(np.int32).max],
              np.int32), False),
], ids=lambda v: getattr(v, "dtype", v) if not isinstance(v, bool)
    else f"unsigned={v}")
def test_min_max_matches_jax(vals, unsigned):
    """KE5's plain version against ``DeviceValues.min_max`` of the JAX
    package: the same two scalars, of the same type, bit for bit (NaN,
    infinities, signed zeros, empty, unsigned order)."""
    got = _dv(vals).min_max(unsigned=unsigned)
    want = _jdv(vals).min_max(unsigned=unsigned)
    assert [type(x) for x in got] == [type(x) for x in want]
    if want[0] is not None:
        assert np.array(got).tobytes() == np.array(want).tobytes()


@pytest.mark.parametrize("case", list(chip_smoke.PACK_EDGE_CASES))
def test_pack_edge_cases_match_jax(case):
    """KE1's edge cases (chip_smoke.PACK_EDGE_CASES: widths 1, 31, 32, 33
    and 64, counts around a miniblock and past a warp's and a block's
    share, miniblock lists reversed, with repeats and over a source
    whose last lanes are missing, inputs shorter than the count) through
    the port's CPU path against the JAX package: the delta encoder's
    ``_pack_masked32``/``_pack_masked64`` on the lanes its gather
    ``alo[sel_dev]`` gives (lanes past the inputs 0), and without a list
    ``pack_u64_device`` (and ``pack_u32_device`` up to width 32)."""
    for w, lo, hi, count, sel in chip_smoke.pack_case(
            np.random.default_rng(15), case):
        got = _u32(pack_bits(_t(lo), None if hi is None else _t(hi), w,
                             count, sel=None if sel is None else _t(sel)))
        nb = (count + 31) // 32
        src = np.arange(32 * nb) if sel is None else \
            (sel[:nb, None].astype(np.int64) * 32 + np.arange(32)).reshape(-1)
        live = src < lo.size

        def gather(x):
            x = np.zeros(lo.size, np.uint32) if x is None else x
            return jnp.asarray(np.where(live, x[np.minimum(src, lo.size - 1)],
                                        0).astype(np.uint32))

        glo, ghi = gather(lo), gather(hi)
        if w <= 32:
            ref = jax_encode._pack_masked32(glo, count, w)
        else:
            ref = jax_encode._pack_masked64(glo, ghi, count, w)
        np.testing.assert_array_equal(got, np.asarray(ref))
        if sel is None:
            hi_j = jnp.asarray(np.zeros(lo.size, np.uint32) if hi is None
                               else hi)
            np.testing.assert_array_equal(got, np.asarray(
                jax_encode.pack_u64_device(jnp.asarray(lo), hi_j, w, count)))
            if w <= 32:
                np.testing.assert_array_equal(got, np.asarray(
                    jax_encode.pack_u32_device(jnp.asarray(lo), w, count)))


@pytest.mark.parametrize("case", list(chip_smoke.MINMAX_EDGE_CASES))
def test_min_max_edge_cases_match_jax(case):
    """KE5's edge cases (chip_smoke.MINMAX_EDGE_CASES: one value, a
    vector's values and one past, a block's round and one past, views 1
    and 2 words into their buffer, the extremes in the last block, NaN in
    the tail only, all NaN, calls back to back) through the port's CPU
    path against ``DeviceValues.min_max`` of the JAX package: the same
    two scalars, of the same type, bit for bit."""
    for buf, lead, v, unsigned in chip_smoke.minmax_case(
            np.random.default_rng(16), case):
        got = DeviceValues(_t(buf)[lead:], v.dtype).min_max(
            unsigned=unsigned)
        want = _jdv(v).min_max(unsigned=unsigned)
        assert [type(x) for x in got] == [type(x) for x in want]
        if want[0] is not None:
            assert np.array(got).tobytes() == np.array(want).tobytes()
