"""DELTA_BINARY_PACKED and BYTE_STREAM_SPLIT: tpuparquet_torch against the
JAX package.

The host side is held to the JAX package's output for output: the
encoder's bytes, ``scan_delta_structure``'s bookkeeping, the device plan
(``plan_delta_i32/_i64``: widths, words, starts, takes, ``n_vals``,
``start`` and ``n_take`` per width class, min_delta lanes, ``first`` and
``total``), the CPU decoders, and the C helpers (hybrid run scan, lane
statistics, hybrid encode, run-table expand and re-pack, the delta block
walk, segment gather and block emit) against the JAX package's native
ones on the same streams.  The plain versions of K11 (``scatter_deltas``)
and K12 (``bss_to_lanes``) and the rebuilds that use them
(``expand_delta_i32/_i64``) are held to the JAX functions bit for bit, and
a small sensor table (``chip_smoke.build_sensors`` at 2 x 20,000 rows) is
read by both packages: every buffer, the routing counters and
``bytes_staged`` agree.  Integer data throughout, so every comparison is
exact.
"""

import io
import re
import sys
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpuparquet import CompressionCodec as JaxCodec
from tpuparquet import Encoding as JaxEncoding
from tpuparquet import FileWriter as JaxFileWriter
from tpuparquet.cpu import bss as jax_bss
from tpuparquet.cpu import delta as jax_delta
from tpuparquet.cpu.hybrid import encode_hybrid as jax_encode_hybrid
from tpuparquet.kernels import decode as jax_decode
from tpuparquet.native import delta_native as jax_delta_native
from tpuparquet.native import hybrid_native as jax_hybrid_native
from tpuparquet.native import pack_native as jax_pack_native
from tpuparquet_torch.cpu import bss, delta
from tpuparquet_torch.cpu.hybrid import _scan_hybrid_py, encode_hybrid, \
    expand_scan
from tpuparquet_torch.io.reader import FileReader
from tpuparquet_torch.kernels import decode
from tpuparquet_torch.native import delta_native, hybrid_native, \
    pack_native

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
import chip_smoke  # noqa: E402
from test_torch_read import COUNTERS, _read_both  # noqa: E402


def _bursty(rng, n, scale=8.0, sigma=2.5, dtype=np.int64):
    """Timestamps with lognormal gaps: miniblock widths vary, so width
    classes scatter."""
    return (1_700_000_000_000_000
            + np.cumsum(rng.lognormal(scale, sigma, n).astype(np.int64))
            ).astype(dtype)


def _streams():
    """name -> (values, block_size, miniblocks)."""
    rng = np.random.default_rng(4)
    i32 = np.iinfo(np.int32)
    return {
        "constant (width 0)": (np.full(1000, 7, np.int64), 128, 4),
        "linear (width 0, min_delta)": (np.arange(999, dtype=np.int64) * 5
                                        - 40, 128, 4),
        "random int64 (widths 33-64)": (
            rng.integers(-2**63, 2**63 - 1, size=1500, dtype=np.int64),
            128, 4),
        "steps 2^40 (width 40-41)": (
            np.cumsum(rng.integers(0, 2**40, size=777)), 128, 4),
        "int32 wrap": (rng.integers(i32.min, i32.max, size=1234,
                                    dtype=np.int32), 128, 4),
        "bursty int64": (_bursty(rng, 5000), 128, 4),
        "bursty int32": (np.cumsum(rng.geometric(0.3, 4000)
                                   * (rng.random(4000) < 0.2) * 1000 + 1)
                         .astype(np.int32), 128, 4),
        "total 0": (np.zeros(0, np.int64), 128, 4),
        "total 1": (np.array([-5], np.int64), 128, 4),
        "total 2": (np.array([5, -300], np.int64), 128, 4),
        "block 256, 4 miniblocks": (_bursty(rng, 3001), 256, 4),
        "block 256, 8 miniblocks": (_bursty(rng, 3001), 256, 8),
        "block 256, 8 miniblocks, int32": (
            (_bursty(rng, 2049) % 2**31).astype(np.int32), 256, 8),
    }


STREAMS = _streams()


def _encoded(name):
    v, bs, nm = STREAMS[name]
    return v, delta.encode_delta_binary_packed(v, bs, nm)


@pytest.mark.parametrize("name", list(STREAMS))
def test_encoder_and_structure_match_jax(name):
    v, bs, nm = STREAMS[name]
    ours = delta.encode_delta_binary_packed(v, bs, nm)
    assert ours == jax_delta.encode_delta_binary_packed(v, bs, nm)
    a = delta.scan_delta_structure(ours)
    b = jax_delta.scan_delta_structure(ours)
    for f in ("block_size", "mb_size", "total", "first", "end_pos"):
        assert getattr(a, f) == getattr(b, f), f
    for f in ("md_blocks", "mb_w", "mb_pos", "mb_start"):
        np.testing.assert_array_equal(np.asarray(getattr(a, f)),
                                      np.asarray(getattr(b, f)), err_msg=f)
    ga, gb = list(a.grouped()), list(b.grouped())
    assert len(ga) == len(gb)
    for x, y in zip(ga, gb):
        assert (x[0], bool(x[1]), bool(x[5])) == (y[0], bool(y[1]),
                                                   bool(y[5]))
        for i in (2, 3, 4):
            np.testing.assert_array_equal(x[i], y[i])
    got, end = delta.decode_delta_binary_packed(ours, v.dtype)
    want, jend = jax_delta.decode_delta_binary_packed(ours, v.dtype)
    assert end == jend == len(ours)
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got, v)


def test_widths_from_max_matches_jax():
    m = np.array([0, 1, 2, 3, 255, 256, 2**32 - 1, 2**32, 2**63, 2**64 - 1],
                 dtype=np.uint64)
    np.testing.assert_array_equal(delta.widths_from_max(m),
                                  jax_delta.widths_from_max(m))


@pytest.mark.parametrize("bad", [b"\x80", b"\x81\x01\x04\x03",
                                 b"\x80\x01\x03\x05\x00",
                                 b"\x80\x01\x04\x80\x02\x00\x00\x01\x02"])
def test_malformed_stream_raises_as_jax(bad):
    """Truncated headers and payloads, and a miniblock count that does
    not divide the block, raise the JAX package's message."""
    with pytest.raises(ValueError) as jerr:
        jax_delta.scan_delta_structure(bad)
    with pytest.raises(ValueError, match=re.escape(str(jerr.value))):
        delta.scan_delta_structure(bad)


def test_miniblock_wider_than_int32_rejected():
    v = np.array([0, 2**40, 0], np.int64)
    data = delta.encode_delta_binary_packed(v)
    with pytest.raises(ValueError, match="width > 32"):
        decode.plan_delta_i32(data)
    decode.plan_delta_i64(data)


def _t(a):
    a = np.ascontiguousarray(a)
    return torch.from_numpy(a.view(np.int32).copy() if a.dtype.itemsize == 4
                            else a.astype(np.int32))


def _port_plan_tensors(plan):
    return decode.DeltaPlan(
        [(w, _t(words), None if st is None else _t(st),
          None if tk is None else _t(tk), nv, s0, nt)
         for w, words, st, tk, nv, s0, nt in plan.groups],
        _t(plan.md_lo), _t(plan.md_hi), plan.block_size, plan.first,
        plan.total)


@pytest.mark.parametrize("name", list(STREAMS))
def test_plan_and_expand_match_jax(name):
    """The plan field by field, then the rebuild (K1/K6, K11's plain
    version, K7's) against the JAX expansion of the JAX plan."""
    v, data = _encoded(name)
    i32 = v.dtype == np.int32
    ours = (decode.plan_delta_i32 if i32 else decode.plan_delta_i64)(data)
    theirs = (jax_decode.plan_delta_i32 if i32
              else jax_decode.plan_delta_i64)(data)
    assert (ours.block_size, ours.first, ours.total) == \
        (theirs.block_size, theirs.first, theirs.total)
    np.testing.assert_array_equal(ours.md_lo, theirs.md_lo)
    np.testing.assert_array_equal(ours.md_hi, theirs.md_hi)
    assert len(ours.groups) == len(theirs.groups)
    for g, h in zip(ours.groups, theirs.groups):
        assert (g[0], g[4], g[5], g[6]) == (h[0], h[4], h[5], h[6])
        np.testing.assert_array_equal(g[1], h[1])
        for i in (2, 3):
            assert (g[i] is None) == (h[i] is None)
            if g[i] is not None:
                assert g[i].dtype == h[i].dtype == np.int32
                np.testing.assert_array_equal(g[i], h[i])
    got = (decode.expand_delta_i32 if i32 else decode.expand_delta_i64)(
        _port_plan_tensors(ours)).numpy().view(np.uint32)
    want = np.asarray((jax_decode.expand_delta_i32 if i32
                       else jax_decode.expand_delta_i64)(theirs))
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got.view(v.dtype), v)


def test_bursty_streams_have_scattered_classes():
    """The cases above reach K11: bursty timestamps scatter their width
    classes, at block 128 and at block 256."""
    for name in ("bursty int64", "bursty int32", "block 256, 4 miniblocks",
                 "block 256, 8 miniblocks, int32"):
        v, data = _encoded(name)
        plan = (decode.plan_delta_i32 if v.dtype == np.int32
                else decode.plan_delta_i64)(data)
        assert any(g[2] is not None for g in plan.groups), name


@pytest.mark.parametrize("wide", [False, True])
def test_scatter_matches_jax_drop(wide):
    """K11's plain version against ``_scatter_grid`` and
    ``.at[].set(mode="drop")``: partial takes, targets past ``out_len``
    and zero takes, ``mb`` 32 and 64."""
    rng = np.random.default_rng(9 + wide)
    for k, mb, out_len in ((5, 32, 150), (7, 64, 300), (1, 32, 20)):
        starts = rng.integers(0, out_len + 40, size=k).astype(np.int32)
        takes = rng.integers(0, mb + 1, size=k).astype(np.int32)
        lo = rng.integers(0, 2**32, size=k * mb, dtype=np.uint32)
        hi = rng.integers(0, 2**32, size=k * mb, dtype=np.uint32)
        pos = jax_decode._scatter_grid(starts, takes, k * mb, out_len)
        want_lo = jnp.zeros(out_len, jnp.uint32).at[pos].set(lo, mode="drop")
        want_hi = jnp.zeros(out_len, jnp.uint32).at[pos].set(hi, mode="drop")
        dlo = torch.zeros(out_len, dtype=torch.int32)
        dhi = torch.zeros(out_len, dtype=torch.int32) if wide else None
        decode.scatter_deltas(_t(lo), _t(hi) if wide else None, _t(starts),
                              _t(takes), k * mb, dlo, dhi, out_len)
        np.testing.assert_array_equal(dlo.numpy().view(np.uint32),
                                      np.asarray(want_lo))
        if wide:
            np.testing.assert_array_equal(dhi.numpy().view(np.uint32),
                                          np.asarray(want_hi))


def test_scatter_checks_buffers():
    z = torch.zeros(64, dtype=torch.int32)
    s = torch.zeros(2, dtype=torch.int32)
    with pytest.raises(ValueError, match="go together"):
        decode.scatter_deltas(z, z, s, s, 64, z, None, 64)
    with pytest.raises(ValueError, match="do not fit"):
        decode.scatter_deltas(z[:10], None, s, s, 64, z, None, 64)
    with pytest.raises(ValueError, match="do not fit"):
        decode.scatter_deltas(z, None, s, s, 64, z, None, 65)


@pytest.mark.parametrize("dtype", [np.int32, np.float32, np.int64,
                                   np.float64])
def test_byte_stream_split_matches_jax(dtype):
    """The codec both ways, and K12's plain version against the JAX
    ``bss_to_lanes`` (k = 4 and 8; counts not a multiple of 32)."""
    rng = np.random.default_rng(3)
    k = np.dtype(dtype).itemsize
    lanes = k // 4
    for count in (0, 1, 31, 1000, 4097):
        v = rng.integers(0, 256, size=count * k, dtype=np.uint8).view(dtype)
        enc = bss.encode_byte_stream_split(v)
        assert enc == jax_bss.encode_byte_stream_split(v)
        got = bss.decode_byte_stream_split(enc + b"\x00", count, dtype)
        np.testing.assert_array_equal(
            got.view(np.uint8),
            jax_bss.decode_byte_stream_split(enc, count, dtype).view(
                np.uint8))
        np.testing.assert_array_equal(got.view(np.uint8), v.view(np.uint8))
        raw = np.frombuffer(enc + b"\x07" * 5, np.uint8)
        lanes_out = decode.bss_to_lanes(torch.from_numpy(raw.copy()), count,
                                        k, lanes)
        want = np.asarray(jax_decode.bss_to_lanes(jnp.asarray(raw), count,
                                                  k, lanes))
        np.testing.assert_array_equal(lanes_out.numpy().view(np.uint32),
                                      want)
        np.testing.assert_array_equal(lanes_out.numpy().view(np.uint8),
                                      v.view(np.uint8))
    with pytest.raises(ValueError, match="too short"):
        bss.decode_byte_stream_split(b"\x00" * 3, 1, dtype)


def test_bss_to_lanes_partial_lane_matches_jax():
    """``k`` below ``4 * lanes``: the missing bytes of the last word are
    zero, as the reference pads them."""
    raw = np.arange(6 * 37, dtype=np.uint8)
    got = decode.bss_to_lanes(torch.from_numpy(raw.copy()), 37, 6, 2)
    want = np.asarray(jax_decode.bss_to_lanes(jnp.asarray(raw), 37, 6, 2))
    np.testing.assert_array_equal(got.numpy().view(np.uint32), want)
    with pytest.raises(ValueError, match="do not fit"):
        decode.bss_to_lanes(torch.from_numpy(raw.copy()), 38, 6, 2)


@pytest.mark.parametrize("case", list(chip_smoke.BSS_EDGE_CASES))
def test_bss_to_lanes_edge_cases_match_jax(case):
    """K12's edge cases (chip_smoke.BSS_EDGE_CASES: every k from 1 to 16,
    counts around the kernel's tiles and at every residue mod 16, views
    1-13 bytes in, streams of exactly k * count bytes, rows of 1,024 to
    2,053 bytes) through the port's CPU path and the JAX package's
    bss_to_lanes."""
    for buf, lead, count, k, lanes in chip_smoke.bss_case(
            np.random.default_rng(24), case):
        ours = decode.bss_to_lanes(torch.from_numpy(buf)[lead:], count, k,
                                   lanes)
        theirs = jax_decode.bss_to_lanes(jnp.asarray(buf[lead:]), count, k,
                                         lanes)
        assert ours.shape == (count * lanes,)
        np.testing.assert_array_equal(ours.numpy().view(np.uint32),
                                      np.asarray(theirs))


# ----------------------------------------------------------------------
# the C helpers against the JAX package's native ones
# ----------------------------------------------------------------------

def _level_streams():
    rng = np.random.default_rng(12)
    out = []
    for w in (1, 2, 3, 5, 8, 13, 20, 31, 32):
        hi = (1 << w) - 1
        v = rng.integers(0, hi, size=20_000, endpoint=True, dtype=np.uint64)
        for _ in range(60):
            a = int(rng.integers(0, v.size))
            v[a : a + int(rng.integers(8, 400))] = rng.integers(0, hi + 1)
        out.append((w, v.astype(np.uint32)))
    out.append((1, (rng.random(9_999) < 0.97).astype(np.uint32)))
    return out


@pytest.mark.parametrize("case", range(10))
def test_hybrid_helpers_match_jax_native(case):
    """Encode, run scan (from byte 3 of a padded buffer), lane stats,
    expand and re-pack against the JAX package's C helpers."""
    w, v = _level_streams()[case]
    jpack, jhyb = jax_pack_native(), jax_hybrid_native()
    enc = hybrid_native().encode32(v, w)
    assert enc == bytes(jpack.hybrid_encode32(v, w))
    assert enc == jax_encode_hybrid(v, w) == encode_hybrid(v, w)
    buf = b"abc" + enc + b"\x00" * 4
    ours = hybrid_native().scan(buf, v.size, w, 3)
    theirs = jhyb.scan(buf, v.size, w, 3)
    assert ours[5:] == theirs[5:]
    for a, b in zip(ours[:5], theirs[:5]):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)
    plain = _scan_hybrid_py(buf, v.size, w, 3)
    assert ours[5:] == plain[5:]
    for a, b in zip(ours[:5], plain[:5]):
        np.testing.assert_array_equal(a, b)
    ends, is_rle, _, bp_start, bp_bytes, n_bp, _ = ours
    lens = np.diff(ends, prepend=np.int32(0))
    for target in (0, int(v[0]), (1 << w) - 1):
        assert hybrid_native().bp_stats(bp_bytes, w, bp_start[~is_rle],
                                        lens[~is_rle], target) == \
            jhyb.bp_stats(bp_bytes, w, bp_start[~is_rle], lens[~is_rle],
                          target)
    got = pack_native().hybrid_expand(ours, v.size, w)
    np.testing.assert_array_equal(got, jpack.hybrid_expand(*ours[:6],
                                                           v.size, w))
    np.testing.assert_array_equal(got, v)
    np.testing.assert_array_equal(expand_scan(*ours[:6], v.size, w), v)
    np.testing.assert_array_equal(pack_native().hybrid_repack(ours, v.size,
                                                              w),
                                  jpack.hybrid_repack(*ours[:6], v.size, w))


def test_hybrid_scan_errors_match_jax_native():
    for bad, count, w in ((b"\x03", 8, 3), (b"\x00", 4, 2),
                          (b"\x02\x09", 1, 3)):
        with pytest.raises(ValueError) as jerr:
            jax_hybrid_native().scan(bad, count, w)
        with pytest.raises(ValueError, match=re.escape(str(jerr.value))):
            hybrid_native().scan(bad, count, w)
    with pytest.raises(ValueError, match="does not fit"):
        encode_hybrid(np.array([8], np.uint32), 3)


@pytest.mark.parametrize("name", ["bursty int64", "int32 wrap",
                                  "block 256, 8 miniblocks"])
def test_delta_helpers_match_jax_native(name):
    """The block walk, the miniblock gather and the block emit against
    the JAX package's ``delta.c``/``pack.c``."""
    v, bs, nm = STREAMS[name]
    data = np.frombuffer(delta.encode_delta_binary_packed(v, bs, nm),
                         np.uint8)
    st = delta.scan_delta_structure(data)
    pos = 0
    for _ in range(4):  # skip the header varints
        while data[pos] & 0x80:
            pos += 1
        pos += 1
    args = (data, pos, st.total - 1, st.mb_size, bs // st.mb_size, 64)
    for a, b in zip(delta_native().scan_blocks(*args),
                    jax_delta_native().scan_blocks(*args)):
        np.testing.assert_array_equal(a, b)
    for w, _src, p_w, _s, _t, _dst in st.grouped():
        nbytes = st.mb_size * w // 8
        np.testing.assert_array_equal(
            delta_native().gather_segments(data, p_w, nbytes),
            jax_delta_native().gather_segments(data, p_w, nbytes))
    with pytest.raises(ValueError, match="out of bounds"):
        delta_native().gather_segments(data, np.array([data.size]), 4)
    rng = np.random.default_rng(0)
    adj = rng.integers(0, 2**20, size=(12, 32), dtype=np.uint64)
    widths = delta.widths_from_max(adj.max(axis=1))
    md = rng.integers(-2**40, 2**40, size=3)
    np.testing.assert_array_equal(
        pack_native().delta_emit(adj, widths, 32, md, 4),
        jax_pack_native().delta_emit(adj, widths, 32, md, 4))


# ----------------------------------------------------------------------
# a small sensor table read by both packages
# ----------------------------------------------------------------------

SENSOR_ENCODINGS = {"ts": "DELTA_BINARY_PACKED",
                    "seq": "DELTA_BINARY_PACKED",
                    "temp": "BYTE_STREAM_SPLIT",
                    "reading": "BYTE_STREAM_SPLIT"}
SENSOR_ENCODINGS_ENUM = {k: JaxEncoding[e] for k, e in
                         SENSOR_ENCODINGS.items()}


@pytest.mark.parametrize("writer,v2", [("port", False), ("port", True),
                                       ("jax", False), ("jax", True)])
def test_sensor_table_matches_jax(writer, v2, monkeypatch):
    """Every buffer, the routing counters (no page takes a transport)
    and the staged bytes agree, with the default transports; the values
    and levels equal the generator's."""
    for k in chip_smoke.TRANSPORT_ENV:
        monkeypatch.delenv(k, raising=False)
    rows = 20_000
    if writer == "port":
        blob, groups = chip_smoke.build_sensors(rows, 2, data_page_v2=v2)
    else:
        groups = chip_smoke.sensor_groups(rows, 2)
        buf = io.BytesIO()
        w = JaxFileWriter(buf, chip_smoke.SENSORS_SCHEMA,
                          codec=JaxCodec.SNAPPY, data_page_v2=v2,
                          column_encodings={
                              k: JaxEncoding[e]
                              for k, e in SENSOR_ENCODINGS.items()})
        for cols, masks in groups:
            w.write_columns(cols, masks=masks)
        w.close()
        blob = buf.getvalue()
    meta = FileReader(blob).meta
    for cc in meta.row_groups[0].columns:
        name = cc.meta_data.path_in_schema[0]
        assert int(SENSOR_ENCODINGS_ENUM[name]) in \
            [int(e) for e in cc.meta_data.encodings], name
    ours, st, jst = _read_both(blob)
    assert {k: getattr(st, k) for k in COUNTERS} == \
        {k: getattr(jst, k) for k in COUNTERS} == dict.fromkeys(COUNTERS, 0)
    assert st.bytes_staged == jst.bytes_staged
    for rg, (cols, masks) in enumerate(groups):
        for name, col in ours[rg].items():
            vals, rep, dl = col.to_numpy()
            assert vals.dtype == cols[name].dtype
            np.testing.assert_array_equal(vals, cols[name], err_msg=name)
            assert not rep.any()
            want = masks[name].astype(np.int32) if name in masks \
                else np.zeros(rows, np.int32)
            np.testing.assert_array_equal(dl, want, err_msg=name)


def test_sensor_ts_scatters():
    """The sensor table's ``ts`` page plans scattered width classes (the
    shape that reaches K11 on the card)."""
    ts = chip_smoke.sensor_groups(20_000, 1)[0][0]["ts"]
    plan = decode.plan_delta_i64(delta.encode_delta_binary_packed(ts))
    assert sum(g[2] is not None for g in plan.groups) >= 3
