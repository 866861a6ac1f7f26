"""BYTE_ARRAY pieces of tpuparquet_torch against the JAX package.

K9 (``page_dict_bytes``) and K10 (``plain_bytes_from_blob``) run their
plain versions here (CPU tensors) and are held to the JAX package's
``page_dict_bytes_tbl`` and ``plain_bytes_from_blob`` bit for bit over the
whole bucket-padded output, on the same staged buffers; the staged
lengths of padded byte arrays are held to the JAX stager's piece split;
the host passes (PLAIN scan and emit, the writer's dictionaries, V2 page
writing, the schema DSL) to the JAX package's on the same inputs.
"""

import io
import sys
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpuparquet.cpu.dictionary import build_dictionary as jax_build_dictionary
from tpuparquet.cpu.plain import ByteArrayColumn as JaxByteArrayColumn
from tpuparquet.cpu.plain import decode_plain as jax_decode_plain
from tpuparquet.cpu.plain import encode_plain as jax_encode_plain
from tpuparquet.io.reader import FileReader as JaxFileReader
from tpuparquet.kernels.decode import page_dict_bytes_tbl as jax_dict_bytes
from tpuparquet.kernels.decode import plain_bytes_from_blob as jax_from_blob
from tpuparquet.kernels.device import _split_rows as jax_split_rows
from tpuparquet_torch.cpu.dictionary import build_dictionary, \
    intern_byte_column
from tpuparquet_torch.cpu.hybrid import encode_hybrid, scan_hybrid
from tpuparquet_torch.cpu.plain import ByteArrayColumn, decode_plain, \
    encode_plain
from tpuparquet_torch.format.metadata import CompressionCodec, \
    ConvertedType, Type
from tpuparquet_torch.format.schema import Schema
from tpuparquet_torch.io.writer import FileWriter
from tpuparquet_torch.kernels.decode import bucket, page_dict_bytes, \
    plain_bytes_from_blob
from tpuparquet_torch.kernels.device import _padded_len, _put_all, _Stager
from tpuparquet_torch.kernels.hybrid import plan_stream_args
from tpuparquet_torch.native import TOO_MANY_DISTINCT
from tpuparquet_torch.stats import collect_stats

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
import chip_smoke  # noqa: E402


def _t(a: np.ndarray) -> torch.Tensor:
    a = np.ascontiguousarray(a).reshape(-1)
    return torch.from_numpy(a.view(np.uint8 if a.dtype.itemsize == 1
                                   else np.int32).copy())


def _staged_dictionary(rng, n_entries: int, max_len: int, min_len: int = 0,
                       empty=None):
    """int32 offsets and u8 data, zero-padded as the stager pads them
    (entry ``empty``, if given, is the empty string)."""
    lens = rng.integers(min_len, max_len, size=n_entries, endpoint=True)
    if empty is not None:
        lens[empty] = 0
    offs = np.zeros(_padded_len(n_entries + 1), dtype=np.int32)
    offs[1 : n_entries + 1] = np.cumsum(lens)
    n = int(lens.sum())
    data = np.zeros(_padded_len(n, 1), dtype=np.uint8)
    data[:n] = rng.integers(0, 256, size=n, dtype=np.uint8)
    return offs, data, lens


# (entries, max length, values, width, stream[, options]): the edge cases
# of K9.  Options: "min_len" (every entry at least this long: a value
# longer than the kernel's 4096-value block writes), "empty_run" (slots
# a:b take entry 0, the empty string, across a block edge), "past" (every
# 7th index past the dictionary's entries: onto its zero padding, or
# clamped), "tail" (the stream fills the bucket's slots past non_null and
# the last picks the dictionary's last entry, which the tail reads)
DICT_CASES = {
    "single run": (200, 12, 3000, 8, "single"),
    "run table": (200, 12, 3000, 8, "table"),
    "width 0": (1, 9, 1000, 0, None),
    "empty blob": (5, 0, 700, 3, "table"),
    "exact bucket": (37, 30, 1024, 6, "single"),
    "all null": (37, 30, 0, 6, "table"),
    "several pieces": (300, 20_000, 500, 9, "table"),
    "value over a tile": (3, 90_000, 40, 2, "single", {"min_len": 70_000}),
    "5000 empty values": (50, 20, 12_000, 6, "table",
                          {"empty_run": (3000, 8000)}),
    "tail reads the last entry": (37, 30, 3000, 6, "single", {"tail": True}),
    "indices past the dictionary": (37, 30, 3000, 7, "single",
                                    {"past": True}),
}


@pytest.mark.parametrize("case", sorted(DICT_CASES))
def test_page_dict_bytes_matches_jax(case):
    n_ent, max_len, nn, w, how, *opt = DICT_CASES[case]
    opt = opt[0] if opt else {}
    rng = np.random.default_rng(len(case))
    offs, data, lens = _staged_dictionary(
        rng, n_ent, max_len, opt.get("min_len", 0),
        0 if "empty_run" in opt else None)
    idx = rng.integers(0, n_ent, size=nn).astype(np.uint32)
    if nn:
        idx[nn // 3 : nn // 3 + 50] = idx[0]  # a run
    if "empty_run" in opt:
        a, b = opt["empty_run"]
        idx[a:b] = 0
    if opt.get("past"):
        idx[::7] = rng.integers(n_ent + 1, 1 << w, size=idx[::7].size)
    slots = nn
    if opt.get("tail"):
        slots = bucket(nn)
        idx = np.concatenate([idx, np.zeros(slots - nn, np.uint32)])
        idx[-1] = n_ent - 1
    if how == "single":
        (bp, tbl), cnt, nbp, single = _one_run_plan(idx, w)
    elif how == "table":
        sc = scan_hybrid(encode_hybrid(idx, w), slots, w)
        (bp, tbl), cnt, nbp, single = plan_stream_args(sc, slots, w)
    else:  # width 0: no stream
        bp = tbl = np.zeros(1, np.uint32)
        cnt, nbp, single = bucket(max(nn, 1)), 0, False
    assert single == (how == "single")
    # the staged lengths at the indices as K9 clamps them
    slens = np.diff(offs)
    total_b = int(slens[np.minimum(idx[:nn], slens.size - 1)].sum())
    if not opt:
        assert total_b == int(lens[idx].sum())
    cap = bucket(max(total_b, 1))
    got = page_dict_bytes(_t(offs), _t(data), _t(bp) if w else None,
                          _t(tbl) if w else None, nn, cnt, w, nbp, cap,
                          single)
    want = np.asarray(jax_dict_bytes(
        jnp.asarray(offs), jnp.asarray(data), jnp.asarray(bp),
        jnp.asarray(tbl), np.int32(nn), cnt, w, nbp, cap, has_idx=w > 0,
        isingle=single))
    assert got.dtype == torch.uint8 and got.shape == (cap,)
    np.testing.assert_array_equal(got.numpy(), want)
    if opt.get("tail"):
        # past the values' end: the last slot's entry, then its clamp
        assert cnt == slots and total_b < cap
        start = int(offs[n_ent - 1])
        src = np.minimum(start + np.arange(cap - total_b), data.size - 1)
        np.testing.assert_array_equal(got.numpy()[total_b:], data[src])


def _one_run_plan(idx: np.ndarray, w: int):
    """The stream as one bit-packed run (as the planner re-packs a run
    table that weighs more than plain packing)."""
    from tpuparquet_torch.cpu.bitpack import pack
    from tpuparquet_torch.varint import write_uvarint

    n = idx.size
    groups = -(-n // 8)
    head = bytearray()
    write_uvarint(head, (groups << 1) | 1)
    padded = np.zeros(groups * 8, np.uint64)
    padded[:n] = idx
    sc = scan_hybrid(bytes(head) + pack(padded, w), n, w)
    return plan_stream_args(sc, n, w)


# (values, max length, pos, bytes cut off the blob, layout): the cases of
# K10.  The layouts are chip_smoke.blob_lens's, at the edges of K10's
# tiles (decode.blob_tile_bytes): a value over two tiles, runs of empty
# values inside a tile (more ends than a tile stages) and on its edge, the
# values' bytes one short of and one past a tile.  1,023 values leave the
# offsets unpadded, so the tail runs on from the last value
BLOB_CASES = {
    "pos 0": (3000, 40, 0, 0, None),
    "odd pos": (3000, 40, 7, 0, None),
    "empty values": (300, 0, 3, 0, None),
    "short blob": (3000, 40, 5, 999, None),
    "empty blob": (0, 0, 0, None, None),
    "pos 1": (3000, 40, 1, 0, None),
    "pos 2": (3000, 40, 2, 0, None),
    "pos 3": (3000, 40, 3, 0, None),
    "value over two tiles": (500, 40, 2, 0, "long"),
    "empty run in a tile": (3000, 40, 1, 0, "empty run"),
    "empty run at a tile edge": (3000, 40, 3, 0, "empty at edge"),
    "nb one short of a tile": (0, 40, 3, 0, "nb -1"),
    "nb one past a tile": (0, 40, 1, 0, "nb +1"),
    "unpadded tail": (1023, 40, 2, 0, None),
    "short unpadded tail": (1023, 40, 2, 999, None),
}


@pytest.mark.parametrize("case", sorted(BLOB_CASES))
def test_plain_bytes_from_blob_matches_jax(case):
    n, max_len, pos, cut, layout = BLOB_CASES[case]
    rng = np.random.default_rng(len(case))
    if layout is None:
        lens = rng.integers(0, max_len, size=n, endpoint=True)
    else:
        lens = chip_smoke.blob_lens(rng, n, max_len, layout)
    n = lens.size
    col = ByteArrayColumn(np.concatenate([[0], np.cumsum(lens)]),
                          rng.integers(0, 256, size=int(lens.sum()),
                                       dtype=np.uint8))
    page = np.concatenate([rng.integers(0, 256, size=pos, dtype=np.uint8),
                           np.frombuffer(encode_plain(Type.BYTE_ARRAY, col),
                                         np.uint8)])
    if cut is None:
        blob = np.zeros(0, np.uint8)
    else:
        blob = np.zeros(bucket(page.size), np.uint8)
        blob[: page.size] = page
        blob = blob[: blob.size - cut]
    nb = int(col.data.size)
    offs = np.full(bucket(n + 1), nb, dtype=np.int32)
    offs[: n + 1] = col.offsets
    cap = bucket(max(nb, 1))
    got = plain_bytes_from_blob(_t(blob), _t(offs), pos, cap)
    want = np.asarray(jax_from_blob(jnp.asarray(blob), jnp.asarray(offs),
                                    jnp.int32(pos), cap))
    np.testing.assert_array_equal(got.numpy(), want)
    if cut is not None:
        np.testing.assert_array_equal(got.numpy()[:nb], col.data)


@pytest.mark.parametrize("n", [0, 31, 33, (128 << 10) - 1, 128 << 10,
                               (128 << 10) + 1, (16 << 20) + 5])
def test_padded_byte_staging_matches_jax(n):
    a = np.zeros(n, np.uint8)
    assert _padded_len(n, 1) == sum(p.size for p in jax_split_rows(a))
    stg = _Stager()
    stg.add(a)
    stg.add(a, pad=False)
    with collect_stats() as st:
        (staged,), _slab = _put_all([stg], torch.device("cpu"))
    assert staged[0].dtype == torch.uint8
    assert staged[0].numel() == _padded_len(n, 1)
    assert staged[1].numel() == n
    assert st.bytes_staged == _padded_len(n, 1) + n


def _random_column(rng, n: int, max_len: int) -> ByteArrayColumn:
    lens = rng.integers(0, max_len, size=n, endpoint=True)
    return ByteArrayColumn(np.concatenate([[0], np.cumsum(lens)]),
                           rng.integers(97, 100, size=int(lens.sum()),
                                        dtype=np.uint8))


def test_plain_bytes_round_trip_matches_jax():
    col = _random_column(np.random.default_rng(1), 5000, 17)
    raw = encode_plain(Type.BYTE_ARRAY, col)
    assert raw == jax_encode_plain(Type.BYTE_ARRAY, JaxByteArrayColumn(
        col.offsets, col.data))
    got = decode_plain(Type.BYTE_ARRAY, raw + b"tail", 5000)
    want = jax_decode_plain(Type.BYTE_ARRAY, raw, 5000)
    np.testing.assert_array_equal(got.offsets, want.offsets)
    np.testing.assert_array_equal(got.data, want.data)
    with pytest.raises(ValueError, match="truncated length prefix"):
        decode_plain(Type.BYTE_ARRAY, raw, 5001)
    with pytest.raises(ValueError, match="PLAIN BYTE_ARRAY"):
        decode_plain(Type.BYTE_ARRAY, raw[:-1], 5000)


def test_byte_dictionary_matches_jax():
    """First-occurrence interning, as the JAX writer builds it, and the
    early stop past the distinct cap."""
    col = _random_column(np.random.default_rng(2), 20_000, 4)
    d, idx = build_dictionary(col)
    jd, jidx = jax_build_dictionary(JaxByteArrayColumn(col.offsets,
                                                       col.data))
    np.testing.assert_array_equal(d.offsets, jd.offsets)
    np.testing.assert_array_equal(d.data, jd.data)
    np.testing.assert_array_equal(idx, jidx)
    assert intern_byte_column(col, len(d) - 1) is TOO_MANY_DISTINCT


def test_float_dictionary_matches_jax():
    vals = np.random.default_rng(3).integers(0, 50, size=9000) / 8.0
    d, idx = build_dictionary(vals)
    jd, jidx = jax_build_dictionary(vals)
    np.testing.assert_array_equal(d, jd)
    np.testing.assert_array_equal(idx, jidx)


def test_schema_dsl_reads_strings_and_doubles():
    sch = Schema.from_string("message m { required binary s (STRING); "
                             "optional double d; required float f; }")
    assert [(c.type, c.element.converted_type) for c in sch.leaves] == [
        (Type.BYTE_ARRAY, ConvertedType.UTF8), (Type.DOUBLE, None),
        (Type.FLOAT, None)]
    with pytest.raises(NotImplementedError):
        Schema.from_string("message m { required int32 s (STRING); }")


@pytest.mark.parametrize("v2", [False, True])
@pytest.mark.parametrize("codec", [CompressionCodec.UNCOMPRESSED,
                                   CompressionCodec.SNAPPY])
def test_writer_strings_and_floats_read_by_jax(v2, codec):
    """The port's writer (V1 and V2 pages) read back by the JAX package's
    CPU oracle: dictionary and PLAIN strings, floats, doubles, nulls."""
    rng = np.random.default_rng(5)
    n = 6000
    mask = rng.random(n) >= 0.3
    cols = {"few": _random_column(rng, n, 1),
            "many": _random_column(rng, int(mask.sum()), 30),
            "f": rng.random(n).astype(np.float32),
            "d": np.round(rng.random(int(mask.sum())) * 4) / 4}
    buf = io.BytesIO()
    with FileWriter(buf, "message m { required binary few (STRING); "
                    "optional binary many; required float f; "
                    "optional double d; }", codec=codec,
                    data_page_v2=v2) as w:
        w.write_columns(cols, masks={"many": mask, "d": mask})
    reader = JaxFileReader(io.BytesIO(buf.getvalue()))
    got = reader.read_row_group_arrays(0)
    for name, want in cols.items():
        vals = got[name].values
        if isinstance(want, ByteArrayColumn):
            np.testing.assert_array_equal(vals.offsets, want.offsets)
            np.testing.assert_array_equal(vals.data, want.data)
        else:
            np.testing.assert_array_equal(vals, want)
    np.testing.assert_array_equal(got["many"].def_levels,
                                  mask.astype(np.int32))
    dict_cols = {".".join(cc.meta_data.path_in_schema)
                 for cc in reader.meta.row_groups[0].columns
                 if cc.meta_data.dictionary_page_offset is not None}
    assert dict_cols == {"few", "d"}
