"""Repeated columns: tpuparquet_torch against the JAX package.

The DSL's schema elements for LIST and TIMESTAMP fields are held to the
JAX parser's, and the writer's levels (``cpu/levels.py list_levels``) to
the JAX writer's ``_prepare_repeated``, case by case: null rows, empty
lists, null elements, a bare repeated leaf, and the masks each schema
refuses.  A config-3-shaped file (bench.py's ``build_config3`` generator
at 2 x 20,000 rows: DELTA_BINARY_PACKED timestamps in a nullable LIST)
and a file of three LISTs (dictionary int32 for K3, dictionary strings
for K9, PLAIN doubles) are written by each writer, in data page V1 and
V2, and read by both packages: every buffer, ``rep_levels`` included,
the routing counters and ``bytes_staged`` agree, and the values and
levels equal the generator's.
"""

import io
import re
import sys
from pathlib import Path

import numpy as np
import pytest

from tpuparquet import CompressionCodec as JaxCodec
from tpuparquet import Encoding as JaxEncoding
from tpuparquet import FileWriter as JaxFileWriter
from tpuparquet.cpu.plain import ByteArrayColumn as JaxByteArrayColumn
from tpuparquet.format.schema import Schema as JaxSchema
from tpuparquet_torch.cpu.levels import list_levels
from tpuparquet_torch.cpu.plain import ByteArrayColumn
from tpuparquet_torch.format.metadata import CompressionCodec, Encoding, \
    ThriftStruct
from tpuparquet_torch.format.schema import Schema
from tpuparquet_torch.io.reader import FileReader
from tpuparquet_torch.io.writer import FileWriter

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
import chip_smoke  # noqa: E402
from test_torch_read import COUNTERS, _read_both  # noqa: E402

OPT_LIST = """message m {
    optional group l (LIST) {
        repeated group list { optional int64 element; }
    }
}"""
REQ_LIST = """message m {
    required group l (LIST) {
        repeated group list { required int32 element; }
    }
}"""
OPT_LIST_REQ_ELEM = """message m {
    optional group l (LIST) {
        repeated group list { required int64 element; }
    }
}"""
BARE = "message m { repeated int32 l; }"
THREE_LISTS = """message m {
    optional group codes (LIST) {
        repeated group list { optional int32 element; }
    }
    optional group names (LIST) {
        repeated group list { optional binary element (STRING); }
    }
    required group vals (LIST) {
        repeated group list { required double element; }
    }
}"""


def _same_struct(a, b, where):
    """Every field the port declares equals the JAX package's."""
    for name in a._NAMES:
        x, y = getattr(a, name), getattr(b, name)
        at = f"{where}.{name}"
        if isinstance(x, ThriftStruct):
            assert y is not None, at
            _same_struct(x, y, at)
        elif x is None:
            assert y is None, at
        else:
            assert int(x) == int(y) if not isinstance(x, str) else x == y, at


@pytest.mark.parametrize("schema", [
    chip_smoke.CONFIG3_SCHEMA, chip_smoke.SENSORS_SCHEMA, OPT_LIST, REQ_LIST,
    BARE, THREE_LISTS.replace(" (STRING)", ""),
    "message m { optional int64 t (TIMESTAMP(MILLIS, false)); }"])
def test_schema_elements_match_jax_parser(schema):
    ours = Schema.from_string(schema)
    theirs = JaxSchema.from_string(schema)
    a, b = ours.to_elements(), theirs.to_elements()
    assert len(a) == len(b)
    for i, (x, y) in enumerate(zip(a, b)):
        _same_struct(x, y, f"element {i}")
    assert [(lf.flat_name, lf.max_rep_level, lf.max_def_level)
            for lf in ours.leaves] == \
        [(lf.flat_name, lf.max_rep_level, lf.max_def_level)
         for lf in theirs.leaves]


@pytest.mark.parametrize("text", [
    "message m { optional group l (MAP) { repeated int32 k; } }",
    "message m { required int32 t (TIME(MICROS, true)); }",
    "message m { required int32 t (TIMESTAMP(MILLIS, true)); }",
    "message m { required binary s (UTF8); }",
])
def test_schema_outside_the_subset_raises(text):
    with pytest.raises(NotImplementedError):
        Schema.from_string(text)


def _levels_case(name):
    """schema, offsets, row mask, element mask of one writer case."""
    rng = np.random.default_rng(len(name))
    lens = rng.integers(0, 5, size=300)
    row_mask = elem_mask = None
    if name in ("null rows", "null rows and elements", "required row mask",
                "bare row mask"):
        row_mask = rng.random(300) >= 0.2
        lens[~row_mask] = 0
    offs = np.concatenate([[0], np.cumsum(lens)])
    if name in ("null elements", "null rows and elements",
                "required element mask", "required element of optional"):
        elem_mask = rng.random(int(offs[-1])) >= 0.3
    schema = {"required row mask": REQ_LIST,
              "required element mask": REQ_LIST,
              "required, no masks": REQ_LIST,
              "required element of optional": OPT_LIST_REQ_ELEM,
              "bare": BARE, "bare row mask": BARE}.get(name, OPT_LIST)
    return schema, offs, row_mask, elem_mask


LEVEL_CASES = ["empty lists", "null rows", "null elements",
               "null rows and elements", "required, no masks", "bare",
               "required row mask", "required element mask",
               "required element of optional", "bare row mask",
               "bad offsets"]


@pytest.mark.parametrize("name", LEVEL_CASES)
def test_writer_levels_match_prepare_repeated(name):
    schema, offs, row_mask, elem_mask = _levels_case(name)
    if name == "bad offsets":
        offs = offs.copy()
        offs[5] = offs[6] + 1
    jw = JaxFileWriter(io.BytesIO(), schema)
    jleaf = jw.schema.leaves[0]
    leaf = Schema.from_string(schema).leaves[0]
    n_elem = int(offs[-1])
    n_valid = n_elem if elem_mask is None else int(elem_mask.sum())
    dtype = np.int32 if "int32" in schema else np.int64
    vals = np.arange(n_valid, dtype=dtype)
    try:
        _, jrep, jdl, jrows, jnulls = jw._prepare_repeated(
            jleaf, vals, offs, row_mask, elem_mask)
    except ValueError as e:
        with pytest.raises(ValueError, match=re.escape(str(e))):
            list_levels(leaf, offs, row_mask, elem_mask)
        assert name not in LEVEL_CASES[:6]
        return
    assert name in LEVEL_CASES[:6]
    rep, dl, rows, n_values = list_levels(leaf, offs, row_mask, elem_mask)
    assert rep.dtype == dl.dtype == np.int32
    np.testing.assert_array_equal(rep, jrep)
    np.testing.assert_array_equal(dl, jdl)
    assert (rows, n_values, dl.size - n_values) == (jrows, n_valid, jnulls)


def _config3_blob(writer, v2, groups):
    enc = {"events.list.element": "DELTA_BINARY_PACKED"}
    if writer == "port":
        return chip_smoke._write(
            chip_smoke.CONFIG3_SCHEMA, [(c, m) for c, m, _, _ in groups],
            None, data_page_v2=v2,
            column_encodings={k: Encoding[e] for k, e in enc.items()},
            lists=[(o, e) for _, _, o, e in groups])
    buf = io.BytesIO()
    w = JaxFileWriter(buf, chip_smoke.CONFIG3_SCHEMA, codec=JaxCodec.SNAPPY,
                      data_page_v2=v2, column_encodings={
                          k: JaxEncoding[e] for k, e in enc.items()})
    for c, m, o, e in groups:
        w.write_columns(c, masks=m, offsets=o, element_masks=e)
    w.close()
    return buf.getvalue()


def _check_lists(ours, groups, schema):
    """Values, rep and def levels against the generator."""
    leaves = {lf.path[0]: lf for lf in Schema.from_string(schema).leaves}
    for rg, (cols, masks, offs, elems) in enumerate(groups):
        for key, leaf in leaves.items():
            col = ours[rg][leaf.flat_name]
            vals, rep, dl = col.to_numpy()
            want_rep, want_dl, _, n = list_levels(
                leaf, offs[key], masks.get(key), elems.get(key))
            np.testing.assert_array_equal(rep, want_rep, err_msg=key)
            np.testing.assert_array_equal(dl, want_dl, err_msg=key)
            want = cols[key]
            if isinstance(want, (ByteArrayColumn, JaxByteArrayColumn)):
                assert vals.to_list() == want.to_list()
            else:
                assert vals.dtype == want.dtype and len(vals) == n
                np.testing.assert_array_equal(vals, want, err_msg=key)
            np.testing.assert_array_equal(
                col.mask.numpy(), want_dl == leaf.max_def_level)


@pytest.mark.parametrize("writer,v2", [("port", False), ("port", True),
                                       ("jax", False), ("jax", True)])
def test_config3_shape_matches_jax(writer, v2, monkeypatch):
    for k in chip_smoke.TRANSPORT_ENV:
        monkeypatch.delenv(k, raising=False)
    groups = chip_smoke.config3_groups(20_000, 2)
    blob = _config3_blob(writer, v2, groups)
    cm = FileReader(blob).meta.row_groups[0].columns[0].meta_data
    assert Encoding.DELTA_BINARY_PACKED in cm.encodings
    assert cm.dictionary_page_offset is None
    ours, st, jst = _read_both(blob)
    assert {k: getattr(st, k) for k in COUNTERS} == \
        {k: getattr(jst, k) for k in COUNTERS} == dict.fromkeys(COUNTERS, 0)
    assert st.bytes_staged == jst.bytes_staged
    col = ours[0]["events.list.element"]
    assert col.padded_buffers()["rep_levels"].size == \
        col.padded_buffers()["def_levels"].size
    _check_lists(ours, groups, chip_smoke.CONFIG3_SCHEMA)


def _three_lists_groups(rows, n_groups, jax_strings):
    rng = np.random.default_rng(21)
    vocab = [b"name-%02d" % i for i in range(40)]
    bac = JaxByteArrayColumn if jax_strings else ByteArrayColumn
    groups = []
    for _ in range(n_groups):
        cols, masks, offs, elems = {}, {}, {}, {}
        for key in ("codes", "names", "vals"):
            lens = rng.integers(0, 6, size=rows)
            if key != "vals":
                masks[key] = rng.random(rows) >= 0.1
                lens[~masks[key]] = 0
            offs[key] = np.concatenate([[0], np.cumsum(lens)])
            n = int(offs[key][-1])
            if key != "vals":
                elems[key] = rng.random(n) >= 0.05
                n = int(elems[key].sum())
            if key == "codes":
                cols[key] = rng.integers(-3, 60, size=n).astype(np.int32)
            elif key == "names":
                picks = rng.integers(0, len(vocab), size=n)
                lens_b = np.array([len(vocab[i]) for i in picks], np.int64)
                o = np.concatenate([[0], np.cumsum(lens_b)])
                cols[key] = bac(o, np.frombuffer(
                    b"".join(vocab[i] for i in picks), np.uint8))
            else:
                cols[key] = rng.normal(0, 1e6, size=n)
        groups.append((cols, masks, offs, elems))
    return groups


@pytest.mark.parametrize("writer,v2", [("port", False), ("port", True),
                                       ("jax", False), ("jax", True)])
def test_lists_of_dictionary_strings_and_plain_match_jax(writer, v2,
                                                         monkeypatch):
    """K3 (dictionary int32), K9 (dictionary strings) and a PLAIN double
    page under rep levels, with the default transports."""
    for k in chip_smoke.TRANSPORT_ENV:
        monkeypatch.delenv(k, raising=False)
    groups = _three_lists_groups(8_000, 2, writer == "jax")
    buf = io.BytesIO()
    if writer == "port":
        w = FileWriter(buf, THREE_LISTS, codec=CompressionCodec.SNAPPY,
                       data_page_v2=v2)
    else:
        w = JaxFileWriter(buf, THREE_LISTS, codec=JaxCodec.SNAPPY,
                          data_page_v2=v2)
    for cols, masks, offs, elems in groups:
        w.write_columns(cols, masks=masks, offsets=offs,
                        element_masks=elems)
    w.close()
    blob = buf.getvalue()
    meta = FileReader(blob).meta
    dict_cols = {cc.meta_data.path_in_schema[0]
                 for cc in meta.row_groups[0].columns
                 if cc.meta_data.dictionary_page_offset is not None}
    assert dict_cols == {"codes", "names"}
    ours, st, jst = _read_both(blob)
    assert {k: getattr(st, k) for k in COUNTERS} == \
        {k: getattr(jst, k) for k in COUNTERS}
    assert st.bytes_staged == jst.bytes_staged
    _check_lists(ours, groups, THREE_LISTS)


def test_writer_refuses_what_it_cannot_write():
    with pytest.raises(ValueError, match="pass a tuple of per-leaf arrays"):
        FileWriter(io.BytesIO(), """message m { optional group l (LIST) {
            repeated group list { optional int32 a; optional int32 b; }
        } }""").write_columns({"l": np.arange(3, dtype=np.int32)},
                              offsets={"l": np.array([0, 3])})
    with pytest.raises(ValueError, match="not allowed"):
        FileWriter(io.BytesIO(), chip_smoke.SENSORS_SCHEMA,
                   column_encodings={"temp": Encoding.DELTA_BINARY_PACKED})
    with pytest.raises(ValueError, match="no such column"):
        FileWriter(io.BytesIO(), chip_smoke.SENSORS_SCHEMA,
                   column_encodings={"nope": Encoding.PLAIN})
    w = FileWriter(io.BytesIO(), OPT_LIST)
    with pytest.raises(ValueError, match="needs offsets"):
        w.write_columns({"l": np.arange(3)})
    with pytest.raises(ValueError, match="3 values vs 4"):
        w.write_columns({"l": np.arange(3)}, offsets={"l": np.array([0, 4])})
