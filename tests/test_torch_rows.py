"""The row API: ``FileReader.rows()`` and the row writer
(``FileWriter.add_data``, ``flush_row_group``, ``max_row_group_size``)
of tpuparquet_torch against the JAX package's.

Over the type matrix of ``tests/test_torch_types.py`` (every physical
type and writable encoding, dictionary on and off, UNCOMPRESSED and
SNAPPY, data page V1 and V2) and the nested schemas of
``tests/test_torch_nested_write.py``, each file is read row by row by
both readers: the records are equal.  The records then go back through
both writers' ``add_data`` with the same settings and the same
``created_by``: the files are equal byte for byte, with and without
``max_row_group_size``, and with ``kv_metadata`` and ``kv_per_column``
on the flush.  The schema's text, the reader's row-group walk and the
errors of the row path agree too.  Inputs come from numpy seeds; every
comparison is exact.
"""

import io
import math

import numpy as np
import pytest

from tpuparquet import CompressionCodec as JaxCodec
from tpuparquet import Encoding as JaxEncoding
from tpuparquet import FileWriter as JaxFileWriter
from tpuparquet.io.reader import FileReader as JaxFileReader
from tpuparquet_torch.format.metadata import CompressionCodec, Encoding
from tpuparquet_torch.io.reader import FileReader
from tpuparquet_torch.io.writer import FileWriter

from test_torch_nested_write import SCHEMAS as NESTED  # noqa: E402
from test_torch_nested_write import _case, _write_both  # noqa: E402
from test_torch_types import ENC, _combos, _schema, _write  # noqa: E402

CREATED_BY = "rows-test"


def _rows_both(blob: bytes) -> list:
    """The records of ``blob`` by both readers, held equal."""
    theirs = list(JaxFileReader(io.BytesIO(blob)).rows())
    ours = list(FileReader(blob).rows())
    assert _same(ours, theirs)
    return ours


def _same(a, b) -> bool:
    """Equal records, a NaN equal to a NaN."""
    if isinstance(a, dict):
        return isinstance(b, dict) and a.keys() == b.keys() and all(
            _same(a[k], b[k]) for k in a)
    if isinstance(a, list):
        return isinstance(b, list) and len(a) == len(b) and all(
            _same(x, y) for x, y in zip(a, b))
    if isinstance(a, float) and isinstance(b, float) \
            and math.isnan(a) and math.isnan(b):
        return True
    return type(a) is type(b) and a == b


def _add_rows_both(schema, rows, *, codec="UNCOMPRESSED", v2=False,
                   allow_dict=True, encodings=None, max_rg=None,
                   flush_every=None, kv=None, kv_per_column=None):
    """``rows`` through both writers' ``add_data`` (a flush every
    ``flush_every`` rows, with ``kv``/``kv_per_column``); both files."""
    out = []
    for cls, codecs, encs in ((JaxFileWriter, JaxCodec, JaxEncoding),
                              (FileWriter, CompressionCodec, Encoding)):
        buf = io.BytesIO()
        w = cls(buf, schema, codec=codecs[codec], data_page_v2=v2,
                allow_dict=allow_dict, created_by=CREATED_BY,
                max_row_group_size=max_rg,
                column_encodings={k: encs[v] for k, v in
                                  (encodings or {}).items()})
        for i, row in enumerate(rows):
            w.add_data(row)
            if flush_every and (i + 1) % flush_every == 0:
                w.flush_row_group(kv_metadata=kv,
                                  kv_per_column=kv_per_column)
        w.close()
        out.append(buf.getvalue())
    return out


@pytest.mark.parametrize("tname,ename,dict_on,codec,v2", list(_combos()))
def test_type_matrix_rows_as_reference(tname, ename, dict_on, codec, v2):
    """The matrix's file read row by row by both readers; its records
    written back by both row writers: byte-equal files whose records are
    the same."""
    blob = _write("jax", tname, ename, dict_on, codec, v2)
    rows = _rows_both(blob)
    assert len(rows) == 300
    enc = {} if ENC[ename] is None else {
        leaf: ENC[ename] for leaf in ("c", "o", "r.list.element")}
    theirs, ours = _add_rows_both(_schema(tname), rows, codec=codec, v2=v2,
                                  allow_dict=dict_on, encodings=enc)
    assert ours == theirs
    assert _same(_rows_both(ours), rows)


@pytest.mark.parametrize("name", list(NESTED))
def test_nested_rows_as_reference(name):
    """Structs, a MAP, LISTs of structs, a bare repeated group: records
    of two row groups, read by both and written back by both row
    writers, byte for byte."""
    schema = NESTED[name]
    groups = [_case(schema, 5 * i + len(name)) for i in range(2)]
    theirs_blob, ours_blob = _write_both(schema, groups, snappy=True)
    rows = _rows_both(ours_blob)
    assert _same(rows, _rows_both(theirs_blob))
    theirs, ours = _add_rows_both(schema, rows, codec="SNAPPY",
                                  flush_every=240)
    assert ours == theirs
    assert _same(_rows_both(ours), rows)


SAMPLE = """message m {
    required int64 id;
    optional binary name (STRING);
    optional group tags (LIST) { repeated group list {
        optional binary element (STRING); } }
    optional group loc { required double lat; optional int32 zone
        (INT(16, false)); }
}"""


def sample_rows(n: int, seed: int) -> list:
    """``n`` records of :data:`SAMPLE`: nulls, empty and null lists, null
    elements, null structs, unsigned values past the signed range."""
    rng = np.random.default_rng(seed)
    rows = []
    for i in range(n):
        row = {"id": int(rng.integers(-(2 ** 40), 2 ** 40))}
        if rng.random() < 0.8:
            row["name"] = b"n%d" % int(rng.integers(0, 50))
        k = int(rng.integers(-1, 4))
        if k >= 0:
            row["tags"] = {"list": [
                {"element": b"t%d" % int(rng.integers(0, 9))}
                if rng.random() < 0.8 else {} for _ in range(k)]}
        if rng.random() < 0.7:
            loc = {"lat": float(rng.random())}
            if rng.random() < 0.6:
                loc["zone"] = int(rng.integers(0, 65536))
            row["loc"] = loc
        rows.append(row)
    return rows


@pytest.mark.parametrize("max_rg", [None, 1, 300, 4096])
@pytest.mark.parametrize("seed", [3, 4])
def test_row_groups_by_size_as_reference(max_rg, seed):
    """``max_row_group_size`` cuts the same row groups in both writers
    (1: one row a group; None: one group at the close), and the files
    are equal byte for byte."""
    rows = sample_rows(180, seed)
    theirs, ours = _add_rows_both(SAMPLE, rows, codec="SNAPPY",
                                  max_rg=max_rg)
    assert ours == theirs
    groups = FileReader(ours).row_group_count()
    if max_rg == 1:
        assert groups == 180
    elif max_rg is None:
        assert groups == 1
    else:
        assert 1 < groups < 180
    assert len(_rows_both(ours)) == 180


def test_flush_kv_metadata_as_reference():
    rows = sample_rows(90, 5)
    kv = {"batch": "7", "source": "rows"}
    per = {"name": {"source": "names"}, "loc.lat": {"unit": "deg"}}
    theirs, ours = _add_rows_both(SAMPLE, rows, flush_every=30, kv=kv,
                                  kv_per_column=per)
    assert ours == theirs
    r = FileReader(ours)
    assert r.row_group_count() == 3
    jr = JaxFileReader(io.BytesIO(ours))
    for rg in range(3):
        r.pre_load()
        jr.pre_load()
        for col in ("id", "name", "loc.lat"):
            file_kv, cm = r.column_meta_data(col)
            jfile_kv, jcm = jr.column_meta_data(col)
            assert file_kv == jfile_kv == {}
            got = [(x.key, x.value) for x in cm.key_value_metadata]
            assert got == [(x.key, x.value) for x in jcm.key_value_metadata]
            assert dict(got) == {**kv, **per.get(col, {})}
        r.skip_row_group()
        jr.skip_row_group()


def test_row_walk_as_reference():
    """``next_row``, ``pre_load``, ``skip_row_group`` and
    ``current_row_group`` step through the same records."""
    rows = sample_rows(100, 6)
    _, blob = _add_rows_both(SAMPLE, rows, flush_every=25)
    ours, theirs = FileReader(blob), JaxFileReader(io.BytesIO(blob))
    seq = []
    for r in (ours, theirs):
        got = [r.next_row(), r.next_row()]
        r.skip_row_group()            # the rest of row group 0
        r.skip_row_group()            # row group 1, not loaded
        r.pre_load()                  # row group 2
        got.append(r.current_row_group().num_rows)
        got += list(r.rows())
        with pytest.raises(EOFError):
            r.next_row()
        seq.append(got)
    assert _same(seq[0], seq[1])
    assert len(seq[0]) == 2 + 1 + 50


@pytest.mark.parametrize("schema", [
    SAMPLE,
    "message m { required int32 d (DATE); optional int64 t "
    "(TIME(MICROS, true)); optional binary e (ENUM); optional binary j "
    "(JSON); optional binary b (BSON); required int64 n (TIMESTAMP(NANOS, "
    "false)); }",
    "message m { optional group mm (MAP) { repeated group key_value { "
    "required binary key (UTF8); optional int32 value (INT_8); } } "
    "required fixed_len_byte_array(16) u (UUID); optional int96 x; "
    "required binary d (DECIMAL(9, 2)); }",
], ids=["sample", "logical", "converted"])
def test_schema_text_as_reference(schema):
    """``get_schema_definition`` prints the same text, every logical and
    converted type of a footer included, and a writer given that
    definition writes the same file."""
    buf = io.BytesIO()
    JaxFileWriter(buf, schema).close()
    blob = buf.getvalue()
    ours = FileReader(blob).get_schema_definition()
    theirs = JaxFileReader(io.BytesIO(blob)).get_schema_definition()
    assert str(ours) == str(theirs)
    assert str(FileReader(blob).schema) == str(theirs)
    out = io.BytesIO()
    FileWriter(out, ours, created_by="tpuparquet").close()
    assert out.getvalue() == blob


@pytest.mark.parametrize("case", ["required_missing", "group_not_dict",
                                  "list_for_struct", "mix_columns",
                                  "closed", "bad_value"])
def test_row_errors_as_reference(case):
    """The row path refuses the same records with the same words."""
    msgs = []
    for cls in (JaxFileWriter, FileWriter):
        w = cls(io.BytesIO(), SAMPLE)
        try:
            if case == "required_missing":
                w.add_data({"name": b"x"})
            elif case == "group_not_dict":
                w.add_data({"id": 1, "loc": 3})
            elif case == "list_for_struct":
                w.add_data({"id": 1, "loc": [{"lat": 1.0}]})
            elif case == "mix_columns":
                w.add_data({"id": 1})
                w.write_columns({"id": np.arange(2)})
            elif case == "closed":
                w.close()
                w.add_data({"id": 1})
            else:
                w.add_data({"id": "seven"})
        except (TypeError, ValueError) as e:
            msgs.append((type(e).__name__, str(e)))
        else:
            msgs.append(None)
    assert msgs[0] is not None and msgs[0] == msgs[1]


def test_sizes_as_reference():
    """``current_row_group_size`` and ``current_file_size`` move as the
    reference's do."""
    rows = sample_rows(40, 8)
    seen = []
    for cls in (JaxFileWriter, FileWriter):
        w = cls(io.BytesIO(), SAMPLE, created_by=CREATED_BY)
        sizes = []
        for i, row in enumerate(rows):
            w.add_data(row)
            sizes.append((w.current_row_group_size(), w.current_file_size()))
            if i % 15 == 14:
                w.flush_row_group()
                sizes.append((w.current_row_group_size(),
                              w.current_file_size()))
        w.close()
        seen.append(sizes)
    assert seen[0] == seen[1]


@pytest.mark.parametrize("rescue", [False, True], ids=["footer", "rescue"])
def test_footer_logical_types_kept(tmp_path, rescue):
    """Every logical type of a footer (DATE, TIME, ENUM, JSON, BSON, MAP,
    UNKNOWN), a chunk's encoding stats and a row group's sorting columns
    survive the port's metadata: re-encoded, the footer is the file's
    own bytes, and a rescue copies them as the reference's does."""
    import struct

    from tpuparquet.format.metadata import (LogicalType, NullType,
                                            PageEncodingStats,
                                            SortingColumn)
    from tpuparquet.format.footer import read_file_metadata, write_footer

    schema = ("message m { required int32 d (DATE); optional int64 t "
              "(TIME(MICROS, true)); optional binary e (ENUM); optional "
              "binary j (JSON); optional binary b (BSON); optional int32 "
              "n; optional group mm (MAP) { repeated group key_value { "
              "required binary key (STRING); optional int32 value; } } }")
    buf = io.BytesIO()
    w = JaxFileWriter(buf, schema)
    w.add_data({"d": 3, "t": 5, "e": b"x", "j": b"{}", "b": b"\x00",
                "mm": {"key_value": [{"key": b"k", "value": 1}]}})
    w.close()
    meta = read_file_metadata(io.BytesIO(buf.getvalue()))
    meta.schema[6].logicalType = LogicalType(UNKNOWN=NullType())
    meta.row_groups[0].sorting_columns = [SortingColumn(
        column_idx=0, descending=False, nulls_first=True)]
    meta.row_groups[0].columns[0].meta_data.encoding_stats = [
        PageEncodingStats(page_type=0, encoding=0, count=1)]
    data = buf.getvalue()
    (flen,) = struct.unpack("<I", data[-8:-4])
    out = io.BytesIO()
    out.write(data[: len(data) - 8 - flen])
    write_footer(out, meta)
    blob = out.getvalue()
    (flen,) = struct.unpack("<I", blob[-8:-4])
    if not rescue:
        ours = FileReader(blob).meta
        assert ours.to_bytes() == blob[-8 - flen: -8]
        return
    from tpuparquet.cli import parquet_tool as jax_pt
    from tpuparquet_torch.cli import parquet_tool as pt

    src = tmp_path / "f.parquet"
    src.write_bytes(blob)
    got = []
    for name, mod in (("jax", jax_pt), ("port", pt)):
        dst = tmp_path / f"{name}.parquet"
        assert mod.main(["rescue", str(src), str(dst)]) == 0
        got.append(dst.read_bytes())
    assert got[1] == got[0]
