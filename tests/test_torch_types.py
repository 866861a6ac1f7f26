"""Every writable type and encoding: tpuparquet_torch against the JAX
package, buffer for buffer.

The matrix of ``tests/test_fallback_matrix.py`` — its ``TYPES`` x
``WRITABLE`` x dictionary on/off — crossed with {UNCOMPRESSED, SNAPPY} x
{data page V1, V2}, one parametrised case each.  A case's file holds
three columns of the type, all written with the encoding: a required
one, an optional one (about 20% nulls) and a LIST (0-3 elements a row,
null rows and null elements).  Each writer writes it, and each file is
read by both packages' ``read_row_groups_device`` (the port's on the
CPU): every padded buffer, ``bytes_staged`` and the routing counters
agree, and ``to_numpy()`` equals the JAX package's CPU oracle.  Then
the shapes the matrix leaves out — dictionaries of 16- and 9-byte rows
and of INT96 words, 9-byte rows by BYTE_STREAM_SPLIT — and, for the
slice as a whole, ``chip_smoke.py``'s Spark-style and parquet-mr v2
tables at 20,000 rows a group, against their generators too.
"""

import io
import itertools
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
from tpuparquet_torch.cpu.plain import ByteArrayColumn
from tpuparquet_torch.format.metadata import CompressionCodec, Encoding
from tpuparquet_torch.io.reader import FileReader
from tpuparquet_torch.io.writer import FileWriter
from tpuparquet_torch.kernels.device import device_column_from_jax_numpy, \
    read_row_groups_device
from tpuparquet_torch.stats import collect_stats

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
import chip_smoke  # noqa: E402

ROWS = 300
COUNTERS = ("pages_device_snappy", "pages_device_delta_lanes",
            "pages_device_planes")

# the matrix of tests/test_fallback_matrix.py
TYPES = {
    "boolean": "boolean",
    "int32": "int32",
    "int64": "int64",
    "int96": "int96",
    "float": "float",
    "double": "double",
    "binary": "binary",
    "flba4": "fixed_len_byte_array(4)",
}
WRITABLE = {
    "boolean": ["plain", "rle"],
    "int32": ["plain", "delta_bp", "bss"],
    "int64": ["plain", "delta_bp", "bss"],
    "int96": ["plain"],
    "float": ["plain", "bss"],
    "double": ["plain", "bss"],
    "binary": ["plain", "dlba", "dba"],
    "flba4": ["plain", "bss", "dba"],
}
ENC = {
    "plain": None,
    "delta_bp": "DELTA_BINARY_PACKED",
    "bss": "BYTE_STREAM_SPLIT",
    "dlba": "DELTA_LENGTH_BYTE_ARRAY",
    "dba": "DELTA_BYTE_ARRAY",
    "rle": "RLE",
}


def _values(tname: str, rng, n: int):
    """``n`` values of the type, in the writers' representation (binary:
    ``(offsets, data)``)."""
    if tname == "boolean":
        v = rng.random(n) < 0.3
        v[: n // 3] = True  # a run for the RLE encoder
        return v
    if tname in ("int32", "int64"):
        return rng.integers(0, 50, n).astype(np.int32 if tname == "int32"
                                             else np.int64)
    if tname == "int96":
        return rng.integers(0, 2**31, (n, 3)).astype(np.uint32)
    if tname == "float":
        return rng.random(n).astype(np.float32)
    if tname == "double":
        return rng.random(n)
    if tname == "binary":
        vals = [b"v%d" % (i % 40) for i in range(n)]
        offs = np.zeros(n + 1, dtype=np.int64)
        np.cumsum([len(v) for v in vals], out=offs[1:])
        return offs, np.frombuffer(b"".join(vals), np.uint8).copy()
    return rng.integers(0, 37, (n, 4)).astype(np.uint8)


def _schema(tname: str) -> str:
    t = TYPES[tname]
    return (f"message m {{ required {t} c; optional {t} o; "
            f"optional group r (LIST) {{ repeated group list {{ "
            f"optional {t} element; }} }} }}")


def _groups(tname: str):
    """One row group: ``(columns, masks, offsets, element masks)``."""
    rng = np.random.default_rng(sum(map(ord, tname)))
    o_mask = rng.random(ROWS) >= 0.2
    lens = rng.integers(0, 4, ROWS)
    r_mask = rng.random(ROWS) >= 0.05
    lens[~r_mask] = 0
    offs = np.zeros(ROWS + 1, dtype=np.int64)
    np.cumsum(lens, out=offs[1:])
    e_mask = rng.random(int(offs[-1])) >= 0.1
    cols = {"c": _values(tname, rng, ROWS),
            "o": _values(tname, rng, int(o_mask.sum())),
            "r": _values(tname, rng, int(e_mask.sum()))}
    return cols, {"o": o_mask, "r": r_mask}, {"r": offs}, {"r": e_mask}


def _write(writer: str, tname: str, ename: str, dict_on: bool, codec: str,
           v2: bool) -> bytes:
    cols, masks, offsets, elems = _groups(tname)
    if writer == "jax":
        cls, codecs, encs, bac = (JaxFileWriter, JaxCodec, JaxEncoding,
                                  JaxByteArrayColumn)
    else:
        cls, codecs, encs, bac = (FileWriter, CompressionCodec, Encoding,
                                  ByteArrayColumn)
    cols = {k: bac(*v) if isinstance(v, tuple) else v
            for k, v in cols.items()}
    enc = {} if ENC[ename] is None else {
        leaf: encs[ENC[ename]] for leaf in ("c", "o", "r.list.element")}
    buf = io.BytesIO()
    w = cls(buf, _schema(tname), codec=codecs[codec], data_page_v2=v2,
            allow_dict=dict_on, column_encodings=enc)
    w.write_columns(cols, masks=masks, offsets=offsets,
                    element_masks=elems)
    w.close()
    return buf.getvalue()


def _jax_buffers(col) -> dict:
    out = {"ptype": col.ptype, "num_values": col.num_values,
           "n_packed": col.n_packed, "type_length": col.type_length}
    for name, t in (("data", col._data_p), ("mask", col._mask_p),
                    ("positions", col._pos_p), ("rep_levels", col._rep_p),
                    ("def_levels", col._def_p), ("offsets", col.offsets)):
        out[name] = None if t is None else np.asarray(t)
    if col.offsets is not None:
        out["n_bytes"] = col.n_bytes
    return out


def _natives_present() -> bool:
    return jax_pack_native() is not None and jax_snappy_native() is not None


def read_both(blob: bytes, where: str):
    """Both packages' device reads of ``blob`` (the port's on the CPU),
    held buffer for buffer; returns ``(ours, our stats, JAX stats)``."""
    with jax_collect_stats() as jst:
        theirs = dict(jax_read_row_groups_device(
            JaxFileReader(io.BytesIO(blob))))
    with collect_stats() as st:
        ours = dict(read_row_groups_device(FileReader(blob), device="cpu"))
    assert ours.keys() == theirs.keys(), where
    for rg in ours:
        assert ours[rg].keys() == theirs[rg].keys(), where
        for name, col in ours[rg].items():
            ref = device_column_from_jax_numpy(_jax_buffers(theirs[rg][name]))
            at = f"{where} rg {rg} {name}"
            assert (col.ptype, col.type_length, col.num_values, col.n_packed,
                    col.n_bytes, col.lanes) == (
                ref.ptype, ref.type_length, ref.num_values, ref.n_packed,
                ref.n_bytes, ref.lanes), at
            a, b = col.padded_buffers(), ref.padded_buffers()
            assert a.keys() == b.keys(), at
            for k in a:
                assert a[k].dtype == b[k].dtype, (at, k)
                np.testing.assert_array_equal(a[k], b[k], err_msg=f"{at} {k}")
    if _natives_present():
        assert st.bytes_staged == jst.bytes_staged, where
        assert {k: getattr(st, k) for k in COUNTERS} == \
            {k: getattr(jst, k) for k in COUNTERS}, where
    return ours, st, jst


def assert_matches_oracle(ours, blob: bytes, where: str) -> None:
    """``to_numpy()`` of every column equals the JAX CPU oracle's."""
    oracle = JaxFileReader(io.BytesIO(blob))
    for rg, out in ours.items():
        want = oracle.read_row_group_arrays(rg)
        for name, col in out.items():
            vals, rep, dl = col.to_numpy()
            ref = want[name]
            at = f"{where} rg {rg} {name}"
            np.testing.assert_array_equal(rep, ref.rep_levels, err_msg=at)
            np.testing.assert_array_equal(dl, ref.def_levels, err_msg=at)
            if isinstance(ref.values, JaxByteArrayColumn):
                np.testing.assert_array_equal(vals.offsets,
                                              ref.values.offsets, err_msg=at)
                np.testing.assert_array_equal(vals.data, ref.values.data,
                                              err_msg=at)
            else:
                want_v = np.asarray(ref.values)
                assert vals.dtype == want_v.dtype, at
                assert vals.shape == want_v.shape, at
                np.testing.assert_array_equal(vals, want_v, err_msg=at)


def _combos():
    for tname, encs in WRITABLE.items():
        for ename in encs:
            for dict_on in ((False, True) if ename == "plain" else (False,)):
                for codec, v2 in itertools.product(
                        ("UNCOMPRESSED", "SNAPPY"), (False, True)):
                    yield tname, ename, dict_on, codec, v2


@pytest.mark.parametrize("tname,ename,dict_on,codec,v2", list(_combos()))
def test_type_matrix_matches_jax(tname, ename, dict_on, codec, v2):
    where = f"{tname}/{ename}/dict={dict_on}/{codec}/v2={v2}"
    blobs = {w: _write(w, tname, ename, dict_on, codec, v2)
             for w in ("jax", "port")}
    for writer, blob in blobs.items():
        ours, _, _ = read_both(blob, f"{where} written by {writer}")
        assert_matches_oracle(ours, blob, f"{where} written by {writer}")
    # the port writes what the JAX writer writes: the same pages
    meta = [FileReader(b).meta.row_groups[0].columns for b in blobs.values()]
    for a, b in zip(*meta):
        assert (a.meta_data.encodings, a.meta_data.num_values,
                a.meta_data.dictionary_page_offset is None) == \
            (b.meta_data.encodings, b.meta_data.num_values,
             b.meta_data.dictionary_page_offset is None), where


WIDE = """message m {
    required fixed_len_byte_array(16) d16;
    optional fixed_len_byte_array(9) d9;
    required fixed_len_byte_array(9) s9;
    optional int96 t;
}"""


@pytest.mark.parametrize("v2", [False, True])
@pytest.mark.parametrize("writer", ["jax", "port"])
def test_wide_rows_match_jax(writer, v2):
    """Dictionaries of 16- and 9-byte rows (K3 at 4 and 3 lanes, the
    dictionary staged padded to no multiple of its lanes) and of INT96
    words, and 9-byte rows by BYTE_STREAM_SPLIT (K12 with k = 9 over 3
    lanes), SNAPPY."""
    rng = np.random.default_rng(9)
    n = 5000
    mask = rng.random(n) >= 0.25
    k = int(mask.sum())
    vocab16 = rng.integers(0, 256, (37, 16), dtype=np.uint8)
    vocab9 = rng.integers(0, 256, (11, 9), dtype=np.uint8)
    cols = {"d16": vocab16[rng.integers(0, 37, n)],
            "d9": vocab9[rng.integers(0, 11, k)],
            "s9": rng.integers(0, 256, (n, 9), dtype=np.uint8),
            "t": rng.integers(0, 7, (k, 3)).astype(np.uint32)}
    masks = {"d9": mask, "t": mask}
    buf = io.BytesIO()
    if writer == "jax":
        w = JaxFileWriter(buf, WIDE, codec=JaxCodec.SNAPPY, data_page_v2=v2,
                          column_encodings={
                              "s9": JaxEncoding.BYTE_STREAM_SPLIT})
    else:
        w = FileWriter(buf, WIDE, codec=CompressionCodec.SNAPPY,
                       data_page_v2=v2, column_encodings={
                           "s9": Encoding.BYTE_STREAM_SPLIT})
    w.write_columns(cols, masks=masks)
    w.close()
    blob = buf.getvalue()
    meta = FileReader(blob).meta.row_groups[0].columns
    assert [cc.meta_data.dictionary_page_offset is not None
            for cc in meta] == [True, True, False, True]
    ours, _, _ = read_both(blob, f"wide rows by {writer}")
    assert_matches_oracle(ours, blob, f"wide rows by {writer}")
    assert [ours[0][c].lanes for c in cols] == [4, 3, 3, 3]
    for name, want in cols.items():
        np.testing.assert_array_equal(ours[0][name].to_numpy()[0], want)


def _tables():
    # (generator's groups, schema, encodings, data page v2, planes pages)
    yield "spark", (chip_smoke.spark_groups(20_000, 2),
                    chip_smoke.SPARK_SCHEMA, {}, False, 2)
    yield "mr_v2", (chip_smoke.mr_v2_groups(20_000, 1),
                    chip_smoke.MR_V2_SCHEMA, chip_smoke.MR_V2_ENCODINGS,
                    True, 0)


@pytest.mark.parametrize("writer", ["jax", "port"])
@pytest.mark.parametrize("table", ["spark", "mr_v2"])
def test_chip_smoke_tables_match_jax(table, writer):
    """The slice as a whole: ``chip_smoke.py``'s Spark-style table (INT96
    planes and dictionary, optional BOOLEAN, DECIMAL and UUID rows; V1)
    and parquet-mr v2 table (RLE booleans, front-coded strings and
    DECIMAL rows, length-coded notes; V2) at 20,000 rows a group, written
    by each writer and read by both packages, against the generator."""
    groups, schema, encs, v2, planes = dict(_tables())[table]
    buf = io.BytesIO()
    if writer == "jax":
        w = JaxFileWriter(buf, schema, codec=JaxCodec.SNAPPY,
                          data_page_v2=v2, column_encodings={
                              k: JaxEncoding[v] for k, v in encs.items()})
        conv = JaxByteArrayColumn
    else:
        w = FileWriter(buf, schema, codec=CompressionCodec.SNAPPY,
                       data_page_v2=v2, column_encodings={
                           k: Encoding[v] for k, v in encs.items()})
        conv = ByteArrayColumn
    for cols, masks in groups:
        w.write_columns({k: conv(*v) if isinstance(v, tuple) else v
                         for k, v in cols.items()}, masks=masks)
    w.close()
    blob = buf.getvalue()
    ours, st, _ = read_both(blob, f"{table} by {writer}")
    assert_matches_oracle(ours, blob, f"{table} by {writer}")
    assert st.pages_device_planes == planes
    for rg, (cols, masks) in enumerate(groups):
        for name, want in cols.items():
            got, _, dl = ours[rg][name].to_numpy()
            if isinstance(want, tuple):
                np.testing.assert_array_equal(got.offsets, want[0])
                np.testing.assert_array_equal(got.data, want[1])
            else:
                np.testing.assert_array_equal(got, want)
            if name in masks:
                np.testing.assert_array_equal(dl, masks[name])
