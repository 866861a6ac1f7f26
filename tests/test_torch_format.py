"""Host layers of tpuparquet_torch against the JAX package: thrift footer,
snappy, and files crossing between the two writers and readers."""

import io

import numpy as np
import pytest

from tpuparquet import CompressionCodec as JaxCodec
from tpuparquet import FileWriter as JaxFileWriter
from tpuparquet.compress import compress_block as jax_compress
from tpuparquet.compress import decompress_block as jax_decompress
from tpuparquet.format.footer import read_file_metadata as jax_read_footer
from tpuparquet.io.reader import FileReader as JaxFileReader
from tpuparquet_torch.compress import compress_block, decompress_block
from tpuparquet_torch.errors import CorruptFooterError
from tpuparquet_torch.format.footer import read_file_metadata
from tpuparquet_torch.format.metadata import CompressionCodec, ThriftStruct
from tpuparquet_torch.format.schema import Schema
from tpuparquet_torch.io.reader import FileReader
from tpuparquet_torch.io.writer import FileWriter
from tpuparquet_torch.kernels.device import read_row_groups_device

SCHEMA = """message m {
    required int64 ts;
    required int32 code;
    optional int32 kind;
    optional int64 amount;
}"""


def _columns(seed: int, rows: int):
    rng = np.random.default_rng(seed)
    kind_mask = rng.random(rows) >= 0.1
    amount_mask = rng.random(rows) >= 0.3
    cols = {
        "ts": 1_600_000_000_000 + rng.integers(0, 1000, rows).cumsum(),
        "code": rng.integers(-3, 4, rows, dtype=np.int32),
        "kind": rng.integers(0, 9, int(kind_mask.sum()), dtype=np.int32),
        "amount": rng.integers(-2**62, 2**62, int(amount_mask.sum())),
    }
    return cols, {"kind": kind_mask, "amount": amount_mask}


def _write(writer_cls, codec, groups):
    buf = io.BytesIO()
    w = writer_cls(buf, SCHEMA, codec=codec)
    for cols, masks in groups:
        w.write_columns(cols, masks=masks)
    w.close()
    return buf.getvalue()


def _same_struct(a, b, where="FileMetaData"):
    """Every field the port declares equals the JAX package's."""
    for name in a._NAMES:
        x, y = getattr(a, name), getattr(b, name)
        at = f"{where}.{name}"
        if isinstance(x, ThriftStruct):
            _same_struct(x, y, at)
        elif isinstance(x, list) and x and isinstance(x[0], ThriftStruct):
            assert len(x) == len(y), at
            for i, (p, q) in enumerate(zip(x, y)):
                _same_struct(p, q, f"{at}[{i}]")
        elif isinstance(x, list):
            assert [int(v) if hasattr(v, "value") else v for v in x] == \
                [int(v) if hasattr(v, "value") else v for v in y], at
        else:
            assert (x is None and y is None) or x == y, at


def test_jax_footer_decodes_to_equal_fields():
    groups = [_columns(s, 3000) for s in (1, 2)]
    blob = _write(JaxFileWriter, JaxCodec.SNAPPY, groups)
    ours = read_file_metadata(io.BytesIO(blob))
    _same_struct(ours, jax_read_footer(io.BytesIO(blob)))
    schema = Schema.from_elements(ours.schema)
    assert [(n.flat_name, n.max_def_level) for n in schema.leaves] == [
        ("ts", 0), ("code", 0), ("kind", 1), ("amount", 1)]


def test_truncated_footer_rejected():
    blob = _write(FileWriter, CompressionCodec.SNAPPY, [_columns(3, 100)])
    with pytest.raises(CorruptFooterError):
        read_file_metadata(io.BytesIO(blob[:-3]))


@pytest.mark.parametrize("kind", ["random", "repetitive", "empty", "short"])
def test_snappy_round_trips_against_jax(kind):
    rng = np.random.default_rng(5)
    data = {
        "random": rng.integers(0, 256, 50_000, dtype=np.uint8).tobytes(),
        "repetitive": np.tile(rng.integers(0, 256, 37, dtype=np.uint8),
                              3000).tobytes(),
        "empty": b"",
        "short": b"abc",
    }[kind]
    ours = compress_block(CompressionCodec.SNAPPY, data)
    assert bytes(jax_decompress(JaxCodec.SNAPPY, ours, len(data))) == data
    theirs = jax_compress(JaxCodec.SNAPPY, data)
    assert decompress_block(CompressionCodec.SNAPPY, theirs,
                            len(data)).tobytes() == data


def test_snappy_corrupt_block_raises():
    blob = compress_block(CompressionCodec.SNAPPY, b"x" * 1000)
    with pytest.raises(ValueError):
        decompress_block(CompressionCodec.SNAPPY, blob[:-2], 1000)


@pytest.mark.parametrize("codec", ["UNCOMPRESSED", "SNAPPY"])
def test_port_file_reads_back_through_jax(codec):
    groups = [_columns(s, 4000) for s in (7, 8)]
    blob = _write(FileWriter, CompressionCodec[codec], groups)
    r = JaxFileReader(io.BytesIO(blob))
    assert r.row_group_count() == 2
    for rg, (cols, masks) in enumerate(groups):
        chunks = r.read_row_group_arrays(rg)
        for name, want in cols.items():
            np.testing.assert_array_equal(np.asarray(chunks[name].values),
                                          want)
            if name in masks:
                np.testing.assert_array_equal(chunks[name].def_levels,
                                              masks[name].astype(np.int32))


@pytest.mark.parametrize("codec", ["UNCOMPRESSED", "SNAPPY"])
def test_jax_file_reads_back_through_port(codec):
    groups = [_columns(s, 4000) for s in (9, 10)]
    blob = _write(JaxFileWriter, JaxCodec[codec], groups)
    r = FileReader(blob)
    for rg, out in read_row_groups_device(r, device="cpu"):
        cols, masks = groups[rg]
        for name, want in cols.items():
            vals, rep, dl = out[name].to_numpy()
            np.testing.assert_array_equal(vals, want)
            assert not rep.any()
            if name in masks:
                np.testing.assert_array_equal(dl, masks[name].astype(
                    np.int32))
                np.testing.assert_array_equal(out[name].mask.numpy(),
                                              masks[name])


def test_port_writer_policy_matches_jax_encodings():
    """Same dictionary decision per chunk as the JAX writer."""
    groups = [_columns(11, 5000)]
    ours = read_file_metadata(io.BytesIO(
        _write(FileWriter, CompressionCodec.SNAPPY, groups)))
    theirs = jax_read_footer(io.BytesIO(
        _write(JaxFileWriter, JaxCodec.SNAPPY, groups)))
    for a, b in zip(ours.row_groups[0].columns, theirs.row_groups[0].columns):
        assert [int(e) for e in a.meta_data.encodings] == \
            [int(e) for e in b.meta_data.encodings]
        assert (a.meta_data.dictionary_page_offset is None) == \
            (b.meta_data.dictionary_page_offset is None)


@pytest.mark.parametrize("ann,ptype,vals", [
    ("INT(64, false)", "int64", np.array([1, -1, 5], np.int64)),
    ("INT(32, false)", "int32", np.array([7, -2, 3, 0], np.int32)),
    ("INT(16, false)", "int32", np.array([40000, 3, 65535], np.int32)),
    ("INT(8, true)", "int32", np.array([-100, 3, 127], np.int32)),
    ("INT(64,true)", "int64", np.array([5, -9, 2], np.int64)),
])
@pytest.mark.parametrize("allow_dict", [False, True])
def test_int_annotation_stats_match_jax(ann, ptype, vals, allow_dict):
    """``INT(bits, signed)`` sets the INTEGER logical and INT_n/UINT_n
    converted types as the JAX DSL does; an unsigned column's chunk
    statistics order as unsigned, keep the signed storage bytes and
    carry no deprecated min/max — over the values or their dictionary,
    equal to the JAX writer's."""
    schema = f"message m {{ required {ptype} u ({ann}); }}"
    metas = []
    for cls, codec in ((FileWriter, CompressionCodec), (JaxFileWriter,
                                                        JaxCodec)):
        buf = io.BytesIO()
        w = cls(buf, schema, codec=codec.SNAPPY, allow_dict=allow_dict)
        w.write_columns({"u": vals})
        w.close()
        metas.append(JaxFileReader(io.BytesIO(buf.getvalue())).meta)
    ours, theirs = metas
    _same_struct(ours.schema[1], theirs.schema[1], "SchemaElement")
    a = ours.row_groups[0].columns[0].meta_data
    b = theirs.row_groups[0].columns[0].meta_data
    assert a.statistics == b.statistics
    assert a.encodings == b.encodings
    if "false" in ann:
        u = vals.view(np.uint32 if ptype == "int32" else np.uint64)
        assert a.statistics.min_value == vals[np.argmin(u)].tobytes()
        assert a.statistics.max_value == vals[np.argmax(u)].tobytes()
        assert a.statistics.min is None


def test_unsigned_leaf_takes_logical_values():
    """An unsigned leaf takes its logical values (uint64 above 2^63) or
    their signed storage, and writes the same file either way."""
    logical = np.array([1, 2**64 - 1, 2**63 + 5], np.uint64)
    blobs = []
    for vals in (logical, logical.view(np.int64)):
        buf = io.BytesIO()
        with FileWriter(buf, "message m { required int64 u (INT(64, "
                        "false)); }") as w:
            w.write_columns({"u": vals})
        blobs.append(buf.getvalue())
    assert blobs[0] == blobs[1]
    with pytest.raises(ValueError, match="out of range"):
        FileWriter(io.BytesIO(), "message m { required int64 s; }") \
            .write_columns({"s": logical})


@pytest.mark.parametrize("text,err", [
    ("message m { required int32 u (INT(64, false)); }", "INT(64"),
    ("message m { required int64 u (INT(12, true)); }", "bitwidth 12"),
    ("message m { required int64 u (INT(64, maybe)); }", "boolean"),
])
def test_int_annotation_rejects_bad_forms(text, err):
    with pytest.raises(ValueError, match=err.replace("(", r"\(")):
        Schema.from_string(text)
