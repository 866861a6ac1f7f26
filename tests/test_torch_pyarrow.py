"""Files pyarrow writes, read by tpuparquet_torch and the JAX package.

Each file is read by both packages' ``read_row_groups_device`` (the
port's on the CPU) and held buffer for buffer, with ``bytes_staged`` and
the routing counters (``test_torch_types.read_both``), and ``to_numpy()``
against the JAX CPU oracle.  The cases: all-null fixed-width columns,
which pyarrow writes with an empty dictionary page (the port used to
refuse the empty dictionary); an empty table (whose chunk holds no data
buffer in the reference); and the probe's tables that read equal
already: a 13-column table in V1 and V2, NONE and SNAPPY, dictionary on
and off, INT96 timestamps, unsigned integers and float16.
"""

import io
import itertools

import numpy as np
import pyarrow as pa
import pyarrow.parquet as pq
import pytest
import torch

from tpuparquet.io.reader import FileReader as JaxFileReader
from tpuparquet.kernels.device import read_row_groups_device as \
    jax_read_row_groups_device
from tpuparquet_torch.io.reader import FileReader
from tpuparquet_torch.kernels.device import read_row_groups_device

from test_torch_types import assert_matches_oracle, read_both  # noqa: E402


def _pyarrow(table: pa.Table, **kw) -> bytes:
    buf = io.BytesIO()
    pq.write_table(table, buf, **kw)
    return buf.getvalue()


NULL_TYPES = {
    "int32": (pa.int32(), {}),
    "int64": (pa.int64(), {}),
    "double": (pa.float64(), {}),
    "binary16": (pa.binary(16), {}),
    "int96": (pa.timestamp("ns"), {"use_deprecated_int96_timestamps": True}),
}


@pytest.mark.parametrize("n", [1, 3000])
@pytest.mark.parametrize("tname", list(NULL_TYPES))
def test_all_null_column_with_empty_dictionary(tname, n):
    """An all-null fixed-width column: pyarrow writes an empty dictionary
    page and a data page of nulls.  The reference reads it (``n_packed``
    0, a 0-length ``data``); so does the port, without touching the
    empty dictionary."""
    t, kw = NULL_TYPES[tname]
    blob = _pyarrow(pa.table({"c": pa.array([None] * n, t)}),
                    compression="SNAPPY", **kw)
    cm = FileReader(blob).meta.row_groups[0].columns[0].meta_data
    assert cm.dictionary_page_offset is not None
    ours, _, _ = read_both(blob, f"all-null {tname} x{n}")
    assert_matches_oracle(ours, blob, f"all-null {tname} x{n}")
    col = ours[0]["c"]
    assert (col.n_packed, col.num_values) == (0, n)
    assert col.data.numel() == 0
    assert not col.mask.any()


def test_empty_table_buffer_keys():
    """A 0-row row group: the reference keeps no data buffer, so the
    port's ``padded_buffers()`` has no ``data`` key either; ``data``
    still reads as a 0-length tensor."""
    blob = _pyarrow(pa.table({"c": pa.array([], pa.int64())}))
    ours, _, _ = read_both(blob, "empty int64 table")
    col = ours[0]["c"]
    theirs = dict(jax_read_row_groups_device(
        JaxFileReader(io.BytesIO(blob))))[0]["c"]
    assert theirs._data_p is None
    assert col.padded_buffers() == {}
    assert col.data.numel() == 0 and col.data.dtype == torch.int32
    vals, rep, dl = col.to_numpy()
    assert vals.size == rep.size == dl.size == 0


def _probe_table(n: int = 2000) -> pa.Table:
    """The probe's 13-column table: plain and nullable numbers,
    dictionary and unique strings, a nullable boolean, fixed-size bytes,
    a decimal, a list, a timestamp, int16 and date32."""
    rng = np.random.default_rng(25)
    null = rng.random(n) < 0.2

    def masked(a):
        return pa.array(a, mask=null)

    words = np.array(["alpha", "beta", "gamma", "delta"])
    lists = [list(range(int(k))) if k >= 0 else None
             for k in rng.integers(-1, 4, n)]
    return pa.table({
        "i32": pa.array(rng.integers(-1000, 1000, n, dtype=np.int32)),
        "i64n": masked(rng.integers(-2**40, 2**40, n)),
        "f32": pa.array(rng.random(n).astype(np.float32)),
        "f64n": masked(rng.random(n)),
        "dict_s": pa.array(words[rng.integers(0, 4, n)]),
        "uniq_s": pa.array([f"row-{i}-{rng.integers(1e9)}" for i in range(n)]),
        "bool_n": masked(rng.random(n) < 0.5),
        "b16": pa.array([rng.bytes(16) for _ in range(n)], pa.binary(16)),
        "dec": pa.array([None if k % 7 == 0 else k for k in range(n)],
                        pa.decimal128(38, 2)),
        "lst": pa.array(lists, pa.list_(pa.int64())),
        "ts": pa.array(rng.integers(0, 2**60, n), pa.timestamp("ns")),
        "i16": pa.array(rng.integers(-300, 300, n).astype(np.int16)),
        "d32": pa.array(rng.integers(0, 20000, n).astype(np.int32),
                        pa.date32()),
    })


@pytest.mark.parametrize("version,codec,dict_on", list(itertools.product(
    ("1.0", "2.0"), ("NONE", "SNAPPY"), (True, False))))
def test_probe_table_matches_jax(version, codec, dict_on):
    blob = _pyarrow(_probe_table(), compression=codec, use_dictionary=dict_on,
                    data_page_version=version)
    where = f"probe v{version} {codec} dict={dict_on}"
    ours, _, _ = read_both(blob, where)
    assert_matches_oracle(ours, blob, where)


def test_int96_unsigned_and_float16_match_jax():
    rng = np.random.default_rng(26)
    n = 1500
    table = pa.table({
        "ts96": pa.array(rng.integers(0, 2**60, n), pa.timestamp("ns")),
        "u8": pa.array(rng.integers(0, 256, n).astype(np.uint8)),
        "u32": pa.array(rng.integers(0, 2**32, n, dtype=np.uint64)
                        .astype(np.uint32)),
        "u64": pa.array(rng.integers(0, 2**64 - 1, n, dtype=np.uint64)),
        "f16": pa.array(rng.random(n).astype(np.float16)),
    })
    blob = _pyarrow(table, compression="SNAPPY",
                    use_deprecated_int96_timestamps=True)
    ours, _, _ = read_both(blob, "int96/unsigned/float16")
    assert_matches_oracle(ours, blob, "int96/unsigned/float16")
    got = dict(read_row_groups_device(FileReader(blob), device="cpu"))
    np.testing.assert_array_equal(
        got[0]["u64"].to_numpy()[0].view(np.uint64),
        table.column("u64").to_numpy())
