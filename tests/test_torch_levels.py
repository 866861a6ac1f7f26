"""V1 pages whose levels use the deprecated BIT_PACKED encoding.

Neither writer writes them, so each page is built by hand: the levels
MSB-first (the JAX package's ``pack_msb``), then PLAIN values, in a V1
data page whose header names BIT_PACKED.  The port decodes those levels
on the host, as the reference does (``tpuparquet/cpu/levels.py``
``decode_levels_bitpacked``), stages them as they are, and its read
equals the JAX package's buffer for buffer and its CPU oracle.
"""

import io

import numpy as np
import pytest

from tpuparquet.cpu.bitpack import pack_msb
from tpuparquet.cpu.levels import decode_levels_bitpacked as \
    jax_decode_levels_bitpacked
from tpuparquet_torch.cpu.levels import decode_levels_bitpacked
from tpuparquet_torch.format.footer import MAGIC, write_footer
from tpuparquet_torch.format.metadata import ColumnChunk, ColumnMetaData, \
    CompressionCodec, DataPageHeader, Encoding, FileMetaData, PageHeader, \
    PageType, RowGroup, Type
from tpuparquet_torch.format.schema import Schema
from tpuparquet_torch.io.pages import _header_bytes

from test_torch_types import assert_matches_oracle, read_both  # noqa: E402


@pytest.mark.parametrize("max_level", [1, 2, 3, 5, 7])
@pytest.mark.parametrize("n", [1, 7, 8, 1001])
def test_host_decoder_matches_jax(max_level, n):
    rng = np.random.default_rng(max_level * 1000 + n)
    levels = rng.integers(0, max_level + 1, n)
    data = pack_msb(levels, int(max_level).bit_length())
    got = decode_levels_bitpacked(data, n, max_level)
    assert got.dtype == np.int32
    np.testing.assert_array_equal(
        got, jax_decode_levels_bitpacked(data, n, max_level))
    np.testing.assert_array_equal(got, levels)


def test_host_decoder_rejects_what_jax_rejects():
    data = pack_msb(np.array([0, 3, 1]), 2)
    for fn in (decode_levels_bitpacked, jax_decode_levels_bitpacked):
        with pytest.raises(ValueError, match="exceeds max level"):
            fn(data, 3, 2)
        with pytest.raises(ValueError, match="too short"):
            fn(data[:0], 3, 2)


def _bitpacked_file(schema: str, ptype: Type, values: np.ndarray, dl,
                    rep=None) -> bytes:
    """One row group of one column: a V1 data page, UNCOMPRESSED, its rep
    and def levels BIT_PACKED, its values PLAIN."""
    sch = Schema.from_string(schema)
    leaf = sch.leaves[0]
    body = b""
    if rep is not None:
        body += pack_msb(rep, int(leaf.max_rep_level).bit_length())
    body += pack_msb(dl, int(leaf.max_def_level).bit_length())
    body += np.ascontiguousarray(values).tobytes()
    hdr = _header_bytes(PageHeader(
        type=PageType.DATA_PAGE, uncompressed_page_size=len(body),
        compressed_page_size=len(body),
        data_page_header=DataPageHeader(
            num_values=len(dl), encoding=Encoding.PLAIN,
            definition_level_encoding=Encoding.BIT_PACKED,
            repetition_level_encoding=Encoding.BIT_PACKED)))
    size = len(hdr) + len(body)
    rows = len(dl) if rep is None else int((np.asarray(rep) == 0).sum())
    cm = ColumnMetaData(
        type=ptype, encodings=[Encoding.BIT_PACKED, Encoding.PLAIN],
        path_in_schema=list(leaf.path), codec=CompressionCodec.UNCOMPRESSED,
        num_values=len(dl), total_uncompressed_size=size,
        total_compressed_size=size, data_page_offset=len(MAGIC))
    buf = io.BytesIO()
    buf.write(MAGIC + hdr + body)
    write_footer(buf, FileMetaData(
        version=1, schema=sch.to_elements(), num_rows=rows,
        row_groups=[RowGroup(columns=[ColumnChunk(file_offset=len(MAGIC),
                                                  meta_data=cm)],
                             total_byte_size=size, num_rows=rows)]))
    return buf.getvalue()


@pytest.mark.parametrize("n", [1, 40, 3000])
def test_flat_optional_column_reads_like_jax(n):
    rng = np.random.default_rng(n)
    dl = (rng.random(n) >= 0.3).astype(np.int64)
    vals = rng.integers(-2**31, 2**31, int(dl.sum())).astype(np.int32)
    blob = _bitpacked_file("message m { optional int32 v; }", Type.INT32,
                           vals, dl)
    ours, _, _ = read_both(blob, f"bit-packed def levels x{n}")
    assert_matches_oracle(ours, blob, f"bit-packed def levels x{n}")
    got, _, got_dl = ours[0]["v"].to_numpy()
    np.testing.assert_array_equal(got, vals)
    np.testing.assert_array_equal(got_dl, dl)


def test_list_column_reads_like_jax():
    """Rep and def levels both BIT_PACKED (max rep 1, max def 3)."""
    rng = np.random.default_rng(4)
    rows = 700
    counts = rng.integers(0, 4, rows)
    rep, dl = [], []
    for c in counts:
        if c == 0:
            rep.append(0)
            dl.append(int(rng.integers(0, 2)))  # a null or an empty row
        for j in range(c):
            rep.append(0 if j == 0 else 1)
            dl.append(3 if rng.random() >= 0.1 else 2)
    rep, dl = np.array(rep), np.array(dl)
    vals = rng.integers(-2**62, 2**62, int((dl == 3).sum()))
    blob = _bitpacked_file(
        "message m { optional group l (LIST) { repeated group list { "
        "optional int64 element; } } }", Type.INT64, vals, dl, rep)
    ours, _, _ = read_both(blob, "bit-packed list levels")
    assert_matches_oracle(ours, blob, "bit-packed list levels")
    got, got_rep, got_dl = ours[0]["l.list.element"].to_numpy()
    np.testing.assert_array_equal(got, vals)
    np.testing.assert_array_equal(got_rep, rep)
    np.testing.assert_array_equal(got_dl, dl)
