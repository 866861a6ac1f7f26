"""The page CRC switches, held against the JAX package: on the read side
``FileReader(verify_crc=)`` and ``TPQ_PAGE_CRC_VERIFY``, on the write
side ``FileWriter(page_crc=)`` and ``TPQ_PAGE_CRC``.

A file with one flipped byte in a data page reads in both packages when
the check is off (the same, wrong, values) and raises in both when it is
on; where both reads finish, ``pages_crc_verified`` and
``crc_mismatches`` count the same in both.
"""

import io

import numpy as np
import pytest

from tpuparquet import CompressionCodec as JaxCodec
from tpuparquet import FileWriter as JaxFileWriter
from tpuparquet.errors import CorruptPageError as JaxCorruptPageError
from tpuparquet.io.reader import FileReader as JaxFileReader
from tpuparquet.kernels.device import read_row_groups_device as \
    jax_read_row_groups_device
from tpuparquet.stats import collect_stats as jax_collect_stats
from tpuparquet_torch.errors import CorruptPageError
from tpuparquet_torch.format.compact import CompactReader
from tpuparquet_torch.format.metadata import CompressionCodec, PageHeader, \
    decode_struct
from tpuparquet_torch.io.reader import FileReader
from tpuparquet_torch.io.writer import FileWriter
from tpuparquet_torch.kernels.device import read_row_groups_device
from tpuparquet_torch.stats import collect_stats

COUNTERS = ("pages_crc_verified", "crc_mismatches")


def _file() -> bytes:
    """Two row groups of a PLAIN int64 column (distinct values: no
    dictionary) beside an optional int32, UNCOMPRESSED, page CRCs on."""
    rng = np.random.default_rng(5)
    buf = io.BytesIO()
    w = JaxFileWriter(buf, "message m { required int64 a; optional int32 b; }",
                      codec=JaxCodec.UNCOMPRESSED)
    for _ in range(2):
        for i in range(300):
            row = {"a": int(rng.integers(-2**40, 2**40))}
            if i % 4:
                row["b"] = int(rng.integers(0, 1000))
            w.add_data(row)
        w.flush_row_group()
    w.close()
    return buf.getvalue()


def _flipped() -> bytes:
    """The file with the last byte of row group 1's ``a`` data page (the
    high byte of its last value) flipped: the page still decodes."""
    blob = bytearray(_file())
    cm = FileReader(bytes(blob)).meta.row_groups[1].columns[0].meta_data
    blob[cm.data_page_offset + cm.total_compressed_size - 1] ^= 0x40
    return bytes(blob)


def _read_both(blob: bytes, **kw):
    """``(ours, theirs, our counters, their counters)``; each side's
    values per row group and column."""
    with jax_collect_stats() as jst:
        theirs = {rg: {k: c.to_numpy() for k, c in cols.items()}
                  for rg, cols in jax_read_row_groups_device(
                      JaxFileReader(io.BytesIO(blob), **kw))}
    with collect_stats() as st:
        ours = {rg: {k: c.to_numpy() for k, c in cols.items()}
                for rg, cols in read_row_groups_device(
                    FileReader(blob, **kw), device="cpu")}
    return (ours, theirs, {k: getattr(st, k) for k in COUNTERS},
            {k: getattr(jst, k) for k in COUNTERS})


def _assert_same(ours, theirs):
    assert ours.keys() == theirs.keys()
    for rg in ours:
        assert ours[rg].keys() == theirs[rg].keys()
        for name in ours[rg]:
            for a, b in zip(ours[rg][name], theirs[rg][name]):
                np.testing.assert_array_equal(np.asarray(a), np.asarray(b),
                                              err_msg=f"rg {rg} {name}")


def test_intact_file_counts_verified_pages_as_reference():
    ours, theirs, st, jst = _read_both(_file())
    _assert_same(ours, theirs)
    assert st == jst
    assert st["pages_crc_verified"] > 0 and st["crc_mismatches"] == 0


@pytest.mark.parametrize("how", ["argument", "environment"])
def test_switch_off_reads_bad_crc_as_reference(how, monkeypatch):
    kw = {}
    if how == "argument":
        kw["verify_crc"] = False
    else:
        monkeypatch.setenv("TPQ_PAGE_CRC_VERIFY", "0")
    blob = _flipped()
    ours, theirs, st, jst = _read_both(blob, **kw)
    _assert_same(ours, theirs)
    assert st == jst == {"pages_crc_verified": 0, "crc_mismatches": 0}
    # the flip reached the values: they differ from the intact file's
    intact, _, _, _ = _read_both(_file(), **kw)
    assert not np.array_equal(ours[1]["a"][0], intact[1]["a"][0])


@pytest.mark.parametrize("kw", [{}, {"verify_crc": True}])
def test_switch_on_raises_as_reference(kw, monkeypatch):
    """Both raise.  Both device reads plan each column on a pool worker
    under a collector of its own and merge a task's counters only when
    the task succeeds, so the failing column's mismatch is dropped and
    both counts stay 0."""
    if not kw:
        monkeypatch.setenv("TPQ_PAGE_CRC_VERIFY", "1")
    blob = _flipped()
    with jax_collect_stats() as jst:
        with pytest.raises(JaxCorruptPageError):
            list(jax_read_row_groups_device(
                JaxFileReader(io.BytesIO(blob), **kw)))
    with collect_stats() as st:
        with pytest.raises(CorruptPageError, match="CRC"):
            list(read_row_groups_device(FileReader(blob, **kw),
                                        device="cpu"))
    assert st.crc_mismatches == 0 and jst.crc_mismatches == 0


def test_argument_overrides_environment(monkeypatch):
    monkeypatch.setenv("TPQ_PAGE_CRC_VERIFY", "0")
    with pytest.raises(CorruptPageError):
        list(read_row_groups_device(FileReader(_flipped(), verify_crc=True),
                                    device="cpu"))


def _columns() -> dict:
    """5,000 rows of ``required int64 a; required double b``."""
    rng = np.random.default_rng(0)
    return {"a": rng.integers(0, 1000, 5000).astype(np.int64),
            "b": rng.random(5000)}


def _write_pair(**kw) -> tuple[bytes, bytes]:
    """The same rows from the port's and the JAX package's writer, SNAPPY,
    other options at their defaults: ``(ours, theirs)``."""
    schema = "message m { required int64 a; required double b; }"
    out = []
    for writer, codec in ((FileWriter, CompressionCodec.SNAPPY),
                          (JaxFileWriter, JaxCodec.SNAPPY)):
        buf = io.BytesIO()
        w = writer(buf, schema, codec=codec, **kw)
        w.write_columns(_columns())
        w.close()
        out.append(buf.getvalue())
    return out[0], out[1]


def _crc_field_bytes(blob: bytes) -> tuple[int, int]:
    """``(page headers that carry a CRC, bytes of those CRC fields)``:
    each header re-encoded with and without its CRC."""
    n = size = 0
    for rg in FileReader(blob).meta.row_groups:
        for cc in rg.columns:
            cm = cc.meta_data
            start = cm.data_page_offset
            if cm.dictionary_page_offset is not None:
                start = min(start, cm.dictionary_page_offset)
            r = CompactReader(blob, start, start + cm.total_compressed_size)
            while r.pos < r.end:
                ph = decode_struct(PageHeader, r)
                r.pos += ph.compressed_page_size
                if ph.crc is not None:
                    with_crc = len(ph.to_bytes())
                    ph.crc = None
                    n += 1
                    size += with_crc - len(ph.to_bytes())
    return n, size


def test_writer_environment_drops_page_crc_as_reference(monkeypatch):
    """Under ``TPQ_PAGE_CRC=0`` neither writer puts a CRC in a page
    header, and each file shrinks by exactly its CRC fields' bytes;
    ``page_crc=True`` beats the variable."""
    monkeypatch.delenv("TPQ_PAGE_CRC", raising=False)
    with_crc = _write_pair()
    monkeypatch.setenv("TPQ_PAGE_CRC", "0")
    without = _write_pair()
    forced = _write_pair(page_crc=True)
    for side, on, off, on_again in zip(("port", "jax"), with_crc, without,
                                       forced):
        n, size = _crc_field_bytes(on)
        assert n > 0 and size > 0, side
        assert _crc_field_bytes(off) == (0, 0), side
        assert len(on) - len(off) == size, side
        assert on_again == on, side
    # the port's file without CRCs reads as the reference's does
    ours, theirs, st, jst = _read_both(without[0], verify_crc=True)
    _assert_same(ours, theirs)
    assert st == jst == {"pages_crc_verified": 0, "crc_mismatches": 0}
