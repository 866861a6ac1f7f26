"""Repairs of three faults the port had against the JAX package (ROADMAP
C.10-C.12), each held to the reference on the inputs that found it.

* C.10: a data page whose value encoding no device kernel takes (RLE on
  INT32, an encoding number outside the enum, a lost ``encoding`` field):
  the device plan decodes its values on the host, which raises the
  reference's error class and words, and a quarantining scan records the
  reference's entry.
* C.11: a V1 page's definition-level encoding field that is not RLE or
  BIT_PACKED (PLAIN, -4, lost) reads as RLE, as in the reference.
* C.12: a corrupt SNAPPY page raises the reference's words, its varint
  size header checked first.

Every file is written by the JAX package from numpy inputs made from a
seed, then one byte of it changed; each side reads it with
``read_row_group_device`` (the port on the CPU).  Buffers compare
exactly.
"""

from __future__ import annotations

import io

import numpy as np
import pytest

from tpuparquet import CompressionCodec as JaxCodec
from tpuparquet import FileWriter as JaxFileWriter
from tpuparquet.cpu.plain import ByteArrayColumn as JaxByteArrayColumn
from tpuparquet.kernels import device as jax_device
from tpuparquet.stats import collect_stats as jax_collect_stats
from tpuparquet_torch.format.compact import CompactReader
from tpuparquet_torch.format.metadata import Encoding, PageHeader, \
    PageType, decode_struct
from tpuparquet_torch.io.reader import FileReader
from tpuparquet_torch.kernels import device as port_device
from tpuparquet_torch.stats import collect_stats

from test_torch_faults import assert_unit_same, scan_both  # noqa: E402
from test_torch_read import _assert_same_column, _jax_buffers  # noqa: E402
from tpuparquet import FileReader as JaxFileReader  # noqa: E402
from tpuparquet_torch.kernels.device import \
    device_column_from_jax_numpy  # noqa: E402

PLAIN_FILE = dict(page_crc=False, salvage_hint=False, page_index=False,
                  write_stats=False)


def _write(schema: str, cols: dict, masks=None, **kw) -> bytes:
    buf = io.BytesIO()
    w = JaxFileWriter(buf, schema, **kw)
    w.write_columns(cols, masks=masks)
    w.close()
    return buf.getvalue()


def _header_at(blob: bytes, pos: int):
    """The page header at ``pos`` and its length in bytes."""
    r = CompactReader(blob, pos, len(blob))
    ph = decode_struct(PageHeader, r)
    return ph, r.pos - pos


def _data_page_pos(blob: bytes) -> int:
    cm = JaxFileReader(io.BytesIO(blob)).meta.row_groups[0].columns[0] \
        .meta_data
    return cm.data_page_offset


def _fields(ph) -> dict:
    """The data page's own header struct, field by field."""
    h = (ph.data_page_header if ph.type == PageType.DATA_PAGE
         else ph.data_page_header_v2)
    return {name: getattr(h, name, None) for _, name, _ in h.FIELDS}


def patched(blob: bytes, field: str, want) -> bytes:
    """``blob`` with one byte of its first data page's header changed so
    that the header decodes with ``field`` = ``want`` (None: the field
    lost) and every other field of the page header as it was."""
    pos = _data_page_pos(blob)
    ph, hlen = _header_at(blob, pos)
    base = _fields(ph)
    for i in range(pos, pos + hlen):
        for b in range(256):
            if b == blob[i]:
                continue
            cand = blob[:i] + bytes([b]) + blob[i + 1:]
            try:
                got, glen = _header_at(cand, pos)
                f = _fields(got)
            except Exception:  # noqa: BLE001 - not a header any more
                continue
            if (glen, got.type, got.compressed_page_size) != \
                    (hlen, ph.type, ph.compressed_page_size):
                continue
            rest = {k: v for k, v in f.items() if k != field
                    and not (want is None and k.endswith("_encoding"))}
            want_rest = {k: v for k, v in base.items() if k in rest}
            if f[field] == want and rest == want_rest:
                return cand
    raise AssertionError(f"no one-byte patch gives {field}={want!r}")


def _read_both(blob: bytes):
    """``(port outcome, reference outcome)``: each a column dict, or the
    raised error as ``(class name, message)``; and each side's
    ``pages_host_values``."""
    out = []
    for dev, read, stats, reader in (
            (port_device, lambda r: port_device.read_row_group_device(
                r, 0, device="cpu"), collect_stats,
             FileReader(blob)),
            (jax_device, lambda r: jax_device.read_row_group_device(r, 0),
             jax_collect_stats, JaxFileReader(io.BytesIO(blob)))):
        with stats() as st:
            try:
                got = read(reader)
            except Exception as e:  # noqa: BLE001 - compared below
                got = (type(e).__name__, str(e))
        out.append((got, st.pages_host_values))
    return out


def _same_outcome(blob: bytes):
    (ours, ours_host), (theirs, theirs_host) = _read_both(blob)
    if isinstance(theirs, tuple):
        assert ours == theirs
        assert ours_host == theirs_host
        return theirs
    assert isinstance(ours, dict), ours
    assert ours_host == theirs_host
    assert ours.keys() == theirs.keys()
    for name in ours:
        _assert_same_column(
            ours[name], device_column_from_jax_numpy(
                _jax_buffers(theirs[name])), name)
    return None


# ----------------------------------------------------------------------
# C.10: value encodings the device plan cannot take
# ----------------------------------------------------------------------

def _typed(ptype: str, n: int, seed: int):
    rng = np.random.default_rng(seed)
    if ptype == "int32":
        return np.arange(n, dtype=np.int32)
    if ptype == "int64":
        return rng.integers(-1000, 1000, n).astype(np.int64)
    if ptype == "float":
        return rng.random(n).astype(np.float32)
    if ptype == "double":
        return rng.random(n)
    if ptype == "boolean":
        return rng.random(n) < 0.5
    raise ValueError(ptype)


C10_CASES = [("int32", Encoding.RLE), ("double", Encoding.RLE),
             ("float", Encoding.DELTA_BINARY_PACKED),
             ("boolean", Encoding.BYTE_STREAM_SPLIT),
             ("int64", Encoding.DELTA_LENGTH_BYTE_ARRAY),
             ("int32", Encoding.DELTA_BYTE_ARRAY),
             ("int32", Encoding.BIT_PACKED), ("int32", 10), ("int32", None)]


@pytest.mark.parametrize("v2", [False, True], ids=["v1", "v2"])
@pytest.mark.parametrize("ptype,enc", C10_CASES,
                         ids=[f"{t}-{getattr(e, 'name', e)}"
                              for t, e in C10_CASES])
def test_value_encoding_without_a_device_kernel(ptype, enc, v2):
    """The port raised NotImplementedError (or ``10 is not a valid
    Encoding``); now each side raises the same class and words, or reads
    the same buffers."""
    blob = _write(f"message m {{ required {ptype} c; }}",
                  {"c": _typed(ptype, 100, 0)},
                  codec=JaxCodec.UNCOMPRESSED, data_page_v2=v2,
                  allow_dict=False, **PLAIN_FILE)
    bad = patched(blob, "encoding", enc)
    err = _same_outcome(bad)
    if (ptype, enc) == ("int32", Encoding.RLE):
        assert err == ("CorruptChunkError", "RLE data encoding is "
                       "boolean-only [row_group=0, column=c]")
    if enc == 10:
        assert err[0] == "CorruptChunkError"
        assert err[1].startswith("unsupported value encoding 10")


def test_quarantined_entry_as_reference(tmp_path):
    """A quarantining scan over a good file and one whose page says RLE
    on INT32, both from paths: both quarantine unit 1 with the same entry
    (``column`` and ``file_detail`` included), and decode unit 0
    alike."""
    good = _write("message m { required int32 c; }",
                  {"c": np.arange(100, dtype=np.int32)},
                  codec=JaxCodec.UNCOMPRESSED, allow_dict=False,
                  **PLAIN_FILE)
    paths = [tmp_path / "good.parquet", tmp_path / "bad.parquet"]
    paths[0].write_bytes(good)
    paths[1].write_bytes(patched(good, "encoding", Encoding.RLE))
    ours, s, st, theirs, js, jst = scan_both(
        lambda pkg: [str(p) for p in paths], on_error="quarantine")
    assert st == jst and st["units_quarantined"] == 1
    assert s.quarantine.units() == js.quarantine.units() == [1]
    entry, jentry = s.quarantine.as_dicts()[0], js.quarantine.as_dicts()[0]
    assert entry == jentry
    assert entry["column"] == "c"
    assert entry["file_detail"] == str(paths[1])
    assert_unit_same(ours[0], theirs[0], "unit 0")


# ----------------------------------------------------------------------
# C.11: the V1 definition-level encoding field
# ----------------------------------------------------------------------

def _c11_files():
    rng = np.random.default_rng(11)
    mask = rng.random(200) >= 0.2
    k = int(mask.sum())
    return {
        "dict-int32": _write(
            "message m { optional int32 c; }",
            {"c": rng.integers(0, 7, k).astype(np.int32)}, {"c": mask},
            codec=JaxCodec.UNCOMPRESSED, **PLAIN_FILE),
        "plain-binary": _write(
            "message m { optional binary c; }",
            {"c": JaxByteArrayColumn.from_list(
                [b"v%d" % i for i in range(k)])}, {"c": mask},
            codec=JaxCodec.UNCOMPRESSED, allow_dict=False, **PLAIN_FILE),
        "snappy-dict-int64": _write(
            "message m { optional int64 c; }",
            {"c": rng.integers(0, 9, k).astype(np.int64)}, {"c": mask},
            codec=JaxCodec.SNAPPY, **PLAIN_FILE),
    }


@pytest.mark.parametrize("want", [Encoding.PLAIN, -4, None],
                         ids=["PLAIN", "minus4", "lost"])
@pytest.mark.parametrize("name", ["dict-int32", "plain-binary",
                                  "snappy-dict-int64"])
def test_def_level_encoding_reads_as_rle(name, want):
    """The port refused these pages; now both sides read them, buffer for
    buffer."""
    bad = patched(_c11_files()[name], "definition_level_encoding", want)
    assert _same_outcome(bad) is None


# ----------------------------------------------------------------------
# C.12: SNAPPY error words
# ----------------------------------------------------------------------

def _snappy_payload(blob: bytes) -> int:
    """Where the first data page's compressed body starts."""
    pos = _data_page_pos(blob)
    _, hlen = _header_at(blob, pos)
    return pos + hlen


@pytest.mark.parametrize("how", ["bad-header", "header-size", "tokens"])
def test_snappy_errors_as_reference(how):
    """A SNAPPY page with one byte changed: a varint size header that
    does not end, one that names another size, and a token stream that
    does not decode; the device read and the host read (``read_row_group_
    arrays``) each raise the reference's class and words."""
    blob = _c11_files()["snappy-dict-int64"]
    at = _snappy_payload(blob)
    buf = bytearray(blob)
    if how == "bad-header":
        size = blob[at]
        buf[at:at + 1] = bytes([size | 0x80])
        # every following byte a continuation: the varint runs off 10
        # bytes (the header's limit) without ending
        for i in range(1, 10):
            buf[at + i] = 0xFF
    elif how == "header-size":
        buf[at] ^= 0x01
    else:
        # the first tag (past the one-byte size header) a copy, which has
        # nothing yet to copy from
        assert blob[at] < 0x80
        buf[at + 1] = 0x05
    bad = bytes(buf)
    err = _same_outcome(bad)
    assert err is not None and err[1].startswith("snappy: ")
    words = {"bad-header": "snappy: bad size header",
             "header-size": "snappy: header size"}
    words["tokens"] = "snappy: corrupt block (rc=-1)"
    assert err[1].startswith(words[how])
    ours = theirs = None
    try:
        FileReader(bad).read_row_group_arrays(0)
    except Exception as e:  # noqa: BLE001 - compared below
        ours = (type(e).__name__, str(e))
    try:
        JaxFileReader(io.BytesIO(bad)).read_row_group_arrays(0)
    except Exception as e:  # noqa: BLE001 - compared below
        theirs = (type(e).__name__, str(e))
    assert ours == theirs and ours is not None
