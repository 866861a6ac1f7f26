"""Front coding and the other string and boolean codecs of
tpuparquet_torch against the JAX package.

DELTA_BYTE_ARRAY pages take one of two routes, by the reference's gate:
a page whose front coding expands its bytes ships one copy and one
literal token a value for K8 (then K13 for FIXED_LEN_BYTE_ARRAY rows);
one that does not is assembled on the host (the JAX package's golden
``HOST_ASSEMBLY_EXCEPTIONS``, ``tests/test_fallback_matrix.py``).  Both
routes stage exactly the JAX read's bytes.  The plain version of K13
equals the JAX ``flba_bytes_to_lanes``; the writers' front coding,
length coding and RLE booleans give the JAX encoders' bytes, and their
decoders the JAX decoders' values; a malformed DELTA_BYTE_ARRAY page
raises the JAX package's error, checked in its order.
"""

import io

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpuparquet import Encoding as JaxEncoding
from tpuparquet import FileWriter as JaxFileWriter
from tpuparquet.cpu import delta as jax_delta
from tpuparquet.cpu.hybrid import decode_hybrid_prefixed as \
    jax_decode_hybrid_prefixed
from tpuparquet.cpu.plain import ByteArrayColumn as JaxByteArrayColumn
from tpuparquet.io.pages import encode_values as jax_encode_values
from tpuparquet.io.reader import FileReader as JaxFileReader
from tpuparquet.kernels.decode import flba_bytes_to_lanes as \
    jax_flba_bytes_to_lanes
from tpuparquet.kernels.device import read_row_group_device as \
    jax_read_row_group_device
from tpuparquet.format.metadata import Type as JaxType
from tpuparquet.stats import collect_stats as jax_collect_stats
from tpuparquet_torch.cpu import delta
from tpuparquet_torch.cpu.hybrid import decode_hybrid_prefixed
from tpuparquet_torch.cpu.plain import ByteArrayColumn
from tpuparquet_torch.format.metadata import CompressionCodec, Encoding, Type
from tpuparquet_torch.io import pages
from tpuparquet_torch.io.reader import FileReader
from tpuparquet_torch.io.writer import FileWriter
from tpuparquet_torch.kernels import device
from tpuparquet_torch.kernels.decode import flba_bytes_to_lanes_plain, \
    flba_tile_rows

from test_torch_types import read_both  # noqa: E402


def _strings(vals) -> tuple:
    return (np.concatenate([[0], np.cumsum([len(v) for v in vals])]),
            np.frombuffer(b"".join(vals), np.uint8).copy())


HEX = [b"%08x" % (i * 2654435761 % 2**32) for i in range(2000)]
PATHS = [b"warehouse/region-7/shelf-%04d/item-%07d" % (i // 40, i)
         for i in range(2000)]
ROWS16 = [b"\x00" * 11 + (i * 7919).to_bytes(5, "big") for i in range(2000)]
RAND16 = [bytes(r) for r in np.random.default_rng(5).integers(
    0, 256, (2000, 16), dtype=np.uint8)]

# (values, fixed length or None, the JAX route: "dba" device, "dba-host")
PAGES = {
    "random hex": (HEX, None, "dba-host"),
    "shared paths": (PATHS, None, "dba"),
    "wire-neutral": ([b"0123456789abcdef"] * 2, None, "dba"),
    "decimal rows": (ROWS16, 16, "dba"),
    "random rows": (RAND16, 16, "dba-host"),
}


def _write_dba(writer: str, vals, flba) -> bytes:
    t = "binary" if flba is None else f"fixed_len_byte_array({flba})"
    schema = f"message m {{ required {t} c; }}"
    buf = io.BytesIO()
    if writer == "jax":
        col = (JaxByteArrayColumn.from_list(vals) if flba is None
               else np.frombuffer(b"".join(vals), np.uint8).reshape(-1, flba))
        w = JaxFileWriter(buf, schema, allow_dict=False, column_encodings={
            "c": JaxEncoding.DELTA_BYTE_ARRAY})
    else:
        col = (ByteArrayColumn(*_strings(vals)) if flba is None
               else np.frombuffer(b"".join(vals), np.uint8).reshape(-1, flba))
        w = FileWriter(buf, schema, allow_dict=False, column_encodings={
            "c": Encoding.DELTA_BYTE_ARRAY})
    w.write_columns({"c": col})
    w.close()
    return buf.getvalue()


@pytest.mark.parametrize("writer", ["jax", "port"])
@pytest.mark.parametrize("name", list(PAGES))
def test_dba_routes_match_jax(monkeypatch, name, writer):
    """The golden host-assembly exception, both sides: each page takes
    the JAX route (its event log's transport), launches K8 and K13 only
    on the device route, and stages the JAX read's bytes."""
    vals, flba, route = PAGES[name]
    blob = _write_dba(writer, vals, flba)
    with jax_collect_stats(events=True) as jst:
        jax_read_row_group_device(JaxFileReader(io.BytesIO(blob)), 0)
    assert {e.transport for e in jst.events.pages} == {route}
    calls = {"expand_tokens": 0, "flba_bytes_to_lanes": 0}
    for name_ in calls:
        fn = getattr(device, name_)

        def counted(*a, _fn=fn, _n=name_):
            calls[_n] += 1
            return _fn(*a)

        monkeypatch.setattr(device, name_, counted)
    ours, st, _ = read_both(blob, f"{name} by {writer}")
    on_device = route == "dba"
    assert calls == {"expand_tokens": int(on_device),
                     "flba_bytes_to_lanes": int(on_device
                                                and flba is not None)}
    got = ours[0]["c"].to_numpy()[0]
    if flba is None:
        assert got.data.tobytes() == b"".join(vals)
    else:
        assert got.tobytes() == b"".join(vals)


def test_host_assembly_stages_fewer_bytes():
    """Host assembly ships the expanded bytes, strictly fewer than the
    compact form (suffixes plus 8 bytes a value) it would otherwise ship;
    the device route ships the compact form."""
    staged = {}
    for name in ("random hex", "shared paths"):
        vals, flba, _ = PAGES[name]
        _, st, jst = read_both(_write_dba("port", vals, flba), name)
        staged[name] = st.bytes_staged
    assert staged["random hex"] >= sum(map(len, HEX))
    assert staged["shared paths"] < sum(map(len, PATHS))


@pytest.mark.parametrize("length", [1, 3, 4, 5, 7, 8, 9, 12, 13, 16, 17,
                                    20, 22, 24])
def test_flba_bytes_to_lanes_plain_matches_jax(length):
    """Counts around K13's row tiles (one short of and one past a tile,
    three tiles and a remainder), and rows that start one byte into their
    buffer."""
    rng = np.random.default_rng(length)
    R = flba_tile_rows(length)
    for count in (0, 1, 33, 1000, R - 1, R + 1, 3 * R + 5):
        raw = rng.integers(0, 256, size=count * length + 7, dtype=np.uint8)
        for off in (0, 1) if count == 3 * R + 5 else (0,):
            got = flba_bytes_to_lanes_plain(torch.from_numpy(raw[off:]),
                                            count, length)
            want = np.asarray(jax_flba_bytes_to_lanes(
                jnp.asarray(raw[off:]), count, length))
            assert got.dtype == torch.int32
            np.testing.assert_array_equal(got.numpy().view(np.uint32), want)


def _columns():
    rng = np.random.default_rng(11)
    yield "empty", []
    yield "one empty", [b""]
    yield "paths", PATHS[:500]
    yield "hex", HEX[:500]
    yield "mixed", [bytes(rng.integers(97, 100, int(k), dtype=np.uint8))
                    for k in rng.integers(0, 12, 3000)]


@pytest.mark.parametrize("name,vals", list(_columns()))
def test_string_encoders_match_jax(name, vals):
    ours = ByteArrayColumn(*_strings(vals)) if vals else \
        ByteArrayColumn(np.zeros(1, np.int64), np.zeros(0, np.uint8))
    theirs = JaxByteArrayColumn.from_list(vals)
    for enc, jenc in ((delta.encode_delta_byte_array,
                       jax_delta.encode_delta_byte_array),
                      (delta.encode_delta_length_byte_array,
                       jax_delta.encode_delta_length_byte_array)):
        assert enc(ours) == jenc(theirs), enc.__name__
    n = len(vals)
    for dec, jdec, encode in (
            (delta.decode_delta_byte_array, jax_delta.decode_delta_byte_array,
             jax_delta.encode_delta_byte_array),
            (delta.decode_delta_length_byte_array,
             jax_delta.decode_delta_length_byte_array,
             jax_delta.encode_delta_length_byte_array)):
        page = encode(theirs) + b"trailing"
        (got, end), (want, jend) = dec(page, n), jdec(page, n)
        assert end == jend
        np.testing.assert_array_equal(got.offsets, want.offsets)
        np.testing.assert_array_equal(got.data, want.data)


def test_flba_delta_byte_array_encoder_matches_jax():
    rows = np.frombuffer(b"".join(ROWS16[:700]), np.uint8).reshape(-1, 16)
    assert pages.encode_values(Type.FIXED_LEN_BYTE_ARRAY,
                               Encoding.DELTA_BYTE_ARRAY, rows) == \
        jax_encode_values(JaxType.FIXED_LEN_BYTE_ARRAY,
                          JaxEncoding.DELTA_BYTE_ARRAY, rows, 16)


@pytest.mark.parametrize("n", [0, 1, 9, 1000, 5003])
def test_rle_boolean_codec_matches_jax(n):
    rng = np.random.default_rng(n)
    vals = rng.random(n) < 0.4
    vals[: n // 2] = True
    got = pages.encode_values(Type.BOOLEAN, Encoding.RLE, vals)
    assert got == jax_encode_values(JaxType.BOOLEAN, JaxEncoding.RLE, vals)
    (dec, end), (jdec, jend) = (decode_hybrid_prefixed(got, n, 1),
                                jax_decode_hybrid_prefixed(got, n, 1))
    assert end == jend == len(got)
    np.testing.assert_array_equal(dec, jdec)
    np.testing.assert_array_equal(dec.astype(bool), vals)


def _bad_page(prefix, suffixes) -> bytes:
    """A DELTA_BYTE_ARRAY page of the given prefix lengths and suffixes."""
    return (jax_delta.encode_delta_binary_packed(
        np.asarray(prefix, dtype=np.int64))
        + jax_delta.encode_delta_length_byte_array(
            JaxByteArrayColumn.from_list(suffixes)))


# each page breaks its rule and every rule the reference checks after it,
# so the error raised shows the order of the checks
BAD = {
    "prefix count": (_bad_page([1, 1], [b"ab", b"c"]), None,
                     "prefix count mismatch"),
    "first prefix": (_bad_page([1, -1, 9], [b"ab", b"c", b"d"]), None,
                     "first prefix must be 0"),
    "negative prefix": (_bad_page([0, -1, 9], [b"ab", b"c", b"d"]), None,
                        "negative prefix"),
    "longer prefix": (_bad_page([0, 2, 9], [b"ab", b"c", b"d"]), 3,
                      "prefix longer than previous value"),
    "FLBA length": (_bad_page([0, 2, 1], [b"abc", b"d", b"efg"]), 3,
                    "FLBA value length mismatch"),
}


def _file_with_page(monkeypatch, page: bytes, flba) -> bytes:
    """A one-column file whose DELTA_BYTE_ARRAY data page holds ``page``
    (three values; the port's writer with its front coding replaced)."""
    monkeypatch.setattr(pages, "encode_delta_byte_array", lambda col: page)
    t = "binary" if flba is None else f"fixed_len_byte_array({flba})"
    col = (ByteArrayColumn(*_strings([b"ab", b"abc", b"abd"]))
           if flba is None else np.zeros((3, flba), np.uint8))
    buf = io.BytesIO()
    with FileWriter(buf, f"message m {{ required {t} c; }}",
                    codec=CompressionCodec.UNCOMPRESSED, allow_dict=False,
                    column_encodings={"c": Encoding.DELTA_BYTE_ARRAY}) as w:
        w.write_columns({"c": col})
    return buf.getvalue()


@pytest.mark.parametrize("name", list(BAD))
def test_dba_validation_errors_in_jax_order(monkeypatch, name):
    page, flba, message = BAD[name]
    blob = _file_with_page(monkeypatch, page, flba)
    with pytest.raises(Exception, match=message) as jax_err:
        jax_read_row_group_device(JaxFileReader(io.BytesIO(blob)), 0)
    with pytest.raises(ValueError, match=message) as err:
        device.read_row_group_device(FileReader(blob), 0, device="cpu")
    assert str(jax_err.value).split(": ", 1)[-1] in str(err.value)
