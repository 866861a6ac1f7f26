"""The subpackages' public names: every name the reference's ``format``,
``cpu``, ``kernels``, ``compress`` and ``serve`` export has its twin in
the port, apart from the few that ROADMAP.md's known differences list
with the twin that stands for each; and each CPU function ported for
the surface equals the reference's on seeded inputs."""

import importlib
import io
import os
import types

import numpy as np
import pytest

import tpuparquet.compress as jax_compress
import tpuparquet.cpu as jax_cpu
import tpuparquet.cpu.dictionary as jax_dictionary
import tpuparquet.cpu.hybrid as jax_hybrid
import tpuparquet.format.footer as jax_footer
import tpuparquet_torch.compress as port_compress
import tpuparquet_torch.cpu as port_cpu
import tpuparquet_torch.cpu.dictionary as port_dictionary
import tpuparquet_torch.cpu.hybrid as port_hybrid
from tpuparquet import FileWriter as JaxFileWriter

_REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

#: reference names with no twin of the same name, by subpackage; each
#: stands in ROADMAP.md with the port's name that stands for it
EXCEPTIONS = {
    "kernels": {"unpack_u32_pallas", "decode_hybrid_device",
                "dict_gather_fixed", "dict_gather_bytes"},
}


def _exported(mod) -> set:
    if hasattr(mod, "__all__"):
        return set(mod.__all__)
    return {n for n in vars(mod) if not n.startswith("_")
            and not isinstance(vars(mod)[n], types.ModuleType)
            and n != "annotations"}


@pytest.mark.parametrize("sub", ["format", "cpu", "kernels", "compress",
                                 "serve"])
def test_reference_names_have_twins(sub):
    ref = importlib.import_module(f"tpuparquet.{sub}")
    port = importlib.import_module(f"tpuparquet_torch.{sub}")
    missing = {n for n in _exported(ref) if not hasattr(port, n)}
    assert missing == EXCEPTIONS.get(sub, set())


def test_exceptions_are_listed_in_roadmap():
    text = open(os.path.join(_REPO, "ROADMAP.md"), encoding="utf-8").read()
    for names in EXCEPTIONS.values():
        for name in names:
            assert f"`{name}`" in text, name


def test_documented_imports():
    from tpuparquet_torch.cpu import encode_levels_v1, null_mask, pack_msb
    from tpuparquet_torch.format import (FileMetaData, FormatError,
                                         read_file_metadata)
    from tpuparquet_torch.errors import CorruptFooterError

    assert FormatError is CorruptFooterError
    assert callable(encode_levels_v1) and callable(null_mask)
    assert callable(pack_msb) and callable(read_file_metadata)
    assert FileMetaData.FIELDS[-1][1] == "footer_signing_key_metadata"


def test_format_error_raised_as_reference():
    import tpuparquet_torch.format as port_format

    bad = b"PAR1" + b"\x00" * 20 + b"XXXX"
    with pytest.raises(jax_footer.FormatError) as ref:
        jax_footer.read_file_metadata(io.BytesIO(bad))
    with pytest.raises(port_format.FormatError) as got:
        port_format.read_file_metadata(io.BytesIO(bad))
    assert str(got.value) == str(ref.value)


def test_lazy_format_and_kernel_names():
    import tpuparquet_torch.format as port_format
    import tpuparquet_torch.kernels as port_kernels
    from tpuparquet_torch.format import recover, validate
    from tpuparquet_torch.kernels import device

    assert port_format.validate_metadata is validate.validate_metadata
    assert port_format.recover_file_metadata is recover.recover_file_metadata
    assert port_kernels.DeviceColumn is device.DeviceColumn
    with pytest.raises(AttributeError):
        port_format.no_such_name  # noqa: B018


SEEDS = [0, 1, 2, 3]


def _levels(seed, max_level):
    rng = np.random.default_rng(seed)
    n = int(rng.integers(0, 3000))
    lv = rng.integers(0, max_level + 1, n).astype(np.int32)
    if seed % 2:
        lv[: n // 2] = max_level  # long runs take the RLE form
    return lv


@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("max_level", [0, 1, 3, 7])
def test_level_encoders_as_reference(seed, max_level):
    lv = _levels(seed, max_level)
    assert port_cpu.bit_width(max_level) == jax_cpu.bit_width(max_level)
    v1 = port_cpu.encode_levels_v1(lv, max_level)
    assert v1 == jax_cpu.encode_levels_v1(lv, max_level)
    assert port_cpu.encode_levels_v2(lv, max_level) == \
        jax_cpu.encode_levels_v2(lv, max_level)
    np.testing.assert_array_equal(port_cpu.null_mask(lv, max_level),
                                  jax_cpu.null_mask(lv, max_level))
    if max_level:
        got, end = port_cpu.decode_levels_v1(v1, len(lv), max_level)
        np.testing.assert_array_equal(got, lv)
        assert end == len(v1)


@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("width", [0, 1, 5, 13, 32])
def test_pack_msb_as_reference(seed, width):
    rng = np.random.default_rng(seed)
    n = int(rng.integers(1, 500))
    v = (rng.integers(0, 1 << width, n, dtype=np.uint64) if width
         else np.zeros(n, np.uint64))
    blob = port_cpu.pack_msb(v, width)
    assert blob == jax_cpu.pack_msb(v, width)
    if width:
        np.testing.assert_array_equal(port_cpu.unpack_msb(blob, n, width), v)
        with pytest.raises(ValueError):
            port_cpu.pack_msb(np.array([1 << width], np.uint64), width)


@pytest.mark.parametrize("seed", SEEDS)
def test_slice_prefixed_as_reference(seed):
    rng = np.random.default_rng(seed)
    body = rng.integers(0, 256, int(rng.integers(0, 64)),
                        dtype=np.uint8).tobytes()
    pos = int(rng.integers(0, 5))
    buf = b"\xaa" * pos + len(body).to_bytes(4, "little") + body + b"\x01"
    assert port_hybrid.slice_prefixed(buf, pos) == \
        jax_hybrid.slice_prefixed(buf, pos)
    for bad in (buf[:pos + 3], buf[:pos + 4 + len(body) - 1]):
        if len(bad) >= pos + 4 + len(body):
            continue
        with pytest.raises(ValueError) as ref:
            jax_hybrid.slice_prefixed(bad, pos)
        with pytest.raises(ValueError) as got:
            port_hybrid.slice_prefixed(bad, pos)
        assert str(got.value) == str(ref.value)


@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("dict_size", [1, 2, 7, 300])
def test_encode_dict_indices_as_reference(seed, dict_size):
    rng = np.random.default_rng(seed)
    idx = rng.integers(0, dict_size, int(rng.integers(0, 2000)))
    assert port_cpu.encode_dict_indices(idx, dict_size) == \
        jax_cpu.encode_dict_indices(idx, dict_size)


def _rows(seed, k=5000, length=6):
    rng = np.random.default_rng(seed)
    pool = rng.integers(0, 256, (37, length), dtype=np.uint8)
    return pool[rng.integers(0, 37, k)]


@pytest.mark.parametrize("hook", ["default", "constant", "first-byte"])
def test_row_hash_func_hook_as_reference(hook, monkeypatch):
    """A custom row hash (even one that collides everywhere) changes no
    dictionary, in either package."""
    fn = {"default": None,
          "constant": lambda rows: np.zeros(rows.shape[0], np.uint64),
          "first-byte": lambda rows: rows[:, 0].astype(np.uint64)}[hook]
    for k in (100, 5000):
        rows = _rows(k, k=k)
        monkeypatch.setattr(jax_dictionary, "row_hash_func", fn)
        monkeypatch.setattr(port_dictionary, "row_hash_func", fn)
        rd, ri = jax_cpu.build_dictionary(rows)
        pd, pi = port_cpu.build_dictionary(rows)
        np.testing.assert_array_equal(pd, rd)
        np.testing.assert_array_equal(pi, ri)


def test_row_hash_func_shape_checked(monkeypatch):
    monkeypatch.setattr(port_dictionary, "row_hash_func",
                        lambda rows: np.zeros(3, np.uint64))
    with pytest.raises(ValueError, match="row_hash_func"):
        port_cpu.build_dictionary(_rows(0, k=10))


def _blocks(seed):
    rng = np.random.default_rng(seed)
    n = int(rng.integers(0, 70000))
    return [b"", b"abc", rng.integers(0, 256, n, dtype=np.uint8).tobytes(),
            rng.integers(0, 3, n, dtype=np.uint8).tobytes(),
            np.cumsum(rng.integers(0, 5, n // 8 + 1)).astype(
                np.int64).tobytes()]


@pytest.mark.parametrize("seed", SEEDS)
def test_snappy_block_helpers_as_reference(seed):
    for data in _blocks(seed):
        for mm in (4, 8):
            block = port_compress.snappy_compress(data, mm)
            assert block == jax_compress.snappy_compress(data, mm)
        assert port_compress.snappy_parse_tokens(block) == \
            jax_compress.snappy_parse_tokens(block)
        assert port_compress.snappy_decompress(block) == data
        assert port_compress.snappy_decompress(block, len(data)) == \
            jax_compress.snappy_decompress(block, len(data))
    block = jax_compress.snappy_compress(b"x" * 100)
    with pytest.raises(port_compress.CompressionError) as got:
        port_compress.snappy_decompress(block, 99)
    with pytest.raises(jax_compress.CompressionError) as ref:
        jax_compress.snappy_decompress(block, 99)
    assert str(got.value) == str(ref.value)


@pytest.mark.parametrize("seed", SEEDS)
def test_lz4_block_helpers_as_reference(seed):
    for data in _blocks(seed):
        block = port_compress.lz4_compress(data)
        assert block == jax_compress.lz4_compress(data)
        assert port_compress.lz4_decompress(block, len(data)) == \
            jax_compress.lz4_decompress(block, len(data)) == data
    with pytest.raises(port_compress.CompressionError):
        port_compress.lz4_decompress(b"\xf0", 10)


def test_levels_feed_a_reference_reader():
    """Pages built from the port's level encoders read back in the
    reference's writer's own terms: the levels the reference writes for
    a nullable column are the port's bytes."""
    from tpuparquet.io.reader import FileReader as JaxFileReader

    buf = io.BytesIO()
    w = JaxFileWriter(buf, "message m { optional int32 a; }")
    vals = [None if i % 3 == 0 else i for i in range(50)]
    for v in vals:
        w.add_data({"a": v})
    w.close()
    r = JaxFileReader(io.BytesIO(buf.getvalue()))
    defs = np.array([0 if v is None else 1 for v in vals], np.int32)
    stream = port_cpu.encode_levels_v1(defs, 1)
    assert stream in buf.getvalue()
    assert r.num_rows == 50
