"""The port's sharded scan against the JAX package's, on the CPU.

The JAX side runs on the 8 virtual CPU devices of ``conftest.py``; the
port on meshes of ``cpu`` slots of the same (rg, sp) shapes, where every
kernel (KS1-KS4) runs its plain version.  Inputs come from numpy seeds and
files the JAX writer writes; every output is compared bit for bit
(tolerance 0): ``scatter_to_dense``, ``stack_hybrid_plans``, the SPMD step
through ``sharded_dict_decode``, the shard-major assembly and its
``perm``, ``ShardedScan`` with ``gather_column`` and
``gather_byte_column`` (replicated and placed) with their counters,
cursors and epoch shuffles, and the placement errors.
"""

import io
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpuparquet import CompressionCodec as JaxCodec
from tpuparquet import FileWriter as JaxFileWriter
from tpuparquet.cpu.hybrid import encode_hybrid
from tpuparquet.kernels.decode import scatter_to_dense as jax_scatter
from tpuparquet.kernels.hybrid import plan_hybrid as jax_plan_hybrid
from tpuparquet.shard import mesh as jax_mesh
from tpuparquet.shard import scan as jax_scan
from tpuparquet.stats import collect_stats as jax_collect_stats
from tpuparquet_torch.kernels.decode import scatter_to_dense
from tpuparquet_torch.kernels.gather import byte_densify
from tpuparquet_torch.kernels.hybrid import plan_hybrid
from tpuparquet_torch.shard import mesh as port_mesh
from tpuparquet_torch.shard import scan as port_scan
from tpuparquet_torch.stats import collect_stats

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

import chip_smoke  # noqa: E402

GATHER = ("gather_bytes_moved", "gather_bytes_replicated")
# (n_devices, sp) of the meshes compared: make_mesh(8), make_mesh(8,
# sp=1), make_mesh(4), make_mesh(1)
MESHES = [(8, None), (8, 1), (4, None), (1, None)]


def _meshes(n, sp):
    """The JAX mesh and the port's CPU mesh of one shape."""
    jm = jax_mesh.make_mesh(n, sp=sp)
    pm = port_mesh.make_mesh(n, sp=sp, devices=["cpu"] * 8)
    assert pm.shape == dict(jm.shape)
    return jm, pm


def _u32(t: torch.Tensor) -> np.ndarray:
    a = t.cpu().numpy()
    return a.view(np.uint32) if a.dtype == np.int32 else a


# ----------------------------------------------------------------------
# mesh construction
# ----------------------------------------------------------------------

@pytest.mark.parametrize("n,sp", MESHES + [(6, None), (6, 3), (2, None)])
def test_make_mesh_shapes(n, sp):
    _meshes(n, sp)


def test_assign_units_as_reference():
    for n, k in ((5, 2), (0, 3), (17, 4)):
        assert port_mesh.assign_units(n, k) == jax_mesh.assign_units(n, k)


def test_default_mesh_needs_a_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        port_mesh.make_mesh()
    with pytest.raises(RuntimeError, match="CUDA"):
        port_scan.ShardedScan([_int_file(40, 1, 0)])


# ----------------------------------------------------------------------
# KS1: scatter_to_dense
# ----------------------------------------------------------------------

def _validity(mask: np.ndarray) -> np.ndarray:
    """The positions levels_to_validity gives: the packed index of each
    slot, 0 for leading nulls."""
    return np.maximum(np.cumsum(mask.astype(np.int32)) - 1, 0).astype(
        np.int32)


@pytest.mark.parametrize("kind", ["some-null", "all-null", "no-null"])
@pytest.mark.parametrize("lanes", [1, 2, 3, 4])
def test_scatter_to_dense_as_reference(lanes, kind):
    rng = np.random.default_rng(lanes)
    n = 1000
    mask = {"some-null": rng.random(n) < 0.7, "all-null": np.zeros(n, bool),
            "no-null": np.ones(n, bool)}[kind]
    pos = _validity(mask)
    packed = rng.integers(0, 2**32, size=int(mask.sum()) * lanes,
                          dtype=np.uint32)
    want = np.asarray(jax_scatter(jnp.asarray(packed), jnp.asarray(mask),
                                  jnp.asarray(pos), lanes=lanes))
    pt = torch.from_numpy(packed.view(np.int32))
    got = scatter_to_dense(pt, torch.from_numpy(mask), torch.from_numpy(pos),
                           lanes)
    np.testing.assert_array_equal(_u32(got), want)
    # into a longer row: the same words, then zeros
    row = torch.full((n * lanes + 7,), -1, dtype=torch.int32)
    scatter_to_dense(pt, torch.from_numpy(mask), torch.from_numpy(pos),
                     lanes, out=row)
    np.testing.assert_array_equal(_u32(row)[: n * lanes], want)
    assert not row[n * lanes:].any()
    if kind == "no-null":  # a column without nulls keeps no mask
        np.testing.assert_array_equal(
            _u32(scatter_to_dense(pt, None, None, lanes)), want)


@pytest.mark.parametrize("n_packed", [0, 37])
def test_scatter_to_dense_2d_as_reference(n_packed):
    rng = np.random.default_rng(9)
    mask = np.zeros(60, bool)
    mask[rng.choice(60, n_packed, replace=False)] = True
    pos = _validity(mask)
    packed = rng.integers(0, 2**32, size=(n_packed, 3), dtype=np.uint32)
    want = np.asarray(jax_scatter(jnp.asarray(packed), jnp.asarray(mask),
                                  jnp.asarray(pos)))
    got = scatter_to_dense(torch.from_numpy(packed.view(np.int32)),
                           torch.from_numpy(mask), torch.from_numpy(pos))
    assert tuple(got.shape) == want.shape == (60, 3)
    np.testing.assert_array_equal(_u32(got), want)


# ----------------------------------------------------------------------
# batched plans and the SPMD step
# ----------------------------------------------------------------------

def _runny(rng, count: int, width: int) -> np.ndarray:
    """Indices with long constant stretches (RLE runs) between random
    ones (bit-packed runs)."""
    hi = (1 << width) - 1
    out = rng.integers(0, hi, size=count, endpoint=True, dtype=np.uint64)
    starts = rng.choice(count, size=max(count // 60, 1), replace=False)
    for s in starts:
        out[s : s + int(rng.integers(8, 40))] = out[s]
    return out.astype(np.uint32)


def _varint(v: int) -> bytes:
    out = bytearray()
    while True:
        b = v & 0x7F
        v >>= 7
        if v:
            out.append(b | 0x80)
        else:
            out.append(b)
            return bytes(out)


def _stream(rng, count: int, width: int) -> bytes:
    """A hybrid index stream of ``count`` values; at width 0, one
    bit-packed group of 8 (no bytes) then an RLE run of the rest."""
    if width == 0:
        return _varint((1 << 1) | 1) + _varint((count - 8) << 1)
    return encode_hybrid(_runny(rng, count, width), width)


def _plans(seed, counts, width):
    rng = np.random.default_rng(seed)
    streams = [_stream(rng, c, width) for c in counts]
    return streams, [jax_plan_hybrid(s, c, width)
                     for s, c in zip(streams, counts)], \
        [plan_hybrid(s, c, width) for s, c in zip(streams, counts)]


@pytest.mark.parametrize("kw", [{}, {"n_units": 8}, {"count": 1026}])
def test_stack_hybrid_plans_field_by_field(kw):
    _, theirs, ours = _plans(0, (100, 257, 1000, 8), 5)
    a = jax_mesh.stack_hybrid_plans(theirs, **kw)
    b = port_mesh.stack_hybrid_plans(ours, **kw)
    for f in port_mesh.BatchedHybridPlan.__slots__:
        x, y = getattr(a, f), getattr(b, f)
        if isinstance(x, np.ndarray):
            assert x.dtype == y.dtype and x.shape == y.shape, f
        np.testing.assert_array_equal(x, y, err_msg=f)


# the stream counts of tests/test_shard.py's SPMD cases, and indices
# past the dictionary's end; then the edges of KS2's tiles
# (chip_smoke.STEP_EDGE_CASES, whose counts sharded_dict_decode reaches:
# counts a tile - 1, a tile and a tile + 1, a unit of exactly R runs whose
# last is bit-packed, an RLE run over a tile edge, a short unit beside one
# of 2,000 runs; lanes 1, 3 and 8; on the sp 2 meshes count / sp is not a
# multiple of the tile)
STEP_CASES = [
    ("five", (200, 333, 512, 100, 777), 6, (64, 2)),
    ("one", (300,), 4, (16, 1)),
    ("clamped", (200, 333, 512, 100, 777, 64, 1000, 5, 321), 6, (40, 3)),
    ("width0", (100, 40, 9), 0, (3, 1)),
    ("width1", (500, 33), 1, (1, 4)),
    ("width32", (70, 130), 32, (1000, 1)),
] + [(name, None, None, None) for name, spec
     in chip_smoke.STEP_EDGE_CASES.items() if spec[3] is None]


def _step_case(case):
    """A STEP_CASES entry's ``(streams, counts, width, dictionary)``."""
    name, counts, width, dshape = case
    if counts is None:
        rng = np.random.default_rng(sum(map(ord, name)))
        return chip_smoke.step_edge_case(rng, name)[:4]
    rng = np.random.default_rng(len(counts) * 7 + width)
    streams = [_stream(rng, c, width) for c in counts]
    return streams, counts, width, rng.integers(0, 2**32, size=dshape,
                                                dtype=np.uint32)


@pytest.mark.parametrize("n,sp", MESHES)
@pytest.mark.parametrize("case", STEP_CASES, ids=lambda c: c[0])
def test_sharded_dict_decode_as_reference(case, n, sp):
    streams, counts, width, dictionary = _step_case(case)
    jm, pm = _meshes(n, sp)
    want = jax_mesh.sharded_dict_decode(jm, streams, list(counts), width,
                                        dictionary)
    got = port_mesh.sharded_dict_decode(pm, streams, list(counts), width,
                                        dictionary)
    assert len(got) == len(want) == len(counts)
    for g, w in zip(got, want):
        assert g.dtype == np.uint32 and g.shape == w.shape
        np.testing.assert_array_equal(g, w)


@pytest.mark.parametrize("n,sp", MESHES)
def test_decode_step_output_as_reference(n, sp):
    """The step's whole (U, count, lanes) output, padding units and
    padding positions included."""
    _, theirs, ours = _plans(3, (100, 257, 31), 7)
    jm, pm = _meshes(n, sp)
    n_rg = jm.shape["rg"]
    n_units = max(((3 + n_rg - 1) // n_rg) * n_rg, n_rg)
    a = jax_mesh.stack_hybrid_plans(theirs, n_units=n_units)
    b = port_mesh.stack_hybrid_plans(ours, n_units=n_units)
    dictionary = np.random.default_rng(4).integers(
        0, 2**32, size=(100, 2), dtype=np.uint32)
    from jax.sharding import NamedSharding, PartitionSpec as P

    step = jax_mesh.decode_step_spmd(jm, a.count, a.width, a.n_bp, 2)
    args = [jax.device_put(x, NamedSharding(jm, P("rg")))
            for x in a.arrays()]
    want = np.asarray(step(*args, jax.device_put(
        dictionary, NamedSharding(jm, P()))))
    outs = port_mesh.decode_step_spmd(pm, b.count, b.width, b.n_bp, 2)(
        *b.arrays(), dictionary)
    assert len(outs) == 1  # every slot is the cpu
    np.testing.assert_array_equal(_u32(outs[0]), want)


def _step_output_pair(jm, pm, theirs, ours, dictionary, count=None):
    """The JAX step's and the port's whole (U, count, lanes) outputs of
    the same plans on meshes of one shape."""
    from jax.sharding import NamedSharding, PartitionSpec as P

    n_rg = jm.shape["rg"]
    n_units = max(-(-len(ours) // n_rg) * n_rg, n_rg)
    a = jax_mesh.stack_hybrid_plans(theirs, n_units=n_units, count=count)
    b = port_mesh.stack_hybrid_plans(ours, n_units=n_units, count=count)
    lanes = dictionary.shape[1]
    step = jax_mesh.decode_step_spmd(jm, a.count, a.width, a.n_bp, lanes)
    args = [jax.device_put(x, NamedSharding(jm, P("rg")))
            for x in a.arrays()]
    want = np.asarray(step(*args, jax.device_put(
        dictionary, NamedSharding(jm, P()))))
    (got,) = port_mesh.decode_step_spmd(pm, b.count, b.width, b.n_bp,
                                        lanes)(*b.arrays(), dictionary)
    return _u32(got), want


@pytest.mark.parametrize("case,n,sp", [
    (name, n, sp) for name, spec in chip_smoke.STEP_EDGE_CASES.items()
    for n, sp in ([(6, 3), (1, None)] if spec[3] else
                  [(8, None), (8, 4), (1, None)])])
def test_decode_step_tile_edges_as_reference(case, n, sp):
    """The step's whole output, padding positions included, on the edges
    of KS2's tiles (chip_smoke.STEP_EDGE_CASES): the padded positions of
    a unit of exactly R runs clamp into its bit-packed last run and past
    its lanes; sp 2 and 4 leave count / sp off the tile; a count of
    3,003 over sp 3 starts shares off 16-byte boundaries."""
    rng = np.random.default_rng(sum(map(ord, case)))
    streams, counts, width, dictionary, count = chip_smoke.step_edge_case(
        rng, case)
    theirs = [jax_plan_hybrid(s, c, width) for s, c in zip(streams, counts)]
    ours = [plan_hybrid(s, c, width) for s, c in zip(streams, counts)]
    if case == "bit-packed last run":  # the layout the case is about
        assert len(ours[0].run_ends) == 32 and not ours[0].run_is_rle[-1]
    got, want = _step_output_pair(*_meshes(n, sp), theirs, ours, dictionary,
                                  count)
    np.testing.assert_array_equal(got, want)


# ----------------------------------------------------------------------
# KS3: byte_densify
# ----------------------------------------------------------------------

def _jax_densify(c):
    """The JAX package's densify of one unit (tpuparquet/shard/scan.py
    gather_byte_column, the per-unit expression and its padding), run in
    JAX on the CPU.  With no packed value (n_packed 0) every slot is
    null, and the expression's gather from an empty array is replaced by
    its outcome, zero lengths."""
    offs = jnp.asarray(c["offsets"][: c["n_packed"] + 1])
    lens = offs[1:] - offs[:-1]
    if c["mask"] is None:
        dl = lens
    elif c["n_packed"] == 0:
        dl = jnp.zeros(c["mask"].size, dtype=lens.dtype)
    else:
        dl = jnp.where(jnp.asarray(c["mask"]),
                       lens[jnp.asarray(c["positions"])],
                       jnp.zeros((), dtype=lens.dtype))
    do = jnp.concatenate([jnp.zeros((1,), dtype=lens.dtype),
                          jnp.cumsum(dl)])
    data = jnp.asarray(c["buf"][c["lead"]:])
    return (np.asarray(jnp.pad(do, (0, c["L"] - do.shape[0]), mode="edge")),
            np.asarray(jnp.pad(data, (0, c["B"] - data.shape[0]))))


@pytest.mark.parametrize("case", list(chip_smoke.DENSIFY_CASES))
def test_byte_densify_as_reference(case):
    """KS3's plain version against the JAX densify on the edges of KS3's
    tiles (chip_smoke.DENSIFY_CASES, slot counts from
    gather.densify_tile_slots): a tile - 1, a tile, a tile + 1 and 9
    tiles of slots; leading nulls, all nulls, no packed value, no slot,
    no mask; 15, 16 and 17 data bytes; a data view 3 bytes into its
    buffer; L > n + 1 and B > nb."""
    c = chip_smoke.densify_case(np.random.default_rng(sum(map(ord, case))),
                                case)
    want_offs, want_data = _jax_densify(c)
    o = torch.full((c["L"],), -1, dtype=torch.int32)
    b = torch.full((c["B"],), 7, dtype=torch.uint8)
    data = torch.from_numpy(c["buf"])[c["lead"]:]
    byte_densify(torch.from_numpy(c["offsets"]), c["n_packed"],
                 None if c["mask"] is None else torch.from_numpy(c["mask"]),
                 None if c["positions"] is None
                 else torch.from_numpy(c["positions"]), data, o, b)
    assert want_offs.dtype == np.int32
    np.testing.assert_array_equal(o.numpy(), want_offs)
    np.testing.assert_array_equal(b.numpy(), want_data)


# ----------------------------------------------------------------------
# the shard-major assembly
# ----------------------------------------------------------------------

@pytest.mark.parametrize("n,sp", MESHES)
@pytest.mark.parametrize("n_true", [1, 6, 13])
def test_assembly_order_and_perm_as_reference(n_true, n, sp):
    jm, pm = _meshes(n, sp)
    padded = [jnp.asarray([u + 1, 7 * u], dtype=jnp.int32)
              for u in range(n_true)]
    (want,), want_perm = jax_scan._assemble_and_gather(
        jm, [(padded, (2,), jnp.int32)])

    def fill(u, rows):
        rows[0][:] = torch.tensor([u + 1, 7 * u], dtype=torch.int32)

    (got,), perm = port_scan._assemble_and_gather(
        pm, n_true, [((2,), torch.int32)], fill)
    np.testing.assert_array_equal(perm, want_perm)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


# ----------------------------------------------------------------------
# ShardedScan and the gathers
# ----------------------------------------------------------------------

def _int_file(n_rows, n_groups, seed) -> bytes:
    """tests/test_shard.py's file: ``a`` required int64, ``b`` optional
    int32 (every 7th row null)."""
    buf = io.BytesIO()
    w = JaxFileWriter(buf, "message m { required int64 a; optional int32 b; }")
    rng = np.random.default_rng(seed)
    per = n_rows // n_groups
    for _ in range(n_groups):
        for i in range(per):
            w.add_data({"a": int(rng.integers(-(2**40), 2**40)),
                        "b": None if i % 7 == 0
                        else int(rng.integers(0, 1000))})
        w.flush_row_group()
    w.close()
    return buf.getvalue()


def _strings(n_rows, n_groups, seed) -> list:
    """The string column's rows: every 6th null, every 3rd empty."""
    rng = np.random.default_rng(seed)
    per = n_rows // n_groups
    return [None if i % 6 == 0 else f"s{int(rng.integers(0, 37))}" * (i % 3)
            for _ in range(n_groups) for i in range(per)]


def _string_file(n_rows, n_groups, seed) -> bytes:
    """tests/test_shard.py's string file (with empty values): ``s``
    optional STRING (:func:`_strings`), ``a`` required int64; SNAPPY."""
    buf = io.BytesIO()
    w = JaxFileWriter(
        buf, "message m { optional binary s (STRING); required int64 a; }",
        codec=JaxCodec.SNAPPY)
    per = n_rows // n_groups
    for k, s in enumerate(_strings(n_rows, n_groups, seed)):
        i = k % per
        w.add_data({"a": i} if s is None else {"a": i, "s": s})
        if i == per - 1:
            w.flush_row_group()
    w.close()
    return buf.getvalue()


def _null_file() -> bytes:
    buf = io.BytesIO()
    w = JaxFileWriter(buf, "message m { optional int64 v; }")
    for _ in range(3):
        for _ in range(40):
            w.add_data({})
        w.flush_row_group()
    w.close()
    return buf.getvalue()


def _scans(blobs, n, sp, *columns, **kw):
    """Run both scans over the same files; returns the meshes and
    results."""
    jm, pm = _meshes(n, sp)
    with jax_scan.ShardedScan([io.BytesIO(b) for b in blobs], *columns,
                              mesh=jm, **kw) as js:
        theirs = js.run()
    with port_scan.ShardedScan(list(blobs), *columns, mesh=pm, **kw) as ps:
        assert ps.units == js.units
        ours = ps.run()
    assert [sorted(r) for r in ours] == [sorted(r) for r in theirs]
    return jm, pm, theirs, ours


def _gather_both(fn, jm, pm, theirs, ours, path, jkw=None, pkw=None):
    with jax_collect_stats() as jst:
        want = getattr(jax_scan, fn)(jm, theirs, path, **(jkw or {}))
    with collect_stats() as st:
        got = getattr(port_scan, fn)(pm, ours, path, **(pkw or {}))
    assert {k: getattr(st, k) for k in GATHER} == \
        {k: getattr(jst, k) for k in GATHER}
    assert st.gather_bytes_moved > 0 and st.gather_reshard_s > 0
    return want, got


def _same(got, want):
    """Bit for bit; the port keeps u32 values in int32 tensors."""
    want = np.asarray(want)
    if isinstance(got, torch.Tensor):
        got = got.numpy()
        if want.dtype == np.uint32:
            got = got.view(np.uint32)
    assert got.dtype == want.dtype and got.shape == want.shape
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("n,sp", MESHES)
def test_multi_file_scan_gather_column_as_reference(n, sp):
    blobs = [_int_file(400, 2, seed=s) for s in range(3)]
    jm, pm, theirs, ours = _scans(blobs, n, sp)
    assert len(ours) == 6
    for path in ("a", "b"):
        want, got = _gather_both("gather_column", jm, pm, theirs, ours,
                                 path)
        _same(got[0], want[0])
        np.testing.assert_array_equal(got[1], want[1])


def test_gather_column_placed_as_reference():
    """``gather_to`` device 0: the reference assembles straight onto it
    (it lies outside the 8-device scan mesh), the port permutes on the
    one cpu device (KS4); outputs and counters agree."""
    blobs = [_int_file(400, 2, seed=s) for s in range(3)]
    jm, pm, theirs, ours = _scans(blobs, 8, None)
    for path in ("a", "b"):
        want, got = _gather_both(
            "gather_column", jm, pm, theirs, ours, path,
            {"gather_to": 0}, {"gather_to": "cpu"})
        _same(got[0], want[0])
        np.testing.assert_array_equal(got[1], want[1])


def test_projection_in_scan():
    blob = _int_file(100, 1, seed=9)
    jm, pm, theirs, ours = _scans([blob], 2, 1, "b")
    assert set(ours[0]) == {"b"}
    want, got = _gather_both("gather_column", jm, pm, theirs, ours, "b")
    _same(got[0], want[0])


def test_all_null_column_gathers_zeros_as_reference():
    jm, pm, theirs, ours = _scans([_null_file()], 4, None)
    want, got = _gather_both("gather_column", jm, pm, theirs, ours, "v")
    _same(got[0], want[0])
    assert got[0].shape == (3, 40, 2) and not got[0].any()
    np.testing.assert_array_equal(got[1], [40, 40, 40])


@pytest.mark.parametrize("n,sp", MESHES)
def test_gather_byte_column_as_reference(n, sp):
    blobs = [_string_file(240, 2, seed=s) for s in range(2)]
    jm, pm, theirs, ours = _scans(blobs, n, sp)
    want, got = _gather_both("gather_byte_column", jm, pm, theirs, ours,
                             "s")
    for g, w in zip(got, want):
        _same(g, w)
    # row by row against the generator: a null row is an empty value
    offs, data, rows, _ = got
    u = 0
    for seed in range(2):
        want_rows = _strings(240, 2, seed)
        for g in range(2):
            exp = want_rows[g * 120 : (g + 1) * 120]
            assert rows[u] == len(exp)
            for i, v in enumerate(exp):
                b = bytes(data[u, offs[u, i] : offs[u, i + 1]])
                assert b == (v or "").encode(), (u, i)
            u += 1


def test_gather_byte_column_placed_as_reference():
    blobs = [_string_file(240, 2, seed=s) for s in range(2)]
    jm, pm, theirs, ours = _scans(blobs, 8, None)
    want, got = _gather_both("gather_byte_column", jm, pm, theirs, ours,
                             "s", {"gather_to": 0}, {"gather_to": "cpu"})
    for g, w in zip(got, want):
        _same(g, w)


def test_scan_level_gather_to_and_replicated_override():
    blobs = [_string_file(120, 2, seed=3)]
    _, pm = _meshes(4, None)
    with port_scan.ShardedScan(blobs, mesh=pm, gather_to="cpu") as ps:
        res = ps.run()
        placed = ps.gather_column(res, "a")
        rep = ps.gather_column(res, "a", out_sharding="replicated")
        byte_rep = ps.gather_byte_column(res, "s",
                                         out_sharding="replicated")
        byte_placed = ps.gather_byte_column(res, "s")
    assert isinstance(placed[0], torch.Tensor)
    assert isinstance(rep[0], np.ndarray)
    np.testing.assert_array_equal(_u32(placed[0]), rep[0])
    for a, b in zip(byte_placed[:2], byte_rep[:2]):
        np.testing.assert_array_equal(a.numpy(), b)


def test_fixed_width_rejected_by_byte_gather():
    _, pm = _meshes(2, 1)
    with port_scan.ShardedScan([_string_file(60, 1, 9)], mesh=pm) as ps:
        res = ps.run()
        with pytest.raises(TypeError, match="fixed-width"):
            port_scan.gather_byte_column(pm, res, "a")
        with pytest.raises(TypeError, match="BYTE_ARRAY"):
            port_scan.gather_column(pm, res, "s")


# ----------------------------------------------------------------------
# cursors and epoch shuffles
# ----------------------------------------------------------------------

@pytest.mark.parametrize("shuffle", [None, 7])
def test_cursor_and_shuffle_as_reference(shuffle):
    blobs = [_int_file(120, 3, seed=s) for s in range(3)]
    jm, pm = _meshes(4, None)
    kw = {} if shuffle is None else {"shuffle_seed": shuffle, "epoch": 2}
    js = jax_scan.ShardedScan([io.BytesIO(b) for b in blobs], mesh=jm, **kw)
    ps = port_scan.ShardedScan(blobs, mesh=pm, **kw)
    assert ps.units == js.units
    if shuffle is not None:
        assert ps.units != sorted(ps.units)
    jit, pit = js.run_iter(), ps.run_iter()
    for _ in range(4):
        (jk, _), (pk, _) = next(jit), next(pit)
        assert jk == pk
    jit.close()
    assert ps.state() == js.state()
    # each side resumes the other's cursor at the same unit
    cur = ps.state()
    theirs = list(jax_scan.ShardedScan(
        [io.BytesIO(b) for b in blobs], mesh=jm, resume=cur, **kw)
        .run_iter())
    ours = list(port_scan.ShardedScan(blobs, mesh=pm, resume=js.state(),
                                      **kw).run_iter())
    assert [k for k, _ in ours] == [k for k, _ in theirs] == \
        list(range(4, 9))
    for (_, a), (_, b) in zip(ours, theirs):
        np.testing.assert_array_equal(a["a"].to_numpy()[0],
                                      np.asarray(b["a"].to_numpy()[0]))


def test_cursor_of_other_epoch_rejected():
    blobs = [_int_file(120, 3, seed=1)]
    _, pm = _meshes(1, None)
    cur = port_scan.ShardedScan(blobs, mesh=pm, shuffle_seed=3,
                                epoch=0).state()
    with pytest.raises(ValueError, match="does not match"):
        port_scan.ShardedScan(blobs, mesh=pm, shuffle_seed=3, epoch=1,
                              resume=cur)


@pytest.mark.parametrize("kw", [{"on_error": "quarantine"},
                                {"salvage": True}, {"unit_deadline": 1.0},
                                {"resume_from": "x.ckpt"},
                                {"progress_export": "p.json"},
                                {"filter": object()}])
def test_later_arguments_raise(kw):
    _, pm = _meshes(1, None)
    with pytest.raises(NotImplementedError, match="ROADMAP A"):
        port_scan.ShardedScan([_int_file(40, 1, 0)], mesh=pm, **kw)


# ----------------------------------------------------------------------
# placement errors (tests/test_gather_placement.py TestErrors)
# ----------------------------------------------------------------------

def test_both_specs_rejected_as_reference():
    jm, pm = _meshes(2, 1)
    from jax.sharding import PartitionSpec as P

    with pytest.raises(ValueError) as je:
        jax_mesh.resolve_out_sharding(jm, out_sharding=P("rg"), gather_to=0)
    with pytest.raises(ValueError) as pe:
        port_mesh.resolve_out_sharding(pm, out_sharding="replicated",
                                       gather_to=0)
    assert str(pe.value) == str(je.value)


def test_gather_to_out_of_range_as_reference():
    jm, pm = _meshes(2, 1)
    with pytest.raises(ValueError) as je:
        jax_mesh.resolve_out_sharding(jm, gather_to=99)
    with pytest.raises(ValueError) as pe:
        port_mesh.resolve_out_sharding(pm, gather_to=99)
    # the same message, over this process's count of devices
    n = len(port_mesh.local_devices())
    assert str(pe.value) == str(je.value).replace(
        f"has {len(jax.local_devices())} addressable",
        f"has {n} addressable")


def test_junk_spec_rejected_as_reference():
    jm, pm = _meshes(2, 1)
    with pytest.raises(ValueError) as je:
        jax_mesh.resolve_out_sharding(jm, out_sharding="replicate-please")
    with pytest.raises(ValueError) as pe:
        port_mesh.resolve_out_sharding(pm, out_sharding="replicate-please")
    assert str(pe.value) == str(je.value)


def test_gather_to_env_default(monkeypatch):
    _, pm = _meshes(2, 1)
    monkeypatch.setenv("TPQ_GATHER_TO", "x")
    with pytest.raises(ValueError, match="not a device index"):
        port_mesh.resolve_out_sharding(pm)
    monkeypatch.setenv("TPQ_GATHER_TO", "5")
    with pytest.raises(ValueError, match="out of range"):
        port_mesh.resolve_out_sharding(pm)
    assert port_mesh.resolve_out_sharding(pm, env_default=False) is None


def test_sharding_spec_waits_for_a9b():
    from jax.sharding import PartitionSpec as P

    _, pm = _meshes(2, 1)
    with pytest.raises(NotImplementedError, match="ROADMAP A.9b"):
        port_mesh.resolve_out_sharding(pm, out_sharding=P("rg"))
    assert port_mesh.resolve_out_sharding(
        pm, out_sharding="replicated") is None


def test_target_outside_mesh_waits_for_a9b():
    """A target outside the scan mesh takes the direct assembly (on the
    CPU: a mesh of ``cpu:0`` slots, the sink ``cpu``): the same arrays as
    the gather placed on the mesh's own device, which runs KS4, and the
    reference's direct assembly's counters.  A ``meta`` target holds no
    data and raises, naming the device."""
    blobs = [_int_file(120, 3, 0), _string_file(120, 2, seed=1)]
    pm = port_mesh.make_mesh(4, devices=["cpu:0"] * 4)
    jm = jax_mesh.make_mesh(8)
    with port_scan.ShardedScan(blobs, "a", mesh=pm) as ps:
        res = ps.run()
    with jax_scan.ShardedScan([io.BytesIO(b) for b in blobs], "a",
                              mesh=jm) as js:
        theirs = js.run()
    want, got = _gather_both("gather_column", jm, pm, theirs, res, "a",
                             {"gather_to": 0}, {"gather_to": "cpu"})
    _same(got[0], want[0])
    in_mesh = port_scan.gather_column(pm, res, "a", gather_to="cpu:0")
    _same(got[0], _u32(in_mesh[0]))
    with pytest.raises(ValueError, match="meta"):
        port_scan.gather_column(pm, res, "a", gather_to="meta")


@pytest.mark.parametrize("n,sp", MESHES)
@pytest.mark.parametrize("fn,path", [("gather_column", "a"),
                                     ("gather_column", "b"),
                                     ("gather_byte_column", "s")])
def test_direct_assembly_as_reference(fn, path, n, sp):
    """Every mesh shape: the port's direct assembly onto a sink outside
    its mesh against the reference's (``gather_to=0``), arrays and
    counters, and against the replicated gather."""
    blobs = ([_string_file(240, 2, seed=s) for s in range(2)]
             if fn == "gather_byte_column"
             else [_int_file(400, 2, seed=s) for s in range(3)])
    jm = jax_mesh.make_mesh(n, sp=sp)
    pm = port_mesh.make_mesh(n, sp=sp, devices=["cpu:0"] * 8)
    with jax_scan.ShardedScan([io.BytesIO(b) for b in blobs],
                              mesh=jm) as js:
        theirs = js.run()
    with port_scan.ShardedScan(blobs, mesh=pm) as ps:
        ours = ps.run()
    want, got = _gather_both(fn, jm, pm, theirs, ours, path,
                             {"gather_to": 0}, {"gather_to": "cpu"})
    rep = getattr(port_scan, fn)(pm, ours, path)
    n_arrays = 2 if fn == "gather_byte_column" else 1
    for g, w, r in zip(got[:n_arrays], want, rep):
        _same(g, w)
        _same(g, r)
    for g, w in zip(got[n_arrays:], want[n_arrays:]):
        np.testing.assert_array_equal(g, w)


@pytest.mark.parametrize("n_true", [0, 1, 5])
def test_assemble_direct_as_reference(n_true):
    """``_assemble_direct`` alone: the same padded rows (two streams, one
    of u32 rows, one of bytes) onto one CPU device in both packages."""
    from jax.sharding import SingleDeviceSharding

    rng = np.random.default_rng(n_true)
    rows_u32 = [rng.integers(0, 2**32, 12, dtype=np.uint32)
                for _ in range(n_true)]
    rows_u8 = [rng.integers(0, 256, 7, dtype=np.uint8)
               for _ in range(n_true)]
    want = jax_scan._assemble_direct(
        SingleDeviceSharding(jax.devices("cpu")[0]),
        [(rows_u32, (12,), np.uint32), (rows_u8, (7,), np.uint8)],
        n_true, 1, None)
    got = port_scan._assemble_direct(
        torch.device("cpu"),
        [([torch.from_numpy(r.view(np.int32)) for r in rows_u32], (12,),
          torch.int32),
         ([torch.from_numpy(r) for r in rows_u8], (7,), torch.uint8)],
        n_true)
    assert len(got) == len(want) == 2
    for g, w in zip(got, want):
        _same(g, np.asarray(w))
