"""The PLAIN wire transports (K5-K8 and their host planners) against the
JAX package.

The planners of ``tpuparquet_torch.kernels.device`` (byte planes, delta
lanes, snappy tokens) are held to ``tpuparquet.kernels.device``'s on the
same page bytes, output for output: wire estimates, the planes' spec and
six staged arrays, the delta plan's packed words, min_delta lanes,
``first`` and ``total``, and the token tables.  The kernels' plain
versions are held to ``planes_to_words``, ``unpack_u64``,
``expand_delta_i32/_i64``, ``expand_tokens`` and ``u8_to_u32_words(_at)``
bit for bit.  Integer data throughout, so every comparison is exact.
"""

import sys
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpuparquet.compress import snappy_single_literal_view as \
    jax_single_literal
from tpuparquet.format.metadata import Type as JaxType
from tpuparquet.kernels import device as jdev
from tpuparquet.kernels.bitunpack import unpack_u64 as jax_unpack_u64
from tpuparquet.kernels.decode import DeltaPlan as JaxDeltaPlan
from tpuparquet.kernels.decode import expand_delta_i32 as jax_delta_i32
from tpuparquet.kernels.decode import expand_delta_i64 as jax_delta_i64
from tpuparquet.kernels.decode import planes_to_words as jax_planes
from tpuparquet.kernels.decode import u8_to_u32_words as jax_u8_words
from tpuparquet.kernels.decode import u8_to_u32_words_at as jax_u8_words_at
from tpuparquet.kernels.snappy import expand_tokens as jax_expand_tokens
from tpuparquet.kernels.snappy import snappy_scan_tokens as jax_scan_tokens
from tpuparquet.native import pack_native as jax_pack_native
from tpuparquet_torch.compress import compress_block, snappy_scan_tokens, \
    snappy_single_literal_view
from tpuparquet_torch.cpu.bitpack import pack
from tpuparquet_torch.format.metadata import CompressionCodec, Type
from tpuparquet_torch.kernels import device as pdev
from tpuparquet_torch.kernels.bitunpack import pad_to_words, unpack_u64
from tpuparquet_torch.cpu.delta import encode_delta_binary_packed
from tpuparquet_torch.kernels.decode import DeltaPlan, bucket, \
    expand_delta_i32, expand_delta_i64, plan_delta_i32, plan_delta_i64, \
    planes_to_words, u8_to_u32_words_at
from tpuparquet_torch.kernels.snappy import decompress_device, \
    expand_tokens, expand_tokens_words, plan_tokens

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
import chip_smoke  # noqa: E402


def _t(a: np.ndarray) -> torch.Tensor:
    return chip_smoke._t(a, "cpu")


def _u32(t: torch.Tensor) -> np.ndarray:
    return t.numpy().view(np.uint32)


# ----------------------------------------------------------------------
# Pages: PLAIN value segments of the shapes the planners decide on
# ----------------------------------------------------------------------

def _pages():
    rng = np.random.default_rng(5)
    n = 20_000
    ts = 1_700_000_000_000 + rng.integers(0, 3_600_000, size=n).cumsum()
    return {
        # int64 timestamps: delta lanes (width 22) against planes
        "timestamps": (ts, Type.INT64),
        # small-range int64: byte planes (two random planes, two runs)
        "distance": (rng.integers(100, 50_000, size=n), Type.INT64),
        # a random low word under a slowly stepping high word: rle32 + raw32
        "lanes_raw": (rng.integers(0, 2**32, size=n)
                      + ((np.arange(n) // 5000) << 32), Type.INT64),
        # a slow int32 sequence that wraps: delta lanes at width 7
        "seq32": ((rng.integers(0, 100, size=n).cumsum() + 2**31 - 50_000)
                  .astype(np.int64).astype(np.int32), Type.INT32),
        # wide deltas: width 39, the three-word unpack
        "wide_delta": (rng.integers(0, 2**39, size=n).cumsum() - 2**60,
                       Type.INT64),
        # int32 < 2^16: byte planes inside a random lane
        "small32": (rng.integers(0, 2**16, size=n).astype(np.int32),
                    Type.INT32),
        # full entropy: every transport rejects
        "random": (rng.integers(-2**63, 2**63 - 1, size=n), Type.INT64),
        # a constant run: width-0 deltas
        "constant": (np.full(n, -7, np.int64), Type.INT64),
    }


PAGES = _pages()


@pytest.mark.parametrize("name", sorted(PAGES))
@pytest.mark.parametrize("budget", [None, 60_000])
def test_plane_planner_matches_jax(name, budget):
    vals, ptype = PAGES[name]
    seg = vals.view(np.uint8)
    lanes = 2 if ptype == Type.INT64 else 1
    jstg, pstg = jdev._Stager(), pdev._Stager()
    want = jdev._plan_plane_words(seg, vals.size, lanes, jstg, budget=budget)
    got = pdev._plan_plane_words(seg, vals.size, lanes, pstg, budget=budget)
    assert (got is None) == (want is None)
    if got is None:
        assert not jstg.arrays and not pstg.arrays
        return
    assert got[0] == want[0]  # the built tables' wire
    assert got[2] == want[1].__defaults__[1]  # the spec K5 reads
    assert len(pstg.arrays) == len(jstg.arrays) == 6
    for (a, pad), b in zip(pstg.arrays, jstg.arrays):
        assert not pad
        assert a.nbytes == b.nbytes
        np.testing.assert_array_equal(a.view(b.dtype), b)
    # K5's plain version on the staged arrays equals the JAX rebuild,
    # and both give the page back
    spec = got[2]
    ours = planes_to_words(*(_t(a) for a, _ in pstg.arrays), spec,
                           vals.size, lanes)
    theirs = jax_planes(*(jnp.asarray(b) for b in jstg.arrays), spec,
                        vals.size, lanes)
    np.testing.assert_array_equal(_u32(ours), np.asarray(theirs))
    np.testing.assert_array_equal(_u32(ours), vals.view(np.uint32))


@pytest.mark.parametrize("case", list(chip_smoke.PLANES_EDGE_CASES))
def test_planes_to_words_edge_cases_match_jax(case):
    """K5's edge cases (chip_smoke.PLANES_EDGE_CASES: counts around the
    kernel's tiles and 4-value groups, raw slabs 1-3, runs of length 1,
    one run over the page, run ends on tile edges, table slices past 0,
    lanes 1-4, buffers from views) through the port's CPU path and the
    JAX package's planes_to_words."""
    bufs, leads, spec, count, lanes = chip_smoke.planes_case(
        np.random.default_rng(17), case)
    views = [b[k:] for b, k in zip(bufs, leads)]
    ours = planes_to_words(*(_t(v) for v in views), spec, count, lanes)
    theirs = jax_planes(*(jnp.asarray(v) for v in views), spec, count,
                        lanes)
    assert ours.shape == (count * lanes,)
    np.testing.assert_array_equal(_u32(ours), np.asarray(theirs))


@pytest.mark.parametrize("name", sorted(PAGES))
def test_delta_planner_matches_jax(name):
    vals, ptype = PAGES[name]
    seg = vals.view(np.uint8)
    jtype = JaxType(int(ptype))
    want = jdev._plan_delta_lane_words(seg, vals.size, jtype)
    got = pdev._plan_delta_lane_words(seg, vals.size, ptype)
    if want is None:  # the JAX planner also declines without its packer
        assert got is None or jax_pack_native() is None
        return
    assert got is not None and got[0] == want[0]
    jstg, pstg = jdev._Stager(), pdev._Stager()
    jwords, pwords = want[1](jstg), got[1](pstg)
    assert len(pstg.arrays) == len(jstg.arrays)
    for (a, _), b in zip(pstg.arrays, jstg.arrays):
        np.testing.assert_array_equal(a.view(b.dtype), b)
    # the staged plan: packed words, min_delta lanes, first, total
    jplan = jwords.__defaults__[0](jstg.arrays)
    pplan = pwords.__defaults__[0]([_t(a) for a, _ in pstg.arrays])
    assert (pplan.block_size, pplan.first, pplan.total) == \
        (jplan.block_size, jplan.first, jplan.total)
    assert [g[0] for g in pplan.groups] == [g[0] for g in jplan.groups]
    rebuilt = pwords([_t(a) for a, _ in pstg.arrays])
    np.testing.assert_array_equal(_u32(rebuilt), vals.view(np.uint32))
    np.testing.assert_array_equal(
        _u32(rebuilt), np.asarray(jwords(list(map(jnp.asarray,
                                                  jstg.arrays)))))


def _blocks():
    """name -> (snappy block, its bytes): four compressed pages, then the
    edges of K8's tiles (16 KiB of output a block): a chain through 19
    tiles, copies across tile edges, hand-made copies with 4-byte offsets
    from more than 64 KiB back, literal tokens longer than a tile, and a
    length of 3 mod 4."""
    rng = np.random.default_rng(9)
    data = {
        "repeated": np.repeat(rng.integers(-2**62, 2**62, size=(300, 64)), 4,
                              axis=0).reshape(-1).view(np.uint8),
        "runs": np.concatenate([np.full(30_000, 3, np.uint8),
                                rng.integers(0, 256, 777).astype(np.uint8),
                                np.full(4_001, 9, np.uint8)]),
        "random": rng.integers(0, 256, size=50_000).astype(np.uint8),
        "timestamps": PAGES["timestamps"][0].view(np.uint8),
    }
    blocks = {k: (compress_block(CompressionCodec.SNAPPY, v), v)
              for k, v in data.items()}
    edges = chip_smoke.token_blocks(np.random.default_rng(10))
    for k in ("run over the tiles", "copies across tiles",
              "copies past 64 KiB", "literals over a tile",
              "length 3 mod 4"):
        blocks[k] = edges[k]
    return blocks


BLOCKS = _blocks()


@pytest.mark.parametrize("name", sorted(BLOCKS))
def test_token_planner_matches_jax(name):
    comp, data = BLOCKS[name]
    for a, b in zip(snappy_scan_tokens(comp), jax_scan_tokens(comp)):
        np.testing.assert_array_equal(a, b)
    s1, s2 = snappy_single_literal_view(comp), jax_single_literal(comp)
    assert (s1 is None) == (s2 is None)
    want = jdev._plan_token_expansion(comp, data.size)
    got = pdev._plan_token_expansion(comp, data.size)
    assert (got is None) == (want is None)
    if got is not None:
        for a, b in zip(got, want):
            np.testing.assert_array_equal(a, b)
    for off in (0, 5):
        nw = (data.size - off) // 4
        w = jdev._plan_device_snappy_words(comp, data.size, nw, offset=off)
        g = pdev._plan_device_snappy_words(comp, data.size, nw, offset=off)
        assert (g is None) == (w is None)
        assert g is None or g[0] == w[0]


# ----------------------------------------------------------------------
# The kernels' plain versions against the JAX functions
# ----------------------------------------------------------------------

# JAX compiles per width and shape: every width is checked against the
# numpy truth, a spread of them (the K1/K6 boundary and the widths the
# transport mix and config 2 ship) against the JAX functions as well
JAX_WIDTHS64 = (0, 1, 7, 22, 31, 32, 33, 39, 52, 63, 64)


@pytest.mark.parametrize("count", [77, 1000])
def test_unpack_u64_matches_jax(count):
    rng = np.random.default_rng(count)
    for w in range(65):
        vals = (rng.integers(0, 2**63, size=count, dtype=np.uint64) * 2
                + rng.integers(0, 2, size=count, dtype=np.uint64))
        if w < 64:
            vals &= np.uint64((1 << w) - 1)
        words = pad_to_words(np.frombuffer(pack(vals, w), np.uint8),
                             max(w, 1), count).reshape(-1)
        lo, hi = unpack_u64(_t(words), w, count)
        got = (_u32(lo).astype(np.uint64)
               | (_u32(hi).astype(np.uint64) << np.uint64(32)))
        np.testing.assert_array_equal(got, vals, err_msg=f"width {w}")
        if w in JAX_WIDTHS64:
            jlo, jhi = jax_unpack_u64(jnp.asarray(words), w, count)
            np.testing.assert_array_equal(_u32(lo), np.asarray(jlo))
            np.testing.assert_array_equal(_u32(hi), np.asarray(jhi))


def _delta_plan(rng, total: int, w: int, lanes: int, block_size: int,
                start: int = 0):
    """A DeltaPlan's arguments built with numpy — one contiguous
    width-``w`` group placed at ``start`` (the deltas before it are 0),
    negative min_deltas, a first value that wraps — and the values it
    encodes, rebuilt with numpy's wrapping u64 arithmetic."""
    n = total - 1
    nb = -(-max(n, 1) // block_size)
    md = rng.integers(-2**63, 0, size=nb).view(np.uint64)
    mask = np.uint64((1 << (32 * lanes)) - 1)
    md &= mask
    md_lo = (md & np.uint64(0xFFFFFFFF)).astype(np.uint32)
    md_hi = (md >> np.uint64(32)).astype(np.uint32)
    first = int(rng.integers(-2**63, 2**63 - 1))
    groups = []
    d = np.zeros(max(n, 0), np.uint64)
    if w:
        n_take = n - start
        n_vals = -(-n_take // 32) * 32
        off = rng.integers(0, 2**63, size=n_vals, dtype=np.uint64) * 2 + 1
        if w < 64:
            off &= np.uint64((1 << w) - 1)
        words = pad_to_words(np.frombuffer(pack(off, w), np.uint8), w,
                             n_vals).reshape(-1)
        groups.append((w, words, None, None, n_vals, start, n_take))
        d[start:] = off[:n_take]
    steps = d + md[np.arange(max(n, 0)) // block_size]
    vals = np.cumsum(np.concatenate(
        [[np.uint64(first & 0xFFFFFFFFFFFFFFFF)], steps]), dtype=np.uint64)
    vals = (vals & mask)[:total]
    truth = (vals.astype(np.uint32) if lanes == 1
             else vals.view(np.uint32))
    return (groups, md_lo, md_hi, block_size, first, total), truth


def _port_plan(args) -> DeltaPlan:
    """The port's DeltaPlan over the same buffers, as CPU tensors."""
    groups, md_lo, md_hi, block_size, first, total = args
    return DeltaPlan([(g[0], _t(g[1]), *g[2:]) for g in groups], _t(md_lo),
                     _t(md_hi), block_size, first, total)


@pytest.mark.parametrize("lanes", [1, 2])
def test_expand_delta_matches_jax(lanes):
    """Contiguous groups at every width the transport ships (0..63 for
    int64, 0..31 for int32), one min_delta for the page or one per 128
    deltas, a group covering the stream or starting inside it."""
    rng = np.random.default_rng(lanes)
    ours_fn, jax_fn = ((expand_delta_i32, jax_delta_i32) if lanes == 1
                       else (expand_delta_i64, jax_delta_i64))
    total = 1000
    for w in range(32 * lanes):
        for block_size, start in ((total - 1, 0), (128, 37)):
            args, truth = _delta_plan(rng, total, w, lanes, block_size,
                                      start)
            got = ours_fn(_port_plan(args))
            assert got.shape == (total * lanes,)
            np.testing.assert_array_equal(_u32(got), truth,
                                          err_msg=f"width {w}")
            if w in JAX_WIDTHS64 and block_size == 128:
                np.testing.assert_array_equal(
                    _u32(got), np.asarray(jax_fn(JaxDeltaPlan(*args))),
                    err_msg=f"width {w}")
    for total in (0, 1, 2):
        args, truth = _delta_plan(rng, total, 5 if total == 2 else 0, lanes,
                                  1)
        got = _u32(ours_fn(_port_plan(args)))
        np.testing.assert_array_equal(got, truth)
        np.testing.assert_array_equal(
            got, np.asarray(jax_fn(JaxDeltaPlan(*args))))


@pytest.mark.parametrize("lanes", [1, 2])
@pytest.mark.parametrize("block_size", [128, 256])
@pytest.mark.parametrize("total", [t for name in ("tile edges", "many tiles")
                                   for t in chip_smoke.K7_CASES[name][0]])
def test_expand_delta_tile_edges_match_jax(total, block_size, lanes):
    """The rebuild at K7's edges on the card (chip_smoke.K7_CASES): value
    counts one short of, at and one past a 4,096-value tile and its
    double, and across 38 tiles, with a width-7 (int32) or width-39
    (int64) group starting inside the stream."""
    rng = np.random.default_rng(total + block_size)
    ours_fn, jax_fn = ((expand_delta_i32, jax_delta_i32) if lanes == 1
                       else (expand_delta_i64, jax_delta_i64))
    args, truth = _delta_plan(rng, total, 7 if lanes == 1 else 39, lanes,
                              block_size, 37)
    got = _u32(ours_fn(_port_plan(args)))
    np.testing.assert_array_equal(got, truth)
    np.testing.assert_array_equal(got, np.asarray(jax_fn(JaxDeltaPlan(
        *args))))


def test_scattered_delta_group_not_supported():
    """A width class whose miniblocks do not land back to back (a
    DELTA_BINARY_PACKED page's) is placed by K11's plain version, for
    int64 and int32 alike: the rebuild gives the values back."""
    rng = np.random.default_rng(5)
    gaps = np.where(rng.random(4000) < 0.5, 3, 1 << 20)
    vals = np.cumsum(np.repeat(gaps, 32)).astype(np.int64)
    for plan_fn, expand, v in ((plan_delta_i64, expand_delta_i64, vals),
                               (plan_delta_i32, expand_delta_i32,
                                vals.astype(np.int32))):
        plan = plan_fn(encode_delta_binary_packed(v))
        assert any(g[2] is not None for g in plan.groups)
        dev_plan = DeltaPlan(
            [(w, _t(words), None if st is None else _t(st),
              None if tk is None else _t(tk), nv, s0, nt)
             for w, words, st, tk, nv, s0, nt in plan.groups],
            _t(plan.md_lo), _t(plan.md_hi), plan.block_size, plan.first,
            plan.total)
        np.testing.assert_array_equal(
            expand(dev_plan).numpy().view(v.dtype), v)


@pytest.mark.parametrize("name", sorted(BLOCKS))
def test_expand_tokens_matches_jax(name):
    comp, data = BLOCKS[name]
    te, ts, lp, out_cap, steps, out_len = plan_tokens(comp, data.size)
    blob = expand_tokens(_t(te), _t(ts), _t(lp), out_cap, steps)
    jblob = jax_expand_tokens(jnp.asarray(te), jnp.asarray(ts),
                              jnp.asarray(lp), out_cap, steps)
    # the whole bucket, tail included, is the JAX kernel's
    np.testing.assert_array_equal(blob.numpy(), np.asarray(jblob))
    np.testing.assert_array_equal(blob.numpy()[:out_len], data)
    for off in (0, 1, 3, 6):
        nw = (out_len - off) // 4
        words = expand_tokens_words(_t(te), _t(ts), _t(lp), out_cap, steps,
                                    off, nw)
        want = (jax_u8_words(jblob, nw) if off == 0
                else jax_u8_words_at(jblob, jnp.int32(off), nw))
        np.testing.assert_array_equal(_u32(words), np.asarray(want))
        np.testing.assert_array_equal(
            _u32(words), np.ascontiguousarray(data[off : off + 4 * nw])
            .view("<u4"))
        np.testing.assert_array_equal(
            _u32(u8_to_u32_words_at(blob, off, nw)), _u32(words))
    np.testing.assert_array_equal(_u32(u8_to_u32_words_at(blob, 0, 7)),
                                  np.asarray(jax_u8_words(jblob, 7)))


def test_decompress_device_on_cpu():
    comp, data = BLOCKS["runs"]
    out = decompress_device(comp, data.size, device="cpu")
    assert out.dtype == torch.uint8
    np.testing.assert_array_equal(out.numpy(), data)


def test_token_tail_matches_jax_when_tokens_fill_their_bucket():
    """64 hand-made tokens, so the token table has no padding token: the
    clamped last token serves the output's padding bytes, as in the JAX
    kernel, and every copy chain resolves to the same literal."""
    rng = np.random.default_rng(3)
    te, ts, pos, lit = [], [], 0, 0
    for k in range(64):
        ln = int(rng.integers(1, 9))
        if k == 0 or rng.random() < 0.4:
            ts.append(-(lit + 1))
            lit += ln
        else:
            ts.append(pos - int(rng.integers(1, pos + 1)))
        pos += ln
        te.append(pos)
    te, ts = np.asarray(te, np.int32), np.asarray(ts, np.int32)
    lp = rng.integers(0, 256, size=bucket(lit)).astype(np.uint8)
    out_cap, steps = bucket(pos), int(np.ceil(np.log2(pos)))
    got = expand_tokens(_t(te), _t(ts), _t(lp), out_cap, steps)
    want = jax_expand_tokens(jnp.asarray(te), jnp.asarray(ts),
                             jnp.asarray(lp), out_cap, steps)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_stager_carries_bytes_at_their_length():
    stg = pdev._Stager()
    b = np.arange(7, dtype=np.uint8)
    w = np.arange(5, dtype=np.uint32)
    stg.add_many([b, w, b[:1]], pad=False)
    with pytest.raises(TypeError):
        stg.add(w.astype(np.int64))  # words are 4 bytes, bytes 1
    from tpuparquet_torch.stats import collect_stats

    with collect_stats() as st:
        (staged,), _slab = pdev._put_all([stg], torch.device("cpu"))
    assert st.bytes_staged == 7 + 4 * 5 + 1
    assert staged[0].dtype == torch.uint8 and staged[0].numel() == 7
    np.testing.assert_array_equal(staged[0].numpy(), b)
    np.testing.assert_array_equal(_u32(staged[1]), w)
    np.testing.assert_array_equal(staged[2].numpy(), b[:1])


def test_bucket_matches_jax():
    from tpuparquet.kernels.decode import bucket as jax_bucket

    assert [bucket(n) for n in range(0, 5000, 37)] == \
        [jax_bucket(n) for n in range(0, 5000, 37)]
    for n in (0, 1, 31, 32_767, 32_768, 1 << 20, (1 << 22) + 5,
              (5 << 22) + 99_999):
        assert 4 * pdev._padded_len(n) == jdev._padded_u32_bytes(n)
