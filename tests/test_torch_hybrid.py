"""Host plans and K2 (tpuparquet_torch.kernels.hybrid) against the JAX
package.

The port's run scan and its staging decision (``plan_stream_args``: keep
the run table, or re-pack the stream as one bit-packed run) must equal
the JAX package's array for array — the JAX side re-packs in native C
where the port re-packs in numpy.  K2's plain version must equal JAX
``expand_tbl`` over the whole bucket-padded output, padding included.
"""

import sys
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpuparquet.cpu.hybrid import encode_hybrid as jax_encode_hybrid
from tpuparquet.cpu.hybrid import scan_hybrid as jax_scan_hybrid
from tpuparquet.kernels.decode import expand_tbl as jax_expand_tbl
from tpuparquet.kernels.hybrid import expand_hybrid as jax_expand_hybrid
from tpuparquet.kernels.hybrid import pack_plan as jax_pack_plan
from tpuparquet.kernels.hybrid import plan_from_scan as jax_plan_from_scan
from tpuparquet.kernels.hybrid import plan_stream_args as jax_plan_stream_args
from tpuparquet_torch.cpu.hybrid import encode_hybrid, expand_scan, \
    scan_hybrid
from tpuparquet_torch.kernels.hybrid import count_eq_scan, expand_hybrid, \
    expand_hybrid_plain, hybrid_tile_slots, max_scan_value, pack_plan, \
    plan_from_scan, plan_stream_args

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

import chip_smoke  # noqa: E402


def _stream(kind: str, n: int, width: int, seed: int) -> np.ndarray:
    rng = np.random.default_rng(seed)
    hi = (1 << width) - 1
    if kind == "validity":  # 5% nulls: thousands of short runs
        return (rng.random(n) >= 0.05).astype(np.uint32)
    if kind == "random":  # no runs: one bit-packed run as written
        return rng.integers(0, hi + 1, size=n).astype(np.uint32)
    if kind == "indices":  # dictionary indices with a few RLE runs
        v = rng.integers(0, hi + 1, size=n).astype(np.uint32)
        for a in rng.integers(0, n - 64, size=4):
            v[a : a + 64] = v[a]
        return v
    if kind == "runs":  # long constant stretches between random values
        v = rng.integers(0, hi, size=n, endpoint=True).astype(np.uint32)
        for _ in range(max(n // 300, 1)):
            a = int(rng.integers(0, n))
            v[a : a + int(rng.integers(8, 400))] = rng.integers(0, hi + 1)
        return v
    if kind == "constant":
        return np.full(n, hi, dtype=np.uint32)
    raise ValueError(kind)


CASES = [("validity", 20_000, 1), ("validity", 500, 1), ("random", 3000, 9),
         ("indices", 20_000, 3), ("indices", 3000, 2), ("runs", 20_000, 5),
         ("runs", 4000, 13), ("constant", 3000, 4), ("runs", 2000, 32)]


def _assert_scans_equal(a, b):
    for x, y in zip(a, b):
        np.testing.assert_array_equal(np.asarray(x), np.asarray(y))


@pytest.mark.parametrize("kind,n,width", CASES)
def test_scan_and_stream_plan_match_jax(kind, n, width):
    vals = _stream(kind, n, width, seed=n + width)
    raw = encode_hybrid(vals, width)
    assert raw == jax_encode_hybrid(vals, width)
    sc = scan_hybrid(raw, n, width)
    _assert_scans_equal(sc, jax_scan_hybrid(raw, n, width))
    np.testing.assert_array_equal(expand_scan(*sc[:6], n, width), vals)
    (bp, tbl), cnt, nbp, single = plan_stream_args(sc, n, width)
    (jbp, jtbl), jcnt, jnbp, jsingle = jax_plan_stream_args(
        jax_scan_hybrid(raw, n, width), n, width)
    assert (cnt, nbp, single) == (jcnt, jnbp, jsingle)
    np.testing.assert_array_equal(bp, jbp)
    np.testing.assert_array_equal(tbl, jtbl)


def test_validity_stream_is_repacked_and_index_stream_is_not():
    """The two plan outcomes config 2 exercises: a 5%-null def-level
    stream re-packs as one bit-packed run, a small-dictionary index
    stream keeps its run table."""
    v = _stream("validity", 20_000, 1, seed=1)
    assert plan_stream_args(scan_hybrid(encode_hybrid(v, 1), v.size, 1),
                            v.size, 1)[3]
    i = _stream("indices", 20_000, 3, seed=2)
    assert not plan_stream_args(scan_hybrid(encode_hybrid(i, 3), i.size, 3),
                                i.size, 3)[3]


@pytest.mark.parametrize("kind,n,width", CASES)
def test_plain_expand_matches_jax_with_padding(kind, n, width):
    vals = _stream(kind, n, width, seed=7 * n + width)
    raw = encode_hybrid(vals, width)
    (bp, tbl), cnt, _, nbp = pack_plan(plan_from_scan(
        scan_hybrid(raw, n, width), n, width))
    (jbp, jtbl), jcnt, _, jnbp = jax_pack_plan(jax_plan_from_scan(
        jax_scan_hybrid(raw, n, width), n, width))
    np.testing.assert_array_equal(tbl, jtbl)
    bp_t = torch.from_numpy(bp.view(np.int32).copy())
    tbl_t = torch.from_numpy(tbl.reshape(-1).view(np.int32).copy())
    got = expand_hybrid(bp_t, tbl_t, cnt, width, nbp).numpy().view(np.uint32)
    want = np.asarray(jax_expand_tbl(jnp.asarray(jbp), jnp.asarray(jtbl),
                                     jcnt, width, jnbp))
    assert got.shape == (cnt,)
    np.testing.assert_array_equal(got, want)  # padded tail included
    np.testing.assert_array_equal(got[:n], vals)


@pytest.mark.parametrize("kind,n,width", [("validity", 20_000, 1),
                                          ("random", 5000, 7)])
def test_single_run_expand_matches_jax(kind, n, width):
    """``single=True`` (one bit-packed run) is the K1 path."""
    vals = _stream(kind, n, width, seed=n)
    sc = scan_hybrid(encode_hybrid(vals, width), n, width)
    (bp, tbl), cnt, nbp, single = plan_stream_args(sc, n, width)
    assert single
    got = expand_hybrid(
        torch.from_numpy(bp.view(np.int32).copy()),
        torch.from_numpy(tbl.reshape(-1).view(np.int32).copy()),
        cnt, width, nbp, single=True).numpy().view(np.uint32)
    want = np.asarray(jax_expand_tbl(jnp.asarray(bp), jnp.asarray(tbl), cnt,
                                     width, nbp, single=True))
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got[:n], vals)


def test_table_without_padding_runs_clamps_to_last_run():
    """32 runs fill the bucket exactly: slots past the count fall in the
    clamped last run, as in the JAX expansion."""
    vals = np.repeat(np.arange(32, dtype=np.uint32) % 4, 9)
    raw = encode_hybrid(vals, 2)
    sc = scan_hybrid(raw, vals.size, 2)
    assert len(sc[0]) == 32
    (bp, tbl), cnt, _, nbp = pack_plan(plan_from_scan(sc, vals.size, 2))
    got = expand_hybrid_plain(torch.from_numpy(bp.view(np.int32).copy()),
                              torch.from_numpy(tbl.reshape(-1).view(
                                  np.int32).copy()), cnt, 2, nbp)
    want = np.asarray(jax_expand_tbl(jnp.asarray(bp), jnp.asarray(tbl), cnt,
                                     2, nbp))
    np.testing.assert_array_equal(got.numpy().view(np.uint32), want)


def test_counts_and_max_from_scan():
    v = _stream("runs", 10_000, 3, seed=5)
    sc = scan_hybrid(encode_hybrid(v, 3), v.size, 3)
    assert count_eq_scan(sc, 3, 7) == int((v == 7).sum())
    assert max_scan_value(sc, 3) == int(v.max())
    with pytest.raises(ValueError):
        count_eq_scan(sc, 3, 6, validate_max=True)


@pytest.mark.parametrize("case", [
    name for name, case in chip_smoke.HYBRID_EDGE_CASES.items()
    if case[2](hybrid_tile_slots()) <= 1 << 16])
def test_hybrid_edge_cases_match_jax(case):
    """K2's edge cases (chip_smoke.HYBRID_EDGE_CASES: rate_code's shape,
    one RLE run, one bit-packed run as a table, a run-dense width-1
    stream, run ends on tile edges, runs of length 0, a table without
    padding runs, bp_start + within past nbp, widths 0-32, counts around
    the kernel's tiles, words and table from views off 16-byte
    boundaries; the 2^21-slot case runs on the card only) through the
    port's CPU path and the JAX package's expand_hybrid on the unpacked
    table columns."""
    wbuf, wl, tbuf, tl, cnt, w, nbp = chip_smoke.hybrid_case(
        np.random.default_rng(15), case)
    words, table = wbuf[wl:], tbuf[tl:]
    got = expand_hybrid(torch.from_numpy(wbuf.view(np.int32))[wl:],
                        torch.from_numpy(tbuf.view(np.int32))[tl:], cnt, w,
                        nbp).numpy().view(np.uint32)
    ends, is_rle, value, bp_start = table.reshape(4, -1)
    want = jax_expand_hybrid(
        jnp.asarray(words), jnp.asarray(ends.view(np.int32)),
        jnp.asarray(is_rle != 0), jnp.asarray(value),
        jnp.asarray(bp_start.view(np.int32)), count=cnt, width=w, n_bp=nbp)
    assert got.shape == (cnt,)
    np.testing.assert_array_equal(got, np.asarray(want))
