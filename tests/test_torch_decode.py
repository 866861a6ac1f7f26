"""K3 and K4 (tpuparquet_torch.kernels.decode) against the JAX package.

The plain versions of the dictionary-page kernel and of
levels_to_validity (also on K4's edge cases, chip_smoke.LEVELS_EDGE_CASES)
are held to ``tpuparquet.kernels.decode``'s
``page_dict_fixed_tbl``, ``page_dict_fixed_levels_tbl``,
``dict_gather_fixed`` and ``levels_to_validity``, bit for bit over the
whole bucket-padded output, on the same staged buffers.
"""

import sys
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpuparquet.kernels.decode import dict_gather_fixed as jax_dict_gather
from tpuparquet.kernels.decode import levels_to_validity as jax_validity
from tpuparquet.kernels.decode import page_dict_fixed_levels_tbl as \
    jax_page_levels
from tpuparquet.kernels.decode import page_dict_fixed_tbl as jax_page
from tpuparquet_torch.cpu.hybrid import encode_hybrid, scan_hybrid
from tpuparquet_torch.kernels.decode import levels_to_validity, \
    page_dict_fixed, page_dict_fixed_levels_tbl
from tpuparquet_torch.kernels.hybrid import expand_hybrid, plan_stream_args

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
import chip_smoke  # noqa: E402


def _t(a: np.ndarray) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(a).reshape(-1)
                            .view(np.int32).copy())


def _plan(vals: np.ndarray, width: int):
    sc = scan_hybrid(encode_hybrid(vals, width), vals.size, width)
    return plan_stream_args(sc, vals.size, width)


def _indices(n: int, top: int, seed: int, runs: bool) -> np.ndarray:
    rng = np.random.default_rng(seed)
    v = rng.integers(0, top, size=n).astype(np.uint32)
    if runs:
        for a in rng.integers(0, n - 40, size=6):
            v[a : a + 40] = v[a]
    return v


def _dictionary(n_dict: int, lanes: int, seed: int) -> np.ndarray:
    """A flat dictionary zero-padded to its bucket, as it is staged."""
    rng = np.random.default_rng(seed)
    d = rng.integers(0, 1 << 32, size=n_dict * lanes, dtype=np.uint64)
    out = np.zeros(max(32, d.size), dtype=np.uint32)  # bucket(d.size)
    out[: d.size] = d
    return out


@pytest.mark.parametrize("lanes", [1, 2])
@pytest.mark.parametrize("runs", [False, True])
@pytest.mark.parametrize("top", [6, 64])  # 64: indices past n_dict clamp
def test_dict_page_matches_jax(lanes, runs, top):
    n_dict, n = 6, 3000
    width = max(int(top - 1).bit_length(), 1)
    idx = _indices(n, top, seed=top + lanes, runs=runs)
    (bp, tbl), cnt, nbp, single = _plan(idx, width)
    d = _dictionary(n_dict, lanes, seed=lanes)
    got = page_dict_fixed(_t(d), _t(bp), _t(tbl), cnt, width, nbp, lanes,
                          single).numpy().view(np.uint32)
    want = np.asarray(jax_page(jnp.asarray(d), jnp.asarray(bp),
                               jnp.asarray(tbl), cnt, width, nbp,
                               lanes=lanes, isingle=single))
    assert got.shape == (cnt * lanes,)
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("lanes", [1, 2])
@pytest.mark.parametrize("top", [6, 64])
def test_run_table_page_via_expanded_indices_matches_jax(lanes, top):
    """On the card a run-table index stream is expanded by K2 and reaches
    K3 as one bit-packed run of width 32; that route gives the JAX
    package's page, padding and clamping included."""
    width = max(int(top - 1).bit_length(), 1)
    idx = _indices(3000, top, seed=top, runs=True)
    (bp, tbl), cnt, nbp, single = _plan(idx, width)
    assert not single
    d = _dictionary(6, lanes, seed=lanes)
    expanded = expand_hybrid(_t(bp), _t(tbl), cnt, width, nbp)
    got = page_dict_fixed(_t(d), expanded, None, cnt, 32, cnt, lanes, True)
    want = np.asarray(jax_page(jnp.asarray(d), jnp.asarray(bp),
                               jnp.asarray(tbl), cnt, width, nbp,
                               lanes=lanes, isingle=False))
    np.testing.assert_array_equal(got.numpy().view(np.uint32), want)


@pytest.mark.parametrize("lanes", [1, 2])
def test_dict_page_with_levels_matches_jax(lanes):
    rng = np.random.default_rng(lanes)
    n = 5000
    valid = rng.random(n) >= 0.05
    nn = int(valid.sum())
    idx = _indices(nn, 5, seed=9, runs=True)
    (ibp, itbl), icnt, inbp, isg = _plan(idx, 3)
    (dbp, dtbl), dcnt, dnbp, dsg = _plan(valid.astype(np.uint32), 1)
    d = _dictionary(5, lanes, seed=3)
    vals, dl = page_dict_fixed_levels_tbl(
        _t(d), _t(dbp), _t(dtbl), _t(ibp), _t(itbl), dcnt, 1, dnbp, icnt,
        3, inbp, lanes=lanes, dsingle=dsg, isingle=isg)
    jvals, jdl = jax_page_levels(
        jnp.asarray(d), jnp.asarray(dbp), jnp.asarray(dtbl),
        jnp.asarray(ibp), jnp.asarray(itbl), dcnt, 1, dnbp, icnt, 3, inbp,
        lanes=lanes, dsingle=dsg, isingle=isg)
    np.testing.assert_array_equal(vals.numpy().view(np.uint32),
                                  np.asarray(jvals))
    np.testing.assert_array_equal(dl.numpy(), np.asarray(jdl))
    np.testing.assert_array_equal(dl.numpy()[:n], valid.astype(np.int32))


@pytest.mark.parametrize("lanes", [1, 2])
def test_width_zero_page_matches_jax(lanes):
    """Width 0: every index is 0 (the JAX path's dict_gather_fixed)."""
    d = _dictionary(3, lanes, seed=11)
    got = page_dict_fixed(_t(d), None, None, 777, 0, 0, lanes)
    want = np.asarray(jax_dict_gather(jnp.asarray(d),
                                      jnp.zeros((777,), jnp.int32),
                                      lanes=lanes))
    np.testing.assert_array_equal(got.numpy().view(np.uint32), want)


@pytest.mark.parametrize("n", [1, 31, 1023, 1025, 70_001])
@pytest.mark.parametrize("max_def", [1, 2])
def test_levels_to_validity_matches_jax(n, max_def):
    dl = np.random.default_rng(n).integers(0, max_def + 1, size=n) \
        .astype(np.int32)
    mask, pos = levels_to_validity(torch.from_numpy(dl), max_def)
    jmask, jpos = jax_validity(jnp.asarray(dl), max_def)
    assert mask.dtype == torch.bool and pos.dtype == torch.int32
    np.testing.assert_array_equal(mask.numpy(), np.asarray(jmask))
    np.testing.assert_array_equal(pos.numpy(), np.asarray(jpos))


@pytest.mark.parametrize("case", list(chip_smoke.LEVELS_EDGE_CASES))
def test_levels_to_validity_edge_cases_match_jax(case):
    """K4's edge cases (chip_smoke.LEVELS_EDGE_CASES: sizes around a lane's
    4 slots and the kernel's tiles, look-back over 9 tiles, 2^21 + 3 slots,
    all null, no nulls, max_def 1 and 3, def levels from views 1-3 words
    into their buffer) through the port's CPU path and the JAX package."""
    buf, lead, max_def = chip_smoke.levels_case(
        np.random.default_rng(13), case)
    mask, pos = levels_to_validity(torch.from_numpy(buf)[lead:], max_def)
    jmask, jpos = jax_validity(jnp.asarray(buf[lead:]), max_def)
    np.testing.assert_array_equal(mask.numpy(), np.asarray(jmask))
    np.testing.assert_array_equal(pos.numpy(), np.asarray(jpos))


def test_dictionary_shape_checked():
    """A dictionary must hold one whole value; a staged one holds its
    values then padding, which need not fill a whole value (a padded
    3-lane INT96 dictionary), as the reference floors ``n_dict``."""
    with pytest.raises(ValueError):
        page_dict_fixed(torch.zeros(1, dtype=torch.int32), None, None, 10, 0,
                        0, lanes=2)
    d = torch.arange(7, dtype=torch.int32)
    np.testing.assert_array_equal(
        page_dict_fixed(d, None, None, 4, 0, 0, lanes=3).numpy(),
        np.tile([0, 1, 2], 4))
