"""K1 (tpuparquet_torch.kernels.bitunpack) against the JAX package.

The plain PyTorch version — what the wrapper runs for CPU tensors — is
held to ``tpuparquet.kernels.bitunpack.unpack_u32`` and to the Pallas
kernel in interpret mode, bit for bit, on the same packed words.  The
CUDA kernel itself is held to the plain version on the card by
``tests/test_torch_cuda.py`` and ``chip_smoke.py``.
"""

import sys
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpuparquet.cpu.bitpack import pack
from tpuparquet.kernels.bitunpack import pad_to_words as jax_pad_to_words
from tpuparquet.kernels.bitunpack import unpack_u32 as jax_unpack_u32
from tpuparquet.kernels.bitunpack import unpack_u32_pallas
from tpuparquet_torch.kernels.bitunpack import pad_to_words, \
    unpack_tile_lanes, unpack_u32, unpack_u32_plain

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

import chip_smoke  # noqa: E402


def _packed(width: int, count: int, seed: int):
    rng = np.random.default_rng(seed)
    hi = (1 << width) - 1 if width else 0
    vals = rng.integers(0, hi, size=count, endpoint=True, dtype=np.uint64)
    raw = np.frombuffer(pack(vals, width), np.uint8)
    words = pad_to_words(raw, max(width, 1), count)
    np.testing.assert_array_equal(
        words, jax_pad_to_words(raw, max(width, 1), count))
    return vals, words


def _t(words: np.ndarray) -> torch.Tensor:
    return torch.from_numpy(words.reshape(-1).view(np.int32).copy())


@pytest.mark.parametrize("width", list(range(33)))
def test_plain_matches_jax_every_width(width):
    vals, words = _packed(width, 1000, seed=width)
    got = unpack_u32_plain(_t(words), width, 1000).numpy().view(np.uint32)
    want = np.asarray(jax_unpack_u32(jnp.asarray(words.reshape(-1)), width,
                                     1000))
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got, vals.astype(np.uint32))
    if width:
        pallas = np.asarray(unpack_u32_pallas(jnp.asarray(words), width,
                                              1000, interpret=True))
        np.testing.assert_array_equal(got, pallas)


@pytest.mark.parametrize("count", [1, 31, 33, 37, 1023, 4097])
@pytest.mark.parametrize("width", [1, 3, 17, 32])
def test_counts_not_multiple_of_32(width, count):
    vals, words = _packed(width, count, seed=count)
    got = unpack_u32(_t(words), width, count).numpy().view(np.uint32)
    want = np.asarray(jax_unpack_u32(jnp.asarray(words.reshape(-1)), width,
                                     count))
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got, vals.astype(np.uint32))


def test_cpu_tensor_takes_plain_version_without_launch():
    _, words = _packed(5, 100, seed=1)
    before = unpack_u32.launches
    out = unpack_u32(_t(words), 5, 100)
    assert out.dtype == torch.int32 and out.shape == (100,)
    assert unpack_u32.launches == before


def test_short_words_rejected():
    with pytest.raises(ValueError):
        unpack_u32(torch.zeros(2, dtype=torch.int32), 3, 64)


@pytest.mark.parametrize("case", [
    name for name, case in chip_smoke.UNPACK_EDGE_CASES.items()
    if case[1](unpack_tile_lanes()) <= 1 << 16])
def test_unpack_edge_cases_match_jax(case):
    """K1's edge cases (chip_smoke.UNPACK_EDGE_CASES: counts around a
    thread's 4 lanes, a 32-lane block and the kernel's tiles, words from
    views 1-3 words into their buffer and ending exactly at ceil(count /
    32) * width) at every width of UNPACK_WIDTHS, through the port's CPU
    path, the JAX package's unpack_u32 and, above width 0, its Pallas
    kernel in interpret mode; the 2^21-lane cases run on the card
    only."""
    for w, buf, lead, count, vals in chip_smoke.unpack_case(
            np.random.default_rng(14), case):
        words = buf[lead:]
        got = unpack_u32(torch.from_numpy(buf.view(np.int32))[lead:], w,
                         count).numpy().view(np.uint32)
        np.testing.assert_array_equal(got, vals.astype(np.uint32))
        np.testing.assert_array_equal(
            got, np.asarray(jax_unpack_u32(jnp.asarray(words), w, count)))
        if w:
            np.testing.assert_array_equal(got, np.asarray(unpack_u32_pallas(
                jnp.asarray(words), w, count, interpret=True)))
