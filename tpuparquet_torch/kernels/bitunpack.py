"""K1 and K6: unpack LSB-first ``width``-bit values to u32 lanes.

The port of ``tpuparquet/kernels/bitunpack.py`` ``unpack_u32`` and its
Pallas twin ``unpack_u32_pallas`` (K1, ``csrc/unpack_u32.cu``), and of
``unpack_u64`` (K6, ``csrc/unpack_u64.cu``, widths 33..64 as ``(lo, hi)``
lanes): a block of 32 consecutive values occupies exactly ``width`` u32
words, so value ``i`` starts at bit ``i * width`` of the flat word
stream.  Each ``*_plain`` function is the same function in plain
PyTorch, which the wrapper runs for CPU tensors.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from ._lib import check_tensor, count_launch, i64_to_u32_bits, launch, \
    stream_of, u32_to_i64

__all__ = ["pad_to_words", "plan_tables64", "unpack_tile_lanes", "unpack_u32",
           "unpack_u32_plain", "unpack_u64", "unpack_u64_plain"]


def pad_to_words(data, width: int, count: int) -> np.ndarray:
    """Host staging: pad a packed byte stream to whole 32-value blocks and
    return it as (n_blocks, width) little-endian u32 words."""
    buf = data if isinstance(data, np.ndarray) else np.frombuffer(
        data, dtype=np.uint8)
    n_blocks = (count + 31) // 32
    need = n_blocks * width * 4
    if len(buf) < need:
        padded = np.zeros(need, dtype=np.uint8)
        padded[: len(buf)] = buf
        buf = padded
    else:
        buf = buf[:need]
    return buf.view("<u4").reshape(n_blocks, width)


def _check_words(words, width: int, count: int) -> None:
    if not 0 <= width <= 32:
        raise ValueError(f"bit width {width} out of range 0..32")
    need = (count + 31) // 32 * width
    if words.numel() < need:
        raise ValueError(f"{count} lanes of width {width} need {need} "
                         f"words, got {words.numel()}")


def unpack_u32_plain(words: torch.Tensor, width: int,
                     count: int) -> torch.Tensor:
    """Plain PyTorch version: (count,) u32 lanes as int32 bits."""
    if width == 0:
        return torch.zeros(count, dtype=torch.int32, device=words.device)
    w64 = u32_to_i64(words)
    bit = torch.arange(count, dtype=torch.int64, device=words.device) * width
    word = bit >> 5
    sh = bit & 31
    lo = w64[word] >> sh
    nxt = w64[torch.clamp(word + 1, max=max(w64.numel() - 1, 0))]
    straddle = sh + width > 32
    # the shift count 32 - sh is only taken where the value straddles
    hi = torch.where(straddle, (nxt << (32 - sh)) & 0xFFFFFFFF,
                     torch.zeros_like(lo))
    return i64_to_u32_bits((lo | hi) & ((1 << width) - 1))


def unpack_tile_lanes() -> int:
    """Lanes a block of K1 unpacks (the kernel's tile: 256 threads, each 2
    rows of 4 lanes)."""
    return 2048


def unpack_u32(words: torch.Tensor, width: int, count: int) -> torch.Tensor:
    """Unpack ``count`` ``width``-bit lanes (0 <= width <= 32) from flat
    u32 words (an int32 tensor, at least ``ceil(count/32) * width``
    words).  CUDA tensors launch K1; CPU tensors take the plain
    version."""
    _check_words(words, width, count)
    if words.device.type == "cpu":
        return unpack_u32_plain(words, width, count)
    if words.device.type != "cuda":
        raise ValueError(f"unsupported device {words.device}")
    check_tensor(words, "words", torch.int32, words.device)
    out = torch.empty(count, dtype=torch.int32, device=words.device)
    launch("unpack_u32", words.data_ptr(), out.data_ptr(), count, width,
           unpack_tile_lanes(), stream_of(out))
    count_launch(unpack_u32)
    return out


unpack_u32.launches = 0


# ----------------------------------------------------------------------
# K6: widths up to 64, as (lo, hi) u32 lanes
# ----------------------------------------------------------------------

@functools.lru_cache(maxsize=None)
def plan_tables64(width: int):
    """Static ``(widx, widx2, widx3, shift)`` tables of a 32-value block
    of ``width``-bit values: value ``j`` starts at bit ``j * width``, so
    its 64 bits live in up to three consecutive words; the second and
    third index are clamped to the block's last word."""
    bit = np.arange(32) * width
    widx = bit // 32
    return (tuple(widx.tolist()),
            tuple(np.minimum(widx + 1, width - 1).tolist()),
            tuple(np.minimum(widx + 2, width - 1).tolist()),
            tuple((bit % 32).tolist()))


def _chunk32(w_lo, w_hi, shift):
    """32 bits starting ``shift`` bits into ``w_lo`` (int64 holding u32;
    the shift by 32 that shift == 0 would take is gated off)."""
    hi_part = torch.where(shift > 0, (w_hi << (32 - shift)) & 0xFFFFFFFF,
                          torch.zeros_like(w_hi))
    return (w_lo >> shift) | hi_part


def _check_words64(words, width: int, count: int) -> None:
    if not 0 <= width <= 64:
        raise ValueError(f"bit width {width} out of range 0..64")
    need = (count + 31) // 32 * width
    if words.numel() < need:
        raise ValueError(f"{count} lanes of width {width} need {need} "
                         f"words, got {words.numel()}")


def unpack_u64_plain(words: torch.Tensor, width: int, count: int):
    """Plain PyTorch version of :func:`unpack_u64`."""
    dev = words.device
    if width == 0:
        z = torch.zeros(count, dtype=torch.int32, device=dev)
        return z, z.clone()
    if width <= 32:
        return (unpack_u32_plain(words, width, count),
                torch.zeros(count, dtype=torch.int32, device=dev))
    n_blocks = (count + 31) // 32
    w = u32_to_i64(words[: n_blocks * width]).reshape(n_blocks, width)
    widx, widx2, widx3, shift = (torch.tensor(t, dtype=torch.int64,
                                              device=dev)
                                 for t in plan_tables64(width))
    lo = _chunk32(w[:, widx], w[:, widx2], shift)
    hi = _chunk32(w[:, widx2], w[:, widx3], shift)
    if width < 64:
        hi = hi & ((1 << (width - 32)) - 1)
    return (i64_to_u32_bits(lo.reshape(-1)[:count]),
            i64_to_u32_bits(hi.reshape(-1)[:count]))


def unpack_u64(words: torch.Tensor, width: int, count: int):
    """Unpack ``count`` LSB-first ``width``-bit values (0 <= width <= 64)
    into ``(lo, hi)`` u32 lanes (int32 tensors).  Width 0 gives zeros and
    widths up to 32 are K1 plus a zero hi lane, as in the JAX function;
    wider values launch K6 on a CUDA tensor.  CPU tensors take the plain
    version."""
    _check_words64(words, width, count)
    if words.device.type == "cpu":
        return unpack_u64_plain(words, width, count)
    if words.device.type != "cuda":
        raise ValueError(f"unsupported device {words.device}")
    dev = words.device
    if width <= 32:
        lo = (unpack_u32(words, width, count) if width else
              torch.zeros(count, dtype=torch.int32, device=dev))
        return lo, torch.zeros(count, dtype=torch.int32, device=dev)
    check_tensor(words, "words", torch.int32, dev)
    lo = torch.empty(count, dtype=torch.int32, device=dev)
    hi = torch.empty(count, dtype=torch.int32, device=dev)
    launch("unpack_u64", words.data_ptr(), lo.data_ptr(), hi.data_ptr(),
           count, width, stream_of(lo))
    count_launch(unpack_u64)
    return lo, hi


unpack_u64.launches = 0
