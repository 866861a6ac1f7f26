"""Dictionary building for the writer (first-occurrence interning), and
the host decode of dictionary pages' indices and their gather.

The dictionary lists the distinct values in the order they first occur
(what an interning writer produces, as the JAX package's
``tpuparquet/cpu/dictionary.py``), and the indices give each value's
position in it.  Integers with a small value range intern through a
dense table, other fixed-width values through ``np.unique`` re-ranked by
first occurrence, ``(N, L)`` rows (FIXED_LEN_BYTE_ARRAY bytes, INT96
words) through a vectorised row hash checked byte for byte, and byte
columns in one C pass (``csrc/bytes.c`` ``tpq_intern_var``) that stops as
soon as the distinct count passes the caller's cap.

:func:`decode_dict_indices` and :func:`gather` are the host decode of a
dictionary-encoded page (the degraded device read, ``kernels/device.py``
``cpu_fallback_values``), as the reference's.
"""

from __future__ import annotations

import numpy as np

from .hybrid import decode_hybrid
from .plain import ByteArrayColumn

__all__ = ["build_dictionary", "decode_dict_indices", "gather",
           "intern_byte_column"]


def decode_dict_indices(data, count: int) -> np.ndarray:
    """A dictionary page's indices (a bit-width byte, then a hybrid
    stream) as int32."""
    if count == 0:
        return np.empty(0, dtype=np.int32)
    if len(data) < 1:
        raise ValueError("empty dictionary-index stream")
    width = int(data[0])
    if width > 32:
        raise ValueError(f"dictionary index bit width {width} > 32")
    if width == 0:
        return np.zeros(count, dtype=np.int32)
    return decode_hybrid(data, count, width, pos=1).astype(np.int32)


def gather(dictionary, indices: np.ndarray):
    """The values at ``indices`` of a dictionary: fancy indexing of an
    array, a new offsets and data pair of a :class:`ByteArrayColumn`."""
    idx = np.asarray(indices)
    if isinstance(dictionary, ByteArrayColumn):
        if idx.size and (idx.min() < 0 or idx.max() >= len(dictionary)):
            raise ValueError("dictionary index out of range")
        return _gather_bytes(dictionary, idx)
    arr = np.asarray(dictionary)
    if idx.size and (idx.min() < 0 or idx.max() >= len(arr)):
        raise ValueError("dictionary index out of range")
    return arr[idx]


def _first_occurrence_rank(first_idx: np.ndarray):
    """``(order, rank)``: the unique values' order of first occurrence,
    and each unique value's rank in it."""
    order = np.argsort(first_idx, kind="stable")
    rank = np.empty(order.size, dtype=np.int64)
    rank[order] = np.arange(order.size)
    return order, rank


def _build_int_dictionary_smallrange(arr: np.ndarray):
    """O(n + range) interning of an integer column whose value range is
    at most ``4 n`` and ``2^24`` (the reference's gate); None otherwise.
    4- and 8-byte columns intern in C, narrower ones in numpy."""
    n = arr.size
    lo, hi = int(arr.min()), int(arr.max())
    span = hi - lo + 1
    if span > 4 * n or span > 1 << 24:
        return None
    if arr.itemsize in (4, 8):
        # one C pass (csrc/intern.c): the ids and the first-occurrence
        # order fall out of the sequential scan
        from ..native import intern_native

        uniq_pos, indices = intern_native().intern_range(
            np.ascontiguousarray(arr), lo, span)
        return arr[uniq_pos], indices
    off = arr.astype(np.int64) - lo
    first = np.full(span, n, dtype=np.int64)
    # reversed fancy assignment keeps the smallest original index
    first[off[::-1]] = np.arange(n - 1, -1, -1, dtype=np.int64)
    present = first < n
    order, rank = _first_occurrence_rank(first[present])
    lookup = np.empty(span, dtype=np.int64)
    lookup[present] = rank
    uniq = (np.nonzero(present)[0][order] + lo).astype(arr.dtype)
    return uniq, lookup[off].astype(np.int32)


def _hash_rows(rows: np.ndarray) -> np.ndarray:
    """FNV-style hash of each row of a (k, L) u8 matrix, over u64 words
    (the tail zero-padded), one multiply-add pass per 8 row bytes."""
    k, L = rows.shape
    nw = (L + 7) // 8
    padded = np.zeros((k, nw * 8), dtype=np.uint8)
    padded[:, :L] = rows
    words = padded.view("<u8")
    h = np.full(k, np.uint64(1469598103934665603 + 31 * L), dtype=np.uint64)
    prime = np.uint64(1099511628211)
    for j in range(nw):
        h = (h ^ words[:, j]) * prime
    return h


def _unique_rows_table(rows: np.ndarray, h: np.ndarray):
    """``(first_idx, inverse)`` by an O(k) slot table over the hashes, or
    None when two distinct rows share a slot (every row is compared with
    its slot's first occupant): the caller then takes the exact path."""
    k = rows.shape[0]
    tbits = max(16, min(22, (4 * k - 1).bit_length()))
    slot = ((h * np.uint64(0x9E3779B97F4A7C15))
            >> np.uint64(64 - tbits)).astype(np.int64)
    first = np.full(1 << tbits, k, dtype=np.int64)
    # reversed scatter keeps the last write: the smallest original index
    first[slot[::-1]] = np.arange(k - 1, -1, -1, dtype=np.int64)
    if not np.array_equal(rows[first[slot]], rows):
        return None
    present = first < k
    return first[present], (np.cumsum(present) - 1)[slot]


def _unique_rows(rows: np.ndarray):
    """``(first_idx, inverse)`` over the distinct rows of a (k, L) u8
    matrix, in some order (callers re-rank by first occurrence): the
    hash table at 4,096 rows and up, else, or on a collision, an exact
    memcmp unique."""
    if rows.shape[0] >= 4096:
        out = _unique_rows_table(rows, _hash_rows(rows))
        if out is not None:
            return out
    view = np.ascontiguousarray(rows).view(
        np.dtype((np.void, rows.shape[1]))).reshape(-1)
    _, first_idx, inv = np.unique(view, return_index=True,
                                  return_inverse=True)
    return first_idx, inv.reshape(-1)


def _gather_bytes(values: ByteArrayColumn,
                  idx: np.ndarray) -> ByteArrayColumn:
    """The values at ``idx``, as a new column (one C gather)."""
    from ..native import bytes_native

    lens = values.lengths()[idx]
    offsets = np.zeros(idx.size + 1, dtype=np.int64)
    np.cumsum(lens, out=offsets[1:])
    data = bytes_native().gather_var(values.data, values.offsets[:-1][idx],
                                     lens, int(offsets[-1]))
    return ByteArrayColumn(offsets, data)


def intern_byte_column(values: ByteArrayColumn, max_distinct: int):
    """``(dictionary, int32 indices)`` of a byte column, or
    :data:`~tpuparquet_torch.native.TOO_MANY_DISTINCT` once more than
    ``max_distinct`` distinct values appear (the writer's gate would
    reject the dictionary, so the pass stops early)."""
    from ..native import TOO_MANY_DISTINCT, bytes_native

    out = bytes_native().intern_var(values.data, values.offsets,
                                    max_distinct)
    if out is TOO_MANY_DISTINCT:
        return out
    firsts, indices = out
    return _gather_bytes(values, firsts), indices


def build_dictionary(values):
    """``(dictionary, int32 indices)`` in first-occurrence order, for an
    integer or float array, ``(N, L)`` rows or a :class:`ByteArrayColumn`
    (uncapped)."""
    if isinstance(values, ByteArrayColumn):
        return intern_byte_column(values, max(len(values), 1))
    arr = np.asarray(values)
    if arr.ndim == 2:
        rows = np.ascontiguousarray(arr).view(np.uint8).reshape(
            arr.shape[0], -1)
        first_idx, inv = _unique_rows(rows)
        order, rank = _first_occurrence_rank(first_idx)
        return arr[first_idx[order]], rank[inv].astype(np.int32)
    if arr.dtype.kind in "iu" and arr.size:
        out = _build_int_dictionary_smallrange(arr)
        if out is not None:
            return out
    uniq, first_idx, inv = np.unique(arr, return_index=True,
                                     return_inverse=True)
    order, rank = _first_occurrence_rank(first_idx)
    return uniq[order], rank[inv.reshape(-1)].astype(np.int32)
