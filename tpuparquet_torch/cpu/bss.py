"""BYTE_STREAM_SPLIT (NumPy): the k bytes of each k-byte value go to k
separate streams, stream b holding byte b of every value in order.  The
encoding of the Parquet format for floating-point data (Encodings.md,
"Byte Stream Split"), which it also allows for FIXED_LEN_BYTE_ARRAY rows;
both directions are one transpose."""

from __future__ import annotations

import numpy as np

__all__ = ["decode_byte_stream_split", "encode_byte_stream_split"]


def encode_byte_stream_split(values: np.ndarray) -> bytes:
    """The streams of a 1-D array of k-byte values, or of the rows of a
    ``(N, L)`` u8 matrix (``k = L``)."""
    v = np.ascontiguousarray(values)
    k = v.dtype.itemsize * (v.shape[1] if v.ndim == 2 else 1)
    return v.view(np.uint8).reshape(-1, k).T.tobytes()


def decode_byte_stream_split(data, count: int, dtype) -> np.ndarray:
    dt = np.dtype(dtype)
    k = dt.itemsize
    need = count * k
    if len(data) < need:
        raise ValueError("BYTE_STREAM_SPLIT: input too short")
    streams = np.frombuffer(data, dtype=np.uint8, count=need).reshape(k, count)
    return np.ascontiguousarray(streams.T).reshape(-1).view(dt)
