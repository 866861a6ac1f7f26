"""DELTA_BINARY_PACKED (NumPy, with the block walk in C), and the two
string encodings built on it: DELTA_LENGTH_BYTE_ARRAY and
DELTA_BYTE_ARRAY.

Wire format: header = ``block_size`` uvarint, ``miniblocks_per_block``
uvarint, ``total_value_count`` uvarint, ``first_value`` zigzag varint;
then per block: ``min_delta`` zigzag varint, one width byte per
miniblock, and the bit-packed miniblock delta payloads (LSB-first).
Values are the prefix sum ``v[i+1] = v[i] + min_delta + delta[i]`` with
two's-complement wraparound at the target width.

:func:`scan_delta_structure` is the one parse of that format: the device
planner (``kernels/decode.py plan_delta_i32/_i64``) and the decoder here
both start from its per-miniblock bookkeeping, so their validation
cannot drift.  Encoder defaults: block 128, 4 miniblocks of 32.

DELTA_LENGTH_BYTE_ARRAY is the values' lengths (DELTA_BINARY_PACKED) then
their bytes back to back; DELTA_BYTE_ARRAY (front coding) is each value's
prefix length shared with the value before it (DELTA_BINARY_PACKED) then
the suffixes as DELTA_LENGTH_BYTE_ARRAY.  The front-coded fill and the
writer's prefix pass run in C (``csrc/delta.c``): both walk the values
one after another.
"""

from __future__ import annotations

import numpy as np

from ..native import bytes_native, delta_native, pack_native
from ..varint import read_uvarint, read_zigzag, write_uvarint, write_zigzag
from .plain import ByteArrayColumn

__all__ = [
    "DeltaStructure",
    "assemble_delta_byte_array",
    "decode_delta_binary_packed",
    "decode_delta_byte_array",
    "decode_delta_length_byte_array",
    "encode_delta_binary_packed",
    "encode_delta_byte_array",
    "encode_delta_length_byte_array",
    "scan_delta_length_byte_array",
    "scan_delta_structure",
    "widths_from_max",
]


def widths_from_max(mb_max: np.ndarray) -> np.ndarray:
    """Vectorised bit_length: the packing width of each miniblock from
    its largest adjusted delta."""
    widths = np.zeros(mb_max.shape, dtype=np.int64)
    m = mb_max.astype(np.uint64, copy=True)
    for s in (32, 16, 8, 4, 2, 1):
        big = m >= (np.uint64(1) << np.uint64(s))
        widths[big] += s
        m[big] >>= np.uint64(s)
    widths += (m > 0)
    return widths


class DeltaStructure:
    """Parsed DELTA_BINARY_PACKED layout: per-block min_delta
    (``md_blocks``) and, per miniblock of nonzero width, its width, payload
    position and first delta index (``mb_w``, ``mb_pos``, ``mb_start``).
    Zero-width miniblocks are omitted (their deltas are zero;
    ``min_delta`` carries the value)."""

    __slots__ = ("block_size", "mb_size", "total", "first", "md_blocks",
                 "mb_w", "mb_pos", "mb_start", "end_pos")

    def __init__(self, **kw):
        for k, v in kw.items():
            setattr(self, k, v)

    def grouped(self):
        """Per distinct width, ``(w, src_contiguous, p_w, s_w, t_w,
        dst_contiguous)``: the payload positions, first delta indices and
        take counts (``min(mb_size, n_deltas - start)``, so only the last
        miniblock is partial) of that width's miniblocks, and whether
        their payloads and their destinations lie back to back."""
        if len(self.mb_w) == 0:
            return
        n_deltas = self.total - 1
        w_np = np.asarray(self.mb_w, dtype=np.int64)
        p_np = np.asarray(self.mb_pos, dtype=np.int64)
        s_np = np.asarray(self.mb_start, dtype=np.int64)
        t_np = np.minimum(self.mb_size, n_deltas - s_np)
        for w in np.unique(w_np):
            w = int(w)
            nbytes = self.mb_size * w // 8
            m = w_np == w
            p_w, s_w, t_w = p_np[m], s_np[m], t_np[m]
            k = len(p_w)
            src_contig = k == 1 or (np.diff(p_w) == nbytes).all()
            dst_contig = k == 1 or (np.diff(s_w) == self.mb_size).all()
            yield w, src_contig, p_w, s_w, t_w, dst_contig


def scan_delta_structure(data, pos: int = 0,
                         max_width: int = 64) -> DeltaStructure:
    """One structure pass over a DELTA_BINARY_PACKED stream: the header
    validated, then the block loop in C (``csrc/delta.c``).  Raises
    ValueError on a malformed stream or a miniblock wider than
    ``max_width`` (the column's physical width)."""
    block_size, pos = read_uvarint(data, pos)
    n_miniblocks, pos = read_uvarint(data, pos)
    if block_size <= 0 or block_size % 128:
        raise ValueError(f"invalid delta block size {block_size}")
    if n_miniblocks <= 0 or block_size % n_miniblocks:
        raise ValueError(f"invalid miniblock count {n_miniblocks}")
    mb_size = block_size // n_miniblocks
    if mb_size % 32:
        raise ValueError(f"miniblock size {mb_size} not a multiple of 32")
    total, pos = read_uvarint(data, pos)
    first, pos = read_zigzag(data, pos)
    # bound the header to int64: Python varints are arbitrary precision
    if (total >= 1 << 63 or block_size >= 1 << 31
            or not -(1 << 63) <= first < 1 << 63):
        raise ValueError("delta header value out of range")
    md, w, p, s, end = delta_native().scan_blocks(
        data, pos, max(total - 1, 0), mb_size, n_miniblocks, max_width)
    return DeltaStructure(block_size=block_size, mb_size=mb_size,
                          total=total, first=first, md_blocks=md, mb_w=w,
                          mb_pos=p, mb_start=s, end_pos=end)


def decode_delta_binary_packed(data, dtype=np.int64, pos: int = 0):
    """Decode one DELTA_BINARY_PACKED stream: ``(values, end_pos)``, the
    position where its payload ends.  All arithmetic is uint64, so it
    wraps as two's complement for both widths (the cast truncates).  The
    decode is one C pass (``csrc/delta.c`` ``tpq_delta_decode``) over the
    scanned structure."""
    dtype = np.dtype(dtype)
    st = scan_delta_structure(data, pos)
    if st.total == 0:
        return np.empty(0, dtype=dtype), st.end_pos
    out = delta_native().decode_all(data, st)
    if out is None:
        raise ValueError("delta miniblock overruns the data")
    return out.view(np.int64).astype(dtype, copy=False), st.end_pos


def encode_delta_binary_packed(values, block_size: int = 128,
                               n_miniblocks: int = 4,
                               is32: bool | None = None) -> bytes:
    """Encode int32/int64 values.  ``is32`` (default: from the dtype)
    wraps the deltas at 32 bits, so an int32 column spanning its whole
    range packs at width 32, not 33, and rebuilds the same values mod
    2^32."""
    v0 = np.asarray(values)
    if is32 is None:
        is32 = v0.dtype in (np.dtype(np.int32), np.dtype(np.uint32))
    v = v0.astype(np.int64, copy=False)
    out = bytearray()
    write_uvarint(out, block_size)
    write_uvarint(out, n_miniblocks)
    write_uvarint(out, v.size)
    mb_size = block_size // n_miniblocks
    if v.size == 0:
        write_zigzag(out, 0)
        return bytes(out)
    write_zigzag(out, int(v[0]))
    deltas = np.diff(v.view(np.uint64)).view(np.int64)
    if is32:
        deltas = deltas.astype(np.int32).astype(np.int64)
    # every block's min and widths in one shot; the padding never wins
    # the min and packs as 0
    n = deltas.size
    n_blocks = (n + block_size - 1) // block_size
    blk = np.full(n_blocks * block_size, np.iinfo(np.int64).max,
                  dtype=np.int64)
    blk[:n] = deltas
    blk2 = blk.reshape(n_blocks, block_size)
    min_deltas = blk2.min(axis=1)
    adj = blk2.view(np.uint64) - min_deltas.view(np.uint64)[:, None]
    adj.reshape(-1)[n:] = 0
    mb = adj.reshape(n_blocks * n_miniblocks, mb_size)
    widths = widths_from_max(mb.max(axis=1))
    body = pack_native().delta_emit(mb, widths, mb_size, min_deltas,
                                    n_miniblocks)
    return bytes(out) + body.tobytes()


# -- DELTA_LENGTH_BYTE_ARRAY ------------------------------------------------

def scan_delta_length_byte_array(data, count: int, pos: int = 0):
    """Validated DLBA structure without materialising the payload:
    ``(int64 offsets, data_pos)``, the bytes being ``data[data_pos :
    data_pos + offsets[-1]]``.  Shared by the decoder and the device
    planner, so their validation cannot drift."""
    lengths, pos = decode_delta_binary_packed(data, np.int64, pos)
    if lengths.size != count:
        raise ValueError(
            f"DELTA_LENGTH_BYTE_ARRAY: length stream has {lengths.size} "
            f"entries, expected {count}")
    if (lengths < 0).any():
        raise ValueError("negative byte-array length")
    offsets = np.zeros(count + 1, dtype=np.int64)
    np.cumsum(lengths, out=offsets[1:])
    if pos + int(offsets[-1]) > len(data):
        raise ValueError("DELTA_LENGTH_BYTE_ARRAY: truncated data section")
    return offsets, pos


def decode_delta_length_byte_array(data, count: int, pos: int = 0):
    """``(ByteArrayColumn, end_pos)``: the lengths, then the bytes."""
    offsets, pos = scan_delta_length_byte_array(data, count, pos)
    total = int(offsets[-1])
    payload = np.frombuffer(data, dtype=np.uint8, count=total, offset=pos)
    return ByteArrayColumn(offsets, payload.copy()), pos + total


def encode_delta_length_byte_array(values: ByteArrayColumn) -> bytes:
    return (encode_delta_binary_packed(values.lengths())
            + values.data[int(values.offsets[0]):
                          int(values.offsets[-1])].tobytes())


# -- DELTA_BYTE_ARRAY (front coding) ----------------------------------------

def assemble_delta_byte_array(prefix_lens, suffix_offsets,
                              suffix_data) -> ByteArrayColumn:
    """Front-coded values rebuilt from the parsed streams (validation
    included), in one C pass; shared by the decoder and the device
    planner's host-assembly route."""
    total_lens = prefix_lens + np.diff(suffix_offsets)
    offsets = np.zeros(len(prefix_lens) + 1, dtype=np.int64)
    np.cumsum(total_lens, out=offsets[1:])
    out = delta_native().dba_assemble(prefix_lens, suffix_offsets,
                                      suffix_data, offsets,
                                      int(offsets[-1]))
    return ByteArrayColumn(offsets, out)


def decode_delta_byte_array(data, count: int, pos: int = 0):
    """``(ByteArrayColumn, end_pos)``: prefix lengths, suffixes, then the
    front-coded fill."""
    prefix_lens, pos = decode_delta_binary_packed(data, np.int64, pos)
    if prefix_lens.size != count:
        raise ValueError("DELTA_BYTE_ARRAY: prefix count mismatch")
    suffixes, pos = decode_delta_length_byte_array(data, count, pos)
    return assemble_delta_byte_array(prefix_lens, suffixes.offsets,
                                     suffixes.data), pos


def encode_delta_byte_array(values: ByteArrayColumn) -> bytes:
    """Front coding: each value's prefix shared with the one before it
    (one C pass), then the suffixes gathered in one C pass — byte for
    byte the JAX package's stream."""
    offs = np.asarray(values.offsets, dtype=np.int64)
    prefix = delta_native().common_prefix(values.data, offs)
    starts = offs[:-1] + prefix
    lens = np.diff(offs) - prefix
    suffix_offs = np.zeros(offs.size, dtype=np.int64)
    np.cumsum(lens, out=suffix_offs[1:])
    suffixes = bytes_native().gather_var(values.data, starts, lens,
                                         int(suffix_offs[-1]))
    return (encode_delta_binary_packed(prefix)
            + encode_delta_length_byte_array(
                ByteArrayColumn(suffix_offs, suffixes)))
