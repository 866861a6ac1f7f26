"""Device decode orchestration: column chunks -> device-resident columns.

The port of ``tpuparquet/kernels/device.py``'s read path: the host walks
page headers, verifies CRCs, decompresses pages and builds run-table
plans (:func:`plan_chunk_device`); one pinned host
slab per row group carries every column's plans and page words to the
device in one non-blocking copy (:func:`_put_all`); the deferred
per-page ops launch the kernels and the row group ends in one fence
(:func:`_finish_row_group`).  :func:`pipelined_reads` plans the columns
of the next row groups on a pool of worker threads while the calling
thread stages, launches and fences the row group before; planning
borrows its decompression slabs from ``kernels/arena.py`` and, under
``TPQ_PLAN_CACHE_MB``, its transport verdicts from
``kernels/plancache.py``.  The result is a :class:`DeviceColumn` per
column, in the JAX package's buffer layout — flat 1-D u32 lanes, or u8
bytes with int32 offsets for BYTE_ARRAY, bucket-padded, same logical
lengths, rep and def levels — so the two compare buffer for buffer.

Covered: data pages v1 and v2 (levels outside compression, the
``num_nulls`` cross-check); UNCOMPRESSED, SNAPPY, GZIP, ZSTD and LZ4_RAW
(decompressed on the host into the arena's slabs, a multi-frame ZSTD
body one frame a worker: ``compress.decompress_block``); required, optional
and repeated columns of every physical type (rep levels in both page
versions, any ``max_rep_level``); PLAIN and
PLAIN_DICTIONARY/RLE_DICTIONARY (K3 at 1 lane for BOOLEAN, INT32 and
FLOAT, 2 for INT64 and DOUBLE, 3 for INT96, ``ceil(L / 4)`` for
FIXED_LEN_BYTE_ARRAY(L); K9 for BYTE_ARRAY); RLE BOOLEAN values (a
width-1 hybrid stream, K1 or K2); DELTA_BINARY_PACKED on INT32 and INT64
(K1 or K6 per width class, K11 placing scattered classes, K7);
BYTE_STREAM_SPLIT on INT32, INT64, FLOAT, DOUBLE and FIXED_LEN_BYTE_ARRAY
(K12); DELTA_LENGTH_BYTE_ARRAY (the value bytes ship as they are) and
DELTA_BYTE_ARRAY on BYTE_ARRAY and FIXED_LEN_BYTE_ARRAY (below); page
CRCs.  Fixed-width PLAIN pages of the lane types (INT32, INT64, INT96,
FLOAT, DOUBLE)
take the JAX package's three wire transports under its switches and
defaults, read per plan: byte planes (``TPQ_DEVICE_PLANES``, K5), delta
lanes (``TPQ_DEVICE_DELTA``, integers only: K1/K6 then K7) and snappy
tokens (``TPQ_DEVICE_SNAPPY``, K8), which compete on wire bytes page by
page exactly as in the reference; a page no transport wins ships its
decompressed words.  Only the snappy tokens are SNAPPY-only: byte
planes and delta lanes compete on the decompressed values of every
codec, as in the reference.  PLAIN BOOLEAN pages ship their bit-packed words and
K1 unpacks them; PLAIN FIXED_LEN_BYTE_ARRAY pages ship their rows padded
to whole lanes; both go outside the slab, as the reference uploads them.
BYTE_ARRAY dictionary pages decode with K9; a
snappy PLAIN BYTE_ARRAY page whose token tables fit the reference's
budget ships them instead of its bytes, and K10 gathers the values out
of K8's expansion; other PLAIN BYTE_ARRAY pages ship their value bytes.
A DELTA_BYTE_ARRAY page ships one copy token (its prefix, read from the
previous value) and one literal token (its suffix) a value, which K8
resolves, then K13 turns FIXED_LEN_BYTE_ARRAY rows into lane words;
a page whose front coding does not expand its bytes is assembled on the
host instead (``dba-host``).  V1 levels in the deprecated BIT_PACKED
encoding decode on the host and stage as they are, as in the reference.
Other encodings and codecs (LZO, BROTLI, Hadoop-framed LZ4) raise
NotImplementedError.

``DeviceColumn.as_values()`` hands a fixed-width column's packed values
to the write path (``kernels/encode.py``) without moving them.

``filter=`` (a ``filter.py`` expression) takes the late-materialized
read instead: the row group's filter columns decode on the host first
(``filter.py`` ``read_row_group_filtered``: pages the page index rules
out are never decompressed), the predicate runs exactly, the other
columns decode only their surviving rows' pages, and only the surviving
rows are copied to the device (:func:`stage_chunkdata`) in the fused
path's layout; no read kernel runs.  :func:`filtered_pipelined_reads`
runs one unit's host decode a pool task while the calling thread copies
the unit before to its device.

:func:`read_row_group_device_resilient` is the read's fault ladder: a
failed dispatch is retried, then the unit is planned again with its
values decoded on the host (:func:`cpu_fallback_values`, a degraded
plan); ``read_row_groups_device(out_sharding=, gather_to=)`` places the
decode on a consumer's devices.  The page loop and the unit's dispatch
hold the fault sites ``kernels.device.*`` (``faults.py``).
:func:`decode_chunk_device` decodes one column chunk on its own, with
the calling thread's arena.
"""

from __future__ import annotations

import contextlib
import os
import struct
import threading
import time
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch

from ..compress import decompress_block, snappy_single_literal_view
from ..cpu.delta import assemble_delta_byte_array, \
    decode_delta_binary_packed, scan_delta_length_byte_array
from ..cpu.dictionary import decode_dict_indices, gather
from ..cpu.hybrid import expand_scan, scan_hybrid
from ..cpu.plain import ByteArrayColumn, decode_plain
from ..errors import CorruptChunkError, CorruptPageError, \
    DeviceDispatchError, ScanError
from ..faults import backoff_delays, fault_point, filter_bytes
from ..filter import bind_filter, read_row_group_filtered
from ..format.compact import CompactReader
from ..format.metadata import CompressionCodec, Encoding, PageHeader, \
    PageType, Type, decode_struct
from ..io.pages import _DICT_ENCODINGS, crc_verify_default, decode_values, \
    scan_levels_v1, scan_levels_v2, verify_page_crc
from ..native import pack_native, plane_native
from ..obs import profiler as _profiler
from ..obs import recorder as _flightrec
from ..obs import trace as _trace
from ..obs.recorder import flight
from ..obs.trace import emit_span
from ..stats import current_stats, worker_stats
from .arena import HostArena, discard_thread_arena, lease_arena, \
    return_arena, thread_arena, trim_arena_pool
from .bitunpack import pad_to_words, unpack_u32
from .decode import (
    DeltaPlan,
    bss_to_lanes,
    bucket,
    expand_delta_i32,
    expand_delta_i64,
    flba_bytes_to_lanes,
    levels_to_validity,
    page_dict_bytes,
    page_dict_fixed,
    page_dict_fixed_levels_tbl,
    page_plain_fixed_levels_tbl,
    plain_bytes_from_blob,
    plain_fixed_to_lanes,
    plan_delta_i32,
    plan_delta_i64,
    planes_to_words,
    stage_u32,
)
from .hybrid import count_eq_scan, expand_hybrid, max_scan_value, \
    plan_stream_args
from .plancache import invalidate_fingerprint, plan_cache, plan_cache_budget
from .snappy import expand_tokens, expand_tokens_words, plan_tokens

__all__ = ["DeviceColumn", "cpu_fallback_values", "decode_chunk_device",
           "device_column_from_jax_numpy", "filtered_pipelined_reads",
           "pipelined_reads", "plan_chunk_device", "read_row_group_device",
           "read_row_group_device_resilient", "read_row_groups_device",
           "stage_chunkdata"]


# ----------------------------------------------------------------------
# Degradation: the values of every page decoded on the host
# ----------------------------------------------------------------------
#
# When a unit's device dispatch keeps failing, the resilient read
# (read_row_group_device_resilient) re-plans it under this thread-local
# flag: every page's values decode on the host (decode_values, the
# dictionary gather) and only the finished buffers cross to the device;
# no value kernel and no wire transport runs, the level streams still
# expand on the device (K1/K2, K4).  Such pages count pages_degraded.

_degrade_tls = threading.local()


def _host_values_only() -> bool:
    return getattr(_degrade_tls, "host_only", False)


@contextlib.contextmanager
def cpu_fallback_values():
    """A scope (this thread) in which every page's values decode on the
    host: the device read's degraded mode."""
    prev = getattr(_degrade_tls, "host_only", False)
    _degrade_tls.host_only = True
    try:
        yield
    finally:
        _degrade_tls.host_only = prev

# u32 lanes a value of the types the PLAIN wire transports carry
_LANES = {Type.INT32: 1, Type.FLOAT: 1, Type.INT64: 2, Type.DOUBLE: 2,
          Type.INT96: 3}

# a PLAIN page's transport verdict -> its page event's transport label
_CHOSEN_TRANSPORT = {"planes": "planes", "delta": "delta-lanes",
                     "snappy": "snappy-tokens"}
_NP_DTYPES = {Type.INT32: np.dtype("<i4"), Type.INT64: np.dtype("<i8"),
              Type.FLOAT: np.dtype("<f4"), Type.DOUBLE: np.dtype("<f8")}
_I32_MAX = (1 << 31) - 1


def _flba_lanes(type_length: int) -> int:
    return (type_length + 3) // 4


def _lanes_for(ptype: Type, type_length) -> int:
    """u32 words a value in the flat device layout (fixed-width types):
    one for BOOLEAN (0 or 1), ``ceil(L / 4)`` for FIXED_LEN_BYTE_ARRAY(L),
    else :data:`_LANES`."""
    if ptype == Type.BOOLEAN:
        return 1
    if ptype == Type.FIXED_LEN_BYTE_ARRAY:
        return _flba_lanes(type_length)
    return _LANES[ptype]


def _stage_byte_rows_np(arr: np.ndarray) -> np.ndarray:
    """``(N, L)`` u8 rows (or INT96 words) -> flat ``(N * lanes,)`` u32,
    each row zero-padded to whole little-endian u32 lanes."""
    if arr.shape[0] == 0:
        return np.zeros(0, dtype=np.uint32)
    rows = arr.view(np.uint8).reshape(arr.shape[0], -1)
    lanes = _flba_lanes(rows.shape[1])
    padded = np.zeros((rows.shape[0], 4 * lanes), dtype=np.uint8)
    padded[:, : rows.shape[1]] = rows
    return padded.view("<u4").reshape(-1)


def _upload(a: np.ndarray, device: torch.device) -> torch.Tensor:
    """A host array on ``device`` outside the slab, as the reference
    uploads string offsets, PLAIN BOOLEAN words and FIXED_LEN_BYTE_ARRAY
    rows (so not in ``bytes_staged``): on the card a pinned copy and a
    non-blocking copy from it that the row group's fence completes, on
    the CPU a copy.  4-byte arrays arrive as int32 bits."""
    a = np.ascontiguousarray(a)
    if a.dtype.itemsize == 4:
        a = a.view(np.int32)
    if device.type == "cuda":
        t = torch.from_numpy(a if a.flags.writeable else a.copy())
        return t.pin_memory().to(device, non_blocking=True)
    # a copy: ``a`` may be a view of an arena slab, which is recycled
    # after the row group
    return torch.from_numpy(a.copy())


class DeviceColumn:
    """Device-resident decoded column.

    ``data``: flat ``(n_packed * lanes,)`` u32 lanes (an int32 tensor,
    same bits) of the non-null values (BOOLEAN as 0 or 1, INT96 as its
    three words, FIXED_LEN_BYTE_ARRAY(``type_length``) as its bytes
    zero-padded to whole lanes), or for BYTE_ARRAY their u8 bytes
    with ``offsets`` (int32, ``n_packed + 1`` entries, as the reference
    holds them on a device without 64-bit integers) and ``n_bytes``;
    ``mask``/``positions`` map record slots to packed values;
    ``rep_levels``/``def_levels`` keep the nesting and the nulls.  Buffers are stored bucket-padded (the
    shape the page kernels emit) with logical lengths ``num_values``
    (record slots) and ``n_packed`` (non-null values); the accessors slice
    lazily and materialise implicit streams (all-zero levels, all-valid
    masks) on demand."""

    __slots__ = ("ptype", "type_length", "num_values", "n_packed", "offsets",
                 "n_bytes", "_data_p", "_mask_p", "_pos_p", "_rep_p",
                 "_def_p", "_cache", "_device")

    def __init__(self, ptype, data, mask, positions, def_levels,
                 num_values: int, n_packed: int, offsets=None,
                 n_bytes: int | None = None, rep_levels=None,
                 type_length: int | None = None, device=None):
        self.ptype = Type(ptype)
        self.type_length = type_length
        # a chunk without pages keeps no data buffer (None), as the
        # reference; ``data`` then reads as a 0-length tensor
        self._device = data.device if data is not None \
            else torch.device(device or "cpu")
        self._data_p = data
        self._mask_p = mask
        self._pos_p = positions
        self._rep_p = rep_levels
        self._def_p = def_levels
        self.num_values = num_values
        self.n_packed = n_packed
        self.offsets = offsets
        self.n_bytes = n_bytes
        self._cache = {}

    @property
    def lanes(self) -> int | None:
        """u32 words per value; None for BYTE_ARRAY."""
        return None if self.offsets is not None \
            else _lanes_for(self.ptype, self.type_length)

    @property
    def device(self) -> torch.device:
        return self._device

    def _sliced(self, key, padded, n, fill):
        got = self._cache.get(key)
        if got is None:
            got = fill() if padded is None else padded[:n]
            self._cache[key] = got
        return got

    @property
    def data(self):
        n = self.n_bytes if self.offsets is not None \
            else self.n_packed * self.lanes
        return self._sliced(
            "data", self._data_p, n,
            lambda: torch.zeros(0, dtype=torch.uint8 if self.offsets
                                is not None else torch.int32,
                                device=self.device))

    @property
    def mask(self):
        return self._sliced(
            "mask", self._mask_p, self.num_values,
            lambda: torch.ones(self.num_values, dtype=torch.bool,
                               device=self.device))

    @property
    def positions(self):
        return self._sliced(
            "pos", self._pos_p, self.num_values,
            lambda: torch.arange(self.num_values, dtype=torch.int32,
                                 device=self.device))

    @property
    def rep_levels(self):
        return self._sliced(
            "rep", self._rep_p, self.num_values,
            lambda: torch.zeros(self.num_values, dtype=torch.int32,
                                device=self.device))

    @property
    def def_levels(self):
        return self._sliced(
            "def", self._def_p, self.num_values,
            lambda: torch.zeros(self.num_values, dtype=torch.int32,
                                device=self.device))

    def block_until_ready(self):
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        return self

    def padded_buffers(self) -> dict:
        """Every stored buffer, padding included, as host numpy arrays
        (u32 lanes as uint32, bytes as uint8) — the unit of
        buffer-for-buffer parity."""
        out = {}
        for name, t in (("data", self._data_p), ("offsets", self.offsets),
                        ("mask", self._mask_p), ("positions", self._pos_p),
                        ("rep_levels", self._rep_p),
                        ("def_levels", self._def_p)):
            if t is not None:
                a = t.cpu().numpy()
                out[name] = a.view(np.uint32) \
                    if name == "data" and a.dtype == np.int32 else a
        return out

    def to_numpy(self, limit: int | None = None):
        """``(values, rep_levels, def_levels)`` in the CPU oracle's
        representation.  ``limit`` bounds it to the first ``limit``
        record slots; buffers are sliced on the device before the copy."""
        n, nn = self.num_values, self.n_packed
        if limit is not None and limit < n:
            n = max(limit, 0)
            nn = n if self._mask_p is None \
                else int(self._mask_p[:n].sum().item())
        rl, dl = [np.zeros(n, dtype=np.int32) if t is None
                  else t[:n].cpu().numpy()
                  for t in (self._rep_p, self._def_p)]
        if self.offsets is not None:
            offs = self.offsets[: nn + 1].cpu().numpy().astype(np.int64)
            data = self.data[: int(offs[-1])].cpu().numpy()
            return ByteArrayColumn(offs, data), rl, dl
        flat = self.data[: nn * self.lanes].cpu().numpy()
        return self._flat_to_typed(flat.view(np.uint32)), rl, dl

    def as_values(self):
        """The packed values as a
        :class:`~tpuparquet_torch.kernels.encode.DeviceValues` for
        ``FileWriter.write_columns``: it shares this column's flat u32
        lane layout (the sliced ``data``, ``n_packed * lanes`` words), so
        no data moves.  int32, int64, float and double columns only; an
        optional column's validity goes to ``write_columns`` separately
        (``masks=``), the packed buffer being exactly the non-null
        values."""
        from .encode import DeviceValues

        dt = None if self.offsets is not None else _NP_DTYPES.get(self.ptype)
        if dt is None:
            raise TypeError(
                f"as_values supports int32/int64/float/double columns, "
                f"not {self.ptype.name}")
        return DeviceValues(self.data, dt)

    def _flat_to_typed(self, flat: np.ndarray):
        """Flat little-endian u32 lane words -> the oracle's values: bool,
        ``(N, 3)`` u32 for INT96, ``(N, L)`` u8 rows for
        FIXED_LEN_BYTE_ARRAY, else the physical dtype."""
        if self.ptype == Type.BOOLEAN:
            return flat.astype(bool)
        if self.ptype == Type.INT96:
            return flat.reshape(-1, 3)
        if self.ptype == Type.FIXED_LEN_BYTE_ARRAY:
            return flat.view(np.uint8).reshape(-1, 4 * self.lanes)[
                :, : self.type_length]
        return flat.view(_NP_DTYPES[self.ptype])


def device_column_from_jax_numpy(col_np: dict,
                                 device="cpu") -> DeviceColumn:
    """The port's column from a JAX ``DeviceColumn``'s numpy buffers.

    ``col_np`` maps ``ptype``, ``num_values``, ``n_packed`` and the
    padded buffers ``data`` (u32, or u8 for BYTE_ARRAY), ``mask``,
    ``positions``, ``rep_levels``, ``def_levels`` (None, or absent, where
    the JAX column holds none) — the JAX column's ``_data_p``/``_mask_p``/
    ``_pos_p``/``_rep_p``/``_def_p`` as numpy — and, for BYTE_ARRAY,
    ``offsets`` and ``n_bytes``, for FIXED_LEN_BYTE_ARRAY
    ``type_length``."""
    def t(a, dtype):
        if a is None:
            return None
        a = np.ascontiguousarray(a)
        if dtype == torch.int32:
            a = a.view(np.int32)
        return torch.from_numpy(a.copy()).to(device=device, dtype=dtype)

    offsets = col_np.get("offsets")
    n_bytes = col_np.get("n_bytes")
    return DeviceColumn(
        col_np["ptype"],
        t(col_np["data"], torch.int32 if offsets is None else torch.uint8),
        t(col_np.get("mask"), torch.bool),
        t(col_np.get("positions"), torch.int32),
        t(col_np.get("def_levels"), torch.int32),
        int(col_np["num_values"]), int(col_np["n_packed"]),
        offsets=t(offsets, torch.int32),
        n_bytes=None if n_bytes is None else int(n_bytes),
        rep_levels=t(col_np.get("rep_levels"), torch.int32),
        type_length=col_np.get("type_length"), device=device)


# ----------------------------------------------------------------------
# Staging: one pinned slab, one copy per row group
# ----------------------------------------------------------------------

# The JAX stager splits large arrays into power-of-two-row pieces (16 MB
# down to 128 KB) and zero-pads only the last piece to a bucket; the
# pieces are reassembled on the device, so the staged array is that much
# longer than the host array.  Kernels see those lengths (a padded
# dictionary's n_dict, a padded dictionary blob's last byte), so the port
# stages the same padded lengths.
_PIECE_BYTES = 16 << 20
_MIN_PIECE_BYTES = 128 << 10
_ALIGN_WORDS = 64  # 256-byte alignment of every array in the slab


def _padded_len(n: int, itemsize: int = 4) -> int:
    """Staged length of an n-element array of ``itemsize``-byte rows
    under the JAX piece split (``_split_rows``): 16 MB pieces, then
    descending powers of two down to 128 KB, then a zero-padded tail
    bucketed to at least 32 rows."""
    if n == 0:
        return 0
    max_rows = 1 << ((_PIECE_BYTES // itemsize).bit_length() - 1)
    min_rows = 1 << ((_MIN_PIECE_BYTES // itemsize).bit_length() - 1)
    total = (n // max_rows) * max_rows
    left = n - total
    while left >= min_rows:
        p = 1 << (left.bit_length() - 1)
        total += p
        left -= p
    if left:
        total += bucket(left)
    return total


class _Stager:
    """Collects one column's host arrays for the row group's batched
    transfer: u32 words (any 4-byte dtype) or bytes (uint8: token
    literals, byte planes, BYTE_ARRAY values and dictionaries).  Arrays
    stage zero-padded to the JAX piece split's length; ``pad=False``
    arrays stage at their exact length (run and token tables, bit-packed
    words, planes, padded offsets, whose lengths the plan fixed)."""

    __slots__ = ("arrays",)

    def __init__(self):
        self.arrays = []

    def add(self, arr, pad: bool = True) -> int:
        a = np.ascontiguousarray(np.asarray(arr).reshape(-1))
        if a.dtype.itemsize == 1:
            a = a.view(np.uint8)
        elif a.dtype.itemsize == 4:
            a = a.view(np.int32)
        else:
            raise TypeError(f"staged arrays are u32 words or bytes, got "
                            f"{a.dtype}")
        self.arrays.append((a, pad))
        return len(self.arrays) - 1

    def add_many(self, arrs, pad: bool = True) -> list[int]:
        return [self.add(a, pad=pad) for a in arrs]


def _put_all(stagers, device: torch.device):
    """Ship every stager's arrays to ``device`` in one copy.

    Returns ``(staged lists, host slab)``: each stager's list of device
    views — int32 for words, uint8 for bytes, each of its staged
    (padded) length; bytes ride the slab zero-padded to whole words — and
    the pinned host slab, which must stay alive until the row group's
    fence (the copy is non-blocking).  ``bytes_staged`` counts what the
    JAX stager ships: every array at its staged length.  The copy is one
    sample of the ``stager_wave_us`` histogram (the reference's stager
    splits a row group into waves of 96 MB)."""
    layout = []
    total = 0
    wire = 0
    for stg in stagers:
        spans = []
        for a, pad in stg.arrays:
            n = _padded_len(a.size, a.itemsize) if pad else a.size
            wire += n * a.itemsize
            spans.append((total, n))
            total += -(-(n * a.itemsize) // (4 * _ALIGN_WORDS)) * _ALIGN_WORDS
        layout.append(spans)
    cuda = device.type == "cuda"
    slab = torch.empty(total, dtype=torch.int32, pin_memory=cuda)
    host = slab.numpy()
    host_u8 = host.view(np.uint8)
    for stg, spans in zip(stagers, layout):
        for (a, _), (off, staged) in zip(stg.arrays, spans):
            if a.dtype == np.uint8:
                host_u8[4 * off : 4 * off + a.size] = a
                host_u8[4 * off + a.size : 4 * off + -(-staged // 4) * 4] = 0
            else:
                host[off : off + a.size] = a
                host[off + a.size : off + staged] = 0
    st = current_stats()
    if st is not None:
        st.bytes_staged += wire
    t_wave = time.perf_counter()
    dev = slab.to(device, non_blocking=True) if cuda else slab
    if st is not None and stagers and any(stg.arrays for stg in stagers):
        # one wave a row group: the host wall of its copy's enqueue (the
        # row group's one fence, in _finish_row_group, ends it)
        st.hist("stager_wave_us").record(
            (time.perf_counter() - t_wave) * 1e6)
    dev_u8 = dev.view(torch.uint8)
    staged = [[dev_u8[4 * off : 4 * off + n] if a.dtype == np.uint8
               else dev[off : off + n]
               for (a, _), (off, n) in zip(stg.arrays, spans)]
              for stg, spans in zip(stagers, layout)]
    return staged, slab


# ----------------------------------------------------------------------
# Planning
# ----------------------------------------------------------------------

def _check_dict_indices(i_sc, width: int, non_null: int, dict_len: int,
                        idx_np=None) -> None:
    """Reject out-of-range dictionary indices on the host: the device
    gather clamps (its padding lanes must stay in range), which would
    turn a corrupt file's oversized index into a silent wrong value.
    ``idx_np``: the indices already expanded on the host."""
    if non_null == 0:
        return
    if dict_len <= 0:
        raise ValueError("dict-encoded page with empty dictionary")
    if idx_np is not None:
        mx = int(idx_np.max()) if idx_np.size else -1
    elif i_sc is None:
        mx = 0  # width 0: every index decodes to 0
    elif (1 << width) <= dict_len:
        return
    else:
        mx = max_scan_value(i_sc, width)
    if mx >= dict_len:
        raise ValueError(f"dictionary index {mx} out of range "
                         f"(dictionary has {dict_len} entries)")


def _merge_parts(parts, lanes: int = 1):
    """[(padded device array, logical n)] -> (array, total n).  One part
    keeps its padding; several are sliced, then concatenated."""
    if not parts:
        return None, 0
    if len(parts) == 1:
        return parts[0]
    arrs = [a[: m * lanes] for a, m in parts]
    return torch.cat(arrs), sum(m for _, m in parts)


# ----------------------------------------------------------------------
# PLAIN wire transports (the JAX package's default-on set)
# ----------------------------------------------------------------------

# The switches keep the JAX package's names and defaults and are read per
# plan, so one process can compare both configurations.

# A degraded plan (cpu_fallback_values) takes none of them.

def _DEVICE_SNAPPY() -> bool:
    if _host_values_only():
        return False
    return os.environ.get("TPQ_DEVICE_SNAPPY", "1") != "0"


def _DEVICE_DELTA_LANES() -> bool:
    if _host_values_only():
        return False
    return os.environ.get("TPQ_DEVICE_DELTA", "1") != "0"


def _DEVICE_PLANES() -> bool:
    if _host_values_only():
        return False
    return os.environ.get("TPQ_DEVICE_PLANES", "1") != "0"


def _plan_delta_lane_words(seg, count: int, ptype: Type, params=None):
    """Plan the delta-lane transport for one PLAIN int32/int64 values
    segment: ``(first, one min_delta, packed delta offsets)``, rebuilt on
    the device by :func:`expand_delta_i32`/``_i64``.

    ``params`` is the plan cache's ``(min_delta, width)`` of this page:
    the sample window and the min/max pass are skipped, and one max over
    the offsets checks the width (a stale hint computes afresh).

    All arithmetic is modular (uint64/uint32 wrap), as the device rebuild
    is, so a random page rejects on width and never corrupts.  Returns
    ``(wire, commit, (min_delta, width))`` — ``wire`` is the staged cost
    after the stager's padding, ``commit(stager)`` stages the plan and
    returns ``words(staged)`` — or None."""
    if count < 1024:
        return None
    lanes = _LANES[ptype]
    nbytes = count * lanes * 4
    buf = (seg.reshape(-1) if isinstance(seg, np.ndarray)
           else np.frombuffer(seg, dtype=np.uint8))
    if buf.size < nbytes:
        raise ValueError("PLAIN: input too short")
    v = np.ascontiguousarray(buf[:nbytes]).view("<u8" if lanes == 2
                                                else "<u4")
    n_deltas = count - 1
    sdt = np.int64 if lanes == 2 else np.int32

    def _width(dd):
        lo = int(dd.min())
        hi = int(dd.max())
        span = int(np.uint64(hi - lo)) if lanes == 2 \
            else int(np.uint32(hi - lo))
        return lo, span.bit_length()

    mask = (1 << (32 * lanes)) - 1

    def offsets(md):
        return ((d.astype(np.int64) - md).astype(np.uint64)
                & np.uint64(mask)) if lanes == 1 \
            else (d - np.int64(md)).view(np.uint64)

    if params is None:
        # the sample window's delta span lower-bounds the page's: a
        # window that already needs full width proves the page rejects
        win = 16384
        if count > win:
            _, w_s = _width((v[1 : win + 1] - v[:win]).view(sdt))
            if w_s >= 32 * lanes:
                return None
    d = (v[1:] - v[:-1]).view(sdt)  # wrap-consistent deltas
    off = None
    if params is not None:
        md, w = params
        off = offsets(md)
        if not (w < 32 * lanes and (off.size == 0 or int(
                off.max()).bit_length() <= w)):
            md, w = _width(d)
            off = None
    else:
        md, w = _width(d)
    if w >= 32 * lanes:
        return None
    # the wire after the stager's padding, with the delta count quantised
    # to 32,768 as in the reference, so the estimate matches its routing
    n_pad32 = (n_deltas + 32767) // 32768 * 32768
    n_words = n_pad32 // 32 * w
    wire = 4 * _padded_len(n_words) + 32 if w else 32
    if wire + 4096 >= nbytes:
        return None  # must clear the same savings floor as the planes

    def commit(stager, _i64=(lanes == 2), off=off):
        if off is None:
            off = offsets(md)
        if n_pad32 != n_deltas:
            off = np.concatenate(
                [off, np.zeros(n_pad32 - n_deltas, dtype=np.uint64)])
        words = (pad_to_words(pack_native().pack(off, w), w, n_pad32)
                 .reshape(-1) if w else None)
        md_u = np.uint64(md & mask)
        md_lo = np.asarray([md_u & np.uint64(0xFFFFFFFF)], dtype=np.uint32)
        md_hi = np.asarray([md_u >> np.uint64(32)], dtype=np.uint32)
        groups = [(w, words, None, None, n_pad32, 0, n_deltas)] if w else []
        plan = DeltaPlan(groups, md_lo, md_hi, n_deltas, int(v[0]), count)
        build = _stage_delta_plan(plan, stager, need_hi=_i64)

        def words_fn(s, _b=build):
            return expand_delta_i64(_b(s)) if _i64 \
                else expand_delta_i32(_b(s))

        return words_fn

    return wire, commit, (md, w)


def _stage_delta_plan(plan: DeltaPlan, stager: _Stager, need_hi: bool):
    """Stage a DeltaPlan as the JAX package does: each width class's
    packed words padded; a scattered class's per-miniblock starts and
    takes exact (padding would corrupt the scatter targets); the
    per-block min_delta lanes exact, the hi lane only for int64, and
    neither when the stream has no block.  Returns ``build(staged,
    device=None) -> DeltaPlan`` over the device buffers (``device`` is
    needed only when no min_delta staged)."""
    specs = []
    for w, words, starts, takes, n_vals, start, n_take in plan.groups:
        wh = stager.add(words)
        if starts is None:
            specs.append((w, wh, words.size, None, None, n_vals, start,
                          n_take))
        else:
            specs.append((w, wh, words.size, stager.add(starts, pad=False),
                          stager.add(takes, pad=False), n_vals, 0, 0))
    has_md = plan.md_lo.size > 0
    lo_h = stager.add(plan.md_lo, pad=False) if has_md else None
    hi_h = stager.add(plan.md_hi, pad=False) if has_md and need_hi else None
    meta = (plan.block_size, plan.first, plan.total)

    def build(s, device=None, _specs=tuple(specs), _lo=lo_h, _hi=hi_h,
              _meta=meta):
        groups = [(w, s[wh][:nw], None if sh is None else s[sh],
                   None if th is None else s[th], n_vals, start, n_take)
                  for w, wh, nw, sh, th, n_vals, start, n_take in _specs]
        if device is None:  # only a stream without blocks needs it
            device = s[_lo].device
        none = torch.zeros(0, dtype=torch.int32, device=device)
        md_lo = none if _lo is None else s[_lo]
        md_hi = None if not need_hi else none if _hi is None else s[_hi]
        return DeltaPlan(groups, md_lo, md_hi, *_meta)

    return build


def _plan_token_expansion(payload, expected_size: int):
    """Token plan of a snappy block for the device: ``(te, ts, lp,
    out_cap, steps, out_len, wire)``, ``wire`` being the padded tables'
    bytes; None for a single-literal block (its bytes are the page
    already) or when the int32 tables would wrap."""
    if snappy_single_literal_view(payload) is not None:
        return None
    plan = plan_tokens(payload, expected_size)
    if plan is None:
        return None
    te, ts, lp = plan[:3]
    return (*plan, te.nbytes + ts.nbytes + lp.nbytes)


def _plan_device_snappy_words(payload, expected_size: int, n_words: int,
                              offset: int = 0):
    """Plan device-side snappy decompression of one values segment
    (``n_words`` u32 words at byte ``offset`` of the block).  Returns
    ``(wire, commit)`` — ``commit(stager)`` stages the token tables and
    returns ``words(staged)`` — or None when the host path applies
    (single literal; int32 overflow; tokens would not shrink the
    transfer)."""
    plan = _plan_token_expansion(payload, expected_size)
    if plan is None:
        return None
    out_len, wire = plan[5], plan[6]
    if out_len < offset + n_words * 4:
        raise ValueError("PLAIN values segment shorter than value count")
    # numeric pages full of short matches cost more as 8-byte-per-token
    # tables than as raw bytes: ship tokens only when they shrink the
    # transfer
    if wire >= 0.9 * (n_words * 4):
        return None

    def commit(stager, _plan=plan, _nw=n_words, _off=offset):
        te, ts, lp, out_cap, steps = _plan[:5]
        hs = stager.add_many([te, ts, lp], pad=False)

        def words(s, _hs=hs):
            return expand_tokens_words(s[_hs[0]], s[_hs[1]], s[_hs[2]],
                                       out_cap, steps, _off, _nw)

        return words

    return wire, commit


def _plan_device_snappy_blob(payload, expected_size: int,
                             wire_budget: float, stager: _Stager):
    """Plan device-side snappy decompression of a whole page into bytes
    (for byte-granular consumers: K10).  Returns ``(wire, blob(staged))``
    — ``blob`` gives the ``(out_cap,)`` u8 expansion — or None when the
    host path applies (single literal; int32 overflow; the token tables
    over ``wire_budget`` bytes)."""
    plan = _plan_token_expansion(payload, expected_size)
    if plan is None or plan[6] > wire_budget:
        return None
    te, ts, lp, out_cap, steps = plan[:5]
    hs = stager.add_many([te, ts, lp], pad=False)

    def blob(s, _hs=hs):
        return expand_tokens(s[_hs[0]], s[_hs[1]], s[_hs[2]], out_cap, steps)

    return plan[6], blob


def _rle_table(plane: np.ndarray, count: int, val_dtype,
               max_runs: int | None = None):
    """(bucket-padded ends, vals, cap) run tables of one strided lane or
    byte plane, or None when it has more than ``max_runs`` runs."""
    res = plane_native().run_scan(
        plane, count if max_runs is None else min(max_runs, count))
    if res is None:
        return None
    ends_r, vals_r = res
    cap = bucket(len(ends_r))
    ends = np.full(cap, count, dtype=np.int32)
    ends[: len(ends_r)] = ends_r
    vals = np.zeros(cap, dtype=val_dtype)
    vals[: len(vals_r)] = vals_r
    return ends, vals, cap


def _lane_contig(plane: np.ndarray) -> np.ndarray:
    """Contiguous copy of a (possibly strided) lane or plane view."""
    if plane.ndim == 1 and not plane.flags.c_contiguous:
        return plane_native().gather(plane)
    return np.ascontiguousarray(plane)


def _plan_plane_words(seg, count: int, lanes: int, stager: _Stager,
                      budget: int | None = None, lane_plans=None):
    """Plan the lane / byte-plane RLE transport for one PLAIN values
    segment (``count`` values of ``lanes`` u32 words).

    Per u32 lane, from a sample window: ``rle32`` (the lane is runs),
    ``bytes`` (random as a word, but some byte planes are runs) or
    ``raw32``.  ``budget`` is a competitor's wire cost: the planes engage
    only under it.  ``lane_plans`` is the plan cache's per-lane verdict
    list of this page: the sample window and the estimate's gate are
    skipped, and the gate on the built tables still applies.  Returns
    ``(wire, words(staged), spec, lane plans)`` — the wire of the built
    tables, K5's spec and the per-lane verdicts — or None when the page
    rejects."""
    if count < 1024:
        return None  # cannot clear the 4 KiB savings floor
    nbytes = count * lanes * 4
    buf = (seg.reshape(-1) if isinstance(seg, np.ndarray)
           else np.frombuffer(seg, dtype=np.uint8, count=nbytes))
    if buf.size < nbytes:
        raise ValueError("PLAIN values segment shorter than value count")
    words_v = buf[:nbytes].view("<u4")  # value-interleaved lanes
    wire_cap = (0.75 * nbytes if budget is None
                else min(0.75 * nbytes, budget))
    if lane_plans is not None and len(lane_plans) == lanes:
        plans = lane_plans
    else:
        win_n = min(count, 1 << 14)
        mid = (count - win_n) // 2
        # per lane: ("raw32",) | ("rle32", est) | ("bytes", cost8)
        plans = []
        wire = 0
        for lane in range(lanes):
            lw = np.ascontiguousarray(
                words_v[mid * lanes + lane : (mid + win_n) * lanes : lanes])
            r32 = float((lw[1:] != lw[:-1]).mean()) if win_n > 1 else 1.0
            est32 = 8 * bucket(int(r32 * count) + 1)
            if est32 < 4 * count:
                plans.append(("rle32", est32))
                wire += est32
                continue
            wb = lw.view(np.uint8).reshape(win_n, 4)
            r8 = (wb[1:] != wb[:-1]).mean(axis=0)
            cost8 = np.minimum(5 * np.array(
                [bucket(int(r * count) + 1) for r in r8]), count)
            if cost8.sum() < 0.75 * 4 * count:
                plans.append(("bytes", cost8))
                wire += int(cost8.sum())
            else:
                plans.append(("raw32",))
                wire += 4 * count
        # engage only on a solid win: each engaged lane costs host time
        if wire > wire_cap or nbytes - wire < 4096:
            return None

    raw32_parts, raw8_parts = [], []
    e32_parts, v32_parts, e8_parts, v8_parts = [], [], [], []
    s32 = s8 = 0
    spec = []
    actual = 0  # wire of the built tables (the sample can lie)

    def raw32(lane_v):
        nonlocal actual
        spec.append(("raw32", len(raw32_parts)))
        raw32_parts.append(_lane_contig(lane_v))
        actual += 4 * count

    def raw8(col):
        nonlocal actual
        raw8_parts.append(col)
        actual += count
        return ("raw8", len(raw8_parts) - 1)

    for lane, plan in enumerate(plans):
        lane_v = words_v[lane::lanes]  # strided view, len == count
        if plan[0] == "rle32":
            # past count/2 runs the 8 B/run table cannot beat the raw lane
            tab = _rle_table(lane_v, count, np.uint32,
                             max_runs=count // 2 + 1)
            if tab is None or 8 * tab[2] >= 4 * count:
                raw32(lane_v)
                continue
            ends, vals, cap = tab
            e32_parts.append(ends)
            v32_parts.append(vals)
            spec.append(("rle32", s32, cap))
            s32 += cap
            actual += 8 * cap
        elif plan[0] == "raw32":
            raw32(lane_v)
        else:
            cost8 = plan[1]
            subs = []
            for t in range(4):
                # byte t of value i's lane sits at i*4*lanes + 4*lane + t
                col = buf[4 * lane + t : nbytes : 4 * lanes]
                if cost8[t] >= count:
                    subs.append(raw8(_lane_contig(col)))
                    continue
                tab = _rle_table(col, count, np.uint8,
                                 max_runs=count // 5 + 1)
                if tab is None or 5 * tab[2] >= count:
                    subs.append(raw8(_lane_contig(col)))
                    continue
                ends, vals, cap = tab
                e8_parts.append(ends)
                v8_parts.append(vals)
                subs.append(("rle8", s8, cap))
                s8 += cap
                actual += 5 * cap
            spec.append(("bytes", *subs))
    # the gate again, on what the built tables weigh
    if actual > wire_cap or nbytes - actual < 4096:
        return None

    def cat(parts, dtype):
        if not parts:
            return np.zeros(1, dtype=dtype)
        return parts[0] if len(parts) == 1 else np.concatenate(parts)

    hs = stager.add_many(
        [cat(raw32_parts, np.uint32), cat(e32_parts, np.int32),
         cat(v32_parts, np.uint32), cat(raw8_parts, np.uint8),
         cat(e8_parts, np.int32), cat(v8_parts, np.uint8)], pad=False)
    spec = tuple(spec)

    def words(s, _hs=hs, _spec=spec):
        return planes_to_words(*(s[h] for h in _hs), _spec, count, lanes)

    return actual, words, spec, plans


def _plan_plain_transport(codec, values_seg, values_comp, non_null: int,
                          ptype: Type, stager: _Stager, arena=None,
                          hint=None):
    """The transports' competition for one PLAIN page, in the JAX
    package's order and with its gates.

    ``values_comp`` is ``(compressed payload, uncompressed size, values
    offset)`` when the page may decompress on the device, else None;
    ``values_seg`` the decompressed values, or None while deferred.
    Byte planes and delta lanes need the decompressed bytes; the token
    scan is a third of the plan wall, so it runs lazily: the compressed
    payload's size approximates the token wire, and a competitor already
    under it skips the scan.  ``hint`` is the plan cache's verdict of
    this page, ``("plain", winner, its parameters)``: only the winner's
    planner runs (none for a raw page).  Returns ``(words(staged) or
    None, values segment, verdict, competition)`` — the segment
    decompressed if the raw path needs it, the verdict for the plan
    cache, and the wire sizes the page event reports
    (:func:`_plain_page_event`)."""
    lanes = _LANES[ptype]
    is_int = ptype in (Type.INT32, Type.INT64)
    use_hint = (isinstance(hint, tuple) and len(hint) >= 2
                and hint[0] == "plain")
    hchoice = hint[1] if use_hint else None
    hparams = hint[2] if use_hint and len(hint) > 2 else None
    plan_words = None
    payload_bound = None
    if values_comp is not None:
        payload_bound = len(values_comp[0])
        competitors = ((_DEVICE_PLANES() or (_DEVICE_DELTA_LANES()
                                             and is_int))
                       and non_null >= 1024)
        if use_hint:
            competitors = hchoice in ("planes", "delta")
        if values_seg is None and competitors:
            values_seg = decompress_block(codec, values_comp[0],
                                          values_comp[1], arena)
    delta_cand = None
    if (not use_hint or hchoice == "delta") and _DEVICE_DELTA_LANES() \
            and is_int and values_seg is not None:
        delta_cand = _plan_delta_lane_words(
            values_seg, non_null, ptype,
            params=hparams if hchoice == "delta" else None)
    delta_wire = delta_cand[0] if delta_cand is not None else None
    lane_plans = None

    def try_planes(budget):
        if (not use_hint or hchoice == "planes") and _DEVICE_PLANES() \
                and non_null and values_seg is not None:
            return _plan_plane_words(
                values_seg, non_null, lanes, stager, budget=budget,
                lane_plans=hparams if hchoice == "planes" else None)
        return None

    budgets = [c for c in (delta_wire, payload_bound) if c is not None]
    pl = try_planes(min(budgets) if budgets else None)
    chosen = "planes" if pl is not None else None
    planes_wire = tok = None
    tok_scanned = False
    if pl is not None:
        planes_wire, plan_words, lane_plans = pl[0], pl[1], pl[3]
    else:
        run_tok = payload_bound is not None and not (
            delta_wire is not None and delta_wire < payload_bound)
        if use_hint:
            run_tok = hchoice == "snappy" and payload_bound is not None
        if run_tok:
            # no competitor beats the token bound: pay the scan
            tok_scanned = True
            tok = _plan_device_snappy_words(
                values_comp[0], values_comp[1], non_null * lanes,
                offset=values_comp[2])
            if tok is None and not use_hint:
                # the tokens are out after all: the planes may have lost
                # only to their bound
                pl = try_planes(delta_wire)
                if pl is not None:
                    planes_wire, plan_words, lane_plans = pl[0], pl[1], pl[3]
                    chosen = "planes"
        if plan_words is None:
            if delta_cand is not None and (tok is None
                                           or delta_cand[0] < tok[0]):
                plan_words, chosen = delta_cand[1](stager), "delta"
            elif tok is not None:
                plan_words, chosen = tok[1](stager), "snappy"
            elif values_seg is None:
                values_seg = decompress_block(codec, values_comp[0],
                                              values_comp[1], arena)
    st = current_stats()
    if st is not None and chosen is not None:
        name = {"planes": "pages_device_planes",
                "delta": "pages_device_delta_lanes",
                "snappy": "pages_device_snappy"}[chosen]
        setattr(st, name, getattr(st, name) + 1)
    params = (lane_plans if chosen == "planes"
              else delta_cand[2] if chosen == "delta" else None)
    chosen_wire = (planes_wire if chosen == "planes"
                   else delta_wire if chosen == "delta"
                   else tok[0] if chosen == "snappy" else None)
    competition = (chosen, chosen_wire, delta_wire, planes_wire,
                   None if tok is None else tok[0], tok_scanned,
                   payload_bound, use_hint)
    return plan_words, values_seg, ("plain", chosen, params), competition


def _plain_page_event(competition, values_seg, non_null: int, ptype: Type,
                      st, events: bool):
    """A PLAIN fixed-width page's event fields ``(transport, wire, raw,
    gate, reason)`` from its competition, as the reference words them
    ("declined": competed and lost; "n/a": never eligible), and its
    ``wire_ratio_permille`` sample when a transport won."""
    (chosen, chosen_wire, delta_wire, planes_wire, tok_wire, tok_scanned,
     payload_bound, use_hint) = competition
    raw = non_null * _LANES[ptype] * 4
    tr = _CHOSEN_TRANSPORT.get(chosen, "raw")
    wire = chosen_wire if chosen is not None else raw
    if st is not None and chosen is not None and raw:
        st.hist("wire_ratio_permille").record(chosen_wire * 1000 // raw)
    if not events:
        return tr, wire, raw, None, None
    gate = {"raw": raw}
    gate["delta-lanes"] = (
        delta_wire if delta_wire is not None
        else "declined" if (_DEVICE_DELTA_LANES()
                            and ptype in (Type.INT32, Type.INT64)
                            and values_seg is not None)
        else "n/a (type/flag/compressed)")
    gate["planes"] = (
        planes_wire if planes_wire is not None
        else "declined" if (_DEVICE_PLANES() and non_null
                            and values_seg is not None)
        else "n/a (flag/empty/compressed)")
    if tok_wire is not None:
        gate["snappy-tokens"] = tok_wire
    elif payload_bound is None:
        gate["snappy-tokens"] = "n/a (not device-snappy)"
    elif tok_scanned:
        gate["snappy-tokens"] = "declined"
    else:
        gate["snappy-tokens"] = (f"not-scanned (competitor under payload "
                                 f"bound {payload_bound}B)")
    reason = (f"{tr} {chosen_wire}B beat raw {raw}B" if chosen is not None
              else "no transport beat raw staging")
    if use_hint:
        reason += " (plan-cache hit)"
    return tr, wire, raw, gate, reason


def _int32_offsets(offs: np.ndarray) -> np.ndarray:
    """Byte offsets as the device layout's int32; raises ValueError past
    2^31 - 1 bytes, where the reference's int32 offsets would wrap."""
    if offs.size and int(offs[-1]) > _I32_MAX:
        raise ValueError(f"{int(offs[-1])} bytes of BYTE_ARRAY values "
                         "overflow the int32 offsets of the device layout")
    return offs.astype(np.int32)


def decode_chunk_device(blob, cm, node, base: int = 0, *,
                        device=None) -> DeviceColumn:
    """Decode one column chunk onto ``device`` (default: the current CUDA
    device; ``"cpu"`` runs the plain versions): ``blob`` holds the chunk's
    bytes from file offset ``base``, ``cm`` its metadata with absolute
    offsets.  The standalone form of the row-group path, one stager and
    one copy; the decompression outputs borrow from the calling thread's
    arena (``kernels/arena.py`` ``thread_arena``), whose slabs are
    released once the stream's copies and kernels have finished.  On an
    error the arena is discarded instead, since a copy may still read
    it."""
    dev = _resolve_device(device)
    arena = thread_arena()
    try:
        stager = _Stager()
        finish = plan_chunk_device(blob, cm, node, base, stager, arena)
        staged, slab = _put_all([stager], dev)
        col = finish(staged[0], dev)
        if dev.type == "cuda":
            # the copies and kernels read the pinned slab and the
            # arena's slabs: both may go only once the stream is done
            torch.cuda.current_stream(dev).synchronize()
        del slab
    except BaseException:
        discard_thread_arena()
        raise
    arena.release_all()
    return col


def plan_chunk_device(blob, cm, node, base: int, stager: _Stager,
                      arena: HostArena | None = None,
                      verify_crc: bool | None = None, cache_key=None,
                      cache_state: list | None = None):
    """Host phase of one column chunk: page-header walk, CRC checks,
    decompression, run-table scans, staging registration.  Returns
    ``finish(staged, device)``, which launches the page kernels and
    assembles the :class:`DeviceColumn`.  Offsets in ``cm`` are absolute;
    ``blob`` starts at file offset ``base``.  ``arena`` lends the
    decompression outputs (they must outlive the row group's fence; None:
    fresh arrays).  ``verify_crc`` gates the check of page CRCs where a
    header carries one (None: the ``TPQ_PAGE_CRC_VERIFY`` default); each
    page checked counts ``pages_crc_verified``.

    ``cache_key`` is this chunk's plan-cache identity (``(footer
    fingerprint, row group, column)``, ``kernels/plancache.py``): on a
    hit each PLAIN page runs only its remembered transport's planner, on
    a miss the verdicts are stored.  Hints choose which lossless
    transport ships, never the decoded bytes.  ``cache_state`` (a list)
    receives ``"hit"``, ``"miss"`` or ``"off"`` for the plan span.

    Under :func:`cpu_fallback_values` (a degraded plan) each data page's
    values decode on the host and stage as finished buffers, its
    transport is ``"host-degraded"`` and it counts ``pages_degraded``;
    the level streams still expand on the device, and the plan cache is
    neither read nor written.  The page loop holds the fault sites
    ``kernels.device.page_payload`` and (not in a degraded plan)
    ``kernels.device.page_dispatch``."""
    if verify_crc is None:
        verify_crc = crc_verify_default()
    st = current_stats()
    # the per-page event log: only under collect_stats(events=True)
    ev = None if st is None else st.events
    degraded = _host_values_only()
    pc = hints = record = None
    if cache_key is not None and not degraded:
        pc = plan_cache()
        if pc is not None:
            hints = pc.lookup(cache_key)
            if hints is None:
                record = []
    if cache_state is not None:
        cache_state.append("off" if pc is None
                           else "hit" if hints is not None else "miss")
    ptype = Type(cm.type)
    col_path = ".".join(cm.path_in_schema)
    is_bytes = ptype == Type.BYTE_ARRAY
    fixed = ptype in _LANES  # PLAIN pages of these take the transports
    if Type(node.element.type) != ptype:
        raise ValueError(f"column chunk type {ptype.name} differs from the "
                         f"schema's {Type(node.element.type).name}")
    type_length = node.type_length
    if ptype == Type.FIXED_LEN_BYTE_ARRAY and not type_length:
        raise ValueError("FIXED_LEN_BYTE_ARRAY requires type_length")
    if st is not None:
        st.chunks += 1
        st.bytes_compressed += cm.total_compressed_size
        st.bytes_uncompressed += cm.total_uncompressed_size or 0
        st.values += cm.num_values
    start = cm.data_page_offset
    if cm.dictionary_page_offset is not None:
        start = min(start, cm.dictionary_page_offset)
    start -= base
    end = start + cm.total_compressed_size
    r = CompactReader(blob, start, end)
    vlanes = None if is_bytes else _lanes_for(ptype, type_length)
    max_rep = node.max_rep_level
    max_def = node.max_def_level
    dwidth = max_def.bit_length()
    total = cm.num_values
    dict_h = None  # staged words, or (offsets, data) handles for bytes
    dict_host = None  # the dictionary's own host copy, degraded plans only
    dict_lens = None
    dict_len = 0
    chunk_bytes = 0  # BYTE_ARRAY value bytes so far (int32 offsets)
    ops = []  # deferred device work: op(staged, parts) -> None
    values_read = 0
    page_i = 0  # every page (error coordinates)
    data_i = 0  # data pages: the plan cache's hint index
    codec_name = CompressionCodec(cm.codec).name
    while values_read < total:
        if r.pos >= end:
            raise CorruptChunkError(
                f"column chunk exhausted at {values_read}/{total} values",
                column=col_path)
        t_pg = time.perf_counter() if ev is not None else 0.0
        ph = decode_struct(PageHeader, r)
        if ph.compressed_page_size is None or ph.compressed_page_size < 0:
            raise CorruptPageError("page header missing compressed size",
                                   column=col_path, page=page_i)
        if ph.uncompressed_page_size is None \
                or ph.uncompressed_page_size < 0:
            raise CorruptPageError("page header missing uncompressed size",
                                   column=col_path, page=page_i)
        if r.pos + ph.compressed_page_size > end:
            raise CorruptPageError("page payload overruns column chunk",
                                   column=col_path, page=page_i)
        payload = np.frombuffer(
            filter_bytes("kernels.device.page_payload",
                         blob[r.pos : r.pos + ph.compressed_page_size],
                         column=col_path, page=page_i), dtype=np.uint8)
        if payload.size != ph.compressed_page_size:
            raise CorruptPageError("page payload truncated",
                                   column=col_path, page=page_i)
        if verify_page_crc(ph, payload, enabled=verify_crc, column=col_path,
                           page=page_i) and st is not None:
            st.pages_crc_verified += 1
        r.pos += ph.compressed_page_size
        page_i += 1
        kind = PageType(ph.type)
        if kind in (PageType.DATA_PAGE, PageType.DATA_PAGE_V2) \
                and not degraded:
            # a device failure of this data page (fault site); a degraded
            # plan, whose values launch no kernel, skips it
            fault_point("kernels.device.page_dispatch", column=col_path,
                        page=data_i)
        if kind == PageType.DICTIONARY_PAGE:
            dph = ph.dictionary_page_header
            if dph is None or dph.num_values is None or dph.num_values < 0:
                raise ValueError("DICTIONARY_PAGE header missing its struct")
            raw = decompress_block(cm.codec, payload,
                                   ph.uncompressed_page_size, arena)
            arr = decode_plain(ptype, raw, dph.num_values, type_length)
            if degraded:
                # the host gather needs its own copy: ``raw`` is the
                # arena's, which recycles
                dict_host = (arr if is_bytes
                             else np.array(arr, copy=True))
            if is_bytes:
                dict_lens = arr.lengths()
                dict_len = dict_lens.size
                dict_h = (stager.add(_int32_offsets(arr.offsets)),
                          stager.add(arr.data))
            else:
                dict_len = arr.shape[0]
                if ptype == Type.BOOLEAN:
                    words = arr.astype(np.uint32)
                elif ptype == Type.FIXED_LEN_BYTE_ARRAY:
                    words = _stage_byte_rows_np(arr)
                else:
                    words = arr.view("<u4").reshape(-1)
                dict_h = stager.add(words)
            if r.pos != cm.data_page_offset - base:
                r.pos = cm.data_page_offset - base
            continue
        # device snappy for a PLAIN page: a fixed-width page's values may
        # decompress on the device (``values_comp``, into the transports'
        # competition), a BYTE_ARRAY page's whole block (``bytes_comp``,
        # for K10); either is (compressed block, size, values offset)
        snappy = (_DEVICE_SNAPPY()
                  and cm.codec == CompressionCodec.SNAPPY)
        values_comp = bytes_comp = None
        if kind == PageType.DATA_PAGE:
            h = ph.data_page_header
            if h is None or h.num_values is None or h.num_values < 0:
                raise ValueError("DATA_PAGE header missing data_page_header")
            n = h.num_values
            enc = h.encoding
            snappy = snappy and enc == Encoding.PLAIN
            if snappy and not max_rep and not max_def and fixed:
                # a flat required PLAIN page holds no level bytes, so
                # planning needs nothing from the payload: decompression
                # is deferred to the transports' competition
                values_comp = (payload, ph.uncompressed_page_size, 0)
                values_seg = dl_scan = dl_host = None
            else:
                raw = decompress_block(cm.codec, payload,
                                       ph.uncompressed_page_size, arena)
                pos = 0
                if max_rep:  # the rep stream comes first
                    rl_scan, rl_host, pos = scan_levels_v1(
                        raw, n, max_rep, pos, h.repetition_level_encoding)
                    _defer_rep_levels(ops, stager, rl_scan, n, max_rep,
                                      rl_host)
                dl_scan, dl_host, pos = scan_levels_v1(
                    raw, n, max_def, pos, h.definition_level_encoding)
                values_seg = raw[pos:]
                # with levels, the host scans them from its own copy, and
                # the device may still take the values out of its own
                # expansion of the tokens, at byte `pos`
                comp = (payload, ph.uncompressed_page_size, pos)
                if snappy and is_bytes:
                    bytes_comp = comp
                elif snappy and fixed:
                    values_comp = comp
        elif kind == PageType.DATA_PAGE_V2:
            h = ph.data_page_header_v2
            if h is None or h.num_values is None or h.num_values < 0:
                raise ValueError(
                    "DATA_PAGE_V2 header missing data_page_header_v2")
            n = h.num_values
            enc = h.encoding
            snappy = snappy and enc == Encoding.PLAIN
            # V2 keeps the levels outside compression: planning needs only
            # the level bytes, and the values block decompresses on its own
            rl_scan, dl_scan, vpos = scan_levels_v2(payload, h, n, max_rep,
                                                    max_def)
            dl_host = None
            if rl_scan is not None:
                _defer_rep_levels(ops, stager, rl_scan, n, max_rep)
            values_seg = payload[vpos:]
            if h.is_compressed is not False:
                comp = (values_seg, ph.uncompressed_page_size - vpos, 0)
                if snappy and fixed:
                    values_comp, values_seg = comp, None
                else:
                    if snappy and is_bytes:
                        bytes_comp = comp
                    values_seg = decompress_block(cm.codec, comp[0], comp[1],
                                                  arena)
        else:
            continue  # index pages carry nothing to decode
        # the page's coordinates ride the flight recorder with or without
        # a collector (the call guarded: this is the per-page loop)
        if _flightrec._active is not None:
            _flightrec.flight("page", site="kernels.device",
                              column=col_path, page=data_i, values=n)
        if st is not None:
            st.pages += 1
            st.hist("page_comp_bytes").record(ph.compressed_page_size)
            st.hist("page_uncomp_bytes").record(ph.uncompressed_page_size)
        non_null = (count_eq_scan(dl_scan, dwidth, max_def,
                                  validate_max=True)
                    if dl_scan is not None
                    else int((dl_host == max_def).sum())
                    if dl_host is not None else n)
        if (kind == PageType.DATA_PAGE_V2 and dl_scan is not None
                and h.num_nulls is not None
                and n - h.num_nulls != non_null):
            raise ValueError(f"V2 num_nulls {h.num_nulls} disagrees with "
                             f"def levels ({n - non_null} nulls)")
        values_read += n
        # the plan cache's verdict of this data page, and the one to
        # record: every data page records one entry, so the indices stay
        # aligned with the data-page ordinal across re-reads
        hint = (hints[data_i] if hints is not None and data_i < len(hints)
                else None)
        verdict = None
        data_i += 1
        plan_words = None
        # the page event's fields, resolved by the branches below
        tr = wire_ev = raw_ev = gate = reason = None
        if enc == Encoding.PLAIN and fixed:
            plan_words, values_seg, verdict, competition = \
                _plan_plain_transport(cm.codec, values_seg, values_comp,
                                      non_null, ptype, stager, arena, hint)
            tr, wire_ev, raw_ev, gate, reason = _plain_page_event(
                competition, values_seg, non_null, ptype, st,
                ev is not None)

        dl_ref = None  # (handles, cnt, nbp, single)
        if dl_scan is not None:
            dl_args, dl_cnt, dl_nbp, dl_sg = plan_stream_args(
                dl_scan, n, dwidth)
            dl_ref = (stager.add_many(dl_args, pad=False), dl_cnt, dl_nbp,
                      dl_sg)
        elif dl_host is not None:
            # host-decoded BIT_PACKED levels stage as they are, and the
            # page's value op then runs without a def stream of its own
            ops.append(_host_levels_op("def", stager.add(dl_host), n))

        if degraded:
            tr, wire_ev, raw_ev, gate = "host-degraded", None, None, None
            reason = "device dispatch degraded: CPU oracle decode"
            if st is not None:
                st.pages_degraded += 1
            op, nb = _degraded_page_op(values_seg, enc, ptype, type_length,
                                       dict_host, dict_len, non_null,
                                       dl_ref, n, dwidth, stager, col_path,
                                       data_i - 1)
            chunk_bytes += nb
            ops.append(op)
        elif enc in _DICT_ENCODINGS:
            tr = "dict"
            if dict_h is None:
                raise CorruptChunkError(
                    "dictionary-encoded page but no dictionary page seen",
                    column=col_path)
            width = int(values_seg[0]) if len(values_seg) else 0
            if width > 32:
                raise ValueError(f"dictionary index bit width {width} > 32")
            if is_bytes:
                op, nb = _plan_dict_bytes_page(values_seg, width, non_null,
                                               dict_h, dict_lens, dl_ref, n,
                                               dwidth, stager)
                chunk_bytes += nb
                ops.append(op)
            else:
                i_sc = scan_hybrid(values_seg, non_null, width, pos=1) \
                    if width else None
                _check_dict_indices(i_sc, width, non_null, dict_len)
                idx_ref = None
                if i_sc is not None:
                    i_args, i_cnt, i_nbp, i_sg = plan_stream_args(
                        i_sc, non_null, width)
                    idx_ref = (stager.add_many(i_args, pad=False), i_cnt,
                               i_nbp, i_sg)
                ops.append(_dict_page_op(dict_h, dl_ref, idx_ref, width, n,
                                         non_null, dwidth, vlanes))
        elif enc == Encoding.PLAIN and is_bytes:
            # a cached "no tokens" verdict skips the token scan
            if hint == ("ba", False):
                bytes_comp = None
            op, nb, blob_wire, budget = _plan_plain_bytes_page(
                values_seg, bytes_comp, non_null, dl_ref, n, dwidth, stager)
            verdict = ("ba", blob_wire is not None)
            raw_ev = nb
            if blob_wire is not None:
                tr, wire_ev = "snappy-tokens", blob_wire
                reason = (f"tokens {blob_wire}B under budget {int(budget)}B "
                          f"(raw {nb}B)")
            else:
                tr, wire_ev = "raw", nb
            if ev is not None:
                gate = {"raw": nb, "snappy-tokens": (
                    blob_wire if blob_wire is not None
                    else "declined" if budget is not None
                    else "n/a (not device-snappy)")}
            chunk_bytes += nb
            ops.append(op)
        elif enc == Encoding.PLAIN and fixed:
            if plan_words is None:  # no transport won: the words ship
                wh = stager.add(stage_u32(values_seg, non_null * vlanes))
                plan_words = lambda s, _wh=wh: s[_wh]  # noqa: E731
            ops.append(_plain_page_op(plan_words, dl_ref, n, non_null,
                                      dwidth, vlanes))
        elif enc == Encoding.PLAIN:  # BOOLEAN, FIXED_LEN_BYTE_ARRAY
            tr = "raw"
            ops.append(_plain_rows_op(values_seg, ptype, type_length,
                                      dl_ref, n, non_null, dwidth))
        elif enc == Encoding.DELTA_BINARY_PACKED and ptype in (Type.INT32,
                                                                Type.INT64):
            tr = "delta-bp"
            ops.append(_delta_page_op(values_seg, ptype, dl_ref, n, non_null,
                                      dwidth, stager))
        elif enc == Encoding.BYTE_STREAM_SPLIT and ptype not in (
                Type.BOOLEAN, Type.INT96, Type.BYTE_ARRAY):
            tr = "bss"
            k = type_length if ptype == Type.FIXED_LEN_BYTE_ARRAY \
                else 4 * vlanes
            ops.append(_bss_page_op(values_seg, dl_ref, n, non_null, dwidth,
                                    k, vlanes, stager))
        elif enc == Encoding.RLE and ptype == Type.BOOLEAN:
            tr = "rle"
            ops.append(_rle_bool_page_op(values_seg, dl_ref, n, non_null,
                                         dwidth, stager))
        elif enc == Encoding.DELTA_LENGTH_BYTE_ARRAY and is_bytes:
            tr = "dlba"
            op, nb = _plan_dlba_page(values_seg, dl_ref, n, non_null, dwidth,
                                     stager)
            chunk_bytes += nb
            ops.append(op)
        elif enc == Encoding.DELTA_BYTE_ARRAY and (
                is_bytes or ptype == Type.FIXED_LEN_BYTE_ARRAY):
            op, nb, (tr, expanded, compact) = _plan_dba_page(
                values_seg, type_length if not is_bytes else None, dl_ref, n,
                non_null, dwidth, stager)
            if ev is not None:
                gate = {"expanded": expanded, "compact": compact}
                if tr == "dba-host":
                    wire_ev = raw_ev = expanded
                    reason = (f"front coding non-expanding: host assembly "
                              f"ships {expanded}B vs compact wire "
                              f"{compact}B")
                else:
                    wire_ev, raw_ev = compact, expanded
                    reason = (f"copy-token expansion: {compact}B wire vs "
                              f"{expanded}B expanded")
            chunk_bytes += nb
            ops.append(op)
        else:
            # no device kernel takes this (encoding, type), or the number
            # is none of the format's: the values decode on the host,
            # which raises the reference's words for what it cannot read
            tr = "host"
            reason = "no device kernel for this encoding"
            if st is not None:
                st.pages_host_values += 1
            op, nb = _degraded_page_op(values_seg, enc, ptype, type_length,
                                       None, 0, non_null, dl_ref, n, dwidth,
                                       stager, col_path, data_i - 1)
            chunk_bytes += nb
            ops.append(op)
        if chunk_bytes > _I32_MAX:
            raise ValueError(f"{chunk_bytes} bytes of BYTE_ARRAY values "
                             "overflow the int32 offsets of the device "
                             "layout")
        if ev is not None:
            # one event a data page (dictionary and index pages are not)
            ev.page(column=col_path, page=data_i - 1,
                    page_type=("v2" if kind == PageType.DATA_PAGE_V2
                               else "v1"),
                    encoding=Encoding(enc).name, codec=codec_name,
                    num_values=n, non_null=non_null,
                    transport=tr if tr is not None else "unknown",
                    wire_bytes=wire_ev, raw_bytes=raw_ev, gate=gate,
                    reason=reason, plan_s=time.perf_counter() - t_pg)
        if record is not None:
            record.append(verdict)
    if record is not None:
        pc.store(cache_key, record, plan_cache_budget())

    def finish(staged, device) -> DeviceColumn:
        parts = {"val": [], "bytes": [], "rep": [], "def": [],
                 "device": device}
        for op in ops:
            op(staged, parts)
        rl, _ = _merge_parts(parts["rep"])
        dl, _ = _merge_parts(parts["def"])
        mask = positions = None
        if max_def and dl is not None:
            mask, positions = levels_to_validity(dl, max_def)
        if parts["bytes"]:
            data, offs, n_bytes = _merge_bytes(parts["bytes"])
            return DeviceColumn(ptype, data, mask, positions, dl, total,
                                offs.size - 1, offsets=_upload(offs, device),
                                n_bytes=n_bytes, rep_levels=rl)
        data, n_packed = _merge_parts(parts["val"], lanes=vlanes or 1)
        return DeviceColumn(ptype, data, mask, positions, dl, total,
                            n_packed, rep_levels=rl, type_length=type_length,
                            device=device)

    return finish


def _degraded_page_op(values_seg, enc, ptype, type_length, dict_host,
                      dict_len: int, non_null: int, dl_ref, n: int,
                      dwidth: int, stager: _Stager, col_path: str,
                      page: int):
    """A degraded plan's page (:func:`cpu_fallback_values`): the values
    decode on the host (``decode_values``, or the dictionary's indices
    and gather), and the op stages them as they are; the def stream
    expands on the device on its own.  A byte column's bytes ride the
    stager (padded and counted, as in the reference), fixed-width words
    upload outside it.  Returns ``(op, value bytes)``."""
    if enc in _DICT_ENCODINGS:
        if dict_host is None:
            raise CorruptChunkError(
                "dictionary-encoded page but no dictionary page seen",
                column=col_path)
        idx = decode_dict_indices(bytes(memoryview(values_seg)), non_null)
        if idx.size and int(idx.max()) >= dict_len:
            raise CorruptPageError(
                f"dictionary index {int(idx.max())} out of range "
                f"(dictionary has {dict_len})", column=col_path, page=page)
        col = gather(dict_host, idx)
    else:
        col = decode_values(ptype, enc, values_seg, non_null, type_length)
    if isinstance(col, ByteArrayColumn):
        dh = stager.add(col.data)
        offs = _int32_offsets(col.offsets)
        nb = int(col.data.size)

        def op(s, parts):
            _add_def(s, parts, dl_ref, dwidth, n)
            parts["bytes"].append((offs, s[dh], nb))

        return op, nb
    arr = np.asarray(col)
    if arr.dtype == np.bool_:
        words = arr.astype(np.uint32).reshape(-1)
    elif arr.dtype.itemsize in (4, 8):
        words = np.ascontiguousarray(arr).view("<u4").reshape(-1)
    elif arr.ndim == 2:  # FIXED_LEN_BYTE_ARRAY rows
        words = _stage_byte_rows_np(arr)
    else:
        raise TypeError(f"cannot stage {arr.dtype} values of {ptype.name}")

    def op(s, parts):
        _add_def(s, parts, dl_ref, dwidth, n)
        parts["val"].append((_upload(words, parts["device"]), non_null))

    return op, 0


def _merge_bytes(parts):
    """[(int32 host offsets, padded device bytes, n_bytes)] -> (data,
    int32 offsets, n_bytes).  One page keeps its padded bytes; several
    are sliced to their length and concatenated, with the offsets rebased
    on the host."""
    if len(parts) == 1:
        offs, data, nb = parts[0]
        return data, offs, nb
    offs = [np.zeros(1, dtype=np.int64)]
    datas = []
    base_off = 0
    for o, data, nb in parts:
        offs.append(o[1:].astype(np.int64) + base_off)
        datas.append(data[:nb])
        base_off += nb
    return torch.cat(datas), np.concatenate(offs).astype(np.int32), base_off


def _plan_dict_bytes_page(values_seg, width: int, non_null: int, dict_h,
                          dict_lens, dl_ref, n: int, dwidth: int,
                          stager: _Stager):
    """Plan one dictionary page of BYTE_ARRAY values: the host expands the
    indices once (vectorised) to check them and to size the output — the
    offsets, and ``cap = bucket(total bytes)`` — and the index stream
    ships as its run table for K9.  Returns ``(op, value bytes)``."""
    if width:
        i_sc = scan_hybrid(values_seg, non_null, width, pos=1)
        idx_u = expand_scan(*i_sc[:6], non_null, width)
        # checked before the int32 cast: a width-32 index like 0xFFFFFFFF
        # would wrap negative and pass
        _check_dict_indices(None, width, non_null, dict_lens.size,
                            idx_np=idx_u)
        idx_np = idx_u.astype(np.int32)
    else:
        i_sc = None
        idx_np = np.zeros(non_null, np.int32)
        _check_dict_indices(None, width, non_null, dict_lens.size,
                            idx_np=idx_np)
    lens = dict_lens[idx_np]
    out_offsets = np.zeros(non_null + 1, dtype=np.int64)
    np.cumsum(lens, out=out_offsets[1:])
    out_offsets = _int32_offsets(out_offsets)
    total_b = int(out_offsets[-1])
    cap = bucket(max(total_b, 1))
    if i_sc is not None:
        i_args, i_cnt, i_nbp, i_sg = plan_stream_args(i_sc, non_null, width,
                                                      expanded=idx_u)
        idx_hs = stager.add_many(i_args, pad=False)
    else:
        idx_hs, i_cnt, i_nbp, i_sg = None, bucket(max(non_null, 1)), 0, False
    doh, ddh = dict_h

    def op(s, parts):
        _add_def(s, parts, dl_ref, dwidth, n)
        bp, tbl = (None, None) if idx_hs is None else \
            (s[idx_hs[0]], s[idx_hs[1]])
        data = page_dict_bytes(s[doh], s[ddh], bp, tbl, non_null, i_cnt,
                               width, i_nbp, cap, isingle=i_sg)
        parts["bytes"].append((out_offsets, data, total_b))

    return op, total_b


def _plan_plain_bytes_page(values_seg, bytes_comp, non_null: int, dl_ref,
                           n: int, dwidth: int, stager: _Stager):
    """Plan one PLAIN BYTE_ARRAY page: the host scans the length prefixes
    (one C pass) for the offsets.  When the page may decompress on the
    device and its token tables cost under ``0.9 x`` its value bytes, less
    the padded offsets that must ship with them, the tables ship and K8
    then K10 rebuild the values on the device (counted in
    ``pages_device_snappy``); otherwise the value bytes ship.  Returns
    ``(op, value bytes, the tables' wire or None, the token budget or
    None)``."""
    col = decode_plain(Type.BYTE_ARRAY, values_seg, non_null)
    offs = _int32_offsets(col.offsets)
    nb = int(col.data.size)
    blob_plan = budget = None
    if bytes_comp is not None:
        budget = 0.9 * nb - 4 * bucket(non_null + 1)
        if budget > 0:
            blob_plan = _plan_device_snappy_blob(bytes_comp[0], bytes_comp[1],
                                                 budget, stager)
    if blob_plan is not None:
        st = current_stats()
        if st is not None:
            st.pages_device_snappy += 1
            if nb:
                st.hist("wire_ratio_permille").record(
                    blob_plan[0] * 1000 // nb)
        blob_fn = blob_plan[1]
        cap = bucket(max(nb, 1))
        offs_pad = np.full(bucket(non_null + 1), nb, dtype=np.int32)
        offs_pad[: non_null + 1] = offs
        oh = stager.add(offs_pad, pad=False)
        pos = bytes_comp[2]

        def get_data(s):
            return plain_bytes_from_blob(blob_fn(s), s[oh], pos, cap)
    else:
        dh = stager.add(col.data)

        def get_data(s):
            return s[dh]

    def op(s, parts):
        _add_def(s, parts, dl_ref, dwidth, n)
        parts["bytes"].append((offs, get_data(s), nb))

    return op, nb, (None if blob_plan is None else blob_plan[0]), budget


def _dict_page_op(dict_h, dl_ref, idx_ref, width, n, non_null, dwidth,
                  lanes):
    """Deferred launch of one dictionary page (K3, after K2 when the
    index stream is a run table, plus the def stream's K1/K2 for an
    optional column)."""
    def op(s, parts):
        if idx_ref is None:  # width 0: every index is 0
            i_bp = i_tbl = None
            i_cnt, i_nbp, i_sg = non_null, 0, False
        else:
            (ih, it), i_cnt, i_nbp, i_sg = idx_ref
            i_bp, i_tbl = s[ih], s[it]
        if dl_ref is not None and idx_ref is not None:
            (dh, dt), d_cnt, d_nbp, d_sg = dl_ref
            vals, dl = page_dict_fixed_levels_tbl(
                s[dict_h], s[dh], s[dt], i_bp, i_tbl, d_cnt, dwidth, d_nbp,
                i_cnt, width, i_nbp, lanes=lanes, dsingle=d_sg,
                isingle=i_sg)
            parts["def"].append((dl, n))
        else:
            _add_def(s, parts, dl_ref, dwidth, n)
            vals = page_dict_fixed(s[dict_h], i_bp, i_tbl, i_cnt, width,
                                   i_nbp, lanes=lanes, isingle=i_sg)
        parts["val"].append((vals, non_null))

    return op


def _plain_page_op(get_words, dl_ref, n, non_null, dwidth, lanes):
    """Deferred PLAIN page: ``get_words(staged)`` gives the value words,
    staged as they are or rebuilt by a wire transport's kernels."""
    def op(s, parts):
        words = get_words(s)
        if dl_ref is not None:
            (dh, dt), d_cnt, d_nbp, d_sg = dl_ref
            vals, dl = page_plain_fixed_levels_tbl(
                words, s[dh], s[dt], non_null, lanes, d_cnt, dwidth, d_nbp,
                dsingle=d_sg)
            parts["def"].append((dl, n))
        else:
            vals = plain_fixed_to_lanes(words, non_null, lanes)
        parts["val"].append((vals, non_null))

    return op


def _delta_page_op(values_seg, ptype, dl_ref, n, non_null, dwidth,
                   stager: _Stager):
    """Deferred DELTA_BINARY_PACKED page: the def stream expands on its
    own, the stream's plan stages (:func:`_stage_delta_plan`) and the
    values rebuild on the device, sliced to the page's non-null count."""
    i64 = ptype == Type.INT64
    plan = plan_delta_i64(values_seg) if i64 else plan_delta_i32(values_seg)
    build = _stage_delta_plan(plan, stager, need_hi=i64)

    def op(s, parts):
        _add_def(s, parts, dl_ref, dwidth, n)
        p = build(s, parts["device"])
        words = (expand_delta_i64(p)[: 2 * non_null] if i64
                 else expand_delta_i32(p)[:non_null])
        parts["val"].append((words, non_null))

    return op


def _bss_page_op(values_seg, dl_ref, n, non_null, dwidth, k, lanes,
                 stager: _Stager):
    """Deferred BYTE_STREAM_SPLIT page of ``k``-byte values: the first
    ``non_null * k`` bytes stage padded and K12 turns them into lane
    words; a page without values stages nothing."""
    raw = (values_seg.reshape(-1) if isinstance(values_seg, np.ndarray)
           else np.frombuffer(values_seg, dtype=np.uint8))
    if raw.size < non_null * k:
        raise ValueError("BYTE_STREAM_SPLIT: input too short")
    rh = stager.add(raw[: non_null * k]) if non_null else None

    def op(s, parts):
        _add_def(s, parts, dl_ref, dwidth, n)
        if rh is not None:
            parts["val"].append((bss_to_lanes(s[rh], non_null, k, lanes),
                                 non_null))

    return op


def _plain_rows_op(values_seg, ptype, type_length, dl_ref, n, non_null,
                   dwidth):
    """Deferred PLAIN page of BOOLEAN or FIXED_LEN_BYTE_ARRAY values, which
    the reference uploads outside the stager (so not in
    ``bytes_staged``): BOOLEAN ships its bit-packed words, padded to whole
    32-value blocks, for K1 at width 1; FIXED_LEN_BYTE_ARRAY ships its rows
    zero-padded to whole lanes."""
    buf = (values_seg.reshape(-1) if isinstance(values_seg, np.ndarray)
           else np.frombuffer(values_seg, dtype=np.uint8))
    if ptype == Type.BOOLEAN:
        host = pad_to_words(buf, 1, non_null).reshape(-1)
    else:
        if buf.size < non_null * type_length:
            raise ValueError("PLAIN FIXED_LEN_BYTE_ARRAY: input too short")
        host = _stage_byte_rows_np(
            buf[: non_null * type_length].reshape(non_null, type_length))

    def op(s, parts):
        _add_def(s, parts, dl_ref, dwidth, n)
        vals = _upload(host, parts["device"])
        if ptype == Type.BOOLEAN:
            vals = unpack_u32(vals, 1, non_null)
        parts["val"].append((vals, non_null))

    return op


def _rle_bool_page_op(values_seg, dl_ref, n, non_null, dwidth,
                      stager: _Stager):
    """Deferred RLE page of BOOLEAN values: a length-prefixed width-1
    hybrid stream, checked against the page and scanned as the V1 levels
    are; its plan stages and K1 or K2 expands it into u32 value lanes."""
    if len(values_seg) < 4:
        raise ValueError("boolean RLE stream missing length")
    (size,) = struct.unpack_from("<I", values_seg, 0)
    if 4 + size > len(values_seg):
        raise ValueError("boolean RLE length exceeds page")
    hs = None
    if non_null:
        scan, _, _ = scan_levels_v1(values_seg, non_null, 1, 0)
        args, cnt, nbp, single = plan_stream_args(scan, non_null, 1)
        hs = stager.add_many(args, pad=False)

    def op(s, parts):
        _add_def(s, parts, dl_ref, dwidth, n)
        if hs is not None:
            parts["val"].append((expand_hybrid(s[hs[0]], s[hs[1]], cnt, 1,
                                               nbp, single), non_null))

    return op


def _plan_dlba_page(values_seg, dl_ref, n, non_null, dwidth,
                    stager: _Stager):
    """Plan one DELTA_LENGTH_BYTE_ARRAY page: the host decodes the lengths
    (validated as the CPU decoder validates them) and the value bytes
    stage as they lie in the page.  Returns ``(op, value bytes)``."""
    offs, dpos = scan_delta_length_byte_array(values_seg, non_null)
    nb = int(offs[-1])
    offs = _int32_offsets(offs)
    dh = stager.add(np.frombuffer(values_seg, np.uint8, nb, dpos))

    def op(s, parts):
        _add_def(s, parts, dl_ref, dwidth, n)
        parts["bytes"].append((offs, s[dh], nb))

    return op, nb


def _plan_dba_page(values_seg, flba_len, dl_ref, n, non_null, dwidth,
                   stager: _Stager):
    """Plan one DELTA_BYTE_ARRAY page (``flba_len``: the row length of a
    FIXED_LEN_BYTE_ARRAY column, else None), as the reference does.

    Front coding is the copy-resolution problem K8 solves: value ``i`` is
    one copy token (its prefix, read from value ``i - 1``'s output start)
    and one literal token (its suffix).  The page ships those tables and
    the suffixes, K8 expands them, and for FIXED_LEN_BYTE_ARRAY K13 turns
    the rows into lane words.  A page with no values, one whose expansion
    would pass 2^30 bytes, or one whose expanded bytes are fewer than the
    suffixes plus 8 bytes a value is assembled on the host instead and
    ships its values (``dba-host``).  Returns ``(op, value bytes,
    (transport, expanded bytes, compact bytes))``: the bytes a
    BYTE_ARRAY page adds to the column (0 for rows), and the page
    event's numbers."""
    prefix, ppos = decode_delta_binary_packed(values_seg, np.int64)
    if prefix.size != non_null:
        raise ValueError("DELTA_BYTE_ARRAY: prefix count mismatch")
    soffs, spos = scan_delta_length_byte_array(values_seg, non_null, ppos)
    if non_null:
        if prefix[0] != 0:
            raise ValueError("DELTA_BYTE_ARRAY: first prefix must be 0")
        if (prefix < 0).any():
            raise ValueError("DELTA_BYTE_ARRAY: negative prefix")
    total_lens = prefix + np.diff(soffs)
    if non_null > 1 and (prefix[1:] > total_lens[:-1]).any():
        raise ValueError("DELTA_BYTE_ARRAY: prefix longer than previous value")
    if flba_len is not None and non_null and not (
            total_lens == flba_len).all():
        raise ValueError("DELTA_BYTE_ARRAY: FLBA value length mismatch")
    offs = np.zeros(non_null + 1, dtype=np.int64)
    np.cumsum(total_lens, out=offs[1:])
    expanded = int(offs[-1])
    n_suffix = int(soffs[-1])
    suffixes = np.frombuffer(values_seg, np.uint8, n_suffix, spos)
    nb = 0 if flba_len is not None else expanded
    compact = n_suffix + 8 * non_null  # suffixes and the token table
    if non_null == 0 or expanded > 1 << 30 or expanded < compact:
        col = assemble_delta_byte_array(prefix, soffs, suffixes)
        if flba_len is not None:
            host = _stage_byte_rows_np(
                col.data[: non_null * flba_len].reshape(non_null, flba_len))

            def op(s, parts):
                _add_def(s, parts, dl_ref, dwidth, n)
                parts["val"].append((_upload(host, parts["device"]),
                                     non_null))
        else:
            dh = stager.add(col.data)
            offs32 = _int32_offsets(col.offsets)

            def op(s, parts):
                _add_def(s, parts, dl_ref, dwidth, n)
                parts["bytes"].append((offs32, s[dh], nb))

        return op, nb, ("dba-host", expanded, compact)
    out_cap = bucket(expanded)
    cap_t = bucket(2 * non_null)
    te = np.full(cap_t, out_cap, dtype=np.int32)
    ts = np.full(cap_t, -1, dtype=np.int32)
    te[0 : 2 * non_null : 2] = (offs[:-1] + prefix).astype(np.int32)
    te[1 : 2 * non_null : 2] = offs[1:].astype(np.int32)
    prev_start = np.zeros(non_null, dtype=np.int64)
    prev_start[1:] = offs[:-2]
    ts[0 : 2 * non_null : 2] = prev_start.astype(np.int32)
    ts[1 : 2 * non_null : 2] = (-soffs[:-1] - 1).astype(np.int32)
    th = stager.add_many([te, ts], pad=False)
    lh = stager.add(suffixes)
    steps = max(int(np.ceil(np.log2(max(expanded, 2)))), 1)
    offs32 = None if flba_len is not None else _int32_offsets(offs)

    def op(s, parts):
        _add_def(s, parts, dl_ref, dwidth, n)
        out = expand_tokens(s[th[0]], s[th[1]], s[lh], out_cap, steps)
        if flba_len is not None:
            parts["val"].append((flba_bytes_to_lanes(out, non_null,
                                                     flba_len), non_null))
        else:
            parts["bytes"].append((offs32, out, nb))

    return op, nb, ("dba", expanded, compact)


def _host_levels_op(kind: str, handle: int, n: int):
    """Deferred levels decoded on the host (BIT_PACKED): the staged int32
    array is the page's level buffer."""
    def op(s, parts):
        parts[kind].append((s[handle], n))

    return op


def _defer_rep_levels(ops, stager: _Stager, scan, n: int,
                      max_rep: int, host=None) -> None:
    """Register a page's rep-level stream (its def stream rides the page's
    own op): its values are checked against ``max_rep`` on the host, its
    plan stages, and K1 or K2 expands it on the device, as the reference's
    ``_defer_levels(..., "rep", ...)``; host-decoded levels (``host``,
    BIT_PACKED) stage as they are."""
    if scan is None:
        ops.append(_host_levels_op("rep", stager.add(host), n))
        return
    width = max_rep.bit_length()
    count_eq_scan(scan, width, max_rep, validate_max=True)
    args, cnt, nbp, single = plan_stream_args(scan, n, width)
    hs = stager.add_many(args, pad=False)

    def op(s, parts):
        parts["rep"].append((expand_hybrid(s[hs[0]], s[hs[1]], cnt, width,
                                           nbp, single), n))

    ops.append(op)


def _add_def(s, parts, dl_ref, dwidth, n) -> None:
    """Expand a page's def stream on its own (K1 or K2), if it has one."""
    if dl_ref is not None:
        (dh, dt), d_cnt, d_nbp, d_sg = dl_ref
        parts["def"].append((expand_hybrid(s[dh], s[dt], d_cnt, dwidth,
                                           d_nbp, d_sg), n))


# ----------------------------------------------------------------------
# Row groups
# ----------------------------------------------------------------------

def _resolve_device(device) -> torch.device:
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device is available; pass device='cpu' to decode "
                "on the CPU")
        return torch.device("cuda", torch.cuda.current_device())
    dev = torch.device(device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(f"device {dev} requested but CUDA is not "
                               "available")
        if dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
    elif dev.type != "cpu":
        raise ValueError(f"unsupported device {dev}")
    return dev


def _plan_threads() -> int:
    """Plan workers of :func:`pipelined_reads`: the calling thread's
    tenant share under an active serve arbiter (``serve/arbiter.py``,
    read per call, so a rebalance takes effect at the next unit), else
    ``TPQ_PLAN_THREADS`` when set (at least 1; a malformed value is
    ignored), else one a usable CPU.  Outside an arbiter it also warns
    once when ``TPQ_PLAN_THREADS`` and ``TPQ_WRITE_THREADS`` together
    exceed the usable CPUs."""
    from ..serve import arbiter as _arbiter

    share = _arbiter.plan_budget()
    if share is not None:
        return share
    _arbiter.warn_if_oversubscribed()
    v = os.environ.get("TPQ_PLAN_THREADS")
    if v is not None:
        try:
            return max(int(v), 1)
        except ValueError:
            pass  # a malformed override falls back to the default
    return _usable_cpus()


def _usable_cpus() -> int:
    """CPUs this process may run on (its affinity mask, which
    ``os.cpu_count()`` ignores)."""
    try:
        return len(os.sched_getaffinity(0)) or 1
    except (AttributeError, OSError):
        return os.cpu_count() or 1


def _plan_one_column(reader, rg_index: int, path, node, cm,
                     arena: HostArena | None):
    """Plan one column chunk into a stager of its own: ``(path, finish,
    stager)``.  Its wall counts ``plan_s`` on the calling thread's
    collector.  Errors carry the column, file and row group; a corrupt
    chunk drops the file's plan-cache entries."""
    t0 = time.perf_counter()
    # the plan span is opened (not emitted whole), so the chunk read it
    # triggers nests under it
    tsp = _trace.open_span("plan", column=path) \
        if _trace._active is not None else None
    stager = _Stager()
    # the fingerprint only with the cache on: on a file it costs a read
    # of the footer, which reads without the cache must not pay
    fingerprint = (reader.plan_fingerprint if plan_cache() is not None
                   else None)
    cache_key = (None if fingerprint is None
                 else (fingerprint, rg_index, path))
    cache_state = []
    try:
        blob, start = reader.chunk_blob(cm, path)
        finish = plan_chunk_device(
            blob, cm, node, start, stager, arena,
            verify_crc=getattr(reader, "verify_crc", None),
            cache_key=cache_key, cache_state=cache_state)
    except ScanError as e:
        if isinstance(e, (CorruptPageError, CorruptChunkError)):
            # the bytes no longer match the footer: its plans are stale,
            # and a source's cached ranges may have served the bad bytes
            # (evicted, so a retry of the unit reads the store)
            invalidate_fingerprint(fingerprint)
            reader.drop_range_caches()
        _trace.close_span(tsp, status="error")
        raise e.annotate(column=path, file=reader.name, row_group=rg_index)
    except ValueError as e:
        # codec-layer domain errors become taxonomy errors with
        # coordinates
        invalidate_fingerprint(fingerprint)
        reader.drop_range_caches()
        _trace.close_span(tsp, status="error")
        raise CorruptChunkError(str(e), column=path, file=reader.name,
                                row_group=rg_index) from e
    except BaseException:
        _trace.close_span(tsp, status="error")
        raise
    cache = cache_state[0] if cache_state else "off"
    _trace.close_span(tsp, cache=cache)
    t1 = time.perf_counter()
    if _flightrec._active is not None:
        _flightrec.flight("span:plan", site="kernels.device", column=path,
                          s=round(t1 - t0, 6), cache=cache)
    st = current_stats()
    if st is not None:
        st.plan_s += t1 - t0
        if st.events is not None:
            st.events.span("plan", "decode", t0, t1,
                           tid=threading.get_ident(), column=path,
                           cache=cache)
    return path, finish, stager


def _plan_column_task(reader, rg_index: int, path, node, cm,
                      arena: HostArena, like, degraded: bool = False,
                      tctx=None, usp=None):
    """A pool worker's task: :func:`_plan_one_column` under a collector
    of its own (``worker_stats``), which the coordinator merges once the
    task has succeeded, and in the coordinator's degraded mode (the flag
    is thread-local).  ``tctx`` is the submitting unit's trace context,
    re-entered here so the column's spans parent under the unit on any
    pool thread; ``usp`` is the unit's open span, whose start the first
    task to run stamps (the unit measures work, not queueing).  Returns
    ``(entry, collector)``."""
    if usp is not None:
        usp.setdefault("t0_exec", time.perf_counter())
    mode = cpu_fallback_values() if degraded else contextlib.nullcontext()
    with _trace.adopt(tctx), mode, worker_stats(like=like) as ws:
        entry = _plan_one_column(reader, rg_index, path, node, cm, arena)
    return entry, ws


def _plan_row_group(reader, rg_index: int, arena: HostArena | None = None):
    """Plan every selected column of one row group on the calling thread,
    one stager a column: ``[(path, finish, stager)]``."""
    return [_plan_one_column(reader, rg_index, path, node, cm, arena)
            for path, node, cm in reader.selected_chunks(
                reader.meta.row_groups[rg_index])]


def _finish_row_group(planned, device: torch.device):
    """Stage one row group's plans in one copy, launch its page kernels,
    and fence once.  The unit's fault sites ``kernels.device.
    unit_dispatch`` and ``kernels.device.hang`` come first, except in a
    degraded plan, whose device work is the staging and the levels."""
    if not _host_values_only():
        fault_point("kernels.device.unit_dispatch")
        fault_point("kernels.device.hang")
    st = current_stats()
    t0 = time.perf_counter()
    # stage markers: transfer and dispatch emit their spans only after
    # measuring, so the sampler needs markers over the same windows
    ptok = _profiler.stage_begin("transfer") \
        if _profiler._active is not None else None
    try:
        staged_lists, slab = _put_all([stg for _, _, stg in planned],
                                      device)
    finally:
        if ptok is not None:
            _profiler.stage_end(ptok)
    t1 = time.perf_counter()
    ptok = _profiler.stage_begin("dispatch") \
        if _profiler._active is not None else None
    try:
        out = {path: finish(staged, device)
               for (path, finish, _), staged in zip(planned, staged_lists)}
        if device.type == "cuda":
            # the one fence of the row group: kernels done, and the
            # pinned slab the copy reads from (and the arenas the plans
            # borrowed) may be released; the dispatch span ends here
            torch.cuda.synchronize(device)
    finally:
        if ptok is not None:
            _profiler.stage_end(ptok)
    del slab
    t2 = time.perf_counter()
    if _flightrec._active is not None:
        _flightrec.flight("span:stage", site="kernels.device",
                          columns=len(out), transfer_s=round(t1 - t0, 6),
                          dispatch_s=round(t2 - t1, 6))
    if _trace._active is not None:
        _trace.emit_span("transfer", t0, t1 - t0, columns=len(out))
        _trace.emit_span("dispatch", t1, t2 - t1, columns=len(out))
    if st is not None:
        st.transfer_s += t1 - t0
        st.dispatch_s += t2 - t1
        if st.events is not None:
            tid = threading.get_ident()
            st.events.span("transfer", "decode", t0, t1, tid=tid,
                           columns=len(out))
            st.events.span("dispatch", "decode", t1, t2, tid=tid,
                           columns=len(out))
    return out


def _submit_columns(ex, reader, rg_index: int, n_workers: int, like,
                    degraded: bool, tctx=None, usp=None):
    """Submit one :func:`_plan_column_task` a selected column of one row
    group to the pool ``ex``: ``(futures, arenas)``, in column order.
    With one worker the tasks run one after another and share one arena;
    racing tasks lease one each.  ``tctx``/``usp``: the unit's trace
    context and open span (:func:`pipelined_reads`)."""
    cols = reader.selected_chunks(reader.meta.row_groups[rg_index])
    shared = lease_arena() if n_workers == 1 and cols else None
    futs, arenas = [], [] if shared is None else [shared]
    for path, node, cm in cols:
        a = shared
        if a is None:
            a = lease_arena()
            arenas.append(a)
        futs.append(ex.submit(_plan_column_task, reader, rg_index, path,
                              node, cm, a, like, degraded, tctx, usp))
    return futs, arenas


def _join_columns(futs, st):
    """Join one row group's plan tasks in column order: merge each
    succeeded task's collector into ``st`` (a failed task's is dropped)
    and raise the first error once all are joined.  Returns the plans."""
    planned = []
    err = None
    for f in futs:
        try:
            entry, ws = f.result()
        except BaseException as e:
            err = err if err is not None else e
            continue
        if st is not None:
            st.merge_from(ws)
        planned.append(entry)
    if err is not None:
        raise err
    return planned


def read_row_group_device(reader, rg_index: int, *, device=None,
                          filter=None,
                          verdict=None) -> dict[str, DeviceColumn]:
    """Decode the selected columns of one row group onto ``device``
    (default: the current CUDA device; raises when there is none — pass
    ``device="cpu"`` to run the kernels' plain versions on the CPU).

    As the reference: with one plan worker (``TPQ_PLAN_THREADS``) or one
    column, the columns plan on the calling thread with one arena and
    count into the caller's collector; otherwise they plan as the tasks
    of :func:`pipelined_reads` do, on a pool of their own
    (:func:`_submit_columns`, :func:`_join_columns`), in the caller's
    degraded mode.  ``filter`` (optionally with its precomputed
    ``verdict``, a ``filter.PruneVerdict``) takes the late-materialized
    read: only the surviving rows reach the device."""
    dev = _resolve_device(device)
    st = current_stats()
    if st is not None:
        st.row_groups += 1
    if filter is not None:
        try:
            chunks, _rows = read_row_group_filtered(reader, rg_index,
                                                    filter, verdict)
        except ScanError as e:
            raise e.annotate(row_group=rg_index)
        return _stage_chunks(reader, chunks, dev)
    rg = reader.meta.row_groups[rg_index]
    cols = reader.selected_chunks(rg)
    # a byte-range source fetches the row group's chunk ranges first,
    # coalesced and in parallel, so the column plans read the disk tier
    reader.prefetch_chunks(rg)
    n_workers = min(_plan_threads(), max(len(cols), 1))
    if n_workers <= 1:
        arenas = [lease_arena()]
        planned = _plan_row_group(reader, rg_index, arenas[0])
    else:
        with ThreadPoolExecutor(max_workers=n_workers) as ex:
            futs, arenas = _submit_columns(ex, reader, rg_index, n_workers,
                                           st, _host_values_only())
            planned = _join_columns(futs, st)
    out = _finish_row_group(planned, dev)
    # an error above drops the leases: a copy may still read their slabs
    for a in arenas:
        return_arena(a)
    return out


def stage_chunkdata(cd, node, device: torch.device) -> DeviceColumn:
    """One host-decoded :class:`~tpuparquet_torch.io.chunk.ChunkData` as a
    :class:`DeviceColumn` on ``device``: the filtered read's transfer,
    exact lengths (no bucket padding), in the fused path's layout: flat
    u32 lanes, or bytes with int32 offsets (a chunk of 2^31 bytes or
    more raises, as the fused path does), and where a slot is null the
    mask and positions (``cumsum(valid) - 1`` clamped at 0) that KS1 and
    KS3 read.  On the card the copies are non-blocking from pinned
    memory; the caller synchronizes.  Counts nothing in
    ``bytes_staged``, as the reference."""
    ptype = Type(node.element.type)
    dl = np.asarray(cd.def_levels, dtype=np.int32)
    max_def = node.max_def_level
    mask = positions = None
    if max_def:
        valid = dl == max_def
        if not valid.all():
            mask = _upload(valid, device)
            positions = _upload(np.maximum(
                np.cumsum(valid, dtype=np.int64) - 1, 0).astype(np.int32),
                device)
    vals = cd.values
    offsets = n_bytes = None
    if isinstance(vals, ByteArrayColumn):
        offs = np.asarray(vals.offsets)
        n_bytes = int(offs[-1]) if offs.size else 0
        offsets = _upload(_int32_offsets(offs), device)
        data = _upload(np.asarray(vals.data, dtype=np.uint8), device)
        n_packed = max(offs.size - 1, 0)
    else:
        arr = np.asarray(vals)
        n_packed = arr.shape[0]
        if ptype == Type.BOOLEAN:
            flat = arr.astype(np.uint32)
        elif ptype == Type.FIXED_LEN_BYTE_ARRAY:
            flat = _stage_byte_rows_np(arr)
        elif ptype == Type.INT96:
            flat = np.ascontiguousarray(arr, dtype="<u4").reshape(-1)
        else:
            flat = np.ascontiguousarray(arr).view("<u4").reshape(-1)
        data = _upload(flat, device)
    return DeviceColumn(
        ptype, data, mask, positions, _upload(dl, device) if max_def
        else None, dl.shape[0], n_packed, offsets=offsets, n_bytes=n_bytes,
        rep_levels=(_upload(np.asarray(cd.rep_levels, dtype=np.int32),
                            device) if node.max_rep_level else None),
        type_length=node.element.type_length, device=device)


def _stage_chunks(reader, chunks: dict, device: torch.device) -> dict:
    """Every filtered chunk of one unit on ``device``, then one fence;
    counts ``transfer_s``."""
    t0 = time.perf_counter()
    ptok = _profiler.stage_begin("transfer") \
        if _profiler._active is not None else None
    try:
        out = {path: stage_chunkdata(cd, reader.schema.leaf(path), device)
               for path, cd in chunks.items()}
        if device.type == "cuda":
            torch.cuda.synchronize(device)
    finally:
        if ptok is not None:
            _profiler.stage_end(ptok)
    st = current_stats()
    if st is not None:
        st.transfer_s += time.perf_counter() - t0
    return out


def read_row_group_device_resilient(reader, rg_index: int,
                                    retries: int | None = None,
                                    sleep=time.sleep,
                                    dispatch_deadline: float | None = None,
                                    *, device=None, filter=None,
                                    verdict=None):
    """:func:`read_row_group_device` with the device-failure ladder:
    retry the dispatch with bounded exponential backoff
    (``faults.backoff_delays``, the ``TPQ_IO_RETRIES`` knobs), then decode
    the unit's values on the host (:func:`cpu_fallback_values`) once.
    Corruption errors propagate unchanged: they are permanent and belong
    to the quarantine.

    Only a failed dispatch takes the ladder: a :class:`~tpuparquet_torch.
    errors.DeviceDispatchError` (an injected dispatch fault, or a
    ``DispatchDeadlineError``).  Every other error propagates at once, so
    no kernel's failure is hidden by the host decode: a kernel that does
    not build (``KernelBuildError``, built before the first attempt on a
    card) or does not launch (``KernelLaunchError``, the CUDA error that
    ``kernels/_lib.py`` ``launch`` raises), and any other RuntimeError
    (out of memory), which a quarantining scan may then absorb.
    ``dispatch_deadline`` (None: ``TPQ_DISPATCH_DEADLINE_S``, off) bounds
    each device attempt (``deadline.call_with_deadline``, as a
    ``DispatchDeadlineError``); the host attempt is never bounded.

    Counts ``dispatch_retries`` a retry and ``units_degraded`` when the
    host decode engages.  Each attempt runs under a collector of its own,
    merged whole only when it succeeds (a failed one adds only the fault
    layer's counts, ``stats.merge_worker_stats``), so a unit that retried
    counts its pages, values and bytes once; each leases its own
    arena.  ``filter``/``verdict`` pass to :func:`read_row_group_device`
    (the filtered read, whose host decode no dispatch fault reaches)."""
    from ..deadline import call_with_deadline, dispatch_deadline_default
    from ..errors import DispatchDeadlineError
    from ..stats import merge_worker_stats
    from ._lib import build_kernels

    dev = _resolve_device(device)
    if dev.type == "cuda":
        build_kernels()  # a failed build raises here, outside the ladder
    if dispatch_deadline is None:
        dispatch_deadline = dispatch_deadline_default()

    def work(degraded: bool):
        mode = (cpu_fallback_values() if degraded
                else contextlib.nullcontext())
        with mode:
            return read_row_group_device(reader, rg_index, device=dev,
                                         filter=filter, verdict=verdict)

    def attempt_bare(degraded: bool):
        st = current_stats()
        if st is None:
            return work(degraded)
        with worker_stats(like=st) as ws:
            try:
                out = work(degraded)
            except BaseException:
                merge_worker_stats(st, ws, failed=True)
                raise
        merge_worker_stats(st, ws, failed=False)
        return out

    def attempt_once(degraded: bool = False):
        # the deadline wrapper runs the attempt under a collector of its
        # own with the same merge; the host attempt is never bounded
        if degraded or not dispatch_deadline:
            return attempt_bare(degraded)
        return call_with_deadline(
            lambda: work(False), dispatch_deadline,
            site="kernels.device.unit_dispatch",
            error=DispatchDeadlineError, file=reader.name,
            row_group=rg_index)

    last = None
    delays = backoff_delays(retries)
    for attempt in range(len(delays) + 1):
        try:
            return attempt_once()
        except DeviceDispatchError as e:
            last = e
        if attempt < len(delays):
            if _flightrec._active is not None:
                _flightrec.flight("dispatch_retry",
                                  site="kernels.device.unit_dispatch",
                                  row_group=rg_index,
                                  error=type(last).__name__)
            if _trace._active is not None:
                _trace.emit_span("dispatch_retry", time.perf_counter(), 0.0,
                                 status="error", row_group=rg_index,
                                 error=type(last).__name__)
            st = current_stats()
            if st is not None:
                st.dispatch_retries += 1
            sleep(delays[attempt])
    # retries spent: the unit's values decode on the host (a cold site:
    # the bare calls)
    flight("degraded-to-host", site="kernels.device.unit_dispatch",
           row_group=rg_index, error=type(last).__name__, message=str(last))
    emit_span("degraded_to_host", time.perf_counter(), 0.0, status="error",
              row_group=rg_index, error=type(last).__name__)
    st = current_stats()
    if st is not None:
        st.units_degraded += 1
        if st.events is not None:
            st.events.fault(site="kernels.device.unit_dispatch",
                            kind="degraded-to-host", row_group=rg_index,
                            error=type(last).__name__, message=str(last))
    return attempt_once(degraded=True)


def pipelined_reads(readers, units, device_for=None, start: int = 0):
    """Yield ``(unit_index, {path: DeviceColumn})`` for ``units[start:]``
    (each a ``(reader_index, rg_index)`` pair), planning ahead on a pool
    of :func:`_plan_threads` workers while the calling thread stages,
    launches and fences unit k on ``device_for(k)`` (default: the current
    CUDA device).

    One task a column: a wide row group fans out over the workers, and
    idle workers take the next unit's columns.  The window holds at
    least ``n_workers + 1`` tasks and one whole unit ahead.  Each task
    plans into its own stager and leases its own arena (with one worker,
    a unit's columns share one), and counts into its own collector,
    which is merged here once the task has succeeded; a failed task's is
    dropped.  A unit's first error is raised after all of its tasks are
    joined.  Arenas go back to the pool only after their unit's fence;
    on an error or an early close they are dropped, the pool is shut
    down and joined, and the free arenas are trimmed to 2.  The results
    equal a serial :func:`read_row_group_device` loop at every thread
    count, buffer for buffer, and so do the counters (``plan_s`` then
    sums the workers' seconds)."""
    order = list(range(start, len(units)))
    if not order:
        return
    if device_for is None:
        dev = _resolve_device(None)
        device_for = lambda k: dev  # noqa: E731
    st = current_stats()
    n_workers = _plan_threads()
    degraded = _host_values_only()  # thread-local: the tasks re-enter it
    ex = ThreadPoolExecutor(max_workers=n_workers)
    inflight = {}    # unit k -> [future per column, in column order]
    arenas_of = {}   # unit k -> [leased arenas]
    unit_spans = {}  # unit k -> its open trace span (or None)
    state = {"next_j": 0, "tasks": 0}

    def submit_unit():
        k = order[state["next_j"]]
        state["next_j"] += 1
        ri, rgi = units[k]
        # the unit span does not become the ambient context (its open
        # and close straddle yields): the plan tasks and the finish step
        # re-enter it explicitly
        usp = None
        if _trace._active is not None:
            usp = _trace.open_span("unit", push=False, unit=k, file=ri,
                                   row_group=rgi)
        unit_spans[k] = usp
        futs, ars = _submit_columns(ex, readers[ri], rgi, n_workers, st,
                                    degraded, _trace.ctx_of(usp), usp)
        inflight[k] = futs
        arenas_of[k] = ars
        state["tasks"] += len(futs)

    def fill_window(min_units: int):
        while state["next_j"] < len(order) and (
                len(inflight) < min_units
                or state["tasks"] < n_workers + 1):
            submit_unit()

    try:
        fill_window(2)  # this unit and at least one planned ahead
        for k in order:
            futs = inflight.pop(k)
            state["tasks"] -= len(futs)
            usp = unit_spans.pop(k, None)
            try:
                planned = _join_columns(futs, st)
                if usp is not None and "t0_exec" in usp:
                    # the unit starts when its first plan task ran
                    usp["t0"] = usp["t0_exec"]
                with _trace.adopt(_trace.ctx_of(usp)):
                    out = _finish_row_group(planned, device_for(k))
            except BaseException as e:
                _trace.close_span(usp, status="error",
                                  error=type(e).__name__)
                raise
            _trace.close_span(usp)
            for a in arenas_of.pop(k):
                return_arena(a)
            fill_window(1)
            if st is not None:
                st.row_groups += 1
            yield k, out
    finally:
        # on an error or an early close the leases are dropped, never
        # recycled (a copy may still read their slabs); the workers are
        # joined, so no task outlives the reads
        ex.shutdown(wait=True)
        # units submitted and never taken close as cancelled, so their
        # plan spans keep a parent
        for usp in unit_spans.values():
            _trace.close_span(usp, status="cancelled")
        unit_spans.clear()
        trim_arena_pool(keep=2)


def filtered_pipelined_reads(readers, units, device_for=None,
                             start: int = 0, *, filter=None, verdicts=None):
    """The late-materialized sibling of :func:`pipelined_reads`: yield
    ``(unit_index, {path: DeviceColumn})`` for ``units[start:]``, each
    unit's filtered host decode (``filter.read_row_group_filtered``) one
    task on a pool of :func:`_plan_threads` workers while the calling
    thread copies the unit before to ``device_for(k)``
    (:func:`stage_chunkdata`).  ``verdicts`` maps ``(file, row group)``
    to a precomputed ``filter.PruneVerdict``.  Each task counts into a
    collector of its own (its wall as ``plan_s``), merged here when it
    succeeded; ``row_groups`` counts a unit.  The host decode is the
    same in the degraded mode (:func:`cpu_fallback_values`)."""
    order = list(range(start, len(units)))
    if not order:
        return
    if device_for is None:
        dev = _resolve_device(None)
        device_for = lambda k: dev  # noqa: E731
    st = current_stats()
    n_workers = _plan_threads()

    def task(ri, rgi, tctx=None, usp=None):
        t0 = time.perf_counter()
        if usp is not None:
            usp.setdefault("t0_exec", t0)
        with _trace.adopt(tctx), worker_stats(like=st) as ws:
            tsp = _trace.open_span("plan", filtered=True) \
                if _trace._active is not None else None
            v = None if verdicts is None else verdicts.get((ri, rgi))
            try:
                chunks, _rows = read_row_group_filtered(readers[ri], rgi,
                                                        filter, v)
            except BaseException:
                _trace.close_span(tsp, status="error")
                raise
            _trace.close_span(tsp)
            ws.plan_s += time.perf_counter() - t0
        return chunks, ws

    ex = ThreadPoolExecutor(max_workers=n_workers)
    inflight = {}
    unit_spans = {}
    todo = iter(order)

    def fill():
        # at most n_workers + 1 units decoding or decoded ahead
        while len(inflight) < n_workers + 1:
            k = next(todo, None)
            if k is None:
                return
            ri, rgi = units[k]
            usp = None
            if _trace._active is not None:
                usp = _trace.open_span("unit", push=False, unit=k, file=ri,
                                       row_group=rgi)
            unit_spans[k] = usp
            inflight[k] = ex.submit(task, ri, rgi, _trace.ctx_of(usp), usp)

    try:
        fill()
        for k in order:
            usp = unit_spans.pop(k, None)
            try:
                chunks, ws = inflight.pop(k).result()
            except BaseException as e:
                _trace.close_span(usp, status="error",
                                  error=type(e).__name__)
                raise
            if usp is not None and "t0_exec" in usp:
                usp["t0"] = usp["t0_exec"]
            if st is not None:
                st.merge_from(ws)
                st.row_groups += 1
            t0 = time.perf_counter()
            out = _stage_chunks(readers[units[k][0]], chunks,
                                device_for(k))
            if _trace._active is not None:
                _trace.emit_span("transfer", t0, time.perf_counter() - t0,
                                 parent=_trace.ctx_of(usp),
                                 columns=len(out))
            _trace.close_span(usp)
            fill()
            yield k, out
    finally:
        ex.shutdown(wait=True)
        for usp in unit_spans.values():
            _trace.close_span(usp, status="cancelled")
        unit_spans.clear()


def read_row_groups_device(reader, rg_indices=None, *, device=None,
                           out_sharding=None, gather_to=None, filter=None):
    """Iterate ``(rg_index, {path: DeviceColumn})`` over the row groups
    ``rg_indices`` (default: all), in that order, planning ahead on a
    pool of workers (:func:`pipelined_reads`).  The results equal
    :func:`read_row_group_device`'s for each index.  The device is
    resolved at the call, so a missing GPU raises here, not at the first
    row group.

    ``out_sharding`` (a ``NamedSharding`` over the consumer's mesh,
    ``shard/mesh.py``) or ``gather_to`` (a device, or an index into the
    local cards) place the decode itself: the row groups round-robin
    over the target's devices in its mesh's slot order
    (``placement_devices``), so each column is born where it is
    consumed; ``out_sharding="replicated"`` is the default placement.
    Explicit only: the ``TPQ_GATHER_TO`` default of the scans does not
    reach this call.

    ``filter`` (a ``filter.py`` expression) prunes first: a row group the
    static verdict proves empty is not read and not yielded (counted as
    ``row_groups_pruned``, its rows as ``rows_pruned``, every verdict's
    ``bloom_hits``); the others take the late-materialized read
    (:func:`filtered_pipelined_reads`).  Pruning runs when the first
    result is asked for."""
    devs = None
    if out_sharding is not None or gather_to is not None:
        from ..shard.mesh import placement_devices, resolve_out_sharding

        target = resolve_out_sharding(None, out_sharding, gather_to,
                                      env_default=False)
        if target is not None:
            if device is not None:
                raise ValueError("pass device= or a placement "
                                 "(out_sharding=, gather_to=), not both")
            devs = [_resolve_device(d) for d in placement_devices(target)]
    if devs is None:
        devs = [_resolve_device(device)]
    indices = list(range(reader.row_group_count()) if rg_indices is None
                   else rg_indices)

    def gen():
        kept, verdicts = indices, None
        if filter is not None:
            bind_filter(filter, reader.schema)
            kept, verdicts = [], {}
            st = current_stats()
            for i in indices:
                v = reader.prune_row_group(filter, i)
                if st is not None:
                    st.bloom_hits += v.bloom_hits
                if v.skip:
                    if st is not None:
                        st.row_groups_pruned += 1
                        st.rows_pruned += reader.meta.row_groups[i].num_rows
                    continue
                verdicts[(0, i)] = v
                kept.append(i)
            reads = filtered_pipelined_reads(
                [reader], [(0, i) for i in kept],
                lambda k: devs[k % len(devs)], filter=filter,
                verdicts=verdicts)
        else:
            reads = pipelined_reads([reader], [(0, i) for i in indices],
                                    lambda k: devs[k % len(devs)])
        try:
            for k, out in reads:
                yield kept[k], out
        finally:
            reads.close()  # an early close joins the pool at once

    return gen()
