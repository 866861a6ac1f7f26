"""Device value decode: PLAIN staging, dictionary pages (K3 fixed-width,
K9 BYTE_ARRAY), validity (K4), the PLAIN wire transports' rebuilds: byte
planes (K5) and delta lanes (K7, after K1 or K6), BYTE_ARRAY values
gathered out of a device-snappy page (K10), DELTA_BINARY_PACKED pages
(K1 or K6, K11 places scattered width classes, K7), BYTE_STREAM_SPLIT
pages (K12) and FIXED_LEN_BYTE_ARRAY rows rebuilt on the device (K13);
the sharded scan's densify of packed values to record slots (KS1).

Hosts stage padded, fixed-shape buffers (page words, run tables); the
device expands them.  Output sizes are padded to power-of-two buckets
(:func:`bucket`), and the padded tails hold exactly what the JAX
package's kernels put there: a dictionary page's tail holds the values
its padding indices gather (``dictionary[0]`` behind padding runs), a
def-level tail holds 0.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from ..cpu.delta import scan_delta_structure
from ..native import delta_native
from ._lib import check_tensor, count_launch, i64_to_lanes, \
    i64_to_u32_bits, lanes_to_i64, launch, stream_of, u32_to_i64
from .bitunpack import _check_words, pad_to_words, unpack_u32, \
    unpack_u32_plain, unpack_u64
from .hybrid import _check_table, expand_hybrid, expand_hybrid_plain

__all__ = [
    "bucket", "stage_u32", "plain_fixed_to_lanes",
    "page_dict_fixed", "page_dict_fixed_plain",
    "page_dict_fixed_levels_tbl", "page_plain_fixed_levels_tbl",
    "page_dict_bytes", "page_dict_bytes_plain",
    "blob_tile_bytes", "plain_bytes_from_blob",
    "plain_bytes_from_blob_plain",
    "levels_to_validity", "levels_to_validity_plain", "validity_tile_slots",
    "planes_to_words", "planes_to_words_plain", "planes_tile_values",
    "DeltaPlan", "delta_scan", "delta_scan_plain",
    "expand_delta_i32", "expand_delta_i64",
    "plan_delta_i32", "plan_delta_i64",
    "scatter_deltas", "scatter_deltas_plain",
    "bss_to_lanes", "bss_to_lanes_plain", "bss_lanes_tile_rows",
    "flba_bytes_to_lanes", "flba_bytes_to_lanes_plain",
    "u8_to_u32_words_at",
    "scatter_to_dense", "scatter_to_dense_plain",
]


def bucket(n: int) -> int:
    """Round up to a power-of-two bucket (min 32)."""
    b = 32
    while b < n:
        b <<= 1
    return b


def stage_u32(data, n_words: int) -> np.ndarray:
    """Host staging: raw little-endian bytes -> padded u32 word array."""
    buf = data if isinstance(data, np.ndarray) else np.frombuffer(
        data, dtype=np.uint8)
    need = n_words * 4
    if len(buf) < need:
        out = np.zeros(need, dtype=np.uint8)
        out[: len(buf)] = buf[:need]
        buf = out
    return buf[:need].view("<u4")


def plain_fixed_to_lanes(words: torch.Tensor, count: int,
                         lanes: int) -> torch.Tensor:
    """PLAIN fixed-width values staged as u32 words -> flat u32 lanes
    (lanes=1: int32, lanes=2: int64 as (lo, hi)).  A view: the bytes are
    already on the device."""
    return words[: count * lanes]


def page_dict_fixed_plain(dictionary, i_bp, i_tbl, icnt: int, iw: int,
                          inbp: int, lanes: int = 1,
                          isingle: bool = False) -> torch.Tensor:
    """Plain PyTorch version of K3."""
    dev = dictionary.device
    if iw == 0:
        idx = torch.zeros(icnt, dtype=torch.int64, device=dev)
    elif isingle:
        idx = u32_to_i64(unpack_u32_plain(i_bp, iw, icnt))
    else:
        idx = u32_to_i64(expand_hybrid_plain(i_bp, i_tbl, icnt, iw, inbp))
    n_dict = dictionary.numel() // lanes
    idx = torch.clamp(idx, max=n_dict - 1)
    if lanes == 1:
        return dictionary[idx]
    flat = (idx[:, None] * lanes
            + torch.arange(lanes, dtype=torch.int64, device=dev)).reshape(-1)
    return dictionary[flat]


def page_dict_fixed(dictionary: torch.Tensor, i_bp, i_tbl, icnt: int,
                    iw: int, inbp: int, lanes: int = 1,
                    isingle: bool = False) -> torch.Tensor:
    """Decode one dictionary-encoded page: expand the index stream
    (``icnt`` slots, width ``iw``; ``iw == 0`` means every index is 0 and
    ``i_bp``/``i_tbl`` may be None), clamp each index to ``n_dict - 1``
    (``n_dict = dictionary.numel() // lanes``), gather ``lanes`` u32 words
    per value from the flat dictionary; ``icnt == 0`` gives an empty
    tensor without reading the dictionary.  CUDA tensors launch K3, which
    unpacks a single bit-packed run itself; a run table is expanded by K2
    first and reaches K3 as a run of width 32.  CPU tensors take the plain
    version."""
    if icnt == 0:
        # a page of nulls only (an all-null column's empty dictionary):
        # no value to gather, as the reference's zero-length gather
        return torch.zeros(0, dtype=torch.int32, device=dictionary.device)
    # as the reference: n_dict is the staged length's whole values (a
    # padded 3-lane dictionary need not be a multiple of 3 words)
    n_dict = dictionary.numel() // lanes
    if n_dict == 0:
        raise ValueError("dictionary must hold n_dict >= 1 values of "
                         f"{lanes} lanes")
    if iw:
        if isingle:
            _check_words(i_bp, iw, icnt)
        else:
            _check_table(i_tbl)
    if dictionary.device.type == "cpu":
        return page_dict_fixed_plain(dictionary, i_bp, i_tbl, icnt, iw,
                                     inbp, lanes, isingle)
    if dictionary.device.type != "cuda":
        raise ValueError(f"unsupported device {dictionary.device}")
    dev = dictionary.device
    check_tensor(dictionary, "dictionary", torch.int32, dev)
    words_ptr = None
    if iw:
        check_tensor(i_bp, "i_bp", torch.int32, dev)
        if not isingle:
            i_bp, iw = expand_hybrid(i_bp, i_tbl, icnt, iw, inbp), 32
        words_ptr = i_bp.data_ptr()
    out = torch.empty(icnt * lanes, dtype=torch.int32, device=dev)
    launch("page_dict_fixed", dictionary.data_ptr(), n_dict, lanes,
           words_ptr, iw, out.data_ptr(), icnt, stream_of(out))
    count_launch(page_dict_fixed)
    return out


page_dict_fixed.launches = 0


def page_dict_fixed_levels_tbl(dictionary, d_bp, d_tbl, i_bp, i_tbl,
                               dcnt: int, dw: int, dnbp: int, icnt: int,
                               iw: int, inbp: int, lanes: int = 1,
                               dsingle: bool = False,
                               isingle: bool = False):
    """Dictionary page of an optional column: the def-level stream
    expands on its own (K1 or K2), the values as :func:`page_dict_fixed`.
    Returns ``(values, def_levels)``."""
    dl = expand_hybrid(d_bp, d_tbl, dcnt, dw, dnbp, dsingle)
    vals = page_dict_fixed(dictionary, i_bp, i_tbl, icnt, iw, inbp, lanes,
                           isingle)
    return vals, dl


def page_plain_fixed_levels_tbl(words, d_bp, d_tbl, count: int, lanes: int,
                                dcnt: int, dw: int, dnbp: int,
                                dsingle: bool = False):
    """PLAIN page of an optional column: ``(values view, def_levels)``."""
    dl = expand_hybrid(d_bp, d_tbl, dcnt, dw, dnbp, dsingle)
    return words[: count * lanes], dl


# ----------------------------------------------------------------------
# K9: dictionary page of BYTE_ARRAY values; K10: values out of a page blob
# ----------------------------------------------------------------------

def _upper_bound(sorted_i32, b):
    """For each ``b``: how many entries of the sorted int32 tensor are
    ``<= b`` (``searchsorted(side="right")``), as int64."""
    return torch.searchsorted(sorted_i32, b, right=True)


def page_dict_bytes_plain(dict_offsets, dict_data, i_bp, i_tbl, non_null: int,
                          icnt: int, iw: int, inbp: int, total_bytes: int,
                          isingle: bool = False) -> torch.Tensor:
    """Plain PyTorch version of K9, in the reference's int32 arithmetic."""
    dev = dict_offsets.device
    if iw == 0:
        idx = torch.zeros(icnt, dtype=torch.int32, device=dev)
    elif isingle:
        idx = unpack_u32_plain(i_bp, iw, icnt)
    else:
        idx = expand_hybrid_plain(i_bp, i_tbl, icnt, iw, inbp)
    # the u32 indices read as int32, as the reference's astype: a value
    # past 2^31 turns negative and clips to 0
    n_dict = dict_offsets.numel() - 1
    idx = torch.clamp(idx, 0, max(n_dict - 1, 0)).long()
    lens = dict_offsets[1:] - dict_offsets[:-1]
    valid = torch.arange(icnt, device=dev) < non_null
    contrib = torch.where(valid, lens[idx], torch.zeros_like(lens[idx]))
    out_offsets = torch.cat([torch.zeros(1, dtype=torch.int32, device=dev),
                             torch.cumsum(contrib, 0, dtype=torch.int32)])
    if dict_data.numel() == 0:
        return torch.zeros(total_bytes, dtype=torch.uint8, device=dev)
    b = torch.arange(total_bytes, dtype=torch.int32, device=dev)
    val = torch.clamp(_upper_bound(out_offsets[1:], b), max=icnt - 1)
    src = dict_offsets[idx[val]] + (b - out_offsets[val])
    src = torch.clamp(src, 0, dict_data.numel() - 1)
    return dict_data[src.long()]


def page_dict_bytes(dict_offsets: torch.Tensor, dict_data: torch.Tensor,
                    i_bp, i_tbl, non_null: int, icnt: int, iw: int,
                    inbp: int, total_bytes: int,
                    isingle: bool = False) -> torch.Tensor:
    """Decode one dictionary page of BYTE_ARRAY values into
    ``(total_bytes,)`` u8: expand the index stream (``icnt`` slots, width
    ``iw``; ``iw == 0`` means every index is 0), clamp each index to
    ``[0, n_dict - 1]`` (``n_dict = dict_offsets.numel() - 1``, the staged
    length), scan the lengths of the first ``non_null`` values into the
    output offsets, and gather every output byte from ``dict_data``.
    Bytes past the values' end hold what the reference's clamps give.
    ``dict_offsets`` is int32, ``dict_data`` uint8, both as staged.  CUDA
    tensors launch K9 (a run-table index stream is expanded by K2 first);
    CPU tensors take the plain version."""
    if dict_offsets.numel() < 2:
        raise ValueError("dictionary offsets must hold >= 2 entries")
    if not 0 <= non_null <= icnt or icnt < 1:
        raise ValueError(f"non_null {non_null} outside [0, icnt={icnt}]")
    if not 0 <= total_bytes < 1 << 31:
        raise ValueError(f"total_bytes {total_bytes} out of the int32 range")
    if not 0 <= iw <= 32:
        raise ValueError(f"index bit width {iw} out of range 0..32")
    if iw:
        if isingle:
            _check_words(i_bp, iw, icnt)
        else:
            _check_table(i_tbl)
    dev = dict_offsets.device
    if dev.type == "cpu":
        return page_dict_bytes_plain(dict_offsets, dict_data, i_bp, i_tbl,
                                     non_null, icnt, iw, inbp, total_bytes,
                                     isingle)
    if dev.type != "cuda":
        raise ValueError(f"unsupported device {dev}")
    check_tensor(dict_offsets, "dict_offsets", torch.int32, dev)
    check_tensor(dict_data, "dict_data", torch.uint8, dev)
    words_ptr = None
    if iw:
        check_tensor(i_bp, "i_bp", torch.int32, dev)
        if not isingle:
            i_bp, iw = expand_hybrid(i_bp, i_tbl, icnt, iw, inbp), 32
        words_ptr = i_bp.data_ptr()
    # one length sum per block of 4096 values (csrc/dict_bytes.cu)
    sums = torch.empty(-(-icnt // 4096), dtype=torch.int32, device=dev)
    out = torch.empty(total_bytes, dtype=torch.uint8, device=dev)
    launch("dict_bytes", dict_offsets.data_ptr(), dict_offsets.numel(),
           dict_data.data_ptr(), dict_data.numel(), words_ptr, iw, non_null,
           icnt, sums.data_ptr(), out.data_ptr(), total_bytes,
           stream_of(out))
    count_launch(page_dict_bytes)
    return out


page_dict_bytes.launches = 0


def blob_tile_bytes() -> int:
    """Output bytes of one tile of K10 (``csrc/bytes_from_blob.cu``),
    which takes them from its wrapper: 8 KiB, whose values' ends a block
    stages in shared memory up to ``blob_tile_bytes() // 4`` of them (a
    tile with more searches them in device memory) beside the blob span
    they select.  The checks pin the tiles' edges with it."""
    return 8192


def plain_bytes_from_blob_plain(blob, out_offsets, pos: int,
                                total_bytes: int) -> torch.Tensor:
    """Plain PyTorch version of K10, in the reference's int32
    arithmetic."""
    dev = blob.device
    if blob.numel() == 0:
        return torch.zeros(total_bytes, dtype=torch.uint8, device=dev)
    b = torch.arange(total_bytes, dtype=torch.int32, device=dev)
    val = torch.clamp(_upper_bound(out_offsets[1:], b),
                      max=out_offsets.numel() - 2)
    o = out_offsets[val]
    src = pos + o + 4 * (val.to(torch.int32) + 1) + (b - o)
    src = torch.clamp(src, 0, blob.numel() - 1)
    return blob[src.long()]


def plain_bytes_from_blob(blob: torch.Tensor, out_offsets: torch.Tensor,
                          pos: int, total_bytes: int) -> torch.Tensor:
    """PLAIN BYTE_ARRAY values gathered out of a device-resident page
    blob (K8's expansion of the page) into ``(total_bytes,)`` u8: value
    ``v`` starts at blob byte ``pos + out_offsets[v] + 4 * (v + 1)``, past
    the values block's offset and the ``v + 1`` length prefixes up to it.
    ``out_offsets`` (int32, ``>= 2`` entries) is padded with the values'
    byte count; bytes past the end hold what the reference's clamps give.
    CUDA tensors launch K10; CPU tensors take the plain version."""
    if out_offsets.numel() < 2:
        raise ValueError("out_offsets must hold >= 2 entries")
    if not 0 <= pos < 1 << 31 or not 0 <= total_bytes < 1 << 31:
        raise ValueError(f"pos {pos} or total_bytes {total_bytes} out of "
                         "the int32 range")
    dev = blob.device
    if dev.type == "cpu":
        return plain_bytes_from_blob_plain(blob, out_offsets, pos,
                                           total_bytes)
    if dev.type != "cuda":
        raise ValueError(f"unsupported device {dev}")
    check_tensor(blob, "blob", torch.uint8, dev)
    check_tensor(out_offsets, "out_offsets", torch.int32, dev)
    out = torch.empty(total_bytes, dtype=torch.uint8, device=dev)
    launch("bytes_from_blob", blob.data_ptr(), blob.numel(),
           out_offsets.data_ptr(), out_offsets.numel(), pos, out.data_ptr(),
           total_bytes, blob_tile_bytes(), stream_of(out))
    count_launch(plain_bytes_from_blob)
    return out


plain_bytes_from_blob.launches = 0


def levels_to_validity_plain(def_levels: torch.Tensor, max_def: int):
    """Plain PyTorch version of K4."""
    mask = def_levels == max_def
    positions = torch.cumsum(mask.to(torch.int32), 0, dtype=torch.int32) - 1
    return mask, torch.clamp(positions, min=0)


def validity_tile_slots() -> int:
    """Slots a block of K4 scans (the kernel's tile: 8 warps, each lane
    8 rows of 4 slots)."""
    return 8192


def levels_to_validity(def_levels: torch.Tensor, max_def: int):
    """Def levels -> ``(mask, positions)``: ``mask = def == max_def`` and
    ``positions[i]`` = the number of non-null slots before slot ``i``
    (the index of its value in the packed buffer; 0 at leading nulls).
    CUDA tensors launch K4; CPU tensors take the plain version."""
    dev = def_levels.device
    if dev.type == "cpu":
        return levels_to_validity_plain(def_levels, max_def)
    if dev.type != "cuda":
        raise ValueError(f"unsupported device {dev}")
    check_tensor(def_levels, "def_levels", torch.int32, dev)
    n = def_levels.numel()
    tile = validity_tile_slots()
    # one allocation: positions (16-byte aligned), mask, then the scan's
    # status word a tile at the next 8-byte boundary
    at = -(-5 * n // 8) * 8
    buf = torch.empty(at + 8 * -(-n // tile), dtype=torch.uint8, device=dev)
    positions = buf[: 4 * n].view(torch.int32)
    mask = buf[4 * n : 5 * n].view(torch.bool)
    launch("levels_to_validity", def_levels.data_ptr(), n, max_def, tile,
           buf.data_ptr() + at, mask.data_ptr(), positions.data_ptr(),
           stream_of(buf))
    count_launch(levels_to_validity)
    return mask, positions


levels_to_validity.launches = 0


# ----------------------------------------------------------------------
# Bytes on the device -> u32 words (the plain last pass of K8)
# ----------------------------------------------------------------------

def u8_to_u32_words_at(b: torch.Tensor, off: int,
                       n_words: int) -> torch.Tensor:
    """Little-endian u32 words (an int32 tensor) from ``n_words * 4``
    bytes of the u8 tensor ``b`` at byte offset ``off`` (any offset).
    Plain PyTorch, for CPU tensors: on the card the words come straight
    out of K8's last pass (:func:`~tpuparquet_torch.kernels.snappy.
    expand_tokens_words`), which reads them from the resolved copy
    graph without materialising the byte blob."""
    if b.device.type != "cpu":
        raise ValueError("u8_to_u32_words_at runs on CPU tensors; on the "
                         "card use snappy.expand_tokens_words (K8)")
    if off < 0 or off + 4 * n_words > b.numel():
        raise ValueError(f"{n_words} words at byte {off} overrun a "
                         f"{b.numel()}-byte buffer")
    w = b[off : off + 4 * n_words].to(torch.int64).reshape(-1, 4)
    return i64_to_u32_bits(w[:, 0] | (w[:, 1] << 8) | (w[:, 2] << 16)
                           | (w[:, 3] << 24))


# ----------------------------------------------------------------------
# K5: lane / byte-plane transport -> lane words
# ----------------------------------------------------------------------

_KIND = {"raw32": 0, "rle32": 1, "bytes": 2, "raw8": 3, "rle8": 4}


def _rle_expand(ends, vals, start: int, n_runs: int, count: int):
    """Run table slice -> per-position values: the run of position ``i``
    is the number of run ends ``<= i``, clamped to ``n_runs - 1``."""
    e = ends[start : start + n_runs]
    i = torch.arange(count, dtype=torch.int32, device=ends.device)
    idx = torch.clamp(torch.searchsorted(e, i, right=True), max=n_runs - 1)
    return vals[start + idx]


def planes_to_words_plain(raw32, rle32_ends, rle32_vals, raw8, rle8_ends,
                          rle8_vals, spec: tuple, count: int,
                          lanes: int) -> torch.Tensor:
    """Plain PyTorch version of K5."""
    words = []
    for entry in spec:
        if entry[0] == "raw32":
            j = entry[1]
            words.append(u32_to_i64(raw32[j * count : (j + 1) * count]))
        elif entry[0] == "rle32":
            words.append(u32_to_i64(_rle_expand(rle32_ends, rle32_vals,
                                                 entry[1], entry[2], count)))
        else:  # "bytes": four byte-plane sub-entries
            w = torch.zeros(count, dtype=torch.int64, device=raw32.device)
            for t, sub in enumerate(entry[1:]):
                if sub[0] == "raw8":
                    j = sub[1]
                    b = raw8[j * count : (j + 1) * count]
                else:
                    b = _rle_expand(rle8_ends, rle8_vals, sub[1], sub[2],
                                    count)
                w |= b.to(torch.int64) << (8 * t)
            words.append(w)
    return i64_to_u32_bits(torch.stack(words, dim=1).reshape(-1))


def planes_tile_values() -> int:
    """Values a block of K5 rebuilds, every lane (the kernel's tile: 256
    threads, each 2 rows of 4 values)."""
    return 2048


@functools.lru_cache(maxsize=1024)
def _spec_array(spec: tuple, lanes: int) -> bytes:
    """The static spec as K5's descriptor, built once per ``(spec,
    lanes)`` as the reference jits once per static spec: per lane
    ``kind, a, b`` then ``sub_kind[4], sub_a[4], sub_b[4]``, int32."""
    if len(spec) != lanes or not 1 <= lanes <= 4:
        raise ValueError(f"spec has {len(spec)} entries for {lanes} lanes")
    out = np.zeros((lanes, 15), dtype=np.int32)
    for lane, entry in enumerate(spec):
        out[lane, 0] = _KIND[entry[0]]
        if entry[0] == "bytes":
            for t, sub in enumerate(entry[1:]):
                out[lane, 3 + t] = _KIND[sub[0]]
                out[lane, 7 + t] = sub[1]
                out[lane, 11 + t] = sub[2] if sub[0] == "rle8" else 0
        else:
            out[lane, 1] = entry[1]
            out[lane, 2] = entry[2] if entry[0] == "rle32" else 0
    return out.tobytes()


def planes_to_words(raw32: torch.Tensor, rle32_ends: torch.Tensor,
                    rle32_vals: torch.Tensor, raw8: torch.Tensor,
                    rle8_ends: torch.Tensor, rle8_vals: torch.Tensor,
                    spec: tuple, count: int, lanes: int) -> torch.Tensor:
    """Lane / byte-plane wire transport -> flat ``(count * lanes,)`` u32
    lane words (an int32 tensor).

    ``spec`` has one entry per lane: ``("raw32", slab)`` (lane ``slab``
    of ``raw32``), ``("rle32", start, n_runs)`` (a slice of the u32 run
    table), or ``("bytes", e0, e1, e2, e3)`` with byte-plane entries
    ``("raw8", slab)`` / ``("rle8", start, n_runs)``.  Run ends are
    int32; ``raw8`` and ``rle8_vals`` are uint8, the rest int32 holding
    u32 bits.  CUDA tensors launch K5; CPU tensors take the plain
    version."""
    dev = raw32.device
    if dev.type == "cpu":
        return planes_to_words_plain(raw32, rle32_ends, rle32_vals, raw8,
                                     rle8_ends, rle8_vals, spec, count,
                                     lanes)
    if dev.type != "cuda":
        raise ValueError(f"unsupported device {dev}")
    desc = _spec_array(spec, lanes)
    for name, t, dtype in (("raw32", raw32, torch.int32),
                           ("rle32_ends", rle32_ends, torch.int32),
                           ("rle32_vals", rle32_vals, torch.int32),
                           ("raw8", raw8, torch.uint8),
                           ("rle8_ends", rle8_ends, torch.int32),
                           ("rle8_vals", rle8_vals, torch.uint8)):
        check_tensor(t, name, dtype, dev)
    for entry in spec:  # every slab and table slice must lie in its buffer
        subs = entry[1:] if entry[0] == "bytes" else (entry,)
        for sub in subs:
            kind = sub[0]
            if kind in ("raw32", "raw8"):
                buf = raw32 if kind == "raw32" else raw8
                end = (sub[1] + 1) * count
            else:
                buf = rle32_ends if kind == "rle32" else rle8_ends
                end = sub[1] + sub[2]
                if sub[2] < 1 or (rle32_vals if kind == "rle32"
                                  else rle8_vals).numel() < end:
                    raise ValueError(f"{kind} table slice {sub[1:]} out "
                                     "of range")
            if sub[1] < 0 or buf.numel() < end:
                raise ValueError(f"{kind} entry {sub[1:]} overruns its "
                                 f"{buf.numel()}-element buffer")
    out = torch.empty(count * lanes, dtype=torch.int32, device=dev)
    launch("planes_to_words", raw32.data_ptr(), rle32_ends.data_ptr(),
           rle32_vals.data_ptr(), raw8.data_ptr(), rle8_ends.data_ptr(),
           rle8_vals.data_ptr(), desc, count, lanes, planes_tile_values(),
           out.data_ptr(), stream_of(out))
    count_launch(planes_to_words)
    return out


planes_to_words.launches = 0


# ----------------------------------------------------------------------
# Delta lanes: DeltaPlan -> values (K1/K6 unpack, K7 scan)
# ----------------------------------------------------------------------

class DeltaPlan:
    """A delta stream to rebuild on the device.

    ``groups``: 7-tuples ``(width, words, starts, takes, n_vals, start,
    n_take)`` — one width class's packed words (``n_vals`` values, flat
    u32 in an int32 tensor); ``starts``/``takes`` None for a contiguous
    group, whose first ``n_take`` deltas land at ``[start, start +
    n_take)``.  ``md_lo`` / ``md_hi``: per-block min_delta as u32 lanes
    (int32 tensors on the plan's device), repeated by ``block_size``.
    ``first``: the first value; ``total``: the value count."""

    __slots__ = ("groups", "md_lo", "md_hi", "block_size", "first",
                 "total")

    def __init__(self, groups, md_lo, md_hi, block_size, first, total):
        self.groups = groups
        self.md_lo = md_lo
        self.md_hi = md_hi
        self.block_size = block_size
        self.first = first
        self.total = total


def _repeat_md(md, block_size: int, n_deltas: int) -> torch.Tensor:
    """Per-delta min_delta (as int64 u32) from the per-block table."""
    idx = torch.arange(n_deltas, dtype=torch.int64,
                       device=md.device) // block_size
    return md.to(torch.int64)[idx]


def delta_scan_plain(dlo, dhi, md_lo, md_hi, block_size: int, first: int,
                     total: int) -> torch.Tensor:
    """Plain PyTorch version of K7."""
    dev = dlo.device
    n = total - 1
    if dhi is None:
        x = (u32_to_i64(dlo[:n]) + u32_to_i64(md_lo)[
            torch.arange(n, device=dev) // block_size]) & 0xFFFFFFFF
        s = torch.cat([torch.tensor([first & 0xFFFFFFFF], device=dev),
                       (first & 0xFFFFFFFF) + torch.cumsum(x, 0)])
        return i64_to_u32_bits(s & 0xFFFFFFFF)
    f = first & 0xFFFFFFFFFFFFFFFF
    f = f - (1 << 64) if f >= 1 << 63 else f
    md = lanes_to_i64(md_lo, md_hi)[torch.arange(n, device=dev)
                                    // block_size]
    x = lanes_to_i64(dlo[:n], dhi[:n]) + md  # wraps mod 2^64
    s = torch.cumsum(torch.cat([torch.tensor([f], device=dev), x]), 0)
    lo, hi = i64_to_lanes(s)
    return torch.stack([lo, hi], dim=1).reshape(-1)


_K7_TILE = 4096  # positions a CTA of csrc/delta_scan.cu scans


def delta_scan(dlo: torch.Tensor, dhi, md_lo: torch.Tensor, md_hi,
               block_size: int, first: int, total: int) -> torch.Tensor:
    """The delta rebuild's scan: ``out[0] = first`` and ``out[k+1] =
    out[k] + d[k] + md[k // block_size]`` for ``k < total - 1``, mod 2^32
    (``dhi``/``md_hi`` None: ``(total,)`` u32) or mod 2^64 (``(2 *
    total,)`` interleaved (lo, hi) u32).  Inputs are int32 tensors of u32
    bits.  CUDA tensors launch K7; CPU tensors take the plain version."""
    wide = dhi is not None
    if wide != (md_hi is not None):
        raise ValueError("dhi and md_hi go together")
    if total <= 0:
        return torch.zeros(0, dtype=torch.int32, device=dlo.device)
    n = total - 1
    if block_size < 1 or md_lo.numel() * block_size < n \
            or dlo.numel() < n or (wide and (dhi.numel() < n
                                             or md_hi.numel()
                                             < md_lo.numel())):
        raise ValueError(f"delta stream of {n} values does not fit its "
                         "buffers")
    dev = dlo.device
    if dev.type == "cpu":
        return delta_scan_plain(dlo, dhi, md_lo, md_hi, block_size, first,
                                total)
    if dev.type != "cuda":
        raise ValueError(f"unsupported device {dev}")
    for name, t in (("dlo", dlo), ("md_lo", md_lo)) + (
            (("dhi", dhi), ("md_hi", md_hi)) if wide else ()):
        check_tensor(t, name, torch.int32, dev)
    # one allocation: the output, then from the next 16-byte boundary the
    # look-back scratch (the tile counter, a flag a 4,096-value tile, each
    # tile's u64 sum and inclusive prefix)
    words = total * (2 if wide else 1)
    at = (words + 3) // 4 * 4
    tiles = (total + _K7_TILE - 1) // _K7_TILE
    buf = torch.empty(at + 4 + (tiles + 3) // 4 * 4 + 4 * tiles,
                      dtype=torch.int32, device=dev)
    launch("delta_scan", dlo.data_ptr(), dhi.data_ptr() if wide else None,
           md_lo.data_ptr(), md_hi.data_ptr() if wide else None, int(wide),
           block_size, n, first & 0xFFFFFFFFFFFFFFFF, buf.data_ptr() + 4 * at,
           buf.data_ptr(), stream_of(buf))
    count_launch(delta_scan)
    return buf[:words]


delta_scan.launches = 0


# ----------------------------------------------------------------------
# DELTA_BINARY_PACKED pages: host plan, K11 placement
# ----------------------------------------------------------------------

def _plan_delta(data, pos: int, max_width: int) -> DeltaPlan:
    """Parse a DELTA_BINARY_PACKED stream's headers and group its
    miniblock payloads by bit width, so the device unpacks each width
    class in one call — the JAX package's ``_plan_delta``, rule for rule.
    ``max_width`` is the column's physical width (a wider miniblock is
    malformed).  A width class whose miniblocks land back to back is
    contiguous (``starts``/``takes`` None; its deltas fill ``[start,
    start + n_take)``); otherwise it ships per-miniblock int32 starts and
    take counts, from which K11 places it."""
    st = scan_delta_structure(data, pos, max_width=max_width)
    mb_size = st.mb_size
    buf = (data if isinstance(data, np.ndarray)
           else np.frombuffer(data, dtype=np.uint8))
    md_u = np.asarray(st.md_blocks, dtype=np.int64).view(np.uint64)
    md_lo = (md_u & np.uint64(0xFFFFFFFF)).astype(np.uint32)
    md_hi = (md_u >> np.uint64(32)).astype(np.uint32)
    groups = []
    for w, src_contig, p_w, s_w, t_w, dst_contig in st.grouped():
        nbytes = mb_size * w // 8
        k = len(p_w)
        if src_contig:
            packed = buf[p_w[0] : p_w[0] + nbytes * k]
        else:
            packed = delta_native().gather_segments(buf, p_w, nbytes)
        n_vals = mb_size * k
        words = pad_to_words(packed, w, n_vals).reshape(-1)
        if dst_contig:  # only the globally-last miniblock can be partial
            groups.append((w, words, None, None, n_vals, int(s_w[0]),
                           int(t_w.sum())))
        else:
            groups.append((w, words, s_w.astype(np.int32),
                           t_w.astype(np.int32), n_vals, 0, 0))
    return DeltaPlan(groups, md_lo, md_hi, st.block_size, st.first, st.total)


def plan_delta_i32(data, pos: int = 0) -> DeltaPlan:
    """Plan of an int32 DELTA_BINARY_PACKED stream (widths 0..32)."""
    return _plan_delta(data, pos, 32)


def plan_delta_i64(data, pos: int = 0) -> DeltaPlan:
    """Plan of an int64 DELTA_BINARY_PACKED stream (widths 0..64)."""
    return _plan_delta(data, pos, 64)


def scatter_deltas_plain(lo, hi, starts, takes, n_vals: int, dlo, dhi,
                         out_len: int) -> None:
    """Plain PyTorch version of K11 (in place)."""
    k = starts.numel()
    mb = n_vals // max(k, 1)
    lane = torch.arange(mb, dtype=torch.int64, device=lo.device)[None, :]
    pos = starts.to(torch.int64)[:, None] + lane
    keep = ((lane < takes.to(torch.int64)[:, None]) & (pos >= 0)
            & (pos < out_len)).reshape(-1)
    pos = pos.reshape(-1)[keep]
    dlo.index_put_((pos,), lo[: k * mb][keep])
    if dhi is not None:
        dhi.index_put_((pos,), hi[: k * mb][keep])


def scatter_deltas(lo: torch.Tensor, hi, starts: torch.Tensor,
                   takes: torch.Tensor, n_vals: int, dlo: torch.Tensor, dhi,
                   out_len: int) -> None:
    """Place one scattered width class of a delta stream, in place: its
    ``k`` miniblocks of ``mb = n_vals // k`` unpacked lanes (``lo``, and
    ``hi`` for int64, u32 bits in int32 tensors), lane ``j`` of miniblock
    ``m`` at ``starts[m] + j`` of ``dlo`` (and ``dhi``) for ``j <
    takes[m]``; a target outside ``[0, out_len)`` is dropped, as the
    reference's ``.at[].set(mode="drop")`` drops it (``_scatter_grid``).
    CUDA tensors launch K11; CPU tensors take the plain version."""
    wide = hi is not None
    if wide != (dhi is not None):
        raise ValueError("hi and dhi go together")
    k = starts.numel()
    mb = n_vals // max(k, 1)
    if takes.numel() != k or lo.numel() < k * mb \
            or (wide and hi.numel() < k * mb) \
            or not 0 <= out_len <= dlo.numel() \
            or (wide and dhi.numel() < out_len):
        raise ValueError(f"{k} miniblocks of {mb} lanes do not fit their "
                         "buffers")
    dev = lo.device
    if dev.type == "cpu":
        scatter_deltas_plain(lo, hi, starts, takes, n_vals, dlo, dhi, out_len)
        return
    if dev.type != "cuda":
        raise ValueError(f"unsupported device {dev}")
    for name, t in (("lo", lo), ("starts", starts), ("takes", takes),
                    ("dlo", dlo)) + ((("hi", hi), ("dhi", dhi)) if wide
                                     else ()):
        check_tensor(t, name, torch.int32, dev)
    launch("delta_scatter", lo.data_ptr(), hi.data_ptr() if wide else None,
           starts.data_ptr(), takes.data_ptr(), k, mb, dlo.data_ptr(),
           dhi.data_ptr() if wide else None, out_len, stream_of(dlo))
    count_launch(scatter_deltas)


scatter_deltas.launches = 0


def _placed_deltas(plan: DeltaPlan, n_deltas: int, wide: bool):
    """Unpack each width class (K1, or K6 above width 32 and for int64)
    into the zero-initialised delta stream: a contiguous class into its
    slice, a scattered one by K11.  The int32 stream holds ``max(n_deltas,
    1)`` deltas, as the reference's, and K11 drops past that length; the
    int64 stream holds ``n_deltas``."""
    dev = plan.md_lo.device
    out_len = n_deltas if wide else max(n_deltas, 1)
    dlo = torch.zeros(out_len, dtype=torch.int32, device=dev)
    dhi = torch.zeros(out_len, dtype=torch.int32, device=dev) \
        if wide else None
    for w, words, starts, takes, n_vals, start, n_take in plan.groups:
        if wide:
            lo, hi = unpack_u64(words, w, n_vals)
        else:
            lo, hi = unpack_u32(words, w, n_vals), None
        if starts is not None:
            scatter_deltas(lo, hi, starts, takes, n_vals, dlo, dhi, out_len)
            continue
        if wide:
            dhi[start : start + n_take] = hi[:n_take]
        dlo[start : start + n_take] = lo[:n_take]
    return dlo, dhi


def expand_delta_i32(plan: DeltaPlan) -> torch.Tensor:
    """Rebuild ``plan.total`` int32 values as ``(total,)`` u32 (an int32
    tensor): unpack each width class (K1), place it (K11 when scattered),
    add min_delta and scan mod 2^32 (K7).  ``md_hi`` is not read."""
    if plan.total == 0:
        return torch.zeros(0, dtype=torch.int32, device=plan.md_lo.device)
    dlo, _ = _placed_deltas(plan, plan.total - 1, False)
    return delta_scan(dlo, None, plan.md_lo, None, plan.block_size,
                      plan.first, plan.total)


def expand_delta_i64(plan: DeltaPlan) -> torch.Tensor:
    """Rebuild ``plan.total`` int64 values as flat ``(2 * total,)``
    interleaved (lo, hi) u32 — the DeviceColumn INT64 layout: unpack each
    width class (K1 or K6), place it (K11 when scattered), add min_delta
    and scan mod 2^64 (K7)."""
    if plan.total == 0:
        return torch.zeros(0, dtype=torch.int32, device=plan.md_lo.device)
    dlo, dhi = _placed_deltas(plan, plan.total - 1, True)
    return delta_scan(dlo, dhi, plan.md_lo, plan.md_hi, plan.block_size,
                      plan.first, plan.total)


# ----------------------------------------------------------------------
# K12: BYTE_STREAM_SPLIT pages
# ----------------------------------------------------------------------

def bss_lanes_tile_rows(lanes: int) -> int:
    """Rows of one tile of K12 (``csrc/bss_to_lanes.cu``), which takes
    them from its wrapper: the largest multiple of 16 whose 16-byte
    vectors, ``T / 16 + 1`` for each of ``4 * lanes`` streams, take one
    round of the kernel's 4 loads a thread in blocks of 256 threads, at
    least 16: 4,080 rows of floats, 2,032 of doubles.  The checks pin the
    tiles' edges with it."""
    return 16 * max(256 // lanes - 1, 1)


def bss_to_lanes_plain(raw, count: int, k: int, lanes: int) -> torch.Tensor:
    """Plain PyTorch version of K12: the reference's transpose."""
    rows = raw[: k * count].reshape(k, count).t().to(torch.int64)
    return _words_of_bytes(rows, lanes)


def bss_to_lanes(raw: torch.Tensor, count: int, k: int,
                 lanes: int) -> torch.Tensor:
    """BYTE_STREAM_SPLIT decode: ``k`` byte streams of ``count`` bytes
    (the first ``k * count`` bytes of the u8 tensor ``raw``) -> flat
    ``(count * lanes,)`` little-endian u32 lane words (an int32 tensor);
    word ``i * lanes + l`` holds bytes ``raw[(4l + b) * count + i]`` for
    ``b < 4``, zero where ``4l + b >= k``.  CUDA tensors launch K12; CPU
    tensors take the plain version."""
    if not 0 < k <= 4 * lanes or count < 0 or raw.numel() < k * count:
        raise ValueError(f"{k} streams of {count} bytes do not fit "
                         f"{raw.numel()} bytes and {lanes} lanes")
    dev = raw.device
    if dev.type == "cpu":
        return bss_to_lanes_plain(raw, count, k, lanes)
    if dev.type != "cuda":
        raise ValueError(f"unsupported device {dev}")
    check_tensor(raw, "raw", torch.uint8, dev)
    out = torch.empty(count * lanes, dtype=torch.int32, device=dev)
    if count:
        launch("bss_to_lanes", raw.data_ptr(), count, k, lanes,
               bss_lanes_tile_rows(lanes), out.data_ptr(), stream_of(out))
        count_launch(bss_to_lanes)
    return out


bss_to_lanes.launches = 0


# ----------------------------------------------------------------------
# K13: FIXED_LEN_BYTE_ARRAY rows on the device -> lane words
# ----------------------------------------------------------------------

def _words_of_bytes(rows: torch.Tensor, lanes: int) -> torch.Tensor:
    """``(count, k)`` bytes (k <= 4 * lanes, as int64), zero-padded to
    whole lanes, as flat little-endian u32 words (an int32 tensor)."""
    count, k = rows.shape
    if k != 4 * lanes:
        rows = torch.nn.functional.pad(rows, (0, 4 * lanes - k))
    b = rows.reshape(count, lanes, 4)
    return i64_to_u32_bits((b[..., 0] | (b[..., 1] << 8) | (b[..., 2] << 16)
                            | (b[..., 3] << 24)).reshape(-1))


def flba_tile_rows(type_length: int) -> int:
    """Rows of one tile of K13 (``csrc/flba_to_lanes.cu``), which takes
    them from its wrapper: the largest multiple of 16 whose rows fit 16
    KiB, or 0 (one thread a word) past 1,024 bytes a row.  Rows of a
    multiple of 4 bytes are copied, not tiled.  The checks pin the tiles'
    edges with it."""
    return (16384 // type_length) & ~15


def flba_bytes_to_lanes_plain(raw, count: int,
                              type_length: int) -> torch.Tensor:
    """Plain PyTorch version of K13: the reference's reshape, pad and
    combine."""
    rows = raw[: count * type_length].reshape(count, type_length)
    return _words_of_bytes(rows.to(torch.int64), (type_length + 3) // 4)


def flba_bytes_to_lanes(raw: torch.Tensor, count: int,
                        type_length: int) -> torch.Tensor:
    """``count`` FIXED_LEN_BYTE_ARRAY rows of ``type_length`` bytes, back
    to back at the start of the u8 tensor ``raw`` -> flat ``(count *
    lanes,)`` little-endian u32 words (an int32 tensor), ``lanes =
    ceil(type_length / 4)``: word ``i * lanes + j`` holds bytes ``raw[i *
    type_length + 4j + b]``, zero past the row.  CUDA tensors launch K13;
    CPU tensors take the plain version."""
    if type_length < 1 or count < 0 or raw.numel() < count * type_length:
        raise ValueError(f"{count} rows of {type_length} bytes do not fit "
                         f"{raw.numel()} bytes")
    dev = raw.device
    if dev.type == "cpu":
        return flba_bytes_to_lanes_plain(raw, count, type_length)
    if dev.type != "cuda":
        raise ValueError(f"unsupported device {dev}")
    check_tensor(raw, "raw", torch.uint8, dev)
    lanes = (type_length + 3) // 4
    out = torch.empty(count * lanes, dtype=torch.int32, device=dev)
    launch("flba_to_lanes", raw.data_ptr(), count, type_length, lanes,
           flba_tile_rows(type_length), out.data_ptr(), stream_of(out))
    count_launch(flba_bytes_to_lanes)
    return out


flba_bytes_to_lanes.launches = 0


# ----------------------------------------------------------------------
# KS1: packed values -> one value per record slot (the gather's densify)
# ----------------------------------------------------------------------

def _slot_count(packed, mask, positions, lanes: int) -> int:
    if mask is not None:
        return mask.numel()
    if positions is not None:
        return positions.numel()
    return packed.numel() // lanes


def scatter_to_dense_plain(packed, mask, positions,
                           lanes: int = 1) -> torch.Tensor:
    """Plain PyTorch version of KS1 over flat ``(n_packed * lanes,)``
    values (``mask``/``positions`` None: every slot valid, the
    identity)."""
    dev = packed.device
    n = _slot_count(packed, mask, positions, lanes)
    n_packed = packed.numel() // lanes
    if n_packed == 0:
        return torch.zeros(n * lanes, dtype=packed.dtype, device=dev)
    pos = (torch.arange(n, device=dev) if positions is None
           else positions.to(torch.int64)).clamp(0, n_packed - 1)
    idx = (pos[:, None] * lanes
           + torch.arange(lanes, dtype=torch.int64, device=dev)).reshape(-1)
    vals = packed[idx]
    if mask is None:
        return vals
    return torch.where(mask.repeat_interleave(lanes), vals,
                       torch.zeros((), dtype=packed.dtype, device=dev))


def scatter_to_dense(packed: torch.Tensor, mask, positions, lanes: int = 1,
                     out: torch.Tensor | None = None) -> torch.Tensor:
    """Inflate packed non-null values to one value per record slot, null
    slots 0: ``out[i * lanes + l] = mask[i] ? packed[positions[i] * lanes
    + l] : 0`` over ``n = len(mask)`` slots.  ``packed`` is flat with
    ``lanes`` u32 words a value (the DeviceColumn layout); a 2-D ``(n,
    lanes)`` input gives a 2-D output, as in the reference.  ``mask`` and
    ``positions`` may be None for a column without nulls.  An empty
    ``packed`` gives zeros without a gather.  ``out`` (flat, at least ``n *
    lanes`` words; on the card the unit's row of the gathered block) is
    filled whole, its tail with zeros.  CUDA tensors launch KS1; CPU
    tensors take the plain version."""
    if packed.dim() > 1:
        if out is not None:
            raise ValueError("out= takes a flat packed buffer")
        lanes = packed.shape[1]
        return scatter_to_dense(packed.reshape(-1), mask, positions,
                                lanes).reshape(-1, lanes)
    n = _slot_count(packed, mask, positions, lanes)
    dev = packed.device
    if out is not None and (out.device != dev or out.dtype != packed.dtype
                            or out.dim() != 1 or not out.is_contiguous()
                            or out.numel() < n * lanes):
        raise ValueError(f"out must be a contiguous 1-D {packed.dtype} "
                         f"tensor of at least {n * lanes} words on {dev}")
    if dev.type == "cpu":
        res = scatter_to_dense_plain(packed, mask, positions, lanes)
        if out is None:
            return res
        out[: res.numel()] = res
        out[res.numel():] = 0
        return out
    if dev.type != "cuda":
        raise ValueError(f"unsupported device {dev}")
    check_tensor(packed, "packed", torch.int32, dev)
    if mask is not None:
        check_tensor(mask, "mask", torch.bool, dev)
    if positions is not None:
        check_tensor(positions, "positions", torch.int32, dev)
        if positions.numel() != n:
            raise ValueError("mask and positions differ in length")
    if out is None:
        out = torch.empty(n * lanes, dtype=torch.int32, device=dev)
    launch("scatter_dense", packed.data_ptr(), packed.numel() // lanes,
           None if mask is None else mask.data_ptr(),
           None if positions is None else positions.data_ptr(), n, lanes,
           out.data_ptr(), out.numel(), stream_of(out))
    count_launch(scatter_to_dense)
    return out


scatter_to_dense.launches = 0
