"""Hybrid RLE/bit-packed streams on the device: host run-table plan + K2.

The sequential run structure of a hybrid stream is resolved on the host
over the run *headers* only (``cpu/hybrid.py scan_hybrid``); the values
themselves are never expanded on the host.  The plan ships as

* ``bp_words``: all bit-packed segments concatenated, as u32 words;
* a packed ``(4, R)`` u32 run table: ``run_ends`` (cumulative output
  count per run), ``is_rle``, ``value`` (RLE fill), ``bp_start`` (a
  bit-packed run's lane offset into ``bp_words``),

padded to power-of-two buckets exactly as the JAX package pads them
(``tpuparquet/kernels/hybrid.py pack_plan``), and K2
(``csrc/expand_hybrid.cu``) expands it: a block searches the run ends
once for its tile of :func:`hybrid_tile_slots` slots, then each slot
takes its run's RLE fill or its packed lane.
"""

from __future__ import annotations

import numpy as np
import torch

from ..cpu.bitpack import pack
from ..cpu.hybrid import expand_scan, scan_hybrid
from ..native import hybrid_native, pack_native
from ._lib import check_tensor, count_launch, i64_to_u32_bits, launch, \
    stream_of, u32_to_i64
from .bitunpack import _check_words, pad_to_words, unpack_u32, \
    unpack_u32_plain

__all__ = [
    "HybridPlan", "plan_hybrid", "plan_from_scan", "pack_plan",
    "plan_stream_args",
    "single_bp_scan", "count_eq_scan", "max_scan_value",
    "expand_hybrid", "expand_hybrid_plain", "hybrid_tile_slots",
]


class HybridPlan:
    """Host-built run table of one stream."""

    __slots__ = ("bp_words", "run_ends", "run_is_rle", "run_value",
                 "run_bp_start", "count", "width", "n_bp_values")

    def __init__(self, bp_words, run_ends, run_is_rle, run_value,
                 run_bp_start, count, width, n_bp_values):
        self.bp_words = bp_words
        self.run_ends = run_ends
        self.run_is_rle = run_is_rle
        self.run_value = run_value
        self.run_bp_start = run_bp_start
        self.count = count
        self.width = width
        self.n_bp_values = n_bp_values


def plan_hybrid(data, count: int, width: int, pos: int = 0) -> HybridPlan:
    """Run table of the hybrid stream in ``data`` from byte ``pos``: the
    run headers scanned on the host, the bit-packed bytes staged as
    padded u32 words."""
    return plan_from_scan(scan_hybrid(data, count, width, pos), count, width)


def plan_from_scan(scan, count: int, width: int) -> HybridPlan:
    """Device plan from a :func:`~tpuparquet_torch.cpu.hybrid.scan_hybrid`
    result."""
    ends, is_rle, values, bp_starts, bp_bytes, n_bp, _ = scan
    if len(ends) == 0:
        ends = np.zeros(1, dtype=np.int32)
        is_rle = np.ones(1, dtype=bool)
        values = np.zeros(1, dtype=np.uint32)
        bp_starts = np.zeros(1, dtype=np.int32)
    bp_words = pad_to_words(np.asarray(bp_bytes, dtype=np.uint8),
                            max(width, 1), max(n_bp, 1))
    return HybridPlan(
        bp_words=bp_words,
        run_ends=np.asarray(ends, dtype=np.int32),
        run_is_rle=np.asarray(is_rle, dtype=bool),
        run_value=np.asarray(values, dtype=np.uint32),
        run_bp_start=np.asarray(bp_starts, dtype=np.int32),
        count=count,
        width=width,
        n_bp_values=max(n_bp, 1),
    )


def pack_plan(p: HybridPlan):
    """Pad a plan to power-of-two buckets and pack its four run-table
    columns into one (4, R) u32 array.  Padding runs end at ``cnt`` and
    are RLE of 0.  Returns ``((flat bp_words, table), cnt, width, n_bp)``."""
    from .decode import bucket

    cnt = bucket(p.count)
    R = bucket(len(p.run_ends))
    n_bp = bucket(p.n_bp_values)
    n_blocks = (n_bp + 31) // 32
    w = max(p.width, 1)
    bp_words = np.zeros((n_blocks, w), dtype=np.uint32)
    bp_words[: p.bp_words.shape[0], : p.bp_words.shape[1]] = p.bp_words
    table = np.zeros((4, R), dtype=np.uint32)
    table[0, :] = cnt
    table[0, : len(p.run_ends)] = p.run_ends.astype(np.uint32)
    table[1, :] = 1
    table[1, : len(p.run_is_rle)] = p.run_is_rle.astype(np.uint32)
    table[2, : len(p.run_value)] = p.run_value
    table[3, : len(p.run_bp_start)] = p.run_bp_start.astype(np.uint32)
    return (bp_words.reshape(-1), table), cnt, p.width, n_bp


def single_bp_scan(scan) -> bool:
    """True when a scan is exactly one bit-packed run: its expansion is
    a plain unpack (K1), no run search."""
    ends, is_rle = scan[0], scan[1]
    return len(ends) == 1 and not bool(is_rle[0])


def plan_stream_args(scan, count: int, width: int, expanded=None):
    """``((bp_words, table), cnt, nbp, single)`` staging plan of one
    hybrid stream — the JAX package's decision, reproduced exactly.

    When the stream's run table plus its bit-packed segments (bucket
    padded, as shipped) weigh more than a plain bit-packing of all its
    values, the host re-packs the runs as ONE bit-packed run
    (``single=True``): in one C pass from the run table, or from the
    caller's ``expanded`` values."""
    from .decode import bucket

    def bp_wire(n_vals: int) -> int:
        return ((bucket(max(n_vals, 1)) + 31) // 32) * 4 * width

    single = single_bp_scan(scan)
    if not single and width and count >= 1024:
        n_bp = int(scan[5])
        old_wire = 16 * bucket(max(len(scan[0]), 1)) + (
            bp_wire(n_bp) if n_bp else 0)
        new_wire = 16 * bucket(1) + bp_wire(count)
        if old_wire > new_wire:
            packed = None
            if expanded is None:
                # run table -> packed bits in one C pass, no expanded
                # intermediate
                packed = pack_native().hybrid_repack(scan, count, width)
            if packed is None:
                vals = (expanded if expanded is not None
                        else expand_scan(*scan[:6], count, width))
                packed = np.frombuffer(pack(vals[:count], width),
                                       dtype=np.uint8)
            scan = (np.array([count], dtype=np.int32),
                    np.zeros(1, dtype=bool),
                    np.zeros(1, dtype=np.uint32),
                    np.zeros(1, dtype=np.int32),
                    packed, count, scan[6])
            single = True
    args, cnt, _, nbp = pack_plan(plan_from_scan(scan, count, width))
    return args, cnt, nbp, single


def _bp_lane_stats(scan, width: int, target: int):
    """(max value | None, count == target) over a scan's consumed
    bit-packed lanes (per-run 8-group padding excluded), in one C
    pass."""
    ends, is_rle, _, bp_starts, bp_bytes, n_bp, _pos = scan
    lens = np.diff(ends, prepend=np.int32(0))
    bp = ~is_rle
    if not bp.any() or not n_bp:
        return None, 0
    return hybrid_native().bp_stats(bp_bytes, width, bp_starts[bp], lens[bp],
                                    target)


def count_eq_scan(scan, width: int, target: int,
                  validate_max: bool = False) -> int:
    """Occurrences of ``target`` in a scanned stream without expanding it
    (the non-null count of a def-level stream).  ``validate_max``
    rejects any level above ``target``."""
    ends, is_rle, values = scan[0], scan[1], scan[2]
    if len(ends) == 0:
        return 0
    lens = np.diff(ends, prepend=np.int32(0))
    live = lens > 0
    if validate_max and bool((values[is_rle & live] > target).any()):
        raise ValueError(
            f"level value {int(values[is_rle & live].max())} exceeds "
            f"max level {target}")
    cnt = int(lens[is_rle & (values == target)].sum())
    bp_max, bp_cnt = _bp_lane_stats(scan, width, target)
    if bp_max is not None:
        if validate_max and bp_max > target:
            raise ValueError(
                f"level value {bp_max} exceeds max level {target}")
        cnt += bp_cnt
    return cnt


def max_scan_value(scan, width: int) -> int:
    """Max decoded value across a scan's live runs; -1 when empty."""
    ends, is_rle, values = scan[0], scan[1], scan[2]
    if len(ends) == 0:
        return -1
    lens = np.diff(ends, prepend=np.int32(0))
    mx = -1
    rle_live = is_rle & (lens > 0)
    if rle_live.any():
        mx = int(values[rle_live].max())
    bp_max, _ = _bp_lane_stats(scan, width, 0)
    if bp_max is not None:
        mx = max(mx, bp_max)
    return mx


def expand_hybrid_plain(bp_words: torch.Tensor, table: torch.Tensor,
                        cnt: int, w: int, nbp: int) -> torch.Tensor:
    """Plain PyTorch version of K2 (``expand_hybrid_core`` over slots
    ``0..cnt-1``), in int64 arithmetic."""
    dev = bp_words.device
    R = table.numel() // 4
    t = u32_to_i64(table).reshape(4, R)
    # the ends and bp_start are int32, as the reference's columns are
    ends, bp_start = (torch.where(r >= 1 << 31, r - (1 << 32), r)
                      for r in (t[0], t[3]))
    unpacked = u32_to_i64(unpack_u32_plain(bp_words, max(w, 1), nbp))
    idx = torch.arange(cnt, dtype=torch.int64, device=dev)
    run = torch.clamp(torch.searchsorted(ends, idx, right=True), max=R - 1)
    run_start = torch.where(run > 0, ends[torch.clamp(run - 1, min=0)],
                            torch.zeros_like(run))
    bp_pos = torch.clamp(bp_start[run] + (idx - run_start), 0, nbp - 1)
    return i64_to_u32_bits(torch.where(t[1][run] != 0, t[2][run],
                                       unpacked[bp_pos]))


def _check_table(table: torch.Tensor) -> int:
    if table.numel() == 0 or table.numel() % 4:
        raise ValueError("run table must hold 4 rows of R >= 1 runs")
    return table.numel() // 4


def hybrid_tile_slots() -> int:
    """Output slots a block of K2 expands (the kernel's tile: 256 threads,
    each 2 rows of 4 slots)."""
    return 2048


def expand_hybrid(bp_words: torch.Tensor, table: torch.Tensor, cnt: int,
                  w: int, nbp: int, single: bool = False) -> torch.Tensor:
    """Expand a packed (4, R) run table (flat int32 tensor of 4 * R u32
    words) over ``cnt`` output slots; ``bp_words`` holds the bit-packed
    lanes at width ``max(w, 1)``, ``nbp`` of them.  ``single`` (the stream
    is one bit-packed run, ``w > 0``) is the plain unpack of K1, as in
    ``decode.py _expand_stream``.  CUDA tensors launch K2; CPU tensors
    take the plain version."""
    if single and w:
        return unpack_u32(bp_words, w, cnt)
    R = _check_table(table)
    _check_words(bp_words, max(w, 1), nbp)
    if bp_words.device.type == "cpu":
        return expand_hybrid_plain(bp_words, table, cnt, w, nbp)
    if bp_words.device.type != "cuda":
        raise ValueError(f"unsupported device {bp_words.device}")
    check_tensor(bp_words, "bp_words", torch.int32, bp_words.device)
    check_tensor(table, "table", torch.int32, bp_words.device)
    out = torch.empty(cnt, dtype=torch.int32, device=bp_words.device)
    launch("expand_hybrid", bp_words.data_ptr(), table.data_ptr(), R,
           out.data_ptr(), cnt, max(w, 1), nbp, hybrid_tile_slots(),
           stream_of(out))
    count_launch(expand_hybrid)
    return out


expand_hybrid.launches = 0
