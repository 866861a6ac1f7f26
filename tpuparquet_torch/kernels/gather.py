"""Device kernels of the sharded scan (``shard/``): the SPMD dictionary
decode step (KS2), a BYTE_ARRAY unit's densify into its row of the
gathered block (KS3) and the placed gather's permute to unit order (KS4).
KS1, the fixed-width densify, is ``decode.scatter_to_dense``.

Each wrapper launches its kernel on a CUDA tensor and takes its plain
PyTorch version on a CPU tensor, and counts its launches in
``.launches``.  Outputs are written in place into the caller's block
(``out=``), so a gathered block is assembled without a stacking copy.
"""

from __future__ import annotations

import numpy as np
import torch

from ._lib import check_tensor, count_launch, launch, stream_of, \
    u32_to_i64
from .bitunpack import unpack_u32_plain

__all__ = ["spmd_step_slot", "spmd_step_slot_plain", "spmd_tile_positions",
           "byte_densify", "byte_densify_plain", "densify_tile_slots",
           "place_rows", "place_rows_plain"]

_I32_MAX = (1 << 31) - 1


# ----------------------------------------------------------------------
# KS2: one mesh slot's share of the SPMD dictionary decode step
# ----------------------------------------------------------------------

def spmd_tile_positions() -> int:
    """Positions of one unit that a block of KS2 decodes (its tiles are
    cut from the slot's first position; the kernel takes up to 512).
    ``chip_smoke.py`` phase 4 times the step at 128, 256 and 512."""
    return 256


def _check_step(bw, run_ends, run_is_rle, run_value, run_bp_start,
                dictionary, out, unit0: int, pos0: int, n_pos: int,
                width: int, n_bp: int) -> None:
    u, R = run_ends.shape
    if R < 1 or any(t.shape != (u, R) for t in (run_is_rle, run_value,
                                                  run_bp_start)):
        raise ValueError("run arrays must share one (units, R >= 1) shape")
    if bw.dim() != 2 or bw.shape[0] != u:
        raise ValueError("bp_words must hold one row per unit")
    if not 0 <= width <= 32 or n_bp < 1 \
            or bw.shape[1] < (n_bp + 31) // 32 * max(width, 1):
        raise ValueError(f"{n_bp} lanes of width {width} do not fit rows of "
                         f"{bw.shape[1]} words")
    if dictionary.dim() != 2 or dictionary.shape[0] < 1:
        raise ValueError("dictionary must be (D >= 1, lanes)")
    if out.dim() != 3 or out.shape[2] != dictionary.shape[1] \
            or unit0 < 0 or unit0 + u > out.shape[0] \
            or pos0 < 0 or pos0 + n_pos > out.shape[1]:
        raise ValueError("the slot's share does not fit the output")


def spmd_step_slot_plain(bw, run_ends, run_is_rle, run_value, run_bp_start,
                         dictionary, out, unit0: int, pos0: int, n_pos: int,
                         width: int, n_bp: int) -> None:
    """Plain PyTorch version of KS2 (``expand_hybrid_core`` vmapped over
    the slot's units, then the clamped dictionary gather)."""
    u, R = run_ends.shape
    dev = run_ends.device
    idx = torch.arange(pos0, pos0 + n_pos, dtype=torch.int64, device=dev)
    ends = run_ends.to(torch.int64)
    run = torch.searchsorted(ends, idx.expand(u, n_pos).contiguous(),
                             right=True).clamp(max=R - 1)
    start = torch.where(run > 0, ends.gather(1, (run - 1).clamp(min=0)),
                        torch.zeros_like(run))
    bp_pos = (run_bp_start.to(torch.int64).gather(1, run) + idx
              - start).clamp(0, n_bp - 1)
    unpacked = torch.stack([u32_to_i64(unpack_u32_plain(
        bw[k], max(width, 1), n_bp)) for k in range(u)]) if u else \
        torch.zeros((0, n_bp), dtype=torch.int64, device=dev)
    vals = torch.where(run_is_rle.gather(1, run),
                       u32_to_i64(run_value).gather(1, run),
                       unpacked.gather(1, bp_pos))
    k = vals.clamp(max=dictionary.shape[0] - 1)
    out[unit0 : unit0 + u, pos0 : pos0 + n_pos] = dictionary[k]


def spmd_step_slot(bw: torch.Tensor, run_ends, run_is_rle, run_value,
                   run_bp_start, dictionary: torch.Tensor,
                   out: torch.Tensor, unit0: int, pos0: int, n_pos: int,
                   width: int, n_bp: int) -> None:
    """Decode the units of one rg block at the value positions ``[pos0,
    pos0 + n_pos)`` (one slot's sp slice) into ``out[unit0 : unit0 + u,
    pos0 : pos0 + n_pos]``: ``bw`` ``(u, words)`` bit-packed lanes at
    width ``max(width, 1)`` (``n_bp`` of them a unit), the run arrays
    ``(u, R)`` (ends int32, is_rle bool, value u32 bits, bp_start int32),
    ``dictionary`` ``(D, lanes)`` u32 bits, ``out`` ``(U, count, lanes)``.
    An index past ``D - 1`` takes entry ``D - 1``.  CUDA tensors launch
    KS2 once; CPU tensors take the plain version."""
    _check_step(bw, run_ends, run_is_rle, run_value, run_bp_start,
                dictionary, out, unit0, pos0, n_pos, width, n_bp)
    dev = out.device
    if dev.type == "cpu":
        spmd_step_slot_plain(bw, run_ends, run_is_rle, run_value,
                             run_bp_start, dictionary, out, unit0, pos0,
                             n_pos, width, n_bp)
        return
    if dev.type != "cuda":
        raise ValueError(f"unsupported device {dev}")
    for name, t, dt in (("bp_words", bw, torch.int32),
                        ("run_ends", run_ends, torch.int32),
                        ("run_is_rle", run_is_rle, torch.bool),
                        ("run_value", run_value, torch.int32),
                        ("run_bp_start", run_bp_start, torch.int32),
                        ("dictionary", dictionary, torch.int32),
                        ("out", out, torch.int32)):
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
        check_tensor(t.view(-1), name, dt, dev)
    u, R = run_ends.shape
    launch("spmd_step", bw.data_ptr(), bw.shape[1], run_ends.data_ptr(),
           run_is_rle.data_ptr(), run_value.data_ptr(),
           run_bp_start.data_ptr(), R, dictionary.data_ptr(),
           dictionary.shape[0], dictionary.shape[1], u, pos0, n_pos,
           spmd_tile_positions(), max(width, 1), n_bp, out.data_ptr(),
           out.shape[1], unit0, stream_of(out))
    count_launch(spmd_step_slot)


spmd_step_slot.launches = 0


# ----------------------------------------------------------------------
# KS3: a BYTE_ARRAY unit's densify into its rows of the gathered block
# ----------------------------------------------------------------------

def densify_tile_slots() -> int:
    """Slots a block of KS3 scans (the kernel's tile: 8 warps, each lane
    2 rows of 4 slots)."""
    return 2048


def _densify_slots(n_packed: int, mask, positions) -> int:
    if mask is not None:
        return mask.numel()
    if positions is not None:
        return positions.numel()
    return n_packed


def byte_densify_plain(offsets, n_packed: int, mask, positions, data,
                       out_offsets, out_data) -> None:
    """Plain PyTorch version of KS3."""
    n = _densify_slots(n_packed, mask, positions)
    dev = offsets.device
    if n_packed == 0:
        dl = torch.zeros(n, dtype=torch.int64, device=dev)
    else:
        lens = torch.diff(offsets[: n_packed + 1].to(torch.int64))
        pos = (torch.arange(n, device=dev) if positions is None
               else positions.to(torch.int64)).clamp(0, n_packed - 1)
        dl = lens[pos]
        if mask is not None:
            dl = torch.where(mask, dl, torch.zeros_like(dl))
    cs = torch.cumsum(dl, 0)
    out_offsets[0] = 0
    out_offsets[1 : n + 1] = cs
    out_offsets[n + 1:] = cs[-1] if n else 0
    nb = data.numel()
    out_data[:nb] = data
    out_data[nb:] = 0


def byte_densify(offsets: torch.Tensor, n_packed: int, mask, positions,
                 data: torch.Tensor, out_offsets: torch.Tensor,
                 out_data: torch.Tensor) -> None:
    """One BYTE_ARRAY unit's densified rows: ``out_offsets`` (L >= n + 1
    int32) gets ``[0, cumsum(dl)]`` edge-padded with the byte total, where
    ``dl[i] = mask[i] ? len(value positions[i]) : 0`` over ``n =
    len(mask)`` slots (``mask``/``positions`` None: every one of the
    ``n_packed`` values, in order); ``out_data`` (B >= len(data) bytes)
    gets ``data`` zero-padded.  ``offsets`` holds at least ``n_packed +
    1`` int32 entries.  CUDA tensors launch KS3 once; CPU tensors take the
    plain version."""
    n = _densify_slots(n_packed, mask, positions)
    dev = offsets.device
    if out_offsets.numel() < n + 1 or out_data.numel() < data.numel() \
            or offsets.numel() < n_packed + 1:
        raise ValueError("the unit does not fit its rows")
    if data.numel() > _I32_MAX:
        raise ValueError("a unit of 2^31 bytes or more does not fit int32 "
                         "offsets")
    if dev.type == "cpu":
        byte_densify_plain(offsets, n_packed, mask, positions, data,
                           out_offsets, out_data)
        return
    if dev.type != "cuda":
        raise ValueError(f"unsupported device {dev}")
    check_tensor(offsets, "offsets", torch.int32, dev)
    check_tensor(data, "data", torch.uint8, dev)
    check_tensor(out_offsets, "out_offsets", torch.int32, dev)
    check_tensor(out_data, "out_data", torch.uint8, dev)
    if mask is not None:
        check_tensor(mask, "mask", torch.bool, dev)
    if positions is not None:
        check_tensor(positions, "positions", torch.int32, dev)
    # the ticket counter (16 bytes), then one word a tile of the scan,
    # which starts up to 3 slots before out_offsets
    tile = densify_tile_slots()
    L = out_offsets.numel()
    scratch = torch.empty(2 + (L + 3 + tile - 1) // tile, dtype=torch.int64,
                          device=dev)
    launch("byte_densify", offsets.data_ptr(), n_packed,
           None if mask is None else mask.data_ptr(),
           None if positions is None else positions.data_ptr(), n, tile,
           scratch.data_ptr(), out_offsets.data_ptr(), L, data.data_ptr(),
           data.numel(), out_data.data_ptr(), out_data.numel(),
           stream_of(out_data))
    count_launch(byte_densify)


byte_densify.launches = 0


# ----------------------------------------------------------------------
# KS4: the placed gather's rows in unit order
# ----------------------------------------------------------------------

def place_rows_plain(x, rows, n_true: int, u_out: int) -> torch.Tensor:
    """Plain PyTorch version of KS4."""
    y = torch.zeros((u_out,) + tuple(x.shape[1:]), dtype=x.dtype,
                    device=x.device)
    y[:n_true] = x[rows[:n_true]]
    return y


def place_rows(x: torch.Tensor, rows, n_true: int,
               u_out: int) -> torch.Tensor:
    """``out[i] = x[rows[i]]`` for ``i < n_true``, zero rows up to
    ``u_out``: the shard-major assembly ``x`` ``(U, ...)`` (any dtype,
    contiguous) permuted to unit order.  ``rows`` (int64, at least
    ``n_true`` entries, each in ``[0, U)``) is checked on the host.  CUDA
    tensors launch KS4 once; CPU tensors take the plain version."""
    rows = torch.as_tensor(np.asarray(rows[:n_true], dtype=np.int64))
    if not 0 <= n_true <= u_out:
        raise ValueError(f"n_true={n_true} out of range for {u_out} rows")
    if n_true and (int(rows.min()) < 0 or int(rows.max()) >= x.shape[0]):
        raise ValueError("a row index is outside the assembly")
    dev = x.device
    if dev.type == "cpu":
        return place_rows_plain(x, rows, n_true, u_out)
    if dev.type != "cuda":
        raise ValueError(f"unsupported device {dev}")
    if not x.is_contiguous():
        raise ValueError("x must be contiguous")
    rows = rows.to(dev)
    out = torch.empty((u_out,) + tuple(x.shape[1:]), dtype=x.dtype,
                      device=dev)
    row_bytes = int(np.prod(x.shape[1:], dtype=np.int64)) * x.element_size()
    launch("place_rows", x.data_ptr(), row_bytes, rows.data_ptr(), n_true,
           u_out, out.data_ptr(), stream_of(out))
    count_launch(place_rows)
    return out


place_rows.launches = 0
