"""Device encode: the write-side kernels (KE1-KE5) and ``DeviceValues``.

The port of ``tpuparquet/kernels/encode.py``.  The use case is columns
that already live in device memory (a read, then compute on the card):
encoding on the device ships *encoded* bytes to the host instead of raw
values.  Every function is byte-exact with the host encoders
(``cpu/bitpack.py``, ``cpu/delta.py``, ``cpu/bss.py``), so a file written
from :class:`DeviceValues` equals the one written from the same numpy
values.

Kernels (``csrc/``), each beside its plain PyTorch version, which the
wrapper runs for CPU tensors only:

* KE1 ``pack_bits`` (``pack_bits.cu``): LSB-first bit packing at widths
  1-64, the tail past ``count`` zeroed, optionally over a list of 32-value
  miniblocks (``pack_u32_device``, ``pack_u64_device``, and the
  ``_pack_masked32/64`` of the delta encoder's second phase);
* KE2 ``bss_encode_device`` (``bss_encode.cu``): lane words to
  BYTE_STREAM_SPLIT streams;
* KE3 ``delta_phase1`` (``delta_encode.cu``): the first phase of
  DELTA_BINARY_PACKED (deltas, the signed minimum of each 128-delta
  block, the adjusted deltas, the maximum of each 32-delta miniblock);
* KE4 ``dict_build`` (``dict_build.cu``): the first-occurrence dictionary
  intern of small-range integers;
* KE5 ``lanes_min_max`` (``min_max.cu``): min and max in signed,
  unsigned or float order (NaN skipped, ``-0.0 < +0.0`` as the JAX
  device path orders them).

Value tensors are the port's lane layout: flat 1-D int32 tensors holding
u32 lane bits (``DeviceColumn.data``).  The plain versions do their u32
and u64 arithmetic in int64, since CPU ``torch.uint32`` has no shifts or
adds.  The JAX module's bucketed shapes exist for XLA's compile cache;
the port computes the true shapes.
"""

from __future__ import annotations

import ctypes
import functools
import threading

import numpy as np
import torch

from ..cpu.delta import widths_from_max
from ..varint import write_uvarint, write_zigzag
from ._lib import check_tensor, count_launch, i64_to_lanes, \
    i64_to_u32_bits, lanes_to_i64, launch, stream_of, u32_to_i64

__all__ = [
    "DeviceValues",
    "bss_encode_device", "bss_encode_plain",
    "delta_encode_device", "delta_phase1", "delta_phase1_plain",
    "device_dict_build", "dict_build", "dict_build_plain",
    "dict_small_range",
    "lanes_min_max", "lanes_min_max_plain",
    "pack_bits", "pack_bits_plain", "pack_u32_device", "pack_u64_device",
    "pack_warp_miniblocks",
]

_BLOCK = 128
_MINIBLOCKS = 4
_MB = _BLOCK // _MINIBLOCKS
_I64_MIN = -(1 << 63)
_I64_MAX = (1 << 63) - 1
_I32_MAX = (1 << 31) - 1


def _device_of(t: torch.Tensor) -> str:
    if t.device.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {t.device}")
    return t.device.type


def _opt_ptr(t) -> int | None:
    return None if t is None else t.data_ptr()


# ----------------------------------------------------------------------
# KE1: LSB-first bit packing
# ----------------------------------------------------------------------

@functools.lru_cache(maxsize=None)
def _pack_tables(width: int):
    """Per word of a 32-value block of ``width``-bit values, the
    ``(value, p)`` pairs whose bits overlap it: ``p = 32 j - i * width``
    is the value's bit that lands on the word's bit 0 (``p < 0``: the
    value starts ``-p`` bits into the word)."""
    out = []
    for j in range(width):
        lo_bit, hi_bit = 32 * j, 32 * j + 32
        out.append(tuple((i, lo_bit - i * width) for i in range(32)
                         if i * width < hi_bit
                         and i * width + width > lo_bit))
    return tuple(out)


def _check_pack(lo, hi, width: int, count: int, sel) -> None:
    if not 0 <= width <= 64:
        raise ValueError(f"bit width {width} out of range 0..64")
    if count < 0:
        raise ValueError(f"negative count {count}")
    if width > 32 and hi is None:
        raise ValueError(f"width {width} needs the high lanes")
    if sel is not None and sel.numel() < (count + 31) // 32:
        raise ValueError(f"{count} values need {(count + 31) // 32} "
                         f"miniblock indices, got {sel.numel()}")


def pack_bits_plain(lo, hi, width: int, count: int, sel=None):
    """Plain PyTorch version of KE1."""
    dev = lo.device
    nb = (count + 31) // 32
    if width == 0 or nb == 0:
        return torch.zeros(0, dtype=torch.int32, device=dev)
    i = torch.arange(nb * 32, dtype=torch.int64, device=dev)
    src = i if sel is None else (
        sel[:nb].to(torch.int64).repeat_interleave(32) * 32 + (i & 31))
    live = i < count

    def take(x):
        n_in = x.numel()
        if n_in == 0:
            return torch.zeros(nb, 32, dtype=torch.int64, device=dev)
        v = u32_to_i64(x[torch.clamp(src, max=n_in - 1)])
        return torch.where(live & (src < n_in), v,
                           torch.zeros_like(v)).reshape(nb, 32)

    if width <= 32:
        vlo, vhi = take(lo) & ((1 << width) - 1), None
    else:
        vlo, vhi = take(lo), take(hi) & ((1 << (width - 32)) - 1)
    words = []
    for contribs in _pack_tables(width):
        acc = torch.zeros(nb, dtype=torch.int64, device=dev)
        for k, p in contribs:
            if p < 0:
                c = (vlo[:, k] << -p) & 0xFFFFFFFF
            elif p == 0:
                c = vlo[:, k]
            elif p < 32:
                c = vlo[:, k] >> p
                if vhi is not None:
                    c = c | ((vhi[:, k] << (32 - p)) & 0xFFFFFFFF)
            else:
                c = vhi[:, k] >> (p - 32)
            acc = acc | c
        words.append(acc)
    return i64_to_u32_bits(torch.stack(words, dim=1).reshape(-1))


def pack_bits(lo: torch.Tensor, hi, width: int, count: int, sel=None):
    """LSB-first pack of ``count`` values of ``width`` bits (0..64) into
    ``ceil(count / 32) * width`` u32 words (an int32 tensor).  Value
    ``i`` is lane ``i`` of ``lo`` (and, for widths above 32, of ``hi``),
    or with ``sel`` (int32 miniblock indices) lane ``sel[i // 32] * 32 +
    i % 32``; lanes past the inputs read as 0, values past ``count`` pack
    as 0, and the bits above ``width`` are masked off, as in the JAX
    functions.  CUDA tensors launch KE1; CPU tensors take the plain
    version."""
    _check_pack(lo, hi, width, count, sel)
    if _device_of(lo) == "cpu":
        return pack_bits_plain(lo, hi, width, count, sel)
    dev = lo.device
    check_tensor(lo, "lo", torch.int32, dev)
    n_in = lo.numel()
    if width > 32:
        check_tensor(hi, "hi", torch.int32, dev)
        n_in = min(n_in, hi.numel())
    else:
        hi = None
    if sel is not None:
        check_tensor(sel, "sel", torch.int32, dev)
    nb = (count + 31) // 32
    if width == 0 or nb == 0:
        return torch.zeros(0, dtype=torch.int32, device=dev)
    out = torch.empty(nb * width, dtype=torch.int32, device=dev)
    launch("pack_bits", lo.data_ptr(), _opt_ptr(hi), n_in, _opt_ptr(sel),
           count, width, pack_warp_miniblocks(), out.data_ptr(),
           stream_of(out))
    count_launch(pack_bits)
    return out


pack_bits.launches = 0


def pack_warp_miniblocks() -> int:
    """Miniblocks one warp of KE1 (``csrc/pack_bits.cu``) packs, which it
    takes from its wrapper and checks against its compiled count: 4, so
    a width class of about 10^4 miniblocks runs in one wave with each
    warp's loads in flight together.  The checks pin a warp's and a
    block's share with it."""
    return 4


def pack_u32_device(values: torch.Tensor, width: int,
                    count: int) -> torch.Tensor:
    """LSB-first pack of ``count`` u32 values (masked to ``width`` bits)
    into flat u32 words; byte-exact with ``cpu.bitpack.pack``.  The input
    may be longer (padded) or shorter (read as 0); the tail past
    ``count`` is zeroed.  Width 0 or count 0 give no words."""
    if width > 32:
        raise ValueError(f"bit width {width} out of range 0..32")
    return pack_bits(values, None, width, count)


def pack_u64_device(lo: torch.Tensor, hi: torch.Tensor, width: int,
                    count: int) -> torch.Tensor:
    """64-bit twin of :func:`pack_u32_device`: values as ``(lo, hi)`` u32
    lanes; widths up to 32 read ``lo`` only."""
    return pack_bits(lo, hi if width > 32 else None, width, count)


# ----------------------------------------------------------------------
# KE2: BYTE_STREAM_SPLIT encode
# ----------------------------------------------------------------------

def _check_bss(flat, count: int, k: int, lanes: int) -> None:
    if lanes < 1 or not 1 <= k <= 4 * lanes:
        raise ValueError(f"{k} byte streams do not fit {lanes} lanes")
    if flat.numel() < count * lanes:
        raise ValueError(f"{count} values of {lanes} lanes need "
                         f"{count * lanes} words, got {flat.numel()}")


def bss_tile_rows(lanes: int) -> int:
    """Rows of one tile of KE2 (``csrc/bss_encode.cu``), which takes them
    from its wrapper: the largest multiple of 16 whose rows of ``4 *
    lanes`` bytes fit 16 KiB, at least 16.  The checks pin the tiles'
    edges with it."""
    return max(16, (16384 // (4 * lanes)) & ~15)


def bss_encode_plain(flat, count: int, k: int, lanes: int) -> torch.Tensor:
    """Plain PyTorch version of KE2."""
    w = u32_to_i64(flat[: count * lanes]).reshape(count, lanes)
    b = torch.stack([(w >> (8 * s)) & 0xFF for s in range(4)], dim=2)
    rows = b.reshape(count, 4 * lanes)[:, :k].to(torch.uint8)
    return rows.t().reshape(-1)


def bss_encode_device(flat: torch.Tensor, count: int, k: int,
                      lanes: int) -> torch.Tensor:
    """BYTE_STREAM_SPLIT encode: ``count`` values of ``lanes`` u32 words
    (their ``4 * lanes`` little-endian bytes) -> ``(k * count,)`` u8,
    stream ``s`` holding byte ``s`` of every value; the inverse of K12,
    byte-exact with ``cpu.bss.encode_byte_stream_split``.  CUDA tensors
    launch KE2; CPU tensors take the plain version."""
    _check_bss(flat, count, k, lanes)
    if _device_of(flat) == "cpu":
        return bss_encode_plain(flat, count, k, lanes)
    check_tensor(flat, "flat", torch.int32, flat.device)
    out = torch.empty(k * count, dtype=torch.uint8, device=flat.device)
    if count:
        launch("bss_encode", flat.data_ptr(), count, k, lanes,
               bss_tile_rows(lanes), out.data_ptr(), stream_of(out))
        count_launch(bss_encode_device)
    return out


bss_encode_device.launches = 0


# ----------------------------------------------------------------------
# KE3: DELTA_BINARY_PACKED, the device phase before the width decision
# ----------------------------------------------------------------------

def _n_blocks(count: int) -> int:
    return (count - 1 + _BLOCK - 1) // _BLOCK


def delta_phase1_plain(flat, count: int, is32: bool):
    """Plain PyTorch version of KE3."""
    dev = flat.device
    nb = _n_blocks(count)
    nd = count - 1
    live = torch.arange(nb * _BLOCK, device=dev) < nd
    if is32:
        v = flat[:count].to(torch.int64)
        d = v[1:] - v[:-1]
        d = ((d + (1 << 31)) & 0xFFFFFFFF) - (1 << 31)  # i32 wraparound
        pad = _I32_MAX
    else:
        v = lanes_to_i64(flat[0 : 2 * count : 2], flat[1 : 2 * count : 2])
        d = v[1:] - v[:-1]  # int64 wraps, as the u64 lane subtraction
        pad = _I64_MAX
    d = torch.cat([d, torch.full((nb * _BLOCK - nd,), pad,
                                 dtype=torch.int64, device=dev)])
    mins = d.reshape(nb, _BLOCK).min(dim=1).values
    adj = d - mins.repeat_interleave(_BLOCK)
    if is32:
        adj = adj & 0xFFFFFFFF
    adj = torch.where(live, adj, torch.zeros_like(adj))
    if is32:
        mx = adj.reshape(nb * _MINIBLOCKS, _MB).max(dim=1).values
        return (mins.to(torch.int32), i64_to_u32_bits(mx),
                i64_to_u32_bits(adj))
    # unsigned maximum: flip the sign bit into a signed order
    key = (adj ^ _I64_MIN).reshape(nb * _MINIBLOCKS, _MB)
    mx = key.max(dim=1).values ^ _I64_MIN
    return (*i64_to_lanes(mins), *i64_to_lanes(mx), *i64_to_lanes(adj))


def delta_phase1(flat: torch.Tensor, count: int, is32: bool):
    """Deltas of ``count >= 2`` int32 (``is32``, one lane, wrapping at 32
    bits as ``cpu/delta.py`` does) or int64 (two interleaved lanes)
    values in blocks of 128: each block's signed minimum delta (dead
    lanes past the last delta take the type's maximum first), the
    adjusted deltas ``delta - minimum`` (dead lanes 0) and each 32-delta
    miniblock's unsigned maximum.  int32 gives ``(mins, mb_max,
    adjusted)``, int64 ``(min_lo, min_hi, max_lo, max_hi, adj_lo,
    adj_hi)``, lanes as int32 bits, equal to the JAX
    ``_delta_phase1_i32/_i64`` lane for lane over the true blocks.  CUDA
    tensors launch KE3; CPU tensors take the plain version."""
    lanes = 1 if is32 else 2
    if count < 2:
        raise ValueError(f"delta phase 1 needs >= 2 values, got {count}")
    if flat.numel() < count * lanes:
        raise ValueError(f"{count} values need {count * lanes} lanes, got "
                         f"{flat.numel()}")
    if _device_of(flat) == "cpu":
        return delta_phase1_plain(flat, count, is32)
    dev = flat.device
    check_tensor(flat, "flat", torch.int32, dev)
    nb = _n_blocks(count)
    # one allocation, cut by one split: the adjusted deltas lead, so the
    # planes that take 16-byte stores start on 16-byte boundaries (128 nb
    # words each), then the miniblock maxima and the block minima
    sizes = (_BLOCK * nb, _MINIBLOCKS * nb, nb)
    if not is32:  # lo and hi planes of each
        sizes = (sizes[0], sizes[0], sizes[1], sizes[1], nb, nb)
    buf = torch.empty(sum(sizes), dtype=torch.int32, device=dev)
    parts = buf.split_with_sizes(sizes)
    if is32:
        adj, mx, mins = parts
        outs = (mins, None, mx, None, adj, None)
    else:
        alo, ahi, mx_lo, mx_hi, min_lo, min_hi = parts
        outs = (min_lo, min_hi, mx_lo, mx_hi, alo, ahi)
    launch("delta_encode", flat.data_ptr(), count, int(is32), nb,
           *[_opt_ptr(t) for t in outs], stream_of(flat))
    count_launch(delta_phase1)
    return (mins, mx, adj) if is32 else outs


delta_phase1.launches = 0


def _u64(lo: np.ndarray, hi: np.ndarray) -> np.ndarray:
    return (lo.view(np.uint32).astype(np.uint64)
            | (hi.view(np.uint32).astype(np.uint64) << np.uint64(32)))


def delta_encode_device(flat: torch.Tensor, count: int,
                        is32: bool = False) -> bytes:
    """DELTA_BINARY_PACKED encode (block 128, 4 miniblocks) with the
    deltas, minima, maxima (KE3) and the miniblock packing (KE1, one
    launch per width over a list of miniblocks) on the tensor's device;
    byte-identical to ``cpu.delta.encode_delta_binary_packed``.  Only the
    first value, the per-block minima, the per-miniblock maxima and the
    packed words cross to the host.  ``flat``: ``(count * 2,)``
    interleaved lanes of int64, or ``(count,)`` of int32 with
    ``is32=True``, which wraps deltas at 32 bits as the host encoder
    does."""
    lanes = 1 if is32 else 2
    out = bytearray()
    write_uvarint(out, _BLOCK)
    write_uvarint(out, _MINIBLOCKS)
    write_uvarint(out, count)
    if count == 0:
        write_zigzag(out, 0)
        return bytes(out)
    first = flat[:lanes].cpu().numpy()
    write_zigzag(out, int(first.view(np.int32 if is32 else np.int64)[0]))
    if count == 1:
        return bytes(out)
    phase = delta_phase1(flat, count, is32)
    if is32:
        mins, mx, alo = phase
        ahi = None
        minima = mins.cpu().numpy().astype(np.int64)
        mb_max = mx.cpu().numpy().view(np.uint32).astype(np.uint64)
    else:
        min_lo, min_hi, mx_lo, mx_hi, alo, ahi = phase
        minima = _u64(min_lo.cpu().numpy(), min_hi.cpu().numpy()).view(
            np.int64)
        mb_max = _u64(mx_lo.cpu().numpy(), mx_hi.cpu().numpy())
    widths = widths_from_max(mb_max)

    # phase 2: the miniblocks of one width pack in one launch
    payloads = [b""] * widths.size
    for w in np.unique(widths):
        w = int(w)
        if w == 0:
            continue
        idx = np.nonzero(widths == w)[0]
        sel = torch.from_numpy(idx.astype(np.int32)).to(alo.device)
        raw = pack_bits(alo, ahi, w, idx.size * _MB,
                        sel=sel).cpu().numpy().tobytes()
        step = _MB * w // 8
        for j, i in enumerate(idx.tolist()):
            payloads[i] = raw[j * step : (j + 1) * step]
    widths_b = widths.astype(np.uint8).tobytes()
    for b in range(minima.size):
        write_zigzag(out, int(minima[b]))
        out += widths_b[b * _MINIBLOCKS : (b + 1) * _MINIBLOCKS]
        out += b"".join(payloads[b * _MINIBLOCKS : (b + 1) * _MINIBLOCKS])
    return bytes(out)


# ----------------------------------------------------------------------
# KE5: min and max in signed, unsigned or float order
# ----------------------------------------------------------------------

_ORDERS = {"signed": 0, "unsigned": 1, "float": 2}


def lanes_min_max_plain(flat, lanes: int, order: str):
    """Plain PyTorch version of KE5."""
    if lanes == 1:
        v = flat.to(torch.int64)  # the int32 reading of the bits
        flip, nan_above = 0x7FFFFFFF, 0x7F800000
    else:
        v = lanes_to_i64(flat[0::2], flat[1::2])
        flip, nan_above = _I64_MAX, 0x7FF0000000000000
    if order == "signed":
        key = v
    elif order == "unsigned":
        key = v & 0xFFFFFFFF if lanes == 1 else v ^ _I64_MIN
    else:
        # total order on the bits: negative floats flip their magnitude,
        # so -0.0 sorts below +0.0; NaN (either sign) is skipped
        keep = (v & flip) <= nan_above
        key = torch.where(v >= 0, v, v ^ flip)[keep]
    if key.numel() == 0:
        return None
    out = []
    for k in (int(key.min()), int(key.max())):
        if order == "unsigned":
            bits = k if lanes == 1 else k ^ _I64_MIN
        elif order == "float":
            bits = k if k >= 0 else k ^ flip
        else:
            bits = k
        out.append(bits & ((1 << (32 * lanes)) - 1))
    return tuple(out)


def lanes_min_max(flat: torch.Tensor, lanes: int, order: str):
    """``(min, max)`` of the values in ``flat`` (1 or 2 lanes a value) as
    the unsigned ints of their bits, in ``order``: ``"signed"``,
    ``"unsigned"`` or ``"float"`` (NaN skipped, ``-0.0`` below ``+0.0``,
    as the JAX device path's ``nanmin``/``nanmax`` order them); None when
    no value counts (empty, or only NaN).  CUDA tensors launch KE5; CPU
    tensors take the plain version."""
    if lanes not in (1, 2) or order not in _ORDERS:
        raise ValueError(f"min/max over {lanes} lanes in {order!r} order "
                         "is not supported")
    if flat.numel() % lanes:
        raise ValueError(f"{flat.numel()} words are not whole values of "
                         f"{lanes} lanes")
    if _device_of(flat) == "cpu":
        return lanes_min_max_plain(flat, lanes, order)
    check_tensor(flat, "flat", torch.int32, flat.device)
    n = flat.numel() // lanes
    if n == 0:
        return None
    stream = stream_of(flat)
    st = _min_max_state(flat.device, stream)
    with st.lock:
        launch("min_max", flat.data_ptr(), n, lanes, _ORDERS[order],
               st.scratch.data_ptr(), st.out_ptr, stream)
        launch("min_max_wait", stream)
        kmin, kmax = int(st.keys[0]), int(st.keys[1])
    count_launch(lanes_min_max)
    if kmin > kmax:
        return None
    bits = 32 * lanes
    top = 1 << (bits - 1)
    full = (1 << bits) - 1

    def unkey(k):
        # the kernel's unsigned keys: the sign bit flipped for signed
        # order, every bit of a negative float flipped for float order
        if order == "signed":
            return k ^ top
        if order == "float":
            return k ^ top if k & top else k ^ full
        return k

    return unkey(kmin), unkey(kmax)


lanes_min_max.launches = 0


class _MinMaxState:
    """KE5's buffers for one device and stream: ``scratch`` (the blocks'
    fold of the keys and the ticket, zeroed once here and set back to 0
    by every call's last block), the pinned host buffer ``host`` the
    kernel writes the two keys to (``keys`` a numpy view of it,
    ``out_ptr`` its device pointer) and a lock that holds the buffer from
    the launch to the read."""

    __slots__ = ("scratch", "host", "keys", "out_ptr", "lock")

    def __init__(self, device: torch.device):
        self.scratch = torch.zeros(3, dtype=torch.int64, device=device)
        self.host = torch.zeros(2, dtype=torch.int64, pin_memory=True)
        self.keys = self.host.numpy().view(np.uint64)
        # a pinned block of the caching allocator need not be mapped into
        # the device's space: ask, and raise when it is not
        ptr = ctypes.c_uint64()
        launch("min_max_mapped", self.host.data_ptr(), ctypes.byref(ptr))
        self.out_ptr = ptr.value
        self.lock = threading.Lock()


_min_max_states: dict = {}
_min_max_lock = threading.Lock()


def _min_max_state(device: torch.device, stream: int) -> _MinMaxState:
    """The KE5 buffers of ``device`` and ``stream`` (made at first use,
    on that stream, so the ticket's zero lands before its first call)."""
    key = (device.index, stream)
    st = _min_max_states.get(key)
    if st is None:
        with _min_max_lock:
            st = _min_max_states.get(key)
            if st is None:
                st = _min_max_states[key] = _MinMaxState(device)
    return st


# ----------------------------------------------------------------------
# KE4: dictionary intern of small-range integers
# ----------------------------------------------------------------------

def dict_build_plain(flat, lanes: int, count: int, lo_lane: int, rng: int):
    """Plain PyTorch version of KE4."""
    dev = flat.device
    off = (u32_to_i64(flat[: count * lanes : lanes]) - lo_lane) & 0xFFFFFFFF
    i = torch.arange(count, dtype=torch.int64, device=dev)
    first = torch.full((rng,), count, dtype=torch.int64, device=dev)
    first.scatter_reduce_(0, off, i, "amin")
    is_first = first[off] == i
    order = off[is_first]
    dsize = order.numel()
    rank = torch.zeros(rng, dtype=torch.int64, device=dev)
    rank[order] = torch.arange(dsize, dtype=torch.int64, device=dev)
    return order.to(torch.int32), dsize, rank[off].to(torch.int32)


def dict_small_range() -> int:
    """The largest range KE4 (``csrc/dict_build.cu``) interns in shared
    memory, which it takes from its wrapper: 2,048 entries (a block's
    first-occurrence table of 8 KiB, the last block's sort keys of 16
    KiB); past it the flag scan over the values is as fast on uniform
    values.  The checks pin the threshold's edges with it."""
    return 2048


def dict_build(flat: torch.Tensor, lanes: int, count: int, lo_lane: int,
               rng: int):
    """First-occurrence intern of ``count`` integers whose low lanes,
    less ``lo_lane`` (mod 2^32), fall in ``[0, rng)``: each value's offset
    claims its first occurrence in a range table, the first occurrences
    rank in index order, and each value takes its offset's rank.  Returns
    ``(order, dsize, indices)``: the ``dsize`` distinct offsets in
    first-occurrence order, and the int32 rank of every value — the JAX
    ``argsort`` order, without a sort.  CUDA tensors launch KE4; CPU
    tensors take the plain version."""
    if not 1 <= rng <= 1 << 24:
        raise ValueError(f"value range {rng} outside 1..2^24")
    if not 1 <= count < 1 << 31:
        raise ValueError(f"count {count} outside 1..2^31-1")
    if flat.numel() < count * lanes:
        raise ValueError(f"{count} values need {count * lanes} lanes, got "
                         f"{flat.numel()}")
    if _device_of(flat) == "cpu":
        return dict_build_plain(flat, lanes, count, lo_lane, rng)
    dev = flat.device
    check_tensor(flat, "flat", torch.int32, dev)
    small = dict_small_range()
    # one allocation: first (then the rank table), counter, dsize, order,
    # indices, and above the small range the flag scan's incl and sums
    scan = (0, 0) if rng <= small else (count, (count + 1023) // 1024)
    sizes = (rng, 1, 1, min(count, rng), count) + scan
    first, counter, dsize, order, indices, incl, sums = torch.empty(
        sum(sizes), dtype=torch.int32, device=dev).split(sizes)
    launch("dict_build", flat.data_ptr(), lanes, count, lo_lane, rng, small,
           first.data_ptr(), counter.data_ptr(), incl.data_ptr(),
           sums.data_ptr(), dsize.data_ptr(), order.data_ptr(),
           indices.data_ptr(), stream_of(order))
    count_launch(dict_build)
    n_dict = int(dsize.item())
    return order[:n_dict], n_dict, indices


dict_build.launches = 0


# ----------------------------------------------------------------------
# DeviceValues: the columnar write path's device column
# ----------------------------------------------------------------------

_VALUE_DTYPES = (np.dtype(np.int32), np.dtype(np.int64),
                 np.dtype(np.float32), np.dtype(np.float64))


class DeviceValues:
    """Device-resident fixed-width column values for
    ``FileWriter.write_columns``: the values stay on the device through
    validation and statistics (KE5), PLAIN, DELTA_BINARY_PACKED (KE3,
    KE1) and BYTE_STREAM_SPLIT (KE2) pages encode there, and only encoded
    bytes and two statistics cross to the host.  Small-range integer
    columns dictionary-encode through the device intern
    (:func:`device_dict_build`, KE4): the index stream crosses at 4 bytes
    a value, and the file matches the host path byte for byte.

    ``flat``: a 1-D int32 tensor of u32 lane words (the
    ``DeviceColumn.data`` layout: lanes interleaved little-endian,
    ``itemsize // 4`` words a value); ``dtype``: the logical dtype,
    int32, int64, float32 or float64.  Combine with ``column_encodings``
    to force DELTA_BINARY_PACKED or BYTE_STREAM_SPLIT."""

    __slots__ = ("flat", "dtype")

    def __init__(self, flat, dtype):
        self.dtype = np.dtype(dtype)
        if self.dtype not in _VALUE_DTYPES:
            raise TypeError(
                f"DeviceValues supports int32/int64/float32/float64, "
                f"got {self.dtype}")
        if not isinstance(flat, torch.Tensor) or flat.dtype != torch.int32 \
                or flat.dim() != 1:
            raise TypeError("flat must be a 1-D int32 tensor of u32 lane "
                            "words")
        self.flat = flat
        if flat.numel() % self.lanes:
            raise ValueError(
                f"lane array length {flat.numel()} not a multiple "
                f"of {self.lanes}")

    @property
    def lanes(self) -> int:
        return self.dtype.itemsize // 4

    @property
    def count(self) -> int:
        """Derived from the lane buffer (never stored)."""
        return self.flat.numel() // self.lanes

    def __len__(self) -> int:
        return self.count

    def to_numpy(self) -> np.ndarray:
        return self.flat.cpu().numpy().view(self.dtype)

    def min_max(self, unsigned: bool = False):
        """``(min, max)`` as numpy scalars of the storage dtype, computed
        on the device (KE5): NaN excluded, ``(None, None)`` when empty or
        all NaN; ``unsigned`` orders integers as u32/u64 and returns the
        signed-storage values."""
        order = ("float" if self.dtype.kind == "f"
                 else "unsigned" if unsigned else "signed")
        got = lanes_min_max(self.flat, self.lanes, order)
        if got is None:
            return None, None
        bits = np.array(got, dtype=np.uint32 if self.lanes == 1
                        else np.uint64)
        mn, mx = bits.view(self.dtype)
        return mn, mx

    def encode(self, ptype, encoding) -> bytes:
        """Encode one page's values on the device; returns the wire
        bytes."""
        from ..format.metadata import Encoding, Type
        from ..stats import current_stats

        st = current_stats()
        if st is not None:
            st.pages_device_encoded += 1
        if encoding == Encoding.PLAIN:
            # PLAIN little-endian values are the lane words' bytes
            return self.flat.cpu().numpy().tobytes()
        if encoding == Encoding.DELTA_BINARY_PACKED:
            return delta_encode_device(self.flat, self.count,
                                       is32=(ptype == Type.INT32))
        if encoding == Encoding.BYTE_STREAM_SPLIT:
            out = bss_encode_device(self.flat, self.count,
                                    self.dtype.itemsize, self.lanes)
            return out.cpu().numpy().tobytes()
        raise ValueError(
            f"DeviceValues cannot encode {encoding!r}; supported: PLAIN, "
            "DELTA_BINARY_PACKED, BYTE_STREAM_SPLIT")


def device_dict_build(dv: DeviceValues):
    """Device-side dictionary of a small-range integer
    :class:`DeviceValues`: the range table, first-occurrence order and
    per-value indices compute on the device (KE5, KE4), and only the
    order table and, on request, the int32 index stream cross to the
    host.

    Returns ``(dictionary ndarray, pull)`` where ``pull()`` fetches the
    index stream — deferred so the caller's dictionary-size gates run
    before the only per-value transfer — or None when the range gate
    rejects (``hi - lo + 1 > 4 n`` or ``> 2^24``, the host interner's
    gate) or the column is empty or floating.  The order is the host
    interner's first-occurrence order, so small-range columns write
    byte-identical files.  A known divergence from the host path, kept
    from the JAX package: wide-range columns of few distinct values
    (which the host's ``np.unique`` still dictionary-encodes) stay on the
    non-dictionary encodes."""
    if dv.dtype.kind != "i":
        return None
    n = dv.count
    if n == 0:
        return None
    lo, hi = dv.min_max()
    rng = int(hi) - int(lo) + 1  # Python ints: no wraparound
    if rng > 4 * n or rng > 1 << 24:
        return None
    # (value - lo) < 2^24 is exact in the low lane's u32 wraparound, so
    # the high lane of int64 values never takes part
    order, _, indices = dict_build(dv.flat, dv.lanes, n,
                                   int(lo) & 0xFFFFFFFF, rng)
    dictionary = (order.cpu().numpy().astype(np.int64) + int(lo)).astype(
        dv.dtype)
    return dictionary, lambda: indices.cpu().numpy()
