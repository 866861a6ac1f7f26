"""K8: snappy block decompression on the device.

The port of ``tpuparquet/kernels/snappy.py``.  Two passes: the host C
scanner (:func:`~tpuparquet_torch.compress.snappy_scan_tokens`) parses
the tag stream into a token table plus the concatenated literal bytes —
O(#tokens) host work, no output materialised — and the device resolves
the copies in parallel (``csrc/snappy_expand.cu``).  Each output byte
links to a literal byte or to a strictly earlier output byte, so
overlapping copies form chains; the kernel resolves them tile by tile in
shared memory, then only the chains that leave their tile, for as many
rounds as the data needs, and writes the bytes (:func:`expand_tokens`)
or little-endian u32 words from a byte offset
(:func:`expand_tokens_words`, which replaces the JAX package's
``u8_to_u32_words(_at)`` pass) straight from each tile.  The plain
version keeps the reference's design: a token search per byte,
``steps`` rounds of pointer doubling ``m = m[m]``, one gather.

Only tokens and literals cross to the device, never the decompressed
block.
"""

from __future__ import annotations

import numpy as np
import torch

from ..compress import snappy_scan_tokens
from ._lib import check_tensor, count_launch, launch, stream_of
from .decode import bucket, u8_to_u32_words_at

__all__ = ["decompress_device", "expand_tokens", "expand_tokens_plain",
           "expand_tokens_words", "expand_tokens_words_plain",
           "plan_tokens", "cuda_launches"]


def plan_tokens(block, expected_size: int | None = None):
    """Scan and pad one block's token tables.

    Returns ``(te, ts, lp, out_cap, steps, out_len)`` — int32 token ends
    and sources, u8 literals, each bucket-padded (padding tokens: ends =
    ``out_cap``, so they are never selected, and sources = -1, which
    resolves to literal 0) — or None when the int32 tables would
    wrap."""
    tok_end, tok_src, lits, out_len = snappy_scan_tokens(block)
    if expected_size is not None and out_len != expected_size:
        raise ValueError(
            f"snappy: header size {out_len} != expected {expected_size}")
    out_cap = bucket(out_len)
    if out_cap >= 1 << 31:
        return None
    T = bucket(len(tok_end))
    te = np.full(T, out_cap, dtype=np.int32)
    te[: len(tok_end)] = tok_end
    ts = np.full(T, -1, dtype=np.int32)
    ts[: len(tok_src)] = tok_src
    lp = np.zeros(bucket(max(len(lits), 1)), dtype=np.uint8)
    lp[: len(lits)] = lits
    # every round at least doubles the resolved length of each chain
    steps = max(int(np.ceil(np.log2(max(out_len, 2)))), 1)
    return te, ts, lp, out_cap, steps, out_len


def _resolved_map(te, ts, out_cap: int, steps: int) -> torch.Tensor:
    """Plain PyTorch passes 1-3: each output byte's literal root as
    ``-(literal index) - 1`` (int32, wrapping as the reference's)."""
    i = torch.arange(out_cap, dtype=torch.int32, device=te.device)
    t = torch.clamp(torch.searchsorted(te, i, right=True),
                    max=te.numel() - 1)
    start = torch.where(t > 0, te[torch.clamp(t - 1, min=0)],
                        torch.zeros_like(i))
    within = i - start
    src = ts[t]
    m = torch.where(src < 0, src - within, src + within)
    for _ in range(steps):
        nxt = m[torch.clamp(m, 0, out_cap - 1).to(torch.int64)]
        m = torch.where(m >= 0, nxt, m)
    return m


def _gather_lits(m, lits) -> torch.Tensor:
    idx = torch.clamp(-(m.to(torch.int64) + 1), 0, lits.numel() - 1)
    return lits[idx]


def expand_tokens_plain(te, ts, lits, out_cap: int,
                        steps: int) -> torch.Tensor:
    """Plain PyTorch version of :func:`expand_tokens`."""
    return _gather_lits(_resolved_map(te, ts, out_cap, steps), lits)


def expand_tokens_words_plain(te, ts, lits, out_cap: int, steps: int,
                              off: int, n_words: int) -> torch.Tensor:
    """Plain PyTorch version of :func:`expand_tokens_words`."""
    return u8_to_u32_words_at(expand_tokens_plain(te, ts, lits, out_cap,
                                                  steps), off, n_words)


def _check_tables(te, ts, lits, out_cap: int) -> None:
    if te.numel() < 1 or te.numel() != ts.numel() or lits.numel() < 1:
        raise ValueError("token tables must hold >= 1 token and >= 1 "
                         "literal byte, with as many sources as ends")
    if not 0 <= out_cap < 1 << 31:
        raise ValueError(f"out_cap {out_cap} out of the int32 range")


# csrc/snappy_expand.cu: output positions a tile kernel block resolves
TILE = 16384


def cuda_launches(end: int) -> int:
    """CUDA launches of one K8 call that resolves ``end`` output
    positions (``out_cap`` for a blob, ``off + 4 * n_words`` for words):
    the tile kernel, and past one tile a memset, the rounds (one
    cooperative launch) and the fix-up."""
    tiles = -(-end // TILE)
    return 4 if tiles > 1 else int(tiles > 0)


def _launch(te, ts, lits, out_cap, off, n_words, out):
    dev = te.device
    check_tensor(te, "te", torch.int32, dev)
    check_tensor(ts, "ts", torch.int32, dev)
    check_tensor(lits, "lits", torch.uint8, dev)
    end = out_cap if n_words < 0 else off + 4 * n_words
    lk = torch.empty(max(end, 1), dtype=torch.int32, device=dev)
    bits = torch.empty(4 * (-(-end // 32)) + 32, dtype=torch.int32,
                       device=dev)
    head = torch.empty(max(off, 1), dtype=torch.uint8, device=dev)
    launch("snappy_expand", te.data_ptr(), ts.data_ptr(), te.numel(),
           lits.data_ptr(), lits.numel(), out_cap, off, n_words,
           out.data_ptr(), lk.data_ptr(), bits.data_ptr(), head.data_ptr(),
           stream_of(out))
    count_launch(expand_tokens)
    return out


def expand_tokens(te: torch.Tensor, ts: torch.Tensor, lits: torch.Tensor,
                  out_cap: int, steps: int) -> torch.Tensor:
    """Resolve a token plan into the ``(out_cap,)`` u8 block (the caller
    slices to the real length; the tail past it holds what the clamps
    give, as in the JAX package).  CUDA tensors launch K8, which resolves
    every chain to its literal whatever ``steps`` says: the same bytes as
    the plain version's ``steps`` rounds whenever those cover the longest
    chain, as they do for every table :func:`plan_tokens` and the
    DELTA_BYTE_ARRAY planner make.  CPU tensors take the plain
    version."""
    _check_tables(te, ts, lits, out_cap)
    if te.device.type == "cpu":
        return expand_tokens_plain(te, ts, lits, out_cap, steps)
    if te.device.type != "cuda":
        raise ValueError(f"unsupported device {te.device}")
    out = torch.empty(out_cap, dtype=torch.uint8, device=te.device)
    return _launch(te, ts, lits, out_cap, 0, -1, out)


def expand_tokens_words(te: torch.Tensor, ts: torch.Tensor,
                        lits: torch.Tensor, out_cap: int, steps: int,
                        off: int, n_words: int) -> torch.Tensor:
    """Resolve a token plan straight into ``n_words`` little-endian u32
    words (an int32 tensor) read from byte ``off`` of the block (any
    offset: a V1 page's values follow its level bytes).  CUDA tensors
    launch K8; CPU tensors take the plain version."""
    _check_tables(te, ts, lits, out_cap)
    if off < 0 or n_words < 0 or off + 4 * n_words > out_cap:
        raise ValueError(f"{n_words} words at byte {off} overrun the "
                         f"{out_cap}-byte block")
    if te.device.type == "cpu":
        return expand_tokens_words_plain(te, ts, lits, out_cap, steps, off,
                                         n_words)
    if te.device.type != "cuda":
        raise ValueError(f"unsupported device {te.device}")
    out = torch.empty(n_words, dtype=torch.int32, device=te.device)
    return _launch(te, ts, lits, out_cap, off, n_words, out)


expand_tokens.launches = 0


def decompress_device(block, expected_size: int | None = None,
                      device=None) -> torch.Tensor:
    """Decompress one snappy block into a u8 tensor on ``device`` (default:
    the current CUDA device; raises when there is none — pass
    ``device="cpu"`` for the plain version)."""
    from .device import _resolve_device

    dev = _resolve_device(device)
    plan = plan_tokens(block, expected_size)
    if plan is None:
        raise ValueError("device snappy: block too large for int32 tables")
    te, ts, lp, out_cap, steps, out_len = plan
    if out_len == 0:
        return torch.zeros(0, dtype=torch.uint8, device=dev)
    te_d, ts_d, lp_d = (torch.from_numpy(a).to(dev) for a in (te, ts, lp))
    return expand_tokens(te_d, ts_d, lp_d, out_cap, steps)[:out_len]
