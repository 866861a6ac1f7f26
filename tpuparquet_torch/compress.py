"""Block codecs of the read and write path: UNCOMPRESSED, SNAPPY, GZIP,
ZSTD and LZ4_RAW.

SNAPPY and LZ4_RAW run in C (``csrc/snappy.c``, ``csrc/lz4raw.c``),
compiled with the host C compiler at first use and loaded with ctypes;
the snappy library also scans a block's tags into the token tables of
the device decompressor (:func:`snappy_scan_tokens`).  Neither has a
pure-Python mirror: without a compiler, SNAPPY and LZ4_RAW raise, and
``TPQ_NATIVE_CODECS=0`` does not move them.  (The JAX package's mirrors
write the same bytes as its C codecs, so files are the same either way.)
The reference's block helpers are here as well: :func:`lz4_compress`,
:func:`lz4_decompress` and :func:`snappy_decompress` run the C codecs,
:func:`snappy_parse_tokens` is the reference's op-list parser, and
:func:`snappy_compress` its greedy encoder, kept byte for byte: the C
encoder that pages go through makes other (equally valid) token choices.

GZIP and ZSTD bind the system libz and libzstd (``syslibs.py``), with
the stdlib ``zlib`` module and the optional ``zstandard`` wheel as
fallbacks; ``TPQ_NATIVE_CODECS=0`` (read per call) puts both on their
fallbacks.  ``TPQ_ZSTD_LEVEL`` sets the ZSTD level (default 1).  LZO,
BROTLI and Hadoop-framed LZ4 raise :class:`NotImplementedError` naming
the codec.

A process-wide registry maps each codec to its :class:`BlockCompressor`
(the reference's extension hook, ``register_block_compressor``): the five
above are registered at import as built-ins.  A compressor a user
registers on a codec id takes every block of that codec, on both sides,
and the native page path (``io/pages.py``) then gives way to the pure
one (:func:`page_codec_settings`, :func:`builtin_uncompressed_registered`).

Corrupt input raises :class:`CompressionError`, a ValueError, in the
reference's words (``snappy: bad size header``, ``snappy: header size N
!= expected M``, ``snappy: corrupt block (rc=-1)``).  The read
path decompresses into a slab of its arena (:func:`decompress_block`);
a ZSTD body of two or more frames whose content sizes are recorded
decodes one frame a worker and counts ``codec_split_frames``.  The write
path compresses each data page with :func:`page_compress`, which splits
a GZIP or ZSTD body of at least two ``TPQ_COMPRESS_BLOCK_KB`` blocks
into independently compressed members or frames (counted in
``codec_split_blocks``) when the caller holds more than one worker and
the system library is loaded: the same decoded bytes, and the same file
bytes as the JAX package's writer, whose native page path splits under
the same conditions.
"""

from __future__ import annotations

import ctypes
import io
import os
import shutil
import threading
import zlib
from concurrent.futures import ThreadPoolExecutor

import numpy as np

from .errors import KernelBuildError
from .format.metadata import CompressionCodec
from .stats import current_stats
from .syslibs import zlib_native, zstd_native
from .varint import read_uvarint, write_uvarint

__all__ = ["BlockCompressor", "CompressionError",
           "builtin_uncompressed_registered", "compress_block",
           "decompress_block", "get_block_compressor",
           "native_codecs_enabled", "page_codec_settings", "page_compress",
           "page_compress_bound", "page_compress_into",
           "register_block_compressor", "registered_codecs",
           "snappy_scan_tokens", "snappy_single_literal_view",
           "snappy_compress", "snappy_decompress", "snappy_parse_tokens",
           "lz4_compress", "lz4_decompress"]

# the format's shortest copy; the JAX package's writer uses the same
# floor, which keeps numeric pages' 4..7-byte matches
_MIN_MATCH = 4

_SUPPORTED = (CompressionCodec.UNCOMPRESSED, CompressionCodec.SNAPPY,
              CompressionCodec.GZIP, CompressionCodec.ZSTD,
              CompressionCodec.LZ4_RAW)


class CompressionError(ValueError):
    """A block that does not decode, or decodes to another size than its
    header says."""


class BlockCompressor:
    """One whole-block codec; a subclass implements both directions on
    ``bytes``."""

    def compress_block(self, block: bytes) -> bytes:
        raise NotImplementedError

    def decompress_block(self, block: bytes, decompressed_size: int) -> bytes:
        raise NotImplementedError


class _Builtin(BlockCompressor):
    """A built-in codec's registry slot: this module's C and
    system-library paths."""

    def __init__(self, codec: CompressionCodec):
        self.codec = codec

    def compress_block(self, block: bytes) -> bytes:
        return compress_block(self.codec, block)

    def decompress_block(self, block: bytes, decompressed_size: int) -> bytes:
        return decompress_block(self.codec, block,
                                decompressed_size).tobytes()


_registry: dict[int, BlockCompressor] = {int(c): _Builtin(c)
                                         for c in _SUPPORTED}
_registry_lock = threading.Lock()


def register_block_compressor(codec: CompressionCodec,
                              c: BlockCompressor) -> None:
    """Register ``c`` on ``codec``: every block of that codec, read or
    written, then goes through it."""
    with _registry_lock:
        _registry[int(codec)] = c


def get_block_compressor(codec: CompressionCodec) -> BlockCompressor:
    with _registry_lock:
        c = _registry.get(int(codec))
    if c is None:
        raise CompressionError(
            f"compression codec {CompressionCodec(codec).name} is not "
            "registered (register_block_compressor to plug one in)")
    return c


def registered_codecs() -> list[CompressionCodec]:
    with _registry_lock:
        return [CompressionCodec(k) for k in sorted(_registry)]


def _user_compressor(codec) -> BlockCompressor | None:
    """The compressor a user registered on ``codec``, or None while the
    slot holds the built-in (or nothing)."""
    with _registry_lock:
        c = _registry.get(int(codec))
    return None if c is None or type(c) is _Builtin else c


def builtin_uncompressed_registered() -> bool:
    """True while the UNCOMPRESSED slot holds the built-in pass-through,
    the condition for the native page path to skip compression; a
    transform a user registered there keeps control of the bytes."""
    return _user_compressor(CompressionCodec.UNCOMPRESSED) is None


def native_codecs_enabled() -> bool:
    """False under ``TPQ_NATIVE_CODECS=0``: GZIP takes the stdlib module
    and ZSTD the ``zstandard`` wheel.  Read per call."""
    return os.environ.get("TPQ_NATIVE_CODECS", "1") != "0"


def _zstd_level() -> int:
    try:
        return int(os.environ.get("TPQ_ZSTD_LEVEL", "1"))
    except ValueError:
        return 1


_lock = threading.Lock()
_libs: dict = {}


def _c_codec(stem: str):
    """The loaded C codec ``csrc/<stem>.c`` (built on first call)."""
    with _lock:
        lib = _libs.get(stem)
        if lib is None:
            from ._build import CSRC, build

            cc = shutil.which("cc") or shutil.which("gcc")
            if cc is None:
                raise KernelBuildError(
                    f"csrc/{stem}.c needs a C compiler to build")
            (path,) = build([(CSRC / f"{stem}.c",
                              [cc, "-O3", "-shared", "-fPIC"])])
            lib = _libs[stem] = _bind(stem, ctypes.CDLL(str(path)))
        return lib


def _bind(stem: str, lib):
    size_t_p = ctypes.POINTER(ctypes.c_size_t)
    io_args = [ctypes.c_void_p, ctypes.c_size_t, ctypes.c_void_p,
               ctypes.c_size_t, size_t_p]
    if stem == "lz4raw":
        for fn in (lib.tpq_lz4_compress, lib.tpq_lz4_decompress):
            fn.restype = ctypes.c_int
            fn.argtypes = io_args
        lib.tpq_lz4_max_compressed_length.restype = ctypes.c_uint64
        lib.tpq_lz4_max_compressed_length.argtypes = [ctypes.c_uint64]
        return lib
    lib.tpq_snappy_decompress.restype = ctypes.c_int
    lib.tpq_snappy_decompress.argtypes = io_args
    lib.tpq_snappy_compress_opt.restype = ctypes.c_int
    lib.tpq_snappy_compress_opt.argtypes = io_args + [ctypes.c_int]
    lib.tpq_snappy_max_compressed_length.restype = ctypes.c_uint64
    lib.tpq_snappy_max_compressed_length.argtypes = [ctypes.c_uint64]
    lib.tpq_snappy_uncompressed_length.restype = ctypes.c_int
    lib.tpq_snappy_uncompressed_length.argtypes = [
        ctypes.c_void_p, ctypes.c_size_t, ctypes.POINTER(ctypes.c_uint64)]
    lib.tpq_snappy_scan_tokens.restype = ctypes.c_int
    lib.tpq_snappy_scan_tokens.argtypes = [
        ctypes.c_void_p, ctypes.c_size_t, ctypes.c_void_p,
        ctypes.c_void_p, ctypes.c_int64, ctypes.c_void_p,
        ctypes.c_size_t, ctypes.POINTER(ctypes.c_int64), size_t_p,
        ctypes.POINTER(ctypes.c_uint64)]
    return lib


def _snappy():
    """The loaded snappy library (built on first call)."""
    return _c_codec("snappy")


def _lz4():
    """The loaded LZ4_RAW library (built on first call)."""
    return _c_codec("lz4raw")


class _Wheel(threading.local):
    """The ``zstandard`` wheel's contexts, one pair a thread (they may
    not be shared by concurrent calls)."""

    level = None


_wheel_ctx = _Wheel()


def _zstd_wheel(level: int):
    """This thread's ``(compressor, decompressor)`` at ``level``; raises
    CompressionError when the wheel is not installed."""
    try:
        import zstandard
    except ImportError:
        raise CompressionError(
            "zstd: the system libzstd is not in use (none loaded, or "
            "TPQ_NATIVE_CODECS=0) and the zstandard wheel is not "
            "installed") from None
    if _wheel_ctx.level != level:
        _wheel_ctx.c = zstandard.ZstdCompressor(level=level)
        _wheel_ctx.d = zstandard.ZstdDecompressor()
        _wheel_ctx.level = level
    return _wheel_ctx.c, _wheel_ctx.d


def _native_zlib():
    return zlib_native() if native_codecs_enabled() else None


def _native_zstd():
    return zstd_native() if native_codecs_enabled() else None


def _u8(data) -> np.ndarray:
    if isinstance(data, np.ndarray):
        return np.ascontiguousarray(data.reshape(-1).view(np.uint8))
    return np.frombuffer(data, dtype=np.uint8)


def _check_codec(codec) -> CompressionCodec:
    codec = CompressionCodec(codec)
    if codec not in _SUPPORTED:
        raise NotImplementedError(
            f"codec {codec.name} is not supported by tpuparquet_torch "
            "(UNCOMPRESSED, SNAPPY, GZIP, ZSTD and LZ4_RAW only)")
    return codec


def _check_size(got: int, want: int) -> None:
    if got != want:
        raise CompressionError(
            f"decompressed size {got} != expected {want}")


_affinity_workers: int | None = None


def _decode_budget() -> int:
    """Workers for frame-parallel decompression: the calling thread's
    share under an active serve arbiter (``serve/arbiter.py``), else the
    process's usable CPUs."""
    global _affinity_workers
    from .serve.arbiter import plan_budget

    share = plan_budget()
    if share is not None:
        return share
    if _affinity_workers is None:
        try:
            _affinity_workers = len(os.sched_getaffinity(0)) or 1
        except (AttributeError, OSError):
            _affinity_workers = os.cpu_count() or 1
    return _affinity_workers


def _zstd_decompress_frames(nat, src, size: int, out, workers: int):
    """Decode a stream of two or more frames with recorded content sizes
    one frame a worker; returns the produced length, or None for a
    stream of one frame or of unrecorded sizes (the caller one-shots
    it)."""
    if workers <= 1:
        return None
    try:
        spans = nat.frame_spans(src)
    except ValueError as e:
        raise CompressionError(str(e)) from None
    if spans is None or len(spans) < 2:
        return None
    _check_size(sum(s[2] for s in spans), size)
    dst = np.cumsum([0] + [s[2] for s in spans])

    def one(i):
        off, clen, ulen = spans[i]
        return nat.decompress_into(src[off:off + clen],
                                   out[dst[i]:dst[i] + ulen], ulen)

    with ThreadPoolExecutor(max_workers=min(workers, len(spans))) as ex:
        try:
            list(ex.map(one, range(len(spans))))
        except ValueError as e:
            raise CompressionError(str(e)) from None
    st = current_stats()
    if st is not None:
        st.codec_split_frames += len(spans)
    return size


def _gzip_stdlib(src: np.ndarray) -> bytes:
    """Inflate every member of a gzip stream with the stdlib module."""
    parts = []
    buf = src.tobytes()
    try:
        while buf:
            d = zlib.decompressobj(wbits=16 + zlib.MAX_WBITS)
            parts.append(d.decompress(buf))
            if not d.eof:
                raise CompressionError("gzip: truncated member")
            buf = d.unused_data
    except zlib.error as e:
        raise CompressionError(f"gzip: {e}") from None
    return b"".join(parts)


def _zstd_wheel_decompress(src: np.ndarray, size: int) -> bytes:
    """ZSTD through the wheel.  Its one-shot call stops after the first
    frame, so a body of several frames (the write side's split) is read
    again as a stream across frames.  (The JAX package streams only when
    the one-shot call raises, so it refuses a split body on this path.)"""
    _, d = _zstd_wheel(_zstd_level())
    try:
        got = d.decompress(src, max_output_size=size)
        if len(got) == size:
            return got
        with d.stream_reader(io.BytesIO(src.tobytes()),
                             read_across_frames=True) as r:
            return r.read(size + 1)
    except Exception as e:  # the wheel raises its own ZstdError
        raise CompressionError(f"zstd: {e}") from None


def _slab(arena, n: int) -> np.ndarray:
    # 16 bytes of slack let the C decoders use fixed-width copies
    return (np.empty(n + 16, dtype=np.uint8) if arena is None
            else arena.borrow(n + 16))


def decompress_block(codec, payload, uncompressed_size: int,
                     arena=None, workers: int | None = None) -> np.ndarray:
    """Decompress one page body to a u8 array of exactly
    ``uncompressed_size`` bytes; raises :class:`CompressionError` on
    corrupt input.  With ``arena`` (a
    :class:`~tpuparquet_torch.kernels.arena.HostArena`) a block that a C
    or system library decodes lands in a slab borrowed from it, valid
    until the arena's ``release_all``; else in a fresh array.
    ``workers`` bounds the frame-parallel decode of a multi-frame ZSTD
    body (None: the usable CPUs)."""
    src = _u8(payload)
    if uncompressed_size is None or uncompressed_size < 0:
        raise CompressionError("missing decompressed size")
    user = _user_compressor(codec)
    if user is not None:
        got = bytes(user.decompress_block(src.tobytes(), uncompressed_size))
        _check_size(len(got), uncompressed_size)
        return np.frombuffer(got, dtype=np.uint8)
    codec = _check_codec(codec)
    if codec == CompressionCodec.UNCOMPRESSED:
        _check_size(src.size, uncompressed_size)
        return src
    if codec == CompressionCodec.SNAPPY:
        lib = _snappy()
        _snappy_header(lib, src, uncompressed_size)
        out = _slab(arena, uncompressed_size)
        produced = ctypes.c_size_t(0)
        rc = lib.tpq_snappy_decompress(src.ctypes.data, src.size,
                                       out.ctypes.data, out.size,
                                       ctypes.byref(produced))
        if rc != 0:
            raise CompressionError(f"snappy: corrupt block (rc={rc})")
        _check_size(produced.value, uncompressed_size)
        return out[:uncompressed_size]
    if codec == CompressionCodec.LZ4_RAW:
        out = _slab(arena, uncompressed_size)
        produced = ctypes.c_size_t(0)
        rc = _lz4().tpq_lz4_decompress(src.ctypes.data, src.size,
                                       out.ctypes.data, uncompressed_size,
                                       ctypes.byref(produced))
        if rc != 0:
            raise CompressionError(f"lz4: corrupt block (rc={rc})")
        if produced.value != uncompressed_size:
            raise CompressionError(
                f"lz4: stream produced {produced.value} bytes, expected "
                f"{uncompressed_size}")
        return out[:uncompressed_size]
    gzip = codec == CompressionCodec.GZIP
    nat = _native_zlib() if gzip else _native_zstd()
    if nat is None:
        got = (_gzip_stdlib(src) if gzip
               else _zstd_wheel_decompress(src, uncompressed_size))
        _check_size(len(got), uncompressed_size)
        return np.frombuffer(got, dtype=np.uint8)
    out = _slab(arena, uncompressed_size)
    got = None
    if not gzip:
        got = _zstd_decompress_frames(
            nat, src, uncompressed_size, out,
            _decode_budget() if workers is None else workers)
    if got is None:
        try:
            got = nat.decompress_into(src, out, uncompressed_size)
        except ValueError as e:
            raise CompressionError(str(e)) from None
    _check_size(got, uncompressed_size)
    return out[:uncompressed_size]


def _snappy_header(lib, src: np.ndarray, expected: int) -> None:
    """Check a snappy block's varint size header against the page's
    size before decoding, in the reference's words (a single-literal
    block's mismatch is worded as the reference's zero-copy view words
    it)."""
    total = ctypes.c_uint64()
    if lib.tpq_snappy_uncompressed_length(src.ctypes.data, src.size,
                                          ctypes.byref(total)) != 0:
        raise CompressionError("snappy: bad size header")
    if total.value != expected:
        view = snappy_single_literal_view(src)
        if view is not None:
            _check_size(view.size, expected)
        raise CompressionError(
            f"snappy: header size {total.value} != expected {expected}")


def snappy_scan_tokens(block):
    """Parse a snappy block's tag stream without decompressing it:
    ``(tok_out_end, tok_src, literals, out_len)``.  Token ``i`` covers
    output bytes ``[tok_out_end[i-1], tok_out_end[i])``; ``tok_src[i]``
    is ``-(literal offset + 1)`` for a literal, else the output position
    its copy reads from.  Raises CompressionError on a corrupt block."""
    lib = _snappy()
    buf = _u8(block)
    cap = max(buf.size, 1)  # every token takes at least one input byte
    tok_end = np.empty(cap, dtype=np.int64)
    tok_src = np.empty(cap, dtype=np.int64)
    lits = np.empty(cap, dtype=np.uint8)
    n_tok = ctypes.c_int64()
    lit_len = ctypes.c_size_t()
    out_len = ctypes.c_uint64()
    rc = lib.tpq_snappy_scan_tokens(
        buf.ctypes.data, buf.size, tok_end.ctypes.data, tok_src.ctypes.data,
        cap, lits.ctypes.data, lits.size, ctypes.byref(n_tok),
        ctypes.byref(lit_len), ctypes.byref(out_len))
    if rc != 0:
        raise CompressionError(f"snappy: corrupt block (rc={rc})")
    t = int(n_tok.value)
    return (tok_end[:t], tok_src[:t], lits[: lit_len.value],
            int(out_len.value))


def snappy_single_literal_view(block) -> np.ndarray | None:
    """The payload of a snappy block that is one literal token covering
    the whole block (an incompressible page: the payload IS the
    decompressed bytes), as a zero-copy view; None for any other
    block."""
    buf = _u8(block)
    try:
        total, pos = read_uvarint(buf, 0)
    except ValueError:
        return None
    if pos >= buf.size:
        return None
    tag = int(buf[pos])
    pos += 1
    if tag & 3:
        return None  # first token is a copy
    ln = tag >> 2
    if ln >= 60:
        extra = ln - 59
        if pos + extra > buf.size:
            return None
        ln = 0
        for i in range(extra):
            ln |= int(buf[pos + i]) << (8 * i)
        pos += extra
    ln += 1
    if ln != total or pos + ln != buf.size:
        return None  # not a single literal covering the whole block
    return buf[pos : pos + ln]


def snappy_parse_tokens(block: bytes):
    """Parse a snappy block into ``(total_len, ops)``, as the reference
    does: ``ops`` is a list of ``(dst, length, src)`` triples, ``src >=
    0`` a copy from absolute output offset ``src`` and ``src < 0`` a
    literal whose bytes start at input position ``-1 - src``."""
    try:
        total, pos = read_uvarint(block, pos=0)
    except ValueError as e:
        raise CompressionError(f"snappy: bad size header: {e}") from None
    n = len(block)
    ops = []
    out_pos = 0
    while pos < n:
        tag = block[pos]
        kind = tag & 3
        pos += 1
        if kind == 0:  # literal
            ln = tag >> 2
            if ln >= 60:
                extra = ln - 59
                if pos + extra > n:
                    raise CompressionError("snappy: truncated literal length")
                ln = int.from_bytes(block[pos : pos + extra], "little")
                pos += extra
            ln += 1
            if pos + ln > n:
                raise CompressionError("snappy: literal overruns input")
            ops.append((out_pos, ln, -1 - pos))
            pos += ln
            out_pos += ln
            continue
        if kind == 1:  # copy with 1-byte offset extension
            if pos >= n:
                raise CompressionError("snappy: truncated copy-1")
            ln = ((tag >> 2) & 0x7) + 4
            off = ((tag >> 5) << 8) | block[pos]
            pos += 1
        elif kind == 2:  # 2-byte offset
            if pos + 2 > n:
                raise CompressionError("snappy: truncated copy-2")
            ln = (tag >> 2) + 1
            off = int.from_bytes(block[pos : pos + 2], "little")
            pos += 2
        else:  # 4-byte offset
            if pos + 4 > n:
                raise CompressionError("snappy: truncated copy-4")
            ln = (tag >> 2) + 1
            off = int.from_bytes(block[pos : pos + 4], "little")
            pos += 4
        if off == 0 or off > out_pos:
            raise CompressionError(
                f"snappy: copy offset {off} out of range at output {out_pos}"
            )
        ops.append((out_pos, ln, out_pos - off))
        out_pos += ln
    if out_pos != total:
        raise CompressionError(
            f"snappy: stream produced {out_pos} bytes, header says {total}"
        )
    return total, ops


def snappy_decompress(block: bytes, expected_size: int | None = None) -> bytes:
    """A snappy block decoded by the C codec; ``expected_size`` (None:
    the block's own header) must match the header."""
    src = _u8(block)
    if expected_size is None:
        total = ctypes.c_uint64()
        if _snappy().tpq_snappy_uncompressed_length(
                src.ctypes.data, src.size, ctypes.byref(total)) != 0:
            raise CompressionError("snappy: bad size header")
        expected_size = int(total.value)
    return decompress_block(CompressionCodec.SNAPPY, src,
                            expected_size).tobytes()


def _emit_literal(out: bytearray, data, lo: int, hi: int) -> None:
    # one token per literal stretch, however long (the tag takes up to 4
    # length bytes), as the reference's encoder emits it
    n = hi - lo
    if n <= 0:
        return
    ln = n - 1
    if ln < 60:
        out.append(ln << 2)
    elif ln < 256:
        out.append(60 << 2)
        out.append(ln)
    elif ln < 65536:
        out.append(61 << 2)
        out += ln.to_bytes(2, "little")
    elif ln < 1 << 24:
        out.append(62 << 2)
        out += ln.to_bytes(3, "little")
    else:
        out.append(63 << 2)
        out += ln.to_bytes(4, "little")
    out += data[lo:hi]


def _emit_copy(out: bytearray, offset: int, ln: int) -> None:
    # 2-byte-offset copies (tag 0b10) cover offset <= 65535, len 1..64
    off = offset.to_bytes(2, "little")
    while ln > 64:
        out.append((63 << 2) | 2)
        out += off
        ln -= 64
    out.append(((ln - 1) << 2) | 2)
    out += off


def snappy_compress(data: bytes, min_match: int = 4) -> bytes:
    """The reference's greedy hash-match snappy encoder (golang-snappy
    style, with the miss-skip acceleration), byte for byte; valid snappy
    that any decoder reads back.  ``min_match`` (at least 4) is the
    shortest back-reference it emits."""
    data = bytes(data)
    n = len(data)
    min_match = max(min_match, 4)
    out = bytearray()
    write_uvarint(out, n)
    if n < 4:
        if n:
            _emit_literal(out, data, 0, n)
        return bytes(out)
    table: dict[int, int] = {}
    pos = 0
    lit_start = 0
    misses = 0
    while pos + 4 <= n:
        key = int.from_bytes(data[pos : pos + 4], "little")
        cand = table.get(key)
        table[key] = pos
        if cand is not None and pos - cand <= 65535:
            # the hit is exact: the key is the 4 bytes themselves
            length = 4
            limit = n - pos
            while (
                length < limit
                and data[cand + length] == data[pos + length]
            ):
                length += 1
            if length < min_match:
                misses += 1
                pos += 1 + (misses >> 5)
                continue
            _emit_literal(out, data, lit_start, pos)
            _emit_copy(out, pos - cand, length)
            pos += length
            lit_start = pos
            misses = 0
        else:
            misses += 1
            pos += 1 + (misses >> 5)  # faster through incompressible data
    _emit_literal(out, data, lit_start, n)
    return bytes(out)


def lz4_compress(data) -> bytes:
    """An LZ4 block by the C encoder (``csrc/lz4raw.c``), the
    reference's bytes; empty input is the one-zero-token block."""
    return _c_compress("lz4", _u8(bytes(data)))


def lz4_decompress(block, expected_size: int) -> bytes:
    """An LZ4 block decoded by the C codec to exactly ``expected_size``
    bytes; raises :class:`CompressionError` on a malformed stream."""
    return decompress_block(CompressionCodec.LZ4_RAW, block,
                            expected_size).tobytes()


def _c_bound(stem: str, n: int) -> int:
    """The C codec's worst-case output for ``n`` input bytes."""
    return int(_snappy().tpq_snappy_max_compressed_length(n)
               if stem == "snappy"
               else _lz4().tpq_lz4_max_compressed_length(n))


def _c_compress_into(stem: str, src, out: np.ndarray) -> int:
    """Compress ``src`` into the caller's u8 buffer (at least
    :func:`_c_bound` bytes) with the C codec; returns the produced
    length, with no intermediate buffer and no copy out."""
    src = _u8(src)
    if out.size < _c_bound(stem, src.size):
        raise CompressionError(f"{stem}: output buffer too small")
    produced = ctypes.c_size_t(0)
    args = (src.ctypes.data, src.size, out.ctypes.data, out.size,
            ctypes.byref(produced))
    rc = (_snappy().tpq_snappy_compress_opt(*args, _MIN_MATCH)
          if stem == "snappy" else _lz4().tpq_lz4_compress(*args))
    if rc != 0:
        raise CompressionError(f"{stem}: compress failed (rc={rc})")
    return int(produced.value)


def _c_compress(stem: str, src: np.ndarray) -> bytes:
    out = np.empty(_c_bound(stem, src.size), dtype=np.uint8)
    return out[:_c_compress_into(stem, src, out)].tobytes()


def compress_block(codec, data) -> bytes:
    """One block compressed whole by the compressor registered on
    ``codec``: the built-ins as the JAX package's registered codecs
    compress it."""
    src = _u8(data)
    user = _user_compressor(codec)
    if user is not None:
        return bytes(user.compress_block(src.tobytes()))
    codec = _check_codec(codec)
    if codec == CompressionCodec.UNCOMPRESSED:
        return src.tobytes()
    if codec == CompressionCodec.SNAPPY:
        return _c_compress("snappy", src)
    if codec == CompressionCodec.LZ4_RAW:
        return _c_compress("lz4raw", src)
    if codec == CompressionCodec.GZIP:
        nat = _native_zlib()
        if nat is not None:
            return nat.compress(src)
        co = zlib.compressobj(wbits=16 + zlib.MAX_WBITS)  # gzip framing
        return co.compress(src) + co.flush()
    level = _zstd_level()
    nat = _native_zstd()
    if nat is not None:
        return nat.compress(src, level)
    return _zstd_wheel(level)[0].compress(src)


# ----------------------------------------------------------------------
# Write side: the block-parallel split of a page body
# ----------------------------------------------------------------------

class PageCodecCtx:
    """A built-in codec's compression into a caller's buffer, for the
    native page path and the block split: a worst-case :meth:`bound` and
    a :meth:`compress_into`.  ``splittable`` marks the codecs whose frames
    concatenate (GZIP members, ZSTD frames), the ones the block split may
    cut."""

    __slots__ = ("codec", "splittable", "_bound", "_into")

    def __init__(self, codec, bound, into, splittable: bool = False):
        self.codec = codec
        self.splittable = splittable
        self._bound = bound
        self._into = into

    def bound(self, n: int) -> int:
        return self._bound(n)

    def compress_into(self, src, out) -> int:
        return self._into(src, out)


def page_codec_settings(codec) -> PageCodecCtx | None:
    """The compression context of ``codec`` for the native page path, as
    the reference hands it out: SNAPPY and LZ4_RAW in C, GZIP and ZSTD
    (splittable) through the loaded system library.  None for
    UNCOMPRESSED, under ``TPQ_NATIVE_CODECS=0``, with no system library,
    or when a user's compressor is registered on the codec (the page path
    then compresses through :func:`compress_block`)."""
    if not native_codecs_enabled() or _user_compressor(codec) is not None:
        return None
    if codec in (CompressionCodec.SNAPPY, CompressionCodec.LZ4_RAW):
        stem = "snappy" if codec == CompressionCodec.SNAPPY else "lz4raw"
        return PageCodecCtx(codec, lambda n: _c_bound(stem, n),
                            lambda src, out: _c_compress_into(stem, src,
                                                              out))
    if codec == CompressionCodec.GZIP:
        nat = _native_zlib()
        if nat is not None:
            return PageCodecCtx(codec, nat.compress_bound, nat.compress_into,
                                splittable=True)
    elif codec == CompressionCodec.ZSTD:
        nat = _native_zstd()
        if nat is not None:
            level = _zstd_level()
            return PageCodecCtx(
                codec, nat.compress_bound,
                lambda src, out: nat.compress_into(src, out, level),
                splittable=True)
    return None


def _split_block_bytes() -> int:
    """The split's block size (``TPQ_COMPRESS_BLOCK_KB``, default 1 MiB,
    at least 64 KiB)."""
    try:
        kb = int(os.environ.get("TPQ_COMPRESS_BLOCK_KB", "1024"))
    except ValueError:
        kb = 1024
    return max(64, kb) * 1024


def _splits(ctx: PageCodecCtx, n: int, workers: int) -> bool:
    return ctx.splittable and workers > 1 and n >= 2 * _split_block_bytes()


def page_compress_bound(ctx: PageCodecCtx, n: int, workers: int = 1) -> int:
    """Output capacity :func:`page_compress_into` needs: the frames'
    worst cases when the split engages, else the codec's bound."""
    block = _split_block_bytes()
    if not _splits(ctx, n, workers):
        return ctx.bound(n)
    nb = -(-n // block)
    return (nb - 1) * ctx.bound(block) + ctx.bound(n - (nb - 1) * block)


def page_compress_into(ctx: PageCodecCtx, src: np.ndarray, out: np.ndarray,
                       workers: int = 1) -> int:
    """Compress ``src`` into ``out`` (sized by :func:`page_compress_bound`)
    and return the produced length.  A body of at least two blocks with
    more than one worker compresses one block a worker into independent
    frames, compacted into one stream and counted in
    ``codec_split_blocks``; the frame boundaries depend only on
    ``TPQ_COMPRESS_BLOCK_KB``, so every worker count above one writes the
    same bytes, and one worker writes the single frame."""
    n = src.size
    if not _splits(ctx, n, workers):
        return ctx.compress_into(src, out)
    block = _split_block_bytes()
    nb = -(-n // block)
    offs = [0]
    for i in range(nb):
        offs.append(offs[-1] + ctx.bound(min(block, n - i * block)))

    def one(i):
        a = i * block
        return ctx.compress_into(src[a:min(n, a + block)],
                                 out[offs[i]:offs[i + 1]])

    with ThreadPoolExecutor(max_workers=min(workers, nb)) as ex:
        lens = list(ex.map(one, range(nb)))
    pos = lens[0]
    for i in range(1, nb):  # compact the frames down to one stream
        li = lens[i]
        if offs[i] != pos:
            out[pos:pos + li] = out[offs[i]:offs[i] + li].copy()
        pos += li
    st = current_stats()
    if st is not None:
        st.codec_split_blocks += nb
    return pos


def page_compress(codec, data, workers: int = 1) -> bytes:
    """A data page's body (V1) or values segment (V2) compressed: split
    into frames by :func:`page_compress_into` when ``workers > 1`` and
    the codec has a split context, else :func:`compress_block`."""
    ctx = page_codec_settings(codec) if workers > 1 else None
    if ctx is None or not ctx.splittable:
        return compress_block(codec, data)
    src = _u8(data)
    out = np.empty(page_compress_bound(ctx, src.size, workers),
                   dtype=np.uint8)
    try:
        return out[:page_compress_into(ctx, src, out, workers)].tobytes()
    except ValueError as e:
        raise CompressionError(str(e)) from None
