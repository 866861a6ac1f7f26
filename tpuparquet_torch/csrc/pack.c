/* LSB-first bit packing for the host planners and the writer.
 *
 * tpq_pack64 packs the delta-lane planner's min_delta-adjusted offsets
 * (kernels/device.py _plan_delta_lane_words); the numpy formulation
 * explodes every value into a byte-per-bit matrix, which made the
 * transport cost more host time than it saved wire.  tpq_delta_emit
 * writes the block body of a DELTA_BINARY_PACKED stream for the writer
 * (cpu/delta.py encode_delta_binary_packed).  tpq_hybrid_expand32
 * expands a hybrid run table on the host (cpu/hybrid.py expand_scan) and
 * tpq_hybrid_repack re-packs one as a single bit-packed run without the
 * expanded intermediate (kernels/hybrid.py plan_stream_args): on a
 * def-level stream of many short runs those were the planner's hottest
 * numpy passes.  tpq_hybrid_encode writes a hybrid stream of u64 values
 * (cpu/hybrid.py encode_hybrid past the u32 fast path of hybrid.c).
 *
 * The writers keep a u64 accumulator and flush whole 64-bit words
 * (one unaligned store per 64 output bits); at most one value straddles
 * a flush, recovered with a single shift.
 */

#include <stddef.h>
#include <stdint.h>
#include <string.h>

/* Pack count width-bit values (already known to fit) LSB-first at out,
 * which must have 8 bytes of slack past the exact (count*width + 7)/8
 * payload.  Returns the exact payload length. */
static inline long long pack_words(const uint64_t *v, long long count,
                                   int width, uint8_t *out) {
    uint64_t acc = 0;
    int nbits = 0;
    long long o = 0;
    for (long long i = 0; i < count; i++) {
        acc |= nbits < 64 ? v[i] << nbits : 0;
        nbits += width;
        if (nbits >= 64) {
            __builtin_memcpy(out + o, &acc, 8);
            o += 8;
            nbits -= 64;
            /* bits of v[i] that did not fit (0 when the flush landed
             * exactly on a value boundary) */
            acc = nbits ? v[i] >> (width - nbits) : 0;
        }
    }
    if (nbits > 0)
        __builtin_memcpy(out + o, &acc, 8); /* slack covers the tail */
    return (count * (long long)width + 7) / 8;
}

/* Pack count LSB-first width-bit values from a contiguous u64 array.
 * out must hold (count*width + 7)/8 + 8 bytes (8 slack for the word
 * writer; the caller slices to the exact length).  Returns 0, -1 if a
 * value does not fit in width bits (silent truncation would corrupt the
 * stream), or -2 for a width outside 1..64. */
long long tpq_pack64(const uint64_t *v, long long count, int width,
                     uint8_t *out) {
    if (width <= 0 || width > 64)
        return -2;
    const uint64_t lim_mask =
        width >= 64 ? 0 : ~((uint64_t)0) << width; /* high bits set */
    for (long long i = 0; i < count; i++)
        if (v[i] & lim_mask)
            return -1;
    pack_words(v, count, width, out);
    return 0;
}

static inline long long emit_uvarint(uint8_t *out, long long o,
                                     uint64_t v) {
    while (v >= 0x80) {
        out[o++] = (uint8_t)(v | 0x80);
        v >>= 7;
    }
    out[o++] = (uint8_t)v;
    return o;
}

/* Emit the block body of a DELTA_BINARY_PACKED stream: per block a
 * zigzag-varint min_delta, the miniblock width bytes, then each
 * non-zero-width miniblock's LSB-first packed payload — the assembly
 * loop that ran per block in Python.  adj is the (n_mb * mb_size)
 * min_delta-adjusted matrix (padding lanes zero), widths one byte per
 * miniblock.  Returns 0 and *out_len, or -1 if cap would overflow. */
long long tpq_delta_emit(const uint64_t *adj, const uint8_t *widths,
                         long long n_mb, long long mb_size,
                         const int64_t *min_deltas, long long n_blocks,
                         long long n_miniblocks, uint8_t *out,
                         long long cap, long long *out_len) {
    long long o = 0;
    for (long long b = 0; b < n_blocks; b++) {
        if (o + 10 + n_miniblocks > cap)
            return -1;
        uint64_t u = (uint64_t)min_deltas[b];
        o = emit_uvarint(out, o, (u << 1) ^ (uint64_t)(min_deltas[b] >> 63));
        for (long long m = 0; m < n_miniblocks; m++) {
            long long mb = b * n_miniblocks + m;
            out[o++] = mb < n_mb ? widths[mb] : 0;
        }
        for (long long m = 0; m < n_miniblocks; m++) {
            long long mb = b * n_miniblocks + m;
            if (mb >= n_mb)
                continue;
            int width = widths[mb];
            if (width == 0)
                continue;
            long long nbytes = mb_size * width / 8;
            if (o + nbytes + 8 > cap)
                return -1;
            o += pack_words(adj + mb * mb_size, mb_size, width, out + o);
        }
    }
    *out_len = o;
    return 0;
}

static inline uint64_t load_bits(const uint8_t *bp, long long bp_len,
                                 long long bitpos, int width) {
    /* read width (<=32) bits at bitpos; safe at the tail */
    long long byte = bitpos >> 3;
    int shift = (int)(bitpos & 7);
    uint64_t w = 0;
    if (byte + 8 <= bp_len) {
        __builtin_memcpy(&w, bp + byte, 8);
    } else {
        for (int i = 0; byte + i < bp_len && i < 8; i++)
            w |= (uint64_t)bp[byte + i] << (8 * i);
    }
    w >>= shift;
    return w & (((uint64_t)1 << width) - 1);
}

/* Emit one bit-packed region (header + 8-value groups, zero-padded
 * tail group): shared by the mid-stream and end-of-stream flushes of
 * tpq_hybrid_encode.  Returns the new offset, or -1 when cap would
 * overflow. */
static long long emit_bp_region(const uint64_t *v, long long bp_n,
                                int width, uint8_t *out, long long cap,
                                long long o) {
    if (bp_n <= 0)
        return o;
    long long groups = (bp_n + 7) / 8;
    if (o + 10 + groups * width + 8 > cap)
        return -1;
    o = emit_uvarint(out, o, ((uint64_t)groups << 1) | 1);
    long long full = bp_n / 8 * 8;
    if (full)
        o += pack_words(v, full, width, out + o);
    if (bp_n > full) { /* zero-padded tail group */
        uint64_t tmp[8] = {0};
        for (long long k = 0; k < bp_n - full; k++)
            tmp[k] = v[full + k];
        o += pack_words(tmp, 8, width, out + o);
    }
    return o;
}

/* Hybrid RLE/BP encode of u64 values at widths 1..64: RLE for constant
 * stretches >= 8, bit-packing for the rest (8-value groups, zero-padded
 * tail), byte for byte the stream of hybrid.c's tpq_hybrid_encode32 at
 * widths up to 32 (cpu/hybrid.py encode_hybrid takes this one for wider
 * values and for arrays that are not u32).  out needs 8 bytes of slack
 * past the worst case.  Returns 0 with *out_len, -1 if a value exceeds
 * width bits, -2 on a bad width, -3 when cap would overflow. */
long long tpq_hybrid_encode(const uint64_t *v, long long n, int width,
                            uint8_t *out, long long cap,
                            long long *out_len) {
    if (width <= 0 || width > 64)
        return -2;
    const uint64_t lim_mask =
        width >= 64 ? 0 : ~((uint64_t)0) << width;
    for (long long i = 0; i < n; i++)
        if (v[i] & lim_mask)
            return -1;
    const int vbytes = (width + 7) / 8;
    long long o = 0;
    long long pending = 0; /* start of the un-emitted bit-packed region */
    long long i = 0;
    while (i < n) {
        /* find the constant run starting at i */
        long long e = i + 1;
        while (e < n && v[e] == v[i])
            e++;
        if (e - i >= 8) { /* long run: flush pending BP, then RLE */
            long long flush_end = i;
            if ((flush_end - pending) % 8) {
                long long r = pending + ((i - pending + 7) / 8) * 8;
                flush_end = r < e ? r : e;
            }
            o = emit_bp_region(v + pending, flush_end - pending, width,
                               out, cap, o);
            if (o < 0)
                return -3;
            if (e - flush_end >= 1) {
                if (o + 10 + vbytes > cap)
                    return -3;
                o = emit_uvarint(out, o,
                                 (uint64_t)(e - flush_end) << 1);
                uint64_t x = v[i];
                for (int b = 0; b < vbytes; b++) {
                    out[o++] = (uint8_t)x;
                    x >>= 8;
                }
            }
            pending = e;
        }
        i = e;
    }
    o = emit_bp_region(v + pending, n - pending, width, out, cap, o);
    if (o < 0)
        return -3;
    *out_len = o;
    return 0;
}

/* Expand a hybrid RLE/BP run table to values — pass 2 of the two-pass
 * decode, one C pass instead of the numpy searchsorted-over-runs
 * formulation (the CPU oracle's hottest function on mixed-run level
 * and dict-index streams).  Clamp semantics mirror the numpy mixed
 * branch: the last run extends to count, bit-packed positions clamp to
 * the stream's final value.  width 1..32. */
long long tpq_hybrid_expand32(const int32_t *ends, const uint8_t *is_rle,
                              const uint32_t *value,
                              const int32_t *bp_start, long long n_runs,
                              const uint8_t *bp, long long bp_len,
                              long long n_bp, long long count, int width,
                              uint32_t *out) {
    if (width <= 0 || width > 32 || n_runs <= 0)
        return -2;
    long long o = 0;
    long long prev = 0;
    for (long long r = 0; r < n_runs && prev < count; r++) {
        long long end = (r == n_runs - 1) ? count : ends[r];
        if (end > count)
            end = count;
        if (end < prev)
            return -2;
        long long len = end - prev;
        if (is_rle[r]) {
            const uint32_t x = value[r];
            for (long long i = 0; i < len; i++)
                out[o++] = x;
        } else {
            long long lim = (n_bp > 0 ? n_bp - 1 : 0) * (long long)width;
            long long bit = (long long)bp_start[r] * width;
            for (long long i = 0; i < len; i++, bit += width)
                out[o++] = (uint32_t)load_bits(
                    bp, bp_len, bit > lim ? lim : bit, width);
        }
        prev = end;
    }
    while (o < count)
        out[o++] = 0; /* unreachable for valid scans (ends cover count) */
    return 0;
}

/* Re-pack a hybrid RLE/BP run table into ONE bit-packed run.
 * Run k covers value indices [ends[k-1], ends[k]); RLE runs repeat
 * value[k], bit-packed runs read consecutive width-bit values from the
 * concatenated bp stream starting at value index bp_start[k].  out
 * must hold (count*width + 7)/8 + 8 bytes (8 slack; caller slices).
 * width 1..32.  Returns 0, or -2 on a bad width / non-monotone
 * table. */
long long tpq_hybrid_repack(const int32_t *ends, const uint8_t *is_rle,
                            const uint32_t *value, const int32_t *bp_start,
                            long long n_runs, const uint8_t *bp,
                            long long bp_len, long long n_bp,
                            long long count, int width, uint8_t *out) {
    if (width <= 0 || width > 32 || n_runs <= 0)
        return -2;
    uint64_t acc = 0;
    int nbits = 0;
    long long o = 0;
    long long prev = 0;
    for (long long r = 0; r < n_runs && prev < count; r++) {
        /* the clamp mirrors the numpy expand (cpu/hybrid.expand_scan):
         * the LAST run extends to cover any values past the table's
         * final end, and bit-packed positions clamp to the stream's
         * last value */
        long long end = (r == n_runs - 1) ? count : ends[r];
        if (end > count)
            end = count;
        if (end < prev)
            return -2;
        long long len = end - prev;
        if (is_rle[r]) {
            const uint64_t x = value[r];
            if (width < 32 && (x >> width))
                return -1; /* would silently read back truncated */
            for (long long i = 0; i < len; i++) {
                acc |= x << nbits;
                nbits += width;
                if (nbits >= 64) {
                    __builtin_memcpy(out + o, &acc, 8);
                    o += 8;
                    nbits -= 64;
                    acc = nbits ? x >> (width - nbits) : 0;
                }
            }
        } else {
            long long lim = (n_bp > 0 ? n_bp - 1 : 0) * (long long)width;
            long long bit = (long long)bp_start[r] * width;
            for (long long i = 0; i < len; i++, bit += width) {
                uint64_t x = load_bits(bp, bp_len,
                                       bit > lim ? lim : bit, width);
                acc |= x << nbits;
                nbits += width;
                if (nbits >= 64) {
                    __builtin_memcpy(out + o, &acc, 8);
                    o += 8;
                    nbits -= 64;
                    acc = nbits ? x >> (width - nbits) : 0;
                }
            }
        }
        prev = end;
    }
    long long total = (count * width + 7) / 8;
    if (nbits > 0 && o < total)
        __builtin_memcpy(out + o, &acc, 8); /* slack covers the tail */
    return 0;
}
