/* LSB-first bit packing for the delta-lane wire planner.
 *
 * tpq_pack64 packs the planner's min_delta-adjusted offsets
 * (kernels/device.py _plan_delta_lane_words); the numpy formulation
 * explodes every value into a byte-per-bit matrix, which made the
 * transport cost more host time than it saved wire.
 *
 * The writer keeps a u64 accumulator and flushes whole 64-bit words
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
