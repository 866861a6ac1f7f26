/* Small-range integer intern: the dictionary build of an integer column
 * whose values span a small range (category codes, quantized measures).
 *
 * One sequential pass gives each value its first-occurrence rank through
 * a dense rank table over the value range; the numpy formulation of
 * cpu/dictionary.py (widen, reversed scatter, presence scan, argsort,
 * gather) takes five passes and their temporaries.
 *
 * Values are raw 32- or 64-bit words; lo is the column minimum in the
 * same width, and offsets are computed with wraparound subtraction,
 * which is exact for signed and unsigned columns alike as long as every
 * (v - lo) lies in [0, rng): the caller takes lo and rng from the true
 * minimum and maximum.  rank holds rng int32 entries filled with -1;
 * uniq_pos receives the first-occurrence index of each id (ids are
 * first-occurrence ranks by construction).  Returns the distinct count
 * D, or -3 when a value falls outside [lo, lo + rng).
 */

#include <stdint.h>

long long tpq_intern_range32(const uint32_t *v, long long n, uint32_t lo,
                             long long rng, int32_t *rank,
                             int64_t *uniq_pos, int32_t *indices) {
    long long d = 0;
    for (long long i = 0; i < n; i++) {
        uint32_t off = v[i] - lo;
        if ((uint64_t)off >= (uint64_t)rng)
            return -3;
        int32_t r = rank[off];
        if (r < 0) {
            r = (int32_t)d;
            rank[off] = r;
            uniq_pos[d++] = i;
        }
        indices[i] = r;
    }
    return d;
}

long long tpq_intern_range64(const uint64_t *v, long long n, uint64_t lo,
                             long long rng, int32_t *rank,
                             int64_t *uniq_pos, int32_t *indices) {
    long long d = 0;
    for (long long i = 0; i < n; i++) {
        uint64_t off = v[i] - lo;
        if (off >= (uint64_t)rng)
            return -3;
        int32_t r = rank[off];
        if (r < 0) {
            r = (int32_t)d;
            rank[off] = r;
            uniq_pos[d++] = i;
        }
        indices[i] = r;
    }
    return d;
}
