/* Strided lane/byte-plane primitives for the device wire planner.
 *
 * The lane/byte-plane RLE transport (kernels/device.py _plan_plane_words)
 * decides per u32 lane of a PLAIN fixed-width values segment whether to
 * ship the lane as a whole-lane run table, per-byte-plane run tables, or
 * raw words.  The numpy formulation of the build phase costs several
 * passes per engaged lane (strided compare -> bool temp -> flatnonzero ->
 * fancy index); these helpers do each job in ONE branch-light pass over
 * the strided source so the plan thread — which the pipelined reader
 * overlaps with device transfers — stays ahead of the wire.
 *
 * Run-table semantics match kernels/device.py _rle_table: run k covers
 * [ends[k-1], ends[k]) (ends[-1] == 0 implied) with value vals[k]; the
 * final run's end equals count.  The caller bucket-pads.
 */

#include <stddef.h>
#include <stdint.h>

/* Scan a strided u32 stream for value runs.  Returns the run count, or
 * -1 when more than cap runs exist (caller ships the lane raw — the
 * table could not beat raw words anyway). */
long long tpq_run_scan32(const uint8_t *base, long long count,
                         long long stride, int32_t *ends, uint32_t *vals,
                         long long cap) {
    if (count <= 0 || cap <= 0)
        return -1;
    uint32_t cur;
    __builtin_memcpy(&cur, base, 4);
    long long n = 0;
    for (long long i = 1; i < count; i++) {
        uint32_t v;
        __builtin_memcpy(&v, base + i * stride, 4);
        if (v != cur) {
            if (n >= cap)
                return -1;
            ends[n] = (int32_t)i;
            vals[n] = cur;
            n++;
            cur = v;
        }
    }
    if (n >= cap)
        return -1;
    ends[n] = (int32_t)count;
    vals[n] = cur;
    return n + 1;
}

/* Same, for a strided byte plane. */
long long tpq_run_scan8(const uint8_t *base, long long count,
                        long long stride, int32_t *ends, uint8_t *vals,
                        long long cap) {
    if (count <= 0 || cap <= 0)
        return -1;
    uint8_t cur = base[0];
    long long n = 0;
    for (long long i = 1; i < count; i++) {
        uint8_t v = base[i * stride];
        if (v != cur) {
            if (n >= cap)
                return -1;
            ends[n] = (int32_t)i;
            vals[n] = cur;
            n++;
            cur = v;
        }
    }
    if (n >= cap)
        return -1;
    ends[n] = (int32_t)count;
    vals[n] = cur;
    return n + 1;
}

/* Gather a strided u32 lane into a contiguous buffer.  The stride-8
 * case (u32 lanes of int64/double columns) is written as a
 * low-word-of-u64 loop the compiler can turn into load+shuffle SIMD. */
void tpq_lane_gather32(const uint8_t *base, long long count,
                       long long stride, uint32_t *out) {
    if (stride == 8) {
        /* the widened load reads 8 bytes but only 4 belong to the last
         * element — stop one early so a lane whose base is offset into
         * the segment (lane 1 of an int64 column) never reads past the
         * caller's buffer (which may be a zero-copy view of the file or
         * an exactly-sized arena slab) */
        for (long long i = 0; i + 1 < count; i++) {
            uint64_t w;
            __builtin_memcpy(&w, base + i * 8, 8);
            out[i] = (uint32_t)w; /* little-endian low word */
        }
        if (count > 0)
            __builtin_memcpy(&out[count - 1], base + (count - 1) * 8, 4);
        return;
    }
    for (long long i = 0; i < count; i++)
        __builtin_memcpy(&out[i], base + i * stride, 4);
}

/* Gather a strided byte plane into a contiguous buffer. */
void tpq_lane_gather8(const uint8_t *base, long long count,
                      long long stride, uint8_t *out) {
    if (stride == 4) {
        for (long long i = 0; i + 1 < count; i++) {
            uint32_t w;
            __builtin_memcpy(&w, base + i * 4, 4);
            out[i] = (uint8_t)w;
        }
        if (count > 0)
            out[count - 1] = base[(count - 1) * 4];
        return;
    }
    if (stride == 8) {
        for (long long i = 0; i + 1 < count; i++) {
            uint64_t w;
            __builtin_memcpy(&w, base + i * 8, 8);
            out[i] = (uint8_t)w;
        }
        if (count > 0)
            out[count - 1] = base[(count - 1) * 8];
        return;
    }
    for (long long i = 0; i < count; i++)
        out[i] = base[i * stride];
}
