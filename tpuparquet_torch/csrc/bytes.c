/* Host passes over BYTE_ARRAY values, one C loop each.
 *
 * A copy of the JAX package's tpuparquet/native/delta.c
 * (tpq_byte_array_scan, tpq_byte_array_emit, tpq_gather_var) and
 * native/intern.c (tpq_intern_var).  At 1.5M strings a page a Python loop
 * per value would be the whole plan: the PLAIN length scan sizes the
 * device output and the offsets, the gather fills a dictionary or a raw
 * page's bytes, the emitter writes PLAIN records, and the interner builds
 * the writer's dictionary in first-occurrence order.
 */
#include <stdint.h>
#include <string.h>

/* Scan count PLAIN BYTE_ARRAY records (u32-LE length prefix + bytes):
 * emits each value's payload position and the cumulative offsets.
 * Returns 0, or -1 truncated prefix / -2 length out of bounds with
 * *err_index the offending value and *err_len its claimed length. */
long long tpq_byte_array_scan(const uint8_t *buf, long long n,
                              long long count, int64_t *positions,
                              int64_t *offsets, long long *err_index,
                              long long *err_len) {
    if (count < 0)
        return -3;
    long long pos = 0, total = 0;
    offsets[0] = 0;
    for (long long i = 0; i < count; i++) {
        if (pos + 4 > n) {
            *err_index = i;
            return -1;
        }
        uint32_t ln;
        memcpy(&ln, buf + pos, 4);
        pos += 4;
        if ((long long)ln > n - pos) {
            *err_index = i;
            *err_len = (long long)ln;
            return -2;
        }
        positions[i] = pos;
        total += (long long)ln;
        offsets[i + 1] = total;
        pos += (long long)ln;
    }
    return 0;
}

/* Emit count PLAIN BYTE_ARRAY records from offsets + contiguous data (the
 * encode twin of tpq_byte_array_scan).  out holds 4*count + data bytes. */
long long tpq_byte_array_emit(const uint8_t *data, long long data_len,
                              const int64_t *offsets, long long count,
                              uint8_t *out) {
    long long o = 0;
    for (long long i = 0; i < count; i++) {
        long long L = offsets[i + 1] - offsets[i];
        /* an inconsistent column must not copy adjacent heap bytes */
        if (L < 0 || L > 0xFFFFFFFFLL || offsets[i] < 0
            || offsets[i] + L > data_len)
            return -1;
        uint32_t ln = (uint32_t)L;
        memcpy(out + o, &ln, 4);
        o += 4;
        memcpy(out + o, data + offsets[i], (size_t)L);
        o += L;
    }
    return 0;
}

/* Gather n variable-length segments into one contiguous buffer. */
long long tpq_gather_var(const uint8_t *src, long long src_len,
                         const int64_t *start, const int64_t *lens,
                         long long n, uint8_t *out, long long out_len) {
    long long o = 0;
    for (long long i = 0; i < n; i++) {
        long long L = lens[i];
        if (L < 0 || start[i] < 0 || start[i] + L > src_len
            || o + L > out_len)
            return -1;
        memcpy(out + o, src + start[i], (size_t)L);
        o += L;
    }
    return 0;
}

/* First-occurrence interning of n variable byte values: FNV hash, a
 * linear-probe table of T = t_mask + 1 int32 slots (caller fills -1), and
 * a memcmp check per probe.  firsts (capacity max_d) receives each id's
 * first value index, indices the id of every value.  Returns the distinct
 * count D, or -1 table saturated, -2 more than max_d distinct (the
 * caller's dictionary gate rejects), -3 corrupt offsets. */
long long tpq_intern_var(const uint8_t *data, long long data_len,
                         const int64_t *offs, long long n,
                         int32_t *slots, long long t_mask, int tbits,
                         int64_t *firsts, long long max_d,
                         int32_t *indices) {
    long long d = 0;
    for (long long i = 0; i < n; i++) {
        int64_t s0 = offs[i], e0 = offs[i + 1];
        if (s0 < 0 || e0 < s0 || e0 > data_len)
            return -3;
        int64_t len = e0 - s0;
        uint64_t h = 1469598103934665603ull + 31ull * (uint64_t)len;
        for (int64_t p = s0; p < e0; p++)
            h = (h ^ data[p]) * 1099511628211ull;
        /* Fibonacci slot: the high bits of the product (the low bits of
         * the FNV chain carry linear structure) */
        long long slot =
            (long long)((h * 0x9E3779B97F4A7C15ull) >> (64 - tbits));
        long long probes = 0;
        for (;;) {
            int32_t id = slots[slot];
            if (id < 0) {
                if (d >= max_d)
                    return -2;
                slots[slot] = (int32_t)d;
                firsts[d] = i;
                indices[i] = (int32_t)d;
                d++;
                break;
            }
            int64_t fs = offs[firsts[id]];
            int64_t fe = offs[firsts[id] + 1];
            if (fe - fs == len
                && memcmp(data + fs, data + s0, (size_t)len) == 0) {
                indices[i] = id;
                break;
            }
            slot = (slot + 1) & t_mask;
            if (++probes > t_mask)
                return -1;
        }
    }
    return d;
}
