/* DELTA_BINARY_PACKED block scanner and miniblock gather; the
 * DELTA_BYTE_ARRAY (front coding) fill and its writer's prefix pass.
 *
 * The structure pass of cpu/delta.py scan_delta_structure walks min_delta
 * zigzag varints and per-miniblock width bytes: a Python loop costs about
 * 6 us per 128-value block, which would dominate the device planner at
 * tens of millions of values.  tpq_delta_scan_blocks is the same one-pass
 * scan in C; the Python wrapper reads and validates the four stream-header
 * varints first, so the scan starts at the first block and the caller can
 * size the output arrays.  tpq_gather_segments concatenates one width
 * class's miniblock payloads for the device planner
 * (kernels/decode.py _plan_delta) when they do not lie back to back.
 * tpq_delta_decode turns a scanned structure into the values in one pass
 * (unpack, min_delta, prefix sum).  tpq_dba_assemble rebuilds front-coded
 * values, each from its predecessor, which is sequential by nature;
 * tpq_common_prefix measures the prefix each value shares with the one
 * before it (the writer's side: a Python loop over a million values took
 * minutes).
 *
 * Return codes of the scan: 0 ok, -1 truncated varint, -5 truncated
 * width list, -6 width > max_width, -7 truncated payload, -8 output cap
 * exceeded (a caller bug), -9 varint value out of range.
 */

#include <stddef.h>
#include <stdint.h>

static int read_uvarint64(const uint8_t *d, long long len, long long *pos,
                          uint64_t *out) {
    unsigned __int128 v = 0;
    int shift = 0;
    for (;;) {
        if (*pos >= len)
            return -1;
        uint8_t b = d[(*pos)++];
        v |= (unsigned __int128)(b & 0x7F) << shift;
        if (!(b & 0x80))
            break;
        shift += 7;
        if (shift > 70)
            return -1;
    }
    if (v > (unsigned __int128)UINT64_MAX)
        return -9;
    *out = (uint64_t)v;
    return 0;
}

/* Gather k fixed-size segments (miniblock payloads) of src into one
 * contiguous buffer.  Returns 0, or -1 when a segment overruns src. */
long long tpq_gather_segments(const uint8_t *src, long long src_len,
                              const int64_t *pos, long long k,
                              long long nbytes, uint8_t *out) {
    for (long long i = 0; i < k; i++) {
        if (pos[i] < 0 || pos[i] + nbytes > src_len)
            return -1;
        __builtin_memcpy(out + i * nbytes, src + pos[i], (size_t)nbytes);
    }
    return 0;
}

/* Walk the blocks of a stream of n_deltas deltas from pos: per block the
 * min_delta (md_blocks), per miniblock of nonzero width its width, payload
 * position and first delta index (mb_w, mb_pos, mb_start).  Zero-width
 * miniblocks carry no payload and are not recorded; miniblocks past the
 * last delta are not read. */
long long tpq_delta_scan_blocks(
    const uint8_t *data, long long data_len, long long pos,
    long long n_deltas, long long mb_size, long long n_miniblocks,
    int max_width,
    int64_t *md_blocks, int32_t *mb_w, int64_t *mb_pos,
    int64_t *mb_start, long long cap_blocks, long long cap_mb,
    long long *n_blocks_out, long long *n_mb_out,
    long long *end_pos_out) {
    long long got = 0, nb = 0, nm = 0;
    while (got < n_deltas) {
        uint64_t u;
        int rc = read_uvarint64(data, data_len, &pos, &u);
        if (rc)
            return rc;
        /* zigzag decode; the wrap is int64 two's complement */
        int64_t min_delta = (int64_t)(u >> 1) ^ -(int64_t)(u & 1);
        if (nb >= cap_blocks)
            return -8;
        md_blocks[nb++] = min_delta;
        if (pos + n_miniblocks > data_len)
            return -5;
        const uint8_t *widths = data + pos;
        pos += n_miniblocks;
        for (long long i = 0; i < n_miniblocks; i++) {
            if (got >= n_deltas)
                break;
            int w = widths[i];
            if (w > max_width)
                return -6;
            long long nbytes = mb_size * w / 8;
            if (pos + nbytes > data_len)
                return -7;
            if (w) {
                if (nm >= cap_mb)
                    return -8;
                mb_w[nm] = w;
                mb_pos[nm] = pos;
                mb_start[nm] = got;
                nm++;
            }
            pos += nbytes;
            got += mb_size;
        }
    }
    *n_blocks_out = nb;
    *n_mb_out = nm;
    *end_pos_out = pos;
    return 0;
}

/* Full DELTA_BINARY_PACKED decode from a scanned structure (the
 * miniblock table tpq_delta_scan_blocks emits): unpack every recorded
 * miniblock's w-bit LSB-first deltas, add the per-block min_delta,
 * prefix-sum from first.  One C pass (ctypes releases the GIL) with no
 * full-size temporaries.  All arithmetic is uint64 two's-complement
 * wrap; out holds total values.
 * Returns 0, or -7 when a miniblock payload overruns data (the scan
 * already rejects this; defensive). */
long long tpq_delta_decode(
    const uint8_t *data, long long data_len,
    const int64_t *md_blocks, long long n_blocks,
    const int32_t *mb_w, const int64_t *mb_pos, const int64_t *mb_start,
    long long n_mb, long long mb_size, long long block_size,
    long long total, uint64_t first, uint64_t *out) {
    if (total <= 0)
        return 0;
    long long n_deltas = total - 1;
    __builtin_memset(out + 1, 0, (size_t)n_deltas * 8);
    for (long long m = 0; m < n_mb; m++) {
        int w = mb_w[m];
        long long pos = mb_pos[m];
        long long nbytes = mb_size * w / 8;
        if (w <= 0 || w > 64 || pos < 0 || pos + nbytes > data_len
            || mb_start[m] < 0 || mb_start[m] >= n_deltas)
            return -7;
        long long take = n_deltas - mb_start[m];
        if (take > mb_size)
            take = mb_size;
        const uint8_t *p = data + pos;
        uint64_t *dst = out + 1 + mb_start[m];
        uint64_t mask = (w == 64) ? ~(uint64_t)0
                                  : (((uint64_t)1 << w) - 1);
        /* speculative 16-byte loads need headroom past the last value's
         * final byte; values near data_len take the byte-wise path */
        long long fast = ((data_len - pos) - 16) * 8 / w;
        if (fast > take)
            fast = take;
        if (fast < 0)
            fast = 0;
        long long j = 0;
        for (; j < fast; j++) {
            long long bit = j * (long long)w;
            unsigned __int128 v;
            __builtin_memcpy(&v, p + (bit >> 3), 16);
            dst[j] = (uint64_t)(v >> (bit & 7)) & mask;
        }
        for (; j < take; j++) {
            long long bit = j * (long long)w;
            long long byte = bit >> 3;
            int shift = (int)(bit & 7);
            int need = (shift + w + 7) >> 3;
            unsigned __int128 acc = 0;
            for (int k = 0; k < need; k++)
                acc |= (unsigned __int128)p[byte + k] << (8 * k);
            dst[j] = (uint64_t)(acc >> shift) & mask;
        }
    }
    uint64_t acc = first;
    out[0] = acc;
    long long i = 0;
    for (long long b = 0; b < n_blocks && i < n_deltas; b++) {
        uint64_t md = (uint64_t)md_blocks[b];
        long long lim = i + block_size;
        if (lim > n_deltas)
            lim = n_deltas;
        for (; i < lim; i++) {
            acc += md + out[1 + i];
            out[1 + i] = acc;
        }
    }
    for (; i < n_deltas; i++) {   /* deltas past the declared blocks */
        acc += out[1 + i];
        out[1 + i] = acc;
    }
    return 0;
}

/* Front-coded DELTA_BYTE_ARRAY reconstruction: value i = the first
 * prefix_lens[i] bytes of value i-1 (from the OUTPUT, inherently
 * sequential) + its suffix bytes.  out_offsets are precomputed
 * cumulative total lengths (count+1 entries).  Returns 0, or -1 first
 * prefix nonzero / -2 prefix longer than the previous value / -3 a
 * suffix out of bounds, with *err_index set. */
long long tpq_dba_assemble(const int64_t *prefix_lens,
                           const int64_t *suffix_offs,
                           const uint8_t *suffix_data,
                           long long suffix_len,
                           const int64_t *out_offsets, long long count,
                           uint8_t *out, long long *err_index) {
    long long prev_start = 0, prev_len = 0;
    for (long long i = 0; i < count; i++) {
        long long start = out_offsets[i];
        long long plen = prefix_lens[i];
        if (i == 0 && plen != 0) {
            *err_index = i;
            return -1;
        }
        if (plen < 0 || plen > prev_len) {
            *err_index = i;
            return -2;
        }
        long long slen = suffix_offs[i + 1] - suffix_offs[i];
        if (slen < 0 || suffix_offs[i] < 0
            || suffix_offs[i] + slen > suffix_len
            || start + plen + slen != out_offsets[i + 1]) {
            *err_index = i;
            return -3;
        }
        if (plen)
            __builtin_memcpy(out + start, out + prev_start,
                             (size_t)plen);
        __builtin_memcpy(out + start + plen,
                         suffix_data + suffix_offs[i], (size_t)slen);
        prev_start = start;
        prev_len = plen + slen;
    }
    return 0;
}

/* prefix[i] = the length of the longest common prefix of values i-1 and
 * i (prefix[0] = 0), values given as offsets (count+1 entries) into data.
 * The offsets are the caller's own, already validated. */
void tpq_common_prefix(const uint8_t *data, const int64_t *offsets,
                       long long count, int64_t *prefix) {
    for (long long i = 0; i < count; i++) {
        if (i == 0) {
            prefix[0] = 0;
            continue;
        }
        const uint8_t *a = data + offsets[i - 1];
        const uint8_t *b = data + offsets[i];
        long long la = offsets[i] - offsets[i - 1];
        long long lb = offsets[i + 1] - offsets[i];
        long long lim = la < lb ? la : lb, n = 0;
        while (n < lim && a[n] == b[n])
            n++;
        prefix[i] = n;
    }
}
