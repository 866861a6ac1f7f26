/* DELTA_BINARY_PACKED block scanner and miniblock gather.
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
