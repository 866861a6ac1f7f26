/* RLE/bit-packed hybrid stream scanner and bit-packed lane statistics.
 *
 * tpq_hybrid_scan parses the uvarint-chained run headers of a Parquet
 * hybrid stream (levels, dictionary indices) into a flat run table plus
 * the concatenated bit-packed segment bytes: the host pass of the device
 * plan (cpu/hybrid.py scan_hybrid).  tpq_bp_stats takes the max and the
 * count of one value over the consumed lanes of those segments, which
 * count_eq_scan and max_scan_value need (kernels/hybrid.py), without
 * unpacking the stream.  A per-run Python loop cost about a second on a
 * def-level stream of half a million runs; this is one C pass each.
 */

#include <stddef.h>
#include <stdint.h>
#include <string.h>

#define TPQ_OK 0
#define TPQ_ERR_TRUNCATED (-1)
#define TPQ_ERR_ZERO_RLE (-2)
#define TPQ_ERR_RUN_CAP (-3)
#define TPQ_ERR_BP_CAP (-4)
#define TPQ_ERR_WIDTH (-5)
#define TPQ_ERR_VALUE (-6)

/* Read one unsigned LEB128 varint; returns the new position or 0 on
 * error. */
static size_t read_uvarint(const uint8_t *buf, size_t len, size_t pos,
                           uint64_t *out) {
  uint64_t v = 0;
  int shift = 0;
  while (pos < len && shift < 64) {
    uint8_t b = buf[pos++];
    v |= (uint64_t)(b & 0x7f) << shift;
    if (!(b & 0x80)) {
      *out = v;
      return pos;
    }
    shift += 7;
  }
  return 0;
}

/* Scan count values of width-bit runs starting at pos.  Every run lands
 * in the table (run_ends cumulative, clamped to count); a bit-packed run
 * keeps its full 8-value groups in bp_out and its table row points at
 * its first lane (run_bp_start).  Returns 0, or -1 truncated, -2 a
 * zero-length RLE run, -3/-4 a cap exceeded, -5 a bad width, -6 an RLE
 * value wider than width. */
int tpq_hybrid_scan(const uint8_t *buf, size_t buflen, size_t pos,
                    int64_t count, int width,
                    int32_t *run_ends, uint8_t *run_is_rle,
                    uint32_t *run_value, int32_t *run_bp_start,
                    int64_t cap_runs, uint8_t *bp_out, size_t bp_cap,
                    int64_t *n_runs, int64_t *n_bp_values,
                    size_t *bp_len, size_t *end_pos) {
  if (width < 0 || width > 32) return TPQ_ERR_WIDTH;
  size_t vbytes = (size_t)(width + 7) / 8;
  uint32_t vmask = width >= 32 ? 0xffffffffu : ((1u << width) - 1u);
  int64_t filled = 0, runs = 0, bp_values = 0;
  size_t bp_used = 0;

  while (filled < count) {
    uint64_t h;
    size_t np = read_uvarint(buf, buflen, pos, &h);
    if (np == 0) return TPQ_ERR_TRUNCATED;
    pos = np;
    if (runs >= cap_runs) return TPQ_ERR_RUN_CAP;
    /* a header whose value count would overflow int64 arithmetic is
     * necessarily longer than the buffer */
    if ((h >> 1) > ((uint64_t)1 << 40)) return TPQ_ERR_TRUNCATED;
    if (h & 1) {
      int64_t n = (int64_t)(h >> 1) * 8;
      size_t nbytes = ((size_t)n * (size_t)width + 7) / 8;
      if (pos + nbytes > buflen) return TPQ_ERR_TRUNCATED;
      if (bp_used + nbytes > bp_cap) return TPQ_ERR_BP_CAP;
      memcpy(bp_out + bp_used, buf + pos, nbytes);
      bp_used += nbytes;
      pos += nbytes;
      run_is_rle[runs] = 0;
      run_value[runs] = 0;
      run_bp_start[runs] = (int32_t)bp_values;
      int64_t take = n < count - filled ? n : count - filled;
      bp_values += n; /* full groups stay; consumers index via bp_start */
      filled += take;
    } else {
      int64_t n = (int64_t)(h >> 1);
      if (n == 0) return TPQ_ERR_ZERO_RLE;
      if (pos + vbytes > buflen) return TPQ_ERR_TRUNCATED;
      uint32_t v = 0;
      for (size_t i = 0; i < vbytes; i++)
        v |= (uint32_t)buf[pos + i] << (8 * i);
      pos += vbytes;
      if (v & ~vmask) return TPQ_ERR_VALUE;
      run_is_rle[runs] = 1;
      run_value[runs] = v;
      run_bp_start[runs] = (int32_t)bp_values;
      int64_t take = n < count - filled ? n : count - filled;
      filled += take;
    }
    run_ends[runs++] = (int32_t)filled;
  }
  *n_runs = runs;
  *n_bp_values = bp_values;
  *bp_len = bp_used;
  *end_pos = pos;
  return TPQ_OK;
}

/* Value i (LSB-first within bytes) of a width-bit stream; the caller
 * guarantees its bits lie within bp_len bytes. */
static inline uint32_t bp_get(const uint8_t *bp, size_t bp_len, int64_t i,
                              int width, uint32_t vmask) {
  uint64_t bit = (uint64_t)i * (uint64_t)width;
  size_t byte = (size_t)(bit >> 3);
  int shift = (int)(bit & 7);
  uint64_t w;
  if (byte + 8 <= bp_len) {
    memcpy(&w, bp + byte, 8);
  } else {
    w = 0;
    for (size_t k = 0; byte + k < bp_len && k < 8; k++)
      w |= (uint64_t)bp[byte + k] << (8 * k);
  }
  return (uint32_t)(w >> shift) & vmask;
}

/* Max value and count of lanes equal to target over the CONSUMED lanes of
 * bit-packed segments: (start, len) pairs in lane positions of the
 * concatenated stream (the run table's bp_start column), so the 8-group
 * padding of each run is never read.  Returns 0, 1 when no lane was
 * consumed (max undefined), -1 a segment past the stream, -5 a bad
 * width. */
int tpq_bp_stats(const uint8_t *bp, size_t bp_len, int width,
                 const int64_t *starts, const int64_t *lens,
                 int64_t n_segs, uint32_t target,
                 uint32_t *out_max, int64_t *out_count_eq) {
  if (width < 0 || width > 32) return TPQ_ERR_WIDTH;
  uint32_t vmask = width >= 32 ? 0xffffffffu : ((1u << width) - 1u);
  uint32_t mx = 0;
  int64_t cnt = 0;
  int seen = 0;
  for (int64_t s = 0; s < n_segs; s++) {
    int64_t start = starts[s], len = lens[s];
    if (start < 0 || len < 0) return TPQ_ERR_TRUNCATED;
    if (len == 0) continue;
    if ((uint64_t)(start + len) * (uint64_t)width > (uint64_t)bp_len * 8)
      return TPQ_ERR_TRUNCATED;
    seen = 1;
    if (width == 0) {
      cnt += (target == 0) ? len : 0;
      continue;
    }
    if (width == 1) {
      /* def levels of an optional column: popcount whole bytes */
      int64_t i = start, end = start + len, ones = 0;
      while (i < end && (i & 7))
        ones += (bp[i >> 3] >> (i & 7)) & 1, i++;
      while (i + 8 <= end) {
        ones += __builtin_popcount(bp[i >> 3]);
        i += 8;
      }
      while (i < end)
        ones += (bp[i >> 3] >> (i & 7)) & 1, i++;
      if (ones) mx = 1u;
      cnt += (target == 1) ? ones : (target == 0 ? len - ones : 0);
      continue;
    }
    for (int64_t i = start; i < start + len; i++) {
      uint32_t v = bp_get(bp, bp_len, i, width, vmask);
      if (v > mx) mx = v;
      cnt += (v == target);
    }
  }
  *out_max = mx;
  *out_count_eq = cnt;
  return seen ? TPQ_OK : 1;
}

/* Pack count width-bit u32 values LSB-first at out (8 bytes of slack past
 * the exact payload); returns the exact payload length. */
static long long pack_words32(const uint32_t *v, long long count, int width,
                              uint8_t *out) {
  uint64_t acc = 0;
  int nbits = 0;
  long long o = 0;
  for (long long i = 0; i < count; i++) {
    acc |= nbits < 64 ? (uint64_t)v[i] << nbits : 0;
    nbits += width;
    if (nbits >= 64) {
      memcpy(out + o, &acc, 8);
      o += 8;
      nbits -= 64;
      acc = nbits ? (uint64_t)v[i] >> (width - nbits) : 0;
    }
  }
  if (nbits > 0) memcpy(out + o, &acc, 8); /* slack covers the tail */
  return (count * (long long)width + 7) / 8;
}

static long long emit_uvarint(uint8_t *out, long long o, uint64_t v) {
  while (v >= 0x80) {
    out[o++] = (uint8_t)(v | 0x80);
    v >>= 7;
  }
  out[o++] = (uint8_t)v;
  return o;
}

/* One bit-packed region: header, 8-value groups, zero-padded tail group.
 * Returns the new offset, or -1 when cap would overflow. */
static long long emit_bp_region32(const uint32_t *v, long long bp_n,
                                  int width, uint8_t *out, long long cap,
                                  long long o) {
  if (bp_n <= 0) return o;
  long long groups = (bp_n + 7) / 8;
  if (o + 10 + groups * width + 8 > cap) return -1;
  o = emit_uvarint(out, o, ((uint64_t)groups << 1) | 1);
  long long full = bp_n / 8 * 8;
  if (full) o += pack_words32(v, full, width, out + o);
  if (bp_n > full) {
    uint32_t tmp[8] = {0};
    for (long long k = 0; k < bp_n - full; k++) tmp[k] = v[full + k];
    o += pack_words32(tmp, 8, width, out + o);
  }
  return o;
}

/* Hybrid encode of n u32 values: RLE for constant stretches of at least
 * 8, bit-packing (8-value groups, zero-padded tail) for the rest, a
 * bit-packed region ahead of an RLE run rounded up to its group edge and
 * the overhang carved off the run — byte for byte the output of
 * cpu/hybrid.py encode_hybrid, whose long-run loop runs in Python.  out
 * needs 8 bytes of slack past the worst case.  Returns 0 with *out_len,
 * -1 a value wider than width, -2 a bad width, -3 cap overflow. */
long long tpq_hybrid_encode32(const uint32_t *v, long long n, int width,
                              uint8_t *out, long long cap,
                              long long *out_len) {
  if (width <= 0 || width > 32) return -2;
  const uint32_t lim = width >= 32 ? 0 : ~((uint32_t)0) << width;
  for (long long i = 0; i < n; i++)
    if (v[i] & lim) return -1;
  const int vbytes = (width + 7) / 8;
  long long o = 0, pending = 0, i = 0;
  while (i < n) {
    long long e = i + 1;
    while (e < n && v[e] == v[i]) e++;
    if (e - i >= 8) {
      long long flush_end = i;
      if ((flush_end - pending) % 8) {
        long long r = pending + ((i - pending + 7) / 8) * 8;
        flush_end = r < e ? r : e;
      }
      o = emit_bp_region32(v + pending, flush_end - pending, width, out,
                           cap, o);
      if (o < 0) return -3;
      if (e - flush_end >= 1) {
        if (o + 10 + vbytes > cap) return -3;
        o = emit_uvarint(out, o, (uint64_t)(e - flush_end) << 1);
        uint32_t x = v[i];
        for (int b = 0; b < vbytes; b++) {
          out[o++] = (uint8_t)x;
          x >>= 8;
        }
      }
      pending = e;
    }
    i = e;
  }
  o = emit_bp_region32(v + pending, n - pending, width, out, cap, o);
  if (o < 0) return -3;
  *out_len = o;
  return 0;
}
