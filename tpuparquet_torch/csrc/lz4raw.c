/* LZ4 raw block codec (Parquet's LZ4_RAW), from scratch, for the
 * tpuparquet_torch host runtime (a copy of the JAX package's
 * ``native/lz4raw.c``, so both packages write the same bytes).
 *
 * Wire format implemented from the public LZ4 block format
 * description: a stream of sequences, each a token byte (high nibble
 * literal length, low nibble match length - 4, 15 = extended with
 * 255-bytes), literal bytes, a 2-byte little-endian match offset
 * (1..65535), and match-length extension bytes.  The final sequence
 * is literals only.  Encoder end rules: the last 5 bytes are always
 * literals and no match starts within the last 12 bytes.
 *
 * The encoder mirrors snappy.c's proven shape: greedy hash-match over
 * 64 KiB blocks (match candidates never leave the current block, so
 * offsets always fit the 2-byte form and the position table stays
 * uint16/L1-resident), golang-style miss-skip acceleration, and one
 * pending literal run carried across blocks so incompressible input
 * still encodes as a single final literal sequence.  The JAX
 * package's pure-Python encoder implements the same algorithm step for
 * step (including the zero-initialized table's position-0 candidate
 * semantics), so its files equal these byte for byte; this package has
 * no Python mirror, and without a C compiler LZ4_RAW raises.
 *
 * API (lengths in bytes, return 0 on success, negative error codes):
 *   tpq_lz4_max_compressed_length(n)
 *   tpq_lz4_compress(in, n, out, out_cap, &produced)
 *   tpq_lz4_decompress(in, n, out, out_cap, &produced)
 */

#include <stddef.h>
#include <stdint.h>
#include <string.h>

#define TPQ_OK 0
#define TPQ_ERR_CORRUPT (-1)
#define TPQ_ERR_TOO_BIG (-2)
#define TPQ_ERR_BUFFER (-3)

#define LZ4_MIN_MATCH 4
#define LZ4_MFLIMIT 12  /* no match may start within the last 12 bytes */
#define LZ4_LASTLITERALS 5 /* the last 5 bytes are always literals */

/* ------------------------------------------------------------------ */
/* decompress                                                         */
/* ------------------------------------------------------------------ */

int tpq_lz4_decompress(const uint8_t *in, size_t n, uint8_t *out,
                       size_t out_cap, size_t *produced) {
  size_t ip = 0, op = 0;
  if (n == 0) { /* zero-byte stream only decodes to zero bytes */
    *produced = 0;
    return TPQ_OK;
  }
  for (;;) {
    if (ip >= n) return TPQ_ERR_CORRUPT; /* stream must end after the
      final literal run, not between sequences */
    uint8_t token = in[ip++];
    size_t lit = token >> 4;
    if (lit == 15) {
      uint8_t b;
      do {
        if (ip >= n) return TPQ_ERR_CORRUPT;
        b = in[ip++];
        lit += b;
        if (lit > out_cap) return TPQ_ERR_CORRUPT; /* cap runaway
          255-chains before they overflow size_t */
      } while (b == 255);
    }
    if (ip + lit > n) return TPQ_ERR_CORRUPT;
    if (op + lit > out_cap) return TPQ_ERR_BUFFER;
    memcpy(out + op, in + ip, lit);
    ip += lit;
    op += lit;
    if (ip == n) break; /* final sequence: literals only */
    if (ip + 2 > n) return TPQ_ERR_CORRUPT;
    size_t off = (size_t)in[ip] | ((size_t)in[ip + 1] << 8);
    ip += 2;
    if (off == 0 || off > op) return TPQ_ERR_CORRUPT;
    size_t mlen = (size_t)(token & 0xF);
    if (mlen == 15) {
      uint8_t b;
      do {
        if (ip >= n) return TPQ_ERR_CORRUPT;
        b = in[ip++];
        mlen += b;
        if (mlen > out_cap) return TPQ_ERR_CORRUPT;
      } while (b == 255);
    }
    mlen += LZ4_MIN_MATCH;
    if (op + mlen > out_cap) return TPQ_ERR_BUFFER;
    {
      uint8_t *dst = out + op;
      const uint8_t *src = dst - off;
      if (off >= 8) {
        if (off >= mlen) {
          memcpy(dst, src, mlen);
        } else {
          /* overlap with period >= 8: 8-byte blocks never read their
           * own output */
          size_t rem = mlen;
          while (rem >= 8) {
            memcpy(dst, src, 8);
            dst += 8;
            src += 8;
            rem -= 8;
          }
          if (rem) memcpy(dst, src, rem);
        }
      } else {
        /* short period: seed one pattern then double it */
        size_t copied = off;
        for (size_t i = 0; i < off && i < mlen; i++) dst[i] = src[i];
        if (copied < mlen) {
          while (copied * 2 <= mlen) {
            memcpy(dst + copied, dst, copied);
            copied *= 2;
          }
          memcpy(dst + copied, dst, mlen - copied);
        }
      }
    }
    op += mlen;
  }
  *produced = op;
  return TPQ_OK;
}

/* ------------------------------------------------------------------ */
/* compress                                                           */
/* ------------------------------------------------------------------ */

uint64_t tpq_lz4_max_compressed_length(uint64_t n) {
  /* one literal-only sequence: token + 255-extension bytes + payload */
  return n + n / 255 + 16;
}

#define LZ4_HASH_BITS 14
#define LZ4_HASH_SIZE (1u << LZ4_HASH_BITS)
#define LZ4_BLOCK_LOG 16
#define LZ4_BLOCK_SIZE (1u << LZ4_BLOCK_LOG)

static inline uint32_t lz4_load32(const uint8_t *p) {
  uint32_t v;
  memcpy(&v, p, 4);
  return v;
}

static inline uint32_t lz4_hash32(uint32_t v) {
  return (v * 2654435761u) >> (32 - LZ4_HASH_BITS);
}

/* token + literal-length extension + literal payload */
static size_t lz4_emit_literals(uint8_t *out, const uint8_t *data,
                                size_t lit, size_t mcode) {
  size_t i = 0;
  if (lit >= 15) {
    out[i++] = (uint8_t)((15u << 4) | mcode);
    size_t rem = lit - 15;
    while (rem >= 255) {
      out[i++] = 255;
      rem -= 255;
    }
    out[i++] = (uint8_t)rem;
  } else {
    out[i++] = (uint8_t)((lit << 4) | mcode);
  }
  memcpy(out + i, data, lit);
  return i + lit;
}

static size_t lz4_emit_match_ext(uint8_t *out, size_t mext) {
  /* extension bytes for a match length whose token nibble was 15 */
  size_t i = 0, rem = mext - 15;
  while (rem >= 255) {
    out[i++] = 255;
    rem -= 255;
  }
  out[i++] = (uint8_t)rem;
  return i;
}

int tpq_lz4_compress(const uint8_t *in, size_t n, uint8_t *out,
                     size_t out_cap, size_t *produced) {
  if (n > 0x7fffffffull) return TPQ_ERR_TOO_BIG;
  if (out_cap < tpq_lz4_max_compressed_length(n)) return TPQ_ERR_BUFFER;
  if (n == 0) { /* canonical empty block: one zero token */
    out[0] = 0;
    *produced = 1;
    return TPQ_OK;
  }
  size_t op = 0;
  uint16_t table[LZ4_HASH_SIZE];
  size_t lit_start = 0; /* ABSOLUTE: pending literals span blocks */

  for (size_t base = 0; base < n; base += LZ4_BLOCK_SIZE) {
    size_t blen = n - base < LZ4_BLOCK_SIZE ? n - base : LZ4_BLOCK_SIZE;
    const uint8_t *b = in + base;
    /* matches may neither start past blen-4 (4-byte load) nor within
     * the input's last MFLIMIT bytes (format end rule) */
    if (n < LZ4_MFLIMIT + 1 || base + LZ4_MFLIMIT > n) continue;
    size_t limit = blen >= 4 ? blen - 4 : 0;
    size_t abs_limit = n - LZ4_MFLIMIT - base; /* n >= MFLIMIT here */
    if (limit > abs_limit) limit = abs_limit;
    if (blen < 4) continue; /* tail rides the final literal flush */
    memset(table, 0, sizeof(table));
    size_t pos = 0;
    uint32_t skip = 32; /* golang-style acceleration: skip>>5 per miss */
    while (pos <= limit) {
      uint32_t key = lz4_load32(b + pos);
      uint32_t h = lz4_hash32(key);
      size_t cand = table[h];
      table[h] = (uint16_t)pos;
      if (cand < pos && lz4_load32(b + cand) == key) {
        size_t len = 4;
        /* extend to block end, but matches must stop LASTLITERALS
         * bytes before the end of the whole input */
        size_t max = blen - pos;
        size_t abs_max = (n - LZ4_LASTLITERALS) - (base + pos);
        if (max > abs_max) max = abs_max;
        while (len + 8 <= max) {
          uint64_t a, w;
          memcpy(&a, b + cand + len, 8);
          memcpy(&w, b + pos + len, 8);
          uint64_t diff = a ^ w;
          if (diff) {
            len += (size_t)(__builtin_ctzll(diff) >> 3);
            goto matched;
          }
          len += 8;
        }
        while (len < max && b[cand + len] == b[pos + len]) len++;
      matched:;
        if (len < 4) { /* end-rule clamp ate the match */
          size_t step = skip >> 5;
          pos += step;
          skip += (uint32_t)step;
          continue;
        }
        size_t lit = base + pos - lit_start;
        size_t mext = len - LZ4_MIN_MATCH;
        size_t off = pos - cand;
        op += lz4_emit_literals(out + op, in + lit_start, lit,
                                mext >= 15 ? 15 : mext);
        out[op++] = (uint8_t)off;
        out[op++] = (uint8_t)(off >> 8);
        if (mext >= 15) op += lz4_emit_match_ext(out + op, mext);
        /* seed the table inside the match so long runs keep matching */
        size_t end = pos + len;
        if (end <= limit && end >= 1) {
          size_t seed = end - 1;
          table[lz4_hash32(lz4_load32(b + seed))] = (uint16_t)seed;
        }
        pos = end;
        lit_start = base + pos;
        skip = 32;
      } else {
        size_t step = skip >> 5;
        pos += step;
        skip += (uint32_t)step;
      }
    }
    /* no per-block literal flush: the pending run carries forward */
  }
  /* final sequence: the remaining literals (>= LASTLITERALS by the
   * end rules, or the whole input when nothing matched) */
  op += lz4_emit_literals(out + op, in + lit_start, n - lit_start, 0);
  *produced = op;
  return TPQ_OK;
}
