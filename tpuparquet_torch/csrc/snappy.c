/* Snappy block codec, from scratch, for the tpuparquet_torch host runtime.
 *
 * The reference keeps its hot path in Go with golang/snappy
 * (compress.go:46-48); our host runtime is Python, where a per-token
 * interpreter loop dominates whole-file decode time, so the block codec
 * lives here in C behind a ctypes boundary.  Wire format implemented
 * from the public snappy format description: a uvarint uncompressed
 * length followed by literal/copy tags (2-bit type, 1/2/4-byte offsets).
 *
 * API (all lengths in bytes, return 0 on success, negative error codes):
 *   tpq_snappy_uncompressed_length(in, n, &len)
 *   tpq_snappy_decompress(in, n, out, out_cap, &produced)
 *   tpq_snappy_max_compressed_length(n)
 *   tpq_snappy_compress(in, n, out, out_cap, &produced)
 */

#include <stddef.h>
#include <stdint.h>
#include <string.h>

#define TPQ_OK 0
#define TPQ_ERR_CORRUPT (-1)
#define TPQ_ERR_TOO_BIG (-2)
#define TPQ_ERR_BUFFER (-3)

/* ------------------------------------------------------------------ */
/* uvarint                                                            */
/* ------------------------------------------------------------------ */

static int read_uvarint(const uint8_t *in, size_t n, size_t *pos,
                        uint64_t *out) {
  uint64_t v = 0;
  int shift = 0;
  while (*pos < n && shift < 64) {
    uint8_t b = in[(*pos)++];
    v |= (uint64_t)(b & 0x7f) << shift;
    if (!(b & 0x80)) {
      *out = v;
      return TPQ_OK;
    }
    shift += 7;
  }
  return TPQ_ERR_CORRUPT;
}

int tpq_snappy_uncompressed_length(const uint8_t *in, size_t n,
                                   uint64_t *len) {
  size_t pos = 0;
  return read_uvarint(in, n, &pos, len);
}

/* ------------------------------------------------------------------ */
/* decompress                                                         */
/* ------------------------------------------------------------------ */

/* Decompress.  When the caller provides >= 16 bytes of slack past
 * `total` in the output buffer (out_cap >= total + 16), short copies use
 * fixed-width speculative stores — the main throughput lever, since a
 * variable-length memcpy per 4..16-byte token dominates otherwise. */
int tpq_snappy_decompress(const uint8_t *in, size_t n, uint8_t *out,
                          size_t out_cap, size_t *produced) {
  size_t pos = 0;
  uint64_t total;
  int rc = read_uvarint(in, n, &pos, &total);
  if (rc != TPQ_OK) return rc;
  if (total > out_cap) return TPQ_ERR_BUFFER;
  int slack = out_cap >= total + 16;

  size_t op = 0;
  while (pos < n) {
    uint8_t tag = in[pos++];
    uint32_t kind = tag & 3;
    size_t len, off;
    if (kind == 0) { /* literal */
      len = tag >> 2;
      if (len >= 60) {
        size_t extra = len - 59;
        if (pos + extra > n) return TPQ_ERR_CORRUPT;
        len = 0;
        for (size_t i = 0; i < extra; i++)
          len |= (size_t)in[pos + i] << (8 * i);
        pos += extra;
      }
      len += 1;
      if (pos + len > n || op + len > total) return TPQ_ERR_CORRUPT;
      if (slack && len <= 16 && pos + 16 <= n) {
        memcpy(out + op, in + pos, 16); /* fixed-size: two stores */
      } else {
        memcpy(out + op, in + pos, len);
      }
      pos += len;
      op += len;
      continue;
    }
    if (kind == 1) {
      if (pos >= n) return TPQ_ERR_CORRUPT;
      len = ((tag >> 2) & 0x7) + 4;
      off = ((size_t)(tag >> 5) << 8) | in[pos];
      pos += 1;
    } else if (kind == 2) {
      if (pos + 2 > n) return TPQ_ERR_CORRUPT;
      len = (tag >> 2) + 1;
      off = (size_t)in[pos] | ((size_t)in[pos + 1] << 8);
      pos += 2;
    } else {
      if (pos + 4 > n) return TPQ_ERR_CORRUPT;
      len = (tag >> 2) + 1;
      off = (size_t)in[pos] | ((size_t)in[pos + 1] << 8) |
            ((size_t)in[pos + 2] << 16) | ((size_t)in[pos + 3] << 24);
      pos += 4;
    }
    if (off == 0 || off > op || op + len > total) return TPQ_ERR_CORRUPT;
    {
      uint8_t *dst = out + op;
      const uint8_t *src = dst - off;
      if (off >= 8) {
        if (slack && len <= 16) {
          /* speculative, bounded by slack; split so each memcpy's
           * src/dst stay disjoint when 8 <= off < 16 */
          if (off >= 16) {
            memcpy(dst, src, 16);
          } else {
            memcpy(dst, src, 8);
            memcpy(dst + 8, src + 8, 8);
          }
        } else if (off >= len) {
          memcpy(dst, src, len);
        } else {
          /* overlap with period >= 8: 8-byte blocks never read their
           * own output */
          size_t rem = len;
          while (rem >= 8) {
            memcpy(dst, src, 8);
            dst += 8;
            src += 8;
            rem -= 8;
          }
          if (rem) memcpy(dst, src, slack ? 8 : rem);
        }
      } else {
        /* short period: seed one pattern then double it */
        size_t copied = off;
        for (size_t i = 0; i < off && i < len; i++) dst[i] = src[i];
        if (copied < len) {
          while (copied * 2 <= len) {
            memcpy(dst + copied, dst, copied);
            copied *= 2;
          }
          memcpy(dst + copied, dst, len - copied);
        }
      }
    }
    op += len;
  }
  if (op != total) return TPQ_ERR_CORRUPT;
  *produced = op;
  return TPQ_OK;
}

/* ------------------------------------------------------------------ */
/* compress                                                           */
/* ------------------------------------------------------------------ */

uint64_t tpq_snappy_max_compressed_length(uint64_t n) {
  /* worst case: varint header + one literal token set per 2^16 chunk */
  return 32 + n + n / 6;
}

static size_t emit_uvarint(uint8_t *out, uint64_t v) {
  size_t i = 0;
  while (v >= 0x80) {
    out[i++] = (uint8_t)(v | 0x80);
    v >>= 7;
  }
  out[i++] = (uint8_t)v;
  return i;
}

static size_t emit_literal(uint8_t *out, const uint8_t *data, size_t len) {
  size_t i = 0;
  size_t l = len - 1;
  if (l < 60) {
    out[i++] = (uint8_t)(l << 2);
  } else if (l < 256) {
    out[i++] = 60 << 2;
    out[i++] = (uint8_t)l;
  } else if (l < 65536) {
    out[i++] = 61 << 2;
    out[i++] = (uint8_t)l;
    out[i++] = (uint8_t)(l >> 8);
  } else if (l < (1u << 24)) {
    out[i++] = 62 << 2;
    out[i++] = (uint8_t)l;
    out[i++] = (uint8_t)(l >> 8);
    out[i++] = (uint8_t)(l >> 16);
  } else {
    out[i++] = 63 << 2;
    out[i++] = (uint8_t)l;
    out[i++] = (uint8_t)(l >> 8);
    out[i++] = (uint8_t)(l >> 16);
    out[i++] = (uint8_t)(l >> 24);
  }
  memcpy(out + i, data, len);
  return i + len;
}

static size_t emit_copy(uint8_t *out, size_t off, size_t len) {
  size_t i = 0;
  /* long matches: peel 64-byte 2-byte-offset copies */
  while (len >= 68) {
    out[i++] = (63 << 2) | 2;
    out[i++] = (uint8_t)off;
    out[i++] = (uint8_t)(off >> 8);
    len -= 64;
  }
  if (len > 64) { /* leave >= 4 for the final copy */
    out[i++] = (59 << 2) | 2;
    out[i++] = (uint8_t)off;
    out[i++] = (uint8_t)(off >> 8);
    len -= 60;
  }
  if (len >= 12 || off >= 2048) {
    out[i++] = (uint8_t)(((len - 1) << 2) | 2);
    out[i++] = (uint8_t)off;
    out[i++] = (uint8_t)(off >> 8);
  } else {
    out[i++] = (uint8_t)(((off >> 8) << 5) | ((len - 4) << 2) | 1);
    out[i++] = (uint8_t)off;
  }
  return i;
}

#define HASH_BITS 14
#define HASH_SIZE (1u << HASH_BITS)

static inline uint32_t load32(const uint8_t *p) {
  uint32_t v;
  memcpy(&v, p, 4);
  return v;
}

static inline uint32_t hash32(uint32_t v) {
  return (v * 0x1e35a7bdu) >> (32 - HASH_BITS);
}

/* min_match: shortest back-reference worth emitting.  8 is the decode-
 * throughput sweet spot for numeric column data (short copies decode
 * token-at-a-time); 4 recovers the ratio on text/byte-array pages whose
 * redundancy is mostly 4..7-byte matches.  Values < 4 clamp to 4 (the
 * format's copy minimum).
 *
 * The encoder works in 64 KiB blocks (the upstream snappy fragment
 * size): match candidates never leave the current block, so the hash
 * table holds uint16 block-relative positions — 32 KiB, L1-resident,
 * where the former whole-input uint32 table thrashed on multi-MB page
 * bodies (the config-2 write wall measured this encoder at ~360 MB/s;
 * the block form runs close to memory speed on the same bodies).
 * Offsets are <= 65535 by construction, so every copy fits the 1/2-
 * byte forms.  Stale table entries from the previous block are
 * harmless: the 4-byte load32 compare validates every candidate, and
 * `cand < pos` rejects self/forward references. */
#define BLOCK_LOG 16
#define BLOCK_SIZE (1u << BLOCK_LOG)

int tpq_snappy_compress_opt(const uint8_t *in, size_t n, uint8_t *out,
                            size_t out_cap, size_t *produced,
                            int min_match) {
  if (n > 0xffffffffu) return TPQ_ERR_TOO_BIG; /* literal length
    encoding holds lengths as uint32 */
  size_t min_len = min_match < 4 ? 4 : (size_t)min_match;
  if (out_cap < tpq_snappy_max_compressed_length(n)) return TPQ_ERR_BUFFER;
  size_t op = emit_uvarint(out, n);

  uint16_t table[HASH_SIZE];
  size_t lit_start = 0; /* ABSOLUTE: pending literals span blocks, so
    an incompressible input still compresses to one literal token —
    the decode side's zero-copy single-literal view depends on it */

  for (size_t base = 0; base < n; base += BLOCK_SIZE) {
    size_t blen = n - base < BLOCK_SIZE ? n - base : BLOCK_SIZE;
    const uint8_t *b = in + base;
    if (blen < 4)
      continue; /* tail bytes ride the final literal flush */
    memset(table, 0, sizeof(table));
    size_t pos = 0;
    size_t limit = blen - 4;
    uint32_t skip = 32; /* golang-style acceleration: skip>>5 per miss */
    while (pos <= limit) {
      uint32_t key = load32(b + pos);
      uint32_t h = hash32(key);
      size_t cand = table[h];
      table[h] = (uint16_t)pos;
      if (cand < pos && load32(b + cand) == key) {
        size_t len = 4;
        size_t max = blen - pos;
        /* extend 8 bytes at a time; the xor's lowest set bit locates
         * the first mismatch (little-endian), so long matches cost one
         * comparison per word instead of per byte */
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
        /* Short copies cost ~as many compressed bytes as the literal
         * they replace but decode token-at-a-time; dense 4..7-byte
         * matches (typical for numeric column data) would cap
         * decompression near 1 GB/s — hence the caller-set floor. */
        if (len < min_len) {
          size_t step = skip >> 5;
          pos += step;
          skip += (uint32_t)step;
          continue;
        }
        if (base + pos > lit_start)
          op += emit_literal(out + op, in + lit_start,
                             base + pos - lit_start);
        op += emit_copy(out + op, pos - cand, len);
        /* seed the table inside the match so long runs keep matching */
        size_t end = pos + len;
        if (end <= limit) {
          size_t seed = end - 1;
          table[hash32(load32(b + seed))] = (uint16_t)seed;
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
  if (n > lit_start)
    op += emit_literal(out + op, in + lit_start, n - lit_start);
  *produced = op;
  return TPQ_OK;
}

int tpq_snappy_compress(const uint8_t *in, size_t n, uint8_t *out,
                        size_t out_cap, size_t *produced) {
  return tpq_snappy_compress_opt(in, n, out, out_cap, produced, 8);
}

/* ------------------------------------------------------------------ */
/* Token scan for the device (CUDA) decompressor: parse the tag stream
 * into a token table + concatenated literal bytes WITHOUT materializing
 * the output.  Host work is O(#tokens + literal bytes); the copy
 * resolution runs on device as log2(n) pointer-doubling gathers.
 * Token i covers output [tok_out_end[i-1], tok_out_end[i]); tok_src[i]
 * is -(literal_offset+1) for literals, or the absolute output position
 * the copy reads from (strictly before its own start + within). */

int tpq_snappy_scan_tokens(const uint8_t *in, size_t n,
                           int64_t *tok_out_end, int64_t *tok_src,
                           int64_t cap_tokens,
                           uint8_t *lit_out, size_t lit_cap,
                           int64_t *n_tokens, size_t *lit_len,
                           uint64_t *out_len) {
  size_t pos = 0;
  uint64_t total;
  int rc = read_uvarint(in, n, &pos, &total);
  if (rc != TPQ_OK) return rc;

  size_t op = 0, lp = 0;
  int64_t t = 0;
  while (pos < n) {
    uint8_t tag = in[pos++];
    uint32_t kind = tag & 3;
    size_t len, off;
    if (t >= cap_tokens) return TPQ_ERR_BUFFER;
    if (kind == 0) {
      len = tag >> 2;
      if (len >= 60) {
        size_t extra = len - 59;
        if (pos + extra > n) return TPQ_ERR_CORRUPT;
        len = 0;
        for (size_t i = 0; i < extra; i++)
          len |= (size_t)in[pos + i] << (8 * i);
        pos += extra;
      }
      len += 1;
      if (pos + len > n || op + len > total) return TPQ_ERR_CORRUPT;
      if (lp + len > lit_cap) return TPQ_ERR_BUFFER;
      memcpy(lit_out + lp, in + pos, len);
      tok_src[t] = -((int64_t)lp + 1);
      lp += len;
      pos += len;
      op += len;
      tok_out_end[t++] = (int64_t)op;
      continue;
    }
    if (kind == 1) {
      if (pos >= n) return TPQ_ERR_CORRUPT;
      len = ((tag >> 2) & 0x7) + 4;
      off = ((size_t)(tag >> 5) << 8) | in[pos];
      pos += 1;
    } else if (kind == 2) {
      if (pos + 2 > n) return TPQ_ERR_CORRUPT;
      len = (tag >> 2) + 1;
      off = (size_t)in[pos] | ((size_t)in[pos + 1] << 8);
      pos += 2;
    } else {
      if (pos + 4 > n) return TPQ_ERR_CORRUPT;
      len = (tag >> 2) + 1;
      off = (size_t)in[pos] | ((size_t)in[pos + 1] << 8) |
            ((size_t)in[pos + 2] << 16) | ((size_t)in[pos + 3] << 24);
      pos += 4;
    }
    if (off == 0 || off > op || op + len > total) return TPQ_ERR_CORRUPT;
    tok_src[t] = (int64_t)(op - off);
    op += len;
    tok_out_end[t++] = (int64_t)op;
  }
  if (op != total) return TPQ_ERR_CORRUPT;
  *n_tokens = t;
  *lit_len = lp;
  *out_len = total;
  return TPQ_OK;
}
