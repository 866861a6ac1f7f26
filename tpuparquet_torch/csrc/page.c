/* Write-side page assembly: the C core of io/pages.py's native page
 * path (_write_page_native).
 *
 * The pure page writer builds a page body from separate bytes objects
 * (length-prefixed level streams, the dictionary-index stream, the
 * values) joined in a bytearray, then copies it once more into the block
 * compressor and reads it again for the CRC.  tpq_page_encode lays the
 * whole body into one caller buffer in one pass; compression and the CRC
 * then run over that buffer in place.  The bytes are the pure path's by
 * construction: the level and index streams come from the same hybrid
 * encoder (hybrid.c tpq_hybrid_encode32), the values are copied
 * verbatim, and tpq_crc32 is zlib's CRC-32.
 */

#include <stddef.h>
#include <stdint.h>
#include <string.h>

/* the level and index streams come from the writer's own hybrid
 * encoder, built into this library beside the page pass */
#include "hybrid.c"

/* ------------------------------------------------------------------ */
/* CRC32 (zlib/gzip polynomial 0xEDB88320, reflected) — slice-by-8.
 * Matches zlib.crc32 bit for bit; the PageHeader.crc field is the
 * same CRC parquet-mr and pyarrow verify.                            */
/* ------------------------------------------------------------------ */

static uint32_t crc_tab[8][256];

__attribute__((constructor)) static void crc_init(void) {
  for (uint32_t i = 0; i < 256; i++) {
    uint32_t c = i;
    for (int k = 0; k < 8; k++)
      c = (c & 1) ? 0xEDB88320u ^ (c >> 1) : c >> 1;
    crc_tab[0][i] = c;
  }
  for (uint32_t i = 0; i < 256; i++) {
    uint32_t c = crc_tab[0][i];
    for (int t = 1; t < 8; t++) {
      c = crc_tab[0][c & 0xff] ^ (c >> 8);
      crc_tab[t][i] = c;
    }
  }
}

uint32_t tpq_crc32(const uint8_t *p, long long n, uint32_t crc) {
  crc = ~crc;
  while (n && ((uintptr_t)p & 7)) {
    crc = crc_tab[0][(crc ^ *p++) & 0xff] ^ (crc >> 8);
    n--;
  }
  while (n >= 8) {
    uint32_t lo, hi;
    memcpy(&lo, p, 4);
    memcpy(&hi, p + 4, 4);
    lo ^= crc;
    crc = crc_tab[7][lo & 0xff] ^ crc_tab[6][(lo >> 8) & 0xff] ^
          crc_tab[5][(lo >> 16) & 0xff] ^ crc_tab[4][lo >> 24] ^
          crc_tab[3][hi & 0xff] ^ crc_tab[2][(hi >> 8) & 0xff] ^
          crc_tab[1][(hi >> 16) & 0xff] ^ crc_tab[0][hi >> 24];
    p += 8;
    n -= 8;
  }
  while (n--) crc = crc_tab[0][(crc ^ *p++) & 0xff] ^ (crc >> 8);
  return ~crc;
}

/* ------------------------------------------------------------------ */
/* Page body encode                                                   */
/* ------------------------------------------------------------------ */

/* Lay a data page's uncompressed body into out in one pass:
 *
 *   [rep level stream][def level stream][values segment]
 *
 * Level streams are the hybrid encode of n u32 levels; with v2 == 0
 * each is preceded by its 4-byte LE byte length (the V1 framing),
 * with v2 != 0 they are raw (V2 keeps lengths in the page header).
 * A NULL rep/dl pointer skips that stream entirely (max level 0).
 * The values segment is either the dictionary-index stream (idx !=
 * NULL: one width byte + hybrid encode of n_idx u32 indices) or the
 * caller's pre-encoded bytes memcpy'd verbatim.
 *
 * Returns 0 and fills *rep_len / *dl_len / *val_len (framing
 * included; body length is their sum), -1 if a level/index exceeds
 * its width, -2 on a bad width, -3 when cap would overflow. */
long long tpq_page_encode(const uint32_t *rep, const uint32_t *dl,
                          long long n, int rep_width, int def_width,
                          int v2, const uint32_t *idx, long long n_idx,
                          int idx_width, const uint8_t *values,
                          long long values_len, uint8_t *out,
                          long long cap, long long *rep_len,
                          long long *dl_len, long long *val_len) {
  long long o = 0;
  const int prefix = v2 ? 0 : 4;
  *rep_len = *dl_len = *val_len = 0;
  for (int s = 0; s < 2; s++) {
    const uint32_t *lv = s == 0 ? rep : dl;
    int width = s == 0 ? rep_width : def_width;
    if (lv == NULL)
      continue;
    if (o + prefix > cap)
      return -3;
    long long body = 0;
    long long rc = tpq_hybrid_encode32(lv, n, width, out + o + prefix,
                                       cap - o - prefix, &body);
    if (rc != 0)
      return rc;
    if (prefix) { /* 4-byte LE length, written after the size is known */
      uint32_t le = (uint32_t)body;
      memcpy(out + o, &le, 4);
    }
    o += prefix + body;
    *(s == 0 ? rep_len : dl_len) = prefix + body;
  }
  if (idx != NULL) {
    if (o + 1 > cap)
      return -3;
    out[o] = (uint8_t)idx_width;
    long long body = 0;
    long long rc = tpq_hybrid_encode32(idx, n_idx, idx_width, out + o + 1,
                                       cap - o - 1, &body);
    if (rc != 0)
      return rc;
    o += 1 + body;
    *val_len = 1 + body;
  } else if (values_len > 0) {
    if (o + values_len > cap)
      return -3;
    memcpy(out + o, values, (size_t)values_len);
    o += values_len;
    *val_len = values_len;
  }
  return 0;
}
