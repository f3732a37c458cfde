/* CRC32C (Castagnoli, reflected polynomial 0x82F63B78) for the wire
 * checksum of byteps_tpu_torch.comm.transport.
 *
 * The same slice-by-8 table algorithm as byteps_tpu/native/wire.h, so a
 * frame stamped by either package verifies on the other.  Chained:
 * bps_crc32c(B, bps_crc32c(A, 0)) == bps_crc32c(A||B, 0), and
 * bps_crc32c("123456789", 0) == 0xE3069283.  Built by the host C compiler
 * at first use (ops/_build.py) and called through ctypes, which releases
 * the interpreter lock for the call.
 */
#include <stddef.h>
#include <stdint.h>
#include <string.h>

static uint32_t tbl[8][256];

/* filled once when the library is loaded, before any call can read it */
__attribute__((constructor)) static void init_tables(void) {
  for (uint32_t i = 0; i < 256; ++i) {
    uint32_t c = i;
    for (int k = 0; k < 8; ++k) c = (c >> 1) ^ ((c & 1) ? 0x82F63B78u : 0);
    tbl[0][i] = c;
  }
  for (uint32_t i = 0; i < 256; ++i)
    for (int t = 1; t < 8; ++t)
      tbl[t][i] = (tbl[t - 1][i] >> 8) ^ tbl[0][tbl[t - 1][i] & 0xFF];
}

uint32_t bps_crc32c(const void* data, size_t n, uint32_t crc) {
  const uint8_t* p = (const uint8_t*)data;
  uint32_t c = crc ^ 0xFFFFFFFFu;
  while (n >= 8) {
    uint32_t lo, hi;
    memcpy(&lo, p, 4);
    memcpy(&hi, p + 4, 4);
#if __BYTE_ORDER__ == __ORDER_BIG_ENDIAN__
    lo = __builtin_bswap32(lo);
    hi = __builtin_bswap32(hi);
#endif
    lo ^= c;
    c = tbl[7][lo & 0xFF] ^ tbl[6][(lo >> 8) & 0xFF] ^
        tbl[5][(lo >> 16) & 0xFF] ^ tbl[4][lo >> 24] ^
        tbl[3][hi & 0xFF] ^ tbl[2][(hi >> 8) & 0xFF] ^
        tbl[1][(hi >> 16) & 0xFF] ^ tbl[0][hi >> 24];
    p += 8;
    n -= 8;
  }
  while (n--) c = (c >> 8) ^ tbl[0][(c ^ *p++) & 0xFF];
  return c ^ 0xFFFFFFFFu;
}
