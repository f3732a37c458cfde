// Shared wire definitions for the framed PS protocol — single source of
// truth for the C++ server (ps_server.cc) and worker client
// (ps_client.cc).  Must stay byte-compatible with the Python framing in
// byteps_tpu/comm/transport.py: 32-byte big-endian header + raw payload,
// with an optional 16-byte (trace_id, span_id) block between header and
// payload when the status byte carries kTraceFlag.
#ifndef BYTEPS_TPU_NATIVE_WIRE_H_
#define BYTEPS_TPU_NATIVE_WIRE_H_

#include <arpa/inet.h>
#include <endian.h>
#include <strings.h>

#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>

namespace bps_wire {

constexpr uint8_t kMagic = 0xB5;

//: status-byte bit: a 16-byte (u64 trace_id + u64 span_id) block follows
//: the header, BEFORE the payload (transport.py TRACE_FLAG)
constexpr uint8_t kTraceFlag = 0x80;

//: status-byte bit: a 4-byte big-endian CRC32C of (trace block + payload)
//: follows the header (after the trace block), BEFORE the payload
//: (transport.py CHECKSUM_FLAG; docs/robustness.md "Wire integrity")
constexpr uint8_t kChecksumFlag = 0x40;

//: status-byte bit: the payload is a lossless container
//: (compression/lossless.py frame format) — header `length` and the
//: CRC32C cover the COMPRESSED bytes; the receiver decompresses after
//: integrity passes.  A bit no pre-lossless decoder sets or strips:
//: old receivers see nonzero status and refuse the frame cleanly
//: (transport.py LOSSLESS_FLAG)
constexpr uint8_t kLosslessFlag = 0x20;

// transport.py Op enum (data-plane subset the native code speaks)
enum Opcode : uint8_t {
  kInit = 10,
  kPush = 11,
  kPull = 12,
  kRegisterCompressor = 13,
  kFused = 14,   // multi-key fused push+pull frame (docs/perf.md)
  kPing = 20,
  kShutdown = 21,
  // recovery plane (docs/robustness.md "healing flow")
  kResyncQuery = 23,
  kResyncState = 24,
  // elastic resharding plane (docs/robustness.md "migration flow").
  // The native engine REPLIES kWrongOwner for keys the adopted
  // ownership map homes elsewhere, but cannot import or export key
  // state — kMigrateState is listed for documentation and deliberately
  // falls through to the clean unknown-op status=1 echo, so a Python
  // old owner's shipment is refused (it rolls back and stays
  // authoritative) instead of silently dropped.
  kMigrateState = 25,
  kWrongOwner = 26,
};

#pragma pack(push, 1)
struct Header {
  uint8_t magic, op, status, flags;
  uint32_t seq;      // network order on the wire
  uint64_t key;      // network order on the wire
  uint32_t cmd;      // Cantor-encoded (RequestType, DataType)
  uint32_t version;  // round / generation
  uint64_t length;   // payload byte count
};
#pragma pack(pop)
static_assert(sizeof(Header) == 32, "wire header must be 32 bytes");

// The ONE header encoder both native halves (and the golden-fixture
// shim) go through — a byte-order bug can no longer live in only the
// client or only the server.
inline void pack_header(Header* h, uint8_t op, uint8_t status, uint8_t flags,
                        uint32_t seq, uint64_t key, uint32_t cmd,
                        uint32_t version, uint64_t length) {
  h->magic = kMagic;
  h->op = op;
  h->status = status;
  h->flags = flags;
  h->seq = htonl(seq);
  h->key = htobe64(key);
  h->cmd = htonl(cmd);
  h->version = htonl(version);
  h->length = htobe64(length);
}

// Optional trace-context block (appended after the header when status
// carries kTraceFlag; `length` still counts only the payload).
inline void pack_trace(uint8_t out[16], uint64_t trace_id, uint64_t span_id) {
  uint64_t t = htobe64(trace_id), s = htobe64(span_id);
  std::memcpy(out, &t, 8);
  std::memcpy(out + 8, &s, 8);
}

// Inverse of pack_trace: decode the wire block into host-order ids
// (server-side span stamping joins child spans onto these).
inline void unpack_trace(const uint8_t in[16], uint64_t* trace_id,
                         uint64_t* span_id) {
  uint64_t t, s;
  std::memcpy(&t, in, 8);
  std::memcpy(&s, in + 8, 8);
  *trace_id = be64toh(t);
  *span_id = be64toh(s);
}

// --- end-to-end wire integrity (kChecksumFlag) -----------------------------
//
// CRC32C (Castagnoli 0x1EDC6F41, reflected 0x82F63B78) over everything
// after the fixed 32-byte header except the checksum block itself: the
// optional trace block chained with the whole payload.  Slice-by-8
// software implementation (~GB/s — the checksum must stay in the noise
// of a fused sum) shared by BOTH native halves and, via the
// bps_wire_crc32c ctypes shim, by transport.py — one implementation,
// no drift.  Semantics match the Python fallback exactly:
// crc32c(B, crc32c(A)) == crc32c(A||B), crc32c("123456789") = 0xE3069283.

inline const uint32_t (*crc32c_tables())[256] {
  static uint32_t tbl[8][256];
  static const bool init = [] {
    for (uint32_t i = 0; i < 256; ++i) {
      uint32_t c = i;
      for (int k = 0; k < 8; ++k) c = (c >> 1) ^ ((c & 1) ? 0x82F63B78u : 0);
      tbl[0][i] = c;
    }
    for (uint32_t i = 0; i < 256; ++i)
      for (int t = 1; t < 8; ++t)
        tbl[t][i] = (tbl[t - 1][i] >> 8) ^ tbl[0][tbl[t - 1][i] & 0xFF];
    return true;
  }();
  (void)init;
  return tbl;
}

inline uint32_t crc32c(const void* data, size_t n, uint32_t crc = 0) {
  const uint32_t (*tbl)[256] = crc32c_tables();
  const uint8_t* p = (const uint8_t*)data;
  uint32_t c = crc ^ 0xFFFFFFFFu;
  while (n >= 8) {
    uint32_t lo, hi;
    std::memcpy(&lo, p, 4);
    std::memcpy(&hi, p + 4, 4);
#if __BYTE_ORDER == __BIG_ENDIAN
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

// Which ops carry a checksum when stamping is on — the data plane only,
// mirroring transport.py _CHECKSUM_OPS (change both together): control
// frames stay byte-identical so arming the knob never perturbs them.
inline bool checksum_op(uint8_t op) {
  switch (op) {
    case kInit:
    case kPush:
    case kPull:
    case kRegisterCompressor:
    case kFused:
    case kResyncQuery:
    case kResyncState:
    case kMigrateState:
    case kWrongOwner:
      return true;
    default:
      return false;
  }
}

// The ONE place the integrity knobs are parsed on the C++ side (both
// engines call these at start/create) — truthiness mirrors transport.py
// wire_checksum_enabled()/checksum_conn_limit() exactly (change all
// together): ""/0/false/no/off = off; conn limit default 8, 0 = never
// escalate, negatives/garbage = default.
inline bool checksum_env_on() {
  const char* v = getenv("BYTEPS_WIRE_CHECKSUM");
  if (!v || !*v) return false;
  return !(strcmp(v, "0") == 0 || strcasecmp(v, "false") == 0 ||
           strcasecmp(v, "no") == 0 || strcasecmp(v, "off") == 0);
}

inline uint32_t checksum_env_conn_limit() {
  const char* v = getenv("BYTEPS_CHECKSUM_CONN_LIMIT");
  if (!v || !*v) return 8;
  char* end = nullptr;
  long n = strtol(v, &end, 10);
  if (end == v || n < 0) return 8;
  return (uint32_t)n;
}

// --- lossless frame compression (kLosslessFlag) ----------------------------
//
// Byte-oriented LZ for the bit-exactness-critical control-plane payloads
// (MIGRATE_STATE / RESYNC_STATE bodies, optimizer-slot blocks) — the
// traffic lossy codecs can't touch.  Container and token stream are
// byte-identical to compression/lossless.py (change both together;
// tests/test_lossless.py pins the parity via the bps_wire_lossless_*
// shims): 10-byte container [4-byte magic B5 'L' 'Z' '0', version 1,
// method (0 store / 1 LZ), u32 BE raw length], then an LZ4-block-style
// greedy token stream — literal/match nibbles with 255-continuation,
// 2-byte little-endian offsets, MINMATCH 4, single-probe 8192-slot
// Knuth hash, final sequence literals-only.  Deterministic by
// construction, so both engines emit the same bytes for the same input.

constexpr uint8_t kLosslessMagic[4] = {0xB5, 'L', 'Z', '0'};
constexpr uint8_t kLosslessVersion = 1;
constexpr uint8_t kLosslessStore = 0;
constexpr uint8_t kLosslessLZ = 1;
constexpr size_t kLosslessHeader = 10;
//: payloads below this never win after the container — skip the
//: compressor (compression/lossless.py MIN_BYTES)
constexpr size_t kLosslessMinBytes = 64;

inline size_t lossless_bound(size_t n) { return n + n / 255 + 16; }

// Greedy single-probe LZ block (no container); returns compressed size,
// or 0 when `dst` (of `cap` bytes) cannot hold the stream — callers pass
// lossless_bound(n) and then store when the result is not smaller.
inline size_t lossless_lz_compress(const uint8_t* src, size_t n,
                                   uint8_t* dst, size_t cap) {
  size_t out = 0;
  auto emit_seq = [&](size_t lit_start, size_t lit_len, size_t offset,
                      size_t mlen) -> bool {
    size_t ml = offset ? mlen - 4 : 0;
    size_t need = 1 + lit_len + (lit_len >= 15 ? (lit_len - 15) / 255 + 1 : 0)
                  + (offset ? 2 + (ml >= 15 ? (ml - 15) / 255 + 1 : 0) : 0);
    if (out + need > cap) return false;
    dst[out++] = (uint8_t)(((lit_len < 15 ? lit_len : 15) << 4)
                           | (ml < 15 ? ml : 15));
    if (lit_len >= 15) {
      size_t rem = lit_len - 15;
      while (rem >= 255) { dst[out++] = 255; rem -= 255; }
      dst[out++] = (uint8_t)rem;
    }
    std::memcpy(dst + out, src + lit_start, lit_len);
    out += lit_len;
    if (offset) {
      dst[out++] = (uint8_t)(offset & 0xFF);
      dst[out++] = (uint8_t)(offset >> 8);
      if (ml >= 15) {
        size_t rem = ml - 15;
        while (rem >= 255) { dst[out++] = 255; rem -= 255; }
        dst[out++] = (uint8_t)rem;
      }
    }
    return true;
  };
  if (n < 4) return emit_seq(0, n, 0, 0) ? out : 0;
  int32_t table[1 << 13];
  std::memset(table, 0xFF, sizeof(table));
  ptrdiff_t mflimit = (ptrdiff_t)n - 12;  // no match begins past here...
  size_t matchlimit = n - 5;              // ...nor extends past here
  size_t anchor = 0, pos = 0;
  while ((ptrdiff_t)pos <= mflimit) {
    uint32_t v;
    std::memcpy(&v, src + pos, 4);
#if __BYTE_ORDER == __BIG_ENDIAN
    v = __builtin_bswap32(v);
#endif
    uint32_t h = (uint32_t)(v * 2654435761u) >> 19;
    int32_t cand = table[h];
    table[h] = (int32_t)pos;
    if (cand >= 0 && pos - (size_t)cand <= 65535 &&
        std::memcmp(src + cand, src + pos, 4) == 0) {
      size_t mlen = 4;
      while (pos + mlen < matchlimit && src[cand + mlen] == src[pos + mlen])
        ++mlen;
      if (!emit_seq(anchor, pos - anchor, pos - (size_t)cand, mlen)) return 0;
      anchor = pos + mlen;
      pos = anchor;
    } else {
      ++pos;
    }
  }
  return emit_seq(anchor, n - anchor, 0, 0) ? out : 0;
}

// Inverse of lossless_lz_compress; every read and copy is validated
// against the input and the declared raw length.  Returns raw_len on
// success, -1 on any violation — fail closed, the caller drops the frame.
inline long lossless_lz_decompress(const uint8_t* src, size_t n,
                                   uint8_t* dst, size_t raw_len) {
  size_t pos = 0, out = 0;
  for (;;) {
    if (pos >= n) return -1;  // truncated token stream
    uint8_t token = src[pos++];
    size_t lit_len = token >> 4;
    if (lit_len == 15) {
      uint8_t b;
      do {
        if (pos >= n) return -1;
        b = src[pos++];
        lit_len += b;
      } while (b == 255);
    }
    if (pos + lit_len > n || out + lit_len > raw_len) return -1;
    std::memcpy(dst + out, src + pos, lit_len);
    pos += lit_len;
    out += lit_len;
    if (pos == n) break;  // final literals-only sequence
    if (pos + 2 > n) return -1;
    size_t offset = (size_t)src[pos] | ((size_t)src[pos + 1] << 8);
    pos += 2;
    if (offset == 0 || offset > out) return -1;
    size_t mlen = token & 15;
    if (mlen == 15) {
      uint8_t b;
      do {
        if (pos >= n) return -1;
        b = src[pos++];
        mlen += b;
      } while (b == 255);
    }
    mlen += 4;
    if (out + mlen > raw_len) return -1;
    const uint8_t* from = dst + out - offset;
    for (size_t i = 0; i < mlen; ++i) dst[out + i] = from[i];  // overlap-safe
    out += mlen;
  }
  return out == raw_len ? (long)raw_len : -1;
}

// data → self-describing container in `dst` (cap must be at least
// kLosslessHeader + lossless_bound(n)); always succeeds via the store
// method when LZ does not win.  Returns the container size.
inline size_t lossless_compress_frame(const uint8_t* src, size_t n,
                                      uint8_t* dst, size_t cap) {
  if (cap < kLosslessHeader + n) return 0;
  std::memcpy(dst, kLosslessMagic, 4);
  dst[4] = kLosslessVersion;
  uint32_t be = htonl((uint32_t)n);
  std::memcpy(dst + 6, &be, 4);
  if (n >= kLosslessMinBytes && cap > kLosslessHeader) {
    size_t c = lossless_lz_compress(src, n, dst + kLosslessHeader,
                                    cap - kLosslessHeader);
    if (c > 0 && c < n) {
      dst[5] = kLosslessLZ;
      return kLosslessHeader + c;
    }
  }
  dst[5] = kLosslessStore;
  std::memcpy(dst + kLosslessHeader, src, n);
  return kLosslessHeader + n;
}

// Container → raw bytes; returns the raw length, or -1 on any corruption
// (bad magic/version/method, truncation, length mismatch).  `dst` must
// hold lossless_raw_len(...) bytes.
inline long lossless_raw_len(const uint8_t* src, size_t n) {
  if (n < kLosslessHeader) return -1;
  if (std::memcmp(src, kLosslessMagic, 4) != 0) return -1;
  if (src[4] != kLosslessVersion) return -1;
  uint32_t be;
  std::memcpy(&be, src + 6, 4);
  return (long)ntohl(be);
}

inline long lossless_decompress_frame(const uint8_t* src, size_t n,
                                      uint8_t* dst, size_t dst_cap) {
  long raw = lossless_raw_len(src, n);
  if (raw < 0 || (size_t)raw > dst_cap) return -1;
  uint8_t method = src[5];
  const uint8_t* body = src + kLosslessHeader;
  size_t body_len = n - kLosslessHeader;
  if (method == kLosslessStore) {
    if (body_len != (size_t)raw) return -1;
    std::memcpy(dst, body, body_len);
    return raw;
  }
  if (method != kLosslessLZ) return -1;
  return lossless_lz_decompress(body, body_len, dst, (size_t)raw);
}

// Stamp outgoing frames with lossless compression?  Mirrors transport.py
// wire_lossless_enabled() (BYTEPS_WIRE_LOSSLESS, default off, same
// truthiness as checksum_env_on — change both together).  Decode is NOT
// gated on this: any received frame carrying kLosslessFlag is decoded.
inline bool lossless_env_on() {
  const char* v = getenv("BYTEPS_WIRE_LOSSLESS");
  if (!v || !*v) return false;
  return !(strcmp(v, "0") == 0 || strcasecmp(v, "false") == 0 ||
           strcasecmp(v, "no") == 0 || strcasecmp(v, "off") == 0);
}

// Ops whose payloads auto-compress when stamping is on — the
// bit-exactness-critical control plane only, mirroring transport.py
// _LOSSLESS_OPS (change both together).  Gradient-plane frames keep
// their own (lossy / per-key tuned) codecs.
inline bool lossless_op(uint8_t op) {
  switch (op) {
    case kResyncState:
    case kMigrateState:
      return true;
    default:
      return false;
  }
}

//: largest pre-payload prefix: header (32) + trace (16) + crc (4)
constexpr size_t kMaxHeadLen = 52;

// Build the complete pre-payload prefix of one frame — header, optional
// trace block (trace_id != 0), optional CRC32C block — the ONE encode
// path the native server's send_msg, the native client's bpsc_send2,
// and the golden-fixture shims all go through.  The CRC covers the
// trace block chained with the payload (everything after the fixed
// header except itself — transport.py frame_checksum parity).  Returns
// the prefix length.
inline size_t build_head(uint8_t out[kMaxHeadLen], uint8_t op,
                         uint8_t base_status, uint8_t flags, uint32_t seq,
                         uint64_t key, uint32_t cmd, uint32_t version,
                         const void* payload, uint64_t len, uint64_t trace_id,
                         uint64_t span_id, bool checksum) {
  Header hd;
  uint8_t status = base_status;
  if (trace_id) status |= kTraceFlag;
  if (checksum) status |= kChecksumFlag;
  pack_header(&hd, op, status, flags, seq, key, cmd, version, len);
  std::memcpy(out, &hd, sizeof(hd));
  size_t off = sizeof(hd);
  if (trace_id) {
    pack_trace(out + off, trace_id, span_id);
    off += 16;
  }
  if (checksum) {
    uint32_t crc = trace_id ? crc32c(out + sizeof(hd), 16) : 0;
    crc = crc32c(payload, (size_t)len, crc);
    uint32_t be = htonl(crc);
    std::memcpy(out + off, &be, 4);
    off += 4;
  }
  return off;
}

// key → reducer stripe (ps_server.cc key-striped engine plane).  Tensor
// keys are small dense integers (partition ids), so a plain modulo would
// stripe adjacent partitions of one tensor onto adjacent stripes — fine —
// but correlated strides (every 4th key hot) would alias one stripe; the
// splitmix64 finalizer decorrelates at ~1 cycle cost.  Lives here so the
// golden shim (bps_wire_key_stripe) pins the mapping tests rely on.
inline uint32_t key_stripe(uint64_t key, uint32_t n_stripes) {
  if (n_stripes <= 1) return 0;
  uint64_t z = key + 0x9E3779B97F4A7C15ull;
  z = (z ^ (z >> 30)) * 0xBF58476D1CE4E5B9ull;
  z = (z ^ (z >> 27)) * 0x94D049BB133111EBull;
  z ^= z >> 31;
  return (uint32_t)(z % n_stripes);
}

// A tensor key's ownership-ring coordinate (elastic resharding plane):
// splitmix64-finalized djb2 of the key's DECIMAL STRING — bit-identical
// to Python hashing.ring_key_hash, pinned via bps_wire_ring_hash.  The
// finalizer matters: raw djb2 of short decimal strings clusters near
// the bottom of the u64 space and would hand one rank the whole ring.
inline uint64_t ring_key_hash(uint64_t key) {
  char buf[24];
  int n = snprintf(buf, sizeof(buf), "%llu", (unsigned long long)key);
  uint64_t z = 5381;
  for (int i = 0; i < n; ++i) z = (z << 5) + z + (uint64_t)(uint8_t)buf[i];
  z += 0x9E3779B97F4A7C15ull;
  z = (z ^ (z >> 30)) * 0xBF58476D1CE4E5B9ull;
  z = (z ^ (z >> 27)) * 0x94D049BB133111EBull;
  return z ^ (z >> 31);
}

}  // namespace bps_wire

#endif  // BYTEPS_TPU_NATIVE_WIRE_H_
