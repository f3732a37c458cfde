// Native PS server data plane.
//
// C++ end-to-end server engine matching byteps/server/server.cc's role
// (SURVEY §2.3): per-connection reader threads parse the framed protocol
// (byteps_tpu/comm/transport.py: 32-byte big-endian header + payload) and
// hand decoded frames to a KEY-STRIPED reducer plane — the key space is
// sharded by hash across N reducer threads (BYTEPS_SERVER_STRIPES), each
// owning its keys' entire state (rounds, exactly-once ledger, init/fused
// waiters, publish cache) behind one per-stripe lock, fed through a
// bounded lock-free task ring.  KV semantics are unchanged:
// init-as-barrier, COPY_FIRST/SUM_RECV/ALL_RECV rounds with buffered
// pulls, async parameter-store mode, and server-side compression
// (decompress-or-sparse-sum on push, compress-merged for pulls, optional
// error feedback; momentum is worker-only, compressor_registry.cc:40-56).
// Op.FUSED frames are decoded on the I/O thread, members scatter to
// their stripes, and an atomic-countdown gather emits the single
// multi-key reply (docs/architecture.md "Key striping").
//
// Control plane (scheduler registration, barriers, heartbeats) stays in
// the Python wrapper — this engine owns only the worker-facing data
// socket, where the throughput is.  No GIL: reducers sum on all cores
// through the same vectorized kernels in reducer.cc/compressor.cc.

#include <arpa/inet.h>
#include <endian.h>
#include <fcntl.h>
#include <netinet/in.h>
#include <netinet/tcp.h>
#include <poll.h>
#include <strings.h>
#include <sys/mman.h>
#include <sys/socket.h>
#include <sys/stat.h>
#include <sys/un.h>
#include <unistd.h>

#include <algorithm>
#include <atomic>
#include <cctype>
#include <chrono>
#include <cmath>
#include <condition_variable>
#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <map>
#include <memory>
#include <mutex>
#include <set>
#include <string>
#include <thread>
#include <tuple>
#include <vector>

#include "hist.h"
#include "wire.h"

// from reducer.cc / compressor.cc (same shared object)
extern "C" {
int32_t bps_sum(void* dst, const void* src, int64_t n, int32_t dtype);
int64_t bps_onebit_size(int64_t n);
int64_t bps_onebit_compress(const float* in, int64_t n, uint8_t* out, int32_t scaled);
int32_t bps_onebit_decompress(const uint8_t* in, int64_t n, float* out);
int64_t bps_topk_compress(const float* in, int64_t n, int64_t k, uint8_t* out);
int32_t bps_topk_decompress(const uint8_t* in, int64_t k, float* out, int64_t n);
int32_t bps_topk_sum_into(const uint8_t* in, int64_t k, float* acc, int64_t n);
int64_t bps_randomk_compress(const float* in, int64_t n, int64_t k, uint64_t s0,
                             uint64_t s1, uint8_t* out);
int64_t bps_dithering_size(int64_t n);
int64_t bps_dithering_compress(const float* in, int64_t n, int32_t s, int32_t natural,
                               int32_t l2, uint64_t s0, uint64_t s1, uint8_t* out);
int32_t bps_dithering_decompress(const uint8_t* in, int64_t n, int32_t s,
                                 int32_t natural, float* out);
}

namespace {

// BYTEPS_NATIVE_DEBUG=1: stderr trace of connection lifecycle decisions
// (handshake failures, desyncs, death detection) — the C++ analogue of
// BYTEPS_SERVER_DEBUG on the Python engine.
bool native_debug() {
  static int v = [] {
    const char* e = getenv("BYTEPS_NATIVE_DEBUG");
    return (e && atoi(e) != 0) ? 1 : 0;
  }();
  return v != 0;
}
#define NDBG(...)                                  \
  do {                                             \
    if (native_debug()) {                          \
      fprintf(stderr, "[byteps-native] " __VA_ARGS__); \
      fputc('\n', stderr);                         \
    }                                              \
  } while (0)

using bps_wire::Header;
using bps_wire::kMagic;
using bps_wire::kInit;
using bps_wire::kPush;
using bps_wire::kPull;
using bps_wire::kRegisterCompressor;
using bps_wire::kFused;
using bps_wire::kPing;
using bps_wire::kShutdown;
using bps_wire::kResyncQuery;
using bps_wire::kResyncState;
using bps_wire::kWrongOwner;
using bps_wire::kTraceFlag;
using bps_wire::pack_header;

// Per-instance observability counters, exported through
// bps_native_server_counters in THIS index order (the Python side maps
// them to the native_* names in native/__init__.py — change both
// together; docs/observability.md catalog).
enum NativeCounter {
  kCtrWireRpc = 0,    // data-plane frames handled (push / pull / fused)
  kCtrFusedFrames,    // multi-key Op.FUSED frames unpacked
  kCtrFusedKeys,      // member sub-pushes those frames carried
  kCtrPushDedup,      // replays suppressed by the exactly-once ledger
  kCtrInitReplayAck,  // INITs acked from the completed-barrier record
  kCtrResyncQuery,    // Op.RESYNC_QUERY frames answered from the ledger
  kCtrZombieReject,   // pushes rejected by the live-rank fence
  kCtrSpanDrop,       // span records dropped on a full trace ring
  kCtrWrongOwner,     // requests redirected by the ownership map
  kCtrJobReject,      // job-namespaced frames refused (multi-tenant is
                      // Python-engine-only; docs/async.md)
  kCtrAsyncReject,    // async-profile INITs refused (no async plane)
  kCtrChecksumFail,   // frames dropped on a CRC32C mismatch (end-to-end
                      // wire integrity; docs/robustness.md)
  kCtrChecksumConnDrop,  // connections dropped after
                         // BYTEPS_CHECKSUM_CONN_LIMIT mismatches
  kCtrServerOptReject,   // server-opt-profile INITs refused (the update
                         // plane is Python-engine-only; appended so an
                         // older .so keeps its index mapping)
  kCtrLosslessFail,      // frames dropped on a lossless-container decode
                         // failure (fail-closed; appended LAST so an
                         // older .so keeps its index mapping)
  kCtrCount,
};

// The native_* names, index-matched to NativeCounter — the one place
// the names live on the C++ side.  bps_native_server_metrics_json
// exports counters under these names, and tools/check_metrics_doc.py
// scans these literals so the docs/observability.md catalog covers the
// native plane too.
const char* const kCounterNames[kCtrCount] = {
    "native_wire_rpc",        "native_fused_frames",  "native_fused_keys",
    "native_push_dedup",      "native_init_replay_ack",
    "native_resync_query",    "native_zombie_reject", "native_span_drop",
    "native_wrong_owner",     "native_job_reject",    "native_async_reject",
    "native_checksum_fail",   "native_checksum_conn_drop",
    "native_server_opt_reject", "native_lossless_fail",
};

// ---------------------------------------------------------------------------
// span plane (docs/observability.md): the C++ engine stamps the same
// recv→sum→publish→reply child spans the Python server does, but it
// must never touch Python from the data path — records land in a
// bounded lock-free ring and the wrapper (server.py NativePSServer)
// drains them via bps_native_server_drain_spans into the process
// tracer, which writes the same server<rank>/comm.json file
// tools/trace_merge.py already stitches.
// ---------------------------------------------------------------------------

// span kinds, index-matched to NATIVE_SPAN_KINDS in native/__init__.py
enum SpanKind {
  kSpanRecv = 0,   // engine-queue dwell (enqueue → handler start)
  kSpanSum,        // ledger + summation under the key lock
  kSpanPublish,    // round publish (swap + waiter flush prep)
  kSpanReply,      // response serialization + send
  kSpanResync,     // Op.RESYNC_QUERY answered from the ledger
};

constexpr uint32_t kSpanFlagDedupe = 1;  // replay suppressed by the ledger
constexpr uint32_t kSpanFlagFused = 2;   // fused-member child span

// mirrored by SPAN_REC_DTYPE in native/__init__.py — change both
// together (64-bit fields first: no implicit padding holes)
struct SpanRec {
  uint64_t trace_id;    // worker's trace id (wire trace-context block)
  uint64_t parent;      // wire span id (or fused-member trailer id)
  uint64_t key;
  double ts;            // wall-clock seconds (time.time() parity)
  double dur;           // seconds
  int32_t kind;         // SpanKind
  uint32_t flags;       // kSpanFlag*
  // reducer stripe that executed the stage (-1 = a serve/control thread:
  // resync answers, fused-frame decode).  The drain maps each stripe to
  // its own Perfetto lane so the merged timeline shows reducer occupancy.
  int32_t stripe;
  uint32_t pad_;
};
static_assert(sizeof(SpanRec) == 56, "SpanRec layout drifted");

double wall_now() {
  timespec ts;
  clock_gettime(CLOCK_REALTIME, &ts);
  return (double)ts.tv_sec + (double)ts.tv_nsec * 1e-9;
}

// Bounded lock-free MPMC ring (Vyukov bounded queue): engine threads
// produce span records concurrently, the wrapper's drain thread
// consumes in batches.  A full ring DROPS (the producer must never
// block the data plane on the observer); drops are counted so the
// timeline says it is incomplete instead of silently lying.
class SpanRing {
 public:
  static constexpr size_t kCap = 1 << 14;  // 16384 records (~768 KiB)

  SpanRing() {
    for (size_t i = 0; i < kCap; ++i)
      slots_[i].seq.store(i, std::memory_order_relaxed);
  }

  bool push(const SpanRec& r) {
    size_t pos = head_.load(std::memory_order_relaxed);
    for (;;) {
      Slot& s = slots_[pos & (kCap - 1)];
      size_t seq = s.seq.load(std::memory_order_acquire);
      intptr_t dif = (intptr_t)seq - (intptr_t)pos;
      if (dif == 0) {
        if (head_.compare_exchange_weak(pos, pos + 1,
                                        std::memory_order_relaxed))
          break;
      } else if (dif < 0) {
        return false;  // full: drop (caller counts it)
      } else {
        pos = head_.load(std::memory_order_relaxed);
      }
    }
    Slot& s = slots_[pos & (kCap - 1)];
    s.rec = r;
    s.seq.store(pos + 1, std::memory_order_release);
    return true;
  }

  // drain up to cap records; single consumer assumed (the drain thread),
  // but the CAS keeps even racing consumers safe
  int32_t pop(SpanRec* out, int32_t cap) {
    int32_t n = 0;
    while (n < cap) {
      size_t pos = tail_.load(std::memory_order_relaxed);
      Slot& s = slots_[pos & (kCap - 1)];
      size_t seq = s.seq.load(std::memory_order_acquire);
      if ((intptr_t)seq - (intptr_t)(pos + 1) < 0) break;  // empty
      if (!tail_.compare_exchange_weak(pos, pos + 1,
                                       std::memory_order_relaxed))
        continue;
      out[n++] = slots_[pos & (kCap - 1)].rec;
      slots_[pos & (kCap - 1)].seq.store(pos + kCap,
                                         std::memory_order_release);
    }
    return n;
  }

 private:
  struct Slot {
    std::atomic<size_t> seq;
    SpanRec rec;
  };
  Slot slots_[kCap];
  // head/tail on separate cache lines: producers and the consumer
  // otherwise false-share one line on every push/pop
  alignas(64) std::atomic<size_t> head_{0};
  alignas(64) std::atomic<size_t> tail_{0};
};

int dtype_size(int32_t dt) {
  switch (dt) {
    case 0: return 4;  // f32
    case 1: return 8;  // f64
    case 2: return 2;  // f16
    case 3: return 1;  // u8
    case 4: return 4;  // i32
    case 5: return 1;  // i8
    case 6: return 8;  // i64
    case 7: return 2;  // bf16
  }
  return 0;
}

void decode_cantor(uint32_t cmd, int32_t* rtype, int32_t* dtype) {
  // inverse of common.cc:98 (see byteps_tpu.common.types)
  uint64_t w = (uint64_t)((std::sqrt(8.0 * cmd + 1) - 1) / 2);
  uint64_t t = w * (w + 1) / 2;
  *dtype = (int32_t)(cmd - t);
  *rtype = (int32_t)(w - *dtype);
}

// ---------------------------------------------------------------------------
// server-side compressor chain (ef? → codec), mirroring registry.py
// ---------------------------------------------------------------------------

struct Codec {
  std::string type;          // onebit | topk | randomk | dithering
  int64_t n = 0;             // dense element count
  int64_t k = 0;
  int32_t onebit_scaled = 0;
  int32_t dith_s = 4, dith_natural = 0, dith_l2 = 0;
  uint64_t s0 = 0, s1 = 0;
  bool has_ef = false;
  std::vector<float> error;  // ef residual

  // Wire-size validation: the onebit/dithering decoders read a fixed
  // n-derived byte count, so a short payload would be an out-of-bounds
  // heap read.  Reject before any codec touches the bytes (the dense path
  // is clamped; this is the compressed equivalent).
  bool wire_ok(int64_t len) const {
    if (type == "onebit") return len == bps_onebit_size(n);
    if (type == "topk" || type == "randomk")
      return len % 8 == 0 && len / 8 <= (k > 0 ? k : n);
    return len == bps_dithering_size(n);  // dithering
  }

  void decompress(const uint8_t* in, int64_t len, float* out) const {
    if (type == "onebit") {
      bps_onebit_decompress(in, n, out);
    } else if (type == "topk" || type == "randomk") {
      bps_topk_decompress(in, len / 8, out, n);
    } else {
      bps_dithering_decompress(in, n, dith_s, dith_natural, out);
    }
  }

  void sum_into(const uint8_t* in, int64_t len, float* acc) const {
    if (type == "topk" || type == "randomk") {
      bps_topk_sum_into(in, len / 8, acc, n);
    } else {
      std::vector<float> tmp(n);
      decompress(in, len, tmp.data());
      bps_sum(acc, tmp.data(), n, 0);
    }
  }

  std::vector<uint8_t> compress(const float* dense, float ef_lr = 1.0f) {
    const float* src = dense;
    std::vector<float> corrected;
    if (has_ef) {
      if (error.empty()) error.assign(n, 0.0f);
      corrected.resize(n);
      // lr-scaled residual correction (vanilla_error_feedback.h:44-58;
      // the lr arrives over the wire via the kRegisterCompressor
      // lr-update flag instead of the reference's lr.s mmap)
      for (int64_t i = 0; i < n; ++i)
        corrected[i] = dense[i] + ef_lr * error[i];
      src = corrected.data();
    }
    std::vector<uint8_t> out;
    int64_t ln = 0;
    if (type == "onebit") {
      out.resize(bps_onebit_size(n));
      ln = bps_onebit_compress(src, n, out.data(), onebit_scaled);
    } else if (type == "topk") {
      out.resize(8 * k);
      ln = bps_topk_compress(src, n, k, out.data());
    } else if (type == "randomk") {
      out.resize(8 * k);
      ln = bps_randomk_compress(src, n, k, s0, s1, out.data());
    } else {
      out.resize(bps_dithering_size(n));
      ln = bps_dithering_compress(src, n, dith_s, dith_natural, dith_l2, s0, s1,
                                  out.data());
    }
    out.resize(ln);
    if (has_ef) {
      // e = corrected − decompress(payload)  (error_feedback.h:46-90)
      std::vector<float> dec(n);
      decompress(out.data(), (int64_t)out.size(), dec.data());
      for (int64_t i = 0; i < n; ++i) error[i] = src[i] - dec[i];
    }
    return out;
  }
};

// splitmix-derived seed pair, bit-matching compression/rng.py seed_pair_from
void seed_pair(uint64_t seed, uint64_t* s0, uint64_t* s1) {
  const uint64_t D0 = 0x9E3779B97F4A7C15ull, D1 = 0xBF58476D1CE4E5B9ull;
  if (!seed) { *s0 = D0; *s1 = D1; return; }
  uint64_t z = seed + D0;
  z = (z ^ (z >> 30)) * D1;
  uint64_t a = z ^ (z >> 27); if (!a) a = D0;
  z = z + D0;
  z = (z ^ (z >> 30)) * D1;
  uint64_t b = z ^ (z >> 27); if (!b) b = D1;
  *s0 = a; *s1 = b;
}

std::unique_ptr<Codec> make_codec(const std::map<std::string, std::string>& kw,
                                  int64_t size) {
  auto get = [&](const char* a, const char* b, const std::string& dflt) {
    auto it = kw.find(a);
    if (it != kw.end()) return it->second;
    it = kw.find(b);
    if (it != kw.end()) return it->second;
    return dflt;
  };
  std::string type = get("byteps_compressor_type", "compressor", "");
  if (type.empty()) return nullptr;
  auto c = std::make_unique<Codec>();
  c->type = type;
  c->n = size;
  double kval = atof(get("byteps_compressor_k", "k", "1").c_str());
  c->k = (kval > 0 && kval < 1) ? std::max<int64_t>(1, (int64_t)(kval * size))
                                : std::max<int64_t>(1, (int64_t)kval);
  if (c->k > size) c->k = size;
  std::string sc = get("byteps_compressor_onebit_scaling", "scaling", "False");
  c->onebit_scaled = (sc == "True" || sc == "true" || sc == "1") ? 1 : 0;
  c->dith_s = c->k > 0 ? (int32_t)c->k : 4;
  std::string part = get("byteps_dithering_partition", "partition", "0");
  c->dith_natural = (part == "1" || part == "natural") ? 1 : 0;
  std::string nrm = get("byteps_dithering_normalize", "normalize", "0");
  c->dith_l2 = (nrm == "1" || nrm == "l2") ? 1 : 0;
  uint64_t seed = strtoull(get("byteps_seed", "seed", "0").c_str(), nullptr, 10);
  seed_pair(seed, &c->s0, &c->s1);
  c->has_ef = !get("byteps_ef_type", "ef", "").empty();
  return c;
}

// ---------------------------------------------------------------------------
// key state + server
// ---------------------------------------------------------------------------

// Refcounted connection: the underlying transport is released only when
// the LAST holder releases it (serve thread, queued engine tasks, pending
// pulls, init waiters).  Without this, a disconnect closes the fd while
// tasks for it are still queued, the kernel recycles the number for the
// next client, and the engine writes one client's bytes onto another's
// stream.
//
// Transport is virtual so the engine composes with every van the Python
// server supports (VERDICT r3 #3): FdConn covers the tcp and uds vans
// (byte streams), ShmConn the shm van — headers and payloads through
// mmap'd SPSC rings (shm_ring.py layout), with the UDS control socket as
// handshake carrier + SIGKILL-liveness backstop.
struct Conn {
  std::mutex write_mu;
  virtual ~Conn() = default;
  virtual bool recv_exact(void* buf, size_t n) = 0;
  virtual bool send_all(const void* buf, size_t n) = 0;
  // unblock the reader and poison the stream (shutdown(2) analogue)
  virtual void wake() = 0;
};
using ConnPtr = std::shared_ptr<Conn>;

struct FdConn : Conn {
  int fd;
  explicit FdConn(int f) : fd(f) {}
  ~FdConn() override { ::close(fd); }
  FdConn(const FdConn&) = delete;
  FdConn& operator=(const FdConn&) = delete;

  bool recv_exact(void* buf, size_t n) override {
    uint8_t* p = (uint8_t*)buf;
    while (n) {
      ssize_t r = ::recv(fd, p, n, 0);
      if (r < 0 && errno == EINTR) continue;  // signal, not a dead stream
      if (r <= 0) return false;
      p += r;
      n -= (size_t)r;
    }
    return true;
  }

  bool send_all(const void* buf, size_t n) override {
    const uint8_t* p = (const uint8_t*)buf;
    while (n) {
      ssize_t r = ::send(fd, p, n, MSG_NOSIGNAL);
      if (r < 0) {
        if (errno == EINTR) continue;
        return false;  // stream is dead; caller's reader will notice EOF
      }
      p += r;
      n -= (size_t)r;
    }
    return true;
  }

  void wake() override { ::shutdown(fd, SHUT_RDWR); }
};

// One direction of an shm-van connection: mmap'd ring, layout per
// shm_ring.py — u64 head @0 (producer), u64 tail @8 (consumer), u8
// closed @16, data @64.  Counters use acquire/release atomics (stronger
// than the Python side's x86-TSO reliance; same wire behavior).
class ShmRing {
 public:
  bool open_path(const char* path) {
    int fd = ::open(path, O_RDWR);
    if (fd < 0) return false;
    struct stat st {};
    if (fstat(fd, &st) != 0 || st.st_size <= 64) {
      ::close(fd);
      return false;
    }
    total_ = (size_t)st.st_size;
    void* m = mmap(nullptr, total_, PROT_READ | PROT_WRITE, MAP_SHARED, fd, 0);
    ::close(fd);
    if (m == MAP_FAILED) return false;
    base_ = (uint8_t*)m;
    cap_ = total_ - 64;
    return true;
  }
  uint64_t head() const {
    return __atomic_load_n((const uint64_t*)base_, __ATOMIC_ACQUIRE);
  }
  uint64_t tail() const {
    return __atomic_load_n((const uint64_t*)(base_ + 8), __ATOMIC_ACQUIRE);
  }
  void publish_head(uint64_t v) {
    __atomic_store_n((uint64_t*)base_, v, __ATOMIC_RELEASE);
  }
  void publish_tail(uint64_t v) {
    __atomic_store_n((uint64_t*)(base_ + 8), v, __ATOMIC_RELEASE);
  }
  bool closed() const {
    return base_ && __atomic_load_n(base_ + 16, __ATOMIC_ACQUIRE) != 0;
  }
  void mark_closed() {
    if (base_) __atomic_store_n(base_ + 16, (uint8_t)1, __ATOMIC_RELEASE);
  }
  void unmap() {
    if (base_) {
      munmap(base_, total_);
      base_ = nullptr;
    }
  }
  bool mapped() const { return base_ != nullptr; }
  uint8_t* data() { return base_ + 64; }
  size_t cap() const { return cap_; }
  // park flags (shm_ring.py doorbell protocol): @17 consumer parked,
  // @18 producer parked; the publishing side doorbells the control
  // socket only when the peer declared itself parked
  bool peer_parked(int off) const {
    return base_ && __atomic_load_n(base_ + off, __ATOMIC_ACQUIRE) != 0;
  }
  void set_park(int off, uint8_t v) {
    if (base_) __atomic_store_n(base_ + off, v, __ATOMIC_RELEASE);
  }

 private:
  uint8_t* base_ = nullptr;
  size_t total_ = 0;
  size_t cap_ = 0;
};

struct ShmConn : Conn {
  int cfd;  // UDS control socket: handshake + liveness backstop
  ShmRing rx, tx;
  std::atomic<bool> dead{false};
  std::atomic<bool> ready{false};
  std::mutex hs_mu;

  explicit ShmConn(int f) : cfd(f) {}
  ~ShmConn() override {
    rx.unmap();
    tx.unmap();
    ::close(cfd);
  }

  // Handshake: client sends two !H-length-prefixed ring paths (c2s then
  // s2c, van.py ShmVan.connect); we attach (their c2s = our rx) and
  // unlink so the files cannot outlive the processes.  Runs lazily in
  // the per-connection serve thread — a stalled client can only stall
  // its own thread (same property as the Python ShmConnection).
  bool ensure_ready() {
    if (ready.load(std::memory_order_acquire)) return true;
    std::lock_guard<std::mutex> g(hs_mu);
    if (ready.load(std::memory_order_acquire)) return true;
    if (dead.load()) return false;
    timeval tv{10, 0};
    setsockopt(cfd, SOL_SOCKET, SO_RCVTIMEO, &tv, sizeof(tv));
    std::string names[2];
    for (auto& name : names) {
      uint16_t ln_be;
      if (!ctl_recv(&ln_be, 2)) { NDBG("shm handshake: len recv failed"); return false; }
      uint16_t ln = ntohs(ln_be);
      if (ln == 0 || ln > 4096) { NDBG("shm handshake: bad name len %u", ln); return false; }
      name.resize(ln);
      if (!ctl_recv(&name[0], ln)) { NDBG("shm handshake: name recv failed"); return false; }
    }
    timeval tv0{0, 0};
    setsockopt(cfd, SOL_SOCKET, SO_RCVTIMEO, &tv0, sizeof(tv0));
    if (!rx.open_path(names[0].c_str()) || !tx.open_path(names[1].c_str())) {
      NDBG("shm handshake: ring open failed (%s / %s)", names[0].c_str(), names[1].c_str());
      // unlink on the failure path too: once the names arrived the files
      // are ours to reap — the client's own mapping stays alive, but a
      // half-open here would otherwise leak both ring files in /dev/shm until
      // client-process cleanup (ADVICE r4)
      for (auto& name : names) ::unlink(name.c_str());
      return false;
    }
    for (auto& name : names) ::unlink(name.c_str());
    ready.store(true, std::memory_order_release);
    return true;
  }

  bool ctl_recv(void* buf, size_t n) {
    uint8_t* p = (uint8_t*)buf;
    while (n) {
      ssize_t r = ::recv(cfd, p, n, 0);
      if (r < 0 && errno == EINTR) continue;  // signal, not a dead stream
      if (r <= 0) return false;
      p += r;
      n -= (size_t)r;
    }
    return true;
  }

  // Doorbell: one byte on the control socket wakes the peer's parked
  // select()/poll() instantly (shm_ring.py park protocol).  Failure is
  // fine: a full buffer means wakeups are already pending, a dead peer
  // is detected by the waiter.
  void kick() {
    char b = 1;
    (void)::send(cfd, &b, 1, MSG_DONTWAIT | MSG_NOSIGNAL);
  }

  // Park on the control socket: woken by the peer's doorbell byte or by
  // its death (EOF).  The 50ms timeout backstops the two lossy cases —
  // the TSO publish-then-read-flag / set-flag-then-recheck race, and
  // doorbell steal (both directions share one control socket, so when
  // this process has a reader AND a writer parked at once, whichever
  // drains the socket first can swallow the other's wakeup byte).  A
  // lost doorbell costs one tick, not a hang.  Returns false when the
  // peer is gone.
  bool park_wait() {
    pollfd p{cfd, POLLIN, 0};
    int r = ::poll(&p, 1, 50);
    if (r > 0) {
      char buf[4096];
      for (;;) {  // drain every pending doorbell
        ssize_t got = ::recv(cfd, buf, sizeof buf, MSG_DONTWAIT);
        if (got == 0) { NDBG("park_wait: control EOF (peer exited)"); return false; }
        if (got < 0) {
          if (errno == EAGAIN || errno == EWOULDBLOCK || errno == EINTR)
            break;
          NDBG("park_wait: control recv errno=%d", errno);
          return false;
        }
        if (got < (ssize_t)sizeof buf) break;
      }
    }
    return !dead.load();
  }

  // One stall step of the park protocol, shared by both ring directions
  // (flag_off: our park flag — 17 consumer, 18 producer).  Spin-yield,
  // then declare the flag and recheck once, then sleep on the control
  // socket.  Returns false when the wait saw the peer die; the caller
  // owns the exit action (recv drains once more, send fails).
  bool stall_step(ShmRing& r, int flag_off, bool& parked, int& stalls) {
    if (++stalls <= 10) {
      sched_yield();  // back-to-back traffic lands within a few yields
      return true;
    }
    if (!parked) {
      parked = true;
      r.set_park(flag_off, 1);
      return true;  // one recheck with the flag visible to the peer
    }
    return park_wait();
  }

  bool recv_exact(void* buf, size_t n) override {
    if (!ensure_ready()) return false;
    uint8_t* p = (uint8_t*)buf;
    bool dying = false, parked = false;
    int stalls = 0;
    while (n) {
      uint64_t head = rx.head(), tail = rx.tail();
      uint64_t avail = head - tail;
      if (avail == 0) {
        if (dying) {
          if (parked) rx.set_park(17, 0);
          return false;
        }
        if (rx.closed() || dead.load()) {
          // peer closed/died — drain once more: bytes may have landed
          // between the avail check and noticing the death
          NDBG("recv_exact: dying (closed=%d dead=%d)", (int)rx.closed(), (int)dead.load());
          dying = true;
          continue;
        }
        if (!stall_step(rx, 17, parked, stalls)) dying = true;
        continue;
      }
      if (parked) {
        parked = false;
        rx.set_park(17, 0);
      }
      stalls = 0;
      size_t pos = (size_t)(tail % rx.cap());
      size_t chunk = std::min<uint64_t>(std::min<uint64_t>(avail, n),
                                        rx.cap() - pos);
      std::memcpy(p, rx.data() + pos, chunk);
      rx.publish_tail(tail + chunk);
      if (rx.peer_parked(18)) kick();  // wake a producer parked on full
      p += chunk;
      n -= chunk;
    }
    return true;
  }

  bool send_all(const void* buf, size_t n) override {
    if (!ensure_ready()) return false;
    const uint8_t* p = (const uint8_t*)buf;
    bool parked = false;
    int stalls = 0;
    while (n) {
      uint64_t head = tx.head(), tail = tx.tail();
      uint64_t free_b = tx.cap() - (head - tail);
      if (free_b == 0) {
        if (tx.closed() || dead.load()) {
          NDBG("send_all: fail (closed=%d dead=%d)", (int)tx.closed(), (int)dead.load());
          if (parked) tx.set_park(18, 0);
          return false;
        }
        if (!stall_step(tx, 18, parked, stalls)) {
          tx.set_park(18, 0);
          return false;
        }
        continue;
      }
      if (parked) {
        parked = false;
        tx.set_park(18, 0);
      }
      stalls = 0;
      size_t pos = (size_t)(head % tx.cap());
      size_t chunk = std::min<uint64_t>(std::min<uint64_t>(free_b, n),
                                        tx.cap() - pos);
      std::memcpy(tx.data() + pos, p, chunk);
      tx.publish_head(head + chunk);  // release: payload visible first
      if (tx.peer_parked(17)) kick();  // wake a parked consumer
      p += chunk;
      n -= chunk;
    }
    return !tx.closed();
  }

  void wake() override {
    dead.store(true);
    rx.mark_closed();
    tx.mark_closed();
    ::shutdown(cfd, SHUT_RDWR);
  }
};

struct PendingPull {
  uint32_t version;
  ConnPtr conn;
  uint32_t seq;
  bool wants_compressed;
  // row-sparse pull request bytes (header + big-endian row indices);
  // empty = dense pull (kRowSparsePushPull, common.h:267-271)
  std::vector<uint8_t> rs_req;
};

// ---------------------------------------------------------------------------
// fused / resync wire codecs — byte-compatible with transport.py
// (encode/decode_fused_*, encode/decode_resync_*); the golden-fixture
// shim (bps_wire_golden) goes through these same functions so the two
// implementations cannot drift silently.
// ---------------------------------------------------------------------------

// one member of an Op.FUSED request body (a VIEW into the frame bytes)
struct FusedMember {
  uint64_t key = 0;
  uint32_t cmd = 0;
  uint32_t version = 0;
  const uint8_t* payload = nullptr;
  uint64_t len = 0;
};

// Request body: u32 count, count × [u64 key, u32 cmd, u32 version,
// u64 length, length bytes], network order.  An optional member-span
// trailer (count × u64, distributed tracing) is ignored — the
// pre-observability decoder contract transport.py documents.
bool parse_fused_push(const uint8_t* body, uint64_t size,
                      std::vector<FusedMember>* out,
                      std::vector<uint64_t>* span_ids = nullptr) {
  if (size < 4) return false;
  uint32_t count_be;
  std::memcpy(&count_be, body, 4);
  const uint32_t count = ntohl(count_be);
  // empty frame is malformed; so is a count the body cannot possibly
  // hold (bound BEFORE reserve — a hostile count must not drive an
  // allocation)
  if (count == 0 || (uint64_t)count * 24 + 4 > size) return false;
  uint64_t off = 4;
  out->reserve(count);
  for (uint32_t i = 0; i < count; ++i) {
    if (off + 24 > size) return false;
    FusedMember m;
    uint64_t key_be, len_be;
    uint32_t cmd_be, ver_be;
    std::memcpy(&key_be, body + off, 8);
    std::memcpy(&cmd_be, body + off + 8, 4);
    std::memcpy(&ver_be, body + off + 12, 4);
    std::memcpy(&len_be, body + off + 16, 8);
    off += 24;
    m.key = be64toh(key_be);
    m.cmd = ntohl(cmd_be);
    m.version = ntohl(ver_be);
    m.len = be64toh(len_be);
    if (m.len > size - off) return false;  // fused frame truncated
    m.payload = body + off;
    off += m.len;
    out->push_back(m);
  }
  // Optional member-span trailer (count × u64, distributed tracing):
  // recovered only when the caller asks — transport.decode_fused_spans
  // parity, so fused member child spans can parent onto their own
  // worker-side spans instead of the pack span.
  if (span_ids && size - off == 8ull * count && count) {
    span_ids->reserve(count);
    for (uint32_t i = 0; i < count; ++i) {
      uint64_t id_be;
      std::memcpy(&id_be, body + off + 8ull * i, 8);
      span_ids->push_back(be64toh(id_be));
    }
  }
  return true;
}

// Reply body: u32 count, count × [u64 key, u32 version, u64 length,
// length bytes] — inverse is transport.decode_fused_reply.
std::vector<uint8_t> encode_fused_reply_bytes(
    const std::vector<uint64_t>& keys, const std::vector<uint32_t>& versions,
    const std::vector<std::vector<uint8_t>>& slots) {
  uint64_t total = 4;
  for (const auto& s : slots) total += 20 + s.size();
  std::vector<uint8_t> out(total);
  uint8_t* p = out.data();
  uint32_t count_be = htonl((uint32_t)keys.size());
  std::memcpy(p, &count_be, 4);
  p += 4;
  for (size_t i = 0; i < keys.size(); ++i) {
    uint64_t key_be = htobe64(keys[i]);
    uint32_t ver_be = htonl(versions[i]);
    uint64_t len_be = htobe64((uint64_t)slots[i].size());
    std::memcpy(p, &key_be, 8);
    std::memcpy(p + 8, &ver_be, 4);
    std::memcpy(p + 12, &len_be, 8);
    p += 20;
    if (!slots[i].empty()) {
      std::memcpy(p, slots[i].data(), slots[i].size());
      p += slots[i].size();
    }
  }
  return out;
}

// Op.RESYNC_QUERY body: {"worker": <flags byte>, "keys": [<u64>, ...]}.
// Minimal parse of exactly the shape transport.encode_resync_query emits
// (the recovery plane's JSON stays human-greppable); anything that is
// not a JSON object fails → the caller drops the connection, mirroring
// the Python server's malformed-recovery-frame policy.
bool parse_resync_query(const uint8_t* body, uint64_t size, uint32_t* wid,
                        std::vector<uint64_t>* keys) {
  std::string s((const char*)body, size);
  size_t i = 0;
  while (i < s.size() && isspace((unsigned char)s[i])) ++i;
  if (i >= s.size() || s[i] != '{') return false;
  *wid = 0;
  size_t wp = s.find("\"worker\"");
  if (wp != std::string::npos) {
    size_t c = s.find(':', wp);
    if (c == std::string::npos) return false;
    *wid = (uint32_t)strtoul(s.c_str() + c + 1, nullptr, 10);
  }
  size_t kp = s.find("\"keys\"");
  if (kp == std::string::npos) return true;  // absent = every key we hold
  size_t lb = s.find('[', kp);
  if (lb == std::string::npos) return false;
  size_t rb = s.find(']', lb);
  if (rb == std::string::npos) return false;
  const char* p = s.c_str() + lb + 1;
  const char* end = s.c_str() + rb;
  while (p < end) {
    while (p < end && !isdigit((unsigned char)*p)) ++p;
    if (p >= end) break;
    char* q = nullptr;
    keys->push_back(strtoull(p, &q, 10));
    p = q;
  }
  return true;
}

// Op.RESYNC_STATE body — byte-identical to transport.encode_resync_state
// (json.dumps default separators, field order store_version / seen /
// recv_count / init) so the two servers' replies cannot drift.
std::string encode_resync_state_bytes(
    const std::vector<std::tuple<uint64_t, uint32_t, uint32_t, int>>& states) {
  std::string out = "{\"keys\": {";
  char buf[160];
  bool first = true;
  for (const auto& [key, sv, seen, rc] : states) {
    if (!first) out += ", ";
    first = false;
    snprintf(buf, sizeof buf,
             "\"%llu\": {\"store_version\": %u, \"seen\": %u, "
             "\"recv_count\": %d, \"init\": true}",
             (unsigned long long)key, sv, seen, rc);
    out += buf;
  }
  out += "}}";
  return out;
}

// Accumulator for one Op.FUSED frame's multi-key response (the C++ twin
// of server.py's _FusedReply): sub-keys' rounds complete independently —
// possibly on different engine threads — each fills its slot, and the
// LAST fill (exactly one, lock-guarded) makes the frame sendable as ONE
// reply so the worker's single seq/deadline/retry state resolves
// atomically for every member.
struct FusedReply {
  ConnPtr conn;
  uint32_t seq = 0;
  uint64_t route_key = 0;
  std::vector<uint64_t> keys;
  std::vector<uint32_t> versions;
  std::vector<std::vector<uint8_t>> slots;
  std::vector<uint8_t> filled;
  size_t remaining = 0;
  // set when the frame was answered OUT of band (an ownership-map
  // WRONG_OWNER redirect): later round publishes must not fill slots
  // into a seq the worker already resolved — a second response on one
  // seq would corrupt the client's demux (server.py _FusedReply parity)
  bool aborted = false;
  std::mutex mu;

  // True exactly once — when this fill completed the frame (the caller
  // then sends the reply).  Duplicate publish race: first fill wins.
  bool fill(size_t slot, std::vector<uint8_t>&& payload, uint32_t version) {
    std::lock_guard<std::mutex> g(mu);
    if (aborted || filled[slot]) return false;
    filled[slot] = 1;
    slots[slot] = std::move(payload);
    versions[slot] = version;
    return --remaining == 0;
  }

  // True exactly once — the winner sends the out-of-band reply on this
  // frame's seq (false once the normal reply already left).
  bool abort_once() {
    std::lock_guard<std::mutex> g(mu);
    if (aborted || remaining == 0) return false;
    aborted = true;
    return true;
  }
};
using FusedReplyPtr = std::shared_ptr<FusedReply>;

// a fused pull-half parked on a key until its round publishes
struct FusedWaiter {
  uint32_t version;
  FusedReplyPtr reply;
  size_t slot;
  bool compressed;
};

// one parked init-barrier waiter (wid 0 = anonymous, token 0 = tokenless
// pre-recovery-plane client)
struct InitWaiter {
  uint8_t wid = 0;
  ConnPtr conn;
  uint32_t seq = 0;
  uint32_t token = 0;
};

// RS wire header: !II (nrows, row_len), then nrows big-endian u32 indices
// [+ nrows*row_len native-order f32 values on pushes]
static bool rs_parse_header(const std::vector<uint8_t>& p, uint32_t* nrows,
                            uint32_t* row_len) {
  if (p.size() < 8) return false;
  uint32_t a, b;
  std::memcpy(&a, p.data(), 4);
  std::memcpy(&b, p.data() + 4, 4);
  *nrows = ntohl(a);
  *row_len = ntohl(b);
  return *row_len != 0;
}

// ---------------------------------------------------------------------------
// key-striped reducer plane (docs/architecture.md "Key striping").  The
// key space is sharded across N reducer threads by hash
// (wire.h key_stripe; BYTEPS_SERVER_STRIPES, default min(4, cores)):
// each stripe owns its keys' ENTIRE mutable state — store/accum rounds,
// the exactly-once ledger, init/fused waiters, publish cache — behind
// ONE per-stripe lock, and a bounded MPSC task ring carries decoded
// frames from the I/O (serve) threads to the stripe's reducer.  Keys
// are independent, so stripes never take each other's locks: sum and
// publish parallelize embarrassingly, and nothing global sits on the
// hot path (the previous engine plane took a process-wide keys_mu_ +
// tid_mu_ on EVERY data frame).  With BYTEPS_SERVER_ENABLE_SCHEDULE=1
// a stripe swaps its ring for the reference's anti-starvation priority
// queue (fewest accumulated pushes first, queue.h:49-97).  Per-key
// ordering is preserved: one key always maps to one stripe, and the
// serve thread enqueues a connection's frames in arrival order.
//
// BYTEPS_SERVER_STRIPES=1 (striping off) takes an INLINE fast path:
// with one shard there is nothing to parallelize, so paying the
// ring hop + reducer wakeup per frame only adds scheduling latency
// (~2.5x round time on an oversubscribed box).  The serve thread runs
// the handler directly — the pre-striping engine shape — under the
// same shard lock, so semantics are identical to the queued path and
// ordering still follows the connection's arrival order.
// ---------------------------------------------------------------------------

// internal task kind for a fused member scattered to its own stripe
// (the serve thread decodes Op.FUSED and fans the members out; distinct
// from the wire ops so the reducer switch stays unambiguous)
constexpr uint8_t kTaskFusedMember = 0xFE;

struct EngineTask {
  uint8_t op = 0;
  uint8_t flags = 0;  // worker identity (rank+1) for the replay ledger
  ConnPtr conn;
  uint32_t seq = 0;
  uint64_t key = 0;
  uint32_t cmd = 0;
  uint32_t version = 0;
  // wire trace context (0 = untraced frame / tracing off): the worker's
  // (trace id, span id) off the TRACE_FLAG block, plus the enqueue
  // wall-clock that bounds the "recv" (queue-dwell) child span
  uint64_t trace_id = 0;
  uint64_t span_id = 0;
  double t_enq = 0.0;
  std::vector<uint8_t> payload;
  // fused-member scatter state (op == kTaskFusedMember): the member's
  // payload is a VIEW (off/len) into the shared frame buffer — one frame
  // allocation serves every member task, refcounted until the last
  // stripe finishes — and the gather accumulator + slot say where this
  // member's pull-half lands in the single multi-key reply.
  std::shared_ptr<std::vector<uint8_t>> frame;
  uint64_t off = 0, len = 0;
  FusedReplyPtr freply;
  uint32_t slot = 0;
  uint64_t member_span = 0;  // trailer span id (0 = no trailer)
};

// Bounded lock-free MPMC ring of tasks (same Vyukov shape as SpanRing)
// — the SPSC-per-producer handoff from I/O threads to one stripe's
// reducer.  Unlike the span ring, a full ring must NOT drop (tasks are
// protocol state): producers back off in Stripe::put.  1024 tasks of
// in-flight backlog per stripe bounds memory without throttling the
// common case (rounds drain in microseconds).
class TaskRing {
 public:
  static constexpr size_t kCap = 1 << 10;

  TaskRing() {
    for (size_t i = 0; i < kCap; ++i)
      slots_[i].seq.store(i, std::memory_order_relaxed);
  }

  // moves from t ONLY on success; a full ring leaves t intact
  bool try_push(EngineTask& t) {
    size_t pos = head_.load(std::memory_order_relaxed);
    for (;;) {
      Slot& s = slots_[pos & (kCap - 1)];
      size_t seq = s.seq.load(std::memory_order_acquire);
      intptr_t dif = (intptr_t)seq - (intptr_t)pos;
      if (dif == 0) {
        if (head_.compare_exchange_weak(pos, pos + 1,
                                        std::memory_order_relaxed))
          break;
      } else if (dif < 0) {
        return false;  // full: caller backs off and retries
      } else {
        pos = head_.load(std::memory_order_relaxed);
      }
    }
    Slot& s = slots_[pos & (kCap - 1)];
    s.task = std::move(t);
    s.seq.store(pos + 1, std::memory_order_release);
    return true;
  }

  bool try_pop(EngineTask* out) {
    size_t pos = tail_.load(std::memory_order_relaxed);
    for (;;) {
      Slot& s = slots_[pos & (kCap - 1)];
      size_t seq = s.seq.load(std::memory_order_acquire);
      intptr_t dif = (intptr_t)seq - (intptr_t)(pos + 1);
      if (dif == 0) {
        if (tail_.compare_exchange_weak(pos, pos + 1,
                                        std::memory_order_relaxed))
          break;
      } else if (dif < 0) {
        return false;  // empty
      } else {
        pos = tail_.load(std::memory_order_relaxed);
      }
    }
    Slot& s = slots_[pos & (kCap - 1)];
    *out = std::move(s.task);
    s.task = EngineTask{};  // release conn/frame refs in the slot NOW
    s.seq.store(pos + kCap, std::memory_order_release);
    return true;
  }

  // approximate backlog (relaxed reads): the hot-stripe imbalance gauge
  size_t depth() const {
    size_t h = head_.load(std::memory_order_relaxed);
    size_t t = tail_.load(std::memory_order_relaxed);
    return h >= t ? h - t : 0;
  }

 private:
  struct Slot {
    std::atomic<size_t> seq;
    EngineTask task;
  };
  Slot slots_[kCap];
  alignas(64) std::atomic<size_t> head_{0};
  alignas(64) std::atomic<size_t> tail_{0};
};

class EngineQueue {
 public:
  explicit EngineQueue(bool schedule) : schedule_(schedule) {}

  void put(EngineTask&& t, uint64_t prio) {
    std::lock_guard<std::mutex> g(mu_);
    items_.push_back({schedule_ ? prio : 0, counter_++, std::move(t)});
    std::push_heap(items_.begin(), items_.end(), cmp);
    cv_.notify_one();
  }

  bool pop(EngineTask* out, int timeout_ms) {
    std::unique_lock<std::mutex> lk(mu_);
    if (items_.empty())
      cv_.wait_for(lk, std::chrono::milliseconds(timeout_ms));
    if (items_.empty()) return false;
    std::pop_heap(items_.begin(), items_.end(), cmp);
    *out = std::move(items_.back().task);
    items_.pop_back();
    return true;
  }

  size_t size() {
    std::lock_guard<std::mutex> g(mu_);
    return items_.size();
  }

 private:
  struct Item {
    uint64_t prio;
    uint64_t order;
    EngineTask task;
  };
  // comparator "greater" turns std::*_heap into a min-heap: the key with
  // the FEWEST accumulated pushes is served first (queue.h:49-97); the
  // order counter keeps same-priority items FIFO
  static bool cmp(const Item& a, const Item& b) {
    return std::tie(a.prio, a.order) > std::tie(b.prio, b.order);
  }
  bool schedule_;
  uint64_t counter_ = 0;
  std::vector<Item> items_;
  std::mutex mu_;
  std::condition_variable cv_;
};

// One key's full server-side state.  Since the key-striping port there
// is no per-key mutex: a key lives on exactly one stripe (wire.h
// key_stripe) and every mutation happens under that stripe's shard lock
// — either on the stripe's reducer thread (sums, publishes) or on a
// control-plane thread that takes the same lock (init barrier, resync
// snapshot, compressor registration, resize).
struct KeyState {
  std::vector<uint8_t> store, accum;
  int32_t dtype = 0;
  int64_t nelems = 0;
  int recv_count = 0;
  uint32_t store_version = 0;
  std::vector<PendingPull> pending;
  std::vector<InitWaiter> init_waiters;
  // fused pull-halves parked until their round publishes (server.py
  // fused_waiters parity)
  std::vector<FusedWaiter> fused_waiters;
  // replay-dedupe ledger (docs/robustness.md): worker flag → newest
  // SUMMED push version.  Per-(key, worker) versions are strictly
  // increasing (engine round gate), so a replayed push arrives with
  // version <= the record and is acked WITHOUT re-summing — retried
  // summation stays exactly-once.  Anonymous pushes (flag 0) never
  // dedupe, same as the Python engine.
  std::map<uint8_t, uint32_t> push_seen;
  // init-idempotency ledger: worker flag → the token whose barrier
  // COMPLETED.  A replayed INIT (retry of a dropped post-release ack)
  // carries the SAME token and is acked from this record instead of
  // re-parked; a fresh token (elastic rejoin) still parks.
  std::map<uint8_t, uint32_t> init_done;
  std::unique_ptr<Codec> codec;
  std::vector<uint8_t> pull_payload;
  // per-key telemetry (docs/observability.md): summation latency and
  // request sizes — the per-tensor feed the adaptive-compression
  // direction picks codecs from.  Always-on like the Python engine's
  // server_sum_seconds (an observe is a bound scan + 3 relaxed adds).
  bps_hist::Hist sum_hist;
  bps_hist::Hist size_hist;
  KeyState() { size_hist.init_size_buckets(); }
};

class NativeServer {
 public:
  void set_num_workers(int n) {
    num_workers_.store(n);
    if (n <= 0) return;
    // an init barrier that is now full releases immediately: survivors
    // blocked in the init RPC must not wait forever for an evicted
    // worker's INIT (mirrors the Python server's update_num_workers).
    // One stripe at a time — stripe locks never nest — and sends happen
    // OUTSIDE the shard lock, same discipline as the reducers.
    for (auto& stp : stripes_) {
      std::vector<std::pair<uint64_t, std::vector<InitWaiter>>> released;
      {
        std::lock_guard<std::mutex> g(stp->mu);
        for (auto& [key, ks] : stp->keys) {
          if ((int)ks->init_waiters.size() >= n) {
            std::vector<InitWaiter> waiters;
            complete_init_barrier_locked(*ks, &waiters);
            released.emplace_back(key, std::move(waiters));
          }
        }
      }
      for (auto& [key, waiters] : released)
        for (auto& w : waiters)
          send_msg(w.conn, kInit, w.seq, key, 0, nullptr, 0);
    }
    if (async_) return;
    // elastic scale-down: a round that already holds >= n pushes will
    // never see the departed workers' contributions — publish it now and
    // flush its buffered pulls (mirrors the Python server)
    for (auto& stp : stripes_) {
      std::vector<std::tuple<uint64_t, ConnPtr, uint32_t, std::vector<uint8_t>,
                             uint32_t>> flush;
      std::vector<FusedReplyPtr> fused_done;
      {
        std::lock_guard<std::mutex> g(stp->mu);
        for (auto& [key, ks] : stp->keys) {
          if (ks->store.empty() || ks->recv_count < n) continue;
          std::vector<std::tuple<ConnPtr, uint32_t, std::vector<uint8_t>,
                                 uint32_t>> kf;
          publish_round_locked(*ks, &kf, &fused_done);
          for (auto& [pconn, pseq, data, ver] : kf)
            flush.emplace_back(key, pconn, pseq, std::move(data), ver);
        }
      }
      for (auto& [key, pconn, pseq, data, ver] : flush)
        send_msg(pconn, kPull, pseq, key, ver, data.data(), data.size());
      for (auto& fr : fused_done) send_fused_reply(fr);
    }
  }

  // zombie fence (docs/robustness.md): adopt the scheduler book's live
  // worker-flag set; n < 0 disables the fence (book without ranks).
  void set_live_workers(const uint8_t* flags, int32_t n) {
    std::lock_guard<std::mutex> g(live_mu_);
    live_.clear();
    if (n < 0) {
      fence_on_ = false;
      return;
    }
    fence_on_ = true;
    for (int32_t i = 0; i < n; ++i) live_.insert(flags[i]);
  }

  // Adopt an ownership map (docs/robustness.md "migration flow"): the
  // Python wrapper ships each scheduler book's consistent-hash ring as
  // precomputed sorted (point hash, rank) arrays.  n <= 0 disables
  // (back to map-less serving — every key served, never redirected).
  void set_ownership(int32_t my_rank, uint32_t epoch, int32_t n,
                     const uint64_t* hashes, const int32_t* ranks) {
    // build an IMMUTABLE snapshot and publish it with one atomic
    // pointer swap: the redirect check on every stripe's reducer thread
    // reads it lock-free (a shared mutex here would re-serialize the
    // key-striped data path the multi-core engine exists to unshare)
    std::shared_ptr<const OwnMap> next;
    if (n > 0 && hashes && ranks && my_rank >= 0) {
      auto m = std::make_shared<OwnMap>();
      m->hashes.assign(hashes, hashes + n);
      m->ranks.assign(ranks, ranks + n);
      m->epoch = epoch;
      m->rank = my_rank;
      next = std::move(m);
    }
    std::atomic_store_explicit(&own_, next, std::memory_order_release);
    own_set_.store(next != nullptr, std::memory_order_release);
  }

  // copy this instance's counters (NativeCounter order) into out
  int32_t read_counters(uint64_t* out, int32_t cap) const {
    int32_t n = std::min<int32_t>(cap, kCtrCount);
    for (int32_t i = 0; i < n; ++i)
      out[i] = ctr_[i].load(std::memory_order_relaxed);
    return n;
  }

  // current per-stripe task backlog (approximate, relaxed reads) — the
  // native_stripe_queue_depth{stripe} gauge feed: a persistently deep
  // stripe while its siblings idle means the key hash is aliasing hot
  // keys onto one reducer (docs/perf.md)
  int32_t read_stripe_depths(uint64_t* out, int32_t cap) const {
    int32_t n = std::min<int32_t>(cap, (int32_t)stripes_.size());
    for (int32_t i = 0; i < n; ++i)
      out[i] = stripes_[i]->pq ? stripes_[i]->pq->size()
                               : stripes_[i]->ring.depth();
    return n;
  }

  // span plane on/off (NativePSServer mirrors cfg.trace_on &&
  // cfg.trace_spans here; the env default below covers direct starts)
  void set_trace(bool on) { trace_on_.store(on, std::memory_order_relaxed); }
  bool tracing() const { return trace_on_.load(std::memory_order_relaxed); }

  int32_t drain_spans(SpanRec* out, int32_t cap) {
    return span_ring_.pop(out, cap);
  }

  // Histograms + counters as one JSON document (names live here in the
  // .cc, where tools/check_metrics_doc.py scans them): the body behind
  // bps_native_server_metrics_json, parsed by native/__init__.py and fed
  // through telemetry's histogram-provider seam into get_metrics(),
  // Prometheus, and the heartbeat cluster aggregate.
  std::string metrics_json() {
    std::string out = "{\"histograms\": [";
    std::vector<std::pair<uint64_t, KeyState*>> all;
    for (auto& stp : stripes_) {
      std::lock_guard<std::mutex> g(stp->mu);
      for (auto& [k, ks] : stp->keys) all.emplace_back(k, ks.get());
    }
    for (auto& [key, ks] : all) {
      std::string kv = std::to_string(key);
      ks->sum_hist.append_json(&out, "native_server_sum_seconds", "key", kv);
      ks->size_hist.append_json(&out, "native_request_bytes", "key", kv);
    }
    // Per-reducer summation occupancy, labeled by stripe — a SEPARATE
    // family from the per-key native_server_sum_seconds (same rule as
    // the *_labeled_total counter families: one family whose series
    // overlap the same observations would double-count under sum()).
    // A hot stripe (bad key hash / skewed tensor sizes) shows up as one
    // stripe's count/sum running away from its siblings.
    for (size_t i = 0; i < stripes_.size(); ++i)
      stripes_[i]->sum_hist.append_json(&out, "native_stripe_sum_seconds",
                                        "stripe", std::to_string(i));
    publish_hist_.append_json(&out, "native_server_publish_seconds", nullptr,
                              "");
    out += "], \"counters\": {";
    char buf[96];
    for (int i = 0; i < kCtrCount; ++i) {
      snprintf(buf, sizeof buf, "%s\"%s\": %llu", i ? ", " : "",
               kCounterNames[i],
               (unsigned long long)ctr_[i].load(std::memory_order_relaxed));
      out += buf;
    }
    out += "}}";
    return out;
  }

  int start(int port, int num_workers, bool enable_async) {
    listen_fd_ = ::socket(AF_INET, SOCK_STREAM, 0);
    if (listen_fd_ < 0) return -1;
    int one = 1;
    setsockopt(listen_fd_, SOL_SOCKET, SO_REUSEADDR, &one, sizeof(one));
    sockaddr_in addr{};
    addr.sin_family = AF_INET;
    addr.sin_addr.s_addr = htonl(INADDR_ANY);
    addr.sin_port = htons((uint16_t)port);
    if (bind(listen_fd_, (sockaddr*)&addr, sizeof(addr)) < 0) return -1;
    if (listen(listen_fd_, 128) < 0) return -1;
    socklen_t len = sizeof(addr);
    getsockname(listen_fd_, (sockaddr*)&addr, &len);
    if (!start_engine(num_workers, enable_async)) return -1;
    return ntohs(addr.sin_port);
  }

  // UDS listener variant: the uds van (shm=false) speaks the framed
  // protocol straight over the stream socket; the shm van (shm=true)
  // uses the socket for handshake/liveness and moves bytes through
  // mmap'd rings (VERDICT r3 #3 — native engine × zero-copy transport).
  bool start_unix(const char* path, int num_workers, bool enable_async,
                  bool shm) {
    shm_van_ = shm;
    uds_path_ = path;
    listen_fd_ = ::socket(AF_UNIX, SOCK_STREAM, 0);
    if (listen_fd_ < 0) return false;
    sockaddr_un addr{};
    addr.sun_family = AF_UNIX;
    bool ok = uds_path_.size() < sizeof(addr.sun_path);
    if (ok) {
      std::memcpy(addr.sun_path, uds_path_.c_str(), uds_path_.size() + 1);
      ok = bind(listen_fd_, (sockaddr*)&addr, sizeof(addr)) == 0 &&
           listen(listen_fd_, 128) == 0;
    }
    if (!ok) {
      ::close(listen_fd_);  // failed bring-up must not leak the fd
      listen_fd_ = -1;
      return false;
    }
    return start_engine(num_workers, enable_async);
  }

  void stop() {
    stop_.store(true);
    // Join the acceptor BEFORE closing the listen fd.  The accept loop
    // polls with a bounded timeout precisely so this join converges:
    // shutdown()/close() on a LISTENING AF_UNIX socket does not wake a
    // blocked accept() on Linux (TCP listeners return EINVAL, unix ones
    // stay parked forever) — the old shutdown-then-join order hung every
    // uds/shm native-server teardown.  Closing after the join also
    // removes the fd-reuse race (poll on a recycled fd number).
    if (accept_thread_.joinable()) accept_thread_.join();
    if (listen_fd_ >= 0) { shutdown(listen_fd_, SHUT_RDWR); close(listen_fd_); }
    if (!uds_path_.empty()) ::unlink(uds_path_.c_str());
    // reducers poll stop_ on a 200ms pop timeout; tasks still queued at
    // teardown are dropped (their conn refs release with the ring)
    for (auto& stp : stripes_)
      if (stp->reducer.joinable()) stp->reducer.join();
    std::vector<std::thread> threads;
    {
      // wake (not destroy) live conns so blocked recv()s return; the
      // transport closes when the last ConnPtr holder releases it.  Join
      // OUTSIDE the lock — exiting serve threads take conn_mu_ to prune.
      std::lock_guard<std::mutex> g(conn_mu_);
      for (auto& c : conns_) c->wake();
      threads.swap(threads_);
    }
    for (auto& t : threads)
      if (t.joinable()) t.join();
    std::lock_guard<std::mutex> g(conn_mu_);
    conns_.clear();
  }

 private:
  // One key-space shard: the key map, every owned KeyState, and the
  // schedule-mode priority bookkeeping live behind `mu`; decoded frames
  // arrive through the bounded task ring (or the priority queue when
  // BYTEPS_SERVER_ENABLE_SCHEDULE=1) and are executed by this stripe's
  // one reducer thread.  qmu/cv_* are ONLY the ring's park/backpressure
  // slow path — steady-state handoff is lock-free.
  struct Stripe {
    std::mutex mu;
    std::map<uint64_t, std::unique_ptr<KeyState>> keys;
    std::map<uint64_t, uint64_t> pushed_total;  // schedule-mode priorities
    TaskRing ring;
    std::unique_ptr<EngineQueue> pq;  // schedule mode replaces the ring
    std::thread reducer;
    bps_hist::Hist sum_hist;  // this reducer's per-task summation time
    std::mutex qmu;
    std::condition_variable cv_empty, cv_full;
    std::atomic<bool> parked{false};     // reducer asleep in stripe_pop
    std::atomic<int> prod_waiting{0};    // producers asleep on a full ring
  };

  bool start_engine(int num_workers, bool enable_async) {
    num_workers_.store(num_workers);
    async_ = enable_async;
    const char* sch = getenv("BYTEPS_SERVER_ENABLE_SCHEDULE");
    schedule_ = sch && atoi(sch) != 0;
    // end-to-end wire integrity (docs/robustness.md "Wire integrity"):
    // stamp replies + tolerate BYTEPS_CHECKSUM_CONN_LIMIT mismatches
    // per connection before dropping it (shared wire.h parsers —
    // transport.py truthiness)
    checksum_on_ = bps_wire::checksum_env_on();
    lossless_on_ = bps_wire::lossless_env_on();
    ck_conn_limit_ = bps_wire::checksum_env_conn_limit();
    // BYTEPS_SERVER_STRIPES: reducer-thread count the key space shards
    // across.  Default min(4, cores): below 4 cores more stripes only
    // buy context switching; above, 4 reducers already saturate the
    // memory bus this sum-and-memcpy workload lives on (docs/perf.md).
    // When STRIPES is unset, an explicit BYTEPS_SERVER_ENGINE_THREAD is
    // honored as the stripe count — it was this engine's thread knob
    // before striping, and deployments that sized it must not silently
    // drop to the auto default on upgrade (docs/env.md).
    const char* sv = getenv("BYTEPS_SERVER_STRIPES");
    int n = sv ? atoi(sv) : 0;
    if (n <= 0) {
      const char* et = getenv("BYTEPS_SERVER_ENGINE_THREAD");
      n = et ? atoi(et) : 0;
    }
    if (n <= 0) {
      int hw = (int)std::thread::hardware_concurrency();
      n = std::min(4, hw > 0 ? hw : 4);
    }
    if (n > 64) n = 64;  // sanity cap: fds + stacks, not a real topology
    for (int i = 0; i < n; ++i) {
      stripes_.emplace_back(new Stripe());
      if (schedule_) stripes_.back()->pq.reset(new EngineQueue(true));
    }
    // striping off (one stripe, no anti-starvation queue): run handlers
    // inline on the serve threads — no reducer thread, no ring hop (see
    // the plane comment above).  Schedule mode keeps the queue even at
    // one stripe: its whole point is reordering across a backlog.
    inline_exec_ = (n == 1 && !schedule_);
    if (!inline_exec_)
      for (int i = 0; i < n; ++i)
        stripes_[i]->reducer = std::thread([this, i] { reducer_loop(i); });
    accept_thread_ = std::thread([this] { accept_loop(); });
    return true;
  }

  void accept_loop() {
    // non-blocking + poll tick: accept() must never park unboundedly,
    // or stop()'s join hangs on vans whose listener shutdown cannot
    // wake it (AF_UNIX; see stop()).  200ms bounds teardown latency.
    int fl = fcntl(listen_fd_, F_GETFL, 0);
    fcntl(listen_fd_, F_SETFL, fl | O_NONBLOCK);
    while (!stop_.load()) {
      pollfd p{listen_fd_, POLLIN, 0};
      int pr = ::poll(&p, 1, 200);
      if (stop_.load()) return;
      if (pr < 0) {
        if (errno == EINTR) continue;
        return;
      }
      if (pr == 0) continue;
      int fd = accept(listen_fd_, nullptr, nullptr);
      if (fd < 0) {
        // transient failures (client RST before accept, signals, fd
        // pressure) must not kill the acceptor
        if (errno == EAGAIN || errno == EWOULDBLOCK || errno == EINTR ||
            errno == ECONNABORTED || errno == EMFILE || errno == ENFILE ||
            errno == ENOBUFS || errno == ENOMEM) {
          continue;
        }
        return;  // listen socket closed (stop) or unrecoverable
      }
      // accepted fds do not inherit O_NONBLOCK on Linux, but make the
      // serve loops' blocking assumption explicit
      int cfl = fcntl(fd, F_GETFL, 0);
      fcntl(fd, F_SETFL, cfl & ~O_NONBLOCK);
      ConnPtr conn;
      if (uds_path_.empty()) {
        int one = 1;
        setsockopt(fd, IPPROTO_TCP, TCP_NODELAY, &one, sizeof(one));
        conn = std::make_shared<FdConn>(fd);
      } else if (shm_van_) {
        conn = std::make_shared<ShmConn>(fd);  // handshake lazy, in serve()
      } else {
        conn = std::make_shared<FdConn>(fd);  // uds: plain byte stream
      }
      std::lock_guard<std::mutex> g(conn_mu_);
      conns_.push_back(conn);
      threads_.emplace_back([this, conn] { serve(conn); });
    }
  }

  void send_msg(const ConnPtr& conn, uint8_t op, uint32_t seq, uint64_t key,
                uint32_t version, const uint8_t* payload, uint64_t len,
                uint8_t status = 0) {
    // lossless frame transform (transport.py Message._stamp_lossless
    // parity): control-plane payloads compress BEFORE the head is
    // built, so `length` and the CRC32C cover the bytes that ship; the
    // flag rides only when the container actually won
    std::vector<uint8_t> lz;
    if (lossless_on_ && bps_wire::lossless_op(op) &&
        len >= bps_wire::kLosslessMinBytes) {
      lz.resize(bps_wire::kLosslessHeader + (size_t)len + (size_t)len / 255 +
                16);
      size_t c = bps_wire::lossless_compress_frame(payload, (size_t)len,
                                                   lz.data(), lz.size());
      if (c > 0 && c < (size_t)len) {
        payload = lz.data();
        len = c;
        status |= bps_wire::kLosslessFlag;
      }
    }
    // shared wire.h head builder: header + (with BYTEPS_WIRE_CHECKSUM)
    // the 4-byte CRC32C over the payload — the SAME encode path the
    // native client and the golden shims use, computed once per frame
    uint8_t head[bps_wire::kMaxHeadLen];
    size_t head_len = bps_wire::build_head(
        head, op, status, /*flags=*/0, seq, key, /*cmd=*/0, version, payload,
        len, /*trace_id=*/0, /*span_id=*/0,
        checksum_on_ && bps_wire::checksum_op(op));
    // per-connection write mutex lives IN the Conn, so concurrent engine
    // threads serialize against each other for exactly this stream
    std::lock_guard<std::mutex> g(conn->write_mu);
    if (!conn->send_all(head, head_len)) return;
    if (len) conn->send_all(payload, len);
  }

  int32_t stripe_idx(uint64_t key) const {
    return (int32_t)bps_wire::key_stripe(key, (uint32_t)stripes_.size());
  }
  Stripe& stripe_of(uint64_t key) { return *stripes_[stripe_idx(key)]; }

  // the ONE KeyState accessor; caller holds st.mu
  KeyState& key_state_locked(Stripe& st, uint64_t key) {
    auto& slot = st.keys[key];
    if (!slot) slot = std::make_unique<KeyState>();
    return *slot;
  }

  // Producer half of the stripe handoff (serve threads).  Fast path is
  // one lock-free ring push + a fence + one flag load; the mutex/cv pair
  // only runs when the ring is FULL (backpressure: the producer yields,
  // then naps 1ms ticks until the reducer frees a slot — bounded
  // timeouts make a lost wakeup cost one tick, never a hang) or when
  // the reducer declared itself parked (empty-queue doorbell).
  void stripe_put(Stripe& st, EngineTask&& t, uint64_t prio) {
    if (st.pq) {
      st.pq->put(std::move(t), prio);
      return;
    }
    int spins = 0;
    while (!st.ring.try_push(t)) {  // moves from t only on success
      if (stop_.load()) return;  // teardown: drop; the conn is dying too
      if (++spins <= 32) {
        sched_yield();
        continue;
      }
      std::unique_lock<std::mutex> lk(st.qmu);
      st.prod_waiting.fetch_add(1, std::memory_order_relaxed);
      st.cv_full.wait_for(lk, std::chrono::milliseconds(1));
      st.prod_waiting.fetch_sub(1, std::memory_order_relaxed);
    }
    // Doorbell check.  The seq_cst fence pairs with the one in
    // stripe_pop: without it this is the store-buffering litmus (our
    // ring-slot store / parked load vs the reducer's parked store /
    // ring-slot recheck can BOTH read stale values on x86 StoreLoad
    // reordering), and a lost doorbell leaves the task queued for the
    // reducer's full 200ms pop timeout.
    std::atomic_thread_fence(std::memory_order_seq_cst);
    if (st.parked.load(std::memory_order_relaxed)) {
      std::lock_guard<std::mutex> g(st.qmu);
      st.cv_empty.notify_one();
    }
  }

  // Consumer half (the stripe's reducer only).  Pops lock-free while
  // work is queued; parks on cv_empty when idle, with the park flag
  // published under qmu and one recheck so a concurrent producer either
  // sees the flag or the recheck sees its task.  The timeout doubles as
  // the stop_ poll tick.
  bool stripe_pop(Stripe& st, EngineTask* out, int timeout_ms) {
    if (st.pq) return st.pq->pop(out, timeout_ms);
    if (st.ring.try_pop(out)) {
      wake_producers(st);
      return true;
    }
    {
      std::unique_lock<std::mutex> lk(st.qmu);
      st.parked.store(true, std::memory_order_release);
      // pairs with stripe_put's fence: the flag store must be visible
      // before the recheck reads the ring, or producer and reducer can
      // each miss the other's write and the wakeup is lost
      std::atomic_thread_fence(std::memory_order_seq_cst);
      if (st.ring.try_pop(out)) {
        st.parked.store(false, std::memory_order_release);
        lk.unlock();
        wake_producers(st);
        return true;
      }
      st.cv_empty.wait_for(lk, std::chrono::milliseconds(timeout_ms));
      st.parked.store(false, std::memory_order_release);
    }
    if (st.ring.try_pop(out)) {
      wake_producers(st);
      return true;
    }
    return false;
  }

  void wake_producers(Stripe& st) {
    if (st.prod_waiting.load(std::memory_order_relaxed) > 0) {
      std::lock_guard<std::mutex> g(st.qmu);
      st.cv_full.notify_all();
    }
  }

  // one decoded data-plane task through its handler — shared by the
  // reducer threads and the stripes=1 inline fast path (serve threads)
  bool run_task(Stripe& st, int sid, EngineTask& t) {
    if (t.op == kPush) return handle_push(st, sid, t);
    if (t.op == kPull) return handle_pull(st, sid, t);
    if (t.op == kTaskFusedMember) return handle_fused_member(st, sid, t);
    return true;
  }

  void reducer_loop(int sid) {
    Stripe& st = *stripes_[sid];
    EngineTask t;
    while (!stop_.load()) {
      if (!stripe_pop(st, &t, 200)) continue;
      bool ok = run_task(st, sid, t);
      if (!ok) {
        // malformed request → drop the connection: wake() unblocks the
        // serve thread's recv; the transport closes with its last holder
        t.conn->wake();
      }
      t = EngineTask{};  // release conn/frame/reply refs promptly
    }
  }

  void serve(const ConnPtr& conn) {
    serve_inner(conn);
    // prune our registry entry; the Conn destructor closes the fd once
    // queued tasks / pending pulls / init waiters release their refs
    std::lock_guard<std::mutex> g(conn_mu_);
    for (auto it = conns_.begin(); it != conns_.end(); ++it)
      if (*it == conn) { conns_.erase(it); break; }
  }

  void serve_inner(const ConnPtr& conn) {
    std::vector<uint8_t> payload;
    uint32_t ck_fails = 0;  // per-connection mismatch tally (escalation)
    while (!stop_.load()) {
      Header h;
      if (!conn->recv_exact(&h, sizeof(h))) { NDBG("serve: header recv failed"); break; }
      if (h.magic != kMagic) { NDBG("serve: BAD MAGIC 0x%02x (desync)", h.magic); break; }

      // Optional trace context (transport.py TRACE_FLAG, status bit 7):
      // a tracing worker appends 16 bytes (u64 trace_id + u64 span_id)
      // after the header.  The block is always consumed (the stream
      // must stay framed), but decoded into span context only when the
      // span plane is on — with BYTEPS_TRACE_SPANS=0 this is one
      // relaxed atomic load and no ring ever sees a write.  The raw
      // bytes are kept: the frame checksum covers them.
      uint64_t trace_id = 0, span_id = 0;
      uint8_t trace_ctx[16];
      bool have_trace = false;
      if (h.status & kTraceFlag) {
        if (!conn->recv_exact(trace_ctx, sizeof(trace_ctx))) {
          NDBG("serve: trace-context recv failed");
          break;
        }
        have_trace = true;
        if (tracing()) bps_wire::unpack_trace(trace_ctx, &trace_id, &span_id);
        h.status &= static_cast<uint8_t>(~kTraceFlag);
      }
      // Optional end-to-end checksum (transport.py CHECKSUM_FLAG):
      // consume the 4-byte CRC32C block; verified below once the
      // payload landed — BEFORE anything reaches a stripe ring or sum
      // core (docs/robustness.md "Wire integrity").
      uint32_t want_crc = 0;
      bool have_ck = false;
      if (h.status & bps_wire::kChecksumFlag) {
        uint8_t ckb[4];
        if (!conn->recv_exact(ckb, sizeof(ckb))) {
          NDBG("serve: checksum recv failed");
          break;
        }
        std::memcpy(&want_crc, ckb, 4);
        want_crc = ntohl(want_crc);
        h.status &= static_cast<uint8_t>(~bps_wire::kChecksumFlag);
        have_ck = true;
      }
      // Optional lossless container (transport.py LOSSLESS_FLAG): the
      // payload is compressed on the wire — decoded below, AFTER the
      // CRC verifies the bytes that actually shipped.
      bool have_lz = false;
      if (h.status & bps_wire::kLosslessFlag) {
        h.status &= static_cast<uint8_t>(~bps_wire::kLosslessFlag);
        have_lz = true;
      }

      uint32_t seq = ntohl(h.seq);
      uint64_t key = be64toh(h.key);
      uint32_t cmd = ntohl(h.cmd);
      uint32_t version = ntohl(h.version);
      uint64_t len = be64toh(h.length);
      payload.resize(len);
      if (len && !conn->recv_exact(payload.data(), len)) break;
      if (have_ck) {
        uint32_t crc = have_trace ? bps_wire::crc32c(trace_ctx, 16) : 0;
        crc = bps_wire::crc32c(payload.data(), payload.size(), crc);
        if (crc != want_crc) {
          // DROP: no reply, no state touched — the sender's deadline/
          // retry + the exactly-once ledger heal it bitwise.  Repeated
          // mismatches mean the path itself is bad: close the conn so
          // the client's revival re-dials.
          ctr_[kCtrChecksumFail].fetch_add(1, std::memory_order_relaxed);
          if (ck_conn_limit_ && ++ck_fails >= ck_conn_limit_) {
            NDBG("serve: %u checksum mismatches — dropping conn", ck_fails);
            ctr_[kCtrChecksumConnDrop].fetch_add(1,
                                                 std::memory_order_relaxed);
            break;
          }
          continue;
        }
      }
      if (have_lz) {
        // decompress AFTER integrity passes; a corrupt container drops
        // exactly like a CRC mismatch — no reply, no state touched,
        // fail closed (never a silent wrong-bytes install), with the
        // same repeated-corruption connection escalation
        long raw = bps_wire::lossless_raw_len(payload.data(), payload.size());
        std::vector<uint8_t> dec;
        long got = -1;
        if (raw >= 0) {
          dec.resize(raw > 0 ? (size_t)raw : 1);
          got = bps_wire::lossless_decompress_frame(
              payload.data(), payload.size(), dec.data(), (size_t)raw);
        }
        if (got < 0 || got != raw) {
          NDBG("serve: lossless decode failed (op %d)", (int)h.op);
          ctr_[kCtrLosslessFail].fetch_add(1, std::memory_order_relaxed);
          if (ck_conn_limit_ && ++ck_fails >= ck_conn_limit_) {
            ctr_[kCtrChecksumConnDrop].fetch_add(1,
                                                 std::memory_order_relaxed);
            break;
          }
          continue;
        }
        dec.resize((size_t)raw);
        payload.swap(dec);
        len = (uint64_t)raw;
      }
      // Multi-tenant fence (docs/async.md): keys carry their job id in
      // the top 16 bits, and this engine has no per-job round sizing,
      // QoS weighting, or admission metering — summing an unknown
      // tenant's frames against the fleet-wide worker count would
      // corrupt its rounds silently.  The payload is already consumed
      // (stream stays framed); reject CLEANLY with the nonzero-status
      // echo, log once, and keep serving job-0 traffic.  Run
      // Python-engine servers for BYTEPS_JOB_ID != 0 fleets.
      if ((key >> 48) != 0 && h.op != kPing && h.op != kShutdown) {
        static std::atomic<bool> warned_job{false};
        if (!warned_job.exchange(true)) {
          fprintf(stderr,
                  "byteps-native: rejecting frame for job %llu (key "
                  "%llx) — multi-tenant job namespaces are "
                  "Python-engine-only (docs/async.md)\n",
                  (unsigned long long)(key >> 48),
                  (unsigned long long)key);
        }
        ctr_[kCtrJobReject].fetch_add(1, std::memory_order_relaxed);
        send_msg(conn, h.op, seq, key, 0, nullptr, 0, /*status=*/1);
        continue;
      }
      switch (h.op) {
        case kPing:
          send_msg(conn, kPing, seq, 0, 0, nullptr, 0);
          break;
        case kShutdown:
          send_msg(conn, kShutdown, seq, 0, 0, nullptr, 0);
          return;
        case kInit:
          // flags = worker identity, version = the init-idempotency
          // token (docs/robustness.md); malformed → drop conn
          if (!handle_init(conn, seq, key, h.flags, version, payload)) return;
          break;
        case kRegisterCompressor:
          handle_register(conn, seq, key, h.flags, payload);
          break;
        case kResyncQuery:
          // recovery plane: answered inline — a read-mostly snapshot of
          // the exactly-once ledger, and the asking worker is stalled on
          // it (mirrors the Python server's serve-thread handling)
          if (!handle_resync(conn, seq, key, payload, trace_id, span_id))
            return;
          break;
        case kPush:
        case kPull: {
          // data plane rides the stripe rings: key → stripe by hash
          // (wire.h key_stripe), nothing global on this path.  The
          // anti-starvation prio (schedule mode only) is the key's
          // accumulated push count (queue.h:49-97), snapshot at enqueue
          // like the reference's cached priority.
          ctr_[kCtrWireRpc].fetch_add(1, std::memory_order_relaxed);
          Stripe& st = stripe_of(key);
          uint64_t prio = 0;
          if (schedule_) {
            std::lock_guard<std::mutex> g(st.mu);
            if (h.op != kPull) st.pushed_total[key]++;
            prio = st.pushed_total[key];
          }
          EngineTask t;
          t.op = h.op;
          t.flags = h.flags;
          t.conn = conn;
          t.seq = seq;
          t.key = key;
          t.cmd = cmd;
          t.version = version;
          if (trace_id) {  // traced frame: bound the recv (queue-dwell) span
            t.trace_id = trace_id;
            t.span_id = span_id;
            t.t_enq = wall_now();
          }
          t.payload = std::move(payload);
          payload.clear();
          if (inline_exec_) {
            // stripes=1: sum/serve on THIS thread (malformed → drop conn,
            // the inline twin of the reducer's conn->wake())
            if (!run_task(st, 0, t)) return;
            break;
          }
          stripe_put(st, std::move(t), prio);
          break;
        }
        case kFused: {
          // Op.FUSED: decoded HERE on the I/O thread, members scattered
          // to their owning stripes, the single multi-key reply gathered
          // by the FusedReply countdown — the last member's reducer
          // sends it (docs/architecture.md "Key striping").
          ctr_[kCtrWireRpc].fetch_add(1, std::memory_order_relaxed);
          if (!scatter_fused(conn, seq, key, h.flags, payload, trace_id,
                             span_id))
            return;  // malformed/fenced fused frame → drop conn
          payload.clear();  // scatter took the buffer
          break;
        }
        default: {
          // Unknown control op (a NEWER protocol than this engine).  The
          // payload is already consumed, so the stream stays framed;
          // reject CLEANLY with a nonzero status echoing the op + seq so
          // the caller fails fast instead of waiting out its deadline,
          // and say so once per process (same pattern as the
          // trace-context skip above).
          static std::atomic<bool> warned{false};
          if (!warned.exchange(true)) {
            fprintf(stderr,
                    "byteps-native: rejecting unknown op %d (newer protocol "
                    "than this engine speaks)\n",
                    (int)h.op);
          }
          send_msg(conn, h.op, seq, key, 0, nullptr, 0, /*status=*/1);
          break;
        }
      }
    }
  }

  // Completed init barrier: consume the waiters and reset the round
  // state (server.py _complete_init_barrier_locked parity).  A completed
  // barrier (re-)establishes round numbering — after an elastic
  // resize/resume every worker re-inits and restarts versions at 1
  // (ReDeclareTensor semantics); store CONTENTS are preserved (async
  // parameter store across resume).  Caller holds ks.mu.
  void complete_init_barrier_locked(KeyState& ks,
                                    std::vector<InitWaiter>* waiters) {
    waiters->swap(ks.init_waiters);
    // record each waiter's init token: a retried INIT landing AFTER this
    // release is acked from the record instead of re-parked (dropped-ack
    // idempotency).  REPLACED, not merged — an older generation's tokens
    // must not false-ack a new generation's genuine barrier.
    ks.init_done.clear();
    for (auto& w : *waiters)
      if (w.wid && w.token) ks.init_done[w.wid] = w.token;
    ks.store_version = 0;
    ks.recv_count = 0;
    ks.pending.clear();
    // parked fused pull-halves are from the abandoned generation too —
    // their frames' round numbering no longer matches (dropped; the
    // worker's retry/deadline path owns them)
    ks.fused_waiters.clear();
    // the new generation restarts versions at 1, so the replay ledger
    // from the previous generation must not mark its first-round pushes
    // as duplicates
    ks.push_seen.clear();
    ks.pull_payload.clear();  // stale round cache must not be served
  }

  bool handle_init(const ConnPtr& conn, uint32_t seq, uint64_t key,
                   uint8_t wid, uint32_t token,
                   const std::vector<uint8_t>& payload) {
    // malformed init must not silently strand the barrier: drop the
    // connection so the worker sees EOF instead of hanging forever
    if (payload.size() < 12) return false;
    // Async-profile extension (docs/async.md): byte 12 bit 0 declares
    // the key ASYNC (pushes apply immediately, pulls gated by a
    // staleness bound).  This engine has no async plane — accepting the
    // INIT and then running sync rounds would silently violate the
    // consistency contract the worker asked for, so reject CLEANLY with
    // the nonzero-status echo (the worker surfaces "run Python-engine
    // servers"); log once.  Sync keys never send the extension.
    if (payload.size() >= 13 && (payload[12] & 1)) {
      static std::atomic<bool> warned_async{false};
      if (!warned_async.exchange(true)) {
        fprintf(stderr,
                "byteps-native: rejecting async-profile init (key %llx) "
                "— the async push_pull plane is Python-engine-only "
                "(docs/async.md)\n",
                (unsigned long long)key);
      }
      ctr_[kCtrAsyncReject].fetch_add(1, std::memory_order_relaxed);
      send_msg(conn, kInit, seq, key, 0, nullptr, 0, /*status=*/1);
      return true;
    }
    // Server-opt profile (bit 1, docs/architecture.md "Server-side
    // optimizer"): the worker asked this engine to RUN the update rule
    // and serve parameters.  This engine only SUMs — accepting would
    // silently hand the worker raw gradient sums where it expects
    // parameters, so reject cleanly like the async precedent.
    if (payload.size() >= 13 && (payload[12] & 2)) {
      static std::atomic<bool> warned_opt{false};
      if (!warned_opt.exchange(true)) {
        fprintf(stderr,
                "byteps-native: rejecting server-opt-profile init "
                "(key %llx) — the server-side optimizer plane is "
                "Python-engine-only (docs/architecture.md)\n",
                (unsigned long long)key);
      }
      ctr_[kCtrServerOptReject].fetch_add(1, std::memory_order_relaxed);
      send_msg(conn, kInit, seq, key, 0, nullptr, 0, /*status=*/1);
      return true;
    }
    uint64_t n;
    uint32_t dt;
    std::memcpy(&n, payload.data(), 8);
    std::memcpy(&dt, payload.data() + 8, 4);
    n = be64toh(n);
    dt = ntohl(dt);
    // INIT routes to the key's owning stripe: barrier state lives with
    // the rest of the key's state behind the shard lock, so token
    // replay-acks and generation resets stay atomic with the sums the
    // stripe's reducer is running
    Stripe& stripe = stripe_of(key);
    std::vector<InitWaiter> waiters;
    bool replay_ack = false;
    uint32_t ro_epoch = 0;
    int32_t ro_owner = -1;
    bool redirect = false;
    {
      std::lock_guard<std::mutex> g(stripe.mu);
      redirect = redirect_locked(stripe, key, &ro_epoch, &ro_owner);
      if (!redirect) {
      KeyState& ks = key_state_locked(stripe, key);
      if (ks.store.empty()) {
        ks.dtype = (int32_t)dt;
        ks.nelems = (int64_t)n;
        size_t bytes = (size_t)n * dtype_size((int32_t)dt);
        ks.store.assign(bytes, 0);
        ks.accum.assign(bytes, 0);
      }
      // init-idempotency (docs/robustness.md): a replayed INIT whose
      // barrier already COMPLETED — the retry of an ack dropped after
      // the release — is acked from the completed-barrier record.
      // Parking it would strand the worker: its released peers never
      // re-init this key, so the short barrier outlives the retry
      // budget.  A fresh token (elastic rejoin, restarted client) still
      // parks: genuine new barriers are unaffected.
      auto it = ks.init_done.find(wid);
      if (wid && token && it != ks.init_done.end() && it->second == token) {
        ctr_[kCtrInitReplayAck].fetch_add(1, std::memory_order_relaxed);
        replay_ack = true;
      } else {
        // keyed by worker identity: a REPLAYED init (retry after a lost
        // ack / torn connection) REPLACES this worker's waiter entry —
        // appending again would double-count one worker and release the
        // barrier short.  Anonymous inits (wid 0) keep appending.
        InitWaiter w{wid, conn, seq, token};
        bool replaced = false;
        if (wid) {
          for (auto& e : ks.init_waiters)
            if (e.wid == wid) {
              e = std::move(w);
              replaced = true;
              break;
            }
        }
        if (!replaced) ks.init_waiters.push_back(std::move(w));
        int workers = num_workers_.load();
        if (workers > 0 && (int)ks.init_waiters.size() >= workers)
          complete_init_barrier_locked(ks, &waiters);
      }
      }  // !redirect
    }
    if (redirect) {
      // the map homes this key elsewhere: the worker's init chases to
      // the owner instead of planting a split-brain store here
      send_wrong_owner(conn, seq, key, ro_epoch, ro_owner);
      return true;
    }
    if (replay_ack) {
      send_msg(conn, kInit, seq, key, 0, nullptr, 0);
      return true;
    }
    for (auto& w : waiters) send_msg(w.conn, kInit, w.seq, key, 0, nullptr, 0);
    return true;
  }

  void handle_register(const ConnPtr& conn, uint32_t seq, uint64_t key,
                       uint8_t flags, const std::vector<uint8_t>& payload) {
    if (flags & 1) {
      // lr update for every EF chain (flag bit 0; payload = big-endian
      // f64) — the wire replacement for the reference's lr.s mmap
      if (payload.size() == 8) {
        uint64_t bits;
        std::memcpy(&bits, payload.data(), 8);
        bits = be64toh(bits);
        double lr;
        std::memcpy(&lr, &bits, 8);
        ef_lr_.store((float)lr);
      }
      send_msg(conn, kRegisterCompressor, seq, key, 0, nullptr, 0);
      return;
    }
    std::map<std::string, std::string> kw;
    std::string text((const char*)payload.data(), payload.size());
    size_t pos = 0;
    while (pos < text.size()) {
      size_t nl = text.find('\n', pos);
      std::string line = text.substr(pos, nl == std::string::npos ? nl : nl - pos);
      size_t eq = line.find('=');
      if (eq != std::string::npos)
        kw[line.substr(0, eq)] = line.substr(eq + 1);
      if (nl == std::string::npos) break;
      pos = nl + 1;
    }
    Stripe& stripe = stripe_of(key);
    {
      std::lock_guard<std::mutex> g(stripe.mu);
      KeyState& ks = key_state_locked(stripe, key);
      ks.codec = make_codec(kw, ks.nelems);
    }
    send_msg(conn, kRegisterCompressor, seq, key, 0, nullptr, 0);
  }

  // Zombie fence (docs/robustness.md): true when the scheduler's latest
  // book lists live ranks and this worker flag is NOT among them — a
  // stalled-but-alive worker must not pollute rounds sized for the
  // shrunken membership; it learns of its expulsion through the dropped
  // connection.
  bool fenced(uint8_t wid) {
    if (!wid) return false;
    std::lock_guard<std::mutex> g(live_mu_);
    if (!fence_on_ || live_.count(wid)) return false;
    ctr_[kCtrZombieReject].fetch_add(1, std::memory_order_relaxed);
    return true;
  }

  // Ownership redirect check (server.py _redirect_locked parity; caller
  // holds st.mu so the verdict is atomic with the summation it gates).
  // True → the caller replies kWrongOwner instead of serving.  A key
  // this engine still HOLDS serves normally even when the map homes it
  // elsewhere — the native engine never ships state, so it simply stays
  // authoritative (the Python pre-ship-window rule, indefinitely).
  bool redirect_locked(Stripe& st, uint64_t key, uint32_t* epoch,
                       int32_t* owner) {
    if (!own_set_.load(std::memory_order_relaxed)) return false;
    std::shared_ptr<const OwnMap> m =
        std::atomic_load_explicit(&own_, std::memory_order_acquire);
    if (!m || m->hashes.empty() || m->rank < 0) return false;
    auto it = std::upper_bound(m->hashes.begin(), m->hashes.end(),
                               bps_wire::ring_key_hash(key));
    size_t i = (size_t)(it - m->hashes.begin());
    if (i >= m->hashes.size()) i = 0;  // wrap: past last point → first
    int32_t o = m->ranks[i];
    if (o == m->rank) return false;
    auto kit = st.keys.find(key);
    if (kit != st.keys.end() && !kit->second->store.empty())
      return false;  // held here: stays authoritative
    *epoch = m->epoch;
    *owner = o;
    return true;
  }

  void send_wrong_owner(const ConnPtr& conn, uint32_t seq, uint64_t key,
                        uint32_t epoch, int32_t owner) {
    ctr_[kCtrWrongOwner].fetch_add(1, std::memory_order_relaxed);
    char body[64];
    int n = snprintf(body, sizeof(body), "{\"owner\": %d, \"epoch\": %u}",
                     (int)owner, (unsigned)epoch);
    // header version carries the epoch too (transport.py contract: a
    // worker can chase without parsing the body)
    send_msg(conn, kWrongOwner, seq, key, epoch, (const uint8_t*)body,
             (uint64_t)n);
  }

  // replay-dedupe check (caller holds ks.mu): true when this (worker,
  // version) was already summed — ack it, don't re-sum
  bool is_replayed_push_locked(KeyState& ks, uint8_t wid, uint32_t version) {
    if (!wid || version == 0) return false;
    auto it = ks.push_seen.find(wid);
    if (it != ks.push_seen.end() && version <= it->second) {
      ctr_[kCtrPushDedup].fetch_add(1, std::memory_order_relaxed);
      return true;
    }
    return false;
  }

  // One (sub-)push's summation under ks.mu — shared by the plain PUSH
  // and FUSED member paths so both stay behaviorally identical
  // (server.py _sum_push_locked parity).  The replay-ledger entry is
  // recorded only AFTER the summation succeeded: a sum that fails must
  // leave the retry eligible.  Returns false on a malformed payload
  // (caller drops the connection).
  bool sum_push_locked(
      KeyState& ks, uint8_t wid, uint32_t version, const uint8_t* payload,
      uint64_t len, bool compressed,
      std::vector<std::tuple<ConnPtr, uint32_t, std::vector<uint8_t>,
                             uint32_t>>* flush,
      std::vector<FusedReplyPtr>* fused_done,
      double* publish_dur = nullptr) {
    // malformed compressed payload → drop conn (mirrors malformed-init)
    if (compressed && !ks.codec->wire_ok((int64_t)len)) return false;
    float* accf = (float*)ks.accum.data();
    // clamp to the allocated buffer: a payload larger than the declared
    // size (client skew) must never write out of bounds
    const int64_t max_elems = (int64_t)ks.store.size() / dtype_size(ks.dtype);
    const int64_t n_elems =
        std::min<int64_t>((int64_t)len / dtype_size(ks.dtype), max_elems);
    if (async_) {
      if (compressed)
        ks.codec->sum_into(payload, (int64_t)len, (float*)ks.store.data());
      else
        bps_sum(ks.store.data(), payload, n_elems, ks.dtype);
      ks.store_version++;
    } else {
      if (compressed) {
        if (ks.recv_count == 0) {
          std::memset(ks.accum.data(), 0, ks.accum.size());
          ks.codec->decompress(payload, (int64_t)len, accf);
        } else {
          ks.codec->sum_into(payload, (int64_t)len, accf);
        }
      } else if (ks.recv_count == 0) {
        std::memcpy(ks.accum.data(), payload,
                    std::min<size_t>(len, ks.accum.size()));
      } else {
        bps_sum(ks.accum.data(), payload, n_elems, ks.dtype);
      }
      ks.recv_count++;
    }
    if (wid && version > 0) ks.push_seen[wid] = version;
    if (!async_ && ks.recv_count >= num_workers_.load()) {
      double p0 = wall_now();
      publish_round_locked(ks, flush, fused_done);
      if (publish_dur) *publish_dur = wall_now() - p0;
    }
    return true;
  }

  // one plain PUSH on its key's reducer thread (caller: reducer_loop)
  bool handle_push(Stripe& st, int sid, EngineTask& t) {
    if (fenced(t.flags)) return false;  // evicted worker → drop conn
    int32_t rtype, dtype;
    decode_cantor(t.cmd, &rtype, &dtype);
    std::vector<std::tuple<ConnPtr, uint32_t, std::vector<uint8_t>, uint32_t>> flush;
    std::vector<FusedReplyPtr> fused_done;
    // child spans mirror server.py: recv (stripe-queue dwell) → sum
    // (dedupe-annotated) → publish (when this push closed the round) →
    // reply, all parented onto the wire-propagated worker span
    double t_start = wall_now();
    if (t.trace_id && t.t_enq > 0)
      span(t.trace_id, t.span_id, t.key, t.t_enq, t_start - t.t_enq,
           kSpanRecv, 0, sid);
    bool dedupe = false;
    double published = 0.0;
    uint32_t ro_epoch = 0;
    int32_t ro_owner = -1;
    KeyState* ksp = nullptr;
    {
      std::lock_guard<std::mutex> g(st.mu);
      // checked under st.mu so the verdict is atomic with the sum it
      // gates; the reply goes out after the unlock (small + rare)
      if (!redirect_locked(st, t.key, &ro_epoch, &ro_owner)) {
        KeyState& ks = key_state_locked(st, t.key);
        ksp = &ks;
        if (ks.store.empty()) return false;  // push before init → drop conn
        dedupe = is_replayed_push_locked(ks, t.flags, t.version);
        if (rtype == 1) {  // kRowSparsePushPull: scatter-sum rows
          if (!dedupe &&
              !handle_push_rowsparse_locked(ks, t.flags, t.version, t.payload,
                                            &flush, &fused_done, &published))
            return false;
        } else {
          bool compressed = (rtype == 2) && ks.codec != nullptr;
          if (!dedupe &&
              !sum_push_locked(ks, t.flags, t.version, t.payload.data(),
                               t.payload.size(), compressed, &flush,
                               &fused_done, &published))
            return false;
        }
      }
    }
    if (ksp == nullptr) {  // ownership redirect: no state was touched
      send_wrong_owner(t.conn, t.seq, t.key, ro_epoch, ro_owner);
      return true;
    }
    ksp->size_hist.observe((double)t.payload.size());
    double t_summed = wall_now();
    double sum_dur = t_summed - t_start - published;
    if (sum_dur < 0) sum_dur = 0;
    ksp->sum_hist.observe(sum_dur);
    st.sum_hist.observe(sum_dur);
    if (published > 0) publish_hist_.observe(published);
    if (t.trace_id) {
      span(t.trace_id, t.span_id, t.key, t_start, sum_dur, kSpanSum,
           dedupe ? kSpanFlagDedupe : 0, sid);
      if (published > 0)
        span(t.trace_id, t.span_id, t.key, t_summed - published, published,
             kSpanPublish, 0, sid);
    }
    send_msg(t.conn, kPush, t.seq, t.key, t.version, nullptr, 0);
    if (t.trace_id)
      span(t.trace_id, t.span_id, t.key, t_summed, wall_now() - t_summed,
           kSpanReply, 0, sid);
    for (auto& [pconn, pseq, data, ver] : flush)
      send_msg(pconn, kPull, pseq, t.key, ver, data.data(), data.size());
    for (auto& fr : fused_done) send_fused_reply(fr);
    return true;
  }

  // ALL_RECV: publish the round and collect serviceable buffered pulls
  // (server.cc:348-375) plus fused pull-halves whose fill COMPLETED
  // their frame (appended to *fused_done for the caller to send after
  // unlocking).  Caller holds ks.mu.
  void publish_round_locked(
      KeyState& ks,
      std::vector<std::tuple<ConnPtr, uint32_t, std::vector<uint8_t>, uint32_t>>*
          flush,
      std::vector<FusedReplyPtr>* fused_done) {
    ks.store.swap(ks.accum);
    ks.store_version++;
    ks.recv_count = 0;
    if (ks.codec)
      ks.pull_payload =
          ks.codec->compress((const float*)ks.store.data(), ef_lr_.load());
    std::vector<PendingPull> still;
    for (auto& p : ks.pending) {
      if (p.version <= ks.store_version) {
        std::vector<uint8_t> data;
        if (!p.rs_req.empty()) {
          if (!rs_gather_locked(ks, p.rs_req, &data)) {
            // malformed gather request: drop THAT connection so the
            // worker's on_error fires instead of hanging in synchronize()
            p.conn->wake();
            continue;
          }
        } else {
          data = wire_payload_locked(ks, p.wants_compressed);
        }
        flush->emplace_back(p.conn, p.seq, std::move(data), ks.store_version);
      } else {
        still.push_back(std::move(p));
      }
    }
    ks.pending.swap(still);
    // fused pull-halves parked on this key: fill their reply slots; a
    // fill that COMPLETES its frame queues the whole reply for send
    std::vector<FusedWaiter> still_fused;
    for (auto& w : ks.fused_waiters) {
      if (w.version <= ks.store_version) {
        if (w.reply->fill(w.slot, wire_payload_locked(ks, w.compressed),
                          ks.store_version))
          fused_done->push_back(w.reply);
      } else {
        still_fused.push_back(std::move(w));
      }
    }
    ks.fused_waiters.swap(still_fused);
  }

  // ship one completed fused frame as a single multi-key reply; the
  // per-connection write mutex inside send_msg serializes against
  // concurrent engine threads on the same stream
  void send_fused_reply(const FusedReplyPtr& r) {
    std::vector<uint8_t> body =
        encode_fused_reply_bytes(r->keys, r->versions, r->slots);
    send_msg(r->conn, kFused, r->seq, r->route_key, 0, body.data(),
             body.size());
  }

  // Op.FUSED scatter (docs/perf.md), run on the I/O thread: unpack one
  // multi-key fused frame and fan its members out to their owning
  // stripes as kTaskFusedMember tasks, each a zero-copy VIEW into the
  // refcounted frame buffer.  The FusedReply countdown gathers the
  // single multi-key reply: whichever reducer fills the LAST slot sends
  // it (server.py _handle_fused parity — one seq/deadline/retry state
  // resolves atomically for every member).  Frame-level retry safety
  // falls out per key: members summed before a mid-frame error are
  // ledger-recorded, so a retransmitted frame re-sums nothing whose
  // original landed.
  bool scatter_fused(const ConnPtr& conn, uint32_t seq, uint64_t route_key,
                     uint8_t flags, std::vector<uint8_t>& payload,
                     uint64_t trace_id, uint64_t span_id) {
    if (fenced(flags)) return false;  // evicted worker → drop conn
    double t_enq = trace_id ? wall_now() : 0.0;
    auto frame = std::make_shared<std::vector<uint8_t>>(std::move(payload));
    std::vector<FusedMember> members;
    // member-span trailer (tracing): each member's sum/publish children
    // parent onto ITS worker-side span; the pack's own span (outer
    // header context) bounds recv — server.py _handle_fused parity
    std::vector<uint64_t> member_spans;
    if (!parse_fused_push(frame->data(), frame->size(), &members,
                          trace_id ? &member_spans : nullptr))
      return false;  // malformed/empty fused frame → drop conn
    for (auto& m : members) {
      int32_t rtype, dtype;
      decode_cantor(m.cmd, &rtype, &dtype);
      if (rtype == 1) return false;  // row-sparse members cannot fuse
    }
    ctr_[kCtrFusedFrames].fetch_add(1, std::memory_order_relaxed);
    ctr_[kCtrFusedKeys].fetch_add(members.size(), std::memory_order_relaxed);
    auto reply = std::make_shared<FusedReply>();
    reply->conn = conn;
    reply->seq = seq;
    reply->route_key = route_key;
    reply->keys.reserve(members.size());
    for (auto& m : members) reply->keys.push_back(m.key);
    reply->versions.assign(members.size(), 0);
    reply->slots.resize(members.size());
    reply->filled.assign(members.size(), 0);
    reply->remaining = members.size();
    for (size_t slot = 0; slot < members.size(); ++slot) {
      auto& m = members[slot];
      Stripe& st = stripe_of(m.key);
      uint64_t prio = 0;
      if (schedule_) {
        std::lock_guard<std::mutex> g(st.mu);
        prio = ++st.pushed_total[m.key];
      }
      EngineTask t;
      t.op = kTaskFusedMember;
      t.flags = flags;
      t.conn = conn;
      t.seq = seq;
      t.key = m.key;
      t.cmd = m.cmd;
      t.version = m.version;
      if (trace_id) {
        t.trace_id = trace_id;
        t.span_id = span_id;
        t.member_span = member_spans.size() == members.size()
                            ? member_spans[slot]
                            : 0;
        t.t_enq = wall_now();
      }
      t.frame = frame;
      t.off = (uint64_t)(m.payload - frame->data());
      t.len = m.len;
      t.freply = reply;
      t.slot = (uint32_t)slot;
      if (inline_exec_) {
        // stripes=1: each member sums on this serve thread in scatter
        // order; the gather countdown still sends the one reply
        if (!run_task(st, 0, t)) return false;
        continue;
      }
      stripe_put(st, std::move(t), prio);
    }
    // the pack's recv span bounds decode + scatter on the I/O thread
    // (stripe -1: not a reducer lane); member queue dwell shows up as
    // the gap before each member's sum span on its stripe lane
    if (trace_id)
      span(trace_id, span_id, route_key, t_enq, wall_now() - t_enq,
           kSpanRecv, kSpanFlagFused);
    return true;
  }

  // one fused member on its key's reducer thread: the same sum core as
  // a plain push, then fill-or-park the member's pull half
  bool handle_fused_member(Stripe& st, int sid, EngineTask& t) {
    if (fenced(t.flags)) return false;  // fence may have closed mid-frame
    int32_t rtype, dtype;
    decode_cantor(t.cmd, &rtype, &dtype);
    const uint8_t* pay = t.frame->data() + t.off;
    std::vector<std::tuple<ConnPtr, uint32_t, std::vector<uint8_t>,
                           uint32_t>> flush;
    std::vector<FusedReplyPtr> fused_done;
    double t_m0 = wall_now();
    double published = 0.0;
    bool dedupe = false;
    bool completed = false;
    uint32_t ro_epoch = 0;
    int32_t ro_owner = -1;
    KeyState* ksp = nullptr;
    {
      std::lock_guard<std::mutex> g(st.mu);
      if (!redirect_locked(st, t.key, &ro_epoch, &ro_owner)) {
        KeyState& ks = key_state_locked(st, t.key);
        ksp = &ks;
        if (ks.store.empty()) return false;  // member before init → drop
        bool compressed = (rtype == 2) && ks.codec != nullptr;
        dedupe = is_replayed_push_locked(ks, t.flags, t.version);
        if (!dedupe &&
            !sum_push_locked(ks, t.flags, t.version, pay, t.len, compressed,
                             &flush, &fused_done, &published))
          return false;
        // this member's pull half: answered now if its round is
        // published (async mode always is), else parked on the key
        if (async_ || t.version <= ks.store_version) {
          if (t.freply->fill(t.slot, wire_payload_locked(ks, compressed),
                             ks.store_version))
            completed = true;
        } else {
          ks.fused_waiters.push_back({t.version, t.freply, t.slot,
                                      compressed});
        }
      }
    }
    if (ksp == nullptr) {
      // ownership redirect: abandon the FRAME — members already summed
      // by earlier stripes are in the exactly-once ledger, so the
      // worker's unfuse-fallback replay re-sums nothing.  abort_once()
      // fences the reply so fused_waiters parked by earlier members can
      // never answer the resolved seq (server.py _handle_fused parity).
      if (t.freply->abort_once())
        send_wrong_owner(t.freply->conn, t.freply->seq, t.freply->route_key,
                         ro_epoch, ro_owner);
      return true;
    }
    ksp->size_hist.observe((double)t.len);
    double t_m1 = wall_now();
    double sum_dur = t_m1 - t_m0 - published;
    if (sum_dur < 0) sum_dur = 0;
    ksp->sum_hist.observe(sum_dur);
    st.sum_hist.observe(sum_dur);
    if (published > 0) publish_hist_.observe(published);
    if (t.trace_id) {
      uint64_t parent = t.member_span ? t.member_span : t.span_id;
      span(t.trace_id, parent, t.key, t_m0, sum_dur, kSpanSum,
           kSpanFlagFused | (dedupe ? kSpanFlagDedupe : 0), sid);
      if (published > 0)
        span(t.trace_id, parent, t.key, t_m1 - published, published,
             kSpanPublish, kSpanFlagFused, sid);
    }
    for (auto& [pconn, pseq, data, ver] : flush)
      send_msg(pconn, kPull, pseq, t.key, ver, data.data(), data.size());
    for (auto& fr : fused_done) send_fused_reply(fr);
    if (completed) send_fused_reply(t.freply);
    return true;
  }

  // Op.RESYNC_QUERY (docs/robustness.md "healing flow"): report the
  // authoritative per-key round/ledger state so a worker that exhausted
  // its retries can replay exactly the journaled pushes this server
  // never absorbed.  Pure read, answered inline on the serve thread
  // (the asking worker is stalled on it); the replayed pushes go
  // through the normal PUSH path — ledger dedupe, fence, publish all
  // apply unchanged.
  bool handle_resync(const ConnPtr& conn, uint32_t seq, uint64_t route_key,
                     const std::vector<uint8_t>& payload, uint64_t trace_id,
                     uint64_t span_id) {
    uint32_t wid = 0;
    std::vector<uint64_t> keys;
    if (!parse_resync_query(payload.data(), payload.size(), &wid, &keys))
      return false;  // malformed recovery frame → drop conn (Python parity)
    double t0 = trace_id ? wall_now() : 0.0;
    ctr_[kCtrResyncQuery].fetch_add(1, std::memory_order_relaxed);
    if (keys.empty()) {
      // "every key we hold" spans the stripes: gather per shard, then
      // sort — ascending key order keeps the JSON body byte-identical
      // to the pre-striping engine (and to server.py's sorted dict)
      for (auto& stp : stripes_) {
        std::lock_guard<std::mutex> g(stp->mu);
        for (auto& [k, ks] : stp->keys) keys.push_back(k);
      }
      std::sort(keys.begin(), keys.end());
    }
    std::vector<std::tuple<uint64_t, uint32_t, uint32_t, int>> states;
    for (uint64_t k : keys) {
      Stripe& st = stripe_of(k);
      std::lock_guard<std::mutex> g(st.mu);
      auto it = st.keys.find(k);
      if (it == st.keys.end()) continue;
      KeyState* ks = it->second.get();
      if (ks->store.empty()) continue;
      uint32_t seen = 0;
      if (wid) {
        auto sit = ks->push_seen.find((uint8_t)wid);
        if (sit != ks->push_seen.end()) seen = sit->second;
      }
      states.emplace_back(k, ks->store_version, seen, ks->recv_count);
    }
    std::string body = encode_resync_state_bytes(states);
    send_msg(conn, kResyncState, seq, route_key, 0,
             (const uint8_t*)body.data(), body.size());
    // the heal's server-side half joins the worker's RESYNC span on the
    // merged Perfetto timeline (server.py _handle_resync parity)
    if (trace_id)
      span(trace_id, span_id, route_key, t0, wall_now() - t0, kSpanResync);
    return true;
  }

  // scatter-sum one worker's (indices, values) rows into the round
  // accumulator (sparse COPY_FIRST zeroes untouched rows); caller holds
  // ks.mu.  f32 only — the worker engine enforces the dtype.
  bool handle_push_rowsparse_locked(
      KeyState& ks, uint8_t wid, uint32_t version,
      const std::vector<uint8_t>& payload,
      std::vector<std::tuple<ConnPtr, uint32_t, std::vector<uint8_t>, uint32_t>>*
          flush,
      std::vector<FusedReplyPtr>* fused_done, double* publish_dur = nullptr) {
    uint32_t nrows, row_len;
    if (!rs_parse_header(payload, &nrows, &row_len)) return false;
    if (dtype_size(ks.dtype) != 4) return false;
    const uint64_t total = ks.store.size() / 4;
    if (total % row_len) return false;
    const uint64_t total_rows = total / row_len;
    if (payload.size() < 8ull + 4ull * nrows + 4ull * nrows * row_len)
      return false;
    const uint8_t* idxp = payload.data() + 8;
    const float* vals = (const float*)(payload.data() + 8 + 4ull * nrows);
    float* dst;
    if (async_) {
      dst = (float*)ks.store.data();  // parameter store: scatter in place
    } else {
      if (ks.recv_count == 0)
        std::memset(ks.accum.data(), 0, ks.accum.size());
      dst = (float*)ks.accum.data();
    }
    for (uint32_t r = 0; r < nrows; ++r) {
      uint32_t be;
      std::memcpy(&be, idxp + 4ull * r, 4);
      const uint64_t row = ntohl(be);
      if (row >= total_rows) return false;
      float* out = dst + row * (uint64_t)row_len;
      const float* src = vals + (uint64_t)r * row_len;
      for (uint32_t c = 0; c < row_len; ++c) out[c] += src[c];
    }
    if (async_) {
      ks.store_version++;
      if (wid && version > 0) ks.push_seen[wid] = version;
      return true;
    }
    ks.recv_count++;
    if (wid && version > 0) ks.push_seen[wid] = version;
    if (ks.recv_count >= num_workers_.load()) {
      double p0 = wall_now();
      publish_round_locked(ks, flush, fused_done);
      if (publish_dur) *publish_dur = wall_now() - p0;
    }
    return true;
  }

  // gather the rows a row-sparse pull requests; caller holds ks.mu
  bool rs_gather_locked(KeyState& ks, const std::vector<uint8_t>& req,
                        std::vector<uint8_t>* out) {
    uint32_t nrows, row_len;
    if (!rs_parse_header(req, &nrows, &row_len)) return false;
    if (dtype_size(ks.dtype) != 4) return false;
    const uint64_t total = ks.store.size() / 4;
    if (total % row_len) return false;
    const uint64_t total_rows = total / row_len;
    if (req.size() < 8ull + 4ull * nrows) return false;
    out->resize(4ull * nrows * row_len);
    const float* store = (const float*)ks.store.data();
    float* o = (float*)out->data();
    const uint8_t* idxp = req.data() + 8;
    for (uint32_t r = 0; r < nrows; ++r) {
      uint32_t be;
      std::memcpy(&be, idxp + 4ull * r, 4);
      const uint64_t row = ntohl(be);
      if (row >= total_rows) return false;
      std::memcpy(o + (uint64_t)r * row_len, store + row * (uint64_t)row_len,
                  4ull * row_len);
    }
    return true;
  }

  std::vector<uint8_t> wire_payload_locked(KeyState& ks, bool wants_compressed) {
    if (wants_compressed && ks.codec) {
      if (async_ || ks.pull_payload.empty())
        return ks.codec->compress((const float*)ks.store.data(), ef_lr_.load());
      return ks.pull_payload;
    }
    return ks.store;
  }

  bool handle_pull(Stripe& st, int sid, EngineTask& t) {
    int32_t rtype, dtype;
    decode_cantor(t.cmd, &rtype, &dtype);
    double t_start = t.trace_id ? wall_now() : 0.0;
    if (t.trace_id && t.t_enq > 0)
      span(t.trace_id, t.span_id, t.key, t.t_enq, t_start - t.t_enq,
           kSpanRecv, 0, sid);
    std::vector<uint8_t> data;
    uint32_t ver = 0;
    uint32_t ro_epoch = 0;
    int32_t ro_owner = -1;
    bool redirect = false;
    {
      std::lock_guard<std::mutex> g(st.mu);
      redirect = redirect_locked(st, t.key, &ro_epoch, &ro_owner);
      if (!redirect) {
        KeyState& ks = key_state_locked(st, t.key);
        if (ks.store.empty()) return false;  // pull before init → drop conn
        bool ready = async_ || t.version <= ks.store_version;
        if (!ready) {
          // parked: the round publish answers it; the worker-side PULL
          // span keeps the wait attributable — no park span (server.py
          // parity)
          ks.pending.push_back({t.version, t.conn, t.seq, rtype == 2,
                                rtype == 1 ? t.payload
                                           : std::vector<uint8_t>{}});
          return true;
        }
        if (rtype == 1) {
          if (!rs_gather_locked(ks, t.payload, &data)) return false;
        } else {
          data = wire_payload_locked(ks, rtype == 2);
        }
        ver = ks.store_version;
      }
    }
    if (redirect) {
      send_wrong_owner(t.conn, t.seq, t.key, ro_epoch, ro_owner);
      return true;
    }
    double t_ready = t.trace_id ? wall_now() : 0.0;
    send_msg(t.conn, kPull, t.seq, t.key, ver, data.data(), data.size());
    if (t.trace_id)
      span(t.trace_id, t.span_id, t.key, t_ready, wall_now() - t_ready,
           kSpanReply, 0, sid);
    return true;
  }

  int listen_fd_ = -1;
  bool shm_van_ = false;     // unix listener hands out ShmConn not FdConn
  std::string uds_path_;     // non-empty = unix listener (unlink on stop)
  std::atomic<int> num_workers_{1};
  bool async_ = false;
  std::atomic<bool> stop_{false};
  std::thread accept_thread_;
  std::mutex conn_mu_;
  std::vector<ConnPtr> conns_;
  std::vector<std::thread> threads_;
  // key-striped reducer plane: all key state lives in the stripes
  bool schedule_ = false;
  // stripes=1 fast path: handlers run inline on the serve threads (no
  // reducer threads, no ring hop) — set once in start_engine
  bool inline_exec_ = false;
  // end-to-end wire integrity (docs/robustness.md "Wire integrity"):
  // BYTEPS_WIRE_CHECKSUM / BYTEPS_CHECKSUM_CONN_LIMIT, read once in
  // start_engine
  bool checksum_on_ = false;
  uint32_t ck_conn_limit_ = 8;
  // lossless control-plane frame compression (BYTEPS_WIRE_LOSSLESS,
  // read once in start_engine; decode is never gated on it)
  bool lossless_on_ = false;
  std::vector<std::unique_ptr<Stripe>> stripes_;
  // EF residual lr (workers broadcast optimizer lr; default 1.0)
  std::atomic<float> ef_lr_{1.0f};
  // zombie fence: live worker flags from the scheduler's latest book
  // (fence_on_ false = no book with ranks seen → fence off)
  std::mutex live_mu_;
  bool fence_on_ = false;
  std::set<uint8_t> live_;
  // elastic resharding ownership (docs/robustness.md "migration flow"):
  // the consistent-hash ring's sorted (point, rank) arrays, shipped by
  // the Python wrapper from each scheduler book
  // (bps_native_server_set_ownership).  The data path pays ONE relaxed
  // atomic load while no map is set; with a map, a request for a key
  // this engine neither owns (per the map) nor holds (no store) gets a
  // kWrongOwner reply carrying the map epoch, so stale-map workers
  // re-route instead of splitting the key's sums across two servers.
  // State migration itself stays Python-engine-only: kMigrateState
  // falls through to the clean status=1 unknown-op echo.
  struct OwnMap {
    std::vector<uint64_t> hashes;  // sorted ring point hashes
    std::vector<int32_t> ranks;    // parallel owner ranks
    uint32_t epoch = 0;
    int32_t rank = -1;             // this engine's server rank
  };
  std::atomic<bool> own_set_{false};
  // immutable snapshot, swapped whole on book adoption; readers use
  // atomic_load so the per-request check stays lock-free across stripes
  std::shared_ptr<const OwnMap> own_;
  // observability counters (NativeCounter order; read via
  // bps_native_server_counters so GIL-free runs aren't metrics-blind)
  std::atomic<uint64_t> ctr_[kCtrCount] = {};
  // span plane: default from the env (a directly-started engine traces
  // iff the process would), overridden by bps_native_server_set_trace
  // (NativePSServer pushes cfg.trace_on && cfg.trace_spans)
  std::atomic<bool> trace_on_{[] {
    const char* on = getenv("BYTEPS_TRACE_ON");
    const char* sp = getenv("BYTEPS_TRACE_SPANS");
    return on && atoi(on) != 0 && !(sp && atoi(sp) == 0);
  }()};
  SpanRing span_ring_;
  bps_hist::Hist publish_hist_;

  // one child-span record into the ring; a full ring drops + counts —
  // the observer must never stall the data plane.  `stripe` is the
  // executing reducer's lane (-1 = serve/control thread); the drain
  // maps it to a per-stripe Perfetto track so the merged timeline
  // shows reducer occupancy.
  void span(uint64_t trace_id, uint64_t parent, uint64_t key, double ts,
            double dur, int32_t kind, uint32_t fl = 0, int32_t stripe = -1) {
    if (!trace_id) return;
    SpanRec r{trace_id, parent, key, ts, dur < 0 ? 0 : dur, kind, fl,
              stripe, 0};
    if (!span_ring_.push(r))
      ctr_[kCtrSpanDrop].fetch_add(1, std::memory_order_relaxed);
  }
};

// several server instances may coexist in one process (multi-server
// tests, the scaling harness); the bound port is the instance id.  Unix
// (uds/shm) instances have no port — they get synthetic ids above the
// TCP port range so the two spaces can never collide.
std::map<int32_t, NativeServer*> g_servers;
std::mutex g_server_mu;
int32_t g_next_unix_id = 1 << 17;  // 131072 > max port 65535

}  // namespace

extern "C" {

// start a native data-plane instance; returns the bound port (id), or -1
int32_t bps_native_server_start(int32_t port, int32_t num_workers,
                                int32_t enable_async) {
  auto* srv = new NativeServer();
  int p = srv->start(port, num_workers, enable_async != 0);
  if (p < 0) {
    delete srv;
    return -1;
  }
  std::lock_guard<std::mutex> g(g_server_mu);
  g_servers[p] = srv;
  return p;
}

// start a native data-plane instance listening on a unix socket path:
// shm=0 → framed protocol over the UDS stream (uds van); shm=1 → UDS
// handshake + mmap'd shared-memory rings (shm van, zero-copy bulk path).
// Returns a synthetic instance id (>= 1<<17), or -1.
int32_t bps_native_server_start_unix(const char* path, int32_t num_workers,
                                     int32_t enable_async, int32_t shm) {
  auto* srv = new NativeServer();
  if (!srv->start_unix(path, num_workers, enable_async != 0, shm != 0)) {
    delete srv;
    return -1;
  }
  std::lock_guard<std::mutex> g(g_server_mu);
  int32_t id = g_next_unix_id++;
  g_servers[id] = srv;
  return id;
}

// update an instance's expected worker count (scheduler address book wins
// over the launch-time env, matching the Python server); port<0 = all
void bps_native_server_set_num_workers(int32_t port, int32_t n) {
  std::lock_guard<std::mutex> g(g_server_mu);
  if (port < 0) {
    for (auto& [p, srv] : g_servers) srv->set_num_workers(n);
    return;
  }
  auto it = g_servers.find(port);
  if (it != g_servers.end()) it->second->set_num_workers(n);
}

// Copy one instance's observability counters into out (NativeCounter
// index order — native/__init__.py maps them to the native_* names).
// Returns the number of slots filled, or -1 for an unknown instance.
int32_t bps_native_server_counters(int32_t port, uint64_t* out, int32_t cap) {
  std::lock_guard<std::mutex> g(g_server_mu);
  auto it = g_servers.find(port);
  if (it == g_servers.end()) return -1;
  return it->second->read_counters(out, cap);
}

// Refresh an instance's zombie fence from the scheduler book's live
// worker-flag list; n < 0 disables the fence (book without ranks).
void bps_native_server_set_live_workers(int32_t port, const uint8_t* flags,
                                        int32_t n) {
  std::lock_guard<std::mutex> g(g_server_mu);
  auto it = g_servers.find(port);
  if (it != g_servers.end()) it->second->set_live_workers(flags, n);
}

// Adopt an ownership map for the elastic resharding plane (docs/
// robustness.md "migration flow"): sorted consistent-hash ring points
// (hashes) with their owning server ranks, this instance's own rank,
// and the map epoch stamped into kWrongOwner redirects.  n <= 0
// disables the check.
void bps_native_server_set_ownership(int32_t port, int32_t my_rank,
                                     uint32_t epoch, int32_t n,
                                     const uint64_t* hashes,
                                     const int32_t* ranks) {
  std::lock_guard<std::mutex> g(g_server_mu);
  auto it = g_servers.find(port);
  if (it != g_servers.end())
    it->second->set_ownership(my_rank, epoch, n, hashes, ranks);
}

// Toggle an instance's span plane (NativePSServer pushes cfg.trace_on
// && cfg.trace_spans; the engine's own default comes from the env).
void bps_native_server_set_trace(int32_t port, int32_t on) {
  std::lock_guard<std::mutex> g(g_server_mu);
  auto it = g_servers.find(port);
  if (it != g_servers.end()) it->second->set_trace(on != 0);
}

// Drain up to cap child-span records (SpanRec layout, mirrored by
// SPAN_REC_DTYPE in native/__init__.py) from an instance's trace ring.
// The Python wrapper replays them into the process tracer, which writes
// the same server<rank>/comm.json file tools/trace_merge.py stitches.
// Returns the record count, 0 when empty, -1 for an unknown instance.
int32_t bps_native_server_drain_spans(int32_t port, void* out, int32_t cap) {
  // held across the drain (like the counters getter): stop() erases the
  // instance under this lock before deleting it, so the pointer cannot
  // dangle mid-pop
  std::lock_guard<std::mutex> g(g_server_mu);
  auto it = g_servers.find(port);
  if (it == g_servers.end()) return -1;
  return it->second->drain_spans((SpanRec*)out, cap);
}

// One instance's histograms + counters as a JSON document (see
// NativeServer::metrics_json) — the feed behind the histogram-provider
// seam in core/telemetry.py.  Returns bytes written, -(needed) when cap
// is too small, or -1 for an unknown instance.
int64_t bps_native_server_metrics_json(int32_t port, uint8_t* out,
                                       uint64_t cap) {
  std::lock_guard<std::mutex> g(g_server_mu);
  auto it = g_servers.find(port);
  if (it == g_servers.end()) return -1;
  std::string body = it->second->metrics_json();
  if (body.size() > cap) return -(int64_t)body.size();
  std::memcpy(out, body.data(), body.size());
  return (int64_t)body.size();
}

// Current task backlog per reducer stripe (approximate, lock-free
// reads) — the native_stripe_queue_depth{stripe} gauge feed.  Returns
// the stripe count filled (= the instance's stripe count when cap
// allows), or -1 for an unknown instance.
int32_t bps_native_server_stripe_queue_depths(int32_t port, uint64_t* out,
                                              int32_t cap) {
  std::lock_guard<std::mutex> g(g_server_mu);
  auto it = g_servers.find(port);
  if (it == g_servers.end()) return -1;
  return it->second->read_stripe_depths(out, cap);
}

// key → reducer stripe through the LIVE mapping (wire.h key_stripe) —
// lets tests pick keys that do (or don't) share a stripe, and pins the
// hash so a silent remapping can't invalidate committed benchmarks.
// Golden shim: the LIVE ring-coordinate hash the engine's ownership
// redirect uses — tests pin it bit-identical to Python
// hashing.ring_key_hash (elastic resharding plane).
uint64_t bps_wire_ring_hash(uint64_t key) {
  return bps_wire::ring_key_hash(key);
}

int32_t bps_wire_key_stripe(uint64_t key, int32_t n_stripes) {
  if (n_stripes <= 0) return -1;
  return (int32_t)bps_wire::key_stripe(key, (uint32_t)n_stripes);
}

// ---------------------------------------------------------------------------
// golden wire-frame shims (tests/test_wire_golden.py): the C++ side of
// the byte-exact cross-language fixtures.  These go through the SAME
// pack_header / encode_fused_reply_bytes / encode_resync_state_bytes /
// parse_* code paths the live engine uses, so transport.py and the C++
// codec cannot drift silently.
// ---------------------------------------------------------------------------

// Emit the fixed fixture frames (layout documented in the test, which
// builds the identical bytes via transport.py).  Returns bytes written,
// or -(needed) when cap is too small.
int64_t bps_wire_golden(uint8_t* out, uint64_t cap) {
  std::vector<uint8_t> buf;
  auto put_header = [&](uint8_t op, uint8_t status, uint8_t flags,
                        uint32_t seq, uint64_t key, uint32_t cmd,
                        uint32_t version, uint64_t len) {
    Header h;
    pack_header(&h, op, status, flags, seq, key, cmd, version, len);
    const uint8_t* p = (const uint8_t*)&h;
    buf.insert(buf.end(), p, p + sizeof(h));
  };
  auto put_bytes = [&](const void* p, size_t n) {
    buf.insert(buf.end(), (const uint8_t*)p, (const uint8_t*)p + n);
  };
  // A: plain PUSH (no trace): payload bytes 0..7
  uint8_t payload_a[8] = {0, 1, 2, 3, 4, 5, 6, 7};
  put_header(kPush, 0, 1, 7, 42, 6, 3, sizeof(payload_a));
  put_bytes(payload_a, sizeof(payload_a));
  // B: the same PUSH with the 16-byte trace-context block
  put_header(kPush, kTraceFlag, 1, 7, 42, 6, 3, sizeof(payload_a));
  uint8_t trace[16];
  bps_wire::pack_trace(trace, 0x1122334455667788ull, 0x99AABBCCDDEEFF00ull);
  put_bytes(trace, sizeof(trace));
  put_bytes(payload_a, sizeof(payload_a));
  // C: PULL request (empty payload)
  put_header(kPull, 0, 0, 8, 42, 6, 3, 0);
  // D: INIT carrying an idempotency token in version (payload !QI)
  uint8_t init_payload[12];
  uint64_t n_be = htobe64(32);
  uint32_t dt_be = htonl(0);
  std::memcpy(init_payload, &n_be, 8);
  std::memcpy(init_payload + 8, &dt_be, 4);
  put_header(kInit, 0, 2, 9, 43, 0, 0xA0001, sizeof(init_payload));
  put_bytes(init_payload, sizeof(init_payload));
  // E: FUSED reply frame through the live reply encoder
  std::vector<uint64_t> keys = {101, 202};
  std::vector<uint32_t> versions = {1, 2};
  std::vector<std::vector<uint8_t>> slots = {{'w', 'x', 'y', 'z'}, {}};
  std::vector<uint8_t> fused = encode_fused_reply_bytes(keys, versions, slots);
  put_header(kFused, 0, 0, 10, 101, 0, 0, fused.size());
  put_bytes(fused.data(), fused.size());
  // F: RESYNC_STATE frame through the live state encoder
  std::string state = encode_resync_state_bytes(
      {{5, 4, 3, 1}, {9, 0, 0, 0}});
  put_header(kResyncState, 0, 0, 11, 5, 0, 0, state.size());
  put_bytes(state.data(), state.size());
  if (buf.size() > cap) return -(int64_t)buf.size();
  std::memcpy(out, buf.data(), buf.size());
  return (int64_t)buf.size();
}

// Compressed-wire-path fixtures (docs/gradient-compression.md
// "Compressed wire path"): a fused PUSH frame whose members carry the
// per-member compressed flag — RequestType kCompressedPushPull Cantor-
// encoded in the member cmd — alongside a raw sibling, WITH the
// member-span trailer (old decoders ignore it, pinned separately), and
// the codec-compressed fused REPLY through the LIVE reply encoder.
// A separate fixture stream from bps_wire_golden so the original frozen
// digest stays untouched (these frames EXTEND the fixture set; the
// existing frames' bytes are unchanged).  Returns bytes written, or
// -(needed) when cap is too small.
int64_t bps_wire_golden_compressed(uint8_t* out, uint64_t cap) {
  std::vector<uint8_t> buf;
  auto put_header = [&](uint8_t op, uint8_t status, uint8_t flags,
                        uint32_t seq, uint64_t key, uint32_t cmd,
                        uint32_t version, uint64_t len) {
    Header h;
    pack_header(&h, op, status, flags, seq, key, cmd, version, len);
    const uint8_t* p = (const uint8_t*)&h;
    buf.insert(buf.end(), p, p + sizeof(h));
  };
  auto put_bytes = [&](const void* p, size_t n) {
    buf.insert(buf.end(), (const uint8_t*)p, (const uint8_t*)p + n);
  };
  // member cmds: Cantor (rtype, dtype=f32) — compressed rtype 2 → 3,
  // default rtype 0 → 0 (common.cc:98 pairing; the "compressed flag"
  // IS the member cmd, no new wire bit)
  const uint32_t kCmdCompressedF32 = 3, kCmdDefaultF32 = 0;
  // onebit-shaped compressed payload: f32 scale + two u32 sign words
  // (little-endian, compressor.cc wire format), fixed bytes both sides
  const uint8_t onebit_payload[12] = {0x00, 0x00, 0x00, 0x3F,   // 0.5f LE
                                      0xEF, 0xBE, 0xAD, 0xDE,
                                      0x67, 0x45, 0x23, 0x01};
  const uint8_t raw_payload[8] = {1, 2, 3, 4, 5, 6, 7, 8};
  // G: fused PUSH body — count 2, compressed member + raw member, then
  // the 2×u64 member-span trailer (transport.encode_fused_push layout)
  std::vector<uint8_t> body;
  auto put_member = [&](uint64_t key, uint32_t cmd, uint32_t ver,
                        const uint8_t* p, uint64_t n) {
    uint64_t key_be = htobe64(key), len_be = htobe64(n);
    uint32_t cmd_be = htonl(cmd), ver_be = htonl(ver);
    uint8_t m[24];
    std::memcpy(m, &key_be, 8);
    std::memcpy(m + 8, &cmd_be, 4);
    std::memcpy(m + 12, &ver_be, 4);
    std::memcpy(m + 16, &len_be, 8);
    body.insert(body.end(), m, m + 24);
    body.insert(body.end(), p, p + n);
  };
  uint32_t count_be = htonl(2);
  body.insert(body.end(), (uint8_t*)&count_be, (uint8_t*)&count_be + 4);
  put_member(301, kCmdCompressedF32, 5, onebit_payload,
             sizeof(onebit_payload));
  put_member(302, kCmdDefaultF32, 5, raw_payload, sizeof(raw_payload));
  for (uint64_t sid : {0xC0FFEE0000000001ull, 0xC0FFEE0000000002ull}) {
    uint64_t be = htobe64(sid);
    body.insert(body.end(), (uint8_t*)&be, (uint8_t*)&be + 8);
  }
  put_header(kFused, kTraceFlag, 1, 31, 301, 2, 0, body.size());
  uint8_t trace[16];
  bps_wire::pack_trace(trace, 0x5555555555555555ull, 0x6666666666666666ull);
  put_bytes(trace, sizeof(trace));
  put_bytes(body.data(), body.size());
  // H: the fused REPLY with a codec-compressed slot beside a raw one,
  // through the LIVE reply encoder the engine sends with
  std::vector<uint64_t> keys = {301, 302};
  std::vector<uint32_t> versions = {5, 5};
  std::vector<std::vector<uint8_t>> slots = {
      std::vector<uint8_t>(onebit_payload,
                           onebit_payload + sizeof(onebit_payload)),
      std::vector<uint8_t>(raw_payload, raw_payload + sizeof(raw_payload))};
  std::vector<uint8_t> reply = encode_fused_reply_bytes(keys, versions, slots);
  put_header(kFused, 0, 0, 31, 301, 0, 0, reply.size());
  put_bytes(reply.data(), reply.size());
  // I: the codec-config registration that arms the server-side chain
  // (newline key=value text, REGISTER_COMPRESSOR)
  const char reg[] =
      "byteps_compressor_type=onebit\nbyteps_ef_type=vanilla";
  put_header(kRegisterCompressor, 0, 0, 32, 301, 0, 0, sizeof(reg) - 1);
  put_bytes(reg, sizeof(reg) - 1);
  if (buf.size() > cap) return -(int64_t)buf.size();
  std::memcpy(out, buf.data(), buf.size());
  return (int64_t)buf.size();
}

// Checksummed-frame fixture stream (docs/robustness.md "Wire
// integrity"): the SAME wire shapes as the plain golden streams —
// PUSH ± trace block, PULL, a FUSED push with a compressed member +
// span trailer + trace context, the codec-compressed fused REPLY —
// but with CHECKSUM_FLAG stamped through the LIVE shared encoder
// (wire.h build_head, the one path send_msg and bpsc_send2 ride).
// Pinned against transport.py and a frozen CHECKSUM_GOLDEN_SHA256 in
// tests/test_wire_golden.py; a SEPARATE stream, so every pre-checksum
// digest stays byte-identical.  Returns bytes written, or -(needed)
// when cap is too small.
int64_t bps_wire_golden_checksum(uint8_t* out, uint64_t cap) {
  std::vector<uint8_t> buf;
  auto put_frame = [&](uint8_t op, uint8_t flags, uint32_t seq, uint64_t key,
                       uint32_t cmd, uint32_t version, const uint8_t* payload,
                       uint64_t len, uint64_t trace_id, uint64_t span_id) {
    uint8_t head[bps_wire::kMaxHeadLen];
    size_t head_len =
        bps_wire::build_head(head, op, /*base_status=*/0, flags, seq, key,
                             cmd, version, payload, len, trace_id, span_id,
                             /*checksum=*/true);
    buf.insert(buf.end(), head, head + head_len);
    if (len) buf.insert(buf.end(), payload, payload + len);
  };
  // J: checksummed plain PUSH (payload bytes 0..7)
  uint8_t payload_a[8] = {0, 1, 2, 3, 4, 5, 6, 7};
  put_frame(kPush, 1, 7, 42, 6, 3, payload_a, sizeof(payload_a), 0, 0);
  // K: the same PUSH with trace context — CRC covers trace block + payload
  put_frame(kPush, 1, 7, 42, 6, 3, payload_a, sizeof(payload_a),
            0x1122334455667788ull, 0x99AABBCCDDEEFF00ull);
  // L: checksummed PULL (empty payload: CRC of the empty tail)
  put_frame(kPull, 0, 8, 42, 6, 3, nullptr, 0, 0, 0);
  // M: checksummed FUSED push — compressed member beside a raw one,
  // member-span trailer, outer trace context (the compressed-wire
  // fixture body, now integrity-stamped end to end)
  const uint32_t kCmdCompressedF32 = 3, kCmdDefaultF32 = 0;
  const uint8_t onebit_payload[12] = {0x00, 0x00, 0x00, 0x3F,
                                      0xEF, 0xBE, 0xAD, 0xDE,
                                      0x67, 0x45, 0x23, 0x01};
  const uint8_t raw_payload[8] = {1, 2, 3, 4, 5, 6, 7, 8};
  std::vector<uint8_t> body;
  auto put_member = [&](uint64_t mkey, uint32_t mcmd, uint32_t ver,
                        const uint8_t* p, uint64_t n) {
    uint64_t key_be = htobe64(mkey), len_be = htobe64(n);
    uint32_t cmd_be = htonl(mcmd), ver_be = htonl(ver);
    uint8_t m[24];
    std::memcpy(m, &key_be, 8);
    std::memcpy(m + 8, &cmd_be, 4);
    std::memcpy(m + 12, &ver_be, 4);
    std::memcpy(m + 16, &len_be, 8);
    body.insert(body.end(), m, m + 24);
    body.insert(body.end(), p, p + n);
  };
  uint32_t count_be = htonl(2);
  body.insert(body.end(), (uint8_t*)&count_be, (uint8_t*)&count_be + 4);
  put_member(301, kCmdCompressedF32, 5, onebit_payload,
             sizeof(onebit_payload));
  put_member(302, kCmdDefaultF32, 5, raw_payload, sizeof(raw_payload));
  for (uint64_t sid : {0xC0FFEE0000000001ull, 0xC0FFEE0000000002ull}) {
    uint64_t be = htobe64(sid);
    body.insert(body.end(), (uint8_t*)&be, (uint8_t*)&be + 8);
  }
  put_frame(kFused, 1, 31, 301, 2, 0, body.data(), body.size(),
            0x5555555555555555ull, 0x6666666666666666ull);
  // N: the checksummed fused REPLY through the LIVE reply encoder
  std::vector<uint64_t> keys = {301, 302};
  std::vector<uint32_t> versions = {5, 5};
  std::vector<std::vector<uint8_t>> slots = {
      std::vector<uint8_t>(onebit_payload,
                           onebit_payload + sizeof(onebit_payload)),
      std::vector<uint8_t>(raw_payload, raw_payload + sizeof(raw_payload))};
  std::vector<uint8_t> reply = encode_fused_reply_bytes(keys, versions, slots);
  put_frame(kFused, 0, 31, 301, 0, 0, reply.data(), reply.size(), 0, 0);
  if (buf.size() > cap) return -(int64_t)buf.size();
  std::memcpy(out, buf.data(), buf.size());
  return (int64_t)buf.size();
}

// Parse a fused-push body with the live decoder and re-encode it
// canonically (count + members, NO span trailer).  The Python test
// feeds transport.encode_fused_push output — with and without the
// trailer — and asserts the echo equals the trailer-less encoding:
// parse parity including the trailer-ignoring contract.  Returns bytes
// written, -1 on a parse failure, or -(needed) when cap is too small.
int64_t bps_wire_fused_echo(const uint8_t* in, uint64_t len, uint8_t* out,
                            uint64_t cap) {
  std::vector<FusedMember> members;
  if (!parse_fused_push(in, len, &members)) return -1;
  uint64_t total = 4;
  for (auto& m : members) total += 24 + m.len;
  if (total > cap) return -(int64_t)total;
  uint8_t* p = out;
  uint32_t count_be = htonl((uint32_t)members.size());
  std::memcpy(p, &count_be, 4);
  p += 4;
  for (auto& m : members) {
    uint64_t key_be = htobe64(m.key), len_be = htobe64(m.len);
    uint32_t cmd_be = htonl(m.cmd), ver_be = htonl(m.version);
    std::memcpy(p, &key_be, 8);
    std::memcpy(p + 8, &cmd_be, 4);
    std::memcpy(p + 12, &ver_be, 4);
    std::memcpy(p + 16, &len_be, 8);
    p += 24;
    if (m.len) {
      std::memcpy(p, m.payload, m.len);
      p += m.len;
    }
  }
  return (int64_t)(p - out);
}

// Parse a fused-push body with the live decoder and return the
// member-span TRAILER ids (host order) — the C++ side of
// transport.decode_fused_spans, pinning the trailer parser the fused
// tracing path (handle_fused member parenting) actually uses.  Returns
// the id count (0 = no trailer), -1 on a parse failure, or -(needed)
// when cap is too small.
int64_t bps_wire_fused_spans_echo(const uint8_t* in, uint64_t len,
                                  uint64_t* out, int64_t cap) {
  std::vector<FusedMember> members;
  std::vector<uint64_t> spans;
  if (!parse_fused_push(in, len, &members, &spans)) return -1;
  if ((int64_t)spans.size() > cap) return -(int64_t)spans.size();
  for (size_t i = 0; i < spans.size(); ++i) out[i] = spans[i];
  return (int64_t)spans.size();
}

// Parse a resync-query body with the live parser and echo it as
// "<worker>|<key>,<key>,..." text.  Returns bytes written, -1 on a
// parse failure, or -(needed) when cap is too small.
int64_t bps_wire_resync_echo(const uint8_t* in, uint64_t len, uint8_t* out,
                             uint64_t cap) {
  uint32_t wid = 0;
  std::vector<uint64_t> keys;
  if (!parse_resync_query(in, len, &wid, &keys)) return -1;
  std::string s = std::to_string(wid) + "|";
  for (size_t i = 0; i < keys.size(); ++i) {
    if (i) s += ",";
    s += std::to_string(keys[i]);
  }
  if (s.size() > cap) return -(int64_t)s.size();
  std::memcpy(out, s.data(), s.size());
  return (int64_t)s.size();
}

// stop one instance by port, or all when port < 0
void bps_native_server_stop(int32_t port) {
  std::vector<NativeServer*> doomed;
  {
    std::lock_guard<std::mutex> g(g_server_mu);
    if (port < 0) {
      for (auto& [p, srv] : g_servers) doomed.push_back(srv);
      g_servers.clear();
    } else {
      auto it = g_servers.find(port);
      if (it == g_servers.end()) return;
      doomed.push_back(it->second);
      g_servers.erase(it);
    }
  }
  for (auto* srv : doomed) {
    srv->stop();
    delete srv;
  }
}

}  // extern "C"
