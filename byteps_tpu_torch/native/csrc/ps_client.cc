// Native worker-side PS data plane (the C++ half of comm/ps_client.py).
//
// The reference's worker hot path is C++ (core_loops.cc:538-618: ZPush /
// ZPull framing, completion demux, zero-copy into caller SArrays) with
// Python only steering.  This file gives the TPU build the same split:
// lane sockets, 32-byte framing, seq-table demux, and payload receive —
// including pull-into-caller-buffer zero copy — all run on C++ threads
// with no GIL; Python sees one completion callback per message (ctypes
// re-acquires the GIL for the duration of the callback only).
//
// Scope: the worker↔server DATA lanes for the tcp and uds vans,
// including BYTEPS_TCP_STREAMS striping (responses demux into one shared
// seq table, per-key lane pinning preserves per-key FIFO).  The shm van
// keeps its Python client (its bulk path is already syscall-free mmap
// memcpy), and the scheduler link stays Python (low-rate control plane).
//
// Contract with comm/ps_client.py (_NativeServerConn):
//   h   = bpsc_create(host, port, kind, streams)   kind: 0 tcp, 1 uds
//         bpsc_set_cb(h, cb, ctx)                  BEFORE first alloc/send
//   seq = bpsc_alloc_seq(h, sink_ptr, sink_len)    -1 => conn dead
//         bpsc_send(h, op, seq, key, cmd, ver, flags, payload, len)
//         bpsc_close(h)                            joins lanes, frees h
//
// Handles are ids into a global registry holding shared_ptrs: a send
// racing a close (elastic server-swap failure path) resolves its id
// before the close erases it — the object stays alive until the last
// in-flight call returns — or after, in which case the call fails
// cleanly instead of touching freed memory.
//
// Completion delivery is BATCHED (r5): lanes enqueue fixed-size
// completion records (payload bytes owned by the entry; zero-copy
// payloads are already in the caller's sink) and fire the registered
// callback ONCE per empty→non-empty queue transition as a doorbell
// (op=-2, every other argument zero).  Python then drains in bulk:
//
//   n = bpsc_drain(h, recs, max_recs, arena, arena_cap)
//
// fills an array of DrainRec (layout below, mirrored by a numpy dtype
// in native/__init__.py) plus non-zero-copy payload bytes packed into
// the arena at rec.off.  Returns the record count, or -(needed) when
// the FIRST pending payload exceeds arena_cap (caller grows + retries).
// Rationale: a ctypes trampoline costs ~10-30µs per invocation with
// this signature — per-message delivery made the native client ~40%
// slower than the Python client on many-small-message rounds
// (VAN_BENCH r4/r5); one doorbell + one bulk drain per burst amortizes
// it to ~zero.
//
// Dead-connection drain enqueues records with op=-1 (payload NULL) for
// every pending seq — exactly once, on the LAST lane to exit (a
// sibling lane may still be mid-receive into a caller's zero-copy
// sink; see _ServerConn.lane_exited for the Python statement of this
// rule) — followed by a doorbell.  Queue order is preserved, so the
// death markers are always delivered after every real completion.

#include <arpa/inet.h>
#include <endian.h>
#include <errno.h>
#include <fcntl.h>
#include <netdb.h>
#include <netinet/in.h>
#include <netinet/tcp.h>
#include <poll.h>
#include <strings.h>
#include <sys/socket.h>
#include <sys/uio.h>
#include <sys/un.h>
#include <unistd.h>

#include <atomic>
#include <cstdint>
#include <cstring>
#include <deque>
#include <map>
#include <memory>
#include <mutex>
#include <chrono>
#include <string>
#include <thread>
#include <unordered_map>
#include <vector>

#include "hist.h"
#include "wire.h"

namespace {

using bps_wire::Header;
using bps_wire::kMagic;

uint64_t steady_ns() {
  return (uint64_t)std::chrono::duration_cast<std::chrono::nanoseconds>(
             std::chrono::steady_clock::now().time_since_epoch())
      .count();
}


typedef void (*bpsc_cb_t)(void* ctx, int32_t op, int32_t status,
                          uint32_t flags, uint32_t seq, uint64_t key,
                          uint32_t cmd, uint32_t version,
                          const uint8_t* payload, uint64_t len,
                          int32_t zero_copied);

int connect_with_timeout(int fd, const sockaddr* sa, socklen_t slen,
                         int timeout_ms) {
  int fl = fcntl(fd, F_GETFL, 0);
  fcntl(fd, F_SETFL, fl | O_NONBLOCK);
  int r = ::connect(fd, sa, slen);
  if (r < 0 && errno != EINPROGRESS) return -1;
  if (r < 0) {
    pollfd p{fd, POLLOUT, 0};
    if (::poll(&p, 1, timeout_ms) <= 0) return -1;
    int err = 0;
    socklen_t el = sizeof(err);
    if (getsockopt(fd, SOL_SOCKET, SO_ERROR, &err, &el) < 0 || err != 0)
      return -1;
  }
  fcntl(fd, F_SETFL, fl);  // back to blocking for the lane loops
  return 0;
}

int dial(const char* host, int port, int kind) {
  if (kind == 1) {  // uds: host is the socket path
    int fd = ::socket(AF_UNIX, SOCK_STREAM, 0);
    if (fd < 0) return -1;
    sockaddr_un addr{};
    addr.sun_family = AF_UNIX;
    size_t n = strlen(host);
    if (n >= sizeof(addr.sun_path)) {
      ::close(fd);
      return -1;
    }
    std::memcpy(addr.sun_path, host, n + 1);
    if (connect_with_timeout(fd, (sockaddr*)&addr, sizeof(addr), 30000) < 0) {
      ::close(fd);
      return -1;
    }
    return fd;
  }
  addrinfo hints{}, *res = nullptr;
  hints.ai_family = AF_UNSPEC;
  hints.ai_socktype = SOCK_STREAM;
  char portbuf[16];
  snprintf(portbuf, sizeof portbuf, "%d", port);
  if (getaddrinfo(host, portbuf, &hints, &res) != 0 || !res) return -1;
  int fd = -1;
  for (addrinfo* ai = res; ai; ai = ai->ai_next) {
    fd = ::socket(ai->ai_family, ai->ai_socktype, ai->ai_protocol);
    if (fd < 0) continue;
    if (connect_with_timeout(fd, ai->ai_addr, (socklen_t)ai->ai_addrlen,
                             30000) == 0)
      break;
    ::close(fd);
    fd = -1;
  }
  freeaddrinfo(res);
  if (fd >= 0) {
    int one = 1;
    setsockopt(fd, IPPROTO_TCP, TCP_NODELAY, &one, sizeof(one));
  }
  return fd;
}

bool cli_recv_exact(int fd, void* buf, size_t n) {
  uint8_t* p = (uint8_t*)buf;
  while (n) {
    ssize_t r = ::recv(fd, p, n, 0);
    if (r < 0 && errno == EINTR) continue;
    if (r <= 0) return false;  // EOF or hard error
    p += r;
    n -= (size_t)r;
  }
  return true;
}

struct ClientLane {
  int fd = -1;
  std::mutex send_mu;
  std::thread th;
};

// mirrored by _DRAIN_REC_DTYPE in byteps_tpu/native/__init__.py —
// change both together (64-bit fields first: no implicit padding holes)
struct DrainRec {
  uint64_t key;
  uint64_t len;
  uint64_t off;  // arena offset of the payload (non-zero-copy only)
  int32_t op;
  int32_t status;
  uint32_t flags;
  uint32_t seq;
  uint32_t cmd;
  uint32_t version;
  int32_t zc;
  int32_t _pad;
};
static_assert(sizeof(DrainRec) == 56, "DrainRec layout drifted");

struct Completion {
  int32_t op;
  int32_t status;
  uint32_t flags;
  uint32_t seq;
  uint32_t cmd;
  uint64_t key;
  uint32_t version;
  int32_t zc;
  uint64_t len;
  std::vector<uint8_t> payload;  // owned bytes (non-zero-copy only)
};

struct NativeClient {
  std::vector<std::unique_ptr<ClientLane>> lanes;
  bpsc_cb_t cb = nullptr;
  void* cb_ctx = nullptr;

  std::mutex mu;  // seq table + lifecycle flags
  uint32_t next_seq = 0;
  struct Pending {
    uint8_t* sink;
    uint64_t sink_len;
    // send timestamp of this seq's newest attempt (0 = not sent yet):
    // feeds the native per-attempt round-trip histogram below
    uint64_t t_send_ns = 0;
  };
  std::unordered_map<uint32_t, Pending> pending;

  // Per-attempt RPC latency, measured where the wire is (send syscall →
  // completion enqueue, no ctypes trampoline / drain batching in the
  // number) — exported as native_rpc_round_trip_seconds through
  // bpsc_metrics_json and telemetry's histogram-provider seam.
  bps_hist::Hist rtt_hist;
  bool dead = false;  // set by the LAST lane to exit (after the drain)
  int live_lanes = 0;

  // end-to-end wire integrity (docs/robustness.md "Wire integrity"):
  // stamp outgoing data-plane frames (BYTEPS_WIRE_CHECKSUM, read at
  // create) and verify any response carrying kChecksumFlag; mismatches
  // across the whole striped connection count toward the teardown limit
  bool checksum_on = false;
  uint32_t ck_conn_limit = 8;
  std::atomic<uint32_t> ck_fails{0};

  // completion queue (batched delivery; see file header)
  std::mutex cq_mu;
  std::deque<Completion> cq;

  // push one completion; doorbell on the empty→non-empty transition.
  // The doorbell trampoline runs ON the calling lane thread and the
  // Python handler drains until empty, so a push into a non-empty
  // queue is always picked up by the drain loop already running.
  void push_completion(Completion&& m) {
    bool bell;
    {
      std::lock_guard<std::mutex> g(cq_mu);
      bell = cq.empty();
      cq.push_back(std::move(m));
    }
    if (bell) cb(cb_ctx, -2, 0, 0, 0, 0, 0, 0, nullptr, 0, 0);
  }

  ~NativeClient() {
    for (auto& l : lanes) {
      if (l->th.joinable()) l->th.join();
      if (l->fd >= 0) ::close(l->fd);
    }
  }

  void shutdown_all_fds() {
    // shutdown (not close) wakes lane threads blocked in recv; the fds
    // close in the destructor, after the threads are joined
    for (auto& l : lanes)
      if (l->fd >= 0) ::shutdown(l->fd, SHUT_RDWR);
  }

  // One lane dying poisons the whole striped connection (a partially
  // striped link would strand keyed requests); only the LAST lane to
  // exit drains pending callbacks — a sibling may still be receiving
  // into a caller's zero-copy sink.
  void lane_exit() {
    shutdown_all_fds();
    std::vector<uint32_t> orphans;
    {
      std::lock_guard<std::mutex> g(mu);
      if (--live_lanes > 0) return;
      dead = true;
      orphans.reserve(pending.size());
      for (auto& kv : pending) orphans.push_back(kv.first);
      pending.clear();
    }
    for (uint32_t seq : orphans) {
      Completion m{};
      m.op = -1;
      m.status = -1;
      m.seq = seq;
      push_completion(std::move(m));
    }
  }

  void recv_loop(ClientLane* lane) {
    for (;;) {
      Header h;
      if (!cli_recv_exact(lane->fd, &h, sizeof(h))) break;
      if (h.magic != kMagic) break;  // framing desync: drop the conn
      // Optional trace context (transport.py TRACE_FLAG, status bit 7):
      // a tracing server appends 16 bytes after the header.  Consume the
      // block and clear the bit so the stream stays framed and Python
      // sees a clean status — the same optional-on-decode guarantee the
      // Python client's recv_header_ex gives (the native client stamps
      // no spans; ROADMAP keeps that as follow-up).
      uint8_t trace_ctx[16];
      bool have_trace = false;
      if (h.status & bps_wire::kTraceFlag) {
        if (!cli_recv_exact(lane->fd, trace_ctx, sizeof(trace_ctx))) break;
        h.status &= static_cast<uint8_t>(~bps_wire::kTraceFlag);
        have_trace = true;
      }
      // Optional end-to-end checksum (transport.py CHECKSUM_FLAG):
      // consume the 4-byte CRC32C and verify once the payload landed —
      // BEFORE the completion reaches the seq demux.
      uint32_t want_crc = 0;
      bool have_ck = false;
      if (h.status & bps_wire::kChecksumFlag) {
        uint8_t ckb[4];
        if (!cli_recv_exact(lane->fd, ckb, sizeof(ckb))) break;
        std::memcpy(&want_crc, ckb, 4);
        want_crc = ntohl(want_crc);
        h.status &= static_cast<uint8_t>(~bps_wire::kChecksumFlag);
        have_ck = true;
      }
      // Optional lossless container (transport.py LOSSLESS_FLAG): the
      // payload on the wire is compressed — `length` and the CRC cover
      // the compressed bytes; decode happens after integrity passes.
      bool have_lz = false;
      if (h.status & bps_wire::kLosslessFlag) {
        h.status &= static_cast<uint8_t>(~bps_wire::kLosslessFlag);
        have_lz = true;
      }
      Completion m{};
      m.op = h.op;
      m.status = h.status;
      m.flags = h.flags;
      m.seq = ntohl(h.seq);
      m.key = be64toh(h.key);
      m.cmd = ntohl(h.cmd);
      m.version = ntohl(h.version);
      m.len = be64toh(h.length);
      uint8_t* sink = nullptr;
      uint64_t sink_len = 0;
      uint64_t t_send_ns = 0;
      {
        std::lock_guard<std::mutex> g(mu);
        auto it = pending.find(m.seq);
        if (it != pending.end()) {
          sink = it->second.sink;
          sink_len = it->second.sink_len;
          t_send_ns = it->second.t_send_ns;
        }
      }
      const uint8_t* body = nullptr;
      if (m.len) {
        // a lossless frame's `length` is the container size, never the
        // caller's raw-sized sink — always land it in an owned payload
        if (!have_lz && sink && sink_len == m.len) {
          // zero-copy: the response lands directly in the caller's
          // registered buffer (ZPull-into-SArray parity); the queued
          // record carries no bytes.  The sink stays valid until the
          // drain delivers this record: Python's keep-alive is dropped
          // only by the per-record dispatch.  A checksum-rejected frame
          // may have written garbage into the sink — harmless: the
          // completion never fires, and the retried response overwrites.
          if (!cli_recv_exact(lane->fd, sink, m.len)) break;
          m.zc = 1;
          body = sink;
        } else {
          // entry-owned payload: each completion is a fresh vector (the
          // queue outlives this loop iteration), so the old per-lane
          // scratch — and its high-water-mark concern (ADVICE r4) — is
          // gone by construction
          m.payload.resize(m.len);
          if (!cli_recv_exact(lane->fd, m.payload.data(), m.len)) break;
          body = m.payload.data();
        }
      }
      if (have_ck) {
        uint32_t crc = have_trace ? bps_wire::crc32c(trace_ctx, 16) : 0;
        crc = bps_wire::crc32c(body, (size_t)m.len, crc);
        if (crc != want_crc) {
          // DROP: the pending entry stays registered (the deadline/
          // retry machinery owns healing), and Python is told via an
          // op=-3 notification record (counted, never demuxed — the
          // corrupt frame's op rides in cmd for the label)
          uint32_t fails = ck_fails.fetch_add(1, std::memory_order_relaxed) + 1;
          Completion note{};
          note.op = -3;
          note.seq = m.seq;
          note.cmd = m.op >= 0 ? (uint32_t)m.op : 0;
          push_completion(std::move(note));
          if (ck_conn_limit && fails >= ck_conn_limit)
            break;  // repeated corruption: poison the conn → revival
          continue;
        }
      }
      if (have_lz) {
        // decompress AFTER integrity passes; a corrupt container drops
        // exactly like a CRC mismatch (pending entry stays registered,
        // deadline/retry re-fetches) — the op=-3 notification carries
        // status=1 so Python counts it as wire_lossless_fail
        long raw = bps_wire::lossless_raw_len(body, (size_t)m.len);
        std::vector<uint8_t> dec;
        long got = -1;
        if (raw >= 0) {
          dec.resize(raw > 0 ? (size_t)raw : 1);
          got = bps_wire::lossless_decompress_frame(body, (size_t)m.len,
                                                    dec.data(), (size_t)raw);
        }
        if (got < 0 || got != raw) {
          uint32_t fails = ck_fails.fetch_add(1, std::memory_order_relaxed) + 1;
          Completion note{};
          note.op = -3;
          note.status = 1;
          note.seq = m.seq;
          note.cmd = m.op >= 0 ? (uint32_t)m.op : 0;
          push_completion(std::move(note));
          if (ck_conn_limit && fails >= ck_conn_limit) break;
          continue;
        }
        dec.resize((size_t)raw);
        m.payload.swap(dec);
        m.len = (uint64_t)raw;
        if (sink && sink_len == m.len) {
          // the caller registered a raw-sized sink (pull): deliver the
          // decoded bytes there so the zero-copy drain contract holds
          std::memcpy(sink, m.payload.data(), (size_t)m.len);
          m.zc = 1;
          m.payload.clear();
        }
      }
      // un-register only AFTER the payload is fully received: dying
      // mid-payload must leave the entry for the drain (op=-1), never
      // lose it
      {
        std::lock_guard<std::mutex> g(mu);
        pending.erase(m.seq);
      }
      // per-attempt round trip: payload fully landed, response not yet
      // delivered to Python (the wire-true number, retries excluded —
      // each attempt re-stamps t_send_ns)
      if (t_send_ns) rtt_hist.observe((double)(steady_ns() - t_send_ns) * 1e-9);
      push_completion(std::move(m));
    }
    lane_exit();
  }
};

// Handle registry: ids never dangle — concurrent bpsc_* calls either
// resolve the shared_ptr before bpsc_close erases it (object outlives
// the call) or fail the lookup cleanly.
std::mutex g_cli_mu;
std::map<int64_t, std::shared_ptr<NativeClient>> g_clients;
int64_t g_next_cli_id = 1;

std::shared_ptr<NativeClient> cli_for(int64_t id) {
  std::lock_guard<std::mutex> g(g_cli_mu);
  auto it = g_clients.find(id);
  return it == g_clients.end() ? nullptr : it->second;
}

// Build the pre-payload part of one outgoing frame into out: 32-byte
// header, plus the 16-byte trace-context block when trace_id != 0
// (trace ids are nonzero by construction, tracing.new_trace_id), plus
// the 4-byte CRC32C block when checksumming (BYTEPS_WIRE_CHECKSUM) —
// all through the shared wire.h build_head, the SAME encoder the
// native server's send_msg uses.  The ONE encode path bpsc_send and
// the golden-fixture shims (bps_wire_client_frame / _ck) share, so the
// live client encoder is what the byte-exact fixtures pin.  Returns
// the byte count (32..52).
size_t build_frame_head(uint8_t out[bps_wire::kMaxHeadLen], int32_t op,
                        uint32_t seq, uint64_t key, uint32_t cmd,
                        uint32_t version, uint32_t flags,
                        const void* payload, uint64_t len, uint64_t trace_id,
                        uint64_t span_id, bool checksum) {
  return bps_wire::build_head(out, (uint8_t)op, /*base_status=*/0,
                              (uint8_t)flags, seq, key, cmd, version, payload,
                              len, trace_id, span_id,
                              checksum && bps_wire::checksum_op((uint8_t)op));
}

}  // namespace

extern "C" {

int64_t bpsc_create(const char* host, int32_t port, int32_t kind,
                    int32_t streams) {
  auto c = std::make_shared<NativeClient>();
  // the shared wire.h parsers (transport.py truthiness), read at
  // create so tests toggling the env between connections see it
  c->checksum_on = bps_wire::checksum_env_on();
  c->ck_conn_limit = bps_wire::checksum_env_conn_limit();
  if (streams < 1) streams = 1;
  if (kind == 1) streams = 1;  // parity with the Python client: stripe tcp only
  for (int i = 0; i < streams; ++i) {
    int fd = dial(host, port, kind);
    if (fd < 0) return -1;  // shared_ptr frees the dialed lanes
    auto lane = std::make_unique<ClientLane>();
    lane->fd = fd;
    c->lanes.push_back(std::move(lane));
  }
  c->live_lanes = (int)c->lanes.size();
  std::lock_guard<std::mutex> g(g_cli_mu);
  int64_t id = g_next_cli_id++;
  g_clients[id] = std::move(c);
  return id;
}

void bpsc_set_cb(int64_t h, void (*cb)(void*, int32_t, int32_t, uint32_t,
                                       uint32_t, uint64_t, uint32_t, uint32_t,
                                       const uint8_t*, uint64_t, int32_t),
                 void* ctx) {
  auto c = cli_for(h);
  if (!c) return;
  c->cb = cb;
  c->cb_ctx = ctx;
  // lanes start only once the callback is in place — a response racing
  // set_cb could otherwise fire a null pointer
  NativeClient* cp = c.get();
  for (auto& l : c->lanes) {
    ClientLane* lp = l.get();
    l->th = std::thread([cp, lp] { cp->recv_loop(lp); });
  }
}

int64_t bpsc_alloc_seq(int64_t h, void* sink, uint64_t sink_len) {
  auto c = cli_for(h);
  if (!c) return -1;
  std::lock_guard<std::mutex> g(c->mu);
  if (c->dead) return -1;
  uint32_t seq = c->next_seq++;
  c->pending[seq] = {(uint8_t*)sink, sink_len};
  return (int64_t)seq;
}

// Trace-context-aware send (docs/observability.md): trace_id/span_id
// ride the optional 16-byte TRACE_FLAG block after the header, exactly
// as transport.py Message.encode emits it — the Python engine's span
// context now propagates through the native client too, so the server's
// child spans join the worker spans whichever client implementation
// carried the frame.  trace_id 0 = untraced frame (the ids are nonzero
// by construction).
int32_t bpsc_send2(int64_t h, int32_t op, uint32_t seq, uint64_t key,
                   uint32_t cmd, uint32_t version, uint32_t flags,
                   const void* payload, uint64_t len, uint64_t trace_id,
                   uint64_t span_id) {
  auto c = cli_for(h);
  if (!c) return -1;
  ClientLane* lane = c->lanes[key % c->lanes.size()].get();
  // the shared wire.h codec — one header encoder for client, server,
  // and the golden-fixture shim (Op.FUSED / RESYNC frames ride this
  // same path: the native client is payload-agnostic, so the fused
  // pack and recovery-plane routing in comm/ps_client.py work over
  // either client implementation)
  uint8_t head[bps_wire::kMaxHeadLen];
  size_t head_len = build_frame_head(head, op, seq, key, cmd, version, flags,
                                     payload, len, trace_id, span_id,
                                     c->checksum_on);
  // per-attempt latency starts at the send, transport included —
  // re-stamped on every retry attempt (the Python client's t_sent
  // placement); registered seq only, control sends have no entry
  {
    std::lock_guard<std::mutex> g(c->mu);
    auto it = c->pending.find(seq);
    if (it != c->pending.end()) it->second.t_send_ns = steady_ns();
  }
  // scatter-gather send: header + payload leave through one writev with
  // zero payload memcpys (transport.py sendmsg parity)
  iovec iov[2] = {{head, head_len}, {const_cast<void*>(payload), len}};
  int iovcnt = len ? 2 : 1;
  size_t off = 0, total = head_len + (size_t)len;
  std::lock_guard<std::mutex> g(lane->send_mu);
  while (off < total) {
    iovec cur[2];
    int n = 0;
    size_t skip = off;
    for (int i = 0; i < iovcnt; ++i) {
      if (skip >= iov[i].iov_len) {
        skip -= iov[i].iov_len;
        continue;
      }
      cur[n].iov_base = (uint8_t*)iov[i].iov_base + skip;
      cur[n].iov_len = iov[i].iov_len - skip;
      skip = 0;
      ++n;
    }
    ssize_t w = ::writev(lane->fd, cur, n);
    if (w < 0 && errno == EINTR) continue;
    if (w <= 0) return -1;
    off += (size_t)w;
  }
  return 0;
}

// pre-observability surface: an untraced bpsc_send2 (kept so an older
// Python layer over a fresh .so keeps working)
int32_t bpsc_send(int64_t h, int32_t op, uint32_t seq, uint64_t key,
                  uint32_t cmd, uint32_t version, uint32_t flags,
                  const void* payload, uint64_t len) {
  return bpsc_send2(h, op, seq, key, cmd, version, flags, payload, len, 0, 0);
}

// One client handle's histograms as a JSON document (same shape as
// bps_native_server_metrics_json) — parsed by native/__init__.py and
// fed through telemetry's histogram-provider seam so the native data
// plane's rpc_round_trip lands in get_metrics()/Prometheus/the cluster
// aggregate.  Returns bytes written, -(needed) when cap is too small,
// or -1 for an unknown handle.
int64_t bpsc_metrics_json(int64_t h, uint8_t* out, uint64_t cap) {
  auto c = cli_for(h);
  if (!c) return -1;
  std::string body = "{\"histograms\": [";
  c->rtt_hist.append_json(&body, "native_rpc_round_trip_seconds", nullptr,
                          "");
  body += "]}";
  if (body.size() > cap) return -(int64_t)body.size();
  std::memcpy(out, body.data(), body.size());
  return (int64_t)body.size();
}

// Golden-fixture shim (tests/test_wire_golden.py): emit one complete
// frame (header [+ trace block] + payload) through the LIVE client
// encode path (build_frame_head — the same bytes bpsc_send2 writes), so
// transport.py Message.encode and the native client cannot drift.
// Returns bytes written or -(needed) when cap is too small.
int64_t bps_wire_client_frame(int32_t op, uint32_t seq, uint64_t key,
                              uint32_t cmd, uint32_t version, uint32_t flags,
                              uint64_t trace_id, uint64_t span_id,
                              const uint8_t* payload, uint64_t len,
                              uint8_t* out, uint64_t cap) {
  uint8_t head[bps_wire::kMaxHeadLen];
  size_t head_len = build_frame_head(head, op, seq, key, cmd, version, flags,
                                     payload, len, trace_id, span_id,
                                     /*checksum=*/false);
  uint64_t total = head_len + len;
  if (total > cap) return -(int64_t)total;
  std::memcpy(out, head, head_len);
  if (len) std::memcpy(out + head_len, payload, len);
  return (int64_t)total;
}

// Checksummed twin of bps_wire_client_frame: the same LIVE encode path
// with BYTEPS_WIRE_CHECKSUM semantics forced on — what the checksummed
// golden stream (tests/test_wire_golden.py CHECKSUM_GOLDEN_SHA256)
// pins against transport.py.  A separate symbol so the original shim's
// bytes (and its callers' bound signature) never change.
int64_t bps_wire_client_frame_ck(int32_t op, uint32_t seq, uint64_t key,
                                 uint32_t cmd, uint32_t version,
                                 uint32_t flags, uint64_t trace_id,
                                 uint64_t span_id, const uint8_t* payload,
                                 uint64_t len, uint8_t* out, uint64_t cap) {
  uint8_t head[bps_wire::kMaxHeadLen];
  size_t head_len = build_frame_head(head, op, seq, key, cmd, version, flags,
                                     payload, len, trace_id, span_id,
                                     /*checksum=*/true);
  uint64_t total = head_len + len;
  if (total > cap) return -(int64_t)total;
  std::memcpy(out, head, head_len);
  if (len) std::memcpy(out + head_len, payload, len);
  return (int64_t)total;
}

// The shared CRC32C through the LIVE wire.h implementation — the ctypes
// fast path transport.py crc32c() rides, and the parity anchor the
// integrity tests pin the pure-Python fallback against.
uint32_t bps_wire_crc32c(const void* data, uint64_t n, uint32_t crc) {
  return bps_wire::crc32c(data, (size_t)n, crc);
}

// Lossless frame codec through the LIVE wire.h implementation — the
// ctypes fast path compression/lossless.py rides, and the parity anchor
// tests/test_lossless.py pins the pure-Python codec against (both sides
// must emit identical containers for identical inputs).  Returns the
// container / raw size, -1 on decode failure, 0 when `cap` is too small.
int64_t bps_wire_lossless_compress(const uint8_t* src, uint64_t n,
                                   uint8_t* dst, uint64_t cap) {
  return (int64_t)bps_wire::lossless_compress_frame(src, (size_t)n, dst,
                                                    (size_t)cap);
}

int64_t bps_wire_lossless_decompress(const uint8_t* src, uint64_t n,
                                     uint8_t* dst, uint64_t dst_cap) {
  return (int64_t)bps_wire::lossless_decompress_frame(src, (size_t)n, dst,
                                                      (size_t)dst_cap);
}

int64_t bpsc_drain(int64_t h, void* recs_out, int64_t max_recs,
                   void* arena_out, uint64_t arena_cap) {
  auto c = cli_for(h);
  if (!c) return 0;
  DrainRec* recs = (DrainRec*)recs_out;
  uint8_t* arena = (uint8_t*)arena_out;
  uint64_t used = 0;
  int64_t n = 0;
  std::lock_guard<std::mutex> g(c->cq_mu);
  while (n < max_recs && !c->cq.empty()) {
    Completion& m = c->cq.front();
    uint64_t need = m.zc ? 0 : m.payload.size();
    if (need > arena_cap - used) {
      if (n > 0) break;  // deliver what fits; caller loops
      return -(int64_t)need;  // first record too big: grow + retry
    }
    DrainRec& r = recs[n];
    r.key = m.key;
    r.len = m.len;
    r.off = used;
    r.op = m.op;
    r.status = m.status;
    r.flags = m.flags;
    r.seq = m.seq;
    r.cmd = m.cmd;
    r.version = m.version;
    r.zc = m.zc;
    r._pad = 0;
    if (need) {
      std::memcpy(arena + used, m.payload.data(), need);
      used += need;
    }
    c->cq.pop_front();
    ++n;
  }
  return n;
}

void bpsc_close(int64_t h) {
  std::shared_ptr<NativeClient> c;
  {
    std::lock_guard<std::mutex> g(g_cli_mu);
    auto it = g_clients.find(h);
    if (it == g_clients.end()) return;  // idempotent
    c = std::move(it->second);
    g_clients.erase(it);
  }
  c->shutdown_all_fds();  // wakes lane threads; they drain and exit
  for (auto& l : c->lanes)
    if (l->th.joinable()) l->th.join();
  // final flush: the handle is already out of the registry, so the
  // doorbell→bpsc_drain contract can no longer deliver — push anything
  // still queued (incl. the lane-exit op=-1 death markers) through the
  // per-record trampoline instead.  Cold path; per-message cost fine.
  // Without this, a blocking request pending at close would hang on a
  // cb(None) that never fires.
  std::deque<Completion> leftover;
  {
    std::lock_guard<std::mutex> g(c->cq_mu);
    leftover.swap(c->cq);
  }
  for (auto& m : leftover) {
    const uint8_t* p =
        (!m.zc && !m.payload.empty()) ? m.payload.data() : nullptr;
    c->cb(c->cb_ctx, m.op, m.status, m.flags, m.seq, m.key, m.cmd,
          m.version, p, m.len, m.zc);
  }
  // fds close in ~NativeClient once any in-flight bpsc_send releases
  // its shared_ptr
}

}  // extern "C"
