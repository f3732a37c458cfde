// Native fixed-bucket histograms — the C++ twin of
// core/telemetry.py's Histogram (docs/observability.md).  Buckets are
// cumulative-upper-bound ("le") semantics with an implicit +Inf slot;
// the bound tables below MUST match telemetry.LATENCY_BUCKETS /
// SIZE_BUCKETS exactly, because the Python histogram-provider seam
// merges these raw counts into the same registry families the Python
// engines feed (bucket-merge needs identical bounds).
//
// observe() is lock-free: one linear bound scan (the tables are tiny
// and hot in cache) + three relaxed atomic adds — cheap enough to stay
// always-on in the GIL-free data plane, same always-on contract the
// Python engine's histograms keep.  Sums are stored scaled to an
// integer unit (microseconds for latency, bytes for sizes) so the sum
// can be a single atomic without a compare-exchange loop on double.
#ifndef BYTEPS_TPU_NATIVE_HIST_H_
#define BYTEPS_TPU_NATIVE_HIST_H_

#include <atomic>
#include <cstdint>
#include <cstdio>
#include <cstring>
#include <string>

namespace bps_hist {

// telemetry.LATENCY_BUCKETS (seconds) — change both together
constexpr double kLatencyBounds[] = {
    0.0001, 0.00025, 0.0005, 0.001, 0.0025, 0.005, 0.01, 0.025, 0.05,
    0.1,    0.25,    0.5,    1.0,   2.5,    5.0,   10.0, 30.0,  100.0,
};
constexpr int kLatencyNum = sizeof(kLatencyBounds) / sizeof(double);

// telemetry.SIZE_BUCKETS (bytes) — change both together
constexpr double kSizeBounds[] = {
    64, 256, 1024, 4096, 16384, 65536, 262144, 1048576, 4194304, 16777216,
};
constexpr int kSizeNum = sizeof(kSizeBounds) / sizeof(double);

constexpr int kMaxBuckets = kLatencyNum > kSizeNum ? kLatencyNum : kSizeNum;

struct Hist {
  const double* bounds = kLatencyBounds;
  int nbounds = kLatencyNum;
  double scale = 1e6;  // value → integer sum unit (µs for latency)
  std::atomic<uint64_t> counts[kMaxBuckets + 1] = {};  // +1 = +Inf
  std::atomic<uint64_t> count{0};
  std::atomic<uint64_t> sum_scaled{0};

  void init_size_buckets() {
    bounds = kSizeBounds;
    nbounds = kSizeNum;
    scale = 1.0;  // sums stay in bytes
  }

  void observe(double v) {
    int i = 0;
    while (i < nbounds && v > bounds[i]) ++i;
    counts[i].fetch_add(1, std::memory_order_relaxed);
    count.fetch_add(1, std::memory_order_relaxed);
    double s = v * scale;
    sum_scaled.fetch_add(s > 0 ? (uint64_t)(s + 0.5) : 0,
                         std::memory_order_relaxed);
  }

  // One JSON record for the Python histogram-provider seam
  // (telemetry.MetricsRegistry.register_hist_provider):
  //   {"name": ..., "labels": {...}, "le": [...], "b": [...N+1 raw...],
  //    "sum": <seconds-or-bytes>, "count": n}
  // Appends nothing (and returns false) when the histogram is empty.
  bool append_json(std::string* out, const char* name,
                   const char* label_key, const std::string& label_val) const {
    uint64_t n = count.load(std::memory_order_relaxed);
    if (n == 0) return false;
    char buf[96];
    if (!out->empty() && out->back() == '}') *out += ", ";
    *out += "{\"name\": \"";
    *out += name;
    *out += "\", \"labels\": {";
    if (label_key) {
      *out += "\"";
      *out += label_key;
      *out += "\": \"" + label_val + "\"";
    }
    *out += "}, \"le\": [";
    for (int i = 0; i < nbounds; ++i) {
      snprintf(buf, sizeof buf, "%s%.17g", i ? ", " : "", bounds[i]);
      *out += buf;
    }
    *out += "], \"b\": [";
    for (int i = 0; i <= nbounds; ++i) {
      snprintf(buf, sizeof buf, "%s%llu", i ? ", " : "",
               (unsigned long long)counts[i].load(std::memory_order_relaxed));
      *out += buf;
    }
    snprintf(buf, sizeof buf, "], \"sum\": %.17g, \"count\": %llu}",
             (double)sum_scaled.load(std::memory_order_relaxed) / scale,
             (unsigned long long)n);
    *out += buf;
    return true;
  }
};

}  // namespace bps_hist

#endif  // BYTEPS_TPU_NATIVE_HIST_H_
