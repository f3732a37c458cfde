// Gradient compression codecs — native C++ core.
//
// TPU-native re-design of byteps/common/compressor/impl/* (SURVEY §2.2):
//   onebit    — sign compression packed 32:1 with optional L1 scaling
//               (onebit.cc)
//   topk      — largest-k (index, value) pairs (topk.cc)
//   randomk   — random-k with a shared xorshift128+ seed so worker and
//               server draw identical indices (randomk.cc, utils.h RNG)
//   dithering — stochastic quantization, linear or natural (power-of-two)
//               level partition, max or L2 norm (dithering.cc)
//
// All codecs run on the fp32 host staging buffer (compression happens
// post-local-reduce, pre-PUSH — docs/gradient-compression.md).  C ABI via
// ctypes; buffers are caller-allocated numpy arrays.

#include <algorithm>
#include <cmath>
#include <cstdint>
#include <cstring>
#include <numeric>
#include <vector>

extern "C" {

// ---------------------------------------------------------------------------
// xorshift128+ — must match byteps_tpu/compression/rng.py bit-for-bit
// ---------------------------------------------------------------------------

static inline uint64_t xorshift128p(uint64_t* s) {
  uint64_t x = s[0];
  const uint64_t y = s[1];
  s[0] = y;
  x ^= x << 23;
  s[1] = x ^ y ^ (x >> 17) ^ (y >> 26);
  return s[1] + y;
}

// ---------------------------------------------------------------------------
// onebit: [f32 scale][u32 packed signs]  (bit set = negative)
// ---------------------------------------------------------------------------

int64_t bps_onebit_size(int64_t n) { return 4 + 4 * ((n + 31) / 32); }

int64_t bps_onebit_compress(const float* in, int64_t n, uint8_t* out,
                            int32_t scaled) {
  float scale = 1.0f;
  if (scaled) {
    double l1 = 0.0;
#pragma omp parallel for reduction(+ : l1) schedule(static)
    for (int64_t i = 0; i < n; ++i) l1 += std::fabs((double)in[i]);
    scale = n > 0 ? (float)(l1 / (double)n) : 1.0f;
  }
  std::memcpy(out, &scale, 4);
  uint32_t* words = (uint32_t*)(out + 4);
  int64_t nwords = (n + 31) / 32;
#pragma omp parallel for schedule(static)
  for (int64_t w = 0; w < nwords; ++w) {
    uint32_t bits = 0;
    int64_t base = w * 32;
    int64_t end = std::min<int64_t>(base + 32, n);
    for (int64_t i = base; i < end; ++i) {
      if (std::signbit(in[i])) bits |= (1u << (i - base));
    }
    words[w] = bits;
  }
  return bps_onebit_size(n);
}

int32_t bps_onebit_decompress(const uint8_t* in, int64_t n, float* out) {
  float scale;
  std::memcpy(&scale, in, 4);
  const uint32_t* words = (const uint32_t*)(in + 4);
#pragma omp parallel for schedule(static)
  for (int64_t i = 0; i < n; ++i) {
    uint32_t bit = (words[i / 32] >> (i % 32)) & 1u;
    out[i] = bit ? -scale : scale;
  }
  return 0;
}

// ---------------------------------------------------------------------------
// topk: [i32 idx, f32 val] * k
// ---------------------------------------------------------------------------

int64_t bps_topk_size(int64_t k) { return 8 * k; }

int64_t bps_topk_compress(const float* in, int64_t n, int64_t k,
                          uint8_t* out) {
  if (k > n) k = n;
  std::vector<int32_t> idx(n);
  std::iota(idx.begin(), idx.end(), 0);
  // tie-break on index (ascending) so equal |magnitudes| at the k-th
  // boundary select deterministically — and identically to the device
  // packer (jax.lax.top_k favors lower indices) and the numpy fallback
  std::nth_element(idx.begin(), idx.begin() + k, idx.end(),
                   [&](int32_t a, int32_t b) {
                     float fa = std::fabs(in[a]), fb = std::fabs(in[b]);
                     return fa > fb || (fa == fb && a < b);
                   });
  // deterministic order: sort the selected k by index
  std::sort(idx.begin(), idx.begin() + k);
  for (int64_t j = 0; j < k; ++j) {
    int32_t i = idx[j];
    std::memcpy(out + 8 * j, &i, 4);
    std::memcpy(out + 8 * j + 4, &in[i], 4);
  }
  return 8 * k;
}

int32_t bps_topk_decompress(const uint8_t* in, int64_t k, float* out,
                            int64_t n) {
  std::memset(out, 0, (size_t)n * 4);
  for (int64_t j = 0; j < k; ++j) {
    int32_t i;
    float v;
    std::memcpy(&i, in + 8 * j, 4);
    std::memcpy(&v, in + 8 * j + 4, 4);
    if (i >= 0 && i < n) out[i] = v;
  }
  return 0;
}

// sum a compressed topk payload into a dense fp32 accumulator (server-side
// SUM_RECV without densifying first)
int32_t bps_topk_sum_into(const uint8_t* in, int64_t k, float* acc,
                          int64_t n) {
  for (int64_t j = 0; j < k; ++j) {
    int32_t i;
    float v;
    std::memcpy(&i, in + 8 * j, 4);
    std::memcpy(&v, in + 8 * j + 4, 4);
    if (i >= 0 && i < n) acc[i] += v;
  }
  return 0;
}

// ---------------------------------------------------------------------------
// randomk: same payload as topk; indices drawn by shared-seed xorshift128+
// ---------------------------------------------------------------------------

int64_t bps_randomk_compress(const float* in, int64_t n, int64_t k,
                             uint64_t s0, uint64_t s1, uint8_t* out) {
  if (k > n) k = n;
  uint64_t st[2] = {s0 ? s0 : 0x9E3779B97F4A7C15ull, s1 ? s1 : 0xBF58476D1CE4E5B9ull};
  for (int64_t j = 0; j < k; ++j) {
    int32_t i = (int32_t)(xorshift128p(st) % (uint64_t)n);
    std::memcpy(out + 8 * j, &i, 4);
    std::memcpy(out + 8 * j + 4, &in[i], 4);
  }
  return 8 * k;
}

// ---------------------------------------------------------------------------
// dithering: [f32 norm][i8 signed level] * n
//   s levels; linear partition l_j = j/s, or natural partition with levels
//   at powers of two; norm = max|x| or L2
// ---------------------------------------------------------------------------

int64_t bps_dithering_size(int64_t n) { return 4 + n; }

int64_t bps_dithering_compress(const float* in, int64_t n, int32_t s,
                               int32_t natural, int32_t l2, uint64_t s0,
                               uint64_t s1, uint8_t* out) {
  double norm = 0.0;
  if (l2) {
    for (int64_t i = 0; i < n; ++i) norm += (double)in[i] * in[i];
    norm = std::sqrt(norm);
  } else {
    for (int64_t i = 0; i < n; ++i)
      norm = std::max(norm, (double)std::fabs(in[i]));
  }
  if (norm == 0.0) norm = 1.0;
  float normf = (float)norm;
  std::memcpy(out, &normf, 4);
  int8_t* lv = (int8_t*)(out + 4);
  uint64_t st[2] = {s0 ? s0 : 0x9E3779B97F4A7C15ull, s1 ? s1 : 0xBF58476D1CE4E5B9ull};
  for (int64_t i = 0; i < n; ++i) {
    double p = std::fabs((double)in[i]) / norm;  // in [0,1]
    double u = (double)(xorshift128p(st) >> 11) * (1.0 / 9007199254740992.0);
    int32_t level;
    if (natural) {
      // natural partition: levels 0 and 2^{-j}, j = s-1..0
      if (p <= 0.0) {
        level = 0;
      } else {
        double lg = std::log2(p);
        int32_t j = (int32_t)std::floor(lg);        // 2^j <= p < 2^{j+1}
        if (j >= 0) {
          level = s;  // p >= 1 → top level
        } else if (j < -s) {
          // below the smallest level: round to 0 or 2^{-s}
          double lo = 0.0, hi = std::pow(2.0, -(double)s);
          level = (p - lo) / (hi - lo) > u ? 1 : 0;
        } else {
          double lo = std::pow(2.0, (double)j);
          double hi = std::pow(2.0, (double)j + 1);
          int32_t jl = s + j;  // index of lo level (1..s-1)
          level = (p - lo) / (hi - lo) > u ? jl + 1 : jl;
        }
      }
    } else {
      // linear partition: levels j/s
      double scaled = p * s;
      int32_t fl = (int32_t)std::floor(scaled);
      double frac = scaled - fl;
      level = fl + (frac > u ? 1 : 0);
      if (level > s) level = s;
    }
    lv[i] = (int8_t)(std::signbit(in[i]) ? -level : level);
  }
  return 4 + n;
}

int32_t bps_dithering_decompress(const uint8_t* in, int64_t n, int32_t s,
                                 int32_t natural, float* out) {
  float norm;
  std::memcpy(&norm, in, 4);
  const int8_t* lv = (const int8_t*)(in + 4);
#pragma omp parallel for schedule(static)
  for (int64_t i = 0; i < n; ++i) {
    int32_t level = lv[i];
    int32_t a = level < 0 ? -level : level;
    double mag;
    if (natural) {
      mag = a == 0 ? 0.0 : std::pow(2.0, (double)(a - s));
    } else {
      mag = (double)a / (double)s;
    }
    out[i] = (float)((level < 0 ? -mag : mag) * norm);
  }
  return 0;
}

}  // extern "C"
