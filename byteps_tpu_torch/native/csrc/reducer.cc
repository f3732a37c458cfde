// CPU reducer — native summation kernels for the PS server and the
// error-feedback path.
//
// TPU-native re-design of the reference's cpu_reducer.cc (SURVEY §2.1):
// OpenMP-parallel elementwise sum over the wire dtypes.  The reference
// hand-rolls AVX+F16C intrinsics for fp16; we let the compiler
// auto-vectorize (-O3 -march=native) for fp32/fp64/int types and provide
// explicit scalar conversion loops for fp16/bf16, which GCC vectorizes
// with native ISA support where available.
//
// Exposed via a C ABI consumed through ctypes (no pybind11 in this image).

#include <cstdint>
#include <cstring>

extern "C" {

// dtype ids must match byteps_tpu.common.types.DataType (mshadow order)
enum DType : int32_t {
  kF32 = 0,
  kF64 = 1,
  kF16 = 2,
  kU8 = 3,
  kI32 = 4,
  kI8 = 5,
  kI64 = 6,
  kBF16 = 7,
};

static inline float half_to_float(uint16_t h) {
  uint32_t sign = (uint32_t)(h & 0x8000u) << 16;
  uint32_t exp = (h >> 10) & 0x1Fu;
  uint32_t man = h & 0x3FFu;
  uint32_t f;
  if (exp == 0) {
    if (man == 0) {
      f = sign;
    } else {  // subnormal
      exp = 127 - 15 + 1;
      while ((man & 0x400u) == 0) {
        man <<= 1;
        exp--;
      }
      man &= 0x3FFu;
      f = sign | (exp << 23) | (man << 13);
    }
  } else if (exp == 0x1F) {
    f = sign | 0x7F800000u | (man << 13);
  } else {
    f = sign | ((exp - 15 + 127) << 23) | (man << 13);
  }
  float out;
  std::memcpy(&out, &f, 4);
  return out;
}

static inline uint16_t float_to_half(float x) {
  uint32_t f;
  std::memcpy(&f, &x, 4);
  uint32_t sign = (f >> 16) & 0x8000u;
  int32_t exp = (int32_t)((f >> 23) & 0xFFu) - 127 + 15;
  uint32_t man = f & 0x7FFFFFu;
  if (exp <= 0) {
    if (exp < -10) return (uint16_t)sign;
    man |= 0x800000u;
    uint32_t shift = (uint32_t)(14 - exp);
    uint16_t h = (uint16_t)(sign | (man >> shift));
    // round-to-nearest
    if ((man >> (shift - 1)) & 1u) h++;
    return h;
  } else if (exp >= 0x1F) {
    return (uint16_t)(sign | 0x7C00u | (man ? 0x200u : 0));
  }
  uint16_t h = (uint16_t)(sign | ((uint32_t)exp << 10) | (man >> 13));
  if ((man >> 12) & 1u) h++;  // round
  return h;
}

static inline float bf16_to_float(uint16_t b) {
  uint32_t f = (uint32_t)b << 16;
  float out;
  std::memcpy(&out, &f, 4);
  return out;
}

static inline uint16_t float_to_bf16(float x) {
  uint32_t f;
  std::memcpy(&f, &x, 4);
  // round-to-nearest-even
  uint32_t rounding = 0x7FFFu + ((f >> 16) & 1u);
  return (uint16_t)((f + rounding) >> 16);
}

}  // extern "C" (pause for template definition)

template <typename T>
static void sum_t(T* dst, const T* src, int64_t n) {
#pragma omp parallel for simd schedule(static)
  for (int64_t i = 0; i < n; ++i) dst[i] += src[i];
}

extern "C" {

// dst += src, n elements of dtype; returns 0 on success
int32_t bps_sum(void* dst, const void* src, int64_t n, int32_t dtype) {
  switch (dtype) {
    case kF32:
      sum_t<float>((float*)dst, (const float*)src, n);
      return 0;
    case kF64:
      sum_t<double>((double*)dst, (const double*)src, n);
      return 0;
    case kI32:
      sum_t<int32_t>((int32_t*)dst, (const int32_t*)src, n);
      return 0;
    case kI64:
      sum_t<int64_t>((int64_t*)dst, (const int64_t*)src, n);
      return 0;
    case kI8:
      sum_t<int8_t>((int8_t*)dst, (const int8_t*)src, n);
      return 0;
    case kU8:
      sum_t<uint8_t>((uint8_t*)dst, (const uint8_t*)src, n);
      return 0;
    case kF16: {
      uint16_t* d = (uint16_t*)dst;
      const uint16_t* s = (const uint16_t*)src;
#pragma omp parallel for schedule(static)
      for (int64_t i = 0; i < n; ++i)
        d[i] = float_to_half(half_to_float(d[i]) + half_to_float(s[i]));
      return 0;
    }
    case kBF16: {
      uint16_t* d = (uint16_t*)dst;
      const uint16_t* s = (const uint16_t*)src;
#pragma omp parallel for schedule(static)
      for (int64_t i = 0; i < n; ++i)
        d[i] = float_to_bf16(bf16_to_float(d[i]) + bf16_to_float(s[i]));
      return 0;
    }
  }
  return -1;
}

// dst = src1 + alpha * src2 (float32), the EF/momentum fused update
int32_t bps_sum_scaled_f32(float* dst, const float* src1, const float* src2,
                           int64_t n, float alpha) {
#pragma omp parallel for simd schedule(static)
  for (int64_t i = 0; i < n; ++i) dst[i] = src1[i] + alpha * src2[i];
  return 0;
}

int32_t bps_copy(void* dst, const void* src, int64_t nbytes) {
  std::memcpy(dst, src, (size_t)nbytes);
  return 0;
}

}  // extern "C"
