// K4, the onebit sign packer, for Hopper (sm_90a).
//
// Replaces the Pallas kernel `_pack_kernel` of
// byteps_tpu/ops/onebit_device.py:38-55 (pallas_call at :84) and the scale
// that file computes beside it (:78-80).  For x of n float32 it writes the
// onebit wire payload into one device buffer:
//
//   [f32 scale][u32 words[ceil(n/32)]], little-endian
//   words[w] = sum_i signbit(x[32w + i]) << i   (lanes past n: clear bits;
//              -0.0 and negative NaNs set their bit, as signbit does)
//   scale    = sum |x| / n when scaling, else 1.0
//
// What bounds it on an H100: bytes.  It reads 4n bytes and writes
// 4 + 4*ceil(n/32), about 0.03 operations a byte, far below the ~295 a byte
// where the card stops being memory bound.  The design keeps to one pass
// over HBM:
// - one warp per 32-element word: lane l loads x[32w + l], so a warp reads
//   128 contiguous bytes (coalesced).  __ballot_sync of the lanes' sign
//   bits is the word itself; lane 0 stores it.  Wider (16-byte) loads are
//   later work.
// - the scale is folded into the same pass: each thread accumulates |x| in
//   float64, each block reduces its threads in a fixed tree (warp
//   shuffles, then shared memory) into one partial, and a second one-block
//   launch sums the partials in a fixed order and divides by n.  No
//   atomics, so the scale is bitwise the same from launch to launch (the
//   servers' sums depend on that), and float64 keeps it within a rounding
//   of the exact mean.
//
// Plain C interface for ctypes (ops/_build.py); the wrapper and the plain
// PyTorch version are in byteps_tpu_torch/ops/onebit_device.py.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr unsigned kFull = 0xffffffffu;

__device__ __forceinline__ double warp_sum(double v) {
  for (int off = 16; off > 0; off >>= 1) v += __shfl_down_sync(kFull, v, off);
  return v;
}

// Sum of v over the block in a fixed order; the result is valid in thread 0.
__device__ __forceinline__ double block_sum(double v, double* smem) {
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  v = warp_sum(v);
  if (lane == 0) smem[warp] = v;
  __syncthreads();
  if (warp == 0) v = warp_sum(lane < kWarps ? smem[lane] : 0.0);
  return v;
}

__global__ void __launch_bounds__(kThreads)
onebit_pack_kernel(const float* __restrict__ x, long long n, long long nwords,
                   uint32_t* __restrict__ words, double* __restrict__ partials) {
  __shared__ double smem[kWarps];
  const int lane = threadIdx.x & 31;
  const long long first = (long long)blockIdx.x * kWarps + (threadIdx.x >> 5);
  const long long stride = (long long)gridDim.x * kWarps;
  double acc = 0.0;
  // every lane of a warp runs the same iterations: the ballot sees all 32
  for (long long w = first; w < nwords; w += stride) {
    const long long i = w * 32 + lane;
    const float v = i < n ? x[i] : 0.0f;  // +0.0 past n: clear bit, adds 0
    const unsigned bits = __ballot_sync(kFull, (__float_as_uint(v) >> 31) != 0u);
    if (lane == 0) words[w] = bits;
    acc += fabs((double)v);
  }
  acc = block_sum(acc, smem);
  if (threadIdx.x == 0) partials[blockIdx.x] = acc;
}

__global__ void __launch_bounds__(kThreads)
onebit_scale_kernel(const double* __restrict__ partials, int nparts, long long n,
                    int scaling, float* __restrict__ scale) {
  __shared__ double smem[kWarps];
  double acc = 0.0;
  for (int i = threadIdx.x; i < nparts; i += kThreads) acc += partials[i];
  acc = block_sum(acc, smem);
  if (threadIdx.x == 0) *scale = scaling ? (float)(acc / (double)n) : 1.0f;
}

}  // namespace

extern "C" {

// Pack n floats at x into the payload at out (4 + 4*ceil(n/32) bytes,
// 4-byte aligned).  partials: nparts doubles of scratch, one per block of
// the first launch.  Returns the cudaError_t of the launches (0 = both
// were accepted); nothing is synchronised.
int bps_onebit_pack(const void* x, long long n, int scaling, void* out,
                    void* partials, int nparts, void* stream) {
  if (n <= 0 || nparts <= 0) return (int)cudaErrorInvalidValue;
  const long long nwords = (n + 31) / 32;
  cudaStream_t s = (cudaStream_t)stream;
  onebit_pack_kernel<<<nparts, kThreads, 0, s>>>(
      (const float*)x, n, nwords, (uint32_t*)((char*)out + 4), (double*)partials);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  onebit_scale_kernel<<<1, kThreads, 0, s>>>(
      (const double*)partials, nparts, n, scaling, (float*)out);
  return (int)cudaGetLastError();
}

}  // extern "C"
