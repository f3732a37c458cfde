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
// where the card stops being memory bound.  At one partition (n =
// 1,024,000, 4 MB) latency holds it, not bytes: a cold read of 4 MB takes
// some 4 us on an H100 whatever the kernel, and the last block's sum adds
// two round trips to the L2 (PERF.md, K4).  The design keeps to one pass
// over HBM and one launch:
// - 16-byte loads, 128 bytes in flight a lane: a warp packs a chunk of
//   1024 elements (32 words) at a time, lane l loading the float4s at
//   elements 128j + 4l for j = 0..7 before it uses any (each j a coalesced
//   512-byte row).  A lane's four sign bits are a nibble of word 4j + l/8;
//   three xor-shuffles OR the eight nibbles of a word together, and one more
//   shuffle hands word l of the chunk to lane l, so the warp stores its 32
//   words as one coalesced 128-byte row.
// - any contiguous view: the chunks are cut from x rounded down to 16
//   bytes, so the float4s stay aligned.  Where x starts s = 1..3 elements
//   past that boundary, word w is the aligned frame's words w and w + 1
//   shifted by s (a funnel over the next lane; lane 31 reads the next
//   chunk's first s elements itself).  Chunks that hold the start of x or
//   its end (n not a multiple of 4, or of 1024) take the scalar path,
//   element by element, in the same kernel; elements outside x are never
//   read and count as +0.0.
// - the scale is folded into the same pass and the same launch: each thread
//   accumulates |x| in float64, each block reduces its threads in a fixed
//   tree (warp shuffles, then shared memory) into one partial, and the last
//   block to finish (it knows by a ticket, one acq_rel atomic add) sums the
//   partials in a fixed order and tree, divides by n and writes the scale.
//   No float atomics, so the scale is bitwise the same from launch to
//   launch whichever block comes last (the servers' sums depend on that),
//   and float64 keeps it within a rounding of the exact mean.  Its bits
//   depend on n and on x's offset past a 16-byte boundary: the wrapper's
//   grid is a function of n alone, never of the card.
// - the partials and the ticket live in a workspace the wrapper keeps per
//   (device, stream), zeroed once; the last block resets the ticket, and
//   launches on one stream are serialised, so a call allocates nothing but
//   its payload.
//
// Plain C interface for ctypes (ops/_build.py); the wrapper and the plain
// PyTorch version are in byteps_tpu_torch/ops/onebit_device.py.

#include <cuda/atomic>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kChunk = 1024;         // elements a warp packs at a time: 32 words
constexpr int kVecs = kChunk / 128;  // float4 loads a lane issues at a time
constexpr int kMaxBlocks = 1024;     // the wrapper's _MAX_BLOCKS
constexpr unsigned kFull = 0xffffffffu;

// kept per (device, stream) by the wrapper, zeroed once when it is made
struct Workspace {
  double partials[kMaxBlocks];  // one per block of a launch
  unsigned int ticket;          // blocks finished; 0 between launches
};

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

__device__ __forceinline__ uint32_t sign_bit(float v) { return __float_as_uint(v) >> 31; }

__device__ __forceinline__ uint32_t sign_nibble(float4 v) {
  return sign_bit(v.x) | sign_bit(v.y) << 1 | sign_bit(v.z) << 2 | sign_bit(v.w) << 3;
}

// The four elements of the aligned frame at e, one by one: x[e - s] where
// s <= e < end, +0.0 elsewhere (a clear bit, adds 0 to the scale).
__device__ __forceinline__ float4 load_edge(const float* __restrict__ x, long long e,
                                            int s, long long end) {
  float f[4];
#pragma unroll
  for (int b = 0; b < 4; ++b) f[b] = e + b >= s && e + b < end ? x[e + b - s] : 0.0f;
  return make_float4(f[0], f[1], f[2], f[3]);
}

// x: n floats starting s elements (0..3) past a 16-byte boundary.  The
// aligned frame counts elements from that boundary: element e is x[e - s],
// and the frame's chunk c holds its elements [1024c, 1024c + 1024).
__global__ void __launch_bounds__(kThreads)
onebit_pack_kernel(const float* __restrict__ x, long long n, int s, long long nwords,
                   int scaling, float* __restrict__ scale,
                   uint32_t* __restrict__ words, Workspace* __restrict__ ws) {
  __shared__ double smem[kWarps];
  __shared__ bool last;
  const int lane = threadIdx.x & 31;
  const long long end = n + s;  // x's end in the aligned frame
  const long long nchunks = (end + kChunk - 1) / kChunk;
  const long long first = (long long)blockIdx.x * kWarps + (threadIdx.x >> 5);
  const long long stride = (long long)gridDim.x * kWarps;
  double acc = 0.0;
  // every lane of a warp runs the same iterations: the shuffles see all 32
  for (long long c = first; c < nchunks; c += stride) {
    const long long base = c * kChunk;
    float4 v[kVecs];
    if (base >= s && base + kChunk <= end) {
      const float4* p = reinterpret_cast<const float4*>(x + (base - s)) + lane;
#pragma unroll
      for (int j = 0; j < kVecs; ++j) v[j] = __ldcs(p + 32 * j);
    } else {  // the chunk holding x's start or its end
#pragma unroll
      for (int j = 0; j < kVecs; ++j) v[j] = load_edge(x, base + 128 * j + 4 * lane, s, end);
    }
    uint32_t mine = 0;  // the frame's word 32c + lane
#pragma unroll
    for (int j = 0; j < kVecs; ++j) {
      acc += fabs((double)v[j].x);
      acc += fabs((double)v[j].y);
      acc += fabs((double)v[j].z);
      acc += fabs((double)v[j].w);
      uint32_t part = sign_nibble(v[j]) << (4 * (lane & 7));
      part |= __shfl_xor_sync(kFull, part, 1);
      part |= __shfl_xor_sync(kFull, part, 2);
      part |= __shfl_xor_sync(kFull, part, 4);
      // lanes 8q..8q+7 now hold the chunk's word 4j + q
      const uint32_t word = __shfl_sync(kFull, part, (lane & 3) * 8);
      if ((lane >> 2) == j) mine = word;
    }
    if (s != 0) {  // x's word w: the frame's words w and w + 1, shifted by s
      uint32_t next = __shfl_down_sync(kFull, mine, 1);
      if (lane == 31) {  // the frame's word 32c + 32 starts the next chunk
        next = 0;
        for (int b = 0; b < s; ++b) {
          const long long e = base + kChunk + b;
          if (e < end) next |= sign_bit(x[e - s]) << b;
        }
      }
      mine = mine >> s | next << (32 - s);
    }
    const long long w = c * 32 + lane;
    if (w < nwords) words[w] = mine;
  }
  acc = block_sum(acc, smem);
  if (threadIdx.x == 0) {
    ws->partials[blockIdx.x] = acc;
    // release: the partial is visible to every block before the ticket is;
    // acquire: the last block then sees every partial
    cuda::atomic_ref<unsigned int, cuda::thread_scope_device> ticket(ws->ticket);
    last = ticket.fetch_add(1u, cuda::memory_order_acq_rel) == gridDim.x - 1;
  }
  __syncthreads();  // also: warp 0's reads of smem are done before it is reused
  if (!last) return;
  // the last block: every partial is in, summed in a fixed order and tree
  acc = 0.0;
  for (int i = threadIdx.x; i < (int)gridDim.x; i += kThreads) acc += __ldcg(&ws->partials[i]);
  acc = block_sum(acc, smem);
  if (threadIdx.x == 0) {
    *scale = scaling ? (float)(acc / (double)n) : 1.0f;
    ws->ticket = 0u;  // ready for the next launch on this stream
  }
}

}  // namespace

extern "C" {

// Pack n floats at x (4-byte aligned) into the payload at out (4 +
// 4*ceil(n/32) bytes, 4-byte aligned) in one launch of nblocks blocks (at
// most kMaxBlocks).  workspace: sizeof(Workspace) bytes, zeroed before the
// first launch, used by no other stream.  Returns the cudaError_t of the
// launch (0 = it was accepted); nothing is synchronised.
int bps_onebit_pack(const void* x, long long n, int scaling, void* out,
                    void* workspace, int nblocks, void* stream) {
  if (n <= 0 || nblocks <= 0 || nblocks > kMaxBlocks || ((uintptr_t)x & 3) != 0) {
    return (int)cudaErrorInvalidValue;
  }
  const int s = (int)(((uintptr_t)x & 15) / 4);
  onebit_pack_kernel<<<nblocks, kThreads, 0, (cudaStream_t)stream>>>(
      (const float*)x, n, s, (n + 31) / 32, scaling, (float*)out,
      (uint32_t*)((char*)out + 4), (Workspace*)workspace);
  return (int)cudaGetLastError();
}

// Bytes of the workspace bps_onebit_pack takes.
long long bps_onebit_workspace_bytes(void) { return (long long)sizeof(Workspace); }

}  // extern "C"
