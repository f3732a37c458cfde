// Flash attention for Hopper (sm_90a): the forward kernel and the two
// backward kernels (dQ, and dK/dV), with a plain C interface for ctypes.
//
// Replaces the Pallas kernels of byteps_tpu/ops/flash_attention.py:
//   hop::flash_fwd_wgmma, flash_fwd_*         <- _fwd_kernel_factory      (K1)
//   hop::flash_bwd_dq_wgmma, flash_bwd_dq_*   <- _bwd_dq_kernel_factory   (K2)
//   hop::flash_bwd_dkv_wgmma, flash_bwd_dkv_* <- _bwd_dkv_kernel_factory  (K3)
//
// Layout: q, k, v, o, dO, dQ, dK, dV are (BH, S, DH) row-major in float or
// bf16; lse and delta are (BH, S) float.  Softmax statistics, exponentials
// and every accumulator are f32.  The sequential grid axis of the Pallas
// kernels becomes a loop inside a block; rows past S read as zero and
// their scores are masked, so a ragged last tile runs here and every S
// takes a kernel; causal tiles that are fully masked are skipped.  No
// S x S intermediate reaches device memory.
//
// K1 for bf16 and dh = 64 (the head dim of BERT-large and GPT-2 medium,
// the training path): hop::flash_fwd_wgmma.  What bounds it: at B = 32,
// H = 16, S = 512 it must move 135 MB (q, k, v read once, O and lse
// written once), 0.0404 ms at 3.35 TB/s, and do 34.4 GFLOP, 0.0347 ms at
// 989 TFLOP/s: bytes bind, by a little, so the memory and the tensor
// cores both have to be kept busy, and the exponentials (one per score,
// on the 16-a-clock MUFU units of each SM) take about as long as the
// products.  The design:
//   1. S = Q K^T runs as wgmma (m64nBNk16) with both operands K-major in
//      shared memory.
//   2. The online softmax stays in the accumulator registers: a row lives
//      in the 4 lanes of a quad, so its max is two shuffles and its sum is
//      kept per thread and reduced once at the end; exp2 with scale log2(e)
//      folded into one FMA; m in log2 units, lse = (m + log2 l) ln 2.
//   3. O += P V runs as wgmma with A from registers: the S accumulator,
//      rounded to bf16 pairs, is wgmma's A layout k16 slice by k16 slice;
//      V is B, MN-major (transposed).  O stays in registers for the whole
//      K/V loop.  Neither S nor P nor O goes through shared memory.
//   4. TMA brings Q and K/V tiles under mbarriers with the 128-byte swizzle
//      (a 64-wide bf16 row is one swizzle atom; the wgmma descriptors use
//      the same mode), through 3-D tensor maps (dh, S, BH): rows past S
//      arrive as zeros and never reach the next head.  The maps are encoded
//      per call, with cuTensorMapEncodeTiled (a libcuda function) looked up
//      through the runtime, so the library links the runtime alone, and
//      passed as __grid_constant__ parameters.
//   5. Warp specialisation: a producer warpgroup (one thread issues the
//      copies) keeps a ring of 3 K/V stages in flight; two consumer
//      warpgroups own 64 query rows each (128 a tile), and setmaxnreg moves
//      the producer's registers to them.
//   6. The fill is hidden two ways at once: a persistent grid of two blocks
//      per SM, each walking (bh, query block) tiles, with the ring running
//      on from one tile into the next (the next tile's Q, K and V load
//      while this tile's last products and epilogue run), and 64-row K/V
//      tiles so that two blocks' registers fit an SM (80 a thread at
//      launch, 104 for the consumers).  PERF.md keeps the times of the
//      layouts this one was chosen over (128-row K/V tiles, one block per
//      SM, one block per tile).
// bf16 K1 for dh = 32 and 128 keeps the WMMA kernel below (flash_fwd_bf16),
// by a static dispatch on dh: a given dh always takes the same kernel.
//
// K2 for bf16 and dh = 64: hop::flash_bwd_dq_wgmma.  What bounds it: at
// B = 32, H = 16, S = 512 it must do 51.5 GFLOP (three products), 0.0521 ms
// at 989 TFLOP/s, and move 170 MB (q, k, v, dO, lse, delta read once, dQ
// written once), 0.0507 ms at 3.35 TB/s: operations bind, by a hair, and
// the 134M exponentials (one per score, as in K1 and K3) take ~0.03 ms on
// the MUFU units.  The design:
//   1. S = Q K^T and dP = dO V^T run as wgmma with both operands K-major in
//      shared memory, as K1's S does; no transposed scores are needed.  P
//      and dS = P (dP - delta) stay in registers: rounded to bf16 pairs k16
//      slice by k16 slice, dS is wgmma's register A for dQ += dS K, with the
//      same K tile read again as B, MN-major.  dQ stays in registers across
//      the key tiles and is written once, in bf16.
//   2. lse and delta are a thread's own two rows in the accumulator layout,
//      so they come into four registers once a tile: no tensor map, and so
//      no alignment condition on them.
//   3. A block owns 128 query rows, 64 for each of two warpgroups, and its
//      threads need 126 registers (S, dP and dQ, 32 f32 each, and the packed
//      dS), so two blocks share an SM: one block's exponentials, dS
//      arithmetic and waits overlap the other's products.  Thread 0 issues
//      the TMA copies: Q and dO once, and the 64-row K/V tiles into a ring
//      of 3 stages one tile ahead of the products.  K1's and K3's layout, a
//      producer warpgroup whose registers go to the consumers (setmaxnreg),
//      leaves room for one block an SM, and was slower here, persistent or
//      not (PERF.md keeps the times).
//   4. A block per (bh, 128-row query block) tile; under a causal mask a
//      head's longest tile comes first.
//   5. No atomics (FlashAttention-3 adds dQ inside the dK/dV kernel with
//      them): each block owns its dQ rows, so two launches give the same
//      bits.
// bf16 K2 for dh = 32 and 128 keeps the WMMA kernel below
// (flash_bwd_dq_bf16), by the same static dispatch.
//
// K3 for bf16 and dh = 64: hop::flash_bwd_dkv_wgmma.  What bounds it: at
// B = 32, H = 16, S = 512 it must do 68.7 GFLOP (four products), 0.0695 ms
// at 989 TFLOP/s, and move 203 MB (q, k, v, dO, lse, delta read once, dK
// and dV written once), 0.0607 ms at 3.35 TB/s: operations bind, by a
// little, and the 134M exponentials (one per score, as in K1) take ~0.03
// ms on the MUFU units.  The design:
//   1. The scores are computed transposed, S^T = K Q^T and dP^T = V dO^T
//      (wgmma, both operands K-major in shared memory), so that P^T and
//      dS^T = P^T (dP^T - delta) come out in the accumulator layout, rows
//      = keys: rounded to bf16 pairs k16 slice by k16 slice they are
//      wgmma's register A for dV += P^T dO and dK += dS^T Q, with the same
//      dO and Q tiles read again as B, MN-major.  Neither P^T nor dS^T goes
//      through shared memory; dK and dV stay in registers across the query
//      tiles and are written once, in bf16.
//   2. A block owns 128 keys, 64 for each of two consumer warpgroups, and
//      streams 64-row query tiles past them.  A producer warpgroup (one
//      thread issues) brings K and V once a tile and keeps a ring of 3
//      (Q, dO, lse, delta) stages in flight; setmaxnreg gives the consumers
//      240 registers, which their dK, dV, S^T, dP^T (32 f32 each) and the
//      packed P^T and dS^T need, so one block runs on an SM.
//   3. lse and delta come by TMA too, through 1-D maps whose boxes start
//      16-byte aligned (TMA needs that; a head's rows at S = 127 are not),
//      so every S takes this kernel.
//   4. Non-causal: a persistent grid of one block per SM walks the (bh, key
//      tile) tiles with K and V double-buffered and the ring running on from
//      one tile into the next, which hides each tile's fill.  Causal tiles
//      are unequal (key tile k sees query tiles from 2k on), so there each
//      block takes one tile and the block scheduler balances them.
// A consumer warpgroup's exponentials and dS arithmetic do not overlap its
// own products, only the other warpgroup's; PERF.md keeps the times of the
// layouts this one was chosen over.  bf16 K3 for dh = 32 and 128 keeps the
// WMMA kernel below (flash_bwd_dkv_bf16), by the same static dispatch.
//
// K1, K2 and K3 for bf16 dh = 32 and 128: the products run on the tensor
// cores as 16x16x16 bf16 WMMA tiles (mma.sync) with f32 accumulators; one
// block of 4 warps per (bh, 64-row query block), or key block for dK/dV,
// each warp owning 16 rows.  Tiles are loaded synchronously; scores go
// through shared memory in f32 for the softmax; P and dS are rounded to
// bf16 for the second product, as the plain version's bf16 path would not,
// which is within the bf16 tolerance.
//
// f32 (all three): the products run on the FMA units in f32 (67 TFLOP/s),
// since TF32 or bf16 tiles would not hold the f32 tolerance; 8 warps, the
// rows that lanes read across are padded (stride dh + 1) so the loops are
// free of bank conflicts.  Bound by operations.

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>

#include <algorithm>
#include <cstdint>

namespace {

using namespace nvcuda;
using bf16 = __nv_bfloat16;

constexpr int BQ = 64;                 // query rows per tile
constexpr int BK = 64;                 // key rows per tile
constexpr float NEG_INF = -1e30f;

__device__ __forceinline__ float warp_max(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, o));
  return x;
}

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

// ===========================================================================
// f32 inputs: FMA kernels
// ===========================================================================

constexpr int NWARP = 8;
constexpr int NTHREAD = NWARP * 32;
constexpr int RW = BQ / NWARP;         // query rows per warp (K1, K2)
constexpr int KW = BK / NWARP;         // key rows per warp (K3)

// Rows [row0, row0 + 64) of a (S, DH) matrix into shared memory, times
// `mul`, with row stride `ld`; rows at or past S are zero.
template <int DH>
__device__ __forceinline__ void load_tile(float* dst, int ld, const float* __restrict__ src,
                                          int row0, int S, float mul) {
  for (int i = threadIdx.x; i < 64 * DH; i += NTHREAD) {
    const int r = i / DH, c = i % DH, gr = row0 + r;
    dst[r * ld + c] = gr < S ? src[(size_t)gr * DH + c] * mul : 0.f;
  }
}

// K1: O = softmax(Q K^T * scale) V and lse = m + log l, per (bh, q-block).
template <int DH>
__global__ void __launch_bounds__(NTHREAD)
flash_fwd_f32(const float* __restrict__ q, const float* __restrict__ k,
              const float* __restrict__ v, float* __restrict__ o, float* __restrict__ lse,
              int S, int causal, float scale) {
  constexpr int NC = DH / 32;          // output columns per lane
  constexpr int LDK = DH + 1;          // padded: lanes read across rows of K
  extern __shared__ float smem[];
  float* Qs = smem;                    // BQ x DH, pre-scaled
  float* Ks = Qs + BQ * DH;            // BK x LDK
  float* Vs = Ks + BK * LDK;           // BK x DH
  float* Ps = Vs + BK * DH;            // BQ x BK

  const int qb = blockIdx.x, bh = blockIdx.y;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int q0 = qb * BQ, wrow = warp * RW;
  const size_t base = (size_t)bh * S * DH;

  load_tile<DH>(Qs, DH, q + base, q0, S, scale);

  float m[RW], l[RW], acc[RW][NC];
#pragma unroll
  for (int r = 0; r < RW; ++r) {
    m[r] = NEG_INF;
    l[r] = 0.f;
#pragma unroll
    for (int j = 0; j < NC; ++j) acc[r][j] = 0.f;
  }

  const int nk = (S + BK - 1) / BK;
  const int kend = causal ? min(nk, qb + 1) : nk;   // later blocks are fully masked
  for (int kb = 0; kb < kend; ++kb) {
    __syncthreads();
    load_tile<DH>(Ks, LDK, k + base, kb * BK, S, 1.f);
    load_tile<DH>(Vs, DH, v + base, kb * BK, S, 1.f);
    __syncthreads();

    float s[RW][2];
#pragma unroll
    for (int r = 0; r < RW; ++r) s[r][0] = s[r][1] = 0.f;
#pragma unroll 8
    for (int d = 0; d < DH; ++d) {
      const float k0 = Ks[lane * LDK + d], k1 = Ks[(lane + 32) * LDK + d];
#pragma unroll
      for (int r = 0; r < RW; ++r) {
        const float qv = Qs[(wrow + r) * DH + d];
        s[r][0] = fmaf(qv, k0, s[r][0]);
        s[r][1] = fmaf(qv, k1, s[r][1]);
      }
    }

    const int c0 = kb * BK + lane, c1 = c0 + 32;
#pragma unroll
    for (int r = 0; r < RW; ++r) {
      const int row = q0 + wrow + r;
      const bool ok0 = c0 < S && (!causal || row >= c0);
      const bool ok1 = c1 < S && (!causal || row >= c1);
      const float mx = warp_max(fmaxf(ok0 ? s[r][0] : NEG_INF, ok1 ? s[r][1] : NEG_INF));
      const float m_new = fmaxf(m[r], mx);
      const float alpha = expf(m[r] - m_new);
      const float p0 = ok0 ? expf(s[r][0] - m_new) : 0.f;
      const float p1 = ok1 ? expf(s[r][1] - m_new) : 0.f;
      l[r] = l[r] * alpha + warp_sum(p0 + p1);
      m[r] = m_new;
#pragma unroll
      for (int j = 0; j < NC; ++j) acc[r][j] *= alpha;
      Ps[(wrow + r) * BK + lane] = p0;
      Ps[(wrow + r) * BK + lane + 32] = p1;
    }
    __syncwarp();

#pragma unroll 4
    for (int kk = 0; kk < BK; ++kk) {
      float vv[NC];
#pragma unroll
      for (int j = 0; j < NC; ++j) vv[j] = Vs[kk * DH + lane + 32 * j];
#pragma unroll
      for (int r = 0; r < RW; ++r) {
        const float p = Ps[(wrow + r) * BK + kk];
#pragma unroll
        for (int j = 0; j < NC; ++j) acc[r][j] = fmaf(p, vv[j], acc[r][j]);
      }
    }
  }

#pragma unroll
  for (int r = 0; r < RW; ++r) {
    const int row = q0 + wrow + r;
    if (row >= S) continue;
    const float ll = l[r] == 0.f ? 1.f : l[r];
    const float inv = 1.f / ll;
#pragma unroll
    for (int j = 0; j < NC; ++j) o[base + (size_t)row * DH + lane + 32 * j] = acc[r][j] * inv;
    if (lane == 0) lse[(size_t)bh * S + row] = m[r] + logf(ll);
  }
}

// K2: dQ = scale * dS K with P = exp(Q K^T * scale - lse), dS = P * (dO V^T - delta),
// per (bh, q-block).
template <int DH>
__global__ void __launch_bounds__(NTHREAD)
flash_bwd_dq_f32(const float* __restrict__ q, const float* __restrict__ k,
                 const float* __restrict__ v, const float* __restrict__ dout,
                 const float* __restrict__ lse, const float* __restrict__ delta,
                 float* __restrict__ dq, int S, int causal, float scale) {
  constexpr int NC = DH / 32;
  constexpr int LDK = DH + 1;
  extern __shared__ float smem[];
  float* Qs = smem;                    // BQ x DH
  float* Os = Qs + BQ * DH;            // BQ x DH (dO)
  float* Ks = Os + BQ * DH;            // BK x LDK
  float* Vs = Ks + BK * LDK;           // BK x LDK
  float* Ds = Vs + BK * LDK;           // BQ x BK (dS)

  const int qb = blockIdx.x, bh = blockIdx.y;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int q0 = qb * BQ, wrow = warp * RW;
  const size_t base = (size_t)bh * S * DH;

  load_tile<DH>(Qs, DH, q + base, q0, S, 1.f);
  load_tile<DH>(Os, DH, dout + base, q0, S, 1.f);

  float lse_r[RW], delta_r[RW], acc[RW][NC];
#pragma unroll
  for (int r = 0; r < RW; ++r) {
    const int row = q0 + wrow + r;
    lse_r[r] = row < S ? lse[(size_t)bh * S + row] : 0.f;
    delta_r[r] = row < S ? delta[(size_t)bh * S + row] : 0.f;
#pragma unroll
    for (int j = 0; j < NC; ++j) acc[r][j] = 0.f;
  }

  const int nk = (S + BK - 1) / BK;
  const int kend = causal ? min(nk, qb + 1) : nk;
  for (int kb = 0; kb < kend; ++kb) {
    __syncthreads();
    load_tile<DH>(Ks, LDK, k + base, kb * BK, S, 1.f);
    load_tile<DH>(Vs, LDK, v + base, kb * BK, S, 1.f);
    __syncthreads();

    float s[RW][2], dp[RW][2];
#pragma unroll
    for (int r = 0; r < RW; ++r) s[r][0] = s[r][1] = dp[r][0] = dp[r][1] = 0.f;
#pragma unroll 4
    for (int d = 0; d < DH; ++d) {
      const float k0 = Ks[lane * LDK + d], k1 = Ks[(lane + 32) * LDK + d];
      const float v0 = Vs[lane * LDK + d], v1 = Vs[(lane + 32) * LDK + d];
#pragma unroll
      for (int r = 0; r < RW; ++r) {
        const float qv = Qs[(wrow + r) * DH + d], ov = Os[(wrow + r) * DH + d];
        s[r][0] = fmaf(qv, k0, s[r][0]);
        s[r][1] = fmaf(qv, k1, s[r][1]);
        dp[r][0] = fmaf(ov, v0, dp[r][0]);
        dp[r][1] = fmaf(ov, v1, dp[r][1]);
      }
    }

    const int c0 = kb * BK + lane, c1 = c0 + 32;
#pragma unroll
    for (int r = 0; r < RW; ++r) {
      const int row = q0 + wrow + r;
      const bool ok0 = c0 < S && (!causal || row >= c0);
      const bool ok1 = c1 < S && (!causal || row >= c1);
      const float p0 = ok0 ? expf(s[r][0] * scale - lse_r[r]) : 0.f;
      const float p1 = ok1 ? expf(s[r][1] * scale - lse_r[r]) : 0.f;
      Ds[(wrow + r) * BK + lane] = p0 * (dp[r][0] - delta_r[r]);
      Ds[(wrow + r) * BK + lane + 32] = p1 * (dp[r][1] - delta_r[r]);
    }
    __syncwarp();

#pragma unroll 4
    for (int kk = 0; kk < BK; ++kk) {
      float kv[NC];
#pragma unroll
      for (int j = 0; j < NC; ++j) kv[j] = Ks[kk * LDK + lane + 32 * j];
#pragma unroll
      for (int r = 0; r < RW; ++r) {
        const float ds = Ds[(wrow + r) * BK + kk];
#pragma unroll
        for (int j = 0; j < NC; ++j) acc[r][j] = fmaf(ds, kv[j], acc[r][j]);
      }
    }
  }

#pragma unroll
  for (int r = 0; r < RW; ++r) {
    const int row = q0 + wrow + r;
    if (row >= S) continue;
#pragma unroll
    for (int j = 0; j < NC; ++j) dq[base + (size_t)row * DH + lane + 32 * j] = acc[r][j] * scale;
  }
}

// K3: dV = P^T dO and dK = scale * dS^T Q, per (bh, k-block), streaming the
// query blocks that can see it.
template <int DH>
__global__ void __launch_bounds__(NTHREAD)
flash_bwd_dkv_f32(const float* __restrict__ q, const float* __restrict__ k,
                  const float* __restrict__ v, const float* __restrict__ dout,
                  const float* __restrict__ lse, const float* __restrict__ delta,
                  float* __restrict__ dk, float* __restrict__ dv, int S, int causal,
                  float scale) {
  constexpr int NC = DH / 32;
  constexpr int LDQ = DH + 1;          // padded: lanes read across rows of Q and dO
  extern __shared__ float smem[];
  float* Ks = smem;                    // BK x DH
  float* Vs = Ks + BK * DH;            // BK x DH
  float* Qs = Vs + BK * DH;            // BQ x LDQ
  float* Os = Qs + BQ * LDQ;           // BQ x LDQ (dO)
  float* Pt = Os + BQ * LDQ;           // BK x BQ (P transposed)
  float* Dt = Pt + BK * BQ;            // BK x BQ (dS transposed)
  float* Ls = Dt + BK * BQ;            // BQ (lse)
  float* Dl = Ls + BQ;                 // BQ (delta)

  const int kb = blockIdx.x, bh = blockIdx.y;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int k0 = kb * BK, wkey = warp * KW;
  const size_t base = (size_t)bh * S * DH;

  load_tile<DH>(Ks, DH, k + base, k0, S, 1.f);
  load_tile<DH>(Vs, DH, v + base, k0, S, 1.f);

  float dka[KW][NC], dva[KW][NC];
#pragma unroll
  for (int kk = 0; kk < KW; ++kk)
#pragma unroll
    for (int j = 0; j < NC; ++j) dka[kk][j] = dva[kk][j] = 0.f;

  const int nq = (S + BQ - 1) / BQ;
  // with BQ == BK, query block qb sees key block kb iff qb >= kb
  for (int qb = causal ? kb : 0; qb < nq; ++qb) {
    const int q0 = qb * BQ;
    __syncthreads();
    load_tile<DH>(Qs, LDQ, q + base, q0, S, 1.f);
    load_tile<DH>(Os, LDQ, dout + base, q0, S, 1.f);
    if (threadIdx.x < BQ) {
      const int row = q0 + threadIdx.x;
      Ls[threadIdx.x] = row < S ? lse[(size_t)bh * S + row] : 0.f;
      Dl[threadIdx.x] = row < S ? delta[(size_t)bh * S + row] : 0.f;
    }
    __syncthreads();

    float s[KW][2], dp[KW][2];
#pragma unroll
    for (int kk = 0; kk < KW; ++kk) s[kk][0] = s[kk][1] = dp[kk][0] = dp[kk][1] = 0.f;
#pragma unroll 4
    for (int d = 0; d < DH; ++d) {
      const float qa = Qs[lane * LDQ + d], qc = Qs[(lane + 32) * LDQ + d];
      const float oa = Os[lane * LDQ + d], oc = Os[(lane + 32) * LDQ + d];
#pragma unroll
      for (int kk = 0; kk < KW; ++kk) {
        const float kv = Ks[(wkey + kk) * DH + d], vv = Vs[(wkey + kk) * DH + d];
        s[kk][0] = fmaf(qa, kv, s[kk][0]);
        s[kk][1] = fmaf(qc, kv, s[kk][1]);
        dp[kk][0] = fmaf(oa, vv, dp[kk][0]);
        dp[kk][1] = fmaf(oc, vv, dp[kk][1]);
      }
    }

    const int r0 = q0 + lane, r1 = r0 + 32;
#pragma unroll
    for (int kk = 0; kk < KW; ++kk) {
      const int key = k0 + wkey + kk;
      const bool ok0 = r0 < S && key < S && (!causal || r0 >= key);
      const bool ok1 = r1 < S && key < S && (!causal || r1 >= key);
      const float p0 = ok0 ? expf(s[kk][0] * scale - Ls[lane]) : 0.f;
      const float p1 = ok1 ? expf(s[kk][1] * scale - Ls[lane + 32]) : 0.f;
      Pt[(wkey + kk) * BQ + lane] = p0;
      Pt[(wkey + kk) * BQ + lane + 32] = p1;
      Dt[(wkey + kk) * BQ + lane] = p0 * (dp[kk][0] - Dl[lane]);
      Dt[(wkey + kk) * BQ + lane + 32] = p1 * (dp[kk][1] - Dl[lane + 32]);
    }
    __syncwarp();

#pragma unroll 2
    for (int rr = 0; rr < BQ; ++rr) {
      float ov[NC], qv[NC];
#pragma unroll
      for (int j = 0; j < NC; ++j) {
        ov[j] = Os[rr * LDQ + lane + 32 * j];
        qv[j] = Qs[rr * LDQ + lane + 32 * j];
      }
#pragma unroll
      for (int kk = 0; kk < KW; ++kk) {
        const float p = Pt[(wkey + kk) * BQ + rr], ds = Dt[(wkey + kk) * BQ + rr];
#pragma unroll
        for (int j = 0; j < NC; ++j) {
          dva[kk][j] = fmaf(p, ov[j], dva[kk][j]);
          dka[kk][j] = fmaf(ds, qv[j], dka[kk][j]);
        }
      }
    }
  }

#pragma unroll
  for (int kk = 0; kk < KW; ++kk) {
    const int key = k0 + wkey + kk;
    if (key >= S) continue;
#pragma unroll
    for (int j = 0; j < NC; ++j) {
      const size_t at = base + (size_t)key * DH + lane + 32 * j;
      dk[at] = dka[kk][j] * scale;
      dv[at] = dva[kk][j];
    }
  }
}

// ===========================================================================
// bf16 inputs: tensor-core (WMMA) kernels
// ===========================================================================

constexpr int TC_WARPS = 4;
constexpr int TC_THREADS = TC_WARPS * 32;
constexpr int TR = BQ / TC_WARPS;      // rows of the block each warp owns (16)

using FragA = wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major>;
using FragBCol = wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::col_major>;
using FragBRow = wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major>;
using FragC = wmma::fragment<wmma::accumulator, 16, 16, 16, float>;

// Shared-memory tiles: 64 rows each.  Row strides are padded (8 bf16 or 4
// floats) against bank conflicts and keep every 16-row fragment 32-byte
// aligned, as WMMA needs.
template <int DH>
struct Tc {
  static constexpr int LDH = DH + 8;                   // bf16, 64 x DH (Q, K, V, dO)
  static constexpr int LDP = BK + 8;                   // bf16, 64 x 64 (P, dS)
  static constexpr int LDF = (DH > BK ? DH : BK) + 4;  // f32, scores and staging
  static constexpr int H = 64 * LDH * 2;               // bytes of each
  static constexpr int P = 64 * LDP * 2;
  static constexpr int F = 64 * LDF * 4;
};

// Rows [row0, row0 + 64) of a (S, DH) bf16 matrix into shared memory, 16
// bytes a thread; rows at or past S are zero.
template <int DH>
__device__ __forceinline__ void load_tile_bf16(bf16* dst, const bf16* __restrict__ src,
                                               int row0, int S) {
  constexpr int V = DH / 8;
  for (int i = threadIdx.x; i < 64 * V; i += TC_THREADS) {
    const int r = i / V, c = i % V, gr = row0 + r;
    uint4 x = make_uint4(0u, 0u, 0u, 0u);
    if (gr < S) x = reinterpret_cast<const uint4*>(src + (size_t)gr * DH)[c];
    *reinterpret_cast<uint4*>(dst + r * Tc<DH>::LDH + c * 8) = x;
  }
}

// Out[16 x 64] = A[16 x DH] B^T, B given as 64 rows of DH (ld LDH): the
// scores of a warp's 16 rows against a 64-row tile, into f32 `out`.
template <int DH>
__device__ __forceinline__ void scores_16x64(float* out, const FragA (&a)[DH / 16],
                                             const bf16* b) {
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    FragC c;
    wmma::fill_fragment(c, 0.f);
#pragma unroll
    for (int kk = 0; kk < DH / 16; ++kk) {
      FragBCol bt;
      wmma::load_matrix_sync(bt, b + 16 * j * Tc<DH>::LDH + 16 * kk, Tc<DH>::LDH);
      wmma::mma_sync(c, a[kk], bt, c);
    }
    wmma::store_matrix_sync(out + 16 * j, c, Tc<DH>::LDF, wmma::mem_row_major);
  }
}

// acc[j] += A[16 x 64] B[64 x DH]: A bf16 (ld LDP), B bf16 rows (ld LDH).
template <int DH>
__device__ __forceinline__ void accumulate_16xdh(FragC (&acc)[DH / 16], const bf16* a,
                                                 const bf16* b) {
#pragma unroll
  for (int kk = 0; kk < BK / 16; ++kk) {
    FragA af;
    wmma::load_matrix_sync(af, a + 16 * kk, Tc<DH>::LDP);
#pragma unroll
    for (int j = 0; j < DH / 16; ++j) {
      FragBRow bf;
      wmma::load_matrix_sync(bf, b + 16 * kk * Tc<DH>::LDH + 16 * j, Tc<DH>::LDH);
      wmma::mma_sync(acc[j], af, bf, acc[j]);
    }
  }
}

// A warp's 16 x DH accumulator, times `mul`, to rows [row, row + 16) of a
// (S, DH) bf16 output, staged through the warp's rows of `stage` (f32).
template <int DH>
__device__ __forceinline__ void store_rows(bf16* __restrict__ out, float* stage,
                                           FragC (&acc)[DH / 16], int row, int S,
                                           float mul, int lane) {
#pragma unroll
  for (int j = 0; j < DH / 16; ++j)
    wmma::store_matrix_sync(stage + 16 * j, acc[j], Tc<DH>::LDF, wmma::mem_row_major);
  __syncwarp();
  for (int r = 0; r < TR; ++r) {
    if (row + r >= S) break;
    for (int c = lane; c < DH; c += 32)
      out[(size_t)(row + r) * DH + c] = __float2bfloat16(stage[r * Tc<DH>::LDF + c] * mul);
  }
  __syncwarp();
}

// K1 on the tensor cores for bf16 dh = 32 and 128 (dh = 64 takes
// hop::flash_fwd_wgmma).  O's running sum lives in shared memory (f32),
// where the online-softmax rescale can reach it row by row.
template <int DH>
__global__ void __launch_bounds__(TC_THREADS)
flash_fwd_bf16(const bf16* __restrict__ q, const bf16* __restrict__ k,
               const bf16* __restrict__ v, bf16* __restrict__ o, float* __restrict__ lse,
               int S, int causal, float scale) {
  using L = Tc<DH>;
  extern __shared__ __align__(128) unsigned char tc_smem[];
  bf16* Qs = reinterpret_cast<bf16*>(tc_smem);
  bf16* Ks = reinterpret_cast<bf16*>(tc_smem + L::H);
  bf16* Vs = reinterpret_cast<bf16*>(tc_smem + 2 * L::H);
  bf16* Ps = reinterpret_cast<bf16*>(tc_smem + 3 * L::H);
  float* Ss = reinterpret_cast<float*>(tc_smem + 3 * L::H + L::P);
  float* Os = reinterpret_cast<float*>(tc_smem + 3 * L::H + L::P + L::F);

  const int qb = blockIdx.x, bh = blockIdx.y;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int q0 = qb * BQ, w0 = warp * TR;
  const size_t base = (size_t)bh * S * DH;
  float* Sw = Ss + w0 * L::LDF;        // this warp's rows
  float* Ow = Os + w0 * L::LDF;
  bf16* Pw = Ps + w0 * L::LDP;

  load_tile_bf16<DH>(Qs, q + base, q0, S);
  for (int i = lane; i < TR * DH; i += 32) Ow[(i / DH) * L::LDF + i % DH] = 0.f;
  __syncthreads();
  FragA qf[DH / 16];
#pragma unroll
  for (int kk = 0; kk < DH / 16; ++kk)
    wmma::load_matrix_sync(qf[kk], Qs + w0 * L::LDH + 16 * kk, L::LDH);

  float m[TR], l[TR];
#pragma unroll
  for (int r = 0; r < TR; ++r) {
    m[r] = NEG_INF;
    l[r] = 0.f;
  }

  const int nk = (S + BK - 1) / BK;
  const int kend = causal ? min(nk, qb + 1) : nk;   // later blocks are fully masked
  for (int kb = 0; kb < kend; ++kb) {
    __syncthreads();
    load_tile_bf16<DH>(Ks, k + base, kb * BK, S);
    load_tile_bf16<DH>(Vs, v + base, kb * BK, S);
    __syncthreads();

    scores_16x64<DH>(Sw, qf, Ks);
    __syncwarp();

    const int c0 = kb * BK + lane, c1 = c0 + 32;
#pragma unroll
    for (int r = 0; r < TR; ++r) {
      const int row = q0 + w0 + r;
      const float s0 = Sw[r * L::LDF + lane] * scale, s1 = Sw[r * L::LDF + lane + 32] * scale;
      const bool ok0 = c0 < S && (!causal || row >= c0);
      const bool ok1 = c1 < S && (!causal || row >= c1);
      const float mx = warp_max(fmaxf(ok0 ? s0 : NEG_INF, ok1 ? s1 : NEG_INF));
      const float m_new = fmaxf(m[r], mx);
      const float alpha = expf(m[r] - m_new);
      const float p0 = ok0 ? expf(s0 - m_new) : 0.f;
      const float p1 = ok1 ? expf(s1 - m_new) : 0.f;
      l[r] = l[r] * alpha + warp_sum(p0 + p1);
      m[r] = m_new;
      Pw[r * L::LDP + lane] = __float2bfloat16(p0);
      Pw[r * L::LDP + lane + 32] = __float2bfloat16(p1);
      for (int c = lane; c < DH; c += 32) Ow[r * L::LDF + c] *= alpha;
    }
    __syncwarp();

    FragC acc[DH / 16];
#pragma unroll
    for (int j = 0; j < DH / 16; ++j)
      wmma::load_matrix_sync(acc[j], Ow + 16 * j, L::LDF, wmma::mem_row_major);
    accumulate_16xdh<DH>(acc, Pw, Vs);
#pragma unroll
    for (int j = 0; j < DH / 16; ++j)
      wmma::store_matrix_sync(Ow + 16 * j, acc[j], L::LDF, wmma::mem_row_major);
    __syncwarp();
  }

#pragma unroll
  for (int r = 0; r < TR; ++r) {
    const int row = q0 + w0 + r;
    if (row >= S) break;
    const float ll = l[r] == 0.f ? 1.f : l[r];
    const float inv = 1.f / ll;
    for (int c = lane; c < DH; c += 32)
      o[base + (size_t)row * DH + c] = __float2bfloat16(Ow[r * L::LDF + c] * inv);
    if (lane == 0) lse[(size_t)bh * S + row] = m[r] + logf(ll);
  }
}

// K2 on the tensor cores for bf16 dh = 32 and 128 (dh = 64 takes
// hop::flash_bwd_dq_wgmma); dQ accumulates in registers across key blocks.
template <int DH>
__global__ void __launch_bounds__(TC_THREADS)
flash_bwd_dq_bf16(const bf16* __restrict__ q, const bf16* __restrict__ k,
                  const bf16* __restrict__ v, const bf16* __restrict__ dout,
                  const float* __restrict__ lse, const float* __restrict__ delta,
                  bf16* __restrict__ dq, int S, int causal, float scale) {
  using L = Tc<DH>;
  extern __shared__ __align__(128) unsigned char tc_smem[];
  bf16* Qs = reinterpret_cast<bf16*>(tc_smem);
  bf16* Os = reinterpret_cast<bf16*>(tc_smem + L::H);   // dO
  bf16* Ks = reinterpret_cast<bf16*>(tc_smem + 2 * L::H);
  bf16* Vs = reinterpret_cast<bf16*>(tc_smem + 3 * L::H);
  bf16* Ds = reinterpret_cast<bf16*>(tc_smem + 4 * L::H);
  float* Ss = reinterpret_cast<float*>(tc_smem + 4 * L::H + L::P);
  float* Ps = reinterpret_cast<float*>(tc_smem + 4 * L::H + L::P + L::F);   // dP

  const int qb = blockIdx.x, bh = blockIdx.y;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int q0 = qb * BQ, w0 = warp * TR;
  const size_t base = (size_t)bh * S * DH;
  float* Sw = Ss + w0 * L::LDF;
  float* DPw = Ps + w0 * L::LDF;
  bf16* Dw = Ds + w0 * L::LDP;

  load_tile_bf16<DH>(Qs, q + base, q0, S);
  load_tile_bf16<DH>(Os, dout + base, q0, S);
  __syncthreads();
  FragA qf[DH / 16], of[DH / 16];
#pragma unroll
  for (int kk = 0; kk < DH / 16; ++kk) {
    wmma::load_matrix_sync(qf[kk], Qs + w0 * L::LDH + 16 * kk, L::LDH);
    wmma::load_matrix_sync(of[kk], Os + w0 * L::LDH + 16 * kk, L::LDH);
  }
  float lse_r[TR], delta_r[TR];
#pragma unroll
  for (int r = 0; r < TR; ++r) {
    const int row = q0 + w0 + r;
    lse_r[r] = row < S ? lse[(size_t)bh * S + row] : 0.f;
    delta_r[r] = row < S ? delta[(size_t)bh * S + row] : 0.f;
  }
  FragC acc[DH / 16];
#pragma unroll
  for (int j = 0; j < DH / 16; ++j) wmma::fill_fragment(acc[j], 0.f);

  const int nk = (S + BK - 1) / BK;
  const int kend = causal ? min(nk, qb + 1) : nk;
  for (int kb = 0; kb < kend; ++kb) {
    __syncthreads();
    load_tile_bf16<DH>(Ks, k + base, kb * BK, S);
    load_tile_bf16<DH>(Vs, v + base, kb * BK, S);
    __syncthreads();

    scores_16x64<DH>(Sw, qf, Ks);
    scores_16x64<DH>(DPw, of, Vs);
    __syncwarp();

    const int c0 = kb * BK + lane, c1 = c0 + 32;
#pragma unroll
    for (int r = 0; r < TR; ++r) {
      const int row = q0 + w0 + r;
      const bool ok0 = c0 < S && (!causal || row >= c0);
      const bool ok1 = c1 < S && (!causal || row >= c1);
      const float p0 = ok0 ? expf(Sw[r * L::LDF + lane] * scale - lse_r[r]) : 0.f;
      const float p1 = ok1 ? expf(Sw[r * L::LDF + lane + 32] * scale - lse_r[r]) : 0.f;
      Dw[r * L::LDP + lane] = __float2bfloat16(p0 * (DPw[r * L::LDF + lane] - delta_r[r]));
      Dw[r * L::LDP + lane + 32] =
          __float2bfloat16(p1 * (DPw[r * L::LDF + lane + 32] - delta_r[r]));
    }
    __syncwarp();

    accumulate_16xdh<DH>(acc, Dw, Ks);
  }

  store_rows<DH>(dq + base, Sw, acc, q0 + w0, S, scale, lane);
}

// K3 on the tensor cores, per (bh, k-block): each warp owns 16 keys and
// works with transposed scores (keys x queries); dK and dV accumulate in
// registers across query blocks.
template <int DH>
__global__ void __launch_bounds__(TC_THREADS)
flash_bwd_dkv_bf16(const bf16* __restrict__ q, const bf16* __restrict__ k,
                   const bf16* __restrict__ v, const bf16* __restrict__ dout,
                   const float* __restrict__ lse, const float* __restrict__ delta,
                   bf16* __restrict__ dk, bf16* __restrict__ dv, int S, int causal,
                   float scale) {
  using L = Tc<DH>;
  extern __shared__ __align__(128) unsigned char tc_smem[];
  bf16* Ks = reinterpret_cast<bf16*>(tc_smem);
  bf16* Vs = reinterpret_cast<bf16*>(tc_smem + L::H);
  bf16* Qs = reinterpret_cast<bf16*>(tc_smem + 2 * L::H);
  bf16* Os = reinterpret_cast<bf16*>(tc_smem + 3 * L::H);   // dO
  bf16* Pt = reinterpret_cast<bf16*>(tc_smem + 4 * L::H);   // P^T
  bf16* Dt = reinterpret_cast<bf16*>(tc_smem + 4 * L::H + L::P);   // dS^T
  float* St = reinterpret_cast<float*>(tc_smem + 4 * L::H + 2 * L::P);
  float* DPt = reinterpret_cast<float*>(tc_smem + 4 * L::H + 2 * L::P + L::F);
  float* Ls = reinterpret_cast<float*>(tc_smem + 4 * L::H + 2 * L::P + 2 * L::F);
  float* Dl = Ls + BQ;

  const int kb = blockIdx.x, bh = blockIdx.y;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int k0 = kb * BK, w0 = warp * TR;
  const size_t base = (size_t)bh * S * DH;
  float* Sw = St + w0 * L::LDF;
  float* DPw = DPt + w0 * L::LDF;
  bf16* Pw = Pt + w0 * L::LDP;
  bf16* Dw = Dt + w0 * L::LDP;

  load_tile_bf16<DH>(Ks, k + base, k0, S);
  load_tile_bf16<DH>(Vs, v + base, k0, S);
  __syncthreads();
  FragA kf[DH / 16], vf[DH / 16];
#pragma unroll
  for (int kk = 0; kk < DH / 16; ++kk) {
    wmma::load_matrix_sync(kf[kk], Ks + w0 * L::LDH + 16 * kk, L::LDH);
    wmma::load_matrix_sync(vf[kk], Vs + w0 * L::LDH + 16 * kk, L::LDH);
  }
  FragC dka[DH / 16], dva[DH / 16];
#pragma unroll
  for (int j = 0; j < DH / 16; ++j) {
    wmma::fill_fragment(dka[j], 0.f);
    wmma::fill_fragment(dva[j], 0.f);
  }

  const int nq = (S + BQ - 1) / BQ;
  // with BQ == BK, query block qb sees key block kb iff qb >= kb
  for (int qb = causal ? kb : 0; qb < nq; ++qb) {
    const int q0 = qb * BQ;
    __syncthreads();
    load_tile_bf16<DH>(Qs, q + base, q0, S);
    load_tile_bf16<DH>(Os, dout + base, q0, S);
    if (threadIdx.x < BQ) {
      const int row = q0 + threadIdx.x;
      Ls[threadIdx.x] = row < S ? lse[(size_t)bh * S + row] : 0.f;
      Dl[threadIdx.x] = row < S ? delta[(size_t)bh * S + row] : 0.f;
    }
    __syncthreads();

    scores_16x64<DH>(Sw, kf, Qs);      // S^T: this warp's keys x 64 queries
    scores_16x64<DH>(DPw, vf, Os);     // dP^T
    __syncwarp();

    const int r0 = q0 + lane, r1 = r0 + 32;
#pragma unroll
    for (int r = 0; r < TR; ++r) {
      const int key = k0 + w0 + r;
      const bool ok0 = r0 < S && key < S && (!causal || r0 >= key);
      const bool ok1 = r1 < S && key < S && (!causal || r1 >= key);
      const float p0 = ok0 ? expf(Sw[r * L::LDF + lane] * scale - Ls[lane]) : 0.f;
      const float p1 = ok1 ? expf(Sw[r * L::LDF + lane + 32] * scale - Ls[lane + 32]) : 0.f;
      Pw[r * L::LDP + lane] = __float2bfloat16(p0);
      Pw[r * L::LDP + lane + 32] = __float2bfloat16(p1);
      Dw[r * L::LDP + lane] = __float2bfloat16(p0 * (DPw[r * L::LDF + lane] - Dl[lane]));
      Dw[r * L::LDP + lane + 32] =
          __float2bfloat16(p1 * (DPw[r * L::LDF + lane + 32] - Dl[lane + 32]));
    }
    __syncwarp();

    accumulate_16xdh<DH>(dva, Pw, Os);
    accumulate_16xdh<DH>(dka, Dw, Qs);
  }

  store_rows<DH>(dk + base, Sw, dka, k0 + w0, S, scale, lane);
  store_rows<DH>(dv + base, Sw, dva, k0 + w0, S, 1.f, lane);
}

template <typename Kernel>
cudaError_t set_smem(Kernel kernel, size_t bytes) {
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
}

// ===========================================================================
// bf16, dh = 64: K1 on wgmma, its tiles brought by TMA
// ===========================================================================

namespace hop {

constexpr int DH = 64;
constexpr int ROW = DH * 2;            // bytes of a row: one 128-byte swizzle atom
constexpr int BM = 128;                // query rows per block, 64 per consumer warpgroup
constexpr float LN2 = 0.6931471805599453f;
constexpr float LOG2E = 1.4426950408889634f;

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(bar), "r"(count) : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(bar), "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];" ::"r"(bar) : "memory");
}

__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done;
  do {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
  } while (!done);
}

// Rows [row, row + box rows) of head bh into shared memory at dst; rows at
// or past S arrive as zeros.  Completion is counted on the mbarrier.
__device__ __forceinline__ void tma_rows(uint32_t dst, const CUtensorMap* map, uint32_t bar,
                                         int row, int bh) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%2, %3, %4}], [%5];"
      ::"r"(dst), "l"(reinterpret_cast<uint64_t>(map)), "r"(0), "r"(row), "r"(bh), "r"(bar)
      : "memory");
}

// wgmma shared-memory descriptor, 128-byte swizzle; tiles are 1024-byte
// aligned, so the base offset is 0.
__device__ __forceinline__ uint64_t desc_sw128(uint32_t addr, uint32_t lbo, uint32_t sbo) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) |
         (static_cast<uint64_t>(lbo >> 4) << 16) | (static_cast<uint64_t>(sbo >> 4) << 32) |
         (1ull << 62);
}

// A box of consecutive floats from element `at` (a multiple of 4: the box
// must start 16-byte aligned) of a 1-D map into shared memory at dst;
// elements past the end arrive as zeros.
__device__ __forceinline__ void tma_vec(uint32_t dst, const CUtensorMap* map, uint32_t bar,
                                        int at) {
  asm volatile(
      "cp.async.bulk.tensor.1d.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%2}], [%3];"
      ::"r"(dst), "l"(reinterpret_cast<uint64_t>(map)), "r"(at), "r"(bar)
      : "memory");
}

__device__ __forceinline__ void wg_fence() { asm volatile("wgmma.fence.sync.aligned;" ::: "memory"); }
__device__ __forceinline__ void wg_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;" ::: "memory");
}
__device__ __forceinline__ void wg_wait0() {
  asm volatile("wgmma.wait_group.sync.aligned 0;" ::: "memory");
}

// Keeps the compiler from moving reads or writes of accumulator registers
// across the asynchronous products.
template <int N>
__device__ __forceinline__ void fence_regs(float (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i])::"memory");
}

#define F8(a, i)                                                                       \
  "+f"(a[i]), "+f"(a[i + 1]), "+f"(a[i + 2]), "+f"(a[i + 3]), "+f"(a[i + 4]),          \
      "+f"(a[i + 5]), "+f"(a[i + 6]), "+f"(a[i + 7])

// d[64 x 64] (+)= A[64 x 16] B[16 x 64], A and B K-major in shared memory;
// acc = 0 overwrites d.
__device__ __forceinline__ void wgmma_ss(float (&d)[32], uint64_t da, uint64_t db, int acc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, "
      "%18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
      "%32, %33, p, 1, 1, 0, 0;\n}\n"
      : F8(d, 0), F8(d, 8), F8(d, 16), F8(d, 24)
      : "l"(da), "l"(db), "r"(acc));
}

// d[64 x 64] += A[64 x 16] B[16 x 64], A from registers (bf16 pairs, the
// m16n8k16 A layout per warp), B MN-major in shared memory (transposed).
__device__ __forceinline__ void wgmma_rs(float (&d)[32], const uint32_t (&a)[4], uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, "
      "%18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
      "{%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : F8(d, 0), F8(d, 8), F8(d, 16), F8(d, 24)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

#undef F8

__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 h = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&h);
}

constexpr int STAGES = 3;              // K/V tiles in flight
constexpr int BN = 64;                 // key rows per K/V tile
constexpr int BLOCKS = 2;              // blocks resident on an SM
constexpr uint32_t Q_BYTES = BM * ROW;
constexpr uint32_t KV_BYTES = BN * ROW;
// shared memory: Q, then STAGES x (K, V), then the mbarriers; 1024 bytes of
// slack to align the tiles
constexpr uint32_t BARS = Q_BYTES + 2 * STAGES * KV_BYTES;
constexpr size_t SMEM = 1024 + BARS + 8 * (2 + 3 * STAGES);
// registers: 65,536 / (2 blocks x 384 threads) = 80 a thread at launch; the
// producer drops to 24 and the consumers take the rest, 104
constexpr int LAUNCH_REGS = 65536 / (BLOCKS * 384) / 8 * 8;
constexpr int CONSUMER_REGS = (LAUNCH_REGS * 384 - 24 * 128) / 256 / 8 * 8;

// The (bh, query block) of the idx-th tile, and the K/V tiles it needs.
// Within a head the last query block comes first: under a causal mask it
// is the longest.
struct Tile {
  int qb, bh, kend;
};

__device__ __forceinline__ Tile tile_at(int idx, int nq, int S, int causal) {
  Tile t;
  t.bh = idx / nq;
  t.qb = nq - 1 - idx % nq;
  const int nk = (S + BN - 1) / BN;
  t.kend = causal ? min(nk, (t.qb * BM + BM - 1) / BN + 1) : nk;   // later tiles fully masked
  return t;
}

// K1.  A persistent grid, BLOCKS blocks on each SM: each block walks the
// (bh, 128-row query block) tiles idx = blockIdx.x, + gridDim.x, ....
// Three warpgroups a block.  The first is the producer: one thread issues the TMA copies of each tile's
// Q and of a ring of STAGES K/V tiles that runs on from one tile into the
// next, so the next tile's loads overlap this tile's last products and
// its epilogue.  The other two are consumers, each owning 64 of a tile's
// 128 query rows; they take the producer's registers (setmaxnreg).
//
// In the accumulator layout of wgmma (m64nBN, f32) thread t of a
// warpgroup holds rows r = 16 (t / 32) + (t % 32) / 4 and r + 8, columns
// 8 j + 2 (t % 4) + {0, 1}: element [4 j + 2 i + c] is row r + 8 i, column
// 8 j + 2 (t % 4) + c.  A row's values are spread over the 4 lanes of a quad.
//
// mbarriers: q_full / q_empty (both consumers are done with Q), and per
// stage k_full, v_full / kv_empty.  Every consumer thread arrives on the
// empty barriers (count 256).
__global__ void __launch_bounds__(384, BLOCKS)
flash_fwd_wgmma(const __grid_constant__ CUtensorMap tq, const __grid_constant__ CUtensorMap tk,
                const __grid_constant__ CUtensorMap tv, bf16* __restrict__ o,
                float* __restrict__ lse, int S, int bh_count, int causal, float scale_log2) {
  extern __shared__ unsigned char smem_raw[];
  const uint32_t sq = (smem_u32(smem_raw) + 1023) & ~1023u;
  const uint32_t bars = sq + BARS;
  const uint32_t q_full = bars, q_empty = bars + 8;
  auto sk = [&](int st) { return sq + Q_BYTES + st * 2 * KV_BYTES; };
  auto sv = [&](int st) { return sk(st) + KV_BYTES; };
  auto k_full = [&](int st) { return bars + 16 + 24 * st; };
  auto v_full = [&](int st) { return bars + 24 + 24 * st; };
  auto kv_empty = [&](int st) { return bars + 32 + 24 * st; };

  const int nq = (S + BM - 1) / BM, ntiles = nq * bh_count;

  if (threadIdx.x == 0) {
    mbar_init(q_full, 1);
    mbar_init(q_empty, 256);
    for (int st = 0; st < STAGES; ++st) {
      mbar_init(k_full(st), 1);
      mbar_init(v_full(st), 1);
      mbar_init(kv_empty(st), 256);
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();

  if (threadIdx.x < 128) {
    asm volatile("setmaxnreg.dec.sync.aligned.u32 24;\n" ::: "memory");
    if (threadIdx.x != 0) return;
    int n = 0, used = 0;                   // K/V tiles issued; query tiles begun
    for (int idx = blockIdx.x; idx < ntiles; idx += gridDim.x, ++used) {
      const Tile t = tile_at(idx, nq, S, causal);
      if (used > 0) mbar_wait(q_empty, (used - 1) & 1);
      mbar_expect_tx(q_full, Q_BYTES);
      tma_rows(sq, &tq, q_full, t.qb * BM, t.bh);
      for (int kb = 0; kb < t.kend; ++kb, ++n) {
        const int st = n % STAGES;
        if (n >= STAGES) mbar_wait(kv_empty(st), ((n / STAGES) & 1) ^ 1);
        mbar_expect_tx(k_full(st), KV_BYTES);
        tma_rows(sk(st), &tk, k_full(st), kb * BN, t.bh);
        mbar_expect_tx(v_full(st), KV_BYTES);
        tma_rows(sv(st), &tv, v_full(st), kb * BN, t.bh);
      }
    }
    return;
  }

  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(CONSUMER_REGS) : "memory");
  const int wg = threadIdx.x / 128 - 1, tid = threadIdx.x % 128, lane = tid % 32;
  const int rw = wg * 64 + (tid / 32) * 16 + lane / 4;   // this thread's rows in a tile: rw, rw + 8
  const int cq = 2 * (lane % 4);                         // its first column in each group of 8
  // Q and K: K-major, 8-row groups 1024 bytes apart; a k16 step is 32 bytes.
  // V: MN-major (dh contiguous), 8-key groups 1024 bytes apart; a k16 step is
  // 16 keys, 2048 bytes.
  const uint64_t dq = desc_sw128(sq + wg * 64 * ROW, 16, 1024);

  int n = 0, used = 0;
  for (int idx = blockIdx.x; idx < ntiles; idx += gridDim.x, ++used) {
    const Tile t = tile_at(idx, nq, S, causal);
    const int q0 = t.qb * BM, r0 = q0 + rw;
    float acc[DH / 2];
#pragma unroll
    for (int i = 0; i < DH / 2; ++i) acc[i] = 0.f;
    float m[2] = {NEG_INF, NEG_INF}, l[2] = {0.f, 0.f};   // m in log2 units; l per thread

    mbar_wait(q_full, used & 1);
    for (int kb = 0; kb < t.kend; ++kb, ++n) {
      const int st = n % STAGES;
      const uint32_t phase = (n / STAGES) & 1;
      float s[BN / 2];
#pragma unroll
      for (int i = 0; i < BN / 2; ++i) s[i] = 0.f;

      // S = Q K^T on the tensor cores, into registers
      const uint64_t dk = desc_sw128(sk(st), 16, 1024);
      mbar_wait(k_full(st), phase);
      wg_fence();
      fence_regs(s);
#pragma unroll
      for (int kk = 0; kk < DH / 16; ++kk) wgmma_ss(s, dq + 2 * kk, dk + 2 * kk, kk);
      wg_commit();
      wg_wait0();
      fence_regs(s);
      if (kb == t.kend - 1) mbar_arrive(q_empty);   // the producer may load the next Q

      // mask columns past S and, if causal, above the diagonal
      const int c0 = kb * BN;
      if (c0 + BN > S || (causal && c0 + BN - 1 > q0 + wg * 64)) {
#pragma unroll
        for (int j = 0; j < BN / 8; ++j)
#pragma unroll
          for (int i = 0; i < 2; ++i)
#pragma unroll
            for (int c = 0; c < 2; ++c) {
              const int col = c0 + 8 * j + cq + c;
              if (col >= S || (causal && col > r0 + 8 * i)) s[4 * j + 2 * i + c] = -INFINITY;
            }
      }

      // online softmax in registers, log2 domain: a row's max over its quad
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        float mx = -INFINITY;
#pragma unroll
        for (int j = 0; j < BN / 8; ++j)
          mx = fmaxf(mx, fmaxf(s[4 * j + 2 * i], s[4 * j + 2 * i + 1]));
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
        const float m_new = fmaxf(m[i], mx * scale_log2);
        const float alpha = ex2(m[i] - m_new);
        m[i] = m_new;
        float sum = 0.f;
#pragma unroll
        for (int j = 0; j < BN / 8; ++j)
#pragma unroll
          for (int c = 0; c < 2; ++c) {
            const float p = ex2(fmaf(s[4 * j + 2 * i + c], scale_log2, -m_new));
            s[4 * j + 2 * i + c] = p;
            sum += p;
          }
        l[i] = l[i] * alpha + sum;
#pragma unroll
        for (int j = 0; j < DH / 8; ++j) {
          acc[4 * j + 2 * i] *= alpha;
          acc[4 * j + 2 * i + 1] *= alpha;
        }
      }

      // P in bf16: the accumulator's k16 column slices are wgmma's register A
      uint32_t p[BN / 16][4];
#pragma unroll
      for (int kk = 0; kk < BN / 16; ++kk) {
        p[kk][0] = pack_bf16(s[8 * kk + 0], s[8 * kk + 1]);
        p[kk][1] = pack_bf16(s[8 * kk + 2], s[8 * kk + 3]);
        p[kk][2] = pack_bf16(s[8 * kk + 4], s[8 * kk + 5]);
        p[kk][3] = pack_bf16(s[8 * kk + 6], s[8 * kk + 7]);
      }

      // O += P V, O staying in registers; then the stage goes back to the producer
      const uint64_t dv = desc_sw128(sv(st), 1024, 1024);
      mbar_wait(v_full(st), phase);
      wg_fence();
      fence_regs(acc);
#pragma unroll
      for (int kk = 0; kk < BN / 16; ++kk) wgmma_rs(acc, p[kk], dv + kk * (16 * ROW >> 4));
      wg_commit();
      wg_wait0();
      fence_regs(acc);
      mbar_arrive(kv_empty(st));
    }

    // O = acc / l (l = 0 -> 1) in bf16, lse = (m + log2 l) ln 2
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      float li = l[i];
      li += __shfl_xor_sync(0xffffffffu, li, 1);
      li += __shfl_xor_sync(0xffffffffu, li, 2);
      const int row = r0 + 8 * i;
      if (row < S) {
        const float ll = li == 0.f ? 1.f : li;
        const float inv = 1.f / ll;
        bf16* out = o + ((size_t)t.bh * S + row) * DH + cq;
#pragma unroll
        for (int j = 0; j < DH / 8; ++j)
          *reinterpret_cast<__nv_bfloat162*>(out + 8 * j) =
              __floats2bfloat162_rn(acc[4 * j + 2 * i] * inv, acc[4 * j + 2 * i + 1] * inv);
        if (lane % 4 == 0) lse[(size_t)t.bh * S + row] = (m[i] + log2f(ll)) * LN2;
      }
    }
  }
}

// K2 for bf16, dh = 64.  A block owns one (bh, 128-row query tile), each of
// its two warpgroups 64 of the rows; 64-row K/V tiles stream through:
//   S = Q K^T, dP = dO V^T         wgmma, both operands K-major
//   P = exp2(S scale log2 e - lse log2 e), dS = P (dP - delta), in registers
//   dQ += dS K                     wgmma, A = dS from registers, B = the same
//                                  K tile read MN-major
// lse and delta belong to the thread's own rows (r, r + 8 in the
// accumulator layout above), so they sit in four registers.  Thread 0
// issues the TMA copies: Q and dO once, and the K/V tiles into a ring of
// STAGES stages one tile ahead of the products, so that a tile's load
// overlaps the tile before it; the stage it refills was freed two tiles
// back, so the two warpgroups seldom wait for each other.  There is no
// producer warpgroup: a block's 256 threads fit in 128 registers each, so
// two blocks share an SM and each one's exponentials and waits overlap the
// other's products.  mbarriers: q_full (Q and dO), and per stage kv_full
// (K and V) / kv_empty (every thread arrives, count 256).
constexpr uint32_t DQ_BARS = 2 * Q_BYTES + 2 * STAGES * KV_BYTES;
constexpr size_t DQ_SMEM = 1024 + DQ_BARS + 8 * (1 + 2 * STAGES);

__global__ void __launch_bounds__(256, 2)
flash_bwd_dq_wgmma(const __grid_constant__ CUtensorMap tq, const __grid_constant__ CUtensorMap tk,
                   const __grid_constant__ CUtensorMap tv, const __grid_constant__ CUtensorMap tdo,
                   const float* __restrict__ lse, const float* __restrict__ delta,
                   bf16* __restrict__ dq, int S, int causal, float scale, float scale_log2) {
  extern __shared__ unsigned char smem_raw[];
  const uint32_t sq = (smem_u32(smem_raw) + 1023) & ~1023u, sdo = sq + Q_BYTES;
  const uint32_t bars = sq + DQ_BARS, q_full = bars;
  auto sk = [&](int st) { return sq + 2 * Q_BYTES + st * 2 * KV_BYTES; };
  auto sv = [&](int st) { return sk(st) + KV_BYTES; };
  auto kv_full = [&](int st) { return bars + 8 + 16 * st; };
  auto kv_empty = [&](int st) { return bars + 16 + 16 * st; };

  const Tile t = tile_at(blockIdx.x, (S + BM - 1) / BM, S, causal);
  const int q0 = t.qb * BM;
  const CUtensorMap *mk = &tk, *mv = &tv;
  // K/V tile n into its stage, once every thread is done with tile n - STAGES
  auto load_kv = [&](int n) {
    const int st = n % STAGES;
    if (n >= STAGES) mbar_wait(kv_empty(st), ((n / STAGES) & 1) ^ 1);
    mbar_expect_tx(kv_full(st), 2 * KV_BYTES);
    tma_rows(sk(st), mk, kv_full(st), n * BN, t.bh);
    tma_rows(sv(st), mv, kv_full(st), n * BN, t.bh);
  };
  if (threadIdx.x == 0) {
    mbar_init(q_full, 1);
    for (int st = 0; st < STAGES; ++st) {
      mbar_init(kv_full(st), 1);
      mbar_init(kv_empty(st), 256);
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    mbar_expect_tx(q_full, 2 * Q_BYTES);
    tma_rows(sq, &tq, q_full, q0, t.bh);
    tma_rows(sdo, &tdo, q_full, q0, t.bh);
    load_kv(0);
  }

  const int wg = threadIdx.x / 128, tid = threadIdx.x % 128, lane = tid % 32;
  const int w0 = q0 + wg * 64;                             // this warpgroup's first row
  const int r0 = w0 + (tid / 32) * 16 + lane / 4;          // this thread's rows: r0, r0 + 8
  const int cq = 2 * (lane % 4);                           // its first column in each group of 8
  float lse2[2], dl[2];                                    // lse log2 e and delta of its rows
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int row = r0 + 8 * i;
    lse2[i] = row < S ? lse[(size_t)t.bh * S + row] * LOG2E : 0.f;
    dl[i] = row < S ? delta[(size_t)t.bh * S + row] : 0.f;
  }
  // Q and dO as A, K and V as B of S and dP: K-major, 8-row groups 1024
  // bytes apart, a k16 step 32 bytes.  K as B of dQ: MN-major (dh
  // contiguous), a k16 step is 16 keys, 2048 bytes.
  const uint64_t dq_a = desc_sw128(sq + wg * 64 * ROW, 16, 1024);
  const uint64_t ddo_a = desc_sw128(sdo + wg * 64 * ROW, 16, 1024);

  float acc[DH / 2];
#pragma unroll
  for (int i = 0; i < DH / 2; ++i) acc[i] = 0.f;
  mbar_wait(q_full, 0);
  for (int kb = 0; kb < t.kend; ++kb) {
    if (threadIdx.x == 0 && kb + 1 < t.kend) load_kv(kb + 1);
    const int st = kb % STAGES;
    // a warpgroup whose rows are all past S or, if causal, all before the
    // tile's first key skips its products (the other one never does); it
    // still waits for the tile, so that its arrival on kv_empty counts for
    // this use of the stage and not a later one
    mbar_wait(kv_full(st), (kb / STAGES) & 1);
    const int c0 = kb * BN;
    if (w0 < S && (!causal || c0 <= w0 + 63)) {
      float s[BN / 2], dp[BN / 2];
#pragma unroll
      for (int i = 0; i < BN / 2; ++i) s[i] = dp[i] = 0.f;
      const uint64_t dk = desc_sw128(sk(st), 16, 1024), dv = desc_sw128(sv(st), 16, 1024);
      wg_fence();
      fence_regs(s);
      fence_regs(dp);
#pragma unroll
      for (int kk = 0; kk < DH / 16; ++kk) wgmma_ss(s, dq_a + 2 * kk, dk + 2 * kk, kk);
#pragma unroll
      for (int kk = 0; kk < DH / 16; ++kk) wgmma_ss(dp, ddo_a + 2 * kk, dv + 2 * kk, kk);
      wg_commit();
      wg_wait0();
      fence_regs(s);
      fence_regs(dp);

      // dS = P (dP - delta) in registers; columns past S, rows past S and, if
      // causal, columns after the row have P exactly 0 (rows past S arrive as
      // zeros, and lse = 0 there would give P = 1)
      const bool edge = c0 + BN > S || w0 + 64 > S || (causal && c0 + BN - 1 > w0);
#pragma unroll
      for (int j = 0; j < BN / 8; ++j)
#pragma unroll
        for (int i = 0; i < 2; ++i)
#pragma unroll
          for (int c = 0; c < 2; ++c) {
            const int e = 4 * j + 2 * i + c, col = c0 + 8 * j + cq + c, row = r0 + 8 * i;
            float p = ex2(fmaf(s[e], scale_log2, -lse2[i]));
            if (edge && (col >= S || row >= S || (causal && col > row))) p = 0.f;
            dp[e] = p * (dp[e] - dl[i]);
          }
      // bf16 pairs: the accumulator's k16 column slices are wgmma's register A
      uint32_t da[BN / 16][4];
#pragma unroll
      for (int kk = 0; kk < BN / 16; ++kk)
#pragma unroll
        for (int r = 0; r < 4; ++r) da[kk][r] = pack_bf16(dp[8 * kk + 2 * r], dp[8 * kk + 2 * r + 1]);

      // dQ += dS K, dQ staying in registers
      const uint64_t dk_mn = desc_sw128(sk(st), 1024, 1024);
      wg_fence();
      fence_regs(acc);
#pragma unroll
      for (int kk = 0; kk < BN / 16; ++kk) wgmma_rs(acc, da[kk], dk_mn + kk * (16 * ROW >> 4));
      wg_commit();
      wg_wait0();
      fence_regs(acc);
    }
    mbar_arrive(kv_empty(st));
  }

  // dQ scale in bf16, for rows < S
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int row = r0 + 8 * i;
    if (row >= S) continue;
    bf16* out = dq + ((size_t)t.bh * S + row) * DH + cq;
#pragma unroll
    for (int j = 0; j < DH / 8; ++j)
      *reinterpret_cast<__nv_bfloat162*>(out + 8 * j) =
          __floats2bfloat162_rn(acc[4 * j + 2 * i] * scale, acc[4 * j + 2 * i + 1] * scale);
  }
}

// K3 for bf16, dh = 64.  A block owns one (bh, 128-key tile), each of its
// two consumer warpgroups 64 of the keys; query tiles of 64 rows stream
// through.  The scores are computed transposed (keys x queries), so that
// every operand of the two accumulating products is a TMA tile or the
// registers of the product before:
//   S^T = K Q^T, dP^T = V dO^T     wgmma, A = K or V rows, B = Q or dO, K-major
//   P^T = exp2(S^T scale log2 e - lse log2 e), dS^T = P^T (dP^T - delta)
//   dV += P^T dO, dK += dS^T Q     wgmma, A = P^T or dS^T from registers,
//                                  B = the same dO or Q tile read MN-major
constexpr int DKV_KEYS = 128;          // key rows per block
constexpr int DKV_QROWS = 64;          // query rows per streamed tile
constexpr uint32_t DKV_KV_BYTES = DKV_KEYS * ROW;
constexpr uint32_t DKV_Q_BYTES = DKV_QROWS * ROW;
// lse and delta of a tile: 64 floats from a box that starts up to 3 early
constexpr int DKV_VEC = DKV_QROWS + 4;
constexpr uint32_t DKV_VEC_BYTES = DKV_VEC * 4;
constexpr uint32_t DKV_VEC_AT = (DKV_VEC_BYTES + 127) & ~127u;   // TMA writes 128-aligned
// a stage: Q, dO, then the tile's lse and delta; stages stay 1024-aligned
constexpr uint32_t DKV_STAGE_TX = 2 * DKV_Q_BYTES + 2 * DKV_VEC_BYTES;
constexpr uint32_t DKV_STAGE = (2 * DKV_Q_BYTES + DKV_VEC_AT + DKV_VEC_BYTES + 1023) & ~1023u;
constexpr int DKV_STAGES = 3;          // query stages in flight
// shared memory: two K/V buffers, the stages, then the mbarriers; 1024 bytes
// of slack to align the tiles
constexpr uint32_t DKV_BARS = 4 * DKV_KV_BYTES + DKV_STAGES * DKV_STAGE;
constexpr size_t DKV_SMEM = 1024 + DKV_BARS + 8 * (4 + 2 * DKV_STAGES);
// registers: 65,536 / 384 threads = 168 a thread at launch; the producer
// drops to 24 and the consumers take the rest, 240
constexpr int DKV_LAUNCH_REGS = 65536 / 384 / 8 * 8;
constexpr int DKV_CONSUMER_REGS = (DKV_LAUNCH_REGS * 384 - 24 * 128) / 256 / 8 * 8;

// Each block walks the (bh, key tile) tiles idx = blockIdx.x, + gridDim.x,
// ...; a head's key tiles are adjacent.  Three warpgroups a block.  The
// first is the producer: one thread issues the TMA copies of each tile's K
// and V (two buffers) and of a ring of DKV_STAGES query stages (Q, dO, lse,
// delta) that runs on from one tile into the next, so the next tile's loads
// overlap this tile's last products and its epilogue.  The other two are
// consumers, 64 keys each; they take the producer's registers (setmaxnreg).
// mbarriers: per K/V buffer kv_full / kv_empty, per stage full / empty
// (the empty ones count 256: every consumer thread arrives).
__global__ void __launch_bounds__(384, 1)
flash_bwd_dkv_wgmma(const __grid_constant__ CUtensorMap tq, const __grid_constant__ CUtensorMap tk,
                    const __grid_constant__ CUtensorMap tv, const __grid_constant__ CUtensorMap tdo,
                    const __grid_constant__ CUtensorMap tlse,
                    const __grid_constant__ CUtensorMap tdelta, bf16* __restrict__ dk,
                    bf16* __restrict__ dv, int S, int bh_count, int causal, float scale,
                    float scale_log2) {
  extern __shared__ unsigned char smem_raw[];
  const uint32_t base = smem_u32(smem_raw);
  const uint32_t s0 = (base + 1023) & ~1023u, bars = s0 + DKV_BARS;
  auto sk = [&](int b) { return s0 + 2 * b * DKV_KV_BYTES; };
  auto sv = [&](int b) { return sk(b) + DKV_KV_BYTES; };
  auto sq = [&](int st) { return s0 + 4 * DKV_KV_BYTES + st * DKV_STAGE; };
  auto sdo = [&](int st) { return sq(st) + DKV_Q_BYTES; };
  auto slse = [&](int st) { return sdo(st) + DKV_Q_BYTES; };
  auto sdelta = [&](int st) { return slse(st) + DKV_VEC_AT; };
  auto kv_full = [&](int b) { return bars + 8 * b; };
  auto kv_empty = [&](int b) { return bars + 16 + 8 * b; };
  auto full = [&](int st) { return bars + 32 + 16 * st; };
  auto empty = [&](int st) { return bars + 40 + 16 * st; };

  const int nkt = (S + DKV_KEYS - 1) / DKV_KEYS, ntiles = nkt * bh_count;
  const int nq = (S + DKV_QROWS - 1) / DKV_QROWS;

  if (threadIdx.x == 0) {
    for (int b = 0; b < 2; ++b) {
      mbar_init(kv_full(b), 1);
      mbar_init(kv_empty(b), 256);
    }
    for (int st = 0; st < DKV_STAGES; ++st) {
      mbar_init(full(st), 1);
      mbar_init(empty(st), 256);
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();

  if (threadIdx.x < 128) {
    asm volatile("setmaxnreg.dec.sync.aligned.u32 24;\n" ::: "memory");
    if (threadIdx.x != 0) return;
    int n = 0, used = 0;                   // query stages issued; key tiles begun
    for (int idx = blockIdx.x; idx < ntiles; idx += gridDim.x, ++used) {
      const int bh = idx / nkt, k0 = idx % nkt * DKV_KEYS, b = used & 1;
      const int vo = (bh * S) & 3;         // lse / delta offset in their boxes
      if (used >= 2) mbar_wait(kv_empty(b), ((used >> 1) & 1) ^ 1);
      mbar_expect_tx(kv_full(b), 2 * DKV_KV_BYTES);
      tma_rows(sk(b), &tk, kv_full(b), k0, bh);
      tma_rows(sv(b), &tv, kv_full(b), k0, bh);
      // earlier query tiles are fully masked under causal
      for (int qt = causal ? k0 / DKV_QROWS : 0; qt < nq; ++qt, ++n) {
        const int st = n % DKV_STAGES, q0 = qt * DKV_QROWS;
        if (n >= DKV_STAGES) mbar_wait(empty(st), ((n / DKV_STAGES) & 1) ^ 1);
        mbar_expect_tx(full(st), DKV_STAGE_TX);
        tma_rows(sq(st), &tq, full(st), q0, bh);
        tma_rows(sdo(st), &tdo, full(st), q0, bh);
        tma_vec(slse(st), &tlse, full(st), bh * S + q0 - vo);
        tma_vec(sdelta(st), &tdelta, full(st), bh * S + q0 - vo);
      }
    }
    return;
  }

  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(DKV_CONSUMER_REGS) : "memory");
  const int wg = threadIdx.x / 128 - 1, tid = threadIdx.x % 128, lane = tid % 32;
  const int cq = 2 * (lane % 4);                           // its first column in each group of 8

  int n = 0, used = 0;
  for (int idx = blockIdx.x; idx < ntiles; idx += gridDim.x, ++used) {
    const int bh = idx / nkt, k0 = idx % nkt * DKV_KEYS, b = used & 1;
    const int vo = (bh * S) & 3;
    const int kw = k0 + wg * 64;                             // this warpgroup's first key
    const int kr = kw + (tid / 32) * 16 + lane / 4;          // this thread's keys: kr, kr + 8
    const uint64_t dk_a = desc_sw128(sk(b) + wg * 64 * ROW, 16, 1024);
    const uint64_t dv_a = desc_sw128(sv(b) + wg * 64 * ROW, 16, 1024);

    float acc_k[DH / 2], acc_v[DH / 2];
#pragma unroll
    for (int i = 0; i < DH / 2; ++i) acc_k[i] = acc_v[i] = 0.f;

    mbar_wait(kv_full(b), (used >> 1) & 1);
    for (int qt = causal ? k0 / DKV_QROWS : 0; qt < nq; ++qt, ++n) {
      const int st = n % DKV_STAGES, q0 = qt * DKV_QROWS;
      // Q and dO: K-major as B of S^T and dP^T (8-row groups 1024 bytes apart,
      // a k16 step 32 bytes); MN-major as B of dK and dV (a k16 step is 16
      // query rows, 2048 bytes)
      const uint64_t dq_k = desc_sw128(sq(st), 16, 1024), ddo_k = desc_sw128(sdo(st), 16, 1024);
      const uint64_t dq_mn = desc_sw128(sq(st), 1024, 1024);
      const uint64_t ddo_mn = desc_sw128(sdo(st), 1024, 1024);
      const float* lse_s = reinterpret_cast<const float*>(smem_raw + (slse(st) - base)) + vo;
      const float* delta_s = reinterpret_cast<const float*>(smem_raw + (sdelta(st) - base)) + vo;
      mbar_wait(full(st), (n / DKV_STAGES) & 1);

      // S^T and dP^T on the tensor cores, into registers
      float s[DKV_QROWS / 2], dp[DKV_QROWS / 2];
#pragma unroll
      for (int i = 0; i < DKV_QROWS / 2; ++i) s[i] = dp[i] = 0.f;
      wg_fence();
      fence_regs(s);
      fence_regs(dp);
#pragma unroll
      for (int kk = 0; kk < DH / 16; ++kk) wgmma_ss(s, dk_a + 2 * kk, dq_k + 2 * kk, kk);
#pragma unroll
      for (int kk = 0; kk < DH / 16; ++kk) wgmma_ss(dp, dv_a + 2 * kk, ddo_k + 2 * kk, kk);
      wg_commit();
      wg_wait0();
      fence_regs(s);
      fence_regs(dp);

      // P^T in registers; columns past S, keys past S and, if causal, queries
      // before the key are exactly 0 (and so is dS^T there)
      const bool edge = q0 + DKV_QROWS > S || kw + 64 > S || (causal && q0 < kw + 63);
#pragma unroll
      for (int j = 0; j < DKV_QROWS / 8; ++j)
#pragma unroll
        for (int c = 0; c < 2; ++c) {
          const int col = q0 + 8 * j + cq + c;
          const float lc = lse_s[8 * j + cq + c] * LOG2E;
#pragma unroll
          for (int i = 0; i < 2; ++i) {
            const int e = 4 * j + 2 * i + c, key = kr + 8 * i;
            const float p = ex2(fmaf(s[e], scale_log2, -lc));
            s[e] = edge && (col >= S || key >= S || (causal && col < key)) ? 0.f : p;
          }
        }

      // bf16 pairs: the accumulators' k16 column slices are wgmma's register A
      uint32_t pa[DKV_QROWS / 16][4], da[DKV_QROWS / 16][4];
#pragma unroll
      for (int kk = 0; kk < DKV_QROWS / 16; ++kk)
#pragma unroll
        for (int r = 0; r < 4; ++r)
          pa[kk][r] = pack_bf16(s[8 * kk + 2 * r], s[8 * kk + 2 * r + 1]);

      // dS^T = P^T (dP^T - delta)
#pragma unroll
      for (int j = 0; j < DKV_QROWS / 8; ++j)
#pragma unroll
        for (int c = 0; c < 2; ++c) {
          const float dc = delta_s[8 * j + cq + c];
#pragma unroll
          for (int i = 0; i < 2; ++i) {
            const int e = 4 * j + 2 * i + c;
            dp[e] = s[e] * (dp[e] - dc);
          }
        }
#pragma unroll
      for (int kk = 0; kk < DKV_QROWS / 16; ++kk)
#pragma unroll
        for (int r = 0; r < 4; ++r)
          da[kk][r] = pack_bf16(dp[8 * kk + 2 * r], dp[8 * kk + 2 * r + 1]);

      // dV += P^T dO, dK += dS^T Q, both staying in registers
      wg_fence();
      fence_regs(acc_v);
      fence_regs(acc_k);
#pragma unroll
      for (int kk = 0; kk < DKV_QROWS / 16; ++kk)
        wgmma_rs(acc_v, pa[kk], ddo_mn + kk * (16 * ROW >> 4));
#pragma unroll
      for (int kk = 0; kk < DKV_QROWS / 16; ++kk)
        wgmma_rs(acc_k, da[kk], dq_mn + kk * (16 * ROW >> 4));
      wg_commit();
      wg_wait0();
      fence_regs(acc_v);
      fence_regs(acc_k);
      mbar_arrive(empty(st));             // the stage goes back to the producer
    }
    mbar_arrive(kv_empty(b));             // and so do K and V

    // dK scale and dV in bf16, for keys < S
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int key = kr + 8 * i;
      if (key >= S) continue;
      const size_t at = ((size_t)bh * S + key) * DH + cq;
#pragma unroll
      for (int j = 0; j < DH / 8; ++j) {
        *reinterpret_cast<__nv_bfloat162*>(dk + at + 8 * j) =
            __floats2bfloat162_rn(acc_k[4 * j + 2 * i] * scale, acc_k[4 * j + 2 * i + 1] * scale);
        *reinterpret_cast<__nv_bfloat162*>(dv + at + 8 * j) =
            __floats2bfloat162_rn(acc_v[4 * j + 2 * i], acc_v[4 * j + 2 * i + 1]);
      }
    }
  }
}

// cuTensorMapEncodeTiled lives in libcuda: it is looked up through the
// runtime's entry-point query, so the library links the runtime alone.
using EncodeTiled = decltype(&cuTensorMapEncodeTiled);

EncodeTiled encode_tiled() {
  static EncodeTiled fn = [] {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    const cudaError_t e = cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &p, 12000,
                                                           cudaEnableDefault, &found);
#else
    const cudaError_t e =
        cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault, &found);
#endif
    return e == cudaSuccess && found == cudaDriverEntryPointSuccess
               ? reinterpret_cast<EncodeTiled>(p)
               : nullptr;
  }();
  return fn;
}

// A (BH, S, 64) bf16 tensor seen as 3-D (dh, S, BH), boxes of `rows` rows of
// one head, 128-byte swizzle.  Rows at or past S read as zeros, so a ragged
// last tile never reaches the next head.
bool rows_map(CUtensorMap* map, const void* ptr, int S, int bh, int rows) {
  const EncodeTiled fn = encode_tiled();
  if (fn == nullptr) return false;
  const cuuint64_t dims[3] = {DH, (cuuint64_t)S, (cuuint64_t)bh};
  const cuuint64_t strides[2] = {ROW, (cuuint64_t)S * ROW};
  const cuuint32_t box[3] = {DH, (cuuint32_t)rows, 1};
  const cuuint32_t step[3] = {1, 1, 1};
  return fn(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 3, const_cast<void*>(ptr), dims, strides, box,
            step, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
            CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

// A (BH, S) float tensor seen as one vector of BH * S, boxes of 68 that
// start 16-byte aligned, so that a head's rows need not be (any S runs):
// the 64 floats of a query tile sit (bh S) mod 4 into the box.  What a box
// reads past a head's S belongs to the next head and is masked; past the
// end it reads as zeros.
bool vec_map(CUtensorMap* map, const void* ptr, int n) {
  const EncodeTiled fn = encode_tiled();
  if (fn == nullptr) return false;
  const cuuint64_t dims[1] = {(cuuint64_t)n};
  const cuuint64_t strides[1] = {(cuuint64_t)n * 4};   // unused at rank 1
  const cuuint32_t box[1] = {DKV_VEC};
  const cuuint32_t step[1] = {1};
  return fn(map, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 1, const_cast<void*>(ptr), dims, strides, box,
            step, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_NONE,
            CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

int sm_count() {
  static const int n = [] {
    int dev = 0, count = 0;
    cudaGetDevice(&dev);
    cudaDeviceGetAttribute(&count, cudaDevAttrMultiProcessorCount, dev);
    return count;
  }();
  return n;
}

// The tensor maps hold this call's pointers, so they are encoded per call
// and passed by value.
cudaError_t launch_fwd(const void* q, const void* k, const void* v, void* o, void* lse, int S,
                       int causal, float scale, int bh, cudaStream_t st) {
  CUtensorMap tq, tk, tv;
  if (!rows_map(&tq, q, S, bh, BM) || !rows_map(&tk, k, S, bh, BN) ||
      !rows_map(&tv, v, S, bh, BN))
    return cudaErrorInvalidValue;
  const cudaError_t e = set_smem(flash_fwd_wgmma, SMEM);
  if (e != cudaSuccess) return e;
  const int tiles = (S + BM - 1) / BM * bh;
  flash_fwd_wgmma<<<std::min(tiles, BLOCKS * sm_count()), 384, SMEM, st>>>(
      tq, tk, tv, (bf16*)o, (float*)lse, S, bh, causal, scale * LOG2E);
  return cudaGetLastError();
}

// A block per tile, two on an SM; under a causal mask a head's longest tile
// comes first.
cudaError_t launch_bwd_dq(const void* q, const void* k, const void* v, const void* dout,
                          const void* lse, const void* delta, void* dq, int S, int causal,
                          float scale, int bh, cudaStream_t st) {
  CUtensorMap tq, tk, tv, tdo;
  if (!rows_map(&tq, q, S, bh, BM) || !rows_map(&tdo, dout, S, bh, BM) ||
      !rows_map(&tk, k, S, bh, BN) || !rows_map(&tv, v, S, bh, BN))
    return cudaErrorInvalidValue;
  const cudaError_t e = set_smem(flash_bwd_dq_wgmma, DQ_SMEM);
  if (e != cudaSuccess) return e;
  const int tiles = (S + BM - 1) / BM * bh;
  flash_bwd_dq_wgmma<<<tiles, 256, DQ_SMEM, st>>>(tq, tk, tv, tdo, (const float*)lse,
                                                  (const float*)delta, (bf16*)dq, S, causal,
                                                  scale, scale * LOG2E);
  return cudaGetLastError();
}

// Non-causal tiles are equal, and a persistent grid of one block per SM
// walks them; causal tiles are not (a key tile sees the query tiles from
// its own on), so there each block takes one tile and the hardware's block
// scheduler balances them.
cudaError_t launch_bwd_dkv(const void* q, const void* k, const void* v, const void* dout,
                           const void* lse, const void* delta, void* dk, void* dv, int S,
                           int causal, float scale, int bh, cudaStream_t st) {
  CUtensorMap tq, tk, tv, tdo, tl, td;
  if (!rows_map(&tq, q, S, bh, DKV_QROWS) || !rows_map(&tdo, dout, S, bh, DKV_QROWS) ||
      !rows_map(&tk, k, S, bh, DKV_KEYS) || !rows_map(&tv, v, S, bh, DKV_KEYS) ||
      !vec_map(&tl, lse, S * bh) || !vec_map(&td, delta, S * bh))
    return cudaErrorInvalidValue;
  const cudaError_t e = set_smem(flash_bwd_dkv_wgmma, DKV_SMEM);
  if (e != cudaSuccess) return e;
  const int tiles = (S + DKV_KEYS - 1) / DKV_KEYS * bh;
  flash_bwd_dkv_wgmma<<<causal ? tiles : std::min(tiles, sm_count()), 384, DKV_SMEM, st>>>(
      tq, tk, tv, tdo, tl, td, (bf16*)dk, (bf16*)dv, S, bh, causal, scale,
      scale * LOG2E);
  return cudaGetLastError();
}

}  // namespace hop

// ===========================================================================
// launch
// ===========================================================================

struct FwdArgs {
  const void *q, *k, *v;
  void *o, *lse;
  int S, causal;
  float scale;
};

struct BwdArgs {
  const void *q, *k, *v, *dout, *lse, *delta;
  void *dq, *dk, *dv;
  int S, causal;
  float scale;
};

// dtype 0: float32 (FMA kernels), 1: bfloat16 (tensor-core kernels).
template <int DH>
cudaError_t fwd(const FwdArgs& a, int dtype, int bh, cudaStream_t st) {
  const dim3 grid((a.S + BQ - 1) / BQ, bh);
  cudaError_t e;
  if (dtype == 0) {
    const size_t smem = sizeof(float) * (BQ * DH + BK * (DH + 1) + BK * DH + BQ * BK);
    if ((e = set_smem(flash_fwd_f32<DH>, smem)) != cudaSuccess) return e;
    flash_fwd_f32<DH><<<grid, NTHREAD, smem, st>>>(
        (const float*)a.q, (const float*)a.k, (const float*)a.v, (float*)a.o,
        (float*)a.lse, a.S, a.causal, a.scale);
  } else if constexpr (DH == 64) {
    return hop::launch_fwd(a.q, a.k, a.v, a.o, a.lse, a.S, a.causal, a.scale, bh, st);
  } else {
    using L = Tc<DH>;
    const size_t smem = 3 * L::H + L::P + 2 * L::F;
    if ((e = set_smem(flash_fwd_bf16<DH>, smem)) != cudaSuccess) return e;
    flash_fwd_bf16<DH><<<grid, TC_THREADS, smem, st>>>(
        (const bf16*)a.q, (const bf16*)a.k, (const bf16*)a.v, (bf16*)a.o, (float*)a.lse,
        a.S, a.causal, a.scale);
  }
  return cudaGetLastError();
}

template <int DH>
cudaError_t bwd_dq(const BwdArgs& a, int dtype, int bh, cudaStream_t st) {
  const dim3 grid((a.S + BQ - 1) / BQ, bh);
  cudaError_t e;
  if (dtype == 0) {
    const size_t smem = sizeof(float) * (2 * BQ * DH + 2 * BK * (DH + 1) + BQ * BK);
    if ((e = set_smem(flash_bwd_dq_f32<DH>, smem)) != cudaSuccess) return e;
    flash_bwd_dq_f32<DH><<<grid, NTHREAD, smem, st>>>(
        (const float*)a.q, (const float*)a.k, (const float*)a.v, (const float*)a.dout,
        (const float*)a.lse, (const float*)a.delta, (float*)a.dq, a.S, a.causal, a.scale);
  } else if constexpr (DH == 64) {
    return hop::launch_bwd_dq(a.q, a.k, a.v, a.dout, a.lse, a.delta, a.dq, a.S, a.causal, a.scale,
                              bh, st);
  } else {
    using L = Tc<DH>;
    const size_t smem = 4 * L::H + L::P + 2 * L::F;
    if ((e = set_smem(flash_bwd_dq_bf16<DH>, smem)) != cudaSuccess) return e;
    flash_bwd_dq_bf16<DH><<<grid, TC_THREADS, smem, st>>>(
        (const bf16*)a.q, (const bf16*)a.k, (const bf16*)a.v, (const bf16*)a.dout,
        (const float*)a.lse, (const float*)a.delta, (bf16*)a.dq, a.S, a.causal, a.scale);
  }
  return cudaGetLastError();
}

template <int DH>
cudaError_t bwd_dkv(const BwdArgs& a, int dtype, int bh, cudaStream_t st) {
  const dim3 grid((a.S + BK - 1) / BK, bh);
  cudaError_t e;
  if (dtype == 0) {
    const size_t smem =
        sizeof(float) * (2 * BK * DH + 2 * BQ * (DH + 1) + 2 * BK * BQ + 2 * BQ);
    if ((e = set_smem(flash_bwd_dkv_f32<DH>, smem)) != cudaSuccess) return e;
    flash_bwd_dkv_f32<DH><<<grid, NTHREAD, smem, st>>>(
        (const float*)a.q, (const float*)a.k, (const float*)a.v, (const float*)a.dout,
        (const float*)a.lse, (const float*)a.delta, (float*)a.dk, (float*)a.dv, a.S,
        a.causal, a.scale);
  } else if constexpr (DH == 64) {
    return hop::launch_bwd_dkv(a.q, a.k, a.v, a.dout, a.lse, a.delta, a.dk, a.dv, a.S, a.causal,
                               a.scale, bh, st);
  } else {
    using L = Tc<DH>;
    const size_t smem = 4 * L::H + 2 * L::P + 2 * L::F + 2 * BQ * sizeof(float);
    if ((e = set_smem(flash_bwd_dkv_bf16<DH>, smem)) != cudaSuccess) return e;
    flash_bwd_dkv_bf16<DH><<<grid, TC_THREADS, smem, st>>>(
        (const bf16*)a.q, (const bf16*)a.k, (const bf16*)a.v, (const bf16*)a.dout,
        (const float*)a.lse, (const float*)a.delta, (bf16*)a.dk, (bf16*)a.dv, a.S,
        a.causal, a.scale);
  }
  return cudaGetLastError();
}

template <typename A>
using Launch = cudaError_t (*)(const A&, int, int, cudaStream_t);

// dtype: 0 = float32, 1 = bfloat16; dh in {32, 64, 128}.
template <typename A>
int dispatch(Launch<A> l32, Launch<A> l64, Launch<A> l128, const A& a, int bh, int dh,
             int dtype, void* stream) {
  if (bh < 1 || bh > 65535 || a.S < 1 || (dtype != 0 && dtype != 1))
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  if (dh == 32) return (int)l32(a, dtype, bh, st);
  if (dh == 64) return (int)l64(a, dtype, bh, st);
  if (dh == 128) return (int)l128(a, dtype, bh, st);
  return (int)cudaErrorInvalidValue;
}

}  // namespace

extern "C" {

// Each returns the cudaError_t of the launch (0 on success).
int bps_flash_fwd(const void* q, const void* k, const void* v, void* o, void* lse, int bh,
                  int s, int dh, int dtype, int causal, float scale, void* stream) {
  FwdArgs a{q, k, v, o, lse, s, causal, scale};
  return dispatch<FwdArgs>(fwd<32>, fwd<64>, fwd<128>, a, bh, dh, dtype, stream);
}

int bps_flash_bwd_dq(const void* q, const void* k, const void* v, const void* dout,
                     const void* lse, const void* delta, void* dq, int bh, int s, int dh,
                     int dtype, int causal, float scale, void* stream) {
  BwdArgs a{q, k, v, dout, lse, delta, dq, nullptr, nullptr, s, causal, scale};
  return dispatch<BwdArgs>(bwd_dq<32>, bwd_dq<64>, bwd_dq<128>, a, bh, dh, dtype, stream);
}

int bps_flash_bwd_dkv(const void* q, const void* k, const void* v, const void* dout,
                      const void* lse, const void* delta, void* dk, void* dv, int bh, int s,
                      int dh, int dtype, int causal, float scale, void* stream) {
  BwdArgs a{q, k, v, dout, lse, delta, nullptr, dk, dv, s, causal, scale};
  return dispatch<BwdArgs>(bwd_dkv<32>, bwd_dkv<64>, bwd_dkv<128>, a, bh, dh, dtype, stream);
}

}  // extern "C"
