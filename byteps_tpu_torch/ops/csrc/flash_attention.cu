// Flash attention for Hopper (sm_90a): the forward kernel and the two
// backward kernels (dQ, and dK/dV), with a plain C interface for ctypes.
//
// Replaces the Pallas kernels of byteps_tpu/ops/flash_attention.py:
//   flash_fwd_*     <- _fwd_kernel_factory      (K1)
//   flash_bwd_dq_*  <- _bwd_dq_kernel_factory   (K2)
//   flash_bwd_dkv_* <- _bwd_dkv_kernel_factory  (K3)
//
// Layout: q, k, v, o, dO, dQ, dK, dV are (BH, S, DH) row-major in float or
// bf16; lse and delta are (BH, S) float.  Softmax statistics, exponentials
// and every accumulator are f32.
//
// Design.  One thread block per (bh, 64-row query block) for the forward
// and dQ kernels, and per (bh, 64-row key block) for dK/dV.  The
// sequential grid axis of the Pallas kernels becomes a loop inside the
// block, over the tiles that are staged in shared memory (rows past S read
// as zero and their scores are masked, so a ragged last block runs here
// and every S takes the kernel).  Causal blocks that are fully masked are
// skipped.  No S x S intermediate reaches device memory: each input is
// read once per block and each output written once.
//
// Two versions of each kernel, chosen by the input type:
//   bf16 (the training path): the products run on the tensor cores, as
//     16x16x16 bf16 WMMA tiles (mma.sync) with f32 accumulators; 4 warps,
//     each owning 16 rows of the block.  Scores go through shared memory
//     in f32 for the softmax; P and dS are rounded to bf16 for the second
//     product, as the plain version's bf16 path would not, which is within
//     the bf16 tolerance.  What bounds them: at S = 512, dh = 64 the work
//     sits near the H100's ridge point (K1 does ~254 FLOP a byte it must
//     move, against ~295), so bytes and operations bound it alike; these
//     kernels stay far from both while their loads are synchronous and
//     every score tile makes a round trip through shared memory.  wgmma
//     with TMA loads in flight is the next step.
//   f32: the products run on the FMA units in f32 (67 TFLOP/s), since
//     TF32 or bf16 tiles would not hold the f32 tolerance; 8 warps, the
//     rows that lanes read across are padded (stride dh + 1) so the loops
//     are free of bank conflicts.  Bound by operations.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>

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

// K1 on the tensor cores.  O's running sum lives in shared memory (f32),
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

// K2 on the tensor cores; dQ accumulates in registers across key blocks.
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

template <typename Kernel>
cudaError_t set_smem(Kernel kernel, size_t bytes) {
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
}

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
