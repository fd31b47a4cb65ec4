// Device code shared by the two tree-attention backward kernels
// (tree_attention_bwd_dq.cu and tree_attention_bwd_dkv.cu): tile loads,
// the Q·Kᵀ-shaped product both kernels recompute, and the masked
// probability p = exp(s − lse) of the reference's _vis_and_p
// (src/repro/kernels/tree_attention_bwd.py:54).
//
// Layout, as the forward (tree_attention_fwd.cu): q/o/do [B,S,H,hd],
// k/v [B,Skv,Kh,hd], kv_last/pos int32, lse/delta [B,H,S] f32.
//   visible(i,j) ⇔ j ≤ i ∧ kv_last[j] ≥ i  [∧ pos_q[i] − pos_k[j] < window],
// i = q_off + local query index.  Query tiles are 64 rows, as in the
// forward, so the block-skip predicate sees the same query tiles.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>

#include <climits>
#include <type_traits>

namespace tab {

constexpr int BQ = 64;               // queries per tile
constexpr int NTHREADS = 256;
constexpr int NWARPS = NTHREADS / 32;
constexpr float NEG_INF = -1e30f;    // the reference's finite sentinel
constexpr int MAX_SMEM = 232448;     // opt-in shared memory of one H100 block

constexpr int align128(int x) { return (x + 127) / 128 * 128; }

template <typename T> __device__ __forceinline__ float to_f32(T x);
template <> __device__ __forceinline__ float to_f32<float>(float x) { return x; }
template <> __device__ __forceinline__ float to_f32<__nv_bfloat16>(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
template <typename T> __device__ __forceinline__ T from_f32(float x);
template <> __device__ __forceinline__ float from_f32<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

// Element type of the shared tiles: bf16 where the products run on the
// tensor cores (WMMA), fp32 where they run on FMA (fp32 inputs, and bf16
// at a head dim that is not a multiple of 16).
template <bool MMA>
using Elem = typename std::conditional<MMA, __nv_bfloat16, float>::type;

// Row pitch of a [rows, HD] tile: +8 bf16 keeps WMMA's 16-byte rule and
// spreads row loads over the banks; +1 float does the same for FMA.
template <int HD, bool MMA>
constexpr int tile_ld() { return MMA ? HD + 8 : HD + 1; }

// dst[r][c] = src[r·stride + c] for r < nrows, 0 for nrows ≤ r < ROWS.
template <int ROWS, int HD, int LD, typename T, typename E>
__device__ __forceinline__ void load_tile(E* dst, const T* __restrict__ src,
                                          size_t stride, int nrows) {
  for (int idx = threadIdx.x; idx < ROWS * HD; idx += NTHREADS) {
    const int r = idx / HD, c = idx % HD;
    dst[r * LD + c] = from_f32<E>(r < nrows ? to_f32(src[r * stride + c]) : 0.f);
  }
}

// C[M][N] = A[M][HD] · B[N][HD]ᵀ, fp32, row-major in shared memory (ld N).
// A and B are row-major tiles of pitch LD.  M = 64 (BQ) in both kernels.
template <int M, int N, int HD, int LD, bool MMA>
__device__ __forceinline__ void gemm_abt(float* C, const Elem<MMA>* A,
                                         const Elem<MMA>* B) {
  static_assert(M == 64 && N % 16 == 0, "tile shape");
  const int tid = threadIdx.x, warp = tid / 32;
  if constexpr (MMA) {
    using namespace nvcuda;
    for (int f = warp; f < (M / 16) * (N / 16); f += NWARPS) {
      const int fm = f / (N / 16), fn = f % (N / 16);
      wmma::fragment<wmma::accumulator, 16, 16, 16, float> cf;
      wmma::fill_fragment(cf, 0.f);
      for (int d = 0; d < HD; d += 16) {
        wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16, wmma::row_major> af;
        wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16, wmma::col_major> bf;
        wmma::load_matrix_sync(af, A + fm * 16 * LD + d, LD);
        wmma::load_matrix_sync(bf, B + fn * 16 * LD + d, LD);
        wmma::mma_sync(cf, af, bf, cf);
      }
      wmma::store_matrix_sync(C + fm * 16 * N + fn * 16, cf, N, wmma::mem_row_major);
    }
  } else {
    constexpr int NJ = N / 16;
    const int tx = tid % 16, ty = tid / 16;
    float s[4][NJ] = {};
    for (int d = 0; d < HD; ++d) {
      float a[4], b[NJ];
#pragma unroll
      for (int i = 0; i < 4; ++i) a[i] = A[(ty + 16 * i) * LD + d];
#pragma unroll
      for (int j = 0; j < NJ; ++j) b[j] = B[(tx + 16 * j) * LD + d];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < NJ; ++j) s[i][j] = fmaf(a[i], b[j], s[i][j]);
    }
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < NJ; ++j) C[(ty + 16 * i) * N + tx + 16 * j] = s[i][j];
  }
}

// The reference's p = where(vis, exp(where(vis, s·scale − lse, −1e30)), 0):
// the exponent is formed only where (i, j) is visible, so a fully masked
// row (lse = −1e30) never overflows and gives p = 0.
__device__ __forceinline__ float masked_p(bool vis, float s, float scale, float lse) {
  return vis ? expf(s * scale - lse) : 0.f;
}

}  // namespace tab
