// Tree flash-attention backward, dq, for Hopper (sm_90a), behind a plain C
// entry point that Python loads with ctypes
// (src/repro_torch/kernels/tree_attention_bwd.py).
//
// Replaces: the Pallas TPU kernel src/repro/kernels/tree_attention_bwd.py::
// _bwd_dq (kernel body :83-134, pallas_call :162).  Same function: with
// p_ij = exp(scale·q_i·k_j − lse_i) on visible pairs (0 elsewhere) and
// Δ_i = Σ_d do_id·o_id (computed by the wrapper),
//   ds_ij = p_ij · (do_i·v_j − Δ_i) · scale,   dq_i = Σ_j ds_ij · k_j.
//
// Design.  One CUDA block of 256 threads owns one (64-query tile, head,
// batch row), as in the forward.  A loop inside the block walks the 64-key
// tiles; it takes the place of the TPU's sequential kv grid axis and its
// VMEM dq carry, and keeps dq in fp32 registers across tiles, written once
// at the end.  The loop stops at the last causal tile and tests every tile
// inside it with the forward's block_live predicate before any load (tree
// visibility is not monotone along kv), so forward and backward skip the
// same tiles.  Ragged S and Skv tails are zero-filled and masked.  A fully
// masked row (lse = −1e30) gives p = 0 through the reference's guarded
// exponent, so padding queries get dq = 0 and nothing is NaN.
//
// Products: S = Q·Kᵀ and dP = dO·Vᵀ, then dQ += dS·K.  bf16 inputs with hd
// a multiple of 16 use WMMA (16×16×16 bf16 tensor-core tiles, fp32
// accumulate; dS is rounded to bf16 before dS·K, as FlashAttention-2/3
// do); fp32 inputs use fp32 FMA, so they match the plain version to
// summation order.  No atomics: two launches give bit-identical dq.
//
// What bounds it on the H100: about 6·hd FLOPs per visible (i, j) pair and
// query head (three products of 2·hd), against 2·hd·2 bytes per key read,
// so at hd 128 an ideal kernel is bound by the tensor cores (989 TFLOP/s
// bf16).  This simple kernel does nothing about that yet: WMMA through
// shared memory, no TMA, no wgmma, no overlap of loads with math, and each
// of a GQA group's query heads reloads the group's K/V tiles.  PERF.md
// keeps its measured times; making it fast is later work.

#include "tree_attention_bwd.cuh"

namespace {

using namespace tab;
constexpr int BK = 64;               // keys per tile (one loop step)

template <int HD, bool MMA>
struct Smem {
  using E = Elem<MMA>;
  static constexpr int ES = static_cast<int>(sizeof(E));
  static constexpr int LD = tile_ld<HD, MMA>();
  static constexpr int LDP = BK + 8;    // bf16 dS (MMA path)
  static constexpr int LDO = HD + 4;    // fp32 dS·K tile (MMA path)
  static constexpr int Q = 0;
  static constexpr int DO = Q + align128(BQ * LD * ES);
  static constexpr int K = DO + align128(BQ * LD * ES);
  static constexpr int V = K + align128(BK * LD * ES);
  static constexpr int S = V + align128(BK * LD * ES);
  static constexpr int DP = S + align128(BQ * BK * 4);
  static constexpr int DS = DP + align128(BQ * BK * 4);
  static constexpr int PR = DS + (MMA ? align128(BQ * LDP * 2) : 0);
  static constexpr int KL = PR + (MMA ? align128(BQ * LDO * 4) : 0);
  static constexpr int PK = KL + align128(BK * 4);
  static constexpr int PQ = PK + align128(BK * 4);
  static constexpr int LSE = PQ + align128(BQ * 4);
  static constexpr int DL = LSE + align128(BQ * 4);
  static constexpr int BYTES = DL + align128(BQ * 4);
  static_assert(BYTES <= MAX_SMEM, "dq tile does not fit shared memory");
};

template <typename T, int HD, bool MMA>
__global__ void __launch_bounds__(NTHREADS)
tree_attention_bwd_dq_kernel(const T* __restrict__ q, const T* __restrict__ k,
                             const T* __restrict__ v, const int* __restrict__ kv_last,
                             const int* __restrict__ pos_q, const int* __restrict__ pos_k,
                             const float* __restrict__ lse, const float* __restrict__ delta,
                             const T* __restrict__ dout, T* __restrict__ dq, int S, int Skv,
                             int H, int Kh, float scale, int q_off, int window) {
  using L = Smem<HD, MMA>;
  using E = typename L::E;
  constexpr int LD = L::LD;
  constexpr int PER = BQ * HD / NTHREADS;   // dq elements per thread
  extern __shared__ __align__(128) unsigned char smem[];
  __shared__ int qp_min_s;
  E* Qs = reinterpret_cast<E*>(smem + L::Q);
  E* DOs = reinterpret_cast<E*>(smem + L::DO);
  E* Ks = reinterpret_cast<E*>(smem + L::K);
  E* Vs = reinterpret_cast<E*>(smem + L::V);
  float* Ss = reinterpret_cast<float*>(smem + L::S);
  float* DPs = reinterpret_cast<float*>(smem + L::DP);
  __nv_bfloat16* DSs = reinterpret_cast<__nv_bfloat16*>(smem + L::DS);
  float* PRs = reinterpret_cast<float*>(smem + L::PR);
  int* kl_s = reinterpret_cast<int*>(smem + L::KL);
  int* pk_s = reinterpret_cast<int*>(smem + L::PK);
  int* pq_s = reinterpret_cast<int*>(smem + L::PQ);
  float* lse_s = reinterpret_cast<float*>(smem + L::LSE);
  float* dl_s = reinterpret_cast<float*>(smem + L::DL);

  const int tid = threadIdx.x, warp = tid / 32;
  const int b = blockIdx.z, h = blockIdx.y;
  const int kh = h / (H / Kh);
  const int q0 = blockIdx.x * BQ;            // local index of the tile's first query
  const int nrows = min(BQ, S - q0);
  const int q_start = q_off + q0;            // global DFS index
  const int q_end = q_start + nrows - 1;
  const bool windowed = pos_q != nullptr;

  const size_t qrow = (size_t(b) * S + q0) * H + h;   // row q0, head h
  load_tile<BQ, HD, LD>(Qs, q + qrow * HD, size_t(H) * HD, nrows);
  load_tile<BQ, HD, LD>(DOs, dout + qrow * HD, size_t(H) * HD, nrows);
  if (tid == 0) qp_min_s = INT_MAX;
  for (int r = tid; r < BQ; r += NTHREADS) {
    const bool ok = r < nrows;
    const size_t g = (size_t(b) * H + h) * S + q0 + r;
    lse_s[r] = ok ? lse[g] : 0.f;
    dl_s[r] = ok ? delta[g] : 0.f;
    pq_s[r] = (windowed && ok) ? pos_q[size_t(b) * S + q0 + r] : 0;
  }
  __syncthreads();
  if (windowed && tid < nrows) atomicMin(&qp_min_s, pq_s[tid]);
  __syncthreads();
  const int qp_min = qp_min_s;

  float acc[PER];
#pragma unroll
  for (int e = 0; e < PER; ++e) acc[e] = 0.f;

  const int n_tiles = min(q_end, Skv - 1) / BK + 1;   // trim to the last causal tile
  for (int t = 0; t < n_tiles; ++t) {
    const int k0 = t * BK;
    const int ncols = min(BK, Skv - k0);
    // block_live(q_start, q_end, k0, max kv_last, qp_min, max pos_k, window);
    // k0 ≤ q_end holds by the loop bound.
    int kl = -1, pk = 0;
    if (tid < ncols) {
      kl = kv_last[size_t(b) * Skv + k0 + tid];
      if (windowed) pk = pos_k[size_t(b) * Skv + k0 + tid];
    }
    if (tid < BK) {
      kl_s[tid] = kl;
      pk_s[tid] = pk;
    }
    const bool seen = __syncthreads_or(kl >= q_start);
    const bool in_window =
        !windowed || __syncthreads_or(tid < ncols && qp_min - pk < window);
    if (!(seen && in_window)) continue;     // dead tile: no loads, no math

    const size_t krow = (size_t(b) * Skv + k0) * Kh + kh;
    load_tile<BK, HD, LD>(Ks, k + krow * HD, size_t(Kh) * HD, ncols);
    load_tile<BK, HD, LD>(Vs, v + krow * HD, size_t(Kh) * HD, ncols);
    __syncthreads();
    gemm_abt<BQ, BK, HD, LD, MMA>(Ss, Qs, Ks);      // S  = Q·Kᵀ
    gemm_abt<BQ, BK, HD, LD, MMA>(DPs, DOs, Vs);    // dP = dO·Vᵀ
    __syncthreads();

    // dS = P ∘ (dP − Δ) · scale
    for (int idx = tid; idx < BQ * BK; idx += NTHREADS) {
      const int r = idx / BK, c = idx % BK;
      const int iq = q_start + r;
      bool vis = r < nrows && c < ncols && k0 + c <= iq && kl_s[c] >= iq;
      if (windowed) vis = vis && (pq_s[r] - pk_s[c] < window);
      const float p = masked_p(vis, Ss[idx], scale, lse_s[r]);
      const float ds = p * (DPs[idx] - dl_s[r]) * scale;
      if constexpr (MMA) DSs[r * L::LDP + c] = __float2bfloat16(ds);
      else Ss[idx] = ds;
    }
    __syncthreads();

    // dQ += dS·K
    if constexpr (MMA) {
      using namespace nvcuda;
      for (int f = warp; f < (BQ / 16) * (HD / 16); f += NWARPS) {
        const int fm = f / (HD / 16), fn = f % (HD / 16);
        wmma::fragment<wmma::accumulator, 16, 16, 16, float> cf;
        wmma::fill_fragment(cf, 0.f);
        for (int j = 0; j < BK; j += 16) {
          wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16, wmma::row_major> af;
          wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16, wmma::row_major> bf;
          wmma::load_matrix_sync(af, DSs + fm * 16 * L::LDP + j, L::LDP);
          wmma::load_matrix_sync(bf, Ks + j * LD + fn * 16, LD);
          wmma::mma_sync(cf, af, bf, cf);
        }
        wmma::store_matrix_sync(PRs + fm * 16 * L::LDO + fn * 16, cf, L::LDO,
                                wmma::mem_row_major);
      }
      __syncthreads();
#pragma unroll
      for (int e = 0; e < PER; ++e) {
        const int idx = tid + e * NTHREADS, r = idx / HD, c = idx % HD;
        acc[e] += PRs[r * L::LDO + c];
      }
    } else {
#pragma unroll
      for (int e = 0; e < PER; ++e) {
        const int idx = tid + e * NTHREADS, r = idx / HD, c = idx % HD;
        float s = 0.f;
        for (int j = 0; j < BK; ++j) s = fmaf(Ss[r * BK + j], Ks[j * LD + c], s);
        acc[e] += s;
      }
    }
    __syncthreads();                        // tiles are reused by the next step
  }

#pragma unroll
  for (int e = 0; e < PER; ++e) {
    const int idx = tid + e * NTHREADS, r = idx / HD, c = idx % HD;
    if (r < nrows) dq[(qrow + size_t(r) * H) * HD + c] = from_f32<T>(acc[e]);
  }
}

template <typename T, int HD, bool MMA>
cudaError_t launch(const void* q, const void* k, const void* v, const void* kv_last,
                   const void* pos_q, const void* pos_k, const void* lse,
                   const void* delta, const void* dout, void* dq, int B, int S, int Skv,
                   int H, int Kh, float scale, int q_off, int window,
                   cudaStream_t stream) {
  constexpr int bytes = Smem<HD, MMA>::BYTES;
  auto kern = tree_attention_bwd_dq_kernel<T, HD, MMA>;
  cudaError_t err =
      cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err != cudaSuccess) return err;
  const dim3 grid((S + BQ - 1) / BQ, H, B);
  kern<<<grid, NTHREADS, bytes, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<const int*>(kv_last), static_cast<const int*>(pos_q),
      static_cast<const int*>(pos_k), static_cast<const float*>(lse),
      static_cast<const float*>(delta), static_cast<const T*>(dout), static_cast<T*>(dq),
      S, Skv, H, Kh, scale, q_off, window);
  return cudaGetLastError();
}

template <int HD>
cudaError_t by_dtype(int dtype, const void* q, const void* k, const void* v,
                     const void* kv_last, const void* pos_q, const void* pos_k,
                     const void* lse, const void* delta, const void* dout, void* dq, int B,
                     int S, int Skv, int H, int Kh, float scale, int q_off, int window,
                     cudaStream_t stream) {
  if (dtype == 0)
    return launch<float, HD, false>(q, k, v, kv_last, pos_q, pos_k, lse, delta, dout, dq,
                                    B, S, Skv, H, Kh, scale, q_off, window, stream);
  if (dtype == 1)
    return launch<__nv_bfloat16, HD, HD % 16 == 0>(q, k, v, kv_last, pos_q, pos_k, lse,
                                                   delta, dout, dq, B, S, Skv, H, Kh,
                                                   scale, q_off, window, stream);
  return cudaErrorInvalidValue;
}

}  // namespace

extern "C" {

// dtype: 0 = float32, 1 = bfloat16.  pos_q/pos_k null ⇒ no window.
// Returns cudaGetLastError() after the launch (0 = ok).
int tree_attention_bwd_dq(const void* q, const void* k, const void* v, const void* kv_last,
                          const void* pos_q, const void* pos_k, const void* lse,
                          const void* delta, const void* dout, void* dq, int B, int S,
                          int Skv, int H, int Kh, int hd, int dtype, float scale, int q_off,
                          int window, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
#define TREE_ATTN_HD(D)                                                                 \
  case D:                                                                               \
    return by_dtype<D>(dtype, q, k, v, kv_last, pos_q, pos_k, lse, delta, dout, dq, B,  \
                       S, Skv, H, Kh, scale, q_off, window, st);
  switch (hd) {
    TREE_ATTN_HD(16)
    TREE_ATTN_HD(24)
    TREE_ATTN_HD(32)
    TREE_ATTN_HD(64)
    TREE_ATTN_HD(96)
    TREE_ATTN_HD(128)
    TREE_ATTN_HD(192)
    default:
      return cudaErrorInvalidValue;
  }
#undef TREE_ATTN_HD
}

const char* tree_attention_bwd_dq_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
