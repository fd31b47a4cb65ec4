// Tree flash-attention backward, dk and dv, for Hopper (sm_90a), behind a
// plain C entry point that Python loads with ctypes
// (src/repro_torch/kernels/tree_attention_bwd.py).
//
// Replaces: the Pallas TPU kernel src/repro/kernels/tree_attention_bwd.py::
// _bwd_dkv (kernel body :185-243, pallas_call :278).  Same function: with
// p_ij = exp(scale·q_i·k_j − lse_i) on visible pairs (0 elsewhere),
// Δ_i = Σ_d do_id·o_id (computed by the wrapper) and
// ds_ij = p_ij · (do_i·v_j − Δ_i) · scale,
//   dv_j = Σ_{h in j's GQA group} Σ_i p_ij · do_i,
//   dk_j = Σ_{h in j's GQA group} Σ_i ds_ij · q_i,
// over the FULL kv length: rows [0, q_off) are the gateway ancestors'
// cotangents, and keys no query sees (padding, kv_last = −1) get exactly 0.
//
// Design.  One CUDA block of 256 threads owns one (key tile, kv head,
// batch row) and keeps that tile's K and V in shared memory.  It loops over
// the G query heads of the group and, inside, over the 64-query tiles,
// accumulating dK and dV in fp32 shared memory; it writes dk and dv once.
// That keeps the reference's in-program GQA reduction (its grid is
// (B, Kh, nk, G, nq)) with no atomics, so two launches give bit-identical
// dk and dv.  The query loop starts at the first tile whose global end
// q_off + qi·64 + 63 reaches the key tile's start, and tests every tile
// after it with the forward's block_live predicate (the tile's max
// kv_last, and with a window its min pos_q against the key tile's max
// pos_k) before any load.  Ragged S and Skv tails are zero-filled and
// masked.  The key tile is 64 wide, as in the forward, wherever that fits
// in shared memory (hd ≤ 128 in bf16, hd ≤ 128 in f32); at hd 192 it is
// 32, which tests the same predicate at a finer key granularity.
//
// Products: S = Q·Kᵀ and dP = dO·Vᵀ, then dV += Pᵀ·dO and dK += dSᵀ·Q.
// bf16 inputs with hd a multiple of 16 use WMMA (fp32 accumulate; P and dS
// are rounded to bf16 before the last two products, as FlashAttention-2/3
// do); fp32 inputs use fp32 FMA, matching the plain version to summation
// order.
//
// What bounds it on the H100: about 8·hd FLOPs per visible (i, j) pair and
// query head (four products of 2·hd), so at hd 128 an ideal kernel is bound
// by the tensor cores (989 TFLOP/s bf16), not by memory.  This simple
// kernel does nothing about that yet: WMMA through shared memory with the
// accumulators there too, no TMA, no wgmma, no overlap of loads with math,
// and only B·Kh·(Skv/64) blocks (256 at the training shape) for 132 SMs.
// PERF.md keeps its measured times; making it fast is later work.

#include "tree_attention_bwd.cuh"

namespace {

using namespace tab;

template <int HD, bool MMA, int BK>
struct Layout {
  using E = Elem<MMA>;
  static constexpr int ES = static_cast<int>(sizeof(E));
  static constexpr int LD = tile_ld<HD, MMA>();
  static constexpr int LDP = BK + 8;       // bf16 P and dS (MMA path)
  static constexpr int LDA = MMA ? HD + 4 : HD;   // fp32 dK/dV accumulators
  static constexpr int K = 0;
  static constexpr int V = K + align128(BK * LD * ES);
  static constexpr int Q = V + align128(BK * LD * ES);
  static constexpr int DO = Q + align128(BQ * LD * ES);
  static constexpr int S = DO + align128(BQ * LD * ES);
  static constexpr int DP = S + align128(BQ * BK * 4);
  static constexpr int PB = DP + align128(BQ * BK * 4);
  static constexpr int DSB = PB + (MMA ? align128(BQ * LDP * 2) : 0);
  static constexpr int DK = DSB + (MMA ? align128(BQ * LDP * 2) : 0);
  static constexpr int DV = DK + align128(BK * LDA * 4);
  static constexpr int KL = DV + align128(BK * LDA * 4);
  static constexpr int PK = KL + align128(BK * 4);
  static constexpr int PQ = PK + align128(BK * 4);
  static constexpr int LSE = PQ + align128(BQ * 4);
  static constexpr int DL = LSE + align128(BQ * 4);
  static constexpr int BYTES = DL + align128(BQ * 4);
};

// The key tile: 64 wide where that fits in shared memory, else 32.
template <int HD, bool MMA>
struct KeyTile {
  static constexpr int value = Layout<HD, MMA, 64>::BYTES <= MAX_SMEM ? 64 : 32;
};

template <int HD, bool MMA>
using Smem = Layout<HD, MMA, KeyTile<HD, MMA>::value>;

// C[BK][HD] += Aᵀ·B in fp32 shared memory (pitch LDC): A is a [BQ][BK] tile
// (P or dS) and B a [BQ][HD] tile (dO or Q), both row-major.
template <int HD, int BK, bool MMA>
__device__ __forceinline__ void gemm_atb_acc(float* C, const void* A, const Elem<MMA>* B) {
  using L = Layout<HD, MMA, BK>;
  const int tid = threadIdx.x, warp = tid / 32;
  if constexpr (MMA) {
    using namespace nvcuda;
    const __nv_bfloat16* Ab = static_cast<const __nv_bfloat16*>(A);
    for (int f = warp; f < (BK / 16) * (HD / 16); f += NWARPS) {
      const int fm = f / (HD / 16), fn = f % (HD / 16);
      float* c = C + fm * 16 * L::LDA + fn * 16;
      wmma::fragment<wmma::accumulator, 16, 16, 16, float> cf;
      wmma::load_matrix_sync(cf, c, L::LDA, wmma::mem_row_major);
      for (int i = 0; i < BQ; i += 16) {
        // Aᵀ's (m = key, k = query) element sits at A[query][key]: col-major
        wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16, wmma::col_major> af;
        wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16, wmma::row_major> bf;
        wmma::load_matrix_sync(af, Ab + i * L::LDP + fm * 16, L::LDP);
        wmma::load_matrix_sync(bf, B + i * L::LD + fn * 16, L::LD);
        wmma::mma_sync(cf, af, bf, cf);
      }
      wmma::store_matrix_sync(c, cf, L::LDA, wmma::mem_row_major);
    }
  } else {
    const float* Af = static_cast<const float*>(A);
#pragma unroll
    for (int e = 0; e < BK * HD / NTHREADS; ++e) {
      const int idx = tid + e * NTHREADS, j = idx / HD, c = idx % HD;
      float s = 0.f;
      for (int i = 0; i < BQ; ++i) s = fmaf(Af[i * BK + j], B[i * L::LD + c], s);
      C[j * L::LDA + c] += s;
    }
  }
}

template <typename T, int HD, bool MMA>
__global__ void __launch_bounds__(NTHREADS)
tree_attention_bwd_dkv_kernel(const T* __restrict__ q, const T* __restrict__ k,
                              const T* __restrict__ v, const int* __restrict__ kv_last,
                              const int* __restrict__ pos_q, const int* __restrict__ pos_k,
                              const float* __restrict__ lse,
                              const float* __restrict__ delta, const T* __restrict__ dout,
                              T* __restrict__ dk, T* __restrict__ dv, int S, int Skv, int H,
                              int Kh, float scale, int q_off, int window) {
  constexpr int BK = KeyTile<HD, MMA>::value;
  using L = Layout<HD, MMA, BK>;
  using E = typename L::E;
  constexpr int LD = L::LD;
  extern __shared__ __align__(128) unsigned char smem[];
  __shared__ int kmax_s, kpmax_s;
  E* Ks = reinterpret_cast<E*>(smem + L::K);
  E* Vs = reinterpret_cast<E*>(smem + L::V);
  E* Qs = reinterpret_cast<E*>(smem + L::Q);
  E* DOs = reinterpret_cast<E*>(smem + L::DO);
  float* Ss = reinterpret_cast<float*>(smem + L::S);
  float* DPs = reinterpret_cast<float*>(smem + L::DP);
  __nv_bfloat16* Pb = reinterpret_cast<__nv_bfloat16*>(smem + L::PB);
  __nv_bfloat16* DSb = reinterpret_cast<__nv_bfloat16*>(smem + L::DSB);
  float* DKs = reinterpret_cast<float*>(smem + L::DK);
  float* DVs = reinterpret_cast<float*>(smem + L::DV);
  int* kl_s = reinterpret_cast<int*>(smem + L::KL);
  int* pk_s = reinterpret_cast<int*>(smem + L::PK);
  int* pq_s = reinterpret_cast<int*>(smem + L::PQ);
  float* lse_s = reinterpret_cast<float*>(smem + L::LSE);
  float* dl_s = reinterpret_cast<float*>(smem + L::DL);

  const int tid = threadIdx.x;
  const int b = blockIdx.z, kh = blockIdx.y;
  const int G = H / Kh;
  const int k0 = blockIdx.x * BK;           // first key of the tile
  const int ncols = min(BK, Skv - k0);
  const bool windowed = pos_q != nullptr;

  const size_t krow = (size_t(b) * Skv + k0) * Kh + kh;   // key k0, kv head kh
  load_tile<BK, HD, LD>(Ks, k + krow * HD, size_t(Kh) * HD, ncols);
  load_tile<BK, HD, LD>(Vs, v + krow * HD, size_t(Kh) * HD, ncols);
  for (int idx = tid; idx < BK * L::LDA; idx += NTHREADS) {
    DKs[idx] = 0.f;
    DVs[idx] = 0.f;
  }
  if (tid == 0) {
    kmax_s = INT_MIN;
    kpmax_s = INT_MIN;
  }
  int kl = -1, pk = 0;
  if (tid < ncols) {
    kl = kv_last[size_t(b) * Skv + k0 + tid];
    if (windowed) pk = pos_k[size_t(b) * Skv + k0 + tid];
  }
  if (tid < BK) {
    kl_s[tid] = kl;
    pk_s[tid] = pk;
  }
  __syncthreads();
  // the tile's max kv_last and (windowed) max pos_k over its real keys
  if (tid < ncols) {
    atomicMax(&kmax_s, kl);
    atomicMax(&kpmax_s, pk);
  }
  __syncthreads();
  const int kmax = kmax_s, kp_max = kpmax_s;

  const int nq = (S + BQ - 1) / BQ;
  const int qi0 = k0 > q_off ? (k0 - q_off) / BQ : 0;   // first tile reaching k0
  for (int g = 0; g < G; ++g) {
    const int h = kh * G + g;
    for (int qi = qi0; qi < nq; ++qi) {
      const int q0 = qi * BQ;
      const int nrows = min(BQ, S - q0);
      const int q_start = q_off + q0;
      const int q_end = q_start + nrows - 1;
      // block_live(q_start, q_end, k0, kmax, min pos_q, kp_max, window)
      if (!(k0 <= q_end && kmax >= q_start)) continue;
      if (windowed) {
        int pq = 0;
        if (tid < nrows) pq = pos_q[size_t(b) * S + q0 + tid];
        if (tid < BQ) pq_s[tid] = pq;
        if (!__syncthreads_or(tid < nrows && pq - kp_max < window)) continue;
      }

      const size_t qrow = (size_t(b) * S + q0) * H + h;
      load_tile<BQ, HD, LD>(Qs, q + qrow * HD, size_t(H) * HD, nrows);
      load_tile<BQ, HD, LD>(DOs, dout + qrow * HD, size_t(H) * HD, nrows);
      for (int r = tid; r < BQ; r += NTHREADS) {
        const size_t gi = (size_t(b) * H + h) * S + q0 + r;
        lse_s[r] = r < nrows ? lse[gi] : 0.f;
        dl_s[r] = r < nrows ? delta[gi] : 0.f;
      }
      __syncthreads();
      gemm_abt<BQ, BK, HD, LD, MMA>(Ss, Qs, Ks);      // S  = Q·Kᵀ
      gemm_abt<BQ, BK, HD, LD, MMA>(DPs, DOs, Vs);    // dP = dO·Vᵀ
      __syncthreads();

      // P and dS = P ∘ (dP − Δ) · scale
      for (int idx = tid; idx < BQ * BK; idx += NTHREADS) {
        const int r = idx / BK, c = idx % BK;
        const int iq = q_start + r;
        bool vis = r < nrows && c < ncols && k0 + c <= iq && kl_s[c] >= iq;
        if (windowed) vis = vis && (pq_s[r] - pk_s[c] < window);
        const float p = masked_p(vis, Ss[idx], scale, lse_s[r]);
        const float ds = p * (DPs[idx] - dl_s[r]) * scale;
        if constexpr (MMA) {
          Pb[r * L::LDP + c] = __float2bfloat16(p);
          DSb[r * L::LDP + c] = __float2bfloat16(ds);
        } else {
          Ss[idx] = p;
          DPs[idx] = ds;
        }
      }
      __syncthreads();
      if constexpr (MMA) {
        gemm_atb_acc<HD, BK, MMA>(DVs, Pb, DOs);     // dV += Pᵀ·dO
        gemm_atb_acc<HD, BK, MMA>(DKs, DSb, Qs);     // dK += dSᵀ·Q
      } else {
        gemm_atb_acc<HD, BK, MMA>(DVs, Ss, DOs);
        gemm_atb_acc<HD, BK, MMA>(DKs, DPs, Qs);
      }
      __syncthreads();                      // tiles are reused by the next step
    }
  }

  for (int idx = tid; idx < BK * HD; idx += NTHREADS) {
    const int j = idx / HD, c = idx % HD;
    if (j < ncols) {
      const size_t o = (krow + size_t(j) * Kh) * HD + c;
      dk[o] = from_f32<T>(DKs[j * L::LDA + c]);
      dv[o] = from_f32<T>(DVs[j * L::LDA + c]);
    }
  }
}

template <typename T, int HD, bool MMA>
cudaError_t launch(const void* q, const void* k, const void* v, const void* kv_last,
                   const void* pos_q, const void* pos_k, const void* lse,
                   const void* delta, const void* dout, void* dk, void* dv, int B, int S,
                   int Skv, int H, int Kh, float scale, int q_off, int window,
                   cudaStream_t stream) {
  constexpr int BK = KeyTile<HD, MMA>::value;
  constexpr int bytes = Smem<HD, MMA>::BYTES;
  static_assert(bytes <= MAX_SMEM, "dk/dv tile does not fit shared memory");
  auto kern = tree_attention_bwd_dkv_kernel<T, HD, MMA>;
  cudaError_t err =
      cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err != cudaSuccess) return err;
  const dim3 grid((Skv + BK - 1) / BK, Kh, B);
  kern<<<grid, NTHREADS, bytes, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<const int*>(kv_last), static_cast<const int*>(pos_q),
      static_cast<const int*>(pos_k), static_cast<const float*>(lse),
      static_cast<const float*>(delta), static_cast<const T*>(dout), static_cast<T*>(dk),
      static_cast<T*>(dv), S, Skv, H, Kh, scale, q_off, window);
  return cudaGetLastError();
}

template <int HD>
cudaError_t by_dtype(int dtype, const void* q, const void* k, const void* v,
                     const void* kv_last, const void* pos_q, const void* pos_k,
                     const void* lse, const void* delta, const void* dout, void* dk,
                     void* dv, int B, int S, int Skv, int H, int Kh, float scale, int q_off,
                     int window, cudaStream_t stream) {
  if (dtype == 0)
    return launch<float, HD, false>(q, k, v, kv_last, pos_q, pos_k, lse, delta, dout, dk,
                                    dv, B, S, Skv, H, Kh, scale, q_off, window, stream);
  if (dtype == 1)
    return launch<__nv_bfloat16, HD, HD % 16 == 0>(q, k, v, kv_last, pos_q, pos_k, lse,
                                                   delta, dout, dk, dv, B, S, Skv, H, Kh,
                                                   scale, q_off, window, stream);
  return cudaErrorInvalidValue;
}

}  // namespace

extern "C" {

// dtype: 0 = float32, 1 = bfloat16.  pos_q/pos_k null ⇒ no window.
// Returns cudaGetLastError() after the launch (0 = ok).
int tree_attention_bwd_dkv(const void* q, const void* k, const void* v, const void* kv_last,
                           const void* pos_q, const void* pos_k, const void* lse,
                           const void* delta, const void* dout, void* dk, void* dv, int B,
                           int S, int Skv, int H, int Kh, int hd, int dtype, float scale,
                           int q_off, int window, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
#define TREE_ATTN_HD(D)                                                                 \
  case D:                                                                               \
    return by_dtype<D>(dtype, q, k, v, kv_last, pos_q, pos_k, lse, delta, dout, dk, dv, \
                       B, S, Skv, H, Kh, scale, q_off, window, st);
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

const char* tree_attention_bwd_dkv_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
