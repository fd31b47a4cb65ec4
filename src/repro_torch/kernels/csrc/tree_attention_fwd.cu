// Tree flash-attention forward for Hopper (sm_90a), behind a plain C entry
// point that Python loads with ctypes (src/repro_torch/kernels/tree_attention.py).
//
// Replaces: the Pallas TPU kernel src/repro/kernels/tree_attention.py::
// tree_attention (kernel body :146-218, pallas_call :248).  Same function:
//   o[b,i,h]   = softmax_j(scale · q[b,i,h]·k[b,j,h/G]) · v[b,j,h/G]
//   visible(i,j) ⇔ j ≤ q_off+i ∧ kv_last[b,j] ≥ q_off+i
//                  [∧ pos_q[b,i] − pos_k[b,j] < window]
//   lse[b,h,i] = m + log(l)   (−1e30 for a row that sees no key; its o is 0)
// q/o: [B,S,H,hd], k/v: [B,Skv,Kh,hd] (contiguous), kv_last/pos: int32.
//
// Design.  One CUDA block of 256 threads owns one (64-query tile, head,
// batch row).  A loop inside the block walks the 64-key tiles; it takes the
// place of the TPU's sequential kv grid axis and its VMEM carry, and keeps
// the online-softmax state (m, l in shared memory, the output accumulator
// in registers) across tiles.  The loop stops at the last causal tile, and
// every tile inside it is tested with the reference's block_live predicate
// (tree_attention.py:75) before anything is loaded: tree visibility is not
// monotone along kv, so a dead tile may sit between live ones, and a dead
// tile here skips its loads as well as its math.  Ragged S and Skv tails are
// masked in-kernel (zero-filled rows, invisible keys), so no block size has
// to divide them.  Fully masked rows keep the reference's finite −1e30
// sentinel and its where(vis, exp, 0) guard, so they give 0, never NaN.
//
// The two products: bf16 inputs with hd a multiple of 16 use WMMA (16×16×16
// bf16 tensor-core tiles, fp32 accumulate; P is rounded to bf16 for P·V);
// fp32 inputs (and bf16 at hd 24) use fp32 FMA on CUDA cores, so fp32 keeps
// full precision.  Every accumulator is fp32.
//
// What bounds it on the H100.  At the serving path's shapes (hd 128, GQA
// 12/2, S 1024 chains) the work is about 4·hd FLOPs per visible (i,j) pair
// against 2·hd·2 bytes per key read, so an ideal kernel is bound by the
// tensor cores (989 TFLOP/s bf16), not by memory (3.35 TB/s).  This simple
// kernel is far from that: WMMA through shared memory, no TMA, no wgmma, no
// warp specialisation, no overlap of loads with math, and each of the G=6
// query heads of a GQA group reloads its K/V tile.  Those are later work.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>

#include <climits>
#include <type_traits>

namespace {

constexpr int BQ = 64;              // queries per tile (one CUDA block)
constexpr int BK = 64;              // keys per tile (one loop step)
constexpr int NTHREADS = 256;
constexpr int NWARPS = NTHREADS / 32;
constexpr float NEG_INF = -1e30f;   // the reference's finite sentinel

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

// Shared-memory layout of one block; the host sizes the launch from it.
template <int HD, bool MMA>
struct Smem {
  using E = typename std::conditional<MMA, __nv_bfloat16, float>::type;
  static constexpr int ES = static_cast<int>(sizeof(E));
  // q/k rows padded: +1 float breaks the 32-bank stride for the FMA path,
  // +8 bf16 keeps WMMA's 16-byte ldm rule and spreads its row loads.
  static constexpr int LDQ = MMA ? HD + 8 : HD + 1;
  static constexpr int LDV = MMA ? HD + 8 : HD;
  static constexpr int LDP = BK + 8;    // bf16 probabilities (MMA path)
  static constexpr int LDO = HD + 4;    // fp32 P·V tile (MMA path)
  static constexpr int Q = 0;
  static constexpr int K = Q + align128(BQ * LDQ * ES);
  static constexpr int V = K + align128(BK * LDQ * ES);
  static constexpr int S = V + align128(BK * LDV * ES);
  static constexpr int P = S + align128(BQ * BK * 4);
  static constexpr int PV = P + (MMA ? align128(BQ * LDP * 2) : 0);
  static constexpr int KL = PV + (MMA ? align128(BQ * LDO * 4) : 0);
  static constexpr int PK = KL + align128(BK * 4);
  static constexpr int PQ = PK + align128(BK * 4);
  static constexpr int M = PQ + align128(BQ * 4);
  static constexpr int L = M + align128(BQ * 4);
  static constexpr int C = L + align128(BQ * 4);
  static constexpr int BYTES = C + align128(BQ * 4);
};

__device__ __forceinline__ float warp_max(float x) {
  for (int o = 16; o > 0; o >>= 1) x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, o));
  return x;
}
__device__ __forceinline__ float warp_sum(float x) {
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

template <typename T, int HD, bool MMA>
__global__ void __launch_bounds__(NTHREADS)
tree_attention_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                          const T* __restrict__ v, const int* __restrict__ kv_last,
                          const int* __restrict__ pos_q, const int* __restrict__ pos_k,
                          T* __restrict__ o, float* __restrict__ lse, int S, int Skv,
                          int H, int Kh, float scale, int q_off, int window) {
  using L = Smem<HD, MMA>;
  using E = typename L::E;
  constexpr int PER = BQ * HD / NTHREADS;   // output elements per thread
  extern __shared__ __align__(128) unsigned char smem[];
  __shared__ int qp_min_s;
  E* Qs = reinterpret_cast<E*>(smem + L::Q);
  E* Ks = reinterpret_cast<E*>(smem + L::K);
  E* Vs = reinterpret_cast<E*>(smem + L::V);
  float* Ss = reinterpret_cast<float*>(smem + L::S);
  __nv_bfloat16* Ps = reinterpret_cast<__nv_bfloat16*>(smem + L::P);
  float* PVs = reinterpret_cast<float*>(smem + L::PV);
  int* kl_s = reinterpret_cast<int*>(smem + L::KL);
  int* pk_s = reinterpret_cast<int*>(smem + L::PK);
  int* pq_s = reinterpret_cast<int*>(smem + L::PQ);
  float* m_s = reinterpret_cast<float*>(smem + L::M);
  float* l_s = reinterpret_cast<float*>(smem + L::L);
  float* c_s = reinterpret_cast<float*>(smem + L::C);

  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int b = blockIdx.z, h = blockIdx.y;
  const int kh = h / (H / Kh);
  const int q0 = blockIdx.x * BQ;            // local index of the tile's first query
  const int nrows = min(BQ, S - q0);
  const int q_start = q_off + q0;            // global DFS index
  const int q_end = q_start + nrows - 1;
  const bool windowed = pos_q != nullptr;

  for (int idx = tid; idx < BQ * HD; idx += NTHREADS) {
    const int r = idx / HD, c = idx % HD;
    const float x = r < nrows ? to_f32(q[((size_t(b) * S + q0 + r) * H + h) * HD + c]) : 0.f;
    Qs[r * L::LDQ + c] = from_f32<E>(x);
  }
  if (tid == 0) qp_min_s = INT_MAX;
  for (int r = tid; r < BQ; r += NTHREADS) {
    m_s[r] = NEG_INF;
    l_s[r] = 0.f;
    pq_s[r] = (windowed && r < nrows) ? pos_q[size_t(b) * S + q0 + r] : 0;
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

    for (int idx = tid; idx < BK * HD; idx += NTHREADS) {
      const int r = idx / HD, c = idx % HD;
      const size_t g = ((size_t(b) * Skv + k0 + r) * Kh + kh) * HD + c;
      const bool ok = r < ncols;
      Ks[r * L::LDQ + c] = from_f32<E>(ok ? to_f32(k[g]) : 0.f);
      Vs[r * L::LDV + c] = from_f32<E>(ok ? to_f32(v[g]) : 0.f);
    }
    __syncthreads();

    // S = Q·Kᵀ  [BQ, BK] fp32
    if constexpr (MMA) {
      using namespace nvcuda;
      for (int f = warp; f < (BQ / 16) * (BK / 16); f += NWARPS) {
        const int fm = f / (BK / 16), fn = f % (BK / 16);
        wmma::fragment<wmma::accumulator, 16, 16, 16, float> cf;
        wmma::fill_fragment(cf, 0.f);
        for (int d = 0; d < HD; d += 16) {
          wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16, wmma::row_major> af;
          wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16, wmma::col_major> bf;
          wmma::load_matrix_sync(af, Qs + fm * 16 * L::LDQ + d, L::LDQ);
          wmma::load_matrix_sync(bf, Ks + fn * 16 * L::LDQ + d, L::LDQ);
          wmma::mma_sync(cf, af, bf, cf);
        }
        wmma::store_matrix_sync(Ss + fm * 16 * BK + fn * 16, cf, BK, wmma::mem_row_major);
      }
    } else {
      const int tx = tid % 16, ty = tid / 16;
      float s[4][4] = {};
      for (int d = 0; d < HD; ++d) {
        float a[4], bb[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) a[i] = Qs[(ty + 16 * i) * L::LDQ + d];
#pragma unroll
        for (int j = 0; j < 4; ++j) bb[j] = Ks[(tx + 16 * j) * L::LDQ + d];
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j) s[i][j] = fmaf(a[i], bb[j], s[i][j]);
      }
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) Ss[(ty + 16 * i) * BK + tx + 16 * j] = s[i][j];
    }
    __syncthreads();

    // online softmax, one warp per row (the reference's m/l/corr update)
    for (int r = warp; r < BQ; r += NWARPS) {
      const int iq = q_start + r;
      const bool row_ok = r < nrows;
      float lg[BK / 32];
      bool vis[BK / 32];
      float mx = NEG_INF;
#pragma unroll
      for (int u = 0; u < BK / 32; ++u) {
        const int c = lane + 32 * u;
        bool ok = row_ok && c < ncols && k0 + c <= iq && kl_s[c] >= iq;
        if (windowed) ok = ok && (pq_s[r] - pk_s[c] < window);
        vis[u] = ok;
        lg[u] = ok ? Ss[r * BK + c] * scale : NEG_INF;
        mx = fmaxf(mx, lg[u]);
      }
      const float m_prev = m_s[r];
      const float m_new = fmaxf(m_prev, warp_max(mx));
      float sum = 0.f;
#pragma unroll
      for (int u = 0; u < BK / 32; ++u) {
        const int c = lane + 32 * u;
        const float p = vis[u] ? expf(lg[u] - m_new) : 0.f;
        sum += p;
        if constexpr (MMA) Ps[r * L::LDP + c] = __float2bfloat16(p);
        else Ss[r * BK + c] = p;
      }
      sum = warp_sum(sum);
      if (lane == 0) {
        const float corr = expf(m_prev - m_new);
        c_s[r] = corr;
        l_s[r] = l_s[r] * corr + sum;
        m_s[r] = m_new;
      }
    }
    __syncthreads();

    // acc = acc·corr + P·V
    if constexpr (MMA) {
      using namespace nvcuda;
      for (int f = warp; f < (BQ / 16) * (HD / 16); f += NWARPS) {
        const int fm = f / (HD / 16), fn = f % (HD / 16);
        wmma::fragment<wmma::accumulator, 16, 16, 16, float> cf;
        wmma::fill_fragment(cf, 0.f);
        for (int j = 0; j < BK; j += 16) {
          wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16, wmma::row_major> af;
          wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16, wmma::row_major> bf;
          wmma::load_matrix_sync(af, Ps + fm * 16 * L::LDP + j, L::LDP);
          wmma::load_matrix_sync(bf, Vs + j * L::LDV + fn * 16, L::LDV);
          wmma::mma_sync(cf, af, bf, cf);
        }
        wmma::store_matrix_sync(PVs + fm * 16 * L::LDO + fn * 16, cf, L::LDO,
                                wmma::mem_row_major);
      }
      __syncthreads();
#pragma unroll
      for (int e = 0; e < PER; ++e) {
        const int idx = tid + e * NTHREADS, r = idx / HD, c = idx % HD;
        acc[e] = acc[e] * c_s[r] + PVs[r * L::LDO + c];
      }
    } else {
#pragma unroll
      for (int e = 0; e < PER; ++e) {
        const int idx = tid + e * NTHREADS, r = idx / HD, c = idx % HD;
        float s = 0.f;
        for (int j = 0; j < BK; ++j) s = fmaf(Ss[r * BK + j], Vs[j * L::LDV + c], s);
        acc[e] = acc[e] * c_s[r] + s;
      }
    }
  }
  __syncthreads();

#pragma unroll
  for (int e = 0; e < PER; ++e) {
    const int idx = tid + e * NTHREADS, r = idx / HD, c = idx % HD;
    if (r < nrows) {
      const float l = l_s[r];
      const float val = l > 0.f ? acc[e] / fmaxf(l, 1e-37f) : 0.f;
      o[((size_t(b) * S + q0 + r) * H + h) * HD + c] = from_f32<T>(val);
    }
  }
  if (lse != nullptr) {
    for (int r = tid; r < nrows; r += NTHREADS) {
      const float l = l_s[r];
      lse[(size_t(b) * H + h) * S + q0 + r] =
          l > 0.f ? m_s[r] + logf(fmaxf(l, 1e-37f)) : NEG_INF;
    }
  }
}

template <typename T, int HD, bool MMA>
cudaError_t launch(const void* q, const void* k, const void* v, const void* kv_last,
                   const void* pos_q, const void* pos_k, void* o, void* lse, int B, int S,
                   int Skv, int H, int Kh, float scale, int q_off, int window,
                   cudaStream_t stream) {
  constexpr int bytes = Smem<HD, MMA>::BYTES;
  auto kern = tree_attention_fwd_kernel<T, HD, MMA>;
  cudaError_t err =
      cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err != cudaSuccess) return err;
  const dim3 grid((S + BQ - 1) / BQ, H, B);
  kern<<<grid, NTHREADS, bytes, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<const int*>(kv_last), static_cast<const int*>(pos_q),
      static_cast<const int*>(pos_k), static_cast<T*>(o), static_cast<float*>(lse), S, Skv,
      H, Kh, scale, q_off, window);
  return cudaGetLastError();
}

template <int HD>
cudaError_t by_dtype(int dtype, const void* q, const void* k, const void* v,
                     const void* kv_last, const void* pos_q, const void* pos_k, void* o,
                     void* lse, int B, int S, int Skv, int H, int Kh, float scale, int q_off,
                     int window, cudaStream_t stream) {
  if (dtype == 0)
    return launch<float, HD, false>(q, k, v, kv_last, pos_q, pos_k, o, lse, B, S, Skv, H,
                                    Kh, scale, q_off, window, stream);
  if (dtype == 1)
    return launch<__nv_bfloat16, HD, HD % 16 == 0>(q, k, v, kv_last, pos_q, pos_k, o, lse,
                                                   B, S, Skv, H, Kh, scale, q_off, window,
                                                   stream);
  return cudaErrorInvalidValue;
}

}  // namespace

extern "C" {

// dtype: 0 = float32, 1 = bfloat16.  pos_q/pos_k null ⇒ no window; lse null
// ⇒ no residuals.  Returns cudaGetLastError() after the launch (0 = ok).
int tree_attention_fwd(const void* q, const void* k, const void* v, const void* kv_last,
                       const void* pos_q, const void* pos_k, void* o, void* lse, int B,
                       int S, int Skv, int H, int Kh, int hd, int dtype, float scale,
                       int q_off, int window, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
#define TREE_ATTN_HD(D)                                                                   \
  case D:                                                                                 \
    return by_dtype<D>(dtype, q, k, v, kv_last, pos_q, pos_k, o, lse, B, S, Skv, H, Kh,   \
                       scale, q_off, window, st);
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

const char* tree_attention_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
