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
// Two paths compute the same function.
//
// Hopper path (bf16 at hd 64 and 128, the models' head dims).  One CUDA
// block of 160 threads owns one (64-query tile, head, batch row): a
// consumer warpgroup (warps 0-3, wgmma's native 64 rows) and a producer
// warp (warp 4).  The producer loads the Q tile by TMA, then walks the
// causal key tiles.  It decides each tile's liveness from the tile's max
// kv_last (and, windowed, its max pos_k against the query tile's min
// pos_q) with the reference's block_live predicate (src/repro/kernels/
// tree_attention.py:75), reading kv_last 16 tiles at a time with one
// warp-wide reduction per tile, and hands the consumers live tiles only:
// for each it stages the tile's kv_last/pos_k by cp.async and brings K and
// V in by TMA into a ring of 2 (hd 128) or 3 (hd 64) stages guarded by
// mbarriers, so it never waits on a load itself.  A dead tile costs no
// load and no barrier.  The producer is hopper.cuh's produce_key_tiles,
// which the dq kernel runs too: the two skip the same tiles.  Tree
// visibility is not monotone along kv, so a dead tile may sit between live
// ones.  The consumers run
// S = Q·Kᵀ as wgmma m64n64k16 from the swizzled shared tiles, the online
// softmax in the accumulator's registers (row max and sum over the four
// threads of a row by shuffles, exp2f with scale·log2e folded in), round P
// to bf16 in registers and feed it as wgmma's A operand for O += P·V, with V
// read MN-major through the descriptor's transpose bit.  O stays in fp32
// registers and is written once.  Blocks run the latest (heaviest) query
// tiles first.  Ragged S and Skv tails read as zero from TMA and are
// masked; a fully masked row keeps o = 0 and lse = −1e30 (the masked
// logits are −inf and the running max starts at the finite −1e30, so no
// exp2f ever sees a NaN).
//
// Simple path (fp32 inputs, the accuracy path, and bf16 at the other head
// dims 16, 24, 32, 96, 192).  One block of 256 threads per (64-query
// tile, head, batch row) walks the key tiles, tests block_live before any
// load, and runs the products on WMMA (bf16 with hd a multiple of 16) or
// fp32 FMA through shared memory.  Every accumulator is fp32 on both paths.
//
// What bounds it on the H100.  At the serving path's shapes (hd 128, GQA
// 12/2, S 1024 chains) the work is about 4·hd FLOPs per visible (i,j) pair
// against 2·hd·2 bytes per key read, so an ideal kernel is bound by the
// tensor cores (989 TFLOP/s bf16), not by memory (3.35 TB/s).  The Hopper
// path's design follows from that: products on wgmma with accumulators in
// registers, loads overlapped with the math, no work or traffic for dead
// tiles.  Each of the G = 6 query heads of a GQA group still loads its own
// K/V tiles (from L2 after the first); PERF.md keeps the measured times.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>

#include "hopper.cuh"

#include <climits>
#include <cmath>
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

// --------------------------------------------------------------------------
// Hopper path: warp-specialised wgmma kernel (bf16, hd 64 and 128)
// --------------------------------------------------------------------------

constexpr int WG_THREADS = 128;               // the consumer warpgroup
constexpr int HOP_THREADS = WG_THREADS + 32;  // + the producer warp

struct FwdMaps {
  CUtensorMap q, k, v;
};

template <int HD>
using FwdLayout = hop::KeyTileLayout<HD, 1>;     // Q resident

template <int HD>
__global__ void __launch_bounds__(HOP_THREADS, 2)
fwd_hopper_kernel(const __grid_constant__ FwdMaps maps, const int* __restrict__ kv_last,
                  const int* __restrict__ pos_q, const int* __restrict__ pos_k,
                  __nv_bfloat16* __restrict__ o, float* __restrict__ lse, int B, int S,
                  int Skv, int H, int Kh, float scale, int q_off, int window) {
  using L = FwdLayout<HD>;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* sm = L::base(smem_raw);
  const hop::KeyRing ring = L::ring(sm);
  const int *kl_s = ring.kl, *pk_s = ring.pk, *k0_s = ring.k0;
  uint64_t *full = ring.full, *empty = ring.empty, *qbar = L::resbar(sm);

  const int nq = (S + BQ - 1) / BQ;
  const int qi = nq - 1 - static_cast<int>(blockIdx.x) / (B * H);   // heaviest first
  const int b = (blockIdx.x / H) % B, h = blockIdx.x % H;
  const int kh = h / (H / Kh);
  const int q0 = qi * BQ, nrows = min(BQ, S - q0);
  const int q_start = q_off + q0;
  const bool windowed = pos_q != nullptr;
  const int tid = threadIdx.x;
  L::init(sm, WG_THREADS);

  if (tid >= WG_THREADS) {
    // ---------------- producer warp (hopper.cuh) ----------------
    const CUtensorMap* const res[1] = {&maps.q};
    hop::produce_key_tiles<HD, L::STAGES>(tid - WG_THREADS, res, sm + L::RES, qbar, &maps.k,
                                          &maps.v, ring, kv_last, pos_q, pos_k, b, h, kh, S,
                                          Skv, q0, nrows, q_off, window);
    return;
  }

  // ---------------- consumer warpgroup ----------------
  const int warp = tid / 32, lane = tid % 32;
  const int r0 = 16 * warp + lane / 4, r1 = r0 + 8;     // this thread's two rows
  const int cq = 2 * (lane % 4);                        // its first column in each 8
  const int iq0 = q_start + r0, iq1 = q_start + r1;
  const bool ok0 = r0 < nrows, ok1 = r1 < nrows;
  int pq0 = 0, pq1 = 0;
  if (windowed) {
    if (ok0) pq0 = pos_q[size_t(b) * S + q0 + r0];
    if (ok1) pq1 = pos_q[size_t(b) * S + q0 + r1];
  }
  const float sl2 = scale * hop::LOG2E;
  float acc[HD / 2];
#pragma unroll
  for (int i = 0; i < HD / 2; ++i) acc[i] = 0.f;
  float m0 = NEG_INF, m1 = NEG_INF, l0 = 0.f, l1 = 0.f;   // log2 domain
  const uint32_t q_base = hop::smem_u32(sm + L::RES);
  hop::mbar_wait(qbar, 0);

  int stage = 0;
  uint32_t phase = 0;
  for (;;) {
    hop::mbar_wait(&full[stage], phase);
    const int k0 = k0_s[stage];
    if (k0 < 0) break;
    const uint32_t k_base = hop::smem_u32(sm + L::KV + stage * 2 * L::TILE);
    const uint32_t v_base = k_base + L::TILE;

    // S = Q·Kᵀ  [64 × 64], fp32 in registers
    float s[32];
#pragma unroll
    for (int i = 0; i < 32; ++i) s[i] = 0.f;
    hop::wgmma_fence();
#pragma unroll
    for (int ks = 0; ks < HD / 16; ++ks)
      hop::wgmma_ss_n64(s, hop::desc_k(q_base, ks), hop::desc_k(k_base, ks), ks > 0);
    hop::wgmma_commit();
    hop::wgmma_wait<0>();
    hop::fence_regs(s);

    // mask, then the online softmax of the reference (m, l, corr), in log2
    const int* kl = kl_s + stage * BK;
    const int* pk = pk_s + stage * BK;
    float mx0 = m0, mx1 = m1;
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int c = 8 * j + cq + e, key = k0 + c, kv = kl[c];
        bool v0 = ok0 && key <= iq0 && kv >= iq0;
        bool v1 = ok1 && key <= iq1 && kv >= iq1;
        if (windowed) {
          v0 = v0 && pq0 - pk[c] < window;
          v1 = v1 && pq1 - pk[c] < window;
        }
        s[4 * j + e] = v0 ? s[4 * j + e] * sl2 : -INFINITY;
        s[4 * j + 2 + e] = v1 ? s[4 * j + 2 + e] * sl2 : -INFINITY;
        mx0 = fmaxf(mx0, s[4 * j + e]);
        mx1 = fmaxf(mx1, s[4 * j + 2 + e]);
      }
    mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, 1));
    mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, 2));
    mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, 1));
    mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, 2));
    const float c0 = exp2f(m0 - mx0), c1 = exp2f(m1 - mx1);
    m0 = mx0;
    m1 = mx1;
    float sum0 = 0.f, sum1 = 0.f;
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        s[4 * j + e] = exp2f(s[4 * j + e] - m0);        // −inf (masked) → 0
        s[4 * j + 2 + e] = exp2f(s[4 * j + 2 + e] - m1);
        sum0 += s[4 * j + e];
        sum1 += s[4 * j + 2 + e];
      }
    l0 = l0 * c0 + sum0;                                 // this thread's share
    l1 = l1 * c1 + sum1;
#pragma unroll
    for (int j = 0; j < HD / 8; ++j) {
      acc[4 * j] *= c0;
      acc[4 * j + 1] *= c0;
      acc[4 * j + 2] *= c1;
      acc[4 * j + 3] *= c1;
    }

    // O += P·V with P rounded to bf16 in registers (wgmma's A operand)
    uint32_t pa[4][4];
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
#pragma unroll
      for (int x = 0; x < 4; ++x)
        pa[kk][x] = hop::pack_bf16(s[8 * kk + 2 * x], s[8 * kk + 2 * x + 1]);
    hop::wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
      hop::wgmma_rs<HD>(acc, pa[kk], hop::desc_mn(v_base + kk * 16 * 128));
    hop::wgmma_commit();
    hop::wgmma_wait<0>();
    hop::fence_regs(acc);
    hop::mbar_arrive(&empty[stage]);
    if (++stage == L::STAGES) {
      stage = 0;
      phase ^= 1;
    }
  }

  l0 += __shfl_xor_sync(0xffffffffu, l0, 1);
  l0 += __shfl_xor_sync(0xffffffffu, l0, 2);
  l1 += __shfl_xor_sync(0xffffffffu, l1, 1);
  l1 += __shfl_xor_sync(0xffffffffu, l1, 2);
  const float inv0 = l0 > 0.f ? 1.f / l0 : 0.f, inv1 = l1 > 0.f ? 1.f / l1 : 0.f;
  __nv_bfloat16* o0 = o + ((size_t(b) * S + q0 + r0) * H + h) * HD + cq;
  __nv_bfloat16* o1 = o + ((size_t(b) * S + q0 + r1) * H + h) * HD + cq;
#pragma unroll
  for (int j = 0; j < HD / 8; ++j) {
    if (ok0)
      *reinterpret_cast<__nv_bfloat162*>(o0 + 8 * j) =
          __floats2bfloat162_rn(acc[4 * j] * inv0, acc[4 * j + 1] * inv0);
    if (ok1)
      *reinterpret_cast<__nv_bfloat162*>(o1 + 8 * j) =
          __floats2bfloat162_rn(acc[4 * j + 2] * inv1, acc[4 * j + 3] * inv1);
  }
  if (lse != nullptr && lane % 4 == 0) {
    if (ok0)
      lse[(size_t(b) * H + h) * S + q0 + r0] = l0 > 0.f ? (m0 + log2f(l0)) * hop::LN2 : NEG_INF;
    if (ok1)
      lse[(size_t(b) * H + h) * S + q0 + r1] = l1 > 0.f ? (m1 + log2f(l1)) * hop::LN2 : NEG_INF;
  }
}

template <int HD>
cudaError_t launch_hopper(const void* q, const void* k, const void* v, const void* kv_last,
                          const void* pos_q, const void* pos_k, void* o, void* lse, int B,
                          int S, int Skv, int H, int Kh, float scale, int q_off, int window,
                          cudaStream_t stream) {
  FwdMaps maps;
  cudaError_t err = hop::tile_map(&maps.q, q, B, S, H, HD);
  if (err == cudaSuccess) err = hop::tile_map(&maps.k, k, B, Skv, Kh, HD);
  if (err == cudaSuccess) err = hop::tile_map(&maps.v, v, B, Skv, Kh, HD);
  if (err != cudaSuccess) return err;
  constexpr int bytes = FwdLayout<HD>::ALLOC;
  auto kern = fwd_hopper_kernel<HD>;
  err = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err != cudaSuccess) return err;
  const int nq = (S + BQ - 1) / BQ;
  kern<<<nq * H * B, HOP_THREADS, bytes, stream>>>(
      maps, static_cast<const int*>(kv_last), static_cast<const int*>(pos_q),
      static_cast<const int*>(pos_k), static_cast<__nv_bfloat16*>(o), static_cast<float*>(lse),
      B, S, Skv, H, Kh, scale, q_off, window);
  return cudaGetLastError();
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
  if (dtype != 1) return cudaErrorInvalidValue;
  if constexpr (HD == 64 || HD == 128)
    return launch_hopper<HD>(q, k, v, kv_last, pos_q, pos_k, o, lse, B, S, Skv, H, Kh, scale,
                             q_off, window, stream);
  else
    return launch<__nv_bfloat16, HD, HD % 16 == 0>(q, k, v, kv_last, pos_q, pos_k, o, lse,
                                                   B, S, Skv, H, Kh, scale, q_off, window,
                                                   stream);
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
