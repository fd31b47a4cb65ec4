// Tree flash-attention backward, dk and dv, for Hopper (sm_90a), behind a
// plain C entry point that Python loads with ctypes
// (src/repro_torch/kernels/tree_attention_bwd.py).
//
// Replaces: the Pallas TPU kernel src/repro/kernels/tree_attention_bwd.py::
// _bwd_dkv (kernel body :185-243, pallas_call :278).  Same function: with
// p_ij = exp(scale·q_i·k_j − lse_i) on visible pairs (0 elsewhere),
// Δ_i = Σ_d do_id·o_id (handed over by the dq launch before it, whose
// kernel computes it on its bf16 Hopper path, hd 64/96/128/192; a torch
// reduction in the wrapper computes it elsewhere) and
// ds_ij = p_ij · (do_i·v_j − Δ_i) · scale,
//   dv_j = Σ_{h in j's GQA group} Σ_i p_ij · do_i,
//   dk_j = Σ_{h in j's GQA group} Σ_i ds_ij · q_i,
// over the FULL kv length: rows [0, q_off) are the gateway ancestors'
// cotangents, and keys no query sees (padding, kv_last = −1) get exactly 0.
//
// Two paths compute the same function, with no atomics on dk, dv or their
// partials: two launches give bit-identical dk and dv.
//
// Hopper path (bf16 at hd 64, 96, 128 and 192, the models' head dims), in
// FlashAttention-3's backward orientation: the key tile is wgmma's M.  One
// CUDA block of 160 threads owns one (64-key tile, kv head, batch row, part
// of the GQA group): a consumer warpgroup (warps 0-3) and a producer warp
// (warp 4).  The producer stages the key tile's kv_last/pos_k, loads K and
// V once by TMA, and takes their max kv_last (and max pos_k); then, for
// each query head of its part and each query tile that block_live keeps
// (without a window the contiguous run from the first tile that reaches
// the key tile to the one that holds its max kv_last; with one, each tile
// is also tested against its min pos_q), it brings Q and dO in by TMA and
// lse, Δ (and pos_q) by cp.async into a 3-stage (hd 96: 2) mbarrier ring.  The
// consumers compute Sᵀ = K·Qᵀ and dPᵀ = V·dOᵀ as wgmma m64n32k16 over each
// half of the query tile, form Pᵀ = exp(s·scale − lse) on visible pairs and
// dSᵀ = Pᵀ∘(dPᵀ − Δ)·scale in the accumulators' registers, round both to
// bf16 there and feed them as wgmma's A operand for dV += Pᵀ·dO and
// dK += dSᵀ·Q (dO and Q read MN-major through the transpose bit).  dK and
// dV stay in fp32 registers across the whole loop over heads and query
// tiles and are written once.  The two accumulators take 128 registers a
// thread at hd 128, so that instance runs one block per SM (see
// dkv_hopper_kernel).  hd 96 (Phi-3-vision) runs this kernel on tiles of
// two 64-column boxes (16 KB, as at hd 128; box 1's columns 96-127 are
// TMA's out-of-bounds zeros, hopper.cuh): Sᵀ and dPᵀ take 6 k16 steps, dV
// and dK are m64n96k16 (48 + 48 accumulator registers), and dk/dv (or
// their fp32 partials) are stored as 96 columns;
// two blocks an SM, as at hd 64, with a 2-stage ring (see
// dkv_hopper_kernel).  A one-block pass first orders the key
// tiles heaviest first (dkv_schedule_kernel), and the GQA group is split into
// `parts` parts across blocks to shorten the heaviest block; each part
// writes fp32 partials that a last pass (sum_parts) adds in a fixed order.
// Ragged S and Skv read as zero from TMA and are masked; keys no query
// sees get exactly 0.
//
// hd 192 (Nemotron-4 340B).  dK and dV would take 96 + 96 fp32 registers a
// thread, and Sᵀ, dPᵀ, their bf16 fragments and the addresses push one
// warpgroup past the 255-register limit: it would spill.  So a block has
// two consumer warpgroups (288 threads with the producer warp, one block
// an SM, ≤ 224 registers a thread) that split the work by operand, not by
// columns, so that no product is computed twice: warpgroup 0 computes
// Sᵀ = K·Qᵀ (m64n64k16 over the whole 64-query tile), forms Pᵀ, and owns
// dV += Pᵀ·dO; warpgroup 1 computes dPᵀ = V·dOᵀ, forms dSᵀ from the fp32
// Pᵀ that warpgroup 0 leaves in shared memory (16 KB, handed over on two
// named barriers: full, then free again), and owns dK += dSᵀ·Q.  Each
// holds one 96-register accumulator and a 32-register product tile; the
// dV/dK products are wgmma m64n192k16 with the accumulator's A fragment
// from registers.  K, V and a 3-stage Q/dO ring take ~212 KB.  The
// producer, the schedule pass, the GQA parts and their fixed-order sum are
// the hd 64/128 path's.
//
// Simple path (fp32 inputs and bf16 at hd 16, 24, 32).  One
// block of 256 threads owns one (key tile, kv head, batch row) and keeps
// that tile's K and V in shared memory.  It loops over the G query heads of
// the group and, inside, over the 64-query tiles, accumulating dK and dV in
// fp32 shared memory; it writes dk and dv once.  The query loop starts at
// the first tile whose global end reaches the key tile's start and tests
// every tile after it with block_live before any load.  The key tile is 64
// wide where that fits in shared memory, 32 at hd 192 (f32).  bf16 with hd a
// multiple of 16 uses WMMA (P and dS rounded to bf16 before the last two
// products, as on the Hopper path); fp32 uses FMA, matching the plain
// version to summation order.
//
// What bounds it on the H100: about 8·hd FLOPs per visible (i, j) pair and
// query head (four products of 2·hd), so at hd 128 an ideal kernel is bound
// by the tensor cores (989 TFLOP/s bf16), not by memory.  PERF.md keeps the
// measured times.

#include <algorithm>

#include "hopper.cuh"
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

// --------------------------------------------------------------------------
// Hopper path: warp-specialised wgmma kernel (bf16, hd 64, 128 and 192)
// --------------------------------------------------------------------------

constexpr int WG_THREADS = 128;               // one consumer warpgroup
constexpr int HBK = 64;                       // keys per block (wgmma's M)
// hd 192's two consumer warpgroups hand Pᵀ over through shared memory on
// these named barriers (0 is __syncthreads)
constexpr int BAR_P_FULL = 1, BAR_P_FREE = 2;

// Consumer warpgroups a block: 1 at hd 64/96/128, 2 at hd 192 (one forms
// Pᵀ and owns dV, the other dSᵀ and dK: see the header).
template <int HD>
__host__ __device__ constexpr int dkv_wgs() { return HD == 192 ? 2 : 1; }
template <int HD>  // + the producer warp
__host__ __device__ constexpr int dkv_threads() { return dkv_wgs<HD>() * WG_THREADS + 32; }

struct DkvMaps {
  CUtensorMap q, k, v, dout;
};

template <int HD>
struct HopLayout {
  static constexpr int TILE = 64 * hop::pad_cols<HD>() * 2;   // one 64-row bf16 tile
  // hd 96 runs two blocks an SM, which fit (2 × 101,480 bytes) with 2
  // stages only; the others 3
  static constexpr int STAGES = HD == 96 ? 2 : 3;
  static constexpr int K = 0;
  static constexpr int V = K + TILE;
  static constexpr int QD = V + TILE;            // stage s: Q at QD + 2·s·TILE, dO after it
  static constexpr int LSE = QD + STAGES * 2 * TILE;
  static constexpr int DL = LSE + STAGES * BQ * 4;
  static constexpr int PQ = DL + STAGES * BQ * 4;
  static constexpr int KL = PQ + STAGES * BQ * 4;
  static constexpr int PK = KL + HBK * 4;
  static constexpr int Q0 = PK + HBK * 4;
  static constexpr int XCH = Q0 + 64;            // hd 192: Pᵀ, fp32 [32][WG_THREADS]
  static constexpr int BAR = XCH + (dkv_wgs<HD>() == 2 ? 32 * WG_THREADS * 4 : 0);
  static constexpr int BYTES = BAR + (2 * STAGES + 1) * 8;
  static constexpr int ALLOC = BYTES + 1024;     // room to align the base to 1 KB
};

// The key tiles' order, heaviest first: one block computes each (batch row,
// key tile)'s max kv_last over its real keys (shared-memory atomicMax: a
// max does not depend on the order), its work (the run of query tiles that
// block_live keeps without a window, from the first that reaches the key
// tile to the one that holds the max), and sorts key = (WMAX − work, unit)
// ascending with a bitonic sort.  Keys are distinct, so the order is the
// stable one of kernels/tree_attention_bwd.py::dkv_schedule, its plain
// version.  Up to SCHED_MAX units (B·Skv ≤ 2^20 tokens); above that the
// main kernel takes the units in index order.
constexpr int SCHED_MAX = 1 << 14;
constexpr uint32_t WMAX = (1u << 18) - 1;

__global__ void __launch_bounds__(1024)
dkv_schedule_kernel(const int* __restrict__ kv_last, int* __restrict__ sched, int B, int S,
                    int Skv, int q_off) {
  extern __shared__ uint32_t sh[];
  const int nk = (Skv + HBK - 1) / HBK, nq = (S + BQ - 1) / BQ, n = B * nk;
  int P = 1;
  while (P < n) P <<= 1;
  int* kmax = reinterpret_cast<int*>(sh);
  uint32_t* key = sh + P;
  const int tid = threadIdx.x, nt = blockDim.x;
  for (int i = tid; i < n; i += nt) kmax[i] = -1;
  __syncthreads();
  for (size_t e = tid; e < size_t(B) * Skv; e += nt) {
    const int b = static_cast<int>(e / Skv), j = static_cast<int>(e % Skv);
    atomicMax(&kmax[b * nk + j / HBK], kv_last[e]);
  }
  __syncthreads();
  for (int i = tid; i < P; i += nt) {
    uint32_t k = 0xFFFFFFFFu;
    if (i < n) {
      const int k0 = (i % nk) * HBK, km = kmax[i];
      const int qi0 = max(k0 - q_off, 0) / BQ;
      const int qi1 = km >= q_off ? min(nq - 1, (km - q_off) / BQ) : -1;
      const int work = max(0, qi1 - qi0 + 1);
      k = ((WMAX - uint32_t(work)) << 14) | uint32_t(i);
    }
    key[i] = k;
  }
  __syncthreads();
  for (int size = 2; size <= P; size <<= 1)
    for (int stride = size >> 1; stride > 0; stride >>= 1) {
      for (int i = tid; i < P; i += nt) {
        const int l = i ^ stride;
        if (l > i) {
          const uint32_t a = key[i], c = key[l];
          if (((i & size) == 0) == (a > c)) {
            key[i] = c;
            key[l] = a;
          }
        }
      }
      __syncthreads();
    }
  for (int i = tid; i < n; i += nt) sched[i] = static_cast<int>(key[i] & 0x3FFF);
}

cudaError_t launch_schedule(const void* kv_last, void* sched, int B, int S, int Skv, int q_off,
                            cudaStream_t stream) {
  const int n = B * ((Skv + HBK - 1) / HBK);
  if (n > SCHED_MAX || (S + BQ - 1) / BQ > int(WMAX)) return cudaErrorInvalidValue;
  int P = 1;
  while (P < n) P <<= 1;
  const int bytes = 2 * P * 4;
  cudaError_t err = cudaFuncSetAttribute(dkv_schedule_kernel,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err != cudaSuccess) return err;
  dkv_schedule_kernel<<<1, 1024, bytes, stream>>>(static_cast<const int*>(kv_last),
                                                  static_cast<int*>(sched), B, S, Skv, q_off);
  return cudaGetLastError();
}

// One block per (key tile, kv head, batch row, part of the GQA group), in
// the order `sched` gives (heaviest key tiles first; index order if null).  dk/dv go straight to
// the outputs when the group is not split (parts = 1), else to fp32
// partials [2][parts][B·Skv·Kh·HD] that sum_parts adds in a fixed order.
// At hd 128 the two register accumulators (128 fp32 a thread) and the
// 64×32 Sᵀ/dPᵀ tiles need ~200 registers: two blocks of five warps on an
// SM cap a thread at 168 (three warps share a 16K-register quarter), which
// spills and serialises the wgmmas, so hd 128 runs one block per SM.  hd
// 96's accumulators take 96 registers a thread (m64n96k16), and ptxas fits
// it in the 168 that two blocks leave, with no spill; two blocks an SM
// with a 2-stage ring took 0.77 device ms at Phi-3-vision's rows where one
// block with 3 stages (171 registers) took 1.34 (tools/hd96_width.py,
// PERF.md), so hd 96 runs two, as hd 64 does.  At
// hd 192 the two accumulators alone would be 192 registers a thread, so
// two consumer warpgroups split them (one block per SM, nine warps: 224
// registers a thread at most).
template <int HD>
__global__ void __launch_bounds__(dkv_threads<HD>(), HD <= 96 ? 2 : 1)
dkv_hopper_kernel(const __grid_constant__ DkvMaps maps, const int* __restrict__ kv_last,
                  const int* __restrict__ pos_q, const int* __restrict__ pos_k,
                  const float* __restrict__ lse, const float* __restrict__ delta,
                  const int* __restrict__ sched, __nv_bfloat16* __restrict__ dk,
                  __nv_bfloat16* __restrict__ dv, float* __restrict__ partial, int B, int S,
                  int Skv, int H, int Kh, int parts, float scale, int q_off, int window) {
  using L = HopLayout<HD>;
  constexpr int NA = hop::pad_cols<HD>() / 64;       // TMA boxes a tile
  constexpr int NWG = dkv_wgs<HD>();
  extern __shared__ unsigned char smem_raw[];
  unsigned char* sm = smem_raw + ((1024 - (hop::smem_u32(smem_raw) & 1023)) & 1023);
  float* lse_s = reinterpret_cast<float*>(sm + L::LSE);
  float* dl_s = reinterpret_cast<float*>(sm + L::DL);
  int* pq_s = reinterpret_cast<int*>(sm + L::PQ);
  int* kl_s = reinterpret_cast<int*>(sm + L::KL);
  int* pk_s = reinterpret_cast<int*>(sm + L::PK);
  int* q0_s = reinterpret_cast<int*>(sm + L::Q0);
  uint64_t* full = reinterpret_cast<uint64_t*>(sm + L::BAR);
  uint64_t* empty = full + L::STAGES;
  uint64_t* kvbar = empty + L::STAGES;

  const int nk = (Skv + HBK - 1) / HBK, nq = (S + BQ - 1) / BQ;
  const int G = H / Kh, per = G / parts;
  const int rank = blockIdx.x / (Kh * parts);
  const int unit = sched != nullptr ? sched[rank] : rank;
  const int kh = (blockIdx.x / parts) % Kh, part = blockIdx.x % parts;
  const int b = unit / nk, k0 = (unit % nk) * HBK;
  const bool windowed = pos_q != nullptr;
  const int tid = threadIdx.x;

  if (tid == 0) {
    for (int s = 0; s < L::STAGES; ++s) {
      hop::mbar_init(&full[s], 33);              // 32 lanes' copies + lane 0
      hop::mbar_init(&empty[s], NWG * WG_THREADS);   // every consumer thread
    }
    hop::mbar_init(kvbar, 32);
    hop::fence_barrier_init();
  }
  __syncthreads();

  if (tid >= NWG * WG_THREADS) {
    // ---------------- producer warp ----------------
    const int lane = tid - NWG * WG_THREADS;
    // the key tile's kv_last / pos_k, and their max over its real keys
    int kmax = -1, kpmax = INT_MIN;
    for (int c = lane; c < HBK; c += 32) {
      const bool in = k0 + c < Skv;
      const int kv = in ? kv_last[size_t(b) * Skv + k0 + c] : -1;
      kl_s[c] = kv;
      kmax = max(kmax, kv);
      if (windowed) {
        const int p = in ? pos_k[size_t(b) * Skv + k0 + c] : 0;
        pk_s[c] = p;
        if (in) kpmax = max(kpmax, p);
      }
    }
    kmax = __reduce_max_sync(0xffffffffu, kmax);
    kpmax = __reduce_max_sync(0xffffffffu, kpmax);
    if (lane == 0) {
      hop::mbar_arrive_expect_tx(kvbar, 2 * L::TILE);
      for (int a = 0; a < NA; ++a) {
        hop::tma_load_4d(sm + L::K + a * hop::ATOM, &maps.k, kvbar, 64 * a, kh, k0, b);
        hop::tma_load_4d(sm + L::V + a * hop::ATOM, &maps.v, kvbar, 64 * a, kh, k0, b);
      }
    } else {
      hop::mbar_arrive(kvbar);
    }
    // block_live(q_start, q_end, k0, kmax, min pos_q, kpmax): without a
    // window the live query tiles are the contiguous run from the first
    // tile that reaches k0 to the one that holds kmax.
    const int qi0 = k0 > q_off ? (k0 - q_off) / BQ : 0;
    const int qi1 = kmax >= q_off ? min(nq - 1, (kmax - q_off) / BQ) : -1;
    int stage = 0;
    uint32_t phase = 0;
    for (int g = part * per; g < (part + 1) * per; ++g) {
      const int h = kh * G + g;
      for (int qi = qi0; qi <= qi1; ++qi) {
        const int q0 = qi * BQ, nrows = min(BQ, S - q0);
        if (k0 > q_off + q0 + nrows - 1) continue;
        if (windowed) {
          int qp_min = INT_MAX;
          for (int r = lane; r < nrows; r += 32)
            qp_min = min(qp_min, pos_q[size_t(b) * S + q0 + r]);
          qp_min = __reduce_min_sync(0xffffffffu, qp_min);
          if (!(static_cast<long long>(qp_min) - kpmax < window)) continue;
        }
        hop::mbar_wait(&empty[stage], phase ^ 1);
        // the rows' lse, Δ (and pos_q), asynchronously; rows past S read 0
        const size_t row0 = (size_t(b) * H + h) * S + q0;
        for (int r = lane; r < BQ; r += 32) {
          const bool in = r < nrows;
          hop::cp_async_4(&lse_s[stage * BQ + r], lse + row0 + (in ? r : 0), in);
          hop::cp_async_4(&dl_s[stage * BQ + r], delta + row0 + (in ? r : 0), in);
          if (windowed)
            hop::cp_async_4(&pq_s[stage * BQ + r], pos_q + size_t(b) * S + q0 + (in ? r : 0),
                            in);
        }
        hop::cp_async_arrive(&full[stage]);
        if (lane == 0) {
          q0_s[stage] = q0;
          hop::mbar_arrive_expect_tx(&full[stage], 2 * L::TILE);
          unsigned char* qt = sm + L::QD + stage * 2 * L::TILE;
          for (int a = 0; a < NA; ++a) {
            hop::tma_load_4d(qt + a * hop::ATOM, &maps.q, &full[stage], 64 * a, h, q0, b);
            hop::tma_load_4d(qt + L::TILE + a * hop::ATOM, &maps.dout, &full[stage], 64 * a,
                             h, q0, b);
          }
        }
        if (++stage == L::STAGES) {
          stage = 0;
          phase ^= 1;
        }
      }
    }
    hop::mbar_wait(&empty[stage], phase ^ 1);        // the end marker
    hop::cp_async_arrive(&full[stage]);
    if (lane == 0) {
      q0_s[stage] = -1;
      hop::mbar_arrive(&full[stage]);
    }
    return;
  }

  if constexpr (NWG == 2) {
    // ---------------- hd 192: two consumer warpgroups, rows are keys ----------------
    // Warpgroup 0 computes Sᵀ = K·Qᵀ, forms Pᵀ and owns dV += Pᵀ·dO;
    // warpgroup 1 computes dPᵀ = V·dOᵀ, forms dSᵀ = Pᵀ∘(dPᵀ − Δ)·scale
    // with the fp32 Pᵀ that warpgroup 0 leaves in `xch`, and owns
    // dK += dSᵀ·Q.  The same thread index holds the same (key, query)
    // elements in both, so the hand-over is elementwise and conflict-free.
    const int wg = tid / WG_THREADS, t = tid % WG_THREADS;
    const int warp = t / 32, lane = t % 32;
    const int r0 = 16 * warp + lane / 4, r1 = r0 + 8;   // this thread's two keys
    const int cq = 2 * (lane % 4);                      // its first column in each 8
    const int key0 = k0 + r0, key1 = k0 + r1;
    const float sl2 = scale * hop::LOG2E;
    float* xch = reinterpret_cast<float*>(sm + L::XCH);
    float acc[HD / 2];                                  // dV (warpgroup 0) or dK (1)
#pragma unroll
    for (int i = 0; i < HD / 2; ++i) acc[i] = 0.f;
    hop::mbar_wait(kvbar, 0);
    const int kl0 = kl_s[r0], kl1 = kl_s[r1];
    const int pk0 = windowed ? pk_s[r0] : 0, pk1 = windowed ? pk_s[r1] : 0;
    const uint32_t a_base = hop::smem_u32(sm + (wg == 0 ? L::K : L::V));
    int st = 0, n = 0;
    uint32_t ph = 0;
    for (;; ++n) {
      hop::mbar_wait(&full[st], ph);
      const int qs = q0_s[st];
      if (qs < 0) break;
      const int nrows = min(BQ, S - qs), qg = q_off + qs;
      const uint32_t q_base = hop::smem_u32(sm + L::QD + st * 2 * L::TILE);
      const uint32_t do_base = q_base + L::TILE;
      // B of the first product (K-major) and of the second (MN-major)
      const uint32_t b1 = wg == 0 ? q_base : do_base, b2 = wg == 0 ? do_base : q_base;
      float x[32];                                      // Sᵀ or dPᵀ [64 keys × 64 queries]
#pragma unroll
      for (int i = 0; i < 32; ++i) x[i] = 0.f;
      hop::wgmma_fence();
#pragma unroll
      for (int ks = 0; ks < HD / 16; ++ks)
        hop::wgmma_ss_n64(x, hop::desc_k(a_base, ks), hop::desc_k(b1, ks), ks > 0);
      hop::wgmma_commit();
      hop::wgmma_wait<0>();
      hop::fence_regs(x);
      if (wg == 0) {
        // Pᵀ = exp(s·scale − lse) on visible pairs, 0 elsewhere
        const float* ls = lse_s + st * BQ;
        const int* pqs = pq_s + st * BQ;
#pragma unroll
        for (int j = 0; j < 8; ++j)
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const int c = 8 * j + cq + e, iq = qg + c;
            const float lg = ls[c] * hop::LOG2E;
            bool v0 = c < nrows && key0 <= iq && kl0 >= iq;
            bool v1 = c < nrows && key1 <= iq && kl1 >= iq;
            if (windowed) {
              v0 = v0 && pqs[c] - pk0 < window;
              v1 = v1 && pqs[c] - pk1 < window;
            }
            x[4 * j + e] = v0 ? exp2f(fmaf(x[4 * j + e], sl2, -lg)) : 0.f;
            x[4 * j + 2 + e] = v1 ? exp2f(fmaf(x[4 * j + 2 + e], sl2, -lg)) : 0.f;
          }
        if (n > 0) hop::named_bar_sync(BAR_P_FREE, 2 * WG_THREADS);   // last Pᵀ read
#pragma unroll
        for (int i = 0; i < 32; ++i) xch[i * WG_THREADS + t] = x[i];
        hop::named_bar_arrive(BAR_P_FULL, 2 * WG_THREADS);
      } else {
        // dSᵀ = Pᵀ∘(dPᵀ − Δ)·scale
        const float* dls = dl_s + st * BQ;
        hop::named_bar_sync(BAR_P_FULL, 2 * WG_THREADS);
#pragma unroll
        for (int j = 0; j < 8; ++j)
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const float dl = dls[8 * j + cq + e];
            const int i0 = 4 * j + e, i1 = 4 * j + 2 + e;
            x[i0] = xch[i0 * WG_THREADS + t] * (x[i0] - dl) * scale;
            x[i1] = xch[i1 * WG_THREADS + t] * (x[i1] - dl) * scale;
          }
        hop::named_bar_arrive(BAR_P_FREE, 2 * WG_THREADS);
      }
      // dV += Pᵀ·dO or dK += dSᵀ·Q over the 64 queries (depth = queries)
      uint32_t xa[4][4];
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
#pragma unroll
        for (int i = 0; i < 4; ++i)
          xa[kk][i] = hop::pack_bf16(x[8 * kk + 2 * i], x[8 * kk + 2 * i + 1]);
      hop::wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
        hop::wgmma_rs<HD>(acc, xa[kk], hop::desc_mn(b2 + kk * 16 * 128));
      hop::wgmma_commit();
      hop::wgmma_wait<0>();
      hop::fence_regs(acc);
      hop::mbar_arrive(&empty[st]);
      if (++st == L::STAGES) {
        st = 0;
        ph ^= 1;
      }
    }
    if (wg == 0 && n > 0) hop::named_bar_sync(BAR_P_FREE, 2 * WG_THREADS);   // the last one
    // this warpgroup's dv (0) or dk (1) rows, written once
    const size_t ne = size_t(B) * Skv * Kh * HD;
    __nv_bfloat16* out = wg == 0 ? dv : dk;
    float* part_out =
        parts == 1 ? nullptr : partial + size_t(wg == 0 ? parts + part : part) * ne;
#pragma unroll
    for (int rr = 0; rr < 2; ++rr) {
      const int key = rr ? key1 : key0;
      if (key >= Skv) continue;
      const size_t off = ((size_t(b) * Skv + key) * Kh + kh) * HD + cq;
#pragma unroll
      for (int j = 0; j < HD / 8; ++j) {
        const float lo = acc[4 * j + 2 * rr], hi = acc[4 * j + 2 * rr + 1];
        if (parts == 1)
          *reinterpret_cast<__nv_bfloat162*>(out + off + 8 * j) = __floats2bfloat162_rn(lo, hi);
        else
          *reinterpret_cast<float2*>(part_out + off + 8 * j) = make_float2(lo, hi);
      }
    }
    return;
  }

  // ---------------- consumer warpgroup: rows are keys ----------------
  const int warp = tid / 32, lane = tid % 32;
  const int r0 = 16 * warp + lane / 4, r1 = r0 + 8;     // this thread's two keys
  const int cq = 2 * (lane % 4);                        // its first column in each 8
  const int key0 = k0 + r0, key1 = k0 + r1;
  const float sl2 = scale * hop::LOG2E;
  float dka[HD / 2], dva[HD / 2];
#pragma unroll
  for (int i = 0; i < HD / 2; ++i) {
    dka[i] = 0.f;
    dva[i] = 0.f;
  }
  hop::mbar_wait(kvbar, 0);
  const int kl0 = kl_s[r0], kl1 = kl_s[r1];
  const int pk0 = windowed ? pk_s[r0] : 0, pk1 = windowed ? pk_s[r1] : 0;
  const uint32_t k_base = hop::smem_u32(sm + L::K), v_base = hop::smem_u32(sm + L::V);

  int stage = 0;
  uint32_t phase = 0;
  for (;;) {
    hop::mbar_wait(&full[stage], phase);
    const int q0 = q0_s[stage];
    if (q0 < 0) break;
    const int nrows = min(BQ, S - q0), qg = q_off + q0;
    const uint32_t q_base = hop::smem_u32(sm + L::QD + stage * 2 * L::TILE);
    const uint32_t do_base = q_base + L::TILE;
    const float* ls = lse_s + stage * BQ;
    const float* dls = dl_s + stage * BQ;
    const int* pqs = pq_s + stage * BQ;
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      // Sᵀ = K·Qᵀ and dPᵀ = V·dOᵀ over 32 queries  [64 keys × 32], fp32
      float st[16], dpt[16];
#pragma unroll
      for (int i = 0; i < 16; ++i) {
        st[i] = 0.f;
        dpt[i] = 0.f;
      }
      const uint32_t roff = half * 32 * 128;   // the half's first query row
      hop::wgmma_fence();
#pragma unroll
      for (int ks = 0; ks < HD / 16; ++ks)
        hop::wgmma_ss_n32(st, hop::desc_k(k_base, ks), hop::desc_k(q_base + roff, ks), ks > 0);
#pragma unroll
      for (int ks = 0; ks < HD / 16; ++ks)
        hop::wgmma_ss_n32(dpt, hop::desc_k(v_base, ks), hop::desc_k(do_base + roff, ks),
                          ks > 0);
      hop::wgmma_commit();
      hop::wgmma_wait<0>();
      hop::fence_regs(st);
      hop::fence_regs(dpt);

      // Pᵀ = exp(s·scale − lse) on visible pairs, dSᵀ = Pᵀ∘(dPᵀ − Δ)·scale
#pragma unroll
      for (int j = 0; j < 4; ++j)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int c = half * 32 + 8 * j + cq + e, iq = qg + c;
          const float lg = ls[c] * hop::LOG2E, dl = dls[c];
          bool v0 = c < nrows && key0 <= iq && kl0 >= iq;
          bool v1 = c < nrows && key1 <= iq && kl1 >= iq;
          if (windowed) {
            v0 = v0 && pqs[c] - pk0 < window;
            v1 = v1 && pqs[c] - pk1 < window;
          }
          const float p0 = v0 ? exp2f(fmaf(st[4 * j + e], sl2, -lg)) : 0.f;
          const float p1 = v1 ? exp2f(fmaf(st[4 * j + 2 + e], sl2, -lg)) : 0.f;
          st[4 * j + e] = p0;
          st[4 * j + 2 + e] = p1;
          dpt[4 * j + e] = p0 * (dpt[4 * j + e] - dl) * scale;
          dpt[4 * j + 2 + e] = p1 * (dpt[4 * j + 2 + e] - dl) * scale;
        }
      uint32_t pa[2][4], da[2][4];
#pragma unroll
      for (int kk = 0; kk < 2; ++kk)
#pragma unroll
        for (int x = 0; x < 4; ++x) {
          pa[kk][x] = hop::pack_bf16(st[8 * kk + 2 * x], st[8 * kk + 2 * x + 1]);
          da[kk][x] = hop::pack_bf16(dpt[8 * kk + 2 * x], dpt[8 * kk + 2 * x + 1]);
        }
      // dV += Pᵀ·dO and dK += dSᵀ·Q over these 32 queries (depth = queries)
      hop::wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < 2; ++kk)
        hop::wgmma_rs<HD>(dva, pa[kk], hop::desc_mn(do_base + roff + kk * 16 * 128));
#pragma unroll
      for (int kk = 0; kk < 2; ++kk)
        hop::wgmma_rs<HD>(dka, da[kk], hop::desc_mn(q_base + roff + kk * 16 * 128));
      hop::wgmma_commit();
      hop::wgmma_wait<0>();
      hop::fence_regs(dva);
      hop::fence_regs(dka);
    }
    hop::mbar_arrive(&empty[stage]);
    if (++stage == L::STAGES) {
      stage = 0;
      phase ^= 1;
    }
  }

  // dk/dv rows of this block's keys, written once
  const size_t n = size_t(B) * Skv * Kh * HD;
#pragma unroll
  for (int rr = 0; rr < 2; ++rr) {
    const int key = rr ? key1 : key0;
    if (key >= Skv) continue;
    const size_t off = ((size_t(b) * Skv + key) * Kh + kh) * HD + cq;
#pragma unroll
    for (int j = 0; j < HD / 8; ++j) {
      const float k_lo = dka[4 * j + 2 * rr], k_hi = dka[4 * j + 2 * rr + 1];
      const float v_lo = dva[4 * j + 2 * rr], v_hi = dva[4 * j + 2 * rr + 1];
      if (parts == 1) {
        *reinterpret_cast<__nv_bfloat162*>(dk + off + 8 * j) = __floats2bfloat162_rn(k_lo, k_hi);
        *reinterpret_cast<__nv_bfloat162*>(dv + off + 8 * j) = __floats2bfloat162_rn(v_lo, v_hi);
      } else {
        *reinterpret_cast<float2*>(partial + part * n + off + 8 * j) = make_float2(k_lo, k_hi);
        *reinterpret_cast<float2*>(partial + (parts + part) * n + off + 8 * j) =
            make_float2(v_lo, v_hi);
      }
    }
  }
}

// dk = Σ_p partial[0][p], dv = Σ_p partial[1][p], p in order: deterministic.
__global__ void sum_parts(const float* __restrict__ partial, __nv_bfloat16* __restrict__ dk,
                          __nv_bfloat16* __restrict__ dv, int parts, size_t n) {
  for (size_t i = blockIdx.x * size_t(blockDim.x) + threadIdx.x; i < 2 * n;
       i += size_t(gridDim.x) * blockDim.x) {
    const size_t w = i / n, e = i % n;
    float s = 0.f;
    for (int p = 0; p < parts; ++p) s += partial[(w * parts + p) * n + e];
    (w ? dv : dk)[e] = __float2bfloat16(s);
  }
}

template <int HD>
cudaError_t launch_hopper(const void* q, const void* k, const void* v, const void* kv_last,
                          const void* pos_q, const void* pos_k, const void* lse,
                          const void* delta, const void* dout, void* sched, void* dk,
                          void* dv, void* partial, int parts, int B, int S, int Skv, int H,
                          int Kh, float scale, int q_off, int window, cudaStream_t stream) {
  DkvMaps maps;
  cudaError_t err = hop::tile_map(&maps.q, q, B, S, H, HD);
  if (err == cudaSuccess) err = hop::tile_map(&maps.k, k, B, Skv, Kh, HD);
  if (err == cudaSuccess) err = hop::tile_map(&maps.v, v, B, Skv, Kh, HD);
  if (err == cudaSuccess) err = hop::tile_map(&maps.dout, dout, B, S, H, HD);
  if (err != cudaSuccess) return err;
  if (parts < 1 || (H / Kh) % parts != 0 || (parts > 1 && partial == nullptr))
    return cudaErrorInvalidValue;
  const int nk = (Skv + HBK - 1) / HBK;
  if (B * nk > SCHED_MAX) {
    sched = nullptr;
  } else {
    err = launch_schedule(kv_last, sched, B, S, Skv, q_off, stream);
    if (err != cudaSuccess) return err;
  }
  constexpr int bytes = HopLayout<HD>::ALLOC;
  static_assert(bytes <= MAX_SMEM, "dk/dv Hopper tile does not fit shared memory");
  auto kern = dkv_hopper_kernel<HD>;
  err = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err != cudaSuccess) return err;
  kern<<<B * nk * Kh * parts, dkv_threads<HD>(), bytes, stream>>>(
      maps, static_cast<const int*>(kv_last), static_cast<const int*>(pos_q),
      static_cast<const int*>(pos_k), static_cast<const float*>(lse),
      static_cast<const float*>(delta), static_cast<const int*>(sched),
      static_cast<__nv_bfloat16*>(dk), static_cast<__nv_bfloat16*>(dv),
      static_cast<float*>(partial), B, S, Skv, H, Kh, parts, scale, q_off, window);
  err = cudaGetLastError();
  if (err != cudaSuccess || parts == 1) return err;
  const size_t n = size_t(B) * Skv * Kh * HD;
  const int blocks = static_cast<int>(std::min<size_t>((2 * n + 255) / 256, 132 * 16));
  sum_parts<<<blocks, 256, 0, stream>>>(static_cast<const float*>(partial),
                                        static_cast<__nv_bfloat16*>(dk),
                                        static_cast<__nv_bfloat16*>(dv), parts, n);
  return cudaGetLastError();
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
                     const void* lse, const void* delta, const void* dout, void* sched,
                     void* dk, void* dv, void* partial, int parts, int B, int S, int Skv,
                     int H, int Kh, float scale, int q_off, int window, cudaStream_t stream) {
  if (dtype == 0)
    return launch<float, HD, false>(q, k, v, kv_last, pos_q, pos_k, lse, delta, dout, dk,
                                    dv, B, S, Skv, H, Kh, scale, q_off, window, stream);
  if (dtype != 1) return cudaErrorInvalidValue;
  if constexpr (HD == 64 || HD == 96 || HD == 128 || HD == 192)
    return launch_hopper<HD>(q, k, v, kv_last, pos_q, pos_k, lse, delta, dout, sched, dk, dv,
                             partial, parts, B, S, Skv, H, Kh, scale, q_off, window, stream);
  else
    return launch<__nv_bfloat16, HD, HD % 16 == 0>(q, k, v, kv_last, pos_q, pos_k, lse,
                                                   delta, dout, dk, dv, B, S, Skv, H, Kh,
                                                   scale, q_off, window, stream);
}

}  // namespace

extern "C" {

// dtype: 0 = float32, 1 = bfloat16.  pos_q/pos_k null ⇒ no window.  The
// bf16 Hopper path (hd 64, 96, 128, 192) also takes `sched`, int32 scratch of
// B·nk elements (nk = ceil(Skv/64)) where it first writes the key tiles'
// order, and splits each GQA group into `parts` parts (a divisor of H/Kh);
// with parts > 1, `partial` is fp32 scratch of 2·parts·B·Skv·Kh·hd elements.
// The other instances ignore the three.  Returns cudaGetLastError() after
// the launches (0 = ok).
int tree_attention_bwd_dkv(const void* q, const void* k, const void* v, const void* kv_last,
                           const void* pos_q, const void* pos_k, const void* lse,
                           const void* delta, const void* dout, void* dk, void* dv,
                           void* sched, void* partial, int B, int S, int Skv, int H,
                           int Kh, int hd, int dtype, int parts, float scale, int q_off,
                           int window, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
#define TREE_ATTN_HD(D)                                                                   \
  case D:                                                                                 \
    return by_dtype<D>(dtype, q, k, v, kv_last, pos_q, pos_k, lse, delta, dout, sched,    \
                       dk, dv, partial, parts, B, S, Skv, H, Kh, scale, q_off, window, st);
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

// The key tiles' order alone (what the bf16 Hopper path computes first),
// into int32 sched[B·ceil(Skv/64)]; for checking it against its plain version.
int tree_attention_bwd_dkv_schedule(const void* kv_last, void* sched, int B, int S, int Skv,
                                    int q_off, void* stream) {
  return launch_schedule(kv_last, sched, B, S, Skv, q_off, static_cast<cudaStream_t>(stream));
}

const char* tree_attention_bwd_dkv_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
