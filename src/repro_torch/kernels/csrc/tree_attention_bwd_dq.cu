// Tree flash-attention backward, dq, for Hopper (sm_90a), behind a plain C
// entry point that Python loads with ctypes
// (src/repro_torch/kernels/tree_attention_bwd.py).
//
// Replaces: the Pallas TPU kernel src/repro/kernels/tree_attention_bwd.py::
// _bwd_dq (kernel body :83-134, pallas_call :162), and on its Hopper path
// also the Δ pre-pass the reference runs outside its kernels (:331).  Same
// function: with p_ij = exp(scale·q_i·k_j − lse_i) on visible pairs (0
// elsewhere) and Δ_i = Σ_d do_id·o_id,
//   ds_ij = p_ij · (do_i·v_j − Δ_i) · scale,   dq_i = Σ_j ds_ij · k_j.
//
// Two paths compute the same function.  No atomics on either: two
// launches give bit-identical dq (and Δ).
//
// Hopper path (bf16 at hd 64 and 128, the models' head dims).  One CUDA
// block of 160 threads owns one (64-query tile, head, batch row), latest
// (heaviest) query tiles first: a consumer warpgroup (warps 0-3) and a
// producer warp (warp 4).  The producer is the forward's
// (hopper.cuh::produce_key_tiles), so the two skip the same key tiles: it
// loads the Q and dO tiles once by TMA, walks the causal key tiles with
// the reference's block_live rule (16 tiles per pass, one warp reduction
// each; window and q_off included) and brings only live K/V tiles by TMA
// into an mbarrier ring of 2 (hd 128) or 3 (hd 64) stages, with each
// tile's kv_last/pos_k staged by cp.async.  The consumers first compute Δ
// of their own rows: each thread owns two rows (wgmma's accumulator
// layout), reads a quarter of each row's O from global memory and of its
// dO from the resident swizzled tile, sums the bf16 products in fp32 and
// closes the sum over the row's four threads by shuffles; Δ is written to
// its [B,H,S] buffer for the dk/dv launch that follows on the same stream.
// Then, for each live key tile and each half of it (32 keys):
// S = Q·Kᵀ and dP = dO·Vᵀ as wgmma m64n32k16 (both operands K-major);
// P = exp(S·scale − lse) on visible pairs with the reference's guarded
// exponent (a fully masked row, lse = −1e30, gets p = 0 and dq = 0);
// dS = P∘(dP − Δ)·scale in the accumulators' registers, rounded to bf16
// there and fed as wgmma's register A operand of dQ += dS·K, with K read
// MN-major from the same swizzled tile through the transpose bit (as the
// forward reads V in P·V).  dQ stays in fp32 registers across the whole
// key loop and is written once.  Half-tile S and dP keep a thread at
// 64 (dQ, hd 128) + 16 + 16 accumulator registers, so two blocks fit on
// an SM (the ptxas line in chip_smoke.py's build phase says how many
// registers it took).  Ragged S and Skv tails read as zero from TMA and are
// masked.
//
// Simple path (fp32 inputs, the accuracy path, and bf16 at the other head
// dims 16, 24, 32, 96, 192; Δ computed by the wrapper).  One block of 256
// threads per (64-query tile, head, batch row) walks the key tiles, tests
// each with block_live before any load, and runs S = Q·Kᵀ, dP = dO·Vᵀ and
// dQ += dS·K on WMMA (bf16 with hd a multiple of 16; dS rounded to bf16
// before dS·K, as FlashAttention-2/3 do) or fp32 FMA (matching the plain
// version to summation order) through shared memory, dq in fp32 registers.
//
// What bounds it on the H100: about 6·hd FLOPs per visible (i, j) pair and
// query head (three products of 2·hd), against 2·hd·2 bytes per key read
// and, for Δ, 2·hd·2 bytes per query row, so at hd 128 an ideal kernel is
// bound by the tensor cores (989 TFLOP/s bf16) or, at the training
// shape's sparse tree mask, by the bytes of q, do, o and dq.  The Hopper
// path's design follows from that: products on wgmma with accumulators in
// registers, loads overlapped with the math by the producer, no work or
// traffic for dead tiles, Δ from tiles the block reads anyway.  PERF.md
// keeps the measured times.

#include "hopper.cuh"
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

// --------------------------------------------------------------------------
// Hopper path: warp-specialised wgmma kernel (bf16, hd 64 and 128)
// --------------------------------------------------------------------------

constexpr int WG_THREADS = 128;               // the consumer warpgroup
constexpr int HOP_THREADS = WG_THREADS + 32;  // + the producer warp

struct DqMaps {
  CUtensorMap q, dout, k, v;
};

template <int HD>
using DqLayout = hop::KeyTileLayout<HD, 2>;      // Q, then dO, resident

// Σ of the 8 bf16 products of two 16-byte chunks, in fp32, in order.
__device__ __forceinline__ float dot8(uint4 a, uint4 b, float acc) {
  const __nv_bfloat162* x = reinterpret_cast<const __nv_bfloat162*>(&a);
  const __nv_bfloat162* y = reinterpret_cast<const __nv_bfloat162*>(&b);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 u = __bfloat1622float2(x[i]), w = __bfloat1622float2(y[i]);
    acc = fmaf(u.x, w.x, acc);
    acc = fmaf(u.y, w.y, acc);
  }
  return acc;
}

template <int HD>
__global__ void __launch_bounds__(HOP_THREADS, 2)
dq_hopper_kernel(const __grid_constant__ DqMaps maps, const int* __restrict__ kv_last,
                 const int* __restrict__ pos_q, const int* __restrict__ pos_k,
                 const float* __restrict__ lse, const __nv_bfloat16* __restrict__ o,
                 float* __restrict__ delta, __nv_bfloat16* __restrict__ dq, int B, int S,
                 int Skv, int H, int Kh, float scale, int q_off, int window) {
  using L = DqLayout<HD>;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* sm = L::base(smem_raw);
  const hop::KeyRing ring = L::ring(sm);
  const int *kl_s = ring.kl, *pk_s = ring.pk, *k0_s = ring.k0;
  uint64_t *full = ring.full, *empty = ring.empty, *qbar = L::resbar(sm);
  unsigned char* const q_tile = sm + L::RES;
  unsigned char* const do_tile = q_tile + L::TILE;

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
    // ---------------- producer warp (hopper.cuh): Q and dO resident ----------------
    const CUtensorMap* const res[2] = {&maps.q, &maps.dout};
    hop::produce_key_tiles<HD, L::STAGES>(tid - WG_THREADS, res, q_tile, qbar, &maps.k,
                                          &maps.v, ring, kv_last, pos_q, pos_k, b, h, kh, S,
                                          Skv, q0, nrows, q_off, window);
    return;
  }

  // ---------------- consumer warpgroup: rows are queries ----------------
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
  const size_t row0 = (size_t(b) * H + h) * S + q0;     // [B,H,S] index of row 0
  const float lg0 = ok0 ? lse[row0 + r0] * hop::LOG2E : 0.f;
  const float lg1 = ok1 ? lse[row0 + r1] * hop::LOG2E : 0.f;

  // Δ of the two rows: this thread takes the 16-byte chunks c ≡ lane (mod
  // 4) of each row, O from global memory and dO from the resident tile.
  const uint4* og0 = reinterpret_cast<const uint4*>(o + ((size_t(b) * S + q0 + r0) * H + h) * HD);
  const uint4* og1 = reinterpret_cast<const uint4*>(o + ((size_t(b) * S + q0 + r1) * H + h) * HD);
  uint4 ov0[HD / 32], ov1[HD / 32];
#pragma unroll
  for (int u = 0; u < HD / 32; ++u) {
    const int c = lane % 4 + 4 * u;
    ov0[u] = ok0 ? og0[c] : make_uint4(0, 0, 0, 0);
    ov1[u] = ok1 ? og1[c] : make_uint4(0, 0, 0, 0);
  }
  hop::mbar_wait(qbar, 0);
  float dl0 = 0.f, dl1 = 0.f;
#pragma unroll
  for (int u = 0; u < HD / 32; ++u) {
    const int c = lane % 4 + 4 * u, a = c / 8, cc = c % 8;   // box, chunk in the box
    const uint4 d0 = *reinterpret_cast<const uint4*>(do_tile + a * hop::ATOM + r0 * 128 +
                                                     ((cc ^ (r0 & 7)) << 4));
    const uint4 d1 = *reinterpret_cast<const uint4*>(do_tile + a * hop::ATOM + r1 * 128 +
                                                     ((cc ^ (r1 & 7)) << 4));
    dl0 = dot8(ov0[u], d0, dl0);
    dl1 = dot8(ov1[u], d1, dl1);
  }
  dl0 += __shfl_xor_sync(0xffffffffu, dl0, 1);
  dl0 += __shfl_xor_sync(0xffffffffu, dl0, 2);
  dl1 += __shfl_xor_sync(0xffffffffu, dl1, 1);
  dl1 += __shfl_xor_sync(0xffffffffu, dl1, 2);
  if (lane % 4 == 0) {
    if (ok0) delta[row0 + r0] = dl0;
    if (ok1) delta[row0 + r1] = dl1;
  }

  const float sl2 = scale * hop::LOG2E;
  float dqa[HD / 2];
#pragma unroll
  for (int i = 0; i < HD / 2; ++i) dqa[i] = 0.f;
  const uint32_t q_base = hop::smem_u32(q_tile), do_base = hop::smem_u32(do_tile);

  int stage = 0;
  uint32_t phase = 0;
  for (;;) {
    hop::mbar_wait(&full[stage], phase);
    const int k0 = k0_s[stage];
    if (k0 < 0) break;
    const uint32_t k_base = hop::smem_u32(sm + L::KV + stage * 2 * L::TILE);
    const uint32_t v_base = k_base + L::TILE;
    const int* kl = kl_s + stage * BK;
    const int* pk = pk_s + stage * BK;
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      // S = Q·Kᵀ and dP = dO·Vᵀ over 32 keys  [64 queries × 32], fp32
      float s[16], dp[16];
#pragma unroll
      for (int i = 0; i < 16; ++i) {
        s[i] = 0.f;
        dp[i] = 0.f;
      }
      const uint32_t roff = half * 32 * 128;   // the half's first key row
      hop::wgmma_fence();
#pragma unroll
      for (int ks = 0; ks < HD / 16; ++ks)
        hop::wgmma_ss_n32(s, hop::desc_k(q_base, ks), hop::desc_k(k_base + roff, ks), ks > 0);
#pragma unroll
      for (int ks = 0; ks < HD / 16; ++ks)
        hop::wgmma_ss_n32(dp, hop::desc_k(do_base, ks), hop::desc_k(v_base + roff, ks), ks > 0);
      hop::wgmma_commit();
      hop::wgmma_wait<0>();
      hop::fence_regs(s);
      hop::fence_regs(dp);

      // P = exp(s·scale − lse) on visible pairs, dS = P∘(dP − Δ)·scale
#pragma unroll
      for (int j = 0; j < 4; ++j)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int c = half * 32 + 8 * j + cq + e, key = k0 + c, kv = kl[c];
          bool v0 = ok0 && key <= iq0 && kv >= iq0;
          bool v1 = ok1 && key <= iq1 && kv >= iq1;
          if (windowed) {
            v0 = v0 && pq0 - pk[c] < window;
            v1 = v1 && pq1 - pk[c] < window;
          }
          const float p0 = v0 ? exp2f(fmaf(s[4 * j + e], sl2, -lg0)) : 0.f;
          const float p1 = v1 ? exp2f(fmaf(s[4 * j + 2 + e], sl2, -lg1)) : 0.f;
          dp[4 * j + e] = p0 * (dp[4 * j + e] - dl0) * scale;
          dp[4 * j + 2 + e] = p1 * (dp[4 * j + 2 + e] - dl1) * scale;
        }
      uint32_t da[2][4];
#pragma unroll
      for (int kk = 0; kk < 2; ++kk)
#pragma unroll
        for (int x = 0; x < 4; ++x)
          da[kk][x] = hop::pack_bf16(dp[8 * kk + 2 * x], dp[8 * kk + 2 * x + 1]);
      // dQ += dS·K over these 32 keys (depth = keys, K read MN-major)
      hop::wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < 2; ++kk)
        hop::wgmma_rs<HD>(dqa, da[kk], hop::desc_mn(k_base + roff + kk * 16 * 128));
      hop::wgmma_commit();
      hop::wgmma_wait<0>();
      hop::fence_regs(dqa);
    }
    hop::mbar_arrive(&empty[stage]);
    if (++stage == L::STAGES) {
      stage = 0;
      phase ^= 1;
    }
  }

  __nv_bfloat16* dq0 = dq + ((size_t(b) * S + q0 + r0) * H + h) * HD + cq;
  __nv_bfloat16* dq1 = dq + ((size_t(b) * S + q0 + r1) * H + h) * HD + cq;
#pragma unroll
  for (int j = 0; j < HD / 8; ++j) {
    if (ok0)
      *reinterpret_cast<__nv_bfloat162*>(dq0 + 8 * j) =
          __floats2bfloat162_rn(dqa[4 * j], dqa[4 * j + 1]);
    if (ok1)
      *reinterpret_cast<__nv_bfloat162*>(dq1 + 8 * j) =
          __floats2bfloat162_rn(dqa[4 * j + 2], dqa[4 * j + 3]);
  }
}

template <int HD>
cudaError_t launch_hopper(const void* q, const void* k, const void* v, const void* kv_last,
                          const void* pos_q, const void* pos_k, const void* lse, void* delta,
                          const void* dout, void* dq, const void* o, int B, int S, int Skv,
                          int H, int Kh, float scale, int q_off, int window,
                          cudaStream_t stream) {
  DqMaps maps;
  cudaError_t err = hop::tile_map(&maps.q, q, B, S, H, HD);
  if (err == cudaSuccess) err = hop::tile_map(&maps.dout, dout, B, S, H, HD);
  if (err == cudaSuccess) err = hop::tile_map(&maps.k, k, B, Skv, Kh, HD);
  if (err == cudaSuccess) err = hop::tile_map(&maps.v, v, B, Skv, Kh, HD);
  if (err != cudaSuccess) return err;
  if (o == nullptr || reinterpret_cast<uintptr_t>(o) % 16 != 0) return cudaErrorInvalidValue;
  constexpr int bytes = DqLayout<HD>::ALLOC;
  auto kern = dq_hopper_kernel<HD>;
  err = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err != cudaSuccess) return err;
  const int nq = (S + BQ - 1) / BQ;
  kern<<<nq * H * B, HOP_THREADS, bytes, stream>>>(
      maps, static_cast<const int*>(kv_last), static_cast<const int*>(pos_q),
      static_cast<const int*>(pos_k), static_cast<const float*>(lse),
      static_cast<const __nv_bfloat16*>(o), static_cast<float*>(delta),
      static_cast<__nv_bfloat16*>(dq), B, S, Skv, H, Kh, scale, q_off, window);
  return cudaGetLastError();
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
                     const void* lse, void* delta, const void* dout, void* dq, const void* o,
                     int B, int S, int Skv, int H, int Kh, float scale, int q_off, int window,
                     cudaStream_t stream) {
  if (dtype == 0)
    return launch<float, HD, false>(q, k, v, kv_last, pos_q, pos_k, lse, delta, dout, dq,
                                    B, S, Skv, H, Kh, scale, q_off, window, stream);
  if (dtype != 1) return cudaErrorInvalidValue;
  if constexpr (HD == 64 || HD == 128)
    return launch_hopper<HD>(q, k, v, kv_last, pos_q, pos_k, lse, delta, dout, dq, o, B, S,
                             Skv, H, Kh, scale, q_off, window, stream);
  else
    return launch<__nv_bfloat16, HD, HD % 16 == 0>(q, k, v, kv_last, pos_q, pos_k, lse,
                                                   delta, dout, dq, B, S, Skv, H, Kh,
                                                   scale, q_off, window, stream);
}

}  // namespace

extern "C" {

// dtype: 0 = float32, 1 = bfloat16.  pos_q/pos_k null ⇒ no window.  The
// bf16 hd 64/128 path computes Δ [B,H,S] f32 from `o` and `dout` and
// writes it to `delta`; the other instances read Δ from `delta` and ignore
// `o`.  Returns cudaGetLastError() after the launch (0 = ok).
int tree_attention_bwd_dq(const void* q, const void* k, const void* v, const void* kv_last,
                          const void* pos_q, const void* pos_k, const void* lse, void* delta,
                          const void* dout, void* dq, const void* o, int B, int S, int Skv,
                          int H, int Kh, int hd, int dtype, float scale, int q_off,
                          int window, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
#define TREE_ATTN_HD(D)                                                                 \
  case D:                                                                               \
    return by_dtype<D>(dtype, q, k, v, kv_last, pos_q, pos_k, lse, delta, dout, dq, o,  \
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

const char* tree_attention_bwd_dq_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
