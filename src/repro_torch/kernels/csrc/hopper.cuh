// Hopper (sm_90a) building blocks shared by the tree-attention kernels'
// tensor-core paths (tree_attention_fwd.cu, tree_attention_bwd_dq.cu,
// tree_attention_bwd_dkv.cu): mbarriers, TMA tile loads, wgmma descriptors
// and the wgmma instructions themselves, written as inline PTX so that the
// build needs no CUTLASS; and the key-tile producer warp that the forward
// and dq share (produce_key_tiles).
//
// Tile layout.  Every bf16 tile is 64 rows of a [B, rows, heads, hd] tensor
// for one head, brought in by TMA as hd/64 boxes of 64 rows × 64 columns
// (128 bytes a row) with the 128-byte swizzle.  A box is one 8 KB "atom"
// column block; box a holds columns [64a, 64a + 64).  Rows past the
// tensor's end read as zero.  wgmma reads such a tile two ways:
//   - K-major (the hd columns are the product's depth): Q and K in Q·Kᵀ,
//     dO and V in dO·Vᵀ, K and Q in K·Qᵀ.  A 16-column step moves the
//     start address 32 bytes inside a box and 8 KB from one box to the
//     next; 8-row groups are 1 KB apart (the stride byte offset).
//   - MN-major (the rows are the depth, hd is the output width): V in P·V,
//     K in dS·K, dO and Q in Pᵀ·dO and dSᵀ·Q, through the descriptor's
//     transpose bit.  A 16-row step moves the start 2 KB; the next 64
//     output columns are the next box, 8 KB on (the leading byte offset);
//     8-row groups are 1 KB apart.
//   Inside a box the 16-byte chunk c of row r sits at r·128 + 16·(c ^ r%8)
//   (the swizzle), which is how a thread reads one element group back.
#pragma once

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <climits>
#include <cstdint>

namespace hop {

constexpr int ATOM = 64 * 128;        // one 64-row × 128-byte swizzled box
constexpr float LOG2E = 1.4426950408889634f;
constexpr float LN2 = 0.6931471805599453f;

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// ---- mbarriers -----------------------------------------------------------
__device__ __forceinline__ void mbar_init(uint64_t* bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(smem_u32(bar)), "r"(count)
               : "memory");
}
__device__ __forceinline__ void fence_barrier_init() {
  asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
}
__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];" ::"r"(smem_u32(bar)) : "memory");
}
// arrive, and expect `bytes` more from asynchronous copies this phase
__device__ __forceinline__ void mbar_arrive_expect_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(smem_u32(bar)),
               "r"(bytes)
               : "memory");
}
// Wait until the phase of parity `parity` has completed.  A wait that
// lasts ~2^32 cycles (about 2 s) traps: a pipeline fault then ends the
// launch with an error instead of hanging the card.
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  const uint32_t addr = smem_u32(bar);
  uint32_t done = 0;
  const long long t0 = clock64();
  do {
    asm volatile(
        "{\n.reg .pred p;\nmbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(addr), "r"(parity)
        : "memory");
    if (!done && clock64() - t0 > (1ll << 32)) __trap();
  } while (!done);
}

// ---- small asynchronous copies ---------------------------------------------
// 4 bytes global → shared without stalling the issuing thread; zero-filled
// (nothing read) when !pred.
__device__ __forceinline__ void cp_async_4(void* dst, const void* src, bool pred) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;" ::"r"(smem_u32(dst)), "l"(src),
               "r"(pred ? 4 : 0)
               : "memory");
}
// One arrival on `bar`, made once every cp.async this thread issued before
// has landed (counted in the barrier's arrival count: .noinc).
__device__ __forceinline__ void cp_async_arrive(uint64_t* bar) {
  asm volatile("cp.async.mbarrier.arrive.noinc.shared::cta.b64 [%0];" ::"r"(smem_u32(bar))
               : "memory");
}

// ---- TMA -----------------------------------------------------------------
// One box of a 4-D tensor map into shared memory; completion is counted on
// `bar` in bytes.  Coordinates are innermost first.
__device__ __forceinline__ void tma_load_4d(void* dst, const CUtensorMap* map, uint64_t* bar,
                                            int c0, int c1, int c2, int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%3, %4, %5, %6}], [%2];" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(bar)), "r"(c0), "r"(c1), "r"(c2),
      "r"(c3)
      : "memory");
}

// ---- wgmma ---------------------------------------------------------------
// Shared-memory matrix descriptor, 128-byte swizzle (layout type 1).
__device__ __forceinline__ uint64_t make_desc(uint32_t addr, uint32_t lbo, uint32_t sbo) {
  return uint64_t((addr & 0x3FFFF) >> 4) | (uint64_t((lbo >> 4) & 0x3FFF) << 16) |
         (uint64_t((sbo >> 4) & 0x3FFF) << 32) | (uint64_t(1) << 62);
}
// K-major operand: 16-column step `ks` of a tile whose rows start at `base`
__device__ __forceinline__ uint64_t desc_k(uint32_t base, int ks) {
  return make_desc(base + (ks >> 2) * ATOM + (ks & 3) * 32, 16, 1024);
}
// MN-major operand whose 16 rows of depth start at `addr` (row-aligned)
__device__ __forceinline__ uint64_t desc_mn(uint32_t addr) {
  return make_desc(addr, ATOM, 1024);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;" ::: "memory");
}
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;" ::"n"(N) : "memory");
}
// Keep the compiler from moving accumulator reads and writes across the
// asynchronous product (it cannot see that wgmma writes them late).
template <int N>
__device__ __forceinline__ void fence_regs(float (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// Two floats as one register of a bf16 A fragment (low half = first).
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// Accumulator layout of m64nN (per thread of the warpgroup, warp w, lane l):
// d[4j + e] is row 16w + l/4 + 8·(e/2), column 8j + 2·(l%4) + e%2.  The A
// fragment of m64k16 from registers takes, for 16-column step kk, the
// pairs (d[8kk], d[8kk+1]), (d[8kk+2], d[8kk+3]), (d[8kk+4], d[8kk+5]),
// (d[8kk+6], d[8kk+7]) of an accumulator: no shuffle is needed.

// D[64×32] (+)= A·B, A and B from shared memory (K-major, 128-byte swizzle).
__device__ __forceinline__ void wgmma_ss_n32(float (&d)[16], uint64_t da, uint64_t db,
                                            int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %18, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15}"
      ", %16, %17, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
        "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]),
        "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
      : "l"(da), "l"(db), "r"(accumulate));
}

// D[64×64] (+)= A·B, A and B from shared memory (K-major, 128-byte swizzle).
__device__ __forceinline__ void wgmma_ss_n64(float (&d)[32], uint64_t da, uint64_t db,
                                            int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, "
      "%19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}"
      ", %32, %33, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
        "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]),
        "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]),
        "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]),
        "+f"(d[31])
      : "l"(da), "l"(db), "r"(accumulate));
}

// D[64×64] += A·B, A from registers (bf16 pairs), B from shared memory
// MN-major (the descriptor's transpose bit), 128-byte swizzle.
__device__ __forceinline__ void wgmma_rs_n64(float (&d)[32], const uint32_t (&a)[4],
                                            uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, "
      "%19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}"
      ", {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
        "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]),
        "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]),
        "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]),
        "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

// D[64×128] += A·B, A from registers (bf16 pairs), B from shared memory
// MN-major (the descriptor's transpose bit), 128-byte swizzle.
__device__ __forceinline__ void wgmma_rs_n128(float (&d)[64], const uint32_t (&a)[4],
                                            uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, "
      "%19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, "
      "%36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, "
      "%53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}"
      ", {%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
        "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]),
        "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]),
        "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]),
        "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]),
        "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]), "+f"(d[42]),
        "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]),
        "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]),
        "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]),
        "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

template <int HD>
__device__ __forceinline__ void wgmma_rs(float (&d)[HD / 2], const uint32_t (&a)[4],
                                         uint64_t db) {
  static_assert(HD == 64 || HD == 128, "wgmma path: hd 64 or 128");
  if constexpr (HD == 64) wgmma_rs_n64(d, a, db);
  else wgmma_rs_n128(d, a, db);
}

// ---- the key-tile producer of the forward and of dq ------------------------
// Both kernels give one block a (64-query tile, head, batch row) and walk
// its causal key tiles; the producer warp below is the one both run, so the
// two skip the same tiles by construction.

constexpr int KT = 64;       // keys per tile
constexpr int SCAN = 16;     // key tiles tested per pass

// The key/value ring in shared memory, STAGES deep.
struct KeyRing {
  unsigned char* kv;   // stage s: K at kv + 2·s·tile, V at kv + (2·s + 1)·tile
  int* kl;             // [STAGES][KT] the stage's kv_last
  int* pk;             // [STAGES][KT] the stage's pos_k (windowed only)
  int* k0;             // [STAGES] the stage's first key; −1 marks the end
  uint64_t* full;      // [STAGES] the stage has landed (32 lanes + lane 0)
  uint64_t* empty;     // [STAGES] the consumers are done with it (128)
};

// Shared memory of a block that runs produce_key_tiles: NRES resident
// 64-row tiles (tile i at RES + i·TILE), then the K/V ring of STAGES
// stages, its metadata and its barriers.  The host sizes the launch by
// ALLOC, which leaves room to align the base to 1 KB (the swizzle's unit).
template <int HD, int NRES>
struct KeyTileLayout {
  static constexpr int TILE = KT * HD * 2;       // one 64-row bf16 tile
  static constexpr int STAGES = HD <= 64 ? 3 : 2;
  static constexpr int RES = 0;
  static constexpr int KV = RES + NRES * TILE;   // stage s: K at KV + 2·s·TILE, V after it
  static constexpr int KL = KV + STAGES * 2 * TILE;
  static constexpr int PK = KL + STAGES * KT * 4;
  static constexpr int K0 = PK + STAGES * KT * 4;
  static constexpr int BAR = K0 + 64;            // full[STAGES], empty[STAGES], resident
  static constexpr int BYTES = BAR + (2 * STAGES + 1) * 8;
  static constexpr int ALLOC = BYTES + 1024;

  // The block's 1 KB-aligned base in its dynamic shared memory.
  __device__ static unsigned char* base(unsigned char* raw) {
    return raw + ((1024 - (smem_u32(raw) & 1023)) & 1023);
  }
  __device__ static KeyRing ring(unsigned char* sm) {
    uint64_t* full = reinterpret_cast<uint64_t*>(sm + BAR);
    return KeyRing{sm + KV, reinterpret_cast<int*>(sm + KL), reinterpret_cast<int*>(sm + PK),
                   reinterpret_cast<int*>(sm + K0), full, full + STAGES};
  }
  // the barrier the resident tiles complete on
  __device__ static uint64_t* resbar(unsigned char* sm) {
    return reinterpret_cast<uint64_t*>(sm + BAR) + 2 * STAGES;
  }
  // Thread 0 initialises the barriers: a stage is full once the producer's
  // 32 lanes' copies and lane 0's TMA have landed, and empty once each of
  // the `consumers` threads has released it.  Then the whole block syncs.
  __device__ static void init(unsigned char* sm, int consumers) {
    if (threadIdx.x == 0) {
      const KeyRing r = ring(sm);
      for (int s = 0; s < STAGES; ++s) {
        mbar_init(&r.full[s], 33);
        mbar_init(&r.empty[s], consumers);
      }
      mbar_init(resbar(sm), 1);
      fence_barrier_init();
    }
    __syncthreads();
  }
};

// The producer warp of one (query tile q0..q0+nrows−1, head h, batch b):
//  1. brings the NRES resident 64-row tiles res[i] (rows q0.., head h) to
//     res_smem + i·tile by TMA, completing on `resbar` (count 1);
//  2. walks the causal key tiles SCAN at a time, reading kv_last (and
//     pos_k) for all of them first and then reducing each tile with one
//     warp-wide max: the reference's block_live(q_start, q_end, k0,
//     max kv_last[, min pos_q, max pos_k, window]);
//  3. for each live tile, in order, waits for a free stage, stages the
//     tile's kv_last/pos_k by cp.async (keys past Skv read 0: later than
//     every query, so invisible) and brings K and V in by TMA;
//  4. hands over the end marker (k0 = −1).
// A dead tile costs no load and no barrier.  pos_q null ⇒ no window.
template <int HD, int STAGES, int NRES>
__device__ __forceinline__ void produce_key_tiles(
    const int lane, const CUtensorMap* const (&res)[NRES], unsigned char* res_smem,
    uint64_t* resbar, const CUtensorMap* kmap, const CUtensorMap* vmap, const KeyRing& ring,
    const int* __restrict__ kv_last, const int* __restrict__ pos_q,
    const int* __restrict__ pos_k, int b, int h, int kh, int S, int Skv, int q0, int nrows,
    int q_off, int window) {
  constexpr int TILE = KT * HD * 2;
  constexpr int NA = HD / 64;
  const int q_start = q_off + q0, q_end = q_start + nrows - 1;
  const bool windowed = pos_q != nullptr;
  if (lane == 0) {
    mbar_arrive_expect_tx(resbar, NRES * TILE);
#pragma unroll
    for (int i = 0; i < NRES; ++i)
      for (int a = 0; a < NA; ++a)
        tma_load_4d(res_smem + i * TILE + a * ATOM, res[i], resbar, 64 * a, h, q0, b);
  }
  int qp_min = INT_MAX;
  if (windowed) {
    for (int r = lane; r < nrows; r += 32) qp_min = min(qp_min, pos_q[size_t(b) * S + q0 + r]);
    qp_min = __reduce_min_sync(0xffffffffu, qp_min);
  }
  const int* klb = kv_last + size_t(b) * Skv;
  const int* pkb = windowed ? pos_k + size_t(b) * Skv : nullptr;
  const int nt = min(q_end, Skv - 1) / KT + 1;       // the last causal key tile
  int stage = 0;
  uint32_t phase = 0;
  for (int t0 = 0; t0 < nt; t0 += SCAN) {
    // block_live(q_start, q_end, k0, max kv_last, qp_min, max pos_k) of
    // SCAN tiles: all loads first, then one reduction per tile.
    int kl_r[SCAN][2], pk_r[SCAN][2];
#pragma unroll
    for (int i = 0; i < SCAN; ++i)
#pragma unroll
      for (int u = 0; u < 2; ++u) {
        const int key = (t0 + i) * KT + lane + 32 * u;
        const bool in = t0 + i < nt && key < Skv;
        kl_r[i][u] = in ? klb[key] : -1;
        pk_r[i][u] = (in && windowed) ? pkb[key] : INT_MIN;
      }
    uint32_t live = 0;
#pragma unroll
    for (int i = 0; i < SCAN; ++i) {
      const int kmax = __reduce_max_sync(0xffffffffu, max(kl_r[i][0], kl_r[i][1]));
      bool ok = kmax >= q_start;                     // k0 ≤ q_end holds below nt
      if (windowed) {
        const int kpmax = __reduce_max_sync(0xffffffffu, max(pk_r[i][0], pk_r[i][1]));
        ok = ok && static_cast<long long>(qp_min) - kpmax < window;
      }
      live |= uint32_t(ok) << i;
    }
    while (live) {
      const int t = t0 + __ffs(live) - 1;
      live &= live - 1;
      const int k0 = t * KT;
      mbar_wait(&ring.empty[stage], phase ^ 1);
      for (int c = lane; c < KT; c += 32) {
        const bool in = k0 + c < Skv;
        cp_async_4(&ring.kl[stage * KT + c], klb + (in ? k0 + c : 0), in);
        if (windowed) cp_async_4(&ring.pk[stage * KT + c], pkb + (in ? k0 + c : 0), in);
      }
      cp_async_arrive(&ring.full[stage]);
      if (lane == 0) {
        ring.k0[stage] = k0;
        mbar_arrive_expect_tx(&ring.full[stage], 2 * TILE);
        unsigned char* kt = ring.kv + stage * 2 * TILE;
        for (int a = 0; a < NA; ++a) {
          tma_load_4d(kt + a * ATOM, kmap, &ring.full[stage], 64 * a, kh, k0, b);
          tma_load_4d(kt + TILE + a * ATOM, vmap, &ring.full[stage], 64 * a, kh, k0, b);
        }
      }
      if (++stage == STAGES) {
        stage = 0;
        phase ^= 1;
      }
    }
  }
  mbar_wait(&ring.empty[stage], phase ^ 1);          // the end marker
  cp_async_arrive(&ring.full[stage]);
  if (lane == 0) {
    ring.k0[stage] = -1;
    mbar_arrive(&ring.full[stage]);
  }
}

// ---- host: tensor maps ---------------------------------------------------
using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                 const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                 const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                 CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled from the driver, through the runtime's entry-point
// query (so the library needs no -lcuda at link time).
inline EncodeTiled encode_tiled() {
  static EncodeTiled fn = [] {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult q;
#if CUDART_VERSION >= 12050
    cudaError_t e = cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &p, 12000,
                                                     cudaEnableDefault, &q);
#else
    cudaError_t e = cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault,
                                            &q);
#endif
    return (e == cudaSuccess && q == cudaDriverEntryPointSuccess)
               ? reinterpret_cast<EncodeTiled>(p)
               : nullptr;
  }();
  return fn;
}

// The map of a contiguous bf16 tensor [B][R][NH][HD] whose box is 64
// columns × 1 head × 64 rows × 1 batch row, 128-byte swizzle; rows past R
// read as zero.
inline cudaError_t tile_map(CUtensorMap* map, const void* ptr, int B, int R, int NH, int HD) {
  EncodeTiled enc = encode_tiled();
  if (enc == nullptr) return cudaErrorNotSupported;
  const cuuint64_t dims[4] = {cuuint64_t(HD), cuuint64_t(NH), cuuint64_t(R), cuuint64_t(B)};
  const cuuint64_t strides[3] = {cuuint64_t(HD) * 2, cuuint64_t(NH) * HD * 2,
                                 cuuint64_t(R) * NH * HD * 2};
  const cuuint32_t box[4] = {64, 1, 64, 1};
  const cuuint32_t step[4] = {1, 1, 1, 1};
  const CUresult r = enc(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(ptr), dims,
                         strides, box, step, CU_TENSOR_MAP_INTERLEAVE_NONE,
                         CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                         CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? cudaSuccess : cudaErrorInvalidValue;
}

}  // namespace hop
