// K1's backward at head dimension 64 in bf16, designed for Hopper: the shape
// the ViT-L tower trains at under train_towers ([64, 577, 3072], 16 heads of
// 64).  Every other head dimension stays on the mma.sync body of
// attn_bwd.cuh, f32 on its CUDA-core kernels.
//
// Replaces: oryon_tpu/ops/pallas/mha_lanes.py `_bwd` (:180), as attn_bwd.cuh
// does, and computes the same function (attn_bwd.cuh's header): S =
// bf16(q k^T) * scale + kmask and P = softmax(S) in f32, dP = bf16(dO v^T),
// D = rowsum(P * dP) accumulated online beside the row sum (not rowsum(dO *
// O), another function under qk_int8), dS = P (dP - D), dV = bf16(P)^T dO,
// dQ = bf16(dS * scale) K, dK = bf16(dS * scale)^T Q with f32 sums rounded
// once, d kmask the sum of dS over images, heads and query rows.
//
// What bounds it on an H100: five L x L x 64 products per (image, head), 0.2206
// ms at [64, 577, 3072] at 989 TFLOP/s, and beside them the L x L
// exponentials on the special-function units (about 0.1 ms a pass at that
// shape).  The schedule is attn_bwd.cuh's deterministic split, so every
// output element is written by one thread and two launches are bitwise
// equal; what the design changes is how each product reaches the tensor
// cores:
//
//  * Every product is `wgmma` m64n64k16 (bf16 in, f32 sums in registers), and
//    each maps onto it without a shuffle through shared memory.  S = Q K^T
//    and dP = dO V^T read A and B from shared memory, B K-major.  dQ += dS K
//    reads dS from registers as A (the f32 accumulator of m64n64, packed in
//    pairs, is the bf16 A layout of m64k16, as P is in attn_wgmma.cuh); its
//    accumulator rows are already the query rows, and K is an N-major B read
//    as it lies (the transposed-B bit).  In dkv_kernel S^T = K Q^T and dP^T
//    = V dO^T put the keys on the rows, so dV += P^T dO and dK += dS^T Q read
//    A from registers with dO and Q as N-major B tiles.
//  * Loads overlap compute: a ring of streamed tiles kept in flight with TMA
//    (full and empty `mbarrier`s, attn_wgmma.cuh's ring).  dq_kernel streams
//    K and V, and a producer warp issues the loads and writes the keys' mask
//    values beside them; dkv_kernel streams Q and dO with their 64-row slices
//    of the row statistics m, 1 / l and D (bulk copies), and its thread 0
//    issues the loads, so no producer warp holds registers there.  A [64, 64]
//    bf16 tile has 128-byte rows under the 128-byte swizzle, so the
//    descriptors read what TMA wrote, and TMA's zero fill past row L keeps a
//    tile inside its image.
//  * Small independent blocks: one consumer warpgroup (64 rows) a block and
//    three resident on an SM (dq_kernel 128 registers a thread, dkv_kernel
//    167: a producer warp would leave room for two), so one block's start
//    and end overlap another's products.  Measured slower and left out
//    (PERF.md): two warpgroups sharing each streamed tile at one block an
//    SM; dq_kernel without its producer warp; and keeping the bf16 S and dP
//    of a block's rows in shared memory through the first sweep so that the
//    second forms only dQ's product (7 products instead of 9), which at 80
//    KB each for L <= 640 leaves room for one block an SM.
//    tools/attn_bwd_tile_sweep.py times the ring stages and resident blocks.
//
// Arithmetic in log2 units, as attn_wgmma.cuh: the logit is fma(bf16 sum,
// scale * log2(e), kmask * log2(e)) and the weights exp2 of it less the row
// max, one FMA and one `ex2.approx` a logit; m is stored in those units.
// Keys past L get -inf (P = 0); query rows past L get m = +inf and 1 / l = 0
// in dkv_kernel (P = 0); no row past L is written.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "attn_bwd.cuh"
#include "attn_wgmma.cuh"
#include "hopper.cuh"

namespace oryon_attn_bwd_wg {

using namespace oryon_hopper;
using oryon_attn_wg::fast_exp2;
using oryon_attn_wg::fence_regs;
using oryon_attn_wg::kLog2e;
using oryon_attn_wg::kTileBytes;
using oryon_attn_wg::pack_bf16;
using oryon_attn_wg::wgmma_rs_tb;
using oryon_attn_wg::wgmma_ss;

constexpr int kHD = 64;

// Phases of the entry: dq_kernel (row statistics and dQ), dkv_kernel (dK,
// dV, the per-key sums of dS, and d kmask when asked for).
enum Phase { kDq = 1, kDkv = 2 };

struct Params {
  __nv_bfloat16* dqkv;  // [B, L, 3C]
  const float* kmask;   // [L] additive f32
  float* stats;         // [3][B * heads * L]: row max m (log2 units), 1 / l, D
  float* colsum;        // [B * heads][L]: sum of dS over the query rows
  int L, C, heads;
  float scale, scale_log2;
};

// x rounded to bf16 in place, two at a time; returns the pair packed
__device__ __forceinline__ uint32_t round_pair(float& lo, float& hi) {
  const uint32_t v = pack_bf16(lo, hi);
  lo = __uint_as_float(v << 16);
  hi = __uint_as_float(v & 0xffff0000u);
  return v;
}

__device__ __forceinline__ float quad_sum(float x) {
  x += __shfl_xor_sync(0xffffffffu, x, 1);
  return x + __shfl_xor_sync(0xffffffffu, x, 2);
}

__device__ __forceinline__ float quad_max(float x) {
  x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 1));
  return fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 2));
}

// D[64, 64] = A[64, 64] . B^T over the head dim: two [64, 64] K-major tiles
// (4 k16 steps of 32 bytes), issued and not waited for.
__device__ __forceinline__ void issue_rows_dot(float (&d)[32], uint64_t desc_a,
                                               uint64_t desc_b) {
#pragma unroll
  for (int kk = 0; kk < kHD / 16; ++kk) wgmma_ss(d, desc_a + 2 * kk, desc_b + 2 * kk, kk > 0);
}

// D[64, 64] += A[64, 64 (registers)] . B[64, 64]: B a row-major tile read
// N-major (a k16 step is 16 rows, 2048 bytes), issued and not waited for.
__device__ __forceinline__ void issue_reg_dot(float (&d)[32], const uint32_t (&a)[16],
                                              uint64_t desc_b) {
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) {
    wgmma_rs_tb(d, a[4 * kk], a[4 * kk + 1], a[4 * kk + 2], a[4 * kk + 3],
                desc_b + kk * (2048 >> 4));
  }
}

__device__ __forceinline__ void fence_regs(uint32_t (&a)[16]) {
#pragma unroll
  for (int i = 0; i < 16; ++i) asm volatile("" : "+r"(a[i])::"memory");
}

// Writes the warpgroup's [64, 64] f32 accumulator as bf16 rows below L:
// staged in `stage` (a swizzled tile the group has finished reading), then
// 16-byte stores, 8 threads a row.  `dst` is row 0's first element; rows `rs`
// apart.
__device__ __forceinline__ void store_tile(const float (&acc)[32], unsigned char* stage,
                                           __nv_bfloat16* dst, long long rs, int row0,
                                           int L, int quad_row, int c2, int tid) {
  named_barrier_sync(1, 128);
#pragma unroll
  for (int j = 0; j < 8; ++j) {
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int row = quad_row + 8 * r;
      *reinterpret_cast<uint32_t*>(stage + row * 128 + ((j ^ (row & 7)) << 4) + c2 * 2) =
          pack_bf16(acc[4 * j + 2 * r], acc[4 * j + 2 * r + 1]);
    }
  }
  named_barrier_sync(1, 128);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int idx = tid + i * 128;
    const int row = idx / 8, chunk = idx % 8;
    if (row0 + row < L) {
      *reinterpret_cast<uint4*>(dst + (row0 + row) * rs + chunk * 8) =
          *reinterpret_cast<const uint4*>(stage + row * 128 + ((chunk ^ (row & 7)) << 4));
    }
  }
}

// ------------------------------------------------------------- dq_kernel

// Shared memory from a 1024-byte aligned base: the Q and dO tiles of the
// block's 64 rows (Q later stages dQ), the ring of K and V tiles, per stage
// the keys' mask values, the barriers.
template <int kStages>
struct DqSmem {
  static constexpr int q_off = 0;
  static constexpr int o_off = kTileBytes;
  static constexpr int ring_off = 2 * kTileBytes;
  static constexpr int aux_off = ring_off + kStages * 2 * kTileBytes;
  static constexpr int bar_off = aux_off + kStages * 64 * 4;
  static constexpr int alloc = bar_off + (2 * kStages + 1) * 8 + 1024;
};

// grid (ceil(L / 64), heads, B): dQ of 64 query rows, and their m, 1 / l and
// D in whole 64-row tiles (stats [3][B * heads * Lp], Lp = L rounded up).
// Sweep 1 over the keys forms S and dP and keeps, per row, the running max
// m, the running sum l of exp2(S - m) and the running sum of exp2(S - m) * dP
// (both rescaled as m moves), so D is the reference's rowsum(P * dP).  Sweep
// 2 forms S and dP again, P and dS from the statistics, and accumulates dQ +=
// bf16(dS * scale) K.  One consumer warpgroup and a producer warp.
template <int kStages, int kMinBlocks>
__global__ void __launch_bounds__(128 + 32, kMinBlocks)
dq_kernel(const __grid_constant__ CUtensorMap map_qkv,
          const __grid_constant__ CUtensorMap map_do, const Params p) {
  using Lay = DqSmem<kStages>;
  extern __shared__ unsigned char smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t base = (raw + 1023u) & ~1023u;
  unsigned char* gbase = smem_raw + (base - raw);
  const uint32_t bar_full = base + Lay::bar_off;
  const uint32_t bar_empty = bar_full + kStages * 8;
  const uint32_t bar_q = bar_empty + kStages * 8;

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int q0 = blockIdx.x * 64, h = blockIdx.y, b = blockIdx.z;
  const int L = p.L, C = p.C;
  const int n_tiles = (L + 63) / 64;
  const int col_q = h * kHD;

  if (threadIdx.x == 0) {
    for (int s = 0; s < kStages; ++s) {
      mbar_init(bar_full + s * 8, 1);
      mbar_init(bar_empty + s * 8, 4);  // one arrive a consumer warp
    }
    mbar_init(bar_q, 1);
    mbar_init_fence();
  }
  __syncthreads();

  if (warp == 4) {
    // ------------------------------------------------------ producer warp
    if (lane == 0) {
      mbar_arrive_expect_tx(bar_q, 2 * kTileBytes);
      tma_load_tile(base + Lay::q_off, &map_qkv, bar_q, col_q, q0, b);
      tma_load_tile(base + Lay::o_off, &map_do, bar_q, col_q, q0, b);
    }
    for (int it = 0; it < 2 * n_tiles; ++it) {
      const int stage = it % kStages;
      mbar_wait(bar_empty + stage * 8, ((it / kStages) & 1u) ^ 1u);  // free at first
      const int k0 = (it % n_tiles) * 64;
      for (int j = lane; j < 64; j += 32) {
        reinterpret_cast<float*>(gbase + Lay::aux_off)[stage * 64 + j] =
            k0 + j < L ? p.kmask[k0 + j] * kLog2e : -INFINITY;
      }
      __syncwarp();  // the arrive below publishes every lane's values
      if (lane == 0) {
        const uint32_t full = bar_full + stage * 8;
        const uint32_t kdst = base + Lay::ring_off + stage * 2 * kTileBytes;
        mbar_arrive_expect_tx(full, 2 * kTileBytes);
        tma_load_tile(kdst, &map_qkv, full, C + col_q, k0, b);
        tma_load_tile(kdst + kTileBytes, &map_qkv, full, 2 * C + col_q, k0, b);
      }
    }
    return;
  }

  // ---------------------------------------------------- consumer warpgroup
  const int tid = threadIdx.x;
  const int quad_row = warp * 16 + lane / 4;  // rows quad_row, quad_row + 8
  const int c2 = (lane % 4) * 2;              // columns j * 8 + c2, + 1
  const uint64_t q_desc = make_desc<kSwizzle128>(base + Lay::q_off);
  const uint64_t o_desc = make_desc<kSwizzle128>(base + Lay::o_off);
  const auto aux_of = [&](int stage) {
    return reinterpret_cast<const float*>(gbase + Lay::aux_off) + stage * 64;
  };
  const auto ring_of = [&](int stage) { return base + Lay::ring_off + stage * 2 * kTileBytes; };
  const auto release = [&](int stage) {
    __syncwarp();
    if (lane == 0) mbar_arrive(bar_empty + stage * 8);
  };
  // the logits in log2 units: fma(bf16 sum, scale * log2(e), mask * log2(e))
  const auto to_logits = [&](float (&x)[32], const float* aux) {
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const float2 mk = *reinterpret_cast<const float2*>(aux + j * 8 + c2);
#pragma unroll
      for (int e = 0; e < 4; ++e) x[4 * j + e] = fmaf(x[4 * j + e], p.scale_log2, (e & 1) ? mk.y : mk.x);
    }
  };

  float m_run[2] = {-INFINITY, -INFINITY}, l_run[2] = {0.f, 0.f}, d_run[2] = {0.f, 0.f};
  float dq[32];
#pragma unroll
  for (int i = 0; i < 32; ++i) dq[i] = 0.f;
  float s[32], dp[32];
  mbar_wait(bar_q, 0);

  // S and dP of the key tile in `stage`, rounded to bf16
  const auto products = [&](int stage) {
    fence_regs(s);
    fence_regs(dp);
    wgmma_fence();
    issue_rows_dot(s, q_desc, make_desc<kSwizzle128>(ring_of(stage)));
    issue_rows_dot(dp, o_desc, make_desc<kSwizzle128>(ring_of(stage) + kTileBytes));
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(s);
    fence_regs(dp);
#pragma unroll
    for (int i = 0; i < 16; ++i) {
      round_pair(s[2 * i], s[2 * i + 1]);
      round_pair(dp[2 * i], dp[2 * i + 1]);
    }
  };

  for (int tile = 0; tile < n_tiles; ++tile) {  // sweep 1: statistics
    const int stage = tile % kStages;
    mbar_wait(bar_full + stage * 8, (tile / kStages) & 1u);
    products(stage);
    to_logits(s, aux_of(stage));
    release(stage);  // K, V and the mask are read
    float tmax[2] = {-INFINITY, -INFINITY};
#pragma unroll
    for (int i = 0; i < 32; ++i) tmax[(i >> 1) & 1] = fmaxf(tmax[(i >> 1) & 1], s[i]);
    float m_safe[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const float m_new = fmaxf(m_run[r], quad_max(tmax[r]));
      m_safe[r] = m_new == -INFINITY ? 0.f : m_new;
      const float corr = fast_exp2(m_run[r] - m_safe[r]);  // 0 before the first key
      l_run[r] *= corr;
      d_run[r] *= corr;
      m_run[r] = m_new;
    }
#pragma unroll
    for (int i = 0; i < 32; ++i) {
      const int r = (i >> 1) & 1;
      const float x = fast_exp2(s[i] - m_safe[r]);
      l_run[r] += x;
      d_run[r] = fmaf(x, dp[i], d_run[r]);
    }
  }

  float il[2], dd[2];  // 1 / l and D
  {  // every row of the tile; rows past L get +inf, 0, 0 (P = 0 in dkv_kernel)
    const size_t plane = size_t(gridDim.z) * p.heads * n_tiles * 64;
    const size_t row0 = (size_t(b) * p.heads + h) * n_tiles * 64;
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      l_run[r] = quad_sum(l_run[r]);
      d_run[r] = quad_sum(d_run[r]);
      il[r] = 1.f / l_run[r];
      dd[r] = d_run[r] * il[r];  // D = rowsum(P * dP)
      const int q = q0 + quad_row + 8 * r;
      if ((lane & 3) == 0) {
        const bool live = q < L;
        p.stats[row0 + q] = live ? m_run[r] : INFINITY;
        p.stats[plane + row0 + q] = live ? il[r] : 0.f;
        p.stats[2 * plane + row0 + q] = live ? dd[r] : 0.f;
      }
    }
  }

  for (int tile = 0; tile < n_tiles; ++tile) {  // sweep 2: dQ
    const int it = n_tiles + tile, stage = it % kStages;
    mbar_wait(bar_full + stage * 8, (it / kStages) & 1u);
    products(stage);
    to_logits(s, aux_of(stage));
    uint32_t a[16];  // bf16(dS * scale) as the A fragments of dQ's product
#pragma unroll
    for (int j = 0; j < 8; ++j) {
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        float ds[2];
#pragma unroll
        for (int c = 0; c < 2; ++c) {
          const int i = 4 * j + 2 * r + c;
          const float pr = fast_exp2(s[i] - m_run[r]) * il[r];
          ds[c] = pr * (dp[i] - dd[r]) * p.scale;
        }
        a[2 * j + r] = pack_bf16(ds[0], ds[1]);
      }
    }
    fence_regs(dq);
    wgmma_fence();
    issue_reg_dot(dq, a, make_desc<kSwizzle128>(ring_of(stage)));
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(dq);
    fence_regs(a);
    release(stage);
  }

  __nv_bfloat16* dst = p.dqkv + (long long)b * L * 3 * C + col_q;
  store_tile(dq, gbase + Lay::q_off, dst, 3LL * C, q0, L, quad_row, c2, tid);
}

// ------------------------------------------------------------ dkv_kernel

// Shared memory from a 1024-byte aligned base: the K and V tiles (later they
// stage dK and dV), the ring of Q and dO tiles, per stage the 64 queries' m,
// 1 / l and D, the barriers.
template <int kStages>
struct DkvSmem {
  static constexpr int k_off = 0;
  static constexpr int v_off = kTileBytes;
  static constexpr int ring_off = 2 * kTileBytes;
  static constexpr int aux_off = ring_off + kStages * 2 * kTileBytes;
  static constexpr int bar_off = aux_off + kStages * 3 * 64 * 4;
  static constexpr int alloc = bar_off + (2 * kStages + 1) * 8 + 1024;
};

// grid (ceil(L / 64), heads, B): dK and dV of 64 keys and their sums of dS.
// Walks the query tiles: S^T and dP^T, P^T and dS^T from the row statistics,
// dV += bf16(P)^T dO, dK += bf16(dS * scale)^T Q.  No producer warp: thread
// 0 issues the first kStages fills at the start and each next one once every
// warp has released the stage it goes to; a fill is a Q and a dO tile by TMA
// and the tile's three 256-byte rows of statistics by bulk copies.
template <int kStages, int kMinBlocks>
__global__ void __launch_bounds__(128, kMinBlocks)
dkv_kernel(const __grid_constant__ CUtensorMap map_qkv,
           const __grid_constant__ CUtensorMap map_do, const Params p) {
  using Lay = DkvSmem<kStages>;
  extern __shared__ unsigned char smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t base = (raw + 1023u) & ~1023u;
  unsigned char* gbase = smem_raw + (base - raw);
  const uint32_t bar_full = base + Lay::bar_off;
  const uint32_t bar_empty = bar_full + kStages * 8;
  const uint32_t bar_kv = bar_empty + kStages * 8;

  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int k0 = blockIdx.x * 64, h = blockIdx.y, b = blockIdx.z;
  const int L = p.L, C = p.C;
  const int n_tiles = (L + 63) / 64;
  const int col_q = h * kHD;
  const size_t plane = size_t(gridDim.z) * p.heads * n_tiles * 64;
  const size_t row0 = (size_t(b) * p.heads + h) * n_tiles * 64;

  if (tid == 0) {
    for (int s = 0; s < kStages; ++s) {
      mbar_init(bar_full + s * 8, 1);
      mbar_init(bar_empty + s * 8, 4);
    }
    mbar_init(bar_kv, 1);
    mbar_init_fence();
  }
  __syncthreads();

  const auto issue = [&](int f) {  // query tile f
    const int stage = f % kStages;
    const uint32_t full = bar_full + stage * 8;
    const uint32_t qdst = base + Lay::ring_off + stage * 2 * kTileBytes;
    const uint32_t aux = base + Lay::aux_off + stage * 3 * 256;
    mbar_arrive_expect_tx(full, 2 * kTileBytes + 3 * 256);
    tma_load_tile(qdst, &map_qkv, full, col_q, f * 64, b);
    tma_load_tile(qdst + kTileBytes, &map_do, full, col_q, f * 64, b);
    for (int i = 0; i < 3; ++i) bulk_load(aux + i * 256, p.stats + i * plane + row0 + f * 64, 256, full);
  };
  if (tid == 0) {
    mbar_arrive_expect_tx(bar_kv, 2 * kTileBytes);
    tma_load_tile(base + Lay::k_off, &map_qkv, bar_kv, C + col_q, k0, b);
    tma_load_tile(base + Lay::v_off, &map_qkv, bar_kv, 2 * C + col_q, k0, b);
    for (int f = 0; f < kStages && f < n_tiles; ++f) issue(f);
  }

  const int quad_row = warp * 16 + lane / 4;  // keys quad_row, quad_row + 8
  const int c2 = (lane % 4) * 2;              // queries j * 8 + c2, + 1
  const uint64_t k_desc = make_desc<kSwizzle128>(base + Lay::k_off);
  const uint64_t v_desc = make_desc<kSwizzle128>(base + Lay::v_off);

  float km[2];  // the mask of this thread's two keys (log2 units); -inf past L
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int key = k0 + quad_row + 8 * r;
    km[r] = key < L ? p.kmask[key] * kLog2e : -INFINITY;
  }
  float cs[2] = {0.f, 0.f};
  float dk[32], dv[32];
#pragma unroll
  for (int i = 0; i < 32; ++i) dk[i] = dv[i] = 0.f;
  float st[32], dpt[32];  // S^T and dP^T: rows keys, columns queries
  mbar_wait(bar_kv, 0);

  for (int it = 0; it < n_tiles; ++it) {
    const int stage = it % kStages;
    const uint32_t qaddr = base + Lay::ring_off + stage * 2 * kTileBytes;
    const uint64_t q_desc = make_desc<kSwizzle128>(qaddr);
    const uint64_t o_desc = make_desc<kSwizzle128>(qaddr + kTileBytes);
    const float* aux = reinterpret_cast<const float*>(gbase + Lay::aux_off) + stage * 3 * 64;
    mbar_wait(bar_full + stage * 8, (it / kStages) & 1u);
    fence_regs(st);
    fence_regs(dpt);
    wgmma_fence();
    issue_rows_dot(st, k_desc, q_desc);
    issue_rows_dot(dpt, v_desc, o_desc);
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(st);
    fence_regs(dpt);

    uint32_t ap[16], as[16];  // bf16(P)^T and bf16(dS * scale)^T as A fragments
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int col = j * 8 + c2;
      const float2 m2 = *reinterpret_cast<const float2*>(aux + col);
      const float2 il2 = *reinterpret_cast<const float2*>(aux + 64 + col);
      const float2 d2 = *reinterpret_cast<const float2*>(aux + 128 + col);
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        float pr[2], ds[2];
        const int i = 4 * j + 2 * r;
        round_pair(st[i], st[i + 1]);
        round_pair(dpt[i], dpt[i + 1]);
#pragma unroll
        for (int c = 0; c < 2; ++c) {
          const float sl = fmaf(st[i + c], p.scale_log2, km[r]);
          pr[c] = fast_exp2(sl - (c ? m2.y : m2.x)) * (c ? il2.y : il2.x);
          ds[c] = pr[c] * (dpt[i + c] - (c ? d2.y : d2.x));
          cs[r] += ds[c];
        }
        ap[2 * j + r] = pack_bf16(pr[0], pr[1]);
        as[2 * j + r] = pack_bf16(ds[0] * p.scale, ds[1] * p.scale);
      }
    }
    fence_regs(dv);
    fence_regs(dk);
    wgmma_fence();
    issue_reg_dot(dv, ap, o_desc);
    issue_reg_dot(dk, as, q_desc);
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(dv);
    fence_regs(dk);
    fence_regs(ap);
    fence_regs(as);
    __syncwarp();
    if (lane == 0) mbar_arrive(bar_empty + stage * 8);
    if (tid == 0 && it + kStages < n_tiles) {  // every warp is done with the stage
      mbar_wait(bar_empty + stage * 8, (it / kStages) & 1u);
      issue(it + kStages);
    }
    __syncwarp();
  }

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const float sum = quad_sum(cs[r]);
    const int key = k0 + quad_row + 8 * r;
    if ((lane & 3) == 0 && key < L) p.colsum[(size_t(b) * p.heads + h) * L + key] = sum;
  }
  __nv_bfloat16* dst = p.dqkv + (long long)b * L * 3 * C + col_q;
  store_tile(dk, gbase + Lay::k_off, dst + C, 3LL * C, k0, L, quad_row, c2, tid);
  store_tile(dv, gbase + Lay::v_off, dst + 2 * C, 3LL * C, k0, L, quad_row, c2, tid);
}

// --------------------------------------------------------------- host side

// What every launch of one backward shares: the tensor maps over qkv and
// dout, the parameters, the batch and where d kmask goes.
struct Launch {
  CUtensorMap mqkv, mdo;
  Params p;
  int B;
  float* dkmask;
};

// qkv [B, L, 3C] and dout [B, L, C] bf16 with C = heads * 64, kmask [L] f32;
// dqkv [B, L, 3C] bf16 out, dkmask [L] f32 out or null; stats [3, B * heads
// * Lp] (Lp: L rounded up to whole 64-row tiles) and colsum [B * heads, L]
// f32 scratch.
inline cudaError_t prepare(Launch& x, const void* qkv, const void* kmask, const void* dout,
                           void* dqkv, void* stats, void* colsum, void* dkmask, int B, int L,
                           int C, int heads, float scale) {
  if (B <= 0 || L <= 0 || heads <= 0 || C != heads * kHD) return cudaErrorInvalidValue;
  if (reinterpret_cast<uintptr_t>(stats) % 16 != 0) return cudaErrorMisalignedAddress;
  cudaError_t err = encode_map(&x.mqkv, qkv, 2, 3ull * C, L, B, 6ull * C,
                               6ull * C * uint64_t(L), 64, 64);
  if (err != cudaSuccess) return err;
  err = encode_map(&x.mdo, dout, 2, uint64_t(C), L, B, 2ull * C, 2ull * C * uint64_t(L), 64, 64);
  if (err != cudaSuccess) return err;
  x.p = Params{};
  x.p.dqkv = static_cast<__nv_bfloat16*>(dqkv);
  x.p.kmask = static_cast<const float*>(kmask);
  x.p.stats = static_cast<float*>(stats);
  x.p.colsum = static_cast<float*>(colsum);
  x.p.L = L;
  x.p.C = C;
  x.p.heads = heads;
  x.p.scale = scale;
  x.p.scale_log2 = scale * kLog2e;
  x.B = B;
  x.dkmask = static_cast<float*>(dkmask);
  return cudaSuccess;
}

// grid (ceil(L / 64), heads, B)
template <typename Kernel>
inline cudaError_t launch_kernel(Kernel kernel, int threads, int bytes, const Launch& x,
                                 cudaStream_t stream) {
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err != cudaSuccess) return err;
  const dim3 grid((x.p.L + 63) / 64, x.p.heads, x.B);
  kernel<<<grid, threads, bytes, stream>>>(x.mqkv, x.mdo, x.p);
  return cudaGetLastError();
}

// dQ and the row statistics
template <int kStages, int kMinBlocks>
inline cudaError_t launch_dq(const Launch& x, cudaStream_t stream) {
  return launch_kernel(dq_kernel<kStages, kMinBlocks>, 128 + 32, DqSmem<kStages>::alloc, x,
                       stream);
}

// dK, dV and the per-key sums of dS, then d kmask when it is asked for
template <int kStages, int kMinBlocks>
inline cudaError_t launch_dkv(const Launch& x, cudaStream_t stream) {
  cudaError_t err = launch_kernel(dkv_kernel<kStages, kMinBlocks>, 128,
                                  DkvSmem<kStages>::alloc, x, stream);
  if (err != cudaSuccess || x.dkmask == nullptr) return err;
  oryon_attn_bwd::colsum_kernel<<<(x.p.L + 255) / 256, 256, 0, stream>>>(
      x.p.colsum, x.dkmask, x.B * x.p.heads, x.p.L);
  return cudaGetLastError();
}

// The whole backward, or the kernels `phases` (Phase bits) name, in the
// configurations the measurements chose (PERF.md): ring stages and resident
// blocks asked of the compiler.
inline cudaError_t launch(const void* qkv, const void* kmask, const void* dout, void* dqkv,
                          void* stats, void* colsum, void* dkmask, int B, int L, int C,
                          int heads, float scale, int phases, cudaStream_t stream) {
  Launch x;
  cudaError_t err = prepare(x, qkv, kmask, dout, dqkv, stats, colsum, dkmask, B, L, C, heads,
                            scale);
  if (err != cudaSuccess) return err;
  if (phases & kDq) err = launch_dq<3, 3>(x, stream);
  if (err == cudaSuccess && (phases & kDkv)) err = launch_dkv<3, 3>(x, stream);
  return err;
}

}  // namespace oryon_attn_bwd_wg
