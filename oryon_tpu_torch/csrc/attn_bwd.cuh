// K1's backward: d qkv and d kmask of attention on the lane-packed
// [B, L, 3C] rows, given the gradient dout [B, L, C] of its output.
//
// Replaces: oryon_tpu/ops/pallas/mha_lanes.py `_bwd` (:180), the backward of
// the custom_vjp around K1 (`fused_mha_lanes_qkv`), which is jax.vjp of the
// plain `_reference_mha` compiled by XLA.  With qk_int8=True (K1-i8) the
// gradient is straight-through, the same function, so this kernel serves both.
//
// What it computes, per (image b, head h), on the [L, hd] slabs q, k, v, dO
// (head h of q at columns [h*hd, (h+1)*hd) of the first C, of k and v in the
// second and third C; dQ, dK and dV go to the same columns of dqkv):
//   S  = bf16(q k^T) * scale + kmask   f32 (the reference's einsum rounds to bf16)
//   P  = softmax(S)                    f32
//   dV = bf16(P)^T dO
//   dP = bf16(dO v^T)
//   D  = rowsum(P * dP)                f32, autograd's softmax backward; not
//                                      rowsum(dO * O), which needs the forward's
//                                      output and is another function under
//                                      qk_int8 (the forward's O has int8 logits)
//   dS = P * (dP - D)                  f32
//   dQ = bf16(dS * scale) k,  dK = bf16(dS * scale)^T q
//   dkmask = sum of dS over b, h and query rows
// Every rounding point of the reference is kept; the products accumulate in
// f32 and round once into dqkv.  What differs is the order of summation, so a
// bf16 logit or dP near a rounding tie can land one bf16 ulp away.  In f32
// (the small and tiny towers) there is no rounding at all: bf16(x) is x.
//
// What bounds it on an H100: five L x L x hd products per (image, head) (S,
// dP, dV, dQ, dK), 10 * B * heads * L^2 * hd operations: 0.2206 ms at the
// training shape [64, 577, 3072] bf16 (16 heads of 64) at 989 TFLOP/s, against
// about 0.06 ms for its bytes (qkv and dout read, dqkv written once).  The
// reference materialises S, P, dP and dS as [B, heads, L, L] tensors in
// device memory (1.36 GB each in f32 at that shape); here no L x L tensor
// leaves the chip: the scratch is O(B * heads * L).
//
// Design (FA2's deterministic split, no atomics, simple before fast):
//  1. dq_kernel: a block of 4 warps owns 64 query rows of one (b, h), each
//     warp 16.  Sweep 1 over the keys forms S and dP and keeps, per row, the
//     running max m, the running sum l of exp(S - m) and the running sum of
//     exp(S - m) * dP (rescaled by exp(m_old - m_new), like the forward's O),
//     so D is the reference's rowsum(P * dP); it writes m, l and D to a
//     [3, B * heads * L] scratch.  Sweep 2 forms S and dP again, P from m and
//     l, dS, and accumulates dQ += bf16(dS * scale) K in registers.
//  2. dkv_kernel: a block owns 64 keys, each warp 16.  It walks the query
//     tiles: S^T and dP^T, P^T from the stats, dS^T; dV += bf16(P)^T dO and
//     dK += bf16(dS * scale)^T Q in registers, and the sum of dS over the
//     query rows for each key into a [B * heads, L] scratch.
//  3. colsum_kernel (when kmask needs a gradient): dkmask[j] sums that
//     scratch over b and h in a fixed order.
// So every element is written by one thread and two launches are bitwise
// equal.  The price is 9 products instead of 5 (S three times, dP three
// times): the work a dQ kept in device memory with atomic adds would save.
// Tensor cores through mma.sync m16n8k16 (bf16 in, f32 sums): the S and dP
// accumulators of a 16-key (or 16-query) chunk become the A operand of the
// next product in registers (FA2's layout: the m16n8 accumulators of two
// neighbouring 8-column tiles are one m16k16 A fragment); K, V, Q and dO
// tiles sit in shared memory, row-major with 8 bf16 of padding (conflict-free
// 32-bit fragment loads), and the operands taken along their rows come
// through ldmatrix .trans.  L needs no alignment: keys past L get a mask of
// -inf, query rows past L load as zeros and get m = +inf (P = 0), and no row
// past L is written.  wgmma and TMA are later work.
//
// f32 (CUDA cores, for the small and tiny towers, head dims 16-128): the same
// two kernels and reduction with attn_f32.cuh's shape: 4 warps a block, 4 rows
// a warp, one key (or query) a lane, tiles of 32 through shared memory.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace oryon_attn_bwd {

constexpr int kTile = 64;     // rows a block owns, and rows of a streamed tile
constexpr int kThreads = 128; // 4 warps
constexpr unsigned kFull = 0xffffffffu;

struct BwdParams {
  const void* qkv;     // [B, L, 3C] bf16 or f32
  const float* kmask;  // [L] additive f32
  const void* dout;    // [B, L, C], qkv's dtype
  void* dqkv;          // [B, L, 3C], qkv's dtype
  float* stats;        // [3][B * heads * L]: row max m, row sum l, D
  float* colsum;       // [B * heads][L]: sum of dS over the query rows
  int L, C, heads;
  float scale;
};

using bf16 = __nv_bfloat16;

__device__ __forceinline__ float round_bf16(float x) {
  return __bfloat162float(__float2bfloat16(x));
}

// two f32 as one register of two bf16, lo in the low half
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// d[16 x 8] += a[16 x 16] b[16 x 8]: bf16 operands, f32 sums
__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// Fragment layouts of m16n8k16 (g = lane / 4, t = lane % 4): a register of A
// holds (row g or g + 8, columns 2t, 2t + 1, or those + 8); of B (k x n),
// (k = 2t, 2t + 1, or those + 8; n = g); of the accumulator, c0 c1 = (row g,
// columns 2t, 2t + 1) and c2 c3 = (row g + 8, the same columns).

// A = tile rows [r0, r0 + 16) x columns [c0, c0 + 16), tile row-major
template <int LD>
__device__ __forceinline__ void load_a(uint32_t (&a)[4], const bf16* tile, int r0,
                                       int c0, int g, int t) {
  const bf16* p = tile + (r0 + g) * LD + c0 + 2 * t;
  a[0] = *reinterpret_cast<const uint32_t*>(p);
  a[1] = *reinterpret_cast<const uint32_t*>(p + 8 * LD);
  a[2] = *reinterpret_cast<const uint32_t*>(p + 8);
  a[3] = *reinterpret_cast<const uint32_t*>(p + 8 * LD + 8);
}

// B (k x n = 16 x 8) whose transpose is the tile: n = tile rows [n0, n0 + 8),
// k = columns [k0, k0 + 16)
template <int LD>
__device__ __forceinline__ void load_b(uint32_t& b0, uint32_t& b1, const bf16* tile,
                                       int n0, int k0, int g, int t) {
  const bf16* p = tile + (n0 + g) * LD + k0 + 2 * t;
  b0 = *reinterpret_cast<const uint32_t*>(p);
  b1 = *reinterpret_cast<const uint32_t*>(p + 8);
}

// Two B fragments (k x n = 16 x 8 each, n in [n0, n0 + 8) and [n0 + 8,
// n0 + 16)) that are the tile itself: k = tile rows [k0, k0 + 16).  One
// ldmatrix .x4 .trans: lane l addresses row (l & 7) of 8 x 8 matrix l / 8;
// matrices 0 and 1 are k rows 0-7 and 8-15 of the first n tile (its b0, b1),
// 2 and 3 those of the second.
template <int LD>
__device__ __forceinline__ void load_b_trans(uint32_t (&b)[4], const bf16* tile, int k0,
                                             int n0, int lane) {
  const int m = lane >> 3;
  const bf16* p = tile + (k0 + (m & 1) * 8 + (lane & 7)) * LD + n0 + (m >> 1) * 8;
  const uint32_t addr = static_cast<uint32_t>(__cvta_generic_to_shared(p));
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(b[0]), "=r"(b[1]), "=r"(b[2]), "=r"(b[3])
               : "r"(addr));
}

// rows [row0, row0 + 64) x HD columns of a slab (row stride rs elements) into
// a row-major shared tile of row stride LD; rows at or past L become zeros
template <int HD, int LD>
__device__ __forceinline__ void load_tile(bf16* dst, const bf16* base, long long rs,
                                          int row0, int L) {
  constexpr int kVec = HD / 8;  // 16-byte vectors a row
  for (int i = threadIdx.x; i < kTile * kVec; i += kThreads) {
    const int r = i / kVec, c = i % kVec;
    uint4 v = make_uint4(0, 0, 0, 0);
    if (row0 + r < L) v = *reinterpret_cast<const uint4*>(base + (row0 + r) * rs + c * 8);
    *reinterpret_cast<uint4*>(dst + r * LD + c * 8) = v;
  }
}

// x[16 x 16] = a b^T over HD: the warp's 16 rows of tile a (from row r0)
// against rows [c0, c0 + 16) of tile b, both row-major; two 8-column
// accumulators, f32 sums
template <int HD, int LD>
__device__ __forceinline__ void rows_dot(float (&x)[2][4], const bf16* a, int r0,
                                         const bf16* b, int c0, int g, int t) {
#pragma unroll
  for (int n = 0; n < 2; ++n) x[n][0] = x[n][1] = x[n][2] = x[n][3] = 0.f;
#pragma unroll
  for (int ks = 0; ks < HD / 16; ++ks) {
    uint32_t af[4], b0, b1;
    load_a<LD>(af, a, r0, ks * 16, g, t);
#pragma unroll
    for (int n = 0; n < 2; ++n) {
      load_b<LD>(b0, b1, b, c0 + n * 8, ks * 16, g, t);
      mma_bf16(x[n], af, b0, b1);
    }
  }
}

__device__ __forceinline__ float quad_sum(float x) {
  x += __shfl_xor_sync(kFull, x, 1);
  return x + __shfl_xor_sync(kFull, x, 2);
}

__device__ __forceinline__ float quad_max(float x) {
  x = fmaxf(x, __shfl_xor_sync(kFull, x, 1));
  return fmaxf(x, __shfl_xor_sync(kFull, x, 2));
}

template <int HD>
struct Smem {
  static constexpr int LD = HD + 8;  // bf16 row stride of every tile
  static constexpr size_t tile = size_t(kTile) * LD * sizeof(bf16);
  static constexpr size_t bytes = 4 * tile + 3 * kTile * sizeof(float);
};

// grid (ceil(L / 64), heads, B): dQ of 64 query rows, and their m, l, D
template <int HD>
__global__ void __launch_bounds__(kThreads) dq_kernel(const BwdParams p) {
  constexpr int LD = Smem<HD>::LD;
  extern __shared__ __align__(16) unsigned char smem[];
  bf16* sQ = reinterpret_cast<bf16*>(smem);
  bf16* sO = sQ + kTile * LD;  // dO rows
  bf16* sK = sO + kTile * LD;
  bf16* sV = sK + kTile * LD;
  float* sM = reinterpret_cast<float*>(sV + kTile * LD);  // kmask, -inf past L

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const int q0 = blockIdx.x * kTile, h = blockIdx.y, b = blockIdx.z;
  const int L = p.L, C = p.C;
  const long long rs = 3LL * C;
  const bf16* qb = static_cast<const bf16*>(p.qkv) + (long long)b * L * rs + h * HD;
  const bf16* kb = qb + C;
  const bf16* vb = qb + 2 * C;
  const bf16* ob = static_cast<const bf16*>(p.dout) + (long long)b * L * C + h * HD;
  load_tile<HD, LD>(sQ, qb, rs, q0, L);
  load_tile<HD, LD>(sO, ob, C, q0, L);
  const int wr = warp * 16;  // the warp's first row in the tile

  // per row of this thread (r = 0: row g, r = 1: row g + 8): running max,
  // then sums over this thread's columns of exp(S - m) and exp(S - m) * dP;
  // after sweep 1, l over the row and D
  float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f}, dd[2] = {0.f, 0.f};
  float il[2] = {0.f, 0.f};
  float dq[HD / 8][4];
#pragma unroll
  for (int n = 0; n < HD / 8; ++n) dq[n][0] = dq[n][1] = dq[n][2] = dq[n][3] = 0.f;

  for (int sweep = 0; sweep < 2; ++sweep) {
    for (int k0 = 0; k0 < L; k0 += kTile) {
      __syncthreads();  // the last tile is consumed (and Q, dO stored)
      load_tile<HD, LD>(sK, kb, rs, k0, L);
      load_tile<HD, LD>(sV, vb, rs, k0, L);
      for (int j = threadIdx.x; j < kTile; j += kThreads) {
        sM[j] = k0 + j < L ? p.kmask[k0 + j] : -INFINITY;
      }
      __syncthreads();
      const int chunks = min(4, (L - k0 + 15) / 16);
      for (int c = 0; c < chunks; ++c) {  // keys [k0 + 16c, k0 + 16c + 16)
        float s[2][4], dp[2][4];
        rows_dot<HD, LD>(s, sQ, wr, sK, c * 16, g, t);
        rows_dot<HD, LD>(dp, sO, wr, sV, c * 16, g, t);
#pragma unroll
        for (int n = 0; n < 2; ++n) {
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            s[n][e] = round_bf16(s[n][e]) * p.scale + sM[c * 16 + n * 8 + 2 * t + (e & 1)];
            dp[n][e] = round_bf16(dp[n][e]);
          }
        }
        if (sweep == 0) {
#pragma unroll
          for (int r = 0; r < 2; ++r) {
            const float mx = quad_max(fmaxf(fmaxf(s[0][2 * r], s[0][2 * r + 1]),
                                            fmaxf(s[1][2 * r], s[1][2 * r + 1])));
            const float m_new = fmaxf(m[r], mx);
            const float m_safe = m_new == -INFINITY ? 0.f : m_new;
            const float corr = __expf(m[r] - m_safe);  // 0 before the first key
            l[r] *= corr;
            dd[r] *= corr;
#pragma unroll
            for (int n = 0; n < 2; ++n) {
#pragma unroll
              for (int e = 2 * r; e < 2 * r + 2; ++e) {
                const float x = __expf(s[n][e] - m_safe);
                l[r] += x;
                dd[r] += x * dp[n][e];
              }
            }
            m[r] = m_new;
          }
        } else {
          float ds[2][4];  // dS * scale
#pragma unroll
          for (int n = 0; n < 2; ++n) {
#pragma unroll
            for (int e = 0; e < 4; ++e) {
              const int r = e >> 1;
              const float pr = __expf(s[n][e] - m[r]) * il[r];
              ds[n][e] = pr * (dp[n][e] - dd[r]) * p.scale;
            }
          }
          const uint32_t a[4] = {pack_bf16(ds[0][0], ds[0][1]), pack_bf16(ds[0][2], ds[0][3]),
                                 pack_bf16(ds[1][0], ds[1][1]), pack_bf16(ds[1][2], ds[1][3])};
#pragma unroll
          for (int n = 0; n < HD / 8; n += 2) {  // dQ += bf16(dS * scale) K
            uint32_t bt[4];
            load_b_trans<LD>(bt, sK, c * 16, n * 8, lane);
            mma_bf16(dq[n], a, bt[0], bt[1]);
            mma_bf16(dq[n + 1], a, bt[2], bt[3]);
          }
        }
      }
    }
    if (sweep == 0) {
      const size_t plane = size_t(gridDim.z) * p.heads * L;
      const size_t row0 = (size_t(b) * p.heads + h) * L;
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        l[r] = quad_sum(l[r]);
        il[r] = 1.f / l[r];
        dd[r] = quad_sum(dd[r]) * il[r];  // D = rowsum(P * dP)
        const int q = q0 + wr + g + 8 * r;
        if (t == 0 && q < L) {
          p.stats[row0 + q] = m[r];
          p.stats[plane + row0 + q] = l[r];
          p.stats[2 * plane + row0 + q] = dd[r];
        }
      }
    }
  }

  bf16* dst = static_cast<bf16*>(p.dqkv) + (long long)b * L * rs + h * HD;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int q = q0 + wr + g + 8 * r;
    if (q >= L) continue;
#pragma unroll
    for (int n = 0; n < HD / 8; ++n) {
      *reinterpret_cast<__nv_bfloat162*>(dst + q * rs + n * 8 + 2 * t) =
          __floats2bfloat162_rn(dq[n][2 * r], dq[n][2 * r + 1]);
    }
  }
}

// grid (ceil(L / 64), heads, B): dK and dV of 64 keys, and their sums of dS
template <int HD>
__global__ void __launch_bounds__(kThreads) dkv_kernel(const BwdParams p) {
  constexpr int LD = Smem<HD>::LD;
  extern __shared__ __align__(16) unsigned char smem[];
  bf16* sK = reinterpret_cast<bf16*>(smem);
  bf16* sV = sK + kTile * LD;
  bf16* sQ = sV + kTile * LD;
  bf16* sO = sQ + kTile * LD;  // dO rows
  float* sStat = reinterpret_cast<float*>(sO + kTile * LD);  // [3][64]: m, 1 / l, D

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const int k0 = blockIdx.x * kTile, h = blockIdx.y, b = blockIdx.z;
  const int L = p.L, C = p.C;
  const long long rs = 3LL * C;
  const bf16* qb = static_cast<const bf16*>(p.qkv) + (long long)b * L * rs + h * HD;
  const bf16* ob = static_cast<const bf16*>(p.dout) + (long long)b * L * C + h * HD;
  load_tile<HD, LD>(sK, qb + C, rs, k0, L);
  load_tile<HD, LD>(sV, qb + 2 * C, rs, k0, L);
  const int wr = warp * 16;
  const size_t plane = size_t(gridDim.z) * p.heads * L;
  const size_t row0 = (size_t(b) * p.heads + h) * L;

  float km[2];  // the mask of this thread's two keys; -inf past L (P = 0)
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int key = k0 + wr + g + 8 * r;
    km[r] = key < L ? p.kmask[key] : -INFINITY;
  }
  float cs[2] = {0.f, 0.f};
  float dk[HD / 8][4], dv[HD / 8][4];
#pragma unroll
  for (int n = 0; n < HD / 8; ++n) {
#pragma unroll
    for (int e = 0; e < 4; ++e) dk[n][e] = dv[n][e] = 0.f;
  }

  for (int q0 = 0; q0 < L; q0 += kTile) {
    __syncthreads();  // the last tile is consumed (and K, V stored)
    load_tile<HD, LD>(sQ, qb, rs, q0, L);
    load_tile<HD, LD>(sO, ob, C, q0, L);
    for (int j = threadIdx.x; j < kTile; j += kThreads) {
      const bool live = q0 + j < L;
      sStat[j] = live ? p.stats[row0 + q0 + j] : INFINITY;
      sStat[kTile + j] = live ? 1.f / p.stats[plane + row0 + q0 + j] : 0.f;
      sStat[2 * kTile + j] = live ? p.stats[2 * plane + row0 + q0 + j] : 0.f;
    }
    __syncthreads();
    const int chunks = min(4, (L - q0 + 15) / 16);
    for (int c = 0; c < chunks; ++c) {  // queries [q0 + 16c, q0 + 16c + 16)
      float st[2][4], dpt[2][4];  // S^T and dP^T: rows keys, columns queries
      rows_dot<HD, LD>(st, sK, wr, sQ, c * 16, g, t);
      rows_dot<HD, LD>(dpt, sV, wr, sO, c * 16, g, t);
      float pt[2][4], dsc[2][4];  // P^T and dS^T * scale
#pragma unroll
      for (int n = 0; n < 2; ++n) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int r = e >> 1;
          const int j = c * 16 + n * 8 + 2 * t + (e & 1);
          const float s = round_bf16(st[n][e]) * p.scale + km[r];
          const float pr = __expf(s - sStat[j]) * sStat[kTile + j];
          const float ds = pr * (round_bf16(dpt[n][e]) - sStat[2 * kTile + j]);
          cs[r] += ds;
          pt[n][e] = pr;
          dsc[n][e] = ds * p.scale;
        }
      }
      const uint32_t ap[4] = {pack_bf16(pt[0][0], pt[0][1]), pack_bf16(pt[0][2], pt[0][3]),
                              pack_bf16(pt[1][0], pt[1][1]), pack_bf16(pt[1][2], pt[1][3])};
      const uint32_t as[4] = {pack_bf16(dsc[0][0], dsc[0][1]), pack_bf16(dsc[0][2], dsc[0][3]),
                              pack_bf16(dsc[1][0], dsc[1][1]), pack_bf16(dsc[1][2], dsc[1][3])};
#pragma unroll
      for (int n = 0; n < HD / 8; n += 2) {
        uint32_t bt[4];
        load_b_trans<LD>(bt, sO, c * 16, n * 8, lane);  // dV += bf16(P)^T dO
        mma_bf16(dv[n], ap, bt[0], bt[1]);
        mma_bf16(dv[n + 1], ap, bt[2], bt[3]);
        load_b_trans<LD>(bt, sQ, c * 16, n * 8, lane);  // dK += bf16(dS * scale)^T Q
        mma_bf16(dk[n], as, bt[0], bt[1]);
        mma_bf16(dk[n + 1], as, bt[2], bt[3]);
      }
    }
  }

  bf16* dst = static_cast<bf16*>(p.dqkv) + (long long)b * L * rs + h * HD;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const float sum = quad_sum(cs[r]);
    const int key = k0 + wr + g + 8 * r;
    if (key >= L) continue;
    if (t == 0) p.colsum[row0 + key] = sum;
#pragma unroll
    for (int n = 0; n < HD / 8; ++n) {
      *reinterpret_cast<__nv_bfloat162*>(dst + key * rs + C + n * 8 + 2 * t) =
          __floats2bfloat162_rn(dk[n][2 * r], dk[n][2 * r + 1]);
      *reinterpret_cast<__nv_bfloat162*>(dst + key * rs + 2 * C + n * 8 + 2 * t) =
          __floats2bfloat162_rn(dv[n][2 * r], dv[n][2 * r + 1]);
    }
  }
}

// ---- f32 mode (CUDA cores) ----

constexpr int kRows = 16;      // rows a block owns: 4 a warp
constexpr int kRowsPerWarp = 4;
constexpr int kLanes = 32;     // keys (or queries) of a streamed tile, one a lane

__device__ __forceinline__ float warp_max(float x) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) x = fmaxf(x, __shfl_xor_sync(kFull, x, off));
  return x;
}

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) x += __shfl_xor_sync(kFull, x, off);
  return x;
}

template <int HD>
struct SmemF32 {
  static constexpr int KP = HD + 1;  // padded row of a streamed tile
  static constexpr size_t bytes =
      (2 * size_t(kRows) * HD + 2 * size_t(kLanes) * KP + 3 * kLanes) * sizeof(float);
};

// rows [row0, row0 + n) x HD columns of an f32 slab into a shared tile of row
// stride ld; rows at or past L become zeros
template <int HD>
__device__ __forceinline__ void load_rows_f32(float* dst, int ld, const float* base,
                                              long long rs, int row0, int n, int L) {
  for (int i = threadIdx.x; i < n * HD; i += kThreads) {
    const int r = i / HD, d = i % HD;
    dst[r * ld + d] = row0 + r < L ? base[(row0 + r) * rs + d] : 0.f;
  }
}

// grid (ceil(L / 16), heads, B)
template <int HD>
__global__ void __launch_bounds__(kThreads) dq_f32_kernel(const BwdParams p) {
  constexpr int kCols = (HD + 31) / 32, KP = SmemF32<HD>::KP;
  extern __shared__ float fs[];
  float* qs = fs;                 // [16][HD]
  float* os = qs + kRows * HD;    // [16][HD] dO rows
  float* ks = os + kRows * HD;    // [32][KP]
  float* vs = ks + kLanes * KP;   // [32][KP]

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int r0 = blockIdx.x * kRows, h = blockIdx.y, b = blockIdx.z;
  const int L = p.L, C = p.C;
  const long long rs = 3LL * C;
  const float* qb = static_cast<const float*>(p.qkv) + (long long)b * L * rs + h * HD;
  const float* ob = static_cast<const float*>(p.dout) + (long long)b * L * C + h * HD;
  load_rows_f32<HD>(qs, HD, qb, rs, r0, kRows, L);
  load_rows_f32<HD>(os, HD, ob, C, r0, kRows, L);

  float m[kRowsPerWarp], l[kRowsPerWarp], dd[kRowsPerWarp], dq[kRowsPerWarp][kCols];
#pragma unroll
  for (int r = 0; r < kRowsPerWarp; ++r) {
    m[r] = -INFINITY;
    l[r] = dd[r] = 0.f;
#pragma unroll
    for (int c = 0; c < kCols; ++c) dq[r][c] = 0.f;
  }
  for (int sweep = 0; sweep < 2; ++sweep) {
    for (int k0 = 0; k0 < L; k0 += kLanes) {
      __syncthreads();
      load_rows_f32<HD>(ks, KP, qb + C, rs, k0, kLanes, L);
      load_rows_f32<HD>(vs, KP, qb + 2 * C, rs, k0, kLanes, L);
      __syncthreads();
      const bool live = k0 + lane < L;
      const float add = live ? p.kmask[k0 + lane] : 0.f;
#pragma unroll
      for (int r = 0; r < kRowsPerWarp; ++r) {
        const float* q = qs + (warp * kRowsPerWarp + r) * HD;
        const float* o = os + (warp * kRowsPerWarp + r) * HD;
        float s = 0.f, dp = 0.f;
#pragma unroll 8
        for (int d = 0; d < HD; ++d) {
          s = fmaf(q[d], ks[lane * KP + d], s);
          dp = fmaf(o[d], vs[lane * KP + d], dp);
        }
        s = live ? s * p.scale + add : -INFINITY;
        if (sweep == 0) {
          const float m_new = fmaxf(m[r], warp_max(s));  // lane 0 is live
          const float alpha = expf(m[r] - m_new);        // 0 on the first tile
          const float x = expf(s - m_new);               // 0 past L
          l[r] = l[r] * alpha + warp_sum(x);
          dd[r] = dd[r] * alpha + warp_sum(x * dp);
          m[r] = m_new;
        } else {
          const float pr = expf(s - m[r]) / l[r];
          const float ds = pr * (dp - dd[r]) * p.scale;
          for (int j = 0; j < kLanes; ++j) {
            const float dsj = __shfl_sync(kFull, ds, j);
#pragma unroll
            for (int c = 0; c < kCols; ++c) {
              const int d = lane + 32 * c;
              if (d < HD) dq[r][c] = fmaf(dsj, ks[j * KP + d], dq[r][c]);
            }
          }
        }
      }
    }
    if (sweep == 0) {
      const size_t plane = size_t(gridDim.z) * p.heads * L;
      const size_t row0 = (size_t(b) * p.heads + h) * L;
#pragma unroll
      for (int r = 0; r < kRowsPerWarp; ++r) {
        dd[r] = dd[r] / l[r];  // D = rowsum(P * dP)
        const int q = r0 + warp * kRowsPerWarp + r;
        if (lane == 0 && q < L) {
          p.stats[row0 + q] = m[r];
          p.stats[plane + row0 + q] = l[r];
          p.stats[2 * plane + row0 + q] = dd[r];
        }
      }
    }
  }
  float* dst = static_cast<float*>(p.dqkv) + (long long)b * L * rs + h * HD;
#pragma unroll
  for (int r = 0; r < kRowsPerWarp; ++r) {
    const int q = r0 + warp * kRowsPerWarp + r;
    if (q >= L) continue;
#pragma unroll
    for (int c = 0; c < kCols; ++c) {
      const int d = lane + 32 * c;
      if (d < HD) dst[q * rs + d] = dq[r][c];
    }
  }
}

// grid (ceil(L / 16), heads, B)
template <int HD>
__global__ void __launch_bounds__(kThreads) dkv_f32_kernel(const BwdParams p) {
  constexpr int kCols = (HD + 31) / 32, KP = SmemF32<HD>::KP;
  extern __shared__ float fs[];
  float* kk = fs;                 // [16][HD] the block's keys
  float* vv = kk + kRows * HD;    // [16][HD]
  float* qs = vv + kRows * HD;    // [32][KP] a query tile
  float* os = qs + kLanes * KP;   // [32][KP] its dO rows
  float* st = os + kLanes * KP;   // [3][32]: m, l, D

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int r0 = blockIdx.x * kRows, h = blockIdx.y, b = blockIdx.z;
  const int L = p.L, C = p.C;
  const long long rs = 3LL * C;
  const float* qb = static_cast<const float*>(p.qkv) + (long long)b * L * rs + h * HD;
  const float* ob = static_cast<const float*>(p.dout) + (long long)b * L * C + h * HD;
  load_rows_f32<HD>(kk, HD, qb + C, rs, r0, kRows, L);
  load_rows_f32<HD>(vv, HD, qb + 2 * C, rs, r0, kRows, L);
  const size_t plane = size_t(gridDim.z) * p.heads * L;
  const size_t row0 = (size_t(b) * p.heads + h) * L;

  float km[kRowsPerWarp], cs[kRowsPerWarp], dk[kRowsPerWarp][kCols], dv[kRowsPerWarp][kCols];
#pragma unroll
  for (int r = 0; r < kRowsPerWarp; ++r) {
    const int key = r0 + warp * kRowsPerWarp + r;
    km[r] = key < L ? p.kmask[key] : -INFINITY;
    cs[r] = 0.f;
#pragma unroll
    for (int c = 0; c < kCols; ++c) dk[r][c] = dv[r][c] = 0.f;
  }
  for (int q0 = 0; q0 < L; q0 += kLanes) {
    __syncthreads();
    load_rows_f32<HD>(qs, KP, qb, rs, q0, kLanes, L);
    load_rows_f32<HD>(os, KP, ob, C, q0, kLanes, L);
    for (int j = threadIdx.x; j < kLanes; j += kThreads) {
      const bool in = q0 + j < L;
      st[j] = in ? p.stats[row0 + q0 + j] : INFINITY;
      st[kLanes + j] = in ? p.stats[plane + row0 + q0 + j] : 1.f;
      st[2 * kLanes + j] = in ? p.stats[2 * plane + row0 + q0 + j] : 0.f;
    }
    __syncthreads();
    const bool live = q0 + lane < L;
#pragma unroll
    for (int r = 0; r < kRowsPerWarp; ++r) {
      const float* k = kk + (warp * kRowsPerWarp + r) * HD;
      const float* v = vv + (warp * kRowsPerWarp + r) * HD;
      float s = 0.f, dp = 0.f;
#pragma unroll 8
      for (int d = 0; d < HD; ++d) {
        s = fmaf(qs[lane * KP + d], k[d], s);
        dp = fmaf(os[lane * KP + d], v[d], dp);
      }
      const float pr = live ? expf(s * p.scale + km[r] - st[lane]) / st[kLanes + lane] : 0.f;
      const float ds = pr * (dp - st[2 * kLanes + lane]);
      cs[r] += ds;
      const float dss = ds * p.scale;
      for (int j = 0; j < kLanes; ++j) {
        const float pj = __shfl_sync(kFull, pr, j);
        const float dsj = __shfl_sync(kFull, dss, j);
#pragma unroll
        for (int c = 0; c < kCols; ++c) {
          const int d = lane + 32 * c;
          if (d < HD) {
            dv[r][c] = fmaf(pj, os[j * KP + d], dv[r][c]);
            dk[r][c] = fmaf(dsj, qs[j * KP + d], dk[r][c]);
          }
        }
      }
    }
  }
  float* dst = static_cast<float*>(p.dqkv) + (long long)b * L * rs + h * HD;
#pragma unroll
  for (int r = 0; r < kRowsPerWarp; ++r) {
    const float sum = warp_sum(cs[r]);
    const int key = r0 + warp * kRowsPerWarp + r;
    if (key >= L) continue;
    if (lane == 0) p.colsum[row0 + key] = sum;
#pragma unroll
    for (int c = 0; c < kCols; ++c) {
      const int d = lane + 32 * c;
      if (d < HD) {
        dst[key * rs + C + d] = dk[r][c];
        dst[key * rs + 2 * C + d] = dv[r][c];
      }
    }
  }
}

// dkmask[j] = sum over the B * heads rows of colsum, in order.  Internal
// linkage: attn_bwd_wgmma.cuh's entry launches it from another source file.
static __global__ void __launch_bounds__(256)
colsum_kernel(const float* __restrict__ colsum, float* __restrict__ dkmask, int rows, int L) {
  const int j = blockIdx.x * blockDim.x + threadIdx.x;
  if (j >= L) return;
  float s = 0.f;
  for (int i = 0; i < rows; ++i) s += colsum[size_t(i) * L + j];
  dkmask[j] = s;
}

template <typename Kernel>
inline cudaError_t launch_one(Kernel kernel, dim3 grid, size_t bytes, const BwdParams& p,
                              cudaStream_t stream) {
  if (bytes > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, int(bytes));
    if (err != cudaSuccess) return err;
  }
  kernel<<<grid, kThreads, bytes, stream>>>(p);
  return cudaGetLastError();
}

template <int HD, bool kF32>
inline cudaError_t launch_hd(const BwdParams& p, int B, float* dkmask, cudaStream_t stream) {
  const int rows = kF32 ? kRows : kTile;
  const dim3 grid((p.L + rows - 1) / rows, p.heads, B);
  cudaError_t err;
  if constexpr (kF32) {
    err = launch_one(dq_f32_kernel<HD>, grid, SmemF32<HD>::bytes, p, stream);
    if (err == cudaSuccess) err = launch_one(dkv_f32_kernel<HD>, grid, SmemF32<HD>::bytes, p, stream);
  } else {
    err = launch_one(dq_kernel<HD>, grid, Smem<HD>::bytes, p, stream);
    if (err == cudaSuccess) err = launch_one(dkv_kernel<HD>, grid, Smem<HD>::bytes, p, stream);
  }
  if (err != cudaSuccess || dkmask == nullptr) return err;
  colsum_kernel<<<(p.L + 255) / 256, 256, 0, stream>>>(p.colsum, dkmask, B * p.heads, p.L);
  return cudaGetLastError();
}

// Every kernel of the backward for this head dimension and dtype, in order on
// one stream.
template <bool kF32>
inline cudaError_t launch(const BwdParams& p, int B, float* dkmask, cudaStream_t stream) {
  switch (p.C / p.heads) {
    case 16: return launch_hd<16, kF32>(p, B, dkmask, stream);
    case 32: return launch_hd<32, kF32>(p, B, dkmask, stream);
    case 64: return launch_hd<64, kF32>(p, B, dkmask, stream);
    case 128: return launch_hd<128, kF32>(p, B, dkmask, stream);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace oryon_attn_bwd
