// Streaming softmax attention at head dimension 64, designed for Hopper: the
// device code of the CLIP-tower attention kernels K1 (mha_lanes.cu, packed
// [B, L, 3C] rows with an additive key mask), K1-i8 (the same with logits
// from per-head int8 codes) and K5 (flash.cu, [B, H, L, D] rows with segment
// ids).  Every other head dimension stays on the WMMA kernel of
// attn_stream.cuh.
//
// What bounds the function on an H100: 4*L*L*64 FLOPs per (image, head)
// against 4*L*64*2 bytes, so the tensor cores, and beside them the L*L
// exponentials of the softmax on the special-function units.  What the
// design does about it:
//
//  * S, P and O live in registers.  One warpgroup (4 warps) owns 64 query
//    rows.  S = Q K^T is `wgmma.mma_async` m64n64k16 x 4 with Q and K read
//    from shared memory and the f32 sum in registers.  The online softmax
//    runs on those registers: a row's 64 values of a key tile sit in the four
//    lanes of a quad, so the row max and the row sum are two shuffles each.
//    P is rounded to bf16 in registers and is the A operand of the second
//    wgmma straight from registers (the f32 accumulator layout of m64nN,
//    packed in pairs, is the bf16 A layout of m64k16).  O (64 x 64 f32, 32
//    registers a thread) stays in registers for the whole key loop.  V is
//    the B operand read from its [keys, 64] tile as it lies (N contiguous:
//    the transposed-B bit, which 16-bit types allow).
//  * Loads overlap compute.  A producer warp copies the Q tile once and then
//    K and V tiles global -> shared with TMA (`cp.async.bulk.tensor`, one
//    thread issues a whole tile) into a ring of kStages stages; completion
//    is counted on `mbarrier`s (full: the tile's bytes have landed; empty:
//    every consumer warp has finished reading the stage).  TMA and not
//    cp.async because the tensor map's 128-byte swizzle is exactly what the
//    wgmma descriptors read (a [64, 64] bf16 tile has 128-byte rows; tile
//    bases are 1024-byte aligned), because its zero fill past row L replaces
//    the `row < L` test (a tile never reads the next image's rows), and
//    because it costs the consumers no registers or instructions.
//  * kConsumers warpgroups of one block share each K/V tile, which halves
//    the L2 -> shared-memory traffic per FLOP against one; the blocks of one
//    (image, head) are adjacent in launch order so K and V are re-read from
//    L2, not from device memory.
//
// Arithmetic (the reference's): exponentials are rounded to bf16 before the
// P V product and the row sum adds the rounded values; normalisation is
// deferred to the end; a row that has seen no live key yet keeps weights of
// exactly 0 (the running max is guarded against -inf - -inf).  The softmax
// uses exp2 with log2(e) folded into the logit scale (and into the additive
// mask), one FMA and one `ex2.approx` per logit; the difference from expf is
// below f32 rounding of the logit and far below the bf16 rounding of P.
// Rows at or past L are never written; the output tile is staged through
// shared memory (swizzled, conflict-free) and written with 16-byte stores.
//
// K1-i8 (mode kKeyMaskI8) differs in the first product only.  A pre-pass
// (mha_lanes.cu) has left the int8 codes of q * scale and k in a [B, L, 2C]
// scratch and the per-(image, head) absmax beside it, so a tile is quantised
// once a call and not once a query-tile block.  Q and K tiles are [64, 64]
// int8 with 64-byte rows: their tensor map takes the 64-byte swizzle and the
// descriptors its form (8-row groups 512 bytes apart); S = Q K^T is
// `wgmma` m64n64k32.s32.s8.s8 x 2 a key tile at twice the bf16 rate, a K tile
// is 4 KB instead of 8.  The s32 sums have the f32 accumulator's layout; they
// reach the softmax as floats without a conversion instruction (see
// kMagicBits), descaled by qm * km / 127^2 in the FMA that applies the mask.
// P V, the ring, the barriers and the output are the bf16 kernel's.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "hopper.cuh"

namespace oryon_attn_wg {

using namespace oryon_hopper;

enum Mode {
  kKeyMask = 0,    // logit = acc * scale + kmask[key]
  kSegments = 1,   // logit = acc * scale where seg[query] == seg[key], else masked
  kKeyMaskI8 = 2,  // logit = int32 acc * (qm * km / 127^2) + kmask[key]
};

constexpr int kHD = 64;              // head dimension this kernel takes
constexpr int kTileBytes = 64 * 128; // one [64 rows, 64 bf16] tile, 128-byte rows
constexpr float kLog2e = 1.4426950408889634f;

// An int32 sum n with |n| < 2^22 (here at most 64 * 127^2 < 2^20) added to
// the bits of 1.5 * 2^23 is the float 12582912 + n, exactly: the int8 logits
// become floats with one integer add, and the constant leaves with the mask
// term of the softmax's FMA (aux = kmask * log2e - kMagic * logit_mul).  The
// FMA rounds once, after the exact product and sum, so nothing cancels; the
// rounding of the constant itself is one shift of every live logit of an
// (image, head), which a softmax does not see.
constexpr int kMagicBits = 0x4B400000;
constexpr float kMagic = 12582912.f;

// Rows q0.. of q, k, v come through tensor maps over [planes, rows, cols]:
// column = col + h * hcol, plane = b * zb + h * zh.
struct Params {
  __nv_bfloat16* out;
  long long ob, oh, orow;  // out element (b, h, row, d) at b*ob + h*oh + row*orow + d
  const float* kmask;      // [L] additive f32 (kKeyMask, kKeyMaskI8)
  const int* seg;          // [B, L] segment ids or null = one segment (kSegments)
  const float* absmax;     // [B, heads, 2]: max|q * scale|, max|k| (kKeyMaskI8)
  int L;
  int heads;
  float scale_log2;        // logit scale * log2(e) (not kKeyMaskI8)
  int col_k, col_v;        // first column of k and of v (q starts at column 0)
  int hcol;                // columns per head step (64 packed, 0 split)
  int zb, zh;              // plane coordinate of (b, h)
};

// ---------------------------------------------------------------- PTX pieces

__device__ __forceinline__ float fast_exp2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;  // ex2(-inf) = +0
}

// Keeps the compiler from moving uses of accumulator registers across the
// asynchronous products.
__device__ __forceinline__ void fence_regs(float (&r)[32]) {
#pragma unroll
  for (int i = 0; i < 32; ++i) asm volatile("" : "+f"(r[i])::"memory");
}
__device__ __forceinline__ void fence_regs(int (&r)[32]) {
#pragma unroll
  for (int i = 0; i < 32; ++i) asm volatile("" : "+r"(r[i])::"memory");
}

#define ORYON_ACC32(d)                                                         \
  "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),      \
      "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), \
      "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]),         \
      "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]),         \
      "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]), "+f"(d[26]),         \
      "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])

#define ORYON_ACC32_INT(d)                                                     \
  "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]), "+r"(d[5]),      \
      "+r"(d[6]), "+r"(d[7]), "+r"(d[8]), "+r"(d[9]), "+r"(d[10]), "+r"(d[11]), \
      "+r"(d[12]), "+r"(d[13]), "+r"(d[14]), "+r"(d[15]), "+r"(d[16]),         \
      "+r"(d[17]), "+r"(d[18]), "+r"(d[19]), "+r"(d[20]), "+r"(d[21]),         \
      "+r"(d[22]), "+r"(d[23]), "+r"(d[24]), "+r"(d[25]), "+r"(d[26]),         \
      "+r"(d[27]), "+r"(d[28]), "+r"(d[29]), "+r"(d[30]), "+r"(d[31])

#define ORYON_ACC32_LIST                                                       \
  "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "    \
  "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, "     \
  "%30, %31}"

// D[64, 64] (+)= A[64, 16] . B[16, 64]^T-as-stored: A and B K-major in shared
// memory (B is the [64 keys, 16] slice of a K tile), f32 sum in registers.
// scale_d = 0 overwrites D.
__device__ __forceinline__ void wgmma_ss(float (&d)[32], uint64_t desc_a,
                                         uint64_t desc_b, int scale_d) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 " ORYON_ACC32_LIST
      ", %32, %33, p, 1, 1, 0, 0;\n"
      "}\n"
      : ORYON_ACC32(d)
      : "l"(desc_a), "l"(desc_b), "r"(scale_d));
}

// The same for int8 codes: D[64, 64] (+)= A[64, 32] . B[32, 64]^T-as-stored,
// both K-major in shared memory (the only layout 8-bit operands have), int32
// sums in registers laid out as the f32 ones.
__device__ __forceinline__ void wgmma_ss_i8(int (&d)[32], uint64_t desc_a,
                                            uint64_t desc_b, int scale_d) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k32.s32.s8.s8 " ORYON_ACC32_LIST
      ", %32, %33, p;\n"
      "}\n"
      : ORYON_ACC32_INT(d)
      : "l"(desc_a), "l"(desc_b), "r"(scale_d));
}

// D[64, 64] += A[64, 16] . B[16, 64]: A from registers (four packed bf16
// pairs a thread), B MN-major in shared memory (the transposed-B bit set).
__device__ __forceinline__ void wgmma_rs_tb(float (&d)[32], uint32_t a0,
                                            uint32_t a1, uint32_t a2, uint32_t a3,
                                            uint64_t desc_b) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 " ORYON_ACC32_LIST
      ", {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n"
      "}\n"
      : ORYON_ACC32(d)
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "l"(desc_b), "r"(1));
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);  // .x in the low half
  return *reinterpret_cast<const uint32_t*>(&v);
}

// The online softmax of one key tile on the accumulator registers of S: takes
// the logits to log2 units (scale and mask; kKeyMaskI8 goes the way of
// kKeyMask, with the descale as its scale), updates the running row max and
// row sum of this thread's two rows, and leaves P = exp2(S - m) rounded to
// bf16 and packed as the A fragments of the P V product.  corr[r] is what O's
// row r must be multiplied by before this tile's P V is added.
template <int MODE, int kGroups>
__device__ __forceinline__ void softmax_tile(float (&s)[kGroups][32],
                                             const unsigned char* aux, int lim,
                                             const int (&qseg)[2], float scale_log2,
                                             int c2, float (&m_run)[2],
                                             float (&l_run)[2],
                                             uint32_t (&pk)[kGroups][16],
                                             float (&corr)[2]) {
  float tmax[2] = {-INFINITY, -INFINITY};
#pragma unroll
  for (int g = 0; g < kGroups; ++g) {
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int col = g * 64 + j * 8;  // + c2 + {0, 1}
      if constexpr (MODE == kSegments) {
        const int2 sg = *reinterpret_cast<const int2*>(aux + (col + c2) * 4);
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int key_seg = (e & 1) ? sg.y : sg.x;
          const bool live = (key_seg == qseg[e >> 1]) && (col + (e & 1) < lim);
          s[g][4 * j + e] = live ? s[g][4 * j + e] * scale_log2 : -INFINITY;
        }
      } else {
        const float2 mk = *reinterpret_cast<const float2*>(aux + (col + c2) * 4);
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          s[g][4 * j + e] = fmaf(s[g][4 * j + e], scale_log2, (e & 1) ? mk.y : mk.x);
        }
      }
      tmax[0] = fmaxf(tmax[0], fmaxf(s[g][4 * j + 0], s[g][4 * j + 1]));
      tmax[1] = fmaxf(tmax[1], fmaxf(s[g][4 * j + 2], s[g][4 * j + 3]));
    }
  }
  float m_safe[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    tmax[r] = fmaxf(tmax[r], __shfl_xor_sync(0xffffffffu, tmax[r], 1));
    tmax[r] = fmaxf(tmax[r], __shfl_xor_sync(0xffffffffu, tmax[r], 2));
    const float m_new = fmaxf(m_run[r], tmax[r]);
    // a row that has seen no unmasked key yet keeps weights of exactly 0
    m_safe[r] = (m_new == -INFINITY) ? 0.f : m_new;
    corr[r] = fast_exp2(m_run[r] - m_safe[r]);  // 0 until the first live key
    m_run[r] = m_new;
  }
  // the row sums add the rounded values
  float psum[2] = {0.f, 0.f};
#pragma unroll
  for (int g = 0; g < kGroups; ++g) {
#pragma unroll
    for (int j = 0; j < 8; ++j) {
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const uint32_t pr = pack_bf16(fast_exp2(s[g][4 * j + 2 * r] - m_safe[r]),
                                      fast_exp2(s[g][4 * j + 2 * r + 1] - m_safe[r]));
        pk[g][2 * j + r] = pr;
        psum[r] += __uint_as_float(pr << 16) + __uint_as_float(pr & 0xffff0000u);
      }
    }
  }
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    psum[r] += __shfl_xor_sync(0xffffffffu, psum[r], 1);
    psum[r] += __shfl_xor_sync(0xffffffffu, psum[r], 2);
    l_run[r] = l_run[r] * corr[r] + psum[r];
  }
}

__device__ __forceinline__ void scale_rows(float (&o)[32], const float (&corr)[2]) {
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    o[4 * j + 0] *= corr[0];
    o[4 * j + 1] *= corr[0];
    o[4 * j + 2] *= corr[1];
    o[4 * j + 3] *= corr[1];
  }
}

// S[64, kBK] = Q[64, 64] . K^T, issued and not waited for.
template <int kGroups>
__device__ __forceinline__ void issue_qk(float (&s)[kGroups][32], uint64_t q_desc,
                                         uint64_t k_desc) {
#pragma unroll
  for (int g = 0; g < kGroups; ++g) {
#pragma unroll
    for (int kk = 0; kk < kHD / 16; ++kk) {
      wgmma_ss(s[g], q_desc + 2 * kk, k_desc + g * (kTileBytes >> 4) + 2 * kk, kk > 0);
    }
  }
}

// The same from int8 tiles (64-byte rows: a 64-key group is 4 KB, a k32 step
// 32 bytes), as int32 sums.
template <int kGroups>
__device__ __forceinline__ void issue_qk_i8(int (&s)[kGroups][32], uint64_t q_desc,
                                            uint64_t k_desc) {
#pragma unroll
  for (int g = 0; g < kGroups; ++g) {
#pragma unroll
    for (int kk = 0; kk < kHD / 32; ++kk) {
      wgmma_ss_i8(s[g], q_desc + 2 * kk, k_desc + g * ((64 * 64) >> 4) + 2 * kk, kk > 0);
    }
  }
}

// O[64, 64] += P[64, kBK] . V[kBK, 64], issued and not waited for.
template <int kGroups>
__device__ __forceinline__ void issue_pv(float (&o)[32],
                                         const uint32_t (&pk)[kGroups][16],
                                         uint64_t v_desc) {
#pragma unroll
  for (int g = 0; g < kGroups; ++g) {
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      wgmma_rs_tb(o, pk[g][4 * kk + 0], pk[g][4 * kk + 1], pk[g][4 * kk + 2],
                  pk[g][4 * kk + 3], v_desc + (g * 4 + kk) * (2048 >> 4));
    }
  }
}

template <typename T, int kGroups>
__device__ __forceinline__ void fence_regs(T (&s)[kGroups][32]) {
#pragma unroll
  for (int g = 0; g < kGroups; ++g) fence_regs(s[g]);
}

// Keeps the A fragments alive (and where they are) until the product that
// reads them has been waited for.
template <int kGroups>
__device__ __forceinline__ void fence_regs(uint32_t (&pk)[kGroups][16]) {
#pragma unroll
  for (int g = 0; g < kGroups; ++g) {
#pragma unroll
    for (int i = 0; i < 16; ++i) asm volatile("" : "+r"(pk[g][i])::"memory");
  }
}

// ------------------------------------------------------------------- kernel

// Shared memory, from a 1024-byte aligned base: the Q tiles (one a consumer
// warpgroup; later the staging of its output tile), the ring of K and V
// tiles, per stage the keys' mask values or segment ids, the barriers.  Q and
// K rows are 128 bytes of bf16 or 64 bytes of int8 codes; a Q tile keeps its
// 8 KB either way, for the output.
template <int MODE, int kConsumers, int kBK, int kStages>
struct Smem {
  static constexpr int qk_row_bytes = (MODE == kKeyMaskI8) ? 64 : 128;
  static constexpr int qk_box_bytes = 64 * qk_row_bytes;  // one TMA box of q or k
  static constexpr int q_off = 0;
  static constexpr int kv_off = kConsumers * kTileBytes;
  static constexpr int k_bytes = kBK * qk_row_bytes;
  static constexpr int stage_bytes = k_bytes + kBK * 128;
  static constexpr int aux_off = kv_off + kStages * stage_bytes;
  static constexpr int bar_off = aux_off + kStages * kBK * 4;
  static constexpr int bytes = bar_off + (2 * kStages + 1) * 8;
  static constexpr int alloc = bytes + 1024;  // room to align the base
};

template <int MODE, int kConsumers, int kBK, int kStages, int kMinBlocks>
__global__ void __launch_bounds__(kConsumers * 128 + 32, kMinBlocks)
attn_wgmma_kernel(const __grid_constant__ CUtensorMap map_q,
                  const __grid_constant__ CUtensorMap map_k,
                  const __grid_constant__ CUtensorMap map_v, const Params p) {
  using Lay = Smem<MODE, kConsumers, kBK, kStages>;
  static_assert(kBK % 64 == 0, "a key tile is whole 64-row boxes");
  constexpr int kGroups = kBK / 64;  // 64-key groups of a tile
  constexpr int kBQ = kConsumers * 64;

  extern __shared__ unsigned char smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t base = (raw + 1023u) & ~1023u;
  unsigned char* gbase = smem_raw + (base - raw);
  const uint32_t bar_full = base + Lay::bar_off;           // [kStages]
  const uint32_t bar_empty = bar_full + kStages * 8;       // [kStages]
  const uint32_t bar_q = bar_empty + kStages * 8;

  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int q0 = blockIdx.x * kBQ;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int L = p.L;
  const int n_tiles = (L + kBK - 1) / kBK;
  const int plane = b * p.zb + h * p.zh;
  const int col_q = h * p.hcol;
  float logit_mul = p.scale_log2;  // what the tensor-core sum is multiplied by
  if constexpr (MODE == kKeyMaskI8) {
    const float qm = p.absmax[(size_t(b) * p.heads + h) * 2];
    const float km = p.absmax[(size_t(b) * p.heads + h) * 2 + 1];
    logit_mul = (qm * km) / (127.0f * 127.0f) * kLog2e;
  }

  if (threadIdx.x == 0) {
    for (int s = 0; s < kStages; ++s) {
      mbar_init(bar_full + s * 8, 1);                // the producer's one arrive
      mbar_init(bar_empty + s * 8, kConsumers * 4);  // one arrive a consumer warp
    }
    mbar_init(bar_q, 1);
    mbar_init_fence();
  }
  __syncthreads();

  if (warp == kConsumers * 4) {
    // ------------------------------------------------------ producer warp
    if (lane == 0) {
      mbar_arrive_expect_tx(bar_q, kConsumers * Lay::qk_box_bytes);
      for (int w = 0; w < kConsumers; ++w) {
        tma_load_tile(base + Lay::q_off + w * kTileBytes, &map_q, bar_q, col_q,
                      q0 + w * 64, plane);
      }
    }
    for (int it = 0; it < n_tiles; ++it) {
      const int stage = it % kStages;
      const uint32_t round = it / kStages;
      mbar_wait(bar_empty + stage * 8, (round & 1u) ^ 1u);  // free at first
      const int k0 = it * kBK;
      for (int j = lane; j < kBK; j += 32) {
        const int key = k0 + j;
        if constexpr (MODE == kSegments) {
          reinterpret_cast<int*>(gbase + Lay::aux_off)[stage * kBK + j] =
              (p.seg != nullptr && key < L) ? p.seg[size_t(b) * L + key] : 1;
        } else if constexpr (MODE == kKeyMaskI8) {
          // the mask, less what kMagicBits added to the sum
          reinterpret_cast<float*>(gbase + Lay::aux_off)[stage * kBK + j] =
              (key < L) ? fmaf(p.kmask[key], kLog2e, -kMagic * logit_mul) : -INFINITY;
        } else {
          reinterpret_cast<float*>(gbase + Lay::aux_off)[stage * kBK + j] =
              (key < L) ? p.kmask[key] * kLog2e : -INFINITY;
        }
      }
      __syncwarp();  // the arrive below publishes every lane's values
      if (lane == 0) {
        const uint32_t full = bar_full + stage * 8;
        const uint32_t kdst = base + Lay::kv_off + stage * Lay::stage_bytes;
        const uint32_t vdst = kdst + Lay::k_bytes;
        mbar_arrive_expect_tx(full, Lay::stage_bytes);
        for (int g = 0; g < kGroups; ++g) {
          tma_load_tile(kdst + g * Lay::qk_box_bytes, &map_k, full, p.col_k + col_q,
                        k0 + g * 64, plane);
          tma_load_tile(vdst + g * kTileBytes, &map_v, full, p.col_v + col_q,
                        k0 + g * 64, plane);
        }
      }
    }
    return;
  }

  // ------------------------------------------------- consumer warpgroups
  const int wg = warp / 4;
  const int tid = threadIdx.x % 128;
  const int quad_row = (warp % 4) * 16 + lane / 4;  // this thread's rows:
  const int c2 = (lane % 4) * 2;                    // quad_row and quad_row + 8
  const int tile_q0 = q0 + wg * 64;

  int qseg[2] = {1, 1};
  if constexpr (MODE == kSegments) {
    if (p.seg != nullptr) {
      qseg[0] = p.seg[size_t(b) * L + min(tile_q0 + quad_row, L - 1)];
      qseg[1] = p.seg[size_t(b) * L + min(tile_q0 + quad_row + 8, L - 1)];
    }
  }

  float o[32];
#pragma unroll
  for (int i = 0; i < 32; ++i) o[i] = 0.f;
  float m_run[2] = {-INFINITY, -INFINITY};  // running max (log2 units)
  float l_run[2] = {0.f, 0.f};              // running sum of rounded weights

  const uint32_t q_smem = base + Lay::q_off + wg * kTileBytes;
  constexpr int kQKSwizzle = (MODE == kKeyMaskI8) ? kSwizzle64 : kSwizzle128;
  const uint64_t q_desc = make_desc<kQKSwizzle>(q_smem);
  mbar_wait(bar_q, 0);

  const auto k_desc_of = [&](int stage) {
    return make_desc<kQKSwizzle>(base + Lay::kv_off + stage * Lay::stage_bytes);
  };
  const auto v_desc_of = [&](int stage) {
    return make_desc<kSwizzle128>(base + Lay::kv_off + stage * Lay::stage_bytes +
                                  Lay::k_bytes);
  };
  const auto aux_of = [&](int stage) {
    return gbase + Lay::aux_off + stage * kBK * 4;
  };

  float s[kGroups][32];
  uint32_t pk[kGroups][16];
  float corr[2];
  // one tile after the other: S, softmax, P V.  The tensor cores stay busy
  // with the other warpgroups of the SM meanwhile (four are resident).
  for (int it = 0; it < n_tiles; ++it) {
    const int stage = it % kStages;
    mbar_wait(bar_full + stage * 8, (it / kStages) & 1u);
    if constexpr (MODE == kKeyMaskI8) {
      int si[kGroups][32];
      fence_regs(si);
      wgmma_fence();
      issue_qk_i8<kGroups>(si, q_desc, k_desc_of(stage));
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs(si);
#pragma unroll
      for (int g = 0; g < kGroups; ++g) {
#pragma unroll
        for (int i = 0; i < 32; ++i) s[g][i] = __int_as_float(si[g][i] + kMagicBits);
      }
    } else {
      fence_regs(s);
      wgmma_fence();
      issue_qk<kGroups>(s, q_desc, k_desc_of(stage));
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs(s);
    }
    softmax_tile<MODE, kGroups>(s, aux_of(stage), L - it * kBK - c2, qseg,
                                logit_mul, c2, m_run, l_run, pk, corr);
    scale_rows(o, corr);
    fence_regs(o);
    wgmma_fence();
    issue_pv<kGroups>(o, pk, v_desc_of(stage));
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(o);
    fence_regs(pk);
    __syncwarp();
    if (lane == 0) mbar_arrive(bar_empty + stage * 8);  // the stage may be refilled
  }

  // Normalise, stage the [64, 64] bf16 tile in this warpgroup's Q tile (every
  // warp of the group has finished reading Q once the barrier passes), then
  // write rows below L with 16-byte stores, 8 threads a row.
  const float inv[2] = {1.f / l_run[0], 1.f / l_run[1]};
  unsigned char* stage_out = gbase + Lay::q_off + wg * kTileBytes;
  named_barrier_sync(1 + wg, 128);
#pragma unroll
  for (int j = 0; j < 8; ++j) {
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int row = quad_row + 8 * r;
      *reinterpret_cast<uint32_t*>(stage_out + row * 128 + ((j ^ (row & 7)) << 4) +
                                   c2 * 2) =
          pack_bf16(o[4 * j + 2 * r] * inv[r], o[4 * j + 2 * r + 1] * inv[r]);
    }
  }
  named_barrier_sync(1 + wg, 128);
  __nv_bfloat16* out_base = p.out + b * p.ob + h * p.oh;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int idx = tid + i * 128;
    const int row = idx / 8;
    const int chunk = idx % 8;
    const int grow = tile_q0 + row;
    if (grow < L) {
      const uint4 val = *reinterpret_cast<const uint4*>(
          stage_out + row * 128 + ((chunk ^ (row & 7)) << 4));
      *reinterpret_cast<uint4*>(out_base + grow * p.orow + chunk * 8) = val;
    }
  }
}

// --------------------------------------------------------------- host side

template <int MODE, int kConsumers, int kBK, int kStages, int kMinBlocks>
cudaError_t launch_config(const CUtensorMap& mq, const CUtensorMap& mk,
                          const CUtensorMap& mv, const Params& p, int B,
                          cudaStream_t stream) {
  using Lay = Smem<MODE, kConsumers, kBK, kStages>;
  auto kernel = attn_wgmma_kernel<MODE, kConsumers, kBK, kStages, kMinBlocks>;
  static bool configured = false;
  if (!configured) {
    cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, Lay::alloc);
    if (err != cudaSuccess) return err;
    configured = true;
  }
  dim3 grid((p.L + kConsumers * 64 - 1) / (kConsumers * 64), p.heads, B);
  kernel<<<grid, kConsumers * 128 + 32, Lay::alloc, stream>>>(mq, mk, mv, p);
  return cudaGetLastError();
}

// The defaults below are the configuration the measurements chose (PERF.md;
// tools/attn_tile_sweep.py times the others): consumer warpgroups a block (64
// query rows each), keys a tile, ring stages, resident blocks asked of the
// compiler.

// K1: qkv [B, L, 3C] bf16 with C = heads * 64, kmask [L] f32, out [B, L, C].
// One map serves q, k and v (columns h*64, C + h*64, 2C + h*64).
template <int kConsumers = 2, int kBK = 64, int kStages = 4, int kMinBlocks = 2>
cudaError_t launch_packed(const void* qkv, const void* kmask, void* out,
                                 int B, int L, int C, int heads, float scale,
                                 cudaStream_t stream) {
  CUtensorMap map;
  cudaError_t err = encode_map(&map, qkv, 2, 3ull * C, L, B, 6ull * C,
                               6ull * C * uint64_t(L), 64, 64);
  if (err != cudaSuccess) return err;
  Params p{};
  p.out = static_cast<__nv_bfloat16*>(out);
  p.ob = (long long)L * C;
  p.oh = kHD;
  p.orow = C;
  p.kmask = static_cast<const float*>(kmask);
  p.L = L;
  p.heads = heads;
  p.scale_log2 = scale * kLog2e;
  p.col_k = C;
  p.col_v = 2 * C;
  p.hcol = kHD;
  p.zb = 1;
  p.zh = 0;
  return launch_config<kKeyMask, kConsumers, kBK, kStages, kMinBlocks>(
      map, map, map, p, B, stream);
}

// K1-i8: the same with the logits from int8 codes.  codes [B, L, 2C] int8
// (q * scale | k, as the first two thirds of a qkv row) and absmax
// [B, heads, 2] f32 come from the pre-pass; v is read from qkv.  One map over
// the codes serves q and k (64-byte swizzle), one over qkv serves v.
template <int kConsumers = 2, int kBK = 64, int kStages = 4, int kMinBlocks = 2>
cudaError_t launch_packed_i8(const void* qkv, const void* codes,
                             const void* absmax, const void* kmask, void* out,
                             int B, int L, int C, int heads,
                             cudaStream_t stream) {
  CUtensorMap map_v, map_c;
  cudaError_t err = encode_map(&map_v, qkv, 2, 3ull * C, L, B, 6ull * C,
                               6ull * C * uint64_t(L), 64, 64);
  if (err != cudaSuccess) return err;
  err = encode_map(&map_c, codes, 1, 2ull * C, L, B, 2ull * C,
                   2ull * C * uint64_t(L), 64, 64);
  if (err != cudaSuccess) return err;
  Params p{};
  p.out = static_cast<__nv_bfloat16*>(out);
  p.ob = (long long)L * C;
  p.oh = kHD;
  p.orow = C;
  p.kmask = static_cast<const float*>(kmask);
  p.absmax = static_cast<const float*>(absmax);
  p.L = L;
  p.heads = heads;
  p.col_k = C;
  p.col_v = 2 * C;
  p.hcol = kHD;
  p.zb = 1;
  p.zh = 0;
  return launch_config<kKeyMaskI8, kConsumers, kBK, kStages, kMinBlocks>(
      map_c, map_c, map_v, p, B, stream);
}

// K5: q, k, v, out [B, H, L, 64] bf16, seg [B, L] int32 or null.  A map each
// over [B*H, L, 64].
template <int kConsumers = 2, int kBK = 64, int kStages = 4, int kMinBlocks = 2>
cudaError_t launch_split(const void* q, const void* k, const void* v,
                                const void* seg, void* out, int B, int H, int L,
                                float sm_scale, cudaStream_t stream) {
  CUtensorMap maps[3];
  const void* bases[3] = {q, k, v};
  for (int i = 0; i < 3; ++i) {
    cudaError_t err = encode_map(&maps[i], bases[i], 2, kHD, L, uint64_t(B) * H,
                                 kHD * 2, uint64_t(L) * kHD * 2, 64, 64);
    if (err != cudaSuccess) return err;
  }
  Params p{};
  p.out = static_cast<__nv_bfloat16*>(out);
  p.ob = (long long)H * L * kHD;
  p.oh = (long long)L * kHD;
  p.orow = kHD;
  p.seg = static_cast<const int*>(seg);
  p.L = L;
  p.heads = H;
  p.scale_log2 = sm_scale * kLog2e;
  p.hcol = 0;
  p.zb = H;
  p.zh = 1;
  return launch_config<kSegments, kConsumers, kBK, kStages, kMinBlocks>(
      maps[0], maps[1], maps[2], p, B, stream);
}

}  // namespace oryon_attn_wg
