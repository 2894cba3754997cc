// Masked cosine argmin with bf16-rounded inputs (K2 in its serving mode,
// precision "bf16"), designed for Hopper.  The f32 mode (match_tf32.cuh) is
// built on the same pre-pass, reduction and merge, with each f32 product
// taken as three TF32 products.
//
// What bounds the function on an H100: 2 * 32 FLOPs per (source, kept target)
// against 128 bytes per target read once, so the tensor cores; and once the
// products are on them, the running (min, argmin) over every product, which
// stays on the CUDA cores.  What the design does about it:
//
//  * A pre-pass compacts.  `compact_targets_kernel` keeps only the targets of
//    each pair that are not excluded, in index order, rounded to bf16, with an
//    int32 map back to the original index and a per-pair count.  The mask
//    leaves the inner loop and the excluded share leaves the work (in serving
//    everything outside the predicted object mask is excluded).  Each block
//    owns 256 targets: it counts the kept targets before its chunk from the
//    flags themselves (at most N bytes, from L2), so the pass is one launch
//    with no dependency between blocks.  The main kernel reads the counts
//    from device memory: no host synchronisation between the two launches.
//  * The products run on the tensor cores.  One warpgroup owns 64 source rows
//    of one pair.  Its [64, 32] source tile is read from the f32 input,
//    rounded to bf16 and kept in registers as the A operand for the whole
//    loop (two k16 steps).  B is a [128, 32] bf16 tile of compacted targets,
//    K-major with 64-byte rows, loaded by TMA with the 64-byte swizzle into a
//    ring of stages by a producer warp; `wgmma` m64n128k16 x 2 leaves the 64 x
//    128 f32 sums in registers.  Products of two bf16 values are exact in
//    f32; the tensor core adds them in another order than a matmul would,
//    which shows only at near-ties.  The warpgroups of a block share each
//    target tile, and the blocks of a pair are adjacent in launch order.
//  * The reduction is about one instruction a product.  The distance
//    0.5 * (1 - sum) falls as the sum grows, so the kernel tracks the maximum
//    of the sum and forms the distance once a row, at the end: the minimum is
//    the plain version's.  A tile costs a thread one `fmaxf` a register and
//    the four lanes that share a row two shuffles; only where a row's tile
//    maximum beats its running best (strict `>`, so an earlier tile keeps a
//    tie) do the lanes that hold it scan their registers for the first column
//    that does, and take the lowest among them.  A thread's columns of a row
//    come in increasing index and compaction preserves order: exact ties go
//    to the lowest original index, as in the plain version.  Deciding by row
//    and not by thread matters because a warp enters the scan when any of its
//    rows improves: 16 rows a warp improve in far fewer tiles than 64
//    per-thread column sets would.  The stage is released as soon as the
//    products are waited for, before the reduction.
//  * What it reaches (PERF.md has the numbers): alone on the card the
//    products take the tensor cores' time and the maxima the time of 64
//    half-rate `fmaxf` a thread a tile, about as long; together they take
//    the sum, whether the overlap is left to the four resident warpgroups of
//    an SM (kSets = 1, the library's) or written out with two accumulator
//    sets (kSets = 2: the next tile's products in flight under this tile's
//    maxima, which tools/match_tile_sweep.py still times).  With 32 values a
//    product each `wgmma` rewrites its whole accumulator for 16 of them, and
//    the register file seems to have no room left for the CUDA cores
//    meanwhile.
//  * The targets of a pair are split.  8 pairs x 40 blocks of 128 source rows
//    are 320 blocks for 264 resident ones, a second wave a fifth full; so a
//    block takes one of `splits` ranges of its pair's tiles and leaves its
//    rows' (best sum, position) in a scratch, and a small last kernel merges
//    the ranges in order (strict `>` again), forms the distance and maps the
//    position to the original index.  The caller chooses `splits` from the
//    shapes and the number of SMs (match_kernel.py: target_splits); the merge
//    is deterministic.
//  * The last tile of a pair is the only one that bounds its columns (the
//    scratch past the count is not initialised).  A pair with no kept target
//    runs no tile and returns (+inf, 0).

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "hopper.cuh"

namespace oryon_match_wg {

using namespace oryon_hopper;

constexpr int kD = 32;                 // feature width (decoder out_channels)
constexpr int kBN = 128;               // targets a tile
constexpr int kTileBytes = kBN * kD * 2;  // 64-byte rows
constexpr int kChunk = 256;            // targets a block of the pre-pass

// --------------------------------------------------------------- the pre-pass

// Zero bytes among the four of a word.
__device__ __forceinline__ int zero_bytes(uint32_t w) {
  const uint32_t nz = (((w & 0x7f7f7f7fu) + 0x7f7f7f7fu) | w) & 0x80808080u;
  return 4 - __popc(nz);
}

// x rounded to TF32 (10 bits of mantissa; to nearest, ties away from zero, as
// cvt.rna.tf32.f32 rounds) by integer operations on its bits, so that the low
// 13 bits are zero and the tensor core's truncation of them never decides a
// result; match_kernel.py's split_tf32_plain is the same arithmetic.
__device__ __forceinline__ float round_tf32(float x) {
  return __uint_as_float((__float_as_uint(x) + 0x1000u) & 0xffffe000u);
}

// x = hi + lo to about 2^-22 |x|: hi = tf32(x), lo = tf32(x - hi) (the
// difference is exact in f32).
__device__ __forceinline__ void split_tf32(float4 v, float4& hi, float4& lo) {
  hi = make_float4(round_tf32(v.x), round_tf32(v.y), round_tf32(v.z), round_tf32(v.w));
  lo = make_float4(round_tf32(v.x - hi.x), round_tf32(v.y - hi.y), round_tf32(v.z - hi.z),
                   round_tf32(v.w - hi.w));
}

// tgt [P, N, 32] f32, bad [P, N] bytes (nonzero = excluded) -> the kept rows
// of each pair first, in order (the rest not written): kSplit false, `rows`
// is tgt16 [P, N, 32] bf16; kSplit true, it is [P, 2, N, 32] f32 with the
// TF32 hi parts of pair p in plane 2p and the lo parts in plane 2p + 1 (the
// f32 mode, match_tf32.cuh).  idx_map [P, N] i32 (original index of each kept
// row), counts [P] i32.
template <bool kSplit>
__global__ void __launch_bounds__(kChunk)
compact_targets_kernel(const float* __restrict__ tgt, const uint8_t* __restrict__ bad,
                       void* __restrict__ rows_out, int* __restrict__ idx_map,
                       int* __restrict__ counts, int N) {
  __shared__ int warp_kept[kChunk / 32];
  __shared__ int warp_before[kChunk / 32];
  __shared__ int kept_local[kChunk];

  const int pair = blockIdx.y;
  const int c0 = blockIdx.x * kChunk;
  const int t = threadIdx.x;
  const int lane = t % 32;
  const int warp = t / 32;
  const uint8_t* bad_p = bad + size_t(pair) * N;

  // kept targets before this chunk (c0 is a multiple of 256)
  int part = 0;
  if (reinterpret_cast<uintptr_t>(bad_p) % 4 == 0) {
    const uint32_t* words = reinterpret_cast<const uint32_t*>(bad_p);
#pragma unroll 4
    for (int j = t; j < c0 / 4; j += kChunk) part += zero_bytes(words[j]);
  } else {
#pragma unroll 4
    for (int j = t; j < c0; j += kChunk) part += bad_p[j] == 0;
  }
  const bool keep = (c0 + t < N) && bad_p[c0 + t] == 0;
  const unsigned ballot = __ballot_sync(0xffffffffu, keep);
  for (int off = 16; off > 0; off >>= 1) part += __shfl_xor_sync(0xffffffffu, part, off);
  if (lane == 0) {
    warp_kept[warp] = __popc(ballot);
    warp_before[warp] = part;
  }
  __syncthreads();
  int before = 0, warp_off = 0, total = 0;
#pragma unroll
  for (int w = 0; w < kChunk / 32; ++w) {
    before += warp_before[w];
    if (w < warp) warp_off += warp_kept[w];
    total += warp_kept[w];
  }
  if (keep) {
    const int local = warp_off + __popc(ballot & ((1u << lane) - 1u));
    kept_local[local] = t;
    idx_map[size_t(pair) * N + before + local] = c0 + t;
  }
  __syncthreads();

  // the kept rows, 8 threads a row: 16 bytes of f32 in, 8 bytes of bf16 (or
  // 16 + 16 bytes of TF32 hi and lo) out, consecutive threads on consecutive
  // output bytes
  const float4* rows = reinterpret_cast<const float4*>(tgt + (size_t(pair) * N + c0) * kD);
  if constexpr (kSplit) {
    float4* hi = static_cast<float4*>(rows_out) + (size_t(2 * pair) * N + before) * (kD / 4);
    float4* lo = hi + size_t(N) * (kD / 4);
    for (int i = t; i < total * 8; i += kChunk) {
      split_tf32(rows[kept_local[i >> 3] * 8 + (i & 7)], hi[i], lo[i]);
    }
  } else {
    uint2* dst = static_cast<uint2*>(rows_out) + (size_t(pair) * N + before) * (kD / 4);
    for (int i = t; i < total * 8; i += kChunk) {
      const float4 v = rows[kept_local[i >> 3] * 8 + (i & 7)];
      const __nv_bfloat162 lo = __floats2bfloat162_rn(v.x, v.y);
      const __nv_bfloat162 hi = __floats2bfloat162_rn(v.z, v.w);
      uint2 o;
      o.x = *reinterpret_cast<const uint32_t*>(&lo);
      o.y = *reinterpret_cast<const uint32_t*>(&hi);
      dst[i] = o;
    }
  }
  if (blockIdx.x == gridDim.x - 1 && t == 0) counts[pair] = before + total;
}

// ------------------------------------------------------------ the main kernel

#define ORYON_ACC64(d)                                                          \
  "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),       \
      "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), \
      "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]),          \
      "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]),          \
      "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]), "+f"(d[26]),          \
      "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),          \
      "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]),          \
      "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]),          \
      "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]),          \
      "+f"(d[47]), "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]),          \
      "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]), "+f"(d[56]),          \
      "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]),          \
      "+f"(d[62]), "+f"(d[63])

#define ORYON_ACC64_LIST                                                        \
  "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "     \
  "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, " \
  "%31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, " \
  "%46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, " \
  "%61, %62, %63}"

// D[64, 128] (+)= A[64, 16] . B[16, 128]^T-as-stored: A from registers (four
// packed bf16 pairs a thread), B K-major in shared memory (the [128 targets,
// 16] slice of a tile), f32 sums in registers.  scale_d = 0 overwrites D.
__device__ __forceinline__ void wgmma_rs(float (&d)[64], const uint32_t (&a)[4],
                                         uint64_t desc_b, int scale_d) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 " ORYON_ACC64_LIST
      ", {%64, %65, %66, %67}, %68, p, 1, 1, 0;\n"
      "}\n"
      : ORYON_ACC64(d)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b), "r"(scale_d));
}

// Keeps the compiler from moving uses of the accumulator registers across the
// asynchronous products.
__device__ __forceinline__ void fence_regs(float (&r)[64]) {
#pragma unroll
  for (int i = 0; i < 64; ++i) asm volatile("" : "+f"(r[i])::"memory");
}

__device__ __forceinline__ uint32_t pack_bf16(float2 v) {
  const __nv_bfloat162 b = __floats2bfloat162_rn(v.x, v.y);  // .x in the low half
  return *reinterpret_cast<const uint32_t*>(&b);
}

// D[64, 128] = A[64, 32] . B^T for one target tile in shared memory, issued
// and committed, not waited for.
__device__ __forceinline__ void issue_tile(float (&d)[64], const uint32_t (&a)[2][4],
                                           uint32_t tile_smem) {
  const uint64_t desc = make_desc<kSwizzle64>(tile_smem);
  fence_regs(d);
  wgmma_fence();
  wgmma_rs(d, a[0], desc, 0);
  wgmma_rs(d, a[1], desc + 2, 1);
  wgmma_commit();
}

// The reduction of one tile's sums into the running best of this thread's two
// rows, in three parts.  t0: position of the tile's first column among the
// kept targets; c2: this lane's first column of every group of eight.

// Columns at or past the pair's count take -inf (the pair's last tile).
__device__ __forceinline__ void mask_tile(float (&d)[64], int t0, int count, int c2) {
  const int lim = count - t0 - c2;  // live columns, from this thread's first
  if (lim + c2 < kBN) {
#pragma unroll
    for (int j = 0; j < 16; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        if (j * 8 + (e & 1) >= lim) d[4 * j + e] = -INFINITY;
      }
    }
  }
}

// mine[r]: the maximum over this lane's columns of row r, as four
// independent chains; tmax[r]: over the row (the quad's four lanes).  No
// branch: this part may run while the next tile's products are in flight.
__device__ __forceinline__ void max_tile(const float (&d)[64], float (&mine)[2],
                                         float (&tmax)[2]) {
  float m[2][4];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
#pragma unroll
    for (int j = 0; j < 4; ++j) m[r][j] = fmaxf(d[4 * j + 2 * r], d[4 * j + 2 * r + 1]);
#pragma unroll
    for (int j = 4; j < 16; ++j) {
      m[r][j % 4] = fmaxf(m[r][j % 4], fmaxf(d[4 * j + 2 * r], d[4 * j + 2 * r + 1]));
    }
  }
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    mine[r] = fmaxf(fmaxf(m[r][0], m[r][1]), fmaxf(m[r][2], m[r][3]));
    tmax[r] = fmaxf(mine[r], __shfl_xor_sync(0xffffffffu, mine[r], 1));
    tmax[r] = fmaxf(tmax[r], __shfl_xor_sync(0xffffffffu, tmax[r], 2));
  }
}

// Where the row's maximum beats the running best (whole quads decide alike),
// the lanes that hold it look for their first column with it and the quad
// takes the lowest.
__device__ __forceinline__ void scan_tile(const float (&d)[64], int t0, int c2,
                                          const float (&mine)[2], const float (&tmax)[2],
                                          float (&best)[2], int (&bpos)[2]) {
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const bool better = tmax[r] > best[r];
    const unsigned quads = __ballot_sync(0xffffffffu, better);
    if (better) {
      best[r] = tmax[r];
      int col = kBN;
      if (mine[r] == tmax[r]) {
#pragma unroll
        for (int j = 15; j >= 0; --j) {
          if (d[4 * j + 2 * r + 1] == tmax[r]) col = j * 8 + 1;
          if (d[4 * j + 2 * r] == tmax[r]) col = j * 8;
        }
        col += c2;
      }
      col = min(col, __shfl_xor_sync(quads, col, 1));
      col = min(col, __shfl_xor_sync(quads, col, 2));
      bpos[r] = t0 + col;
    }
  }
}

template <int kStages>
struct Smem {
  static constexpr int bar_off = kStages * kTileBytes;
  static constexpr int bytes = bar_off + 2 * kStages * 8;
  static constexpr int alloc = bytes + 1024;  // room to align the base
};

// src [P, S, 32] f32; map_t over tgt16 [P, N, 32] bf16 (boxes of 128 rows);
// counts [P] from the pre-pass; part_best, part_pos [P, splits, S]: the
// largest sum of each row over the tiles of split blockIdx.y of its pair and
// its position among the kept targets (-inf, 0 where the split has no tile).
template <int kConsumers, int kStages, int kMinBlocks, int kSets>
__global__ void __launch_bounds__(kConsumers * 128 + 32, kMinBlocks)
match_wgmma_kernel(const __grid_constant__ CUtensorMap map_t,
                   const float* __restrict__ src, const int* __restrict__ counts,
                   float* __restrict__ part_best, int* __restrict__ part_pos, int S) {
  using Lay = Smem<kStages>;
  extern __shared__ unsigned char smem_raw[];
  const uint32_t base = (smem_u32(smem_raw) + 1023u) & ~1023u;
  const uint32_t bar_full = base + Lay::bar_off;      // [kStages]
  const uint32_t bar_empty = bar_full + kStages * 8;  // [kStages]

  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int pair = blockIdx.z;
  const int count = counts[pair];
  const int all_tiles = (count + kBN - 1) / kBN;
  const int tile0 = int((long long)all_tiles * blockIdx.y / gridDim.y);
  const int n_tiles = int((long long)all_tiles * (blockIdx.y + 1) / gridDim.y) - tile0;

  if (threadIdx.x == 0) {
    for (int s = 0; s < kStages; ++s) {
      mbar_init(bar_full + s * 8, 1);                // the producer's one arrive
      mbar_init(bar_empty + s * 8, kConsumers * 4);  // one arrive a consumer warp
    }
    mbar_init_fence();
  }
  __syncthreads();

  if (warp == kConsumers * 4) {
    // ------------------------------------------------------ producer warp
    if (lane == 0) {
      for (int it = 0; it < n_tiles; ++it) {
        const int stage = it % kStages;
        mbar_wait(bar_empty + stage * 8, ((it / kStages) & 1u) ^ 1u);  // free at first
        mbar_arrive_expect_tx(bar_full + stage * 8, kTileBytes);
        tma_load_tile(base + stage * kTileBytes, &map_t, bar_full + stage * 8, 0,
                      (tile0 + it) * kBN, pair);
      }
    }
    return;
  }

  // ------------------------------------------------- consumer warpgroups
  // this thread's rows of the accumulator: row_lo and row_lo + 8; its columns
  // of a tile: j * 8 + c2 + {0, 1}, j = 0..15
  const int row_lo = (blockIdx.x * kConsumers + warp / 4) * 64 + (warp % 4) * 16 + lane / 4;
  const int c2 = (lane % 4) * 2;

  // the A fragments of both k16 steps: (row_lo, row_lo + 8) x (columns
  // kk * 16 + c2, + 8), rounded to bf16; rows at or past S are zeros
  uint32_t a[2][4];
  {
    const float* sp = src + size_t(pair) * S * kD;
#pragma unroll
    for (int kk = 0; kk < 2; ++kk) {
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int row = row_lo + 8 * (i & 1);
        const int col = kk * 16 + 8 * (i >> 1) + c2;
        float2 v = make_float2(0.f, 0.f);
        if (row < S) v = *reinterpret_cast<const float2*>(sp + size_t(row) * kD + col);
        a[kk][i] = pack_bf16(v);
      }
    }
  }

  // the largest sum of each row so far and its position among the kept
  // targets, the same in the four lanes of the row's quad
  float best[2] = {-INFINITY, -INFINITY};
  int bpos[2] = {0, 0};

  const auto wait_full = [&](int it) {
    mbar_wait(bar_full + (it % kStages) * 8, (it / kStages) & 1u);
  };
  const auto tile_smem = [&](int it) { return base + (it % kStages) * kTileBytes; };
  // every warp of the group has waited for the products that read the stage
  const auto release = [&](int it) {
    __syncwarp();
    if (lane == 0) mbar_arrive(bar_empty + (it % kStages) * 8);  // may be refilled
  };
  const auto position = [&](int it) { return (tile0 + it) * kBN; };
  float mine[2], tmax[2];

  if constexpr (kSets == 1) {
    // one tile after the other: products, then the reduction.  The tensor
    // cores have the other warpgroups of the SM meanwhile.
    float d[64];
    for (int it = 0; it < n_tiles; ++it) {
      wait_full(it);
      issue_tile(d, a, tile_smem(it));
      wgmma_wait<0>();
      fence_regs(d);
      release(it);
      mask_tile(d, position(it), count, c2);
      max_tile(d, mine, tmax);
      scan_tile(d, position(it), c2, mine, tmax, best, bpos);
    }
  } else if (n_tiles > 0) {
    // two accumulator sets: the products of tile it + 1 run under the
    // branch-free part of the reduction of tile it (its maxima); the scan,
    // which branches, follows their wait, since the compiler lets no
    // asynchronous product stay in flight across a branch that may diverge.
    // Only a split's last tile can be the pair's last: it alone is masked.
    float d0[64], d1[64];
    const auto step = [&](float(&cur)[64], float(&next)[64], int it) {
      wait_full(it + 1);
      issue_tile(next, a, tile_smem(it + 1));
      max_tile(cur, mine, tmax);
      wgmma_wait<0>();
      fence_regs(next);
      release(it + 1);
      scan_tile(cur, position(it), c2, mine, tmax, best, bpos);
    };
    const auto last = [&](float(&cur)[64], int it) {
      mask_tile(cur, position(it), count, c2);
      max_tile(cur, mine, tmax);
      scan_tile(cur, position(it), c2, mine, tmax, best, bpos);
    };
    wait_full(0);
    issue_tile(d0, a, tile_smem(0));
    wgmma_wait<0>();
    fence_regs(d0);
    release(0);
    int it = 0;
    while (true) {
      if (it + 1 >= n_tiles) break;
      step(d0, d1, it++);
      if (it + 1 >= n_tiles) break;
      step(d1, d0, it++);
    }
    if (it & 1) {
      last(d1, it);
    } else {
      last(d0, it);
    }
  }

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = row_lo + 8 * r;
    if (lane % 4 == 0 && row < S) {
      const size_t at = (size_t(pair) * gridDim.y + blockIdx.y) * S + row;
      part_best[at] = best[r];
      part_pos[at] = bpos[r];
    }
  }
}

// The splits of a row merged in order (a later split wins only with a larger
// sum), the distance formed, the position mapped to the original index.
__global__ void __launch_bounds__(256)
match_merge_kernel(const float* __restrict__ part_best, const int* __restrict__ part_pos,
                   const int* __restrict__ idx_map, const int* __restrict__ counts,
                   float* __restrict__ out_min, int* __restrict__ out_arg, int S, int N,
                   int splits) {
  const int pair = blockIdx.y;
  const int row = blockIdx.x * blockDim.x + threadIdx.x;
  if (row >= S) return;
  float best = -INFINITY;
  int pos = 0;
  for (int s = 0; s < splits; ++s) {
    const size_t at = (size_t(pair) * splits + s) * S + row;
    const float b = part_best[at];
    if (b > best) {
      best = b;
      pos = part_pos[at];
    }
  }
  out_min[size_t(pair) * S + row] = 0.5f * (1.f - best);
  out_arg[size_t(pair) * S + row] = counts[pair] > 0 ? idx_map[size_t(pair) * N + pos] : 0;
}

// --------------------------------------------------------------- host side

// Consumer warpgroups a block (64 source rows each), ring stages, resident
// blocks asked of the compiler and accumulator sets a warpgroup.  phases: 1 the pre-pass, 2 the main kernel and
// the merge, 3 both (as every caller but a measurement of one phase asks).
// part_best, part_pos: [P, splits, S] scratch.
template <int kConsumers = 2, int kStages = 4, int kMinBlocks = 2, int kSets = 1>
cudaError_t launch(const void* src, const void* tgt, const void* bad, void* tgt16,
                   void* idx_map, void* counts, void* part_best, void* part_pos,
                   void* out_min, void* out_arg, int P, int S, int N, int splits,
                   int phases, cudaStream_t stream) {
  if (phases & 1) {
    compact_targets_kernel<false><<<dim3((N + kChunk - 1) / kChunk, P), kChunk, 0, stream>>>(
        static_cast<const float*>(tgt), static_cast<const uint8_t*>(bad), tgt16,
        static_cast<int*>(idx_map), static_cast<int*>(counts), N);
    cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return err;
  }
  if (phases & 2) {
    using Lay = Smem<kStages>;
    CUtensorMap map;
    cudaError_t err = encode_map(&map, tgt16, 2, kD, N, P, kD * 2,
                                 uint64_t(N) * kD * 2, kD, kBN);
    if (err != cudaSuccess) return err;
    auto kernel = match_wgmma_kernel<kConsumers, kStages, kMinBlocks, kSets>;
    static bool configured = false;
    if (!configured) {
      err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                 Lay::alloc);
      if (err != cudaSuccess) return err;
      configured = true;
    }
    const dim3 grid((S + kConsumers * 64 - 1) / (kConsumers * 64), splits, P);
    kernel<<<grid, kConsumers * 128 + 32, Lay::alloc, stream>>>(
        map, static_cast<const float*>(src), static_cast<const int*>(counts),
        static_cast<float*>(part_best), static_cast<int*>(part_pos), S);
    err = cudaGetLastError();
    if (err != cudaSuccess) return err;
    match_merge_kernel<<<dim3((S + 255) / 256, P), 256, 0, stream>>>(
        static_cast<const float*>(part_best), static_cast<const int*>(part_pos),
        static_cast<const int*>(idx_map), static_cast<const int*>(counts),
        static_cast<float*>(out_min), static_cast<int*>(out_arg), S, N, splits);
    return cudaGetLastError();
  }
  return cudaSuccess;
}

}  // namespace oryon_match_wg
