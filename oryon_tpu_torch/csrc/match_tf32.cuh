// Masked cosine argmin on the inputs as they are (K2 in precision "fp32", the
// counterpart of oryon_tpu/ops/pallas/match_kernel.py::masked_argmin_pallas,
// which takes its products at Precision.HIGHEST), designed for Hopper: each
// f32 product runs on the tensor cores as three TF32 products.
//
// What bounds the function on an H100: 2 * 32 FLOPs per (source, kept
// target), about 58 GFLOP for the serving batch at 40% excluded, against 128
// bytes a target read once.  On the CUDA cores that is 0.87 ms at the f32
// peak; one TF32 product keeps 11 significant bits of each input and misses
// the mode's gate (minima within 1e-5 of the plain version), so the products
// are split ("3xTF32", as CUTLASS's examples 27 and 28 do):
//
//   x = hi + lo,  hi = tf32(x),  lo = tf32(x - hi),
//   <s, t> ~ <hi_s, lo_t> + <lo_s, hi_t> + <hi_s, hi_t>
//
// Each input keeps about 22 bits (|x - hi - lo| <= 2^-22 |x|), every product
// of two TF32 values is exact in f32, and the dropped lo_s lo_t term is below
// 2^-22 of |<s, t>|'s terms: a 32-wide dot of unit vectors is off by about
// 1e-7, against 1e-5.  Three TF32 products at 495 TFLOP/s bound the work at
// 0.35 ms.  What the design does about it:
//
//  * The pre-pass compacts and splits in one pass (match_wgmma.cuh's
//    compact_targets_kernel<true>): the kept targets of each pair in index
//    order, each row written as its hi and its lo parts, rounded explicitly
//    (round_tf32), with the bf16 mode's index map and per-pair count.  The
//    mask leaves the inner loop and the excluded share leaves the work.
//  * One warpgroup owns 64 source rows of one pair.  It reads them from the
//    f32 input, splits them the same way and stores hi and lo once into
//    shared memory in the 128-byte-swizzled K-major layout that TMA would
//    write: A comes from shared memory, because keeping hi and lo of four k8
//    steps in registers (32 of them) beside the 64 accumulator registers
//    would pass the 112 a thread that two resident blocks allow.
//  * B is a [128, 32] tile of hi_t and one of lo_t (16 KB each, 128-byte
//    rows, 128-byte swizzle), loaded by TMA into a ring of stages by a
//    producer warp.  A tile is 12 `wgmma` m64n128k8 tf32: the four k steps
//    of hi_s lo_t, of lo_s hi_t, then of hi_s hi_t, into one f32
//    accumulator, the small terms first.  The order is fixed, so two
//    launches agree bitwise.
//  * The reduction, the target splits and the merge are the bf16 mode's
//    (mask_tile, max_tile, scan_tile, match_merge_kernel): the running
//    maximum of the sum on the accumulator registers, a row scanned only
//    when its tile maximum beats its best (strict `>`), ties to the lowest
//    original index.  Products now take six times the bf16 mode's tensor-core
//    time a tile, so the maxima of one warpgroup hide more easily under the
//    products of the other three resident ones.

#pragma once

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "hopper.cuh"
#include "match_wgmma.cuh"

namespace oryon_match_wg {

using namespace oryon_hopper;

constexpr int kRowBytes32 = kD * 4;                 // 128: one swizzle span
constexpr int kPartBytes = kBN * kRowBytes32;       // 16 KB: hi or lo of a tile
constexpr int kStageBytes32 = 2 * kPartBytes;       // hi, then lo
constexpr int kSrcBytes = 64 * kRowBytes32;         // 8 KB: hi or lo of 64 rows

template <int kConsumers, int kStages>
struct SmemTf32 {
  // [kStages] x (hi tile, lo tile), [kConsumers] x (hi rows, lo rows), barriers;
  // every part 1024-byte aligned, as the 128-byte swizzle needs
  static constexpr int src_off = kStages * kStageBytes32;
  static constexpr int bar_off = src_off + kConsumers * 2 * kSrcBytes;
  static constexpr int bytes = bar_off + 2 * kStages * 8;
  static constexpr int alloc = bytes + 1024;  // room to align the base
};

// D[64, 128] (+)= A[64, 8] . B[128, 8]^T in TF32, both operands K-major in
// shared memory under the 128-byte swizzle, f32 sums in registers.
// scale_d = 0 overwrites D.
__device__ __forceinline__ void wgmma_tf32(float (&d)[64], uint64_t desc_a, uint64_t desc_b,
                                           int scale_d) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k8.f32.tf32.tf32 " ORYON_ACC64_LIST
      ", %64, %65, p, 1, 1;\n"
      "}\n"
      : ORYON_ACC64(d)
      : "l"(desc_a), "l"(desc_b), "r"(scale_d));
}

// D = the three TF32 products of one target tile (k8 steps advance the
// descriptors by 32 bytes), issued and committed, not waited for.
__device__ __forceinline__ void issue_tile_tf32(float (&d)[64], uint32_t a_hi, uint32_t a_lo,
                                                uint32_t b_hi, uint32_t b_lo) {
  const uint64_t ah = make_desc<kSwizzle128>(a_hi), al = make_desc<kSwizzle128>(a_lo);
  const uint64_t bh = make_desc<kSwizzle128>(b_hi), bl = make_desc<kSwizzle128>(b_lo);
  fence_regs(d);
  wgmma_fence();
#pragma unroll
  for (int k = 0; k < 4; ++k) wgmma_tf32(d, ah + 2 * k, bl + 2 * k, k > 0);
#pragma unroll
  for (int k = 0; k < 4; ++k) wgmma_tf32(d, al + 2 * k, bh + 2 * k, 1);
#pragma unroll
  for (int k = 0; k < 4; ++k) wgmma_tf32(d, ah + 2 * k, bh + 2 * k, 1);
  wgmma_commit();
}

// src [P, S, 32] f32; map_t over the pre-pass's [P, 2, N, 32] hi / lo rows
// (planes 2p and 2p + 1, boxes of 128 rows); counts [P]; part_best, part_pos
// [P, splits, S] as in match_wgmma_kernel.
template <int kConsumers, int kStages, int kMinBlocks>
__global__ void __launch_bounds__(kConsumers * 128 + 32, kMinBlocks)
match_tf32_kernel(const __grid_constant__ CUtensorMap map_t, const float* __restrict__ src,
                  const int* __restrict__ counts, float* __restrict__ part_best,
                  int* __restrict__ part_pos, int S) {
  using Lay = SmemTf32<kConsumers, kStages>;
  extern __shared__ unsigned char smem_raw[];
  const uint32_t base = (smem_u32(smem_raw) + 1023u) & ~1023u;
  unsigned char* const base_p = smem_raw + (base - smem_u32(smem_raw));
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
        const uint32_t dst = base + stage * kStageBytes32;
        mbar_wait(bar_empty + stage * 8, ((it / kStages) & 1u) ^ 1u);  // free at first
        mbar_arrive_expect_tx(bar_full + stage * 8, kStageBytes32);
        tma_load_tile(dst, &map_t, bar_full + stage * 8, 0, (tile0 + it) * kBN, 2 * pair);
        tma_load_tile(dst + kPartBytes, &map_t, bar_full + stage * 8, 0, (tile0 + it) * kBN,
                      2 * pair + 1);
      }
    }
    return;
  }

  // ------------------------------------------------- consumer warpgroups
  const int group = warp / 4;
  const int row_lo = (blockIdx.x * kConsumers + group) * 64 + (warp % 4) * 16 + lane / 4;
  const int c2 = (lane % 4) * 2;
  const uint32_t a_hi = base + Lay::src_off + group * 2 * kSrcBytes;
  const uint32_t a_lo = a_hi + kSrcBytes;

  // the group's 64 source rows, split, into shared memory: 16-byte chunk c of
  // row r at r * 128 + (c ^ (r % 8)) * 16 (the 128-byte swizzle); rows at or
  // past S are zeros
  {
    const int t = threadIdx.x % 128;
    const int row0 = (blockIdx.x * kConsumers + group) * 64;
    const float4* sp = reinterpret_cast<const float4*>(src + size_t(pair) * S * kD);
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int i = t + 128 * j;
      const int r = i / 8, c = i % 8;
      float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
      if (row0 + r < S) v = sp[size_t(row0 + r) * (kD / 4) + c];
      const uint32_t off = r * kRowBytes32 + ((c ^ (r % 8)) * 16);
      split_tf32(v, *reinterpret_cast<float4*>(base_p + (a_hi - base) + off),
                 *reinterpret_cast<float4*>(base_p + (a_lo - base) + off));
    }
    fence_proxy_async();  // the stores, visible to the products' operand reads
    named_barrier_sync(1, kConsumers * 128);  // the consumers only, once
  }

  float best[2] = {-INFINITY, -INFINITY};
  int bpos[2] = {0, 0};
  float mine[2], tmax[2];
  float d[64];
  for (int it = 0; it < n_tiles; ++it) {
    const int stage = it % kStages;
    const uint32_t tile = base + stage * kStageBytes32;
    mbar_wait(bar_full + stage * 8, (it / kStages) & 1u);
    issue_tile_tf32(d, a_hi, a_lo, tile, tile + kPartBytes);
    wgmma_wait<0>();
    fence_regs(d);
    __syncwarp();
    if (lane == 0) mbar_arrive(bar_empty + stage * 8);  // the stage may be refilled
    const int t0 = (tile0 + it) * kBN;
    mask_tile(d, t0, count, c2);
    max_tile(d, mine, tmax);
    scan_tile(d, t0, c2, mine, tmax, best, bpos);
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

// --------------------------------------------------------------- host side

// The f32 mode: arguments as launch() in match_wgmma.cuh, with `rows` the
// [P, 2, N, 32] f32 scratch of the split pre-pass in place of tgt16.
// Consumer warpgroups a block, ring stages and resident blocks asked of the
// compiler; internal linkage, so that a second library built from this
// header (tools/match_tile_sweep.cu) keeps its own `configured` flags.
template <int kConsumers = 2, int kStages = 2, int kMinBlocks = 2>
static cudaError_t launch_tf32x3(const void* src, const void* tgt, const void* bad, void* rows,
                                 void* idx_map, void* counts, void* part_best, void* part_pos,
                                 void* out_min, void* out_arg, int P, int S, int N, int splits,
                                 int phases, cudaStream_t stream) {
  if (phases & 1) {
    compact_targets_kernel<true><<<dim3((N + kChunk - 1) / kChunk, P), kChunk, 0, stream>>>(
        static_cast<const float*>(tgt), static_cast<const uint8_t*>(bad), rows,
        static_cast<int*>(idx_map), static_cast<int*>(counts), N);
    cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return err;
  }
  if (phases & 2) {
    using Lay = SmemTf32<kConsumers, kStages>;
    CUtensorMap map;
    cudaError_t err = encode_map(&map, rows, 4, kD, N, 2 * uint64_t(P), kRowBytes32,
                                 uint64_t(N) * kRowBytes32, kD, kBN);
    if (err != cudaSuccess) return err;
    auto kernel = match_tf32_kernel<kConsumers, kStages, kMinBlocks>;
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
