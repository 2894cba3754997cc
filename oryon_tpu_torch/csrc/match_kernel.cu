// Masked cosine argmin for nearest-neighbour feature matching.
//
// For every source row: the minimum and the argmin over the targets of
// 0.5 * (1 - <src, tgt>), with excluded targets at +inf and ties to the
// lowest target index.  Two modes, each the counterpart of one JAX function:
//
//  * precision "fp32" replaces the Pallas TPU kernel
//    oryon_tpu/ops/pallas/match_kernel.py::masked_argmin_pallas, which takes
//    its products at Precision.HIGHEST on the f32 inputs (and the XLA twin
//    _streaming_argmin under MatchParams.precision = "fp32", the strict-parity
//    runs).  The Pallas kernel adds +1e9 to an excluded target instead of
//    +inf: the same argmin whenever one target of the pair is kept; with none
//    kept this port returns (+inf, 0), as _streaming_argmin does.  It runs on
//    the tensor cores as three TF32 products (match_tf32.cuh: a pre-pass that
//    compacts and splits the kept targets, `wgmma` m64n128k8 tf32, the
//    running best on the accumulator registers), entry
//    oryon_masked_argmin_wgmma_tf32x3.  Each input keeps about 22 bits, so
//    the sums are within about 1e-7 of f32 ones, against the mode's 1e-5
//    gate; one TF32 product (11 bits) would not hold it.
//  * precision "bf16" replaces oryon_tpu/ops/matching.py::_streaming_argmin in
//    its bf16 mode (inputs rounded to bf16, f32 sums; the serving default of
//    MatchParams.precision): match_wgmma.cuh, a compacting pre-pass, then
//    `wgmma` m64n128k16, entry oryon_masked_argmin_wgmma_bf16.
//
// What bounds it on an H100: per pair 5120 x (kept targets) x 32
// multiply-adds against 4.7 MB of targets, so arithmetic; materialising the
// 5120 x 36864 f32 distance matrix would instead cost 755 MB of device memory
// traffic per pair.
//
// The CUDA-core kernel below (the first body of the fp32 mode, entry
// oryon_masked_argmin_f32) is on no route: it stays in the library only so
// that chip_smoke.py can time it beside the fp32 mode's kernel in the same
// run.  One launch
// covers the batch, grid = (source tiles, pairs); each thread keeps two
// 32-wide source rows in registers and walks every target of its pair in
// index order through 256-target chunks in shared memory (a broadcast read),
// skipping excluded ones (the same as +inf under the strict `<`); four
// interleaved partial sums a dot product.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "match_tf32.cuh"
#include "match_wgmma.cuh"

namespace {

constexpr int kD = 32;          // feature width (decoder out_channels)
constexpr int kThreads = 128;
constexpr int kRows = 2;        // source rows per thread
constexpr int kTile = kThreads * kRows;  // source rows per block
constexpr int kChunk = 256;     // targets per shared-memory chunk

__global__ void __launch_bounds__(kThreads)
masked_argmin_kernel(const float* __restrict__ src,
                     const float* __restrict__ tgt,
                     const uint8_t* __restrict__ bad,
                     float* __restrict__ out_min, int* __restrict__ out_arg,
                     int S, int N) {
  __shared__ float4 t_s[kChunk * kD / 4];
  __shared__ uint8_t bad_s[kChunk];

  const int pair = blockIdx.y;
  const float* src_p = src + size_t(pair) * S * kD;
  const float* tgt_p = tgt + size_t(pair) * N * kD;
  const uint8_t* bad_p = bad + size_t(pair) * N;

  float x[kRows][kD];
  float best[kRows];
  int arg[kRows];
#pragma unroll
  for (int i = 0; i < kRows; ++i) {
    const int r = blockIdx.x * kTile + i * kThreads + threadIdx.x;
#pragma unroll
    for (int d = 0; d < kD; ++d) {
      x[i][d] = r < S ? src_p[size_t(r) * kD + d] : 0.f;
    }
    best[i] = INFINITY;
    arg[i] = 0;
  }

  for (int c0 = 0; c0 < N; c0 += kChunk) {
    const int n = min(kChunk, N - c0);
    __syncthreads();  // the previous chunk is no longer read
    const float4* src4 = reinterpret_cast<const float4*>(tgt_p + size_t(c0) * kD);
    for (int idx = threadIdx.x; idx < n * kD / 4; idx += kThreads) {
      t_s[idx] = src4[idx];
    }
    for (int j = threadIdx.x; j < n; j += kThreads) bad_s[j] = bad_p[c0 + j];
    __syncthreads();

    for (int j = 0; j < n; ++j) {
      if (bad_s[j]) continue;  // same branch for every thread of the block
      float acc[kRows][4];
#pragma unroll
      for (int i = 0; i < kRows; ++i) {
#pragma unroll
        for (int a = 0; a < 4; ++a) acc[i][a] = 0.f;
      }
#pragma unroll
      for (int q = 0; q < kD / 4; ++q) {
        const float4 t = t_s[j * (kD / 4) + q];
#pragma unroll
        for (int i = 0; i < kRows; ++i) {
          acc[i][0] = fmaf(x[i][4 * q + 0], t.x, acc[i][0]);
          acc[i][1] = fmaf(x[i][4 * q + 1], t.y, acc[i][1]);
          acc[i][2] = fmaf(x[i][4 * q + 2], t.z, acc[i][2]);
          acc[i][3] = fmaf(x[i][4 * q + 3], t.w, acc[i][3]);
        }
      }
#pragma unroll
      for (int i = 0; i < kRows; ++i) {
        const float cos = (acc[i][0] + acc[i][1]) + (acc[i][2] + acc[i][3]);
        const float dist = 0.5f * (1.f - cos);
        if (dist < best[i]) {
          best[i] = dist;
          arg[i] = c0 + j;
        }
      }
    }
  }

#pragma unroll
  for (int i = 0; i < kRows; ++i) {
    const int r = blockIdx.x * kTile + i * kThreads + threadIdx.x;
    if (r < S) {
      out_min[size_t(pair) * S + r] = best[i];
      out_arg[size_t(pair) * S + r] = arg[i];
    }
  }
}

}  // namespace

// The CUDA-core kernel (timed beside the fp32 mode; no route calls it).
// src [P, S, D] f32, tgt [P, N, D] f32, bad [P, N] bytes (nonzero =
// excluded), out_min [P, S] f32, out_arg [P, S] i32, all contiguous; D must
// be 32.  Returns a cudaError_t code (0 on success).
extern "C" int oryon_masked_argmin_f32(const void* src, const void* tgt,
                                       const void* bad, void* out_min,
                                       void* out_arg, int P, int S, int N,
                                       int D, void* stream) {
  if (P <= 0 || S <= 0 || N <= 0 || D != kD) return int(cudaErrorInvalidValue);
  dim3 grid((S + kTile - 1) / kTile, P);
  masked_argmin_kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(src), static_cast<const float*>(tgt),
      static_cast<const uint8_t*>(bad), static_cast<float*>(out_min),
      static_cast<int*>(out_arg), S, N);
  return int(cudaGetLastError());
}

// The same function with both inputs rounded to bf16, on the tensor cores
// (match_wgmma.cuh).  Scratch, allocated by the caller: tgt16 [P, N, 32]
// bf16, idx_map [P, N] i32, counts [P] i32; phase 1 (the compacting pre-pass)
// writes them, phase 2 (the products and the reduction over `splits` ranges
// of each pair's targets, then their merge) reads them on the same stream,
// through part_best [P, splits, S] f32 and part_pos [P, splits, S] i32;
// phases = 3 runs both.
extern "C" int oryon_masked_argmin_wgmma_bf16(
    const void* src, const void* tgt, const void* bad, void* tgt16, void* idx_map,
    void* counts, void* part_best, void* part_pos, void* out_min, void* out_arg,
    int P, int S, int N, int D, int splits, int phases, void* stream) {
  if (P <= 0 || P > 65535 || S <= 0 || N <= 0 || D != oryon_match_wg::kD ||
      splits <= 0 || splits > 65535 || (phases & ~3) != 0) {
    return int(cudaErrorInvalidValue);
  }
  return int(oryon_match_wg::launch(src, tgt, bad, tgt16, idx_map, counts, part_best,
                                    part_pos, out_min, out_arg, P, S, N, splits, phases,
                                    static_cast<cudaStream_t>(stream)));
}

// The fp32 mode on the tensor cores (match_tf32.cuh): arguments as the bf16
// entry's, with `rows` the [P, 2, N, 32] f32 scratch of the split pre-pass
// (the TF32 hi and lo parts of each pair's kept targets) in place of tgt16.
extern "C" int oryon_masked_argmin_wgmma_tf32x3(
    const void* src, const void* tgt, const void* bad, void* rows, void* idx_map,
    void* counts, void* part_best, void* part_pos, void* out_min, void* out_arg,
    int P, int S, int N, int D, int splits, int phases, void* stream) {
  if (P <= 0 || P > 65535 || S <= 0 || N <= 0 || D != oryon_match_wg::kD ||
      splits <= 0 || splits > 65535 || (phases & ~3) != 0) {
    return int(cudaErrorInvalidValue);
  }
  return int(oryon_match_wg::launch_tf32x3(src, tgt, bad, rows, idx_map, counts, part_best,
                                           part_pos, out_min, out_arg, P, S, N, splits,
                                           phases, static_cast<cudaStream_t>(stream)));
}
