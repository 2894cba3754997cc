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

#include <cuda_runtime.h>

#include "match_tf32.cuh"
#include "match_wgmma.cuh"

// The bf16 mode, both inputs rounded to bf16, on the tensor cores
// (match_wgmma.cuh).  src [P, S, D] f32, tgt [P, N, D] f32, bad [P, N] bytes
// (nonzero = excluded), out_min [P, S] f32, out_arg [P, S] i32, all
// contiguous; D must be 32.  Scratch, allocated by the caller: tgt16 [P, N, 32]
// bf16, idx_map [P, N] i32, counts [P] i32; phase 1 (the compacting pre-pass)
// writes them, phase 2 (the products and the reduction over `splits` ranges
// of each pair's targets, then their merge) reads them on the same stream,
// through part_best [P, splits, S] f32 and part_pos [P, splits, S] i32;
// phases = 3 runs both.  Returns a cudaError_t code (0 on success).
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
