// Block configurations of the tensor-core matchers for
// tools/match_tile_sweep.py: K2's bf16 mode (csrc/match_wgmma.cuh) under each
// (consumer warpgroups a block, ring stages, resident blocks asked for,
// accumulator sets a warpgroup), and its fp32 mode (csrc/match_tf32.cuh)
// under each (consumer warpgroups, ring stages, resident blocks).  Not part
// of the kernel library: the sweep builds this file by itself.

#include "../csrc/match_tf32.cuh"
#include "../csrc/match_wgmma.cuh"

#define ORYON_SWEEP_CONFIGS(X) \
  X(0, 2, 4, 2, 1)             \
  X(1, 4, 4, 1, 1)             \
  X(2, 3, 4, 1, 1)             \
  X(3, 1, 4, 4, 1)             \
  X(4, 2, 2, 2, 1)             \
  X(5, 2, 6, 2, 1)             \
  X(6, 2, 4, 1, 2)             \
  X(7, 3, 4, 1, 2)             \
  X(8, 2, 6, 1, 2)             \
  X(9, 1, 4, 2, 2)             \
  X(10, 1, 4, 3, 2)

// The configuration of index cfg as four ints; returns 0, or -1 past the end.
extern "C" int oryon_match_sweep_config(int cfg, int* out) {
  switch (cfg) {
#define X(id, c, st, mb, sets) \
  case id: out[0] = c; out[1] = st; out[2] = mb; out[3] = sets; return 0;
    ORYON_SWEEP_CONFIGS(X)
#undef X
    default: return -1;
  }
}

// K2 (bf16) under configuration cfg; arguments as
// oryon_masked_argmin_wgmma_bf16 without D.
extern "C" int oryon_match_sweep(int cfg, const void* src, const void* tgt,
                                 const void* bad, void* tgt16, void* idx_map,
                                 void* counts, void* part_best, void* part_pos,
                                 void* out_min, void* out_arg, int P, int S, int N,
                                 int splits, int phases, void* stream) {
  switch (cfg) {
#define X(id, c, st, mb, sets)                                               \
  case id:                                                                   \
    return int(oryon_match_wg::launch<c, st, mb, sets>(                      \
        src, tgt, bad, tgt16, idx_map, counts, part_best, part_pos, out_min, \
        out_arg, P, S, N, splits, phases, static_cast<cudaStream_t>(stream)));
    ORYON_SWEEP_CONFIGS(X)
#undef X
    default: return int(cudaErrorInvalidValue);
  }
}

#define ORYON_SWEEP_TF32_CONFIGS(X) \
  X(0, 2, 2, 2)                     \
  X(1, 2, 2, 1)                     \
  X(2, 2, 3, 1)                     \
  X(3, 1, 2, 2)                     \
  X(4, 1, 4, 1)                     \
  X(5, 3, 2, 1)                     \
  X(6, 4, 2, 1)                     \
  X(7, 4, 4, 1)

// The fp32 mode's configuration of index cfg as three ints (the fourth 1);
// returns 0, or -1 past the end.
extern "C" int oryon_match_sweep_tf32_config(int cfg, int* out) {
  switch (cfg) {
#define X(id, c, st, mb) \
  case id: out[0] = c; out[1] = st; out[2] = mb; out[3] = 1; return 0;
    ORYON_SWEEP_TF32_CONFIGS(X)
#undef X
    default: return -1;
  }
}

// K2 (fp32) under configuration cfg; arguments as
// oryon_masked_argmin_wgmma_tf32x3 without D.
extern "C" int oryon_match_sweep_tf32(int cfg, const void* src, const void* tgt,
                                      const void* bad, void* rows, void* idx_map,
                                      void* counts, void* part_best, void* part_pos,
                                      void* out_min, void* out_arg, int P, int S, int N,
                                      int splits, int phases, void* stream) {
  switch (cfg) {
#define X(id, c, st, mb)                                                        \
  case id:                                                                      \
    return int(oryon_match_wg::launch_tf32x3<c, st, mb>(                        \
        src, tgt, bad, rows, idx_map, counts, part_best, part_pos, out_min,     \
        out_arg, P, S, N, splits, phases, static_cast<cudaStream_t>(stream)));
    ORYON_SWEEP_TF32_CONFIGS(X)
#undef X
    default: return int(cudaErrorInvalidValue);
  }
}
