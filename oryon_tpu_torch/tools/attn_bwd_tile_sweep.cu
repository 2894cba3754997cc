// Configurations of the head-dim-64 backward kernels (csrc/attn_bwd_wgmma.cuh)
// for tools/attn_bwd_tile_sweep.py: the query-tile and the key-tile kernel
// under each (ring stages, resident blocks asked for).  Not part of the kernel
// library: the sweep builds this file by itself.

#include "../csrc/attn_bwd_wgmma.cuh"

// id, kernel (0 query-tile, 1 key-tile), ring stages, resident blocks asked
// for; the first of each kernel is the library's
#define ORYON_BWD_SWEEP_CONFIGS(X) \
  X(0, 0, 3, 3)                    \
  X(1, 0, 2, 3)                    \
  X(2, 0, 4, 2)                    \
  X(3, 1, 3, 3)                    \
  X(4, 1, 2, 3)                    \
  X(5, 1, 4, 2)                    \
  X(6, 1, 3, 2)

// The configuration of index cfg as three ints (kernel, stages, blocks);
// returns 0, or -1 past the end.
extern "C" int oryon_bwd_sweep_config(int cfg, int* out) {
  switch (cfg) {
#define X(id, k, st, mb) \
  case id: out[0] = k; out[1] = st; out[2] = mb; return 0;
    ORYON_BWD_SWEEP_CONFIGS(X)
#undef X
    default: return -1;
  }
}

template <int kKernel, int kStages, int kMinBlocks>
cudaError_t run_config(const oryon_attn_bwd_wg::Launch& x, cudaStream_t s) {
  if constexpr (kKernel == 0) {
    return oryon_attn_bwd_wg::launch_dq<kStages, kMinBlocks>(x, s);
  } else {
    return oryon_attn_bwd_wg::launch_dkv<kStages, kMinBlocks>(x, s);
  }
}

// One kernel under configuration cfg; arguments as
// oryon_mha_lanes_bwd_wgmma_bf16 without dkmask and phases.  The key-tile
// kernel reads the row statistics the query-tile kernel left in stats.
extern "C" int oryon_bwd_sweep_run(int cfg, const void* qkv, const void* kmask,
                                   const void* dout, void* dqkv, void* stats, void* colsum,
                                   int B, int L, int C, int heads, float scale, void* stream) {
  oryon_attn_bwd_wg::Launch x;
  cudaError_t err = oryon_attn_bwd_wg::prepare(x, qkv, kmask, dout, dqkv, stats, colsum,
                                               nullptr, B, L, C, heads, scale);
  if (err != cudaSuccess) return int(err);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (cfg) {
#define X(id, k, st, mb) \
  case id: return int(run_config<k, st, mb>(x, s));
    ORYON_BWD_SWEEP_CONFIGS(X)
#undef X
    default: return int(cudaErrorInvalidValue);
  }
}
