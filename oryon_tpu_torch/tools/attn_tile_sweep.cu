// Tile configurations of the wgmma attention kernel (csrc/attn_wgmma.cuh) for
// tools/attn_tile_sweep.py: K1 on packed [B, L, 3C] rows under each
// (consumer warpgroups, keys a tile, ring stages, resident blocks asked for).
// Not part of the kernel library: the sweep builds this file by itself.

#include "../csrc/attn_wgmma.cuh"

#define ORYON_SWEEP_CONFIGS(X) \
  X(0, 2, 64, 4, 2)            \
  X(1, 1, 64, 4, 4)            \
  X(2, 2, 128, 2, 2)           \
  X(3, 1, 128, 2, 3)           \
  X(4, 2, 64, 2, 2)            \
  X(5, 2, 64, 3, 2)            \
  X(6, 2, 64, 6, 2)            \
  X(7, 1, 64, 4, 3)            \
  X(8, 2, 128, 2, 1)           \
  X(9, 1, 128, 2, 2)

// The configuration of index cfg as four ints; returns 0, or -1 past the end.
extern "C" int oryon_sweep_config(int cfg, int* out) {
  switch (cfg) {
#define X(id, c, bk, st, mb) \
  case id: out[0] = c; out[1] = bk; out[2] = st; out[3] = mb; return 0;
    ORYON_SWEEP_CONFIGS(X)
#undef X
    default: return -1;
  }
}

// K1 under configuration cfg; arguments as oryon_fused_mha_lanes_wgmma_bf16.
extern "C" int oryon_sweep_packed(int cfg, const void* qkv, const void* kmask,
                                  void* out, int B, int L, int C, int heads,
                                  float scale, void* stream) {
  switch (cfg) {
#define X(id, c, bk, st, mb)                                            \
  case id:                                                              \
    return int(oryon_attn_wg::launch_packed<c, bk, st, mb>(             \
        qkv, kmask, out, B, L, C, heads, scale,                         \
        static_cast<cudaStream_t>(stream)));
    ORYON_SWEEP_CONFIGS(X)
#undef X
    default: return int(cudaErrorInvalidValue);
  }
}
