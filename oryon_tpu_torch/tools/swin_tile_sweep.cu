// Block configurations of the wgmma window-attention kernel
// (csrc/swin_wgmma.cuh) for tools/swin_tile_sweep.py: K3 and K4 under each
// (consumer warpgroups a block, ring stages, resident blocks asked for); the
// item order is a run-time argument.  Not part of the kernel library: the
// sweep builds this file by itself.

#include "../csrc/swin_wgmma.cuh"

#define ORYON_SWIN_SWEEP_CONFIGS(X) \
  X(0, 2, 4, 2)                     \
  X(1, 2, 2, 2)                     \
  X(2, 2, 6, 2)                     \
  X(3, 2, 8, 2)                     \
  X(4, 2, 4, 3)                     \
  X(5, 2, 2, 3)                     \
  X(6, 1, 2, 4)                     \
  X(7, 1, 4, 4)                     \
  X(8, 1, 3, 5)                     \
  X(9, 4, 4, 1)                     \
  X(10, 4, 8, 1)                    \
  X(11, 3, 6, 2)

// The configuration of index cfg as three ints; returns 0, or -1 past the end.
extern "C" int oryon_swin_sweep_config(int cfg, int* out) {
  switch (cfg) {
#define X(id, wg, st, mb) \
  case id: out[0] = wg; out[1] = st; out[2] = mb; return 0;
    ORYON_SWIN_SWEEP_CONFIGS(X)
#undef X
    default: return -1;
  }
}

// K3's attention kernel under configuration cfg on a bias already in bf16
// fragment order; the other arguments as launch_packed's.
extern "C" int oryon_swin_sweep_packed(int cfg, const void* q, const void* k,
                                       const void* v, const void* frag, void* out,
                                       int Bw, int nw, int N, int C, int heads,
                                       float scale, int order, void* stream) {
  switch (cfg) {
#define X(id, wg, st, mb)                                               \
  case id:                                                              \
    return int(oryon_swin_wg::launch_packed<wg, st, mb>(                \
        q, k, v, frag, out, Bw, nw, N, C, heads, scale, order,          \
        static_cast<cudaStream_t>(stream)));
    ORYON_SWIN_SWEEP_CONFIGS(X)
#undef X
    default: return int(cudaErrorInvalidValue);
  }
}

// K4's the same, on a bias in f32 fragment order.
extern "C" int oryon_swin_sweep_band(int cfg, const void* qkv_map, const void* frag,
                                     void* out, int B, int Hp, int Wp, int C,
                                     int heads, int window, float scale, int order,
                                     void* stream) {
  switch (cfg) {
#define X(id, wg, st, mb)                                               \
  case id:                                                              \
    return int(oryon_swin_wg::launch_band<wg, st, mb>(                  \
        qkv_map, frag, out, B, Hp, Wp, C, heads, window, scale, order,  \
        static_cast<cudaStream_t>(stream)));
    ORYON_SWIN_SWEEP_CONFIGS(X)
#undef X
    default: return int(cudaErrorInvalidValue);
  }
}
