// K1's f32 mode and its backward at the small and tiny towers' shapes (L <=
// 128, head dims 16 and 32): the one-block-a-head kernels of
// attn_f32_head.cuh and attn_bwd_f32_head.cuh.  Their own source file, so
// that they build beside mha_lanes.cu; the library compiles every .cu in
// parallel.

#include "attn_bwd_f32_head.cuh"

// qkv [B, L, 3C] f32, kmask [L] f32, out [B, L, C] f32, all contiguous and
// 16-byte aligned; 1 <= L <= 128, C / heads in {16, 32}.
extern "C" int oryon_fused_mha_lanes_f32_head(const void* qkv, const void* kmask, void* out,
                                              int B, int L, int C, int heads, float scale,
                                              void* stream) {
  return int(oryon_attn_f32_head::launch(qkv, static_cast<const float*>(kmask),
                                         static_cast<float*>(out), B, L, C, heads, scale,
                                         static_cast<cudaStream_t>(stream)));
}

// K1's backward there: qkv [B, L, 3C] and dout [B, L, C] f32, kmask [L] f32
// in; dqkv [B, L, 3C] f32 out.  When kmask needs a gradient: slab [B * heads,
// L] f32 scratch, counter one unsigned int that is 0 (and is 0 again after
// the kernel), dkmask [L] f32 out; otherwise all three null.
extern "C" int oryon_mha_lanes_bwd_f32_head(const void* qkv, const void* kmask,
                                            const void* dout, void* dqkv, void* slab,
                                            void* counter, void* dkmask, int B, int L, int C,
                                            int heads, float scale, void* stream) {
  return int(oryon_attn_bwd_f32_head::launch(
      qkv, dout, static_cast<const float*>(kmask), static_cast<float*>(dqkv),
      static_cast<float*>(slab), static_cast<unsigned int*>(counter),
      static_cast<float*>(dkmask), B, L, C, heads, scale, static_cast<cudaStream_t>(stream)));
}
