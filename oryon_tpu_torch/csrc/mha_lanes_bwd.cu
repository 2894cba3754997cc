// K1's backward at head dimension 64 in bf16: the wgmma + TMA kernels of
// attn_bwd_wgmma.cuh (the shape the ViT-L tower trains at under
// train_towers).  Its own source file, so that mha_lanes.cu builds as fast as
// before; the library compiles every .cu in parallel.

#include "attn_bwd_wgmma.cuh"

// qkv [B, L, 3C] and dout [B, L, C] bf16, kmask [L] f32 in; dqkv [B, L, 3C]
// bf16 out; dkmask [L] f32 out, or null when kmask needs no gradient.  stats
// [3, B * heads * Lp] (Lp: L rounded up to a multiple of 64; 16-byte
// aligned) and colsum [B * heads, L] f32 are scratch.  All contiguous;
// C / heads == 64.  `phases`: 1 the query-tile kernel (row
// statistics and dQ), 2 the key-tile kernel (dK, dV, and d kmask), 3 both.
extern "C" int oryon_mha_lanes_bwd_wgmma_bf16(const void* qkv, const void* kmask,
                                              const void* dout, void* dqkv, void* stats,
                                              void* colsum, void* dkmask, int B, int L,
                                              int C, int heads, float scale, int phases,
                                              void* stream) {
  return int(oryon_attn_bwd_wg::launch(qkv, kmask, dout, dqkv, stats, colsum, dkmask, B, L,
                                       C, heads, scale, phases,
                                       static_cast<cudaStream_t>(stream)));
}
