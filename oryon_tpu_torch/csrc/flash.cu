// Flash multi-head attention on [B, H, L, D] rows with segment ids (K5).
//
// Replaces: oryon_tpu/ops/flash.py::flash_mha and flash_mha_padded, which run
// the stock Pallas TPU flash-attention kernel (`_run_flash`): the opt-in
// attention of the CLIP vision tower under ModelConfig.attn_impl="flash".
//
// What it computes: softmax(q k^T * sm_scale) v over the last two axes, where
// query i of image b sees key j only if seg[b, i] == seg[b, j] (the tower pads
// 577 tokens to 640 and gives the padding its own segment, so padding rows
// attend among themselves and stay finite).  Without segment ids every key
// below L is seen, and L may be any length: the ragged last tile is masked
// here instead of padding L to 128 as the TPU wrapper did.
//
// What bounds it on an H100: as K1 (mha_lanes.cu), 4*L*L*D FLOPs per (image,
// head) against 4*L*D*2 bytes, so the tensor cores once the logits stay on
// chip.  The head-split transposes that feed this layout are the caller's and
// cost device-memory passes that K1 avoids; that is why "fused" is the default.
//
// Design: at D = 64 the wgmma kernel of attn_wgmma.cuh (S, P and O in
// registers, K and V tiles through a TMA ring; one tensor map each for q, k
// and v over [B*H, L, 64]), at D = 16, 32 and 128 the WMMA streaming kernel
// of attn_stream.cuh; both with the segment comparison in place of the
// additive mask.  A row whose first key tiles are all masked keeps exact zero
// weights until its first visible key (the running max is guarded against
// -inf - -inf).

#include "attn_stream.cuh"
#include "attn_wgmma.cuh"

// q, k, v, out [B, H, L, D] bf16 contiguous, D in {16, 32, 128} (the WMMA
// kernel); seg [B, L] int32 or null.  Returns a cudaError_t code (0 on
// success).
extern "C" int oryon_flash_mha_bf16(const void* q, const void* k, const void* v,
                                    const void* seg, void* out, int B, int H,
                                    int L, int D, float sm_scale,
                                    void* stream) {
  using namespace oryon_attn;
  if (B <= 0 || H <= 0 || L <= 0) return int(cudaErrorInvalidValue);
  AttnParams p{};
  p.q = static_cast<const __nv_bfloat16*>(q);
  p.k = static_cast<const __nv_bfloat16*>(k);
  p.v = static_cast<const __nv_bfloat16*>(v);
  p.out = static_cast<__nv_bfloat16*>(out);
  p.sb = p.ob = (long long)H * L * D;
  p.sh = p.oh = (long long)L * D;
  p.sr = p.orow = D;
  p.seg = static_cast<const int*>(seg);
  p.L = L;
  p.heads = H;
  p.scale = sm_scale;
  return int(launch_hd<kSegments>(D, p, B, static_cast<cudaStream_t>(stream)));
}

// The same at D = 64 (the wgmma kernel); q, k and v 16-byte aligned.
extern "C" int oryon_flash_mha_wgmma_bf16(const void* q, const void* k,
                                          const void* v, const void* seg,
                                          void* out, int B, int H, int L, int D,
                                          float sm_scale, void* stream) {
  if (B <= 0 || H <= 0 || L <= 0 || D != oryon_attn_wg::kHD) {
    return int(cudaErrorInvalidValue);
  }
  return int(oryon_attn_wg::launch_split(q, k, v, seg, out, B, H, L, sm_scale,
                                         static_cast<cudaStream_t>(stream)));
}
