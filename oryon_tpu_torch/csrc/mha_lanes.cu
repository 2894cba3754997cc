// Fused multi-head attention on the lane-packed [B, L, 3C] in_proj output.
//
// Replaces: oryon_tpu/ops/pallas/mha_lanes.py::fused_mha_lanes_qkv (the
// Pallas TPU kernel `_kernel`): with qk_int8=False the default attention of
// the CLIP vision tower (ModelConfig.attn_impl="fused", kernel K1), with
// qk_int8=True its int8-logit variant (attn_impl="fused_i8qk", kernel K1-i8).
//
// What bounds it on an H100: per (image, head) the work is 4*L*L*hd FLOPs
// (two L x L x hd products) against 3*L*hd*2 bytes of q/k/v read once, so at
// the ViT-L shape (L=577, hd=64) it is compute-bound on the tensor cores once
// the L x L logits stay on chip.  The TPU kernel held the whole [L, L] score
// matrix of one head in VMEM; a Hopper SM has at most 227 KB of shared
// memory, so that does not carry over.
//
// Design, head dimension 64 (the ViT-L tower), bf16 logits: the wgmma kernel
// of attn_wgmma.cuh.  One warpgroup owns 64 query rows of one head of one
// image; S, P and O stay in registers (wgmma m64n64k16, P as the register A
// operand, V through the transposed-B descriptor); a producer warp streams K
// and V tiles through a ring of shared-memory stages with TMA, straight from
// the packed rows (one tensor map over [B, L, 3C]; columns h*64, C + h*64
// and 2C + h*64), so no q/k/v split or head transpose ever touches device
// memory and the zero fill past row L keeps a tile out of the next image.
//
// Design, every other head dimension (16, 32, 128), with bf16 or int8 logits:
// the WMMA kernel of attn_stream.cuh, flash-attention style streaming with
// one block of 4 warps per 64 query rows, keys in tiles of 64, S, P and O
// passed through shared memory, no overlap of loads and products.
//
// Both keep the TPU kernel's arithmetic: f32 online softmax (running max and
// sum per row), exponentials rounded to bf16 before the P V product, the row
// sum adding the rounded values, normalisation deferred to the end.  L need
// not be aligned: keys at or past L get -inf, query rows past L are not
// written.  The additive key mask (0 for real keys, -1e9 for padding) is
// applied in f32.
//
// K1-i8: q * scale and k are quantised to int8 by the absmax of the whole
// [L, hd] slab of one (image, head), but that head is spread over L / 64
// query-tile blocks, so the maxima are taken by a small pre-pass kernel (one
// block per (image, head)) into a [B, heads, 2] f32 scratch that the wrapper
// allocates; it re-reads q and k once (2/3 of the input) from L2 or device
// memory.  The logits are int8 x int8 -> int32 tensor-core sums, descaled by
// qm * km / 127^2 where the softmax applies the mask.  P V stays bf16.
//  * Head dimension 64: a second pre-pass kernel quantises q * scale and k
//    once (round half to even, the reference's order of multiplies) into a
//    [B, L, 2C] int8 scratch, 21 MB written against 42 MB read at the ViT-L
//    shape, and the main kernel is the int8 mode of attn_wgmma.cuh: Q and K
//    tiles of codes through TMA, `wgmma` m64n64k32.s32.s8.s8 for the logits.
//    Quantising in the main kernel instead would do it once per query-tile
//    block, ten times a head, on the CUDA cores that the softmax needs.
//  * Head dimensions 16, 32 and 128: each block of the WMMA kernel quantises
//    its Q tile and every K tile while copying them to shared memory.
//
// f32 qkv (the small and tiny towers compute in f32): the CUDA-core kernel
// of attn_f32.cuh at head dimensions 16, 32, 64 and 128, with the TPU
// kernel's f32 arithmetic (see there).
//
// The backward (d qkv and d kmask, for the towers under train_towers; the
// same for K1 and K1-i8, whose gradient is straight-through): attn_bwd.cuh,
// tensor cores at bf16 and CUDA cores at f32, head dimensions 16-128.

#include "attn_bwd.cuh"
#include "attn_f32.cuh"
#include "attn_stream.cuh"
#include "attn_wgmma.cuh"

namespace {

using namespace oryon_attn;

// max|q * scale| and max|k| over the [L, hd] slab of one (image, head), each
// floored at 1e-12: out[b, h, 0] and out[b, h, 1].
template <int HD>
__global__ void __launch_bounds__(256)
qk_absmax_kernel(const __nv_bfloat16* __restrict__ qkv, float* __restrict__ out,
                 int L, int C, float scale) {
  constexpr int kVec = HD / 8;
  const int h = blockIdx.x;
  const int b = blockIdx.y;
  const __nv_bfloat16* base = qkv + size_t(b) * L * 3 * C + h * HD;
  float qm = 0.f, km = 0.f;
#pragma unroll 4  // more loads in flight: the pass is bound by memory latency
  for (int idx = threadIdx.x; idx < L * kVec; idx += blockDim.x) {
    const __nv_bfloat16* rowp = base + size_t(idx / kVec) * 3 * C + (idx % kVec) * 8;
    const uint4 qv = *reinterpret_cast<const uint4*>(rowp);
    const uint4 kv = *reinterpret_cast<const uint4*>(rowp + C);
    const __nv_bfloat16* qx = reinterpret_cast<const __nv_bfloat16*>(&qv);
    const __nv_bfloat16* kx = reinterpret_cast<const __nv_bfloat16*>(&kv);
#pragma unroll
    for (int e = 0; e < 8; ++e) {
      qm = fmaxf(qm, fabsf(__bfloat162float(qx[e]) * scale));
      km = fmaxf(km, fabsf(__bfloat162float(kx[e])));
    }
  }
  __shared__ float red[2][8];
  for (int off = 16; off > 0; off >>= 1) {
    qm = fmaxf(qm, __shfl_xor_sync(0xffffffffu, qm, off));
    km = fmaxf(km, __shfl_xor_sync(0xffffffffu, km, off));
  }
  if (threadIdx.x % 32 == 0) {
    red[0][threadIdx.x / 32] = qm;
    red[1][threadIdx.x / 32] = km;
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    for (int w = 1; w < 8; ++w) {
      qm = fmaxf(qm, red[0][w]);
      km = fmaxf(km, red[1][w]);
    }
    out[(size_t(b) * gridDim.x + h) * 2] = fmaxf(qm, 1e-12f);
    out[(size_t(b) * gridDim.x + h) * 2 + 1] = fmaxf(km, 1e-12f);
  }
}

// The int8 codes of q * scale and k: codes[b, l, c] = rn((x * pre) * r) for
// the first 2C columns of a qkv row (q | k), pre = scale for q and 1 for k,
// r = 127 / absmax of the column's (image, head): two f32 multiplies in this
// order and round half to even, as the reference does.  Eight values a thread.
__global__ void __launch_bounds__(256)
qk_quantise_kernel(const __nv_bfloat16* __restrict__ qkv,
                   const float* __restrict__ absmax,
                   signed char* __restrict__ codes, int B, int L, int C,
                   int heads, float scale) {
  const int vecs = 2 * C / 8;  // 16-byte vectors of q | k in a row
  const long long idx = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= (long long)B * L * vecs) return;
  const long long row = idx / vecs;  // b * L + l
  const int col = int(idx % vecs) * 8;
  const int b = int(row / L);
  const int is_k = col >= C;
  const int h = (col - is_k * C) / (C / heads);
  const float pre = is_k ? 1.0f : scale;
  const float r = 127.0f / absmax[(size_t(b) * heads + h) * 2 + is_k];
  const uint4 raw = *reinterpret_cast<const uint4*>(qkv + row * 3 * C + col);
  const __nv_bfloat16* x = reinterpret_cast<const __nv_bfloat16*>(&raw);
  alignas(8) signed char qv[8];
#pragma unroll
  for (int e = 0; e < 8; ++e) {
    const float f = __bfloat162float(x[e]) * pre;
    qv[e] = static_cast<signed char>(__float2int_rn(f * r));
  }
  *reinterpret_cast<uint2*>(codes + row * 2 * C + col) =
      *reinterpret_cast<const uint2*>(qv);
}

AttnParams packed_params(const void* qkv, const void* kmask, void* out, int L,
                         int C, int heads, float scale) {
  const auto* base = static_cast<const __nv_bfloat16*>(qkv);
  AttnParams p{};
  p.q = base;
  p.k = base + C;
  p.v = base + 2 * C;
  p.out = static_cast<__nv_bfloat16*>(out);
  p.sb = (long long)L * 3 * C;
  p.sh = C / heads;
  p.sr = 3 * C;
  p.ob = (long long)L * C;
  p.oh = C / heads;
  p.orow = C;
  p.kmask = static_cast<const float*>(kmask);
  p.L = L;
  p.heads = heads;
  p.scale = scale;
  return p;
}

}  // namespace

// qkv [B, L, 3C] bf16, kmask [L] f32, out [B, L, C] bf16, all contiguous;
// C / heads in {16, 32, 128} (the WMMA kernel).  Returns a cudaError_t code
// (0 on success).
extern "C" int oryon_fused_mha_lanes_bf16(const void* qkv, const void* kmask,
                                          void* out, int B, int L, int C,
                                          int heads, float scale,
                                          void* stream) {
  if (B <= 0 || L <= 0 || heads <= 0 || C % heads != 0) {
    return int(cudaErrorInvalidValue);
  }
  const AttnParams p = packed_params(qkv, kmask, out, L, C, heads, scale);
  return int(launch_hd<kKeyMask>(C / heads, p, B,
                                 static_cast<cudaStream_t>(stream)));
}

// The same at C / heads = 64 (the wgmma kernel); qkv 16-byte aligned.
extern "C" int oryon_fused_mha_lanes_wgmma_bf16(const void* qkv,
                                                const void* kmask, void* out,
                                                int B, int L, int C, int heads,
                                                float scale, void* stream) {
  if (B <= 0 || L <= 0 || heads <= 0 || C != heads * oryon_attn_wg::kHD) {
    return int(cudaErrorInvalidValue);
  }
  return int(oryon_attn_wg::launch_packed(qkv, kmask, out, B, L, C, heads, scale,
                                          static_cast<cudaStream_t>(stream)));
}

// The same in f32: qkv [B, L, 3C] f32, kmask [L] f32, out [B, L, C] f32, all
// contiguous; C / heads in {16, 32, 64, 128} (the CUDA-core kernel).
extern "C" int oryon_fused_mha_lanes_f32(const void* qkv, const void* kmask,
                                         void* out, int B, int L, int C,
                                         int heads, float scale, void* stream) {
  if (B <= 0 || L <= 0 || heads <= 0 || C % heads != 0) {
    return int(cudaErrorInvalidValue);
  }
  return int(oryon_attn_f32::launch(
      static_cast<const float*>(qkv), static_cast<const float*>(kmask),
      static_cast<float*>(out), B, L, C, heads, scale,
      static_cast<cudaStream_t>(stream)));
}

// The same with int8 logits, C / heads in {16, 32, 128}.  absmax:
// [B, heads, 2] f32 scratch, written by the pre-pass and read by the main
// kernel on the same stream.
extern "C" int oryon_fused_mha_lanes_i8qk_bf16(const void* qkv,
                                               const void* kmask, void* absmax,
                                               void* out, int B, int L, int C,
                                               int heads, float scale,
                                               void* stream) {
  if (B <= 0 || L <= 0 || heads <= 0 || C % heads != 0) {
    return int(cudaErrorInvalidValue);
  }
  const auto* x = static_cast<const __nv_bfloat16*>(qkv);
  auto* am = static_cast<float*>(absmax);
  auto s = static_cast<cudaStream_t>(stream);
  const dim3 grid(heads, B);
  switch (C / heads) {
    case 16: qk_absmax_kernel<16><<<grid, 256, 0, s>>>(x, am, L, C, scale); break;
    case 32: qk_absmax_kernel<32><<<grid, 256, 0, s>>>(x, am, L, C, scale); break;
    case 128: qk_absmax_kernel<128><<<grid, 256, 0, s>>>(x, am, L, C, scale); break;
    default: return int(cudaErrorInvalidValue);
  }
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return int(err);
  AttnParams p = packed_params(qkv, kmask, out, L, C, heads, scale);
  p.absmax = am;
  return int(launch_hd<kKeyMaskI8>(C / heads, p, B, s));
}

// The same with int8 logits at C / heads = 64 (int8 wgmma).  absmax
// [B, heads, 2] f32 and codes [B, L, 2C] int8 are scratch: phase 1 (the
// pre-pass: absmax, then the codes) writes them, phase 2 (the attention
// kernel) reads them on the same stream.  phases = 3 runs both, as every
// caller but a measurement of one phase does.
extern "C" int oryon_fused_mha_lanes_i8qk_wgmma_bf16(
    const void* qkv, const void* kmask, void* absmax, void* codes, void* out,
    int B, int L, int C, int heads, float scale, int phases, void* stream) {
  if (B <= 0 || L <= 0 || heads <= 0 || C != heads * oryon_attn_wg::kHD ||
      (phases & ~3) != 0) {
    return int(cudaErrorInvalidValue);
  }
  auto s = static_cast<cudaStream_t>(stream);
  if (phases & 1) {
    const auto* x = static_cast<const __nv_bfloat16*>(qkv);
    auto* am = static_cast<float*>(absmax);
    qk_absmax_kernel<64><<<dim3(heads, B), 256, 0, s>>>(x, am, L, C, scale);
    cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return int(err);
    const long long threads = (long long)B * L * (2 * C / 8);
    qk_quantise_kernel<<<unsigned((threads + 255) / 256), 256, 0, s>>>(
        x, am, static_cast<signed char*>(codes), B, L, C, heads, scale);
    err = cudaGetLastError();
    if (err != cudaSuccess) return int(err);
  }
  if (phases & 2) {
    return int(oryon_attn_wg::launch_packed_i8(qkv, codes, absmax, kmask, out, B,
                                               L, C, heads, s));
  }
  return int(cudaSuccess);
}

namespace {

oryon_attn_bwd::BwdParams bwd_params(const void* qkv, const void* kmask, const void* dout,
                                     void* dqkv, void* stats, void* colsum, int L, int C,
                                     int heads, float scale) {
  oryon_attn_bwd::BwdParams p{};
  p.qkv = qkv;
  p.kmask = static_cast<const float*>(kmask);
  p.dout = dout;
  p.dqkv = dqkv;
  p.stats = static_cast<float*>(stats);
  p.colsum = static_cast<float*>(colsum);
  p.L = L;
  p.C = C;
  p.heads = heads;
  p.scale = scale;
  return p;
}

}  // namespace

// K1's backward: qkv [B, L, 3C] and dout [B, L, C] bf16, kmask [L] f32 in;
// dqkv [B, L, 3C] bf16 out; dkmask [L] f32 out, or null when kmask needs no
// gradient.  stats [3, B * heads * L] and colsum [B * heads, L] f32 are
// scratch.  All contiguous; C / heads in {16, 32, 64, 128}.
extern "C" int oryon_mha_lanes_bwd_bf16(const void* qkv, const void* kmask,
                                        const void* dout, void* dqkv, void* stats,
                                        void* colsum, void* dkmask, int B, int L,
                                        int C, int heads, float scale, void* stream) {
  if (B <= 0 || L <= 0 || heads <= 0 || C % heads != 0) {
    return int(cudaErrorInvalidValue);
  }
  return int(oryon_attn_bwd::launch<false>(
      bwd_params(qkv, kmask, dout, dqkv, stats, colsum, L, C, heads, scale), B,
      static_cast<float*>(dkmask), static_cast<cudaStream_t>(stream)));
}

// The same in f32 (qkv, dout and dqkv f32; the CUDA-core kernels).
extern "C" int oryon_mha_lanes_bwd_f32(const void* qkv, const void* kmask,
                                       const void* dout, void* dqkv, void* stats,
                                       void* colsum, void* dkmask, int B, int L,
                                       int C, int heads, float scale, void* stream) {
  if (B <= 0 || L <= 0 || heads <= 0 || C % heads != 0) {
    return int(cudaErrorInvalidValue);
  }
  return int(oryon_attn_bwd::launch<true>(
      bwd_params(qkv, kmask, dout, dqkv, stats, colsum, L, C, heads, scale), B,
      static_cast<float*>(dkmask), static_cast<cudaStream_t>(stream)));
}
