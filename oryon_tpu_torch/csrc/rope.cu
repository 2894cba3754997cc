// 2D rotary position embedding of the EVA02-CLIP vision tower (kernel R1),
// in place on q and k of the packed [B, L, 3C] in_proj output, ahead of K1.
//
// Replaces no TPU kernel: the JAX package has no EVA02 tower.  It was added
// because the rotation in plain PyTorch is about ten launches and three
// extra passes over q and k a block (slices, the pair swap, two products,
// the sum, the cast, the copy back), 24 times a forward.
//
// What it computes: for every image b, patch row p = 1..L-1 (the class row 0
// is not rotated) and every head of q and of k, with the f32 tables cos / sin
// [L-1, hd] that the model builds (head dims 0..hd/2-1 carry the row angles,
// the rest the column angles; each frequency repeated for an interleaved
// pair):
//   out[2i]   = x[2i]   * cos[2i]   + (-x[2i+1]) * sin[2i]
//   out[2i+1] = x[2i+1] * cos[2i+1] +   x[2i]    * sin[2i+1]
// in f32, each product and the sum rounded on its own (no fused multiply-add,
// so the result is the plain version's bit for bit), then one rounding to the
// storage type.  v and the class row are left untouched.
//
// What bounds it on an H100: memory.  At the EVA tower's shape (16 images of
// 577 tokens, C = 1024) q and k of the patch rows are 37.7 MB, read once and
// written once (75.5 MB, 22.5 us at 3.35 TB/s); the tables are 0.3 MB and
// stay in L2; three operations an element are nothing against the bytes.
//
// Design: one block of 256 threads per (image, patch row) and column chunk;
// each thread moves 16 bytes (8 bf16 or 4 f32, whole pairs of one head) with
// one vector load and one vector store, and reads its cos / sin entries as
// float4s.  One launch a block of the tower.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>
#include <string.h>

namespace {

constexpr int kThreads = 256;

__device__ __forceinline__ float to_f32(__nv_bfloat16 v) { return __bfloat162float(v); }
__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ void store_f32(float v, __nv_bfloat16* o) { *o = __float2bfloat16_rn(v); }
__device__ __forceinline__ void store_f32(float v, float* o) { *o = v; }

template <typename T>
__global__ void __launch_bounds__(kThreads)
rope_qk_kernel(T* __restrict__ qkv, const float* __restrict__ cos_t,
               const float* __restrict__ sin_t, int L, int C, int hd) {
  constexpr int kVec = 16 / sizeof(T);
  const int rows = L - 1;
  const int n = blockIdx.x / rows;
  const int p = blockIdx.x % rows;
  const int col = (blockIdx.y * kThreads + threadIdx.x) * kVec;    // in [0, 2C): q | k
  if (col >= 2 * C) return;
  T* ptr = qkv + (size_t(n) * L + 1 + p) * 3 * size_t(C) + col;
  const int d = col % hd;
  const float4* cs = reinterpret_cast<const float4*>(cos_t + size_t(p) * hd + d);
  const float4* sn = reinterpret_cast<const float4*>(sin_t + size_t(p) * hd + d);

  const uint4 raw = *reinterpret_cast<const uint4*>(ptr);
  T x[kVec];
  memcpy(x, &raw, sizeof(raw));
  float c[kVec], s[kVec];
#pragma unroll
  for (int i = 0; i < kVec / 4; ++i) {
    const float4 a = __ldg(cs + i), b = __ldg(sn + i);
    c[4 * i] = a.x; c[4 * i + 1] = a.y; c[4 * i + 2] = a.z; c[4 * i + 3] = a.w;
    s[4 * i] = b.x; s[4 * i + 1] = b.y; s[4 * i + 2] = b.z; s[4 * i + 3] = b.w;
  }
#pragma unroll
  for (int i = 0; i < kVec; i += 2) {
    const float x0 = to_f32(x[i]), x1 = to_f32(x[i + 1]);
    const float y0 = __fadd_rn(__fmul_rn(x0, c[i]), __fmul_rn(-x1, s[i]));
    const float y1 = __fadd_rn(__fmul_rn(x1, c[i + 1]), __fmul_rn(x0, s[i + 1]));
    store_f32(y0, &x[i]);
    store_f32(y1, &x[i + 1]);
  }
  uint4 out;
  memcpy(&out, x, sizeof(out));
  *reinterpret_cast<uint4*>(ptr) = out;
}

template <typename T>
int launch(void* qkv, const void* cos_t, const void* sin_t, int B, int L, int C, int hd,
           void* stream) {
  constexpr int kVec = 16 / sizeof(T);
  if (B <= 0 || L <= 1) return 0;
  if (hd % kVec || C % hd || C % kVec) return int(cudaErrorInvalidValue);
  const long long rows = (long long)B * (L - 1);
  if (rows > 0x7fffffffLL) return int(cudaErrorInvalidValue);
  const dim3 grid(unsigned(rows), unsigned((2 * C / kVec + kThreads - 1) / kThreads));
  rope_qk_kernel<T><<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<T*>(qkv), static_cast<const float*>(cos_t), static_cast<const float*>(sin_t),
      L, C, hd);
  return int(cudaGetLastError());
}

}  // namespace

// qkv: [B, L, 3C] contiguous, 16-byte aligned; cos, sin: [L - 1, hd] f32.
extern "C" int oryon_rope_qk_bf16(void* qkv, const void* cos_t, const void* sin_t, int B,
                                  int L, int C, int hd, void* stream) {
  return launch<__nv_bfloat16>(qkv, cos_t, sin_t, B, L, C, hd, stream);
}

extern "C" int oryon_rope_qk_f32(void* qkv, const void* cos_t, const void* sin_t, int B,
                                 int L, int C, int hd, void* stream) {
  return launch<float>(qkv, cos_t, sin_t, B, L, C, hd, stream);
}
