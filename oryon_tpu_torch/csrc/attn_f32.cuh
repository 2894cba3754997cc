// K1's f32 mode: attention on the lane-packed [B, L, 3C] rows in float32,
// for the small and tiny CLIP towers, which compute in f32.
//
// Replaces: oryon_tpu/ops/pallas/mha_lanes.py `_kernel` at an f32 qkv (the
// Pallas body is generic in dtype; the f32 towers run the same pallas_call).
// Its arithmetic at f32, kept here: the logits q . k in f32, with the scale
// folded into q when the multiply is exact (a power of two: head dim 16 or
// 64), otherwise applied to the logit; the additive key mask; exponentials,
// row sums and P V in f32; the division by the row sum last.  The TPU kernel
// takes the row maximum over all keys at once; this one keeps a running
// maximum and rescales (online softmax), which moves the result by a few
// ulps, not more.
//
// Design: plain CUDA cores, no tensor cores (f32 has none that keep full
// precision).  A block of 4 warps owns 16 query rows of one (image, head);
// each warp owns 4 of them.  Keys stream through shared memory in tiles of
// 32, one key a lane: a lane forms its key's logit for each of the warp's
// rows (q broadcast from shared memory, k row padded by one float against
// bank conflicts), the warp reduces the tile maximum and sum by shuffles,
// and each lane accumulates the output columns d = lane + 32 i of the rows
// (P broadcast by shuffle, V read across lanes).  L needs no alignment: keys
// at or past L are left out, query rows past L are not written.

#pragma once

#include <cuda_runtime.h>
#include <math.h>

namespace oryon_attn_f32 {

constexpr int kWarps = 4;
constexpr int kRowsPerWarp = 4;
constexpr int kRows = kWarps * kRowsPerWarp;   // query rows per block
constexpr int kKeys = 32;                      // keys per tile, one a lane
constexpr int kThreads = kWarps * 32;

__device__ __forceinline__ float warp_max(float x) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, off));
  return x;
}

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) x += __shfl_xor_sync(0xffffffffu, x, off);
  return x;
}

// grid (ceil(L / kRows), heads, B); qkv [B, L, 3C], kmask [L], out [B, L, C].
template <int HD>
__global__ void __launch_bounds__(kThreads)
mha_lanes_f32_kernel(const float* __restrict__ qkv, const float* __restrict__ kmask,
                     float* __restrict__ out, int L, int C, float scale, int fold) {
  constexpr int kCols = (HD + 31) / 32;   // output columns a lane owns
  __shared__ float qs[kRows][HD];
  __shared__ float ks[kKeys][HD + 1];
  __shared__ float vs[kKeys][HD];

  const int r0 = blockIdx.x * kRows;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const size_t rs = size_t(3) * C;
  const float* base = qkv + size_t(b) * L * rs + size_t(h) * HD;

  for (int i = threadIdx.x; i < kRows * HD; i += kThreads) {
    const int r = i / HD, d = i % HD;
    const float x = r0 + r < L ? base[size_t(r0 + r) * rs + d] : 0.f;
    qs[r][d] = fold ? x * scale : x;
  }

  float m[kRowsPerWarp], l[kRowsPerWarp], o[kRowsPerWarp][kCols];
#pragma unroll
  for (int r = 0; r < kRowsPerWarp; ++r) {
    m[r] = -INFINITY;
    l[r] = 0.f;
#pragma unroll
    for (int c = 0; c < kCols; ++c) o[r][c] = 0.f;
  }

  for (int k0 = 0; k0 < L; k0 += kKeys) {
    __syncthreads();   // the previous tile is consumed (and q is stored)
    for (int i = threadIdx.x; i < kKeys * HD; i += kThreads) {
      const int j = i / HD, d = i % HD;
      const bool live = k0 + j < L;
      const float* row = base + size_t(k0 + j) * rs;
      ks[j][d] = live ? row[C + d] : 0.f;
      vs[j][d] = live ? row[2 * C + d] : 0.f;
    }
    __syncthreads();
    const bool live = k0 + lane < L;   // lane 0 is always live: k0 < L
    const float add = live ? kmask[k0 + lane] : 0.f;
#pragma unroll
    for (int r = 0; r < kRowsPerWarp; ++r) {
      const float* q = qs[warp * kRowsPerWarp + r];
      float s = 0.f;
#pragma unroll 8
      for (int d = 0; d < HD; ++d) s = fmaf(q[d], ks[lane][d], s);
      if (!fold) s *= scale;
      s = live ? s + add : -INFINITY;
      const float m_new = fmaxf(m[r], warp_max(s));
      const float alpha = expf(m[r] - m_new);   // 0 on the first tile
      const float p = expf(s - m_new);          // 0 for a key past L
      l[r] = l[r] * alpha + warp_sum(p);
      m[r] = m_new;
#pragma unroll
      for (int c = 0; c < kCols; ++c) o[r][c] *= alpha;
      for (int j = 0; j < kKeys; ++j) {
        const float pj = __shfl_sync(0xffffffffu, p, j);
#pragma unroll
        for (int c = 0; c < kCols; ++c) {
          const int d = lane + 32 * c;
          if (d < HD) o[r][c] = fmaf(pj, vs[j][d], o[r][c]);
        }
      }
    }
  }

#pragma unroll
  for (int r = 0; r < kRowsPerWarp; ++r) {
    const int row = r0 + warp * kRowsPerWarp + r;
    if (row >= L) continue;
    float* dst = out + (size_t(b) * L + row) * C + size_t(h) * HD;
#pragma unroll
    for (int c = 0; c < kCols; ++c) {
      const int d = lane + 32 * c;
      if (d < HD) dst[d] = o[r][c] / l[r];
    }
  }
}

// True when x * scale is exact for every float x (scale a power of two).
inline bool exact_scale(float scale) {
  int e = 0;
  return scale != 0.f && isfinite(scale) && frexpf(fabsf(scale), &e) == 0.5f;
}

inline cudaError_t launch(const float* qkv, const float* kmask, float* out, int B,
                          int L, int C, int heads, float scale,
                          cudaStream_t stream) {
  const dim3 grid((L + kRows - 1) / kRows, heads, B);
  const int fold = exact_scale(scale) ? 1 : 0;
  switch (C / heads) {
    case 16:
      mha_lanes_f32_kernel<16><<<grid, kThreads, 0, stream>>>(qkv, kmask, out, L, C, scale, fold);
      break;
    case 32:
      mha_lanes_f32_kernel<32><<<grid, kThreads, 0, stream>>>(qkv, kmask, out, L, C, scale, fold);
      break;
    case 64:
      mha_lanes_f32_kernel<64><<<grid, kThreads, 0, stream>>>(qkv, kmask, out, L, C, scale, fold);
      break;
    case 128:
      mha_lanes_f32_kernel<128><<<grid, kThreads, 0, stream>>>(qkv, kmask, out, L, C, scale, fold);
      break;
    default:
      return cudaErrorInvalidValue;
  }
  return cudaGetLastError();
}

}  // namespace oryon_attn_f32
