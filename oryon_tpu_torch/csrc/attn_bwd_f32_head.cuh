// K1's backward in f32 at the small and tiny towers' shapes, designed for
// Hopper: one launch, one block an (image, head), which holds the head's
// whole L x L attention (L <= 128, head dims 16 and 32; the towers train at
// [64, 65, 192], 4 heads of 16).  Longer sequences and head dims 64 / 128
// stay on the two-kernel schedule of attn_bwd.cuh.
//
// Replaces: oryon_tpu/ops/pallas/mha_lanes.py `_bwd` (:180), jax.vjp of the
// plain `_reference_mha` (:104-117) in f32, as attn_bwd.cuh does.  Per (image,
// head), on the [L, hd] slabs q, k, v, dO:
//   S  = (q k^T) * scale + kmask       two roundings, as the reference
//   P  = softmax(S)                    the exact row max and row sum, then
//                                      exp(S - max) / sum
//   dP = dO v^T
//   D  = rowsum(P * dP)
//   dS = P (dP - D)
//   dV = P^T dO,  dQ = (dS * scale) K,  dK = (dS * scale)^T Q
//   d kmask = the sum of dS over images, heads and query rows
// Five products; S (then P) and dP (then dS, then dS * scale) stay in shared
// memory and nothing is recomputed.  The two-kernel schedule needs nine, a
// [3, B * heads * L] scratch of row statistics and a third kernel for d kmask,
// because there a block owns a strip of rows or keys, not a head.
//
// What bounds it on an H100: as the forward (attn_f32_head.cuh), a launch:
// at [64, 65, 192] the five products are 0.69 MFLOP a head, 2.6 us for all
// 256 heads at 67 TFLOP/s, and 8.5 MB move (2.5 us at 3.35 TB/s).
//
// Design: the forward's loads (four TMA boxes: q, k, v from the map over
// qkv, dO from a map over dout) and its two products of shared tiles
// (rows_dot_rows for S and dP, square_dot_tile for the three others, which
// write d qkv straight from registers).  Row passes (eight lanes a query
// row): the max, exp, sum and P; D and dS.  A column pass (two lanes a key):
// the key's sum of dS over the query rows, and dS * scale in place.
//
// d kmask in the same launch, deterministic: each block writes its keys' sums
// into its row of a [B * heads, L] slab, fences, and counts itself on a
// device counter; the block that takes the last count sums the slab's rows in
// index order into d kmask and puts the counter back to 0 for the next
// launch.  Whatever order the blocks finish in, every sum is taken in the
// same order, so two launches are bitwise equal, and nothing but the counter
// is written with an atomic.  One counter serves the launches of one stream
// in turn; launches on two streams at once would need two.

#pragma once

#include "attn_f32_head.cuh"

namespace oryon_attn_bwd_f32_head {

using namespace oryon_attn_f32_head;

// grid (B * heads); qkv through map_qkv, dout through map_o (3-D f32 maps,
// boxes of [n, HD]); kmask [L]; dqkv [B, L, 3C] out.  With a slab ([B *
// heads, L] scratch) also dkmask [L] out, counted on `counter` (0 before and
// after).
template <int HD>
__global__ void __launch_bounds__(kThreads)
mha_bwd_f32_head_kernel(const __grid_constant__ CUtensorMap map_qkv,
                        const __grid_constant__ CUtensorMap map_o,
                        const float* __restrict__ kmask, float* __restrict__ dqkv,
                        float* slab, unsigned int* counter,
                        float* __restrict__ dkmask, int L, int C, int heads, float scale) {
  extern __shared__ unsigned char smem_raw[];
  const Layout lay(L, HD, 4, 2, padded(L));
  float* base = reinterpret_cast<float*>(aligned_base(smem_raw));
  float* qs = base + lay.tiles_off;
  float* ks = qs + lay.tile_floats;
  float* vs = ks + lay.tile_floats;
  float* os = vs + lay.tile_floats;
  float* P = base + lay.squares_off;   // S, then P
  float* G = P + lay.square_floats;    // dP, then dS, then dS * scale
  float* km = base + lay.mask_off;
  auto* bar = reinterpret_cast<uint64_t*>(reinterpret_cast<unsigned char*>(base) + lay.bar_off);
  __shared__ bool last;
  const int n = lay.n, ld = lay.ld;
  const int b = blockIdx.x / heads, h = blockIdx.x % heads;

  for (int j = threadIdx.x; j < L; j += kThreads) km[j] = kmask[j];
  const CUtensorMap* maps[4] = {&map_qkv, &map_qkv, &map_qkv, &map_o};
  float* dst[4] = {qs, ks, vs, os};
  const int cols[4] = {h * HD, C + h * HD, 2 * C + h * HD, h * HD};
  load_tiles<HD, 4>(bar, maps, dst, cols, n, b);   // its barrier also publishes km

  rows_dot_rows<HD>(qs, 0, n, ks, n, [&](int i, int j, float s) {
    if (i < L && j < L) P[i * ld + j] = __fadd_rn(__fmul_rn(s, scale), km[j]);
  });
  rows_dot_rows<HD>(os, 0, n, vs, n, [&](int i, int j, float s) {
    if (i < L && j < L) G[i * ld + j] = s;
  });
  __syncthreads();

  // eight lanes a query row: P = exp(S - max) / sum, D = rowsum(P * dP), dS
  for_rows(L, [&](int i, bool live, int sub) {
    float* prow = P + i * ld;
    float* grow = G + i * ld;
    float v[kRowKeys];
    float m = -INFINITY;
#pragma unroll
    for (int t = 0; t < kRowKeys; ++t) {
      const int j = sub + kRowLanes * t;
      v[t] = live && j < L ? prow[j] : -INFINITY;
      m = fmaxf(m, v[t]);
    }
    m = group_max(m);
    float l = 0.f;
#pragma unroll
    for (int t = 0; t < kRowKeys; ++t) {
      v[t] = live && sub + kRowLanes * t < L ? expf(v[t] - m) : 0.f;
      l += v[t];
    }
    l = group_sum(l);
    float d = 0.f;
#pragma unroll
    for (int t = 0; t < kRowKeys; ++t) {
      const int j = sub + kRowLanes * t;
      if (live && j < L) {
        v[t] = v[t] / l;
        prow[j] = v[t];
        d += __fmul_rn(v[t], grow[j]);
      }
    }
    d = group_sum(d);
#pragma unroll
    for (int t = 0; t < kRowKeys; ++t) {
      const int j = sub + kRowLanes * t;
      if (live && j < L) grow[j] = __fmul_rn(v[t], __fsub_rn(grow[j], d));
    }
  });
  __syncthreads();

  // two lanes a key (2L <= kThreads): each sums dS over half the query rows
  // in order and scales them in place, then the halves are added
  {
    const int j = threadIdx.x / 2, half = (L + 1) / 2;
    const int i0 = threadIdx.x % 2 * half, i1 = min(L, i0 + half);
    float sum = 0.f;
    if (j < L) {
      for (int i = i0; i < i1; ++i) {
        const float x = G[i * ld + j];
        sum += x;
        G[i * ld + j] = __fmul_rn(x, scale);
      }
    }
    sum += __shfl_xor_sync(kFull, sum, 1);
    if (slab != nullptr && j < L && threadIdx.x % 2 == 0) slab[size_t(blockIdx.x) * L + j] = sum;
  }
  __syncthreads();

  // dV = P^T dO, dQ = (dS * scale) K, dK = (dS * scale)^T Q, rows past L left out
  const size_t rs = 3 * size_t(C);
  float* db = dqkv + size_t(b) * L * rs + h * HD;
  auto to = [&](int part) {
    return [=](int i, int c, float4 x) {
      *reinterpret_cast<float4*>(db + i * rs + part * C + 4 * c) = x;
    };
  };
  square_dot_tile<HD, true>(P, ld, os, L, L, to(2));
  square_dot_tile<HD, false>(G, ld, ks, L, L, to(0));
  square_dot_tile<HD, true>(G, ld, qs, L, L, to(1));

  if (slab == nullptr) return;
  __threadfence();   // this block's slab row, before its count
  __syncthreads();
  if (threadIdx.x == 0) last = atomicAdd(counter, 1u) == gridDim.x - 1;
  __syncthreads();
  if (!last) return;
  __threadfence();   // every other block's slab row, after its count
  for (int j = threadIdx.x; j < L; j += kThreads) {
    float sum = 0.f;
#pragma unroll 8
    for (unsigned r = 0; r < gridDim.x; ++r) sum += __ldcg(slab + size_t(r) * L + j);
    dkmask[j] = sum;
  }
  if (threadIdx.x == 0) *counter = 0u;
}

template <int HD>
static cudaError_t launch_bwd_hd(const void* qkv, const void* dout, const float* kmask,
                                 float* dqkv, float* slab, unsigned int* counter,
                                 float* dkmask, int B, int L, int C, int heads, float scale,
                                 cudaStream_t stream) {
  static bool configured = false;
  cudaError_t err = allow_smem(mha_bwd_f32_head_kernel<HD>,
                               Layout(kMaxL, HD, 4, 2, kMaxL).alloc, &configured);
  if (err != cudaSuccess) return err;
  CUtensorMap map_qkv, map_o;
  err = encode(&map_qkv, qkv, 3ull * C, L, B, HD);
  if (err == cudaSuccess) err = encode(&map_o, dout, uint64_t(C), L, B, HD);
  if (err != cudaSuccess) return err;
  mha_bwd_f32_head_kernel<HD><<<B * heads, kThreads, Layout(L, HD, 4, 2, padded(L)).alloc,
                                stream>>>(map_qkv, map_o, kmask, dqkv, slab, counter, dkmask,
                                          L, C, heads, scale);
  return cudaGetLastError();
}

// qkv [B, L, 3C] and dout [B, L, C] f32, kmask [L] f32 in; dqkv [B, L, 3C] f32
// out, all contiguous and 16-byte aligned; 1 <= L <= kMaxL, C / heads in
// {16, 32}.  d kmask: slab [B * heads, L] f32 scratch, counter one unsigned
// int that is 0, dkmask [L] f32 out; all three null when kmask needs no
// gradient.
static inline cudaError_t launch(const void* qkv, const void* dout, const float* kmask,
                                 float* dqkv, float* slab, unsigned int* counter,
                                 float* dkmask, int B, int L, int C, int heads, float scale,
                                 cudaStream_t stream) {
  if (B <= 0 || L <= 0 || L > kMaxL || heads <= 0 || C % heads != 0 ||
      reinterpret_cast<uintptr_t>(dqkv) % 16 != 0 ||
      (slab == nullptr) != (counter == nullptr) || (slab == nullptr) != (dkmask == nullptr)) {
    return cudaErrorInvalidValue;
  }
  switch (C / heads) {
    case 16:
      return launch_bwd_hd<16>(qkv, dout, kmask, dqkv, slab, counter, dkmask, B, L, C, heads,
                               scale, stream);
    case 32:
      return launch_bwd_hd<32>(qkv, dout, kmask, dqkv, slab, counter, dkmask, B, L, C, heads,
                               scale, stream);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace oryon_attn_bwd_f32_head
