// K1's f32 mode at the small and tiny towers' shapes, designed for Hopper:
// one block holds one (image, head) whole, L <= 128 and head dims 16 and 32
// (the towers run [B, 65, 192] and [B, 17, 192], 4 heads of 16).  Longer
// sequences and head dims 64 / 128 stay on the streaming kernel of
// attn_f32.cuh.
//
// Replaces: oryon_tpu/ops/pallas/mha_lanes.py `_kernel` (:45) at an f32 qkv,
// and keeps its layout and order of arithmetic (:67-101): a grid step there
// holds an image's whole [L, 3C] block and does each head at once, so here a
// block holds a head's q, k, v slices and its whole L x L logits.  Per head:
//   S = q k^T in f32, times scale, plus the key mask (the TPU kernel folds a
//       power-of-two scale into q first, which gives the same bits in f32:
//       scaling by a power of two commutes with rounding);
//   m = the exact maximum of each row over all keys (no running maximum and
//       no rescale, which the streaming kernel needs and which drifts a few
//       ulps from this order);
//   E = exp(S - m), l = the f32 row sum of E;
//   O = E V, divided by l last.
//
// What bounds it on an H100: nothing the card is short of.  Per head two
// L x L x hd products, 0.27 MFLOP at [65, 16], against 52 KB read and 17 KB
// written; at [64, 65, 192] the bytes take 1.3 us at 3.35 TB/s, the f32
// products 1.0 us on the CUDA cores, so the kernel's floor is a launch.  The
// streaming kernel paid for L = 65 in other ways: 5 blocks a head, each
// re-reading the head's K and V, and a rescale per key tile.  Here:
//
//  * Loads: one thread asks TMA for three boxes (q, k and v of the head, [n,
//    hd] f32 with n = L rounded up to 16) from one 3-D map over [B, L, 3C], so a
//    box never reads into the next image and rows past L arrive as zeros.
//    Rows of 64 bytes (hd 16) take the 64-byte swizzle and rows of 128 bytes
//    (hd 32) the 128-byte one; reading them back as 16-byte chunks, eight
//    neighbouring rows fall in distinct banks.
//  * Products on the CUDA cores in f32, from shared memory: TF32 tensor cores
//    cannot hold the 1e-5 gate, and three-way split TF32 (match_tf32.cuh)
//    would pay its bookkeeping where the products are not what sets the
//    pace.  S: each thread owns a 4 x 4 tile of rows and columns strided by
//    n / 4, so a warp reads neighbouring key rows; S lands in a square buffer
//    with an odd row stride (n + 1), so a column or a row of it reads without
//    conflicts.  O: each thread owns 4 columns of 4 rows, V broadcast along
//    a row; at head dim 16 two lanes split the keys and add their halves.
//  * Softmax: eight lanes a row, four rows a warp at once, each lane 16 keys
//    at most, the maximum and the sum by shuffles within the eight.
//  * 256 threads a block, one block an (image, head) or, when B * heads blocks
//    would leave SMs idle (serve_small's [4, 65, 192] is 16 heads, a served
//    batch of 8 64), a block a part of its query rows, 16 or more: a head's
//    time is the chain of its passes, which a part shortens.  A part reloads
//    K and V from L2, and its rows are computed as the whole head's would be,
//    so the output is the same bits whatever the split.  No block waits on
//    another.

#pragma once

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "hopper.cuh"

namespace oryon_attn_f32_head {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxL = 128;   // longest sequence a block holds
constexpr unsigned kFull = 0xffffffffu;

// rows of a head's tiles: L rounded up to 16 (4 x 4 thread tiles of S whose
// rows and columns stride n / 4, a multiple of 4)
__host__ __device__ constexpr int padded(int L) { return (L + 15) / 16 * 16; }

// 16-byte chunk c of row r of an [n, HD] f32 tile as TMA wrote it: 64-byte
// rows (HD 16) under the 64-byte swizzle put chunk c at c ^ ((r >> 1) & 3),
// 128-byte rows (HD 32) under the 128-byte swizzle at c ^ (r & 7).  The tile
// base is 1024-byte aligned.
template <int HD>
__device__ __forceinline__ float4 chunk(const float* tile, int r, int c) {
  static_assert(HD == 16 || HD == 32, "head dims 16 and 32");
  const int phys = HD == 16 ? c ^ ((r >> 1) & 3) : c ^ (r & 7);
  return *reinterpret_cast<const float4*>(tile + r * HD + phys * 4);
}

// epi(i, j, sum_d A[r0 + i][d] B[j][d]) for every i < m and j < n (both
// multiples of 4): the product of rows of two [n, HD] tiles along the head
// dim, d in order.  A thread owns a 4 x 4 tile of rows ti + tr r and columns
// tj + tc c (tr = m / 4, tc = n / 4, r, c < 4), so the threads of a warp
// read neighbouring rows of B and one or two rows of A.
template <int HD, class Epi>
__device__ __forceinline__ void rows_dot_rows(const float* A, int r0, int m, const float* B,
                                              int n, Epi epi) {
  const int tr = m / 4, tc = n / 4;
  for (int cell = threadIdx.x; cell < tr * tc; cell += kThreads) {
    const int ti = cell / tc, tj = cell % tc;
    float acc[4][4];
#pragma unroll
    for (int r = 0; r < 4; ++r)
#pragma unroll
      for (int c = 0; c < 4; ++c) acc[r][c] = 0.f;
#pragma unroll
    for (int k = 0; k < HD / 4; ++k) {
      float4 a[4], b[4];
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        a[r] = chunk<HD>(A, r0 + ti + tr * r, k);
        b[r] = chunk<HD>(B, tj + tc * r, k);
      }
#pragma unroll
      for (int r = 0; r < 4; ++r)
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          acc[r][c] = fmaf(a[r].x, b[c].x, acc[r][c]);
          acc[r][c] = fmaf(a[r].y, b[c].y, acc[r][c]);
          acc[r][c] = fmaf(a[r].z, b[c].z, acc[r][c]);
          acc[r][c] = fmaf(a[r].w, b[c].w, acc[r][c]);
        }
    }
#pragma unroll
    for (int r = 0; r < 4; ++r)
#pragma unroll
      for (int c = 0; c < 4; ++c) epi(ti + tr * r, tj + tc * c, acc[r][c]);
  }
}

// store(i, c, o) for every row i < M and chunk c < HD / 4 of columns, o the
// four sums over k < K of A(i, k) * T[k][4c..4c+3]: T an [n, HD] tile, A a
// square buffer of row stride ld read as S[i][k] or, kTrans, as S[k][i].  A
// thread owns one chunk of the rows q + Q r (Q = ceil(M / 4), r < 4): four
// independent sums, so its loads and FMAs overlap.  At head dim 16 two
// neighbouring lanes split k in two halves, each summed in order, and add
// them by a shuffle (a thread's share of 256 would otherwise be one row).
// Rows q + Q r >= M stay below n and are summed but not stored.
template <int HD, bool kTrans, class Store>
__device__ __forceinline__ void square_dot_tile(const float* S, int ld, const float* T, int M,
                                                int K, Store store) {
  constexpr int kChunks = HD / 4;
  constexpr int kSlices = HD == 16 ? 2 : 1;
  const int quads = (M + 3) / 4, items = quads * kChunks;
  const int half = (K + kSlices - 1) / kSlices;
  for (int base = 0; base < items * kSlices; base += kThreads) {   // uniform: shuffles below
    const int t = base + threadIdx.x;
    const int slice = t % kSlices, item = t / kSlices;
    const int c = item % kChunks, q = item / kChunks;
    float4 acc[4];
#pragma unroll
    for (int r = 0; r < 4; ++r) acc[r] = make_float4(0.f, 0.f, 0.f, 0.f);
    if (item < items) {
      const int k1 = min(K, (slice + 1) * half);
      for (int k = slice * half; k < k1; ++k) {
        const float4 b = chunk<HD>(T, k, c);
#pragma unroll
        for (int r = 0; r < 4; ++r) {
          const int i = q + quads * r;
          const float a = kTrans ? S[k * ld + i] : S[i * ld + k];
          acc[r].x = fmaf(a, b.x, acc[r].x);
          acc[r].y = fmaf(a, b.y, acc[r].y);
          acc[r].z = fmaf(a, b.z, acc[r].z);
          acc[r].w = fmaf(a, b.w, acc[r].w);
        }
      }
    }
    if (kSlices > 1) {
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        acc[r].x += __shfl_xor_sync(kFull, acc[r].x, 1);
        acc[r].y += __shfl_xor_sync(kFull, acc[r].y, 1);
        acc[r].z += __shfl_xor_sync(kFull, acc[r].z, 1);
        acc[r].w += __shfl_xor_sync(kFull, acc[r].w, 1);
      }
    }
    if (item < items && slice == 0) {
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        const int i = q + quads * r;
        if (i < M) store(i, c, acc[r]);
      }
    }
  }
}

// Lanes that share a query row in the softmax passes, and keys a lane holds.
constexpr int kRowLanes = 8;
constexpr int kRowKeys = kMaxL / kRowLanes;

__device__ __forceinline__ float group_max(float x) {
#pragma unroll
  for (int off = kRowLanes / 2; off > 0; off >>= 1) x = fmaxf(x, __shfl_xor_sync(kFull, x, off));
  return x;
}

__device__ __forceinline__ float group_sum(float x) {
#pragma unroll
  for (int off = kRowLanes / 2; off > 0; off >>= 1) x += __shfl_xor_sync(kFull, x, off);
  return x;
}

// fn(i, live, sub) over the query rows i < L, kRowLanes lanes a row (lane
// sub of its group holds the keys sub + kRowLanes t), four rows a warp at
// once.  Every lane of a warp makes the same calls (live is false for a row
// past L), so fn may shuffle within its group.
template <class Fn>
__device__ __forceinline__ void for_rows(int L, Fn fn) {
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  constexpr int kRowsAtOnce = 32 / kRowLanes;
  for (int i0 = warp * kRowsAtOnce; i0 < L; i0 += kWarps * kRowsAtOnce) {
    const int i = i0 + lane / kRowLanes;
    fn(i, i < L, lane % kRowLanes);
  }
}

// Shared memory from a 1024-byte aligned base, for n = padded(L) rows and
// `tiles` [n, HD] f32 tiles: the tiles, then `squares` [rows, n + 1] f32
// buffers (rows a multiple of 4, at most n), then the key mask and one more
// [n] f32 vector, then the barrier.
struct Layout {
  int n, ld, tile_floats, square_floats, tiles_off, squares_off, mask_off, vec_off, bar_off,
      alloc;
  __host__ __device__ Layout(int L, int hd, int tiles, int squares, int rows) {
    n = padded(L);
    ld = n + 1;
    tile_floats = n * hd;                 // a multiple of 256: 1024-byte aligned tiles
    square_floats = rows * ld;            // even: the barrier stays 8-byte aligned
    tiles_off = 0;
    squares_off = tiles_off + tiles * tile_floats;
    mask_off = squares_off + squares * square_floats;
    vec_off = mask_off + n;
    bar_off = (vec_off + n) * 4;
    alloc = bar_off + 8 + 1024;           // room to align the base
  }
};

__device__ __forceinline__ unsigned char* aligned_base(unsigned char* raw) {
  const uint32_t a = oryon_hopper::smem_u32(raw);
  return raw + (((a + 1023u) & ~1023u) - a);
}

// One thread: the barrier armed for `boxes` [n, HD] f32 boxes, which it then
// asks TMA for; every thread waits for them.  `cols` are the boxes' first
// columns in the map, `dst` their tiles.
template <int HD, int kBoxes>
__device__ __forceinline__ void load_tiles(uint64_t* bar, const CUtensorMap* const* maps,
                                           float* const* dst, const int* cols, int n, int b) {
  using namespace oryon_hopper;
  const uint32_t bar_a = smem_u32(bar);
  if (threadIdx.x == 0) {
    mbar_init(bar_a, 1);
    mbar_init_fence();
    mbar_arrive_expect_tx(bar_a, uint32_t(kBoxes * n * HD * 4));
#pragma unroll
    for (int i = 0; i < kBoxes; ++i) tma_load_tile(smem_u32(dst[i]), maps[i], bar_a, cols[i], 0, b);
  }
  __syncthreads();   // the barrier is initialised before anyone polls it
  mbar_wait(bar_a, 0);
}

// grid (B * heads * parts): a block owns query rows [part * R, part * R + R)
// of one (image, head), R a multiple of 4.  qkv through `map` (a 3-D f32 map
// over [B, L, 3C], boxes of [n, HD]), kmask [L], out [B, L, C].
template <int HD>
__global__ void __launch_bounds__(kThreads)
mha_f32_head_kernel(const __grid_constant__ CUtensorMap map, const float* __restrict__ kmask,
                    float* __restrict__ out, int L, int C, int heads, float scale, int parts,
                    int R) {
  extern __shared__ unsigned char smem_raw[];
  const Layout lay(L, HD, 3, 1, R);
  float* base = reinterpret_cast<float*>(aligned_base(smem_raw));
  float* qs = base + lay.tiles_off;
  float* ks = qs + lay.tile_floats;
  float* vs = ks + lay.tile_floats;
  float* S = base + lay.squares_off;   // the block's rows: row i is query r0 + i
  float* km = base + lay.mask_off;
  float* rowsum = base + lay.vec_off;
  auto* bar = reinterpret_cast<uint64_t*>(reinterpret_cast<unsigned char*>(base) + lay.bar_off);
  const int n = lay.n, ld = lay.ld;
  const int bh = blockIdx.x / parts, r0 = blockIdx.x % parts * R;
  const int b = bh / heads, h = bh % heads, m = min(L - r0, R);

  for (int j = threadIdx.x; j < L; j += kThreads) km[j] = kmask[j];
  const CUtensorMap* maps[3] = {&map, &map, &map};
  float* dst[3] = {qs, ks, vs};
  const int cols[3] = {h * HD, C + h * HD, 2 * C + h * HD};
  load_tiles<HD, 3>(bar, maps, dst, cols, n, b);   // its barrier also publishes km

  // S = q k^T * scale + kmask, for the block's rows and the live keys (two
  // roundings, as the TPU kernel's multiply and add)
  rows_dot_rows<HD>(qs, r0, (m + 3) / 4 * 4, ks, n, [&](int i, int j, float s) {
    if (i < m && j < L) S[i * ld + j] = __fadd_rn(__fmul_rn(s, scale), km[j]);
  });
  __syncthreads();

  // E = exp(S - rowmax) in place, the row sums beside
  for_rows(m, [&](int i, bool live, int sub) {
    float* row = S + i * ld;
    float v[kRowKeys];
    float top = -INFINITY;
#pragma unroll
    for (int t = 0; t < kRowKeys; ++t) {
      const int j = sub + kRowLanes * t;
      v[t] = live && j < L ? row[j] : -INFINITY;
      top = fmaxf(top, v[t]);
    }
    top = group_max(top);
    float l = 0.f;
#pragma unroll
    for (int t = 0; t < kRowKeys; ++t) {
      const int j = sub + kRowLanes * t;
      if (live && j < L) {
        const float e = expf(v[t] - top);
        row[j] = e;
        l += e;
      }
    }
    l = group_sum(l);
    if (live && sub == 0) rowsum[i] = l;
  });
  __syncthreads();

  // O = E V, divided by the row sum last
  float* ob = out + (size_t(b) * L + r0) * C + h * HD;
  square_dot_tile<HD, false>(S, ld, vs, m, L, [&](int i, int c, float4 o) {
    const float l = rowsum[i];
    o.x = o.x / l;
    o.y = o.y / l;
    o.z = o.z / l;
    o.w = o.w / l;
    *reinterpret_cast<float4*>(ob + size_t(i) * C + 4 * c) = o;
  });
}

// The 3-D f32 map over [planes, rows, cols] with boxes of [n, hd].
inline cudaError_t encode(CUtensorMap* map, const void* base, uint64_t cols, int L, int B,
                          int hd) {
  return oryon_hopper::encode_map(map, base, 4, cols, uint64_t(L), uint64_t(B), cols * 4,
                                  cols * 4 * uint64_t(L), uint32_t(hd), uint32_t(padded(L)));
}

// The largest shared memory a kernel of this head dim asks for, set once.
template <class Kernel>
inline cudaError_t allow_smem(Kernel kernel, int bytes, bool* done) {
  if (*done) return cudaSuccess;
  const cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err == cudaSuccess) *done = true;
  return err;
}

// Row parts a head: one when B * heads blocks already fill the card's SMs,
// otherwise enough to, but no more than L / 16 (16 query rows a part or
// more).  A block's time is the chain of its products and softmax passes, so
// a head split over more SMs finishes sooner; every part reloads K and V
// (from L2), which at the tiny tower's L = 17 costs more than it saves.
static int row_parts(int B, int heads, int L) {
  static int sms = 0;
  if (sms == 0) {
    int dev = 0;
    if (cudaGetDevice(&dev) != cudaSuccess ||
        cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev) != cudaSuccess) {
      sms = 1;
    }
  }
  const int want = (sms + B * heads - 1) / (B * heads), most = L / 16;
  const int parts = want < most ? want : most;
  return parts < 1 ? 1 : parts;
}

template <int HD>
static cudaError_t launch_hd(const void* qkv, const float* kmask, float* out, int B, int L,
                             int C, int heads, float scale, cudaStream_t stream) {
  static bool configured = false;
  cudaError_t err = allow_smem(mha_f32_head_kernel<HD>,
                               Layout(kMaxL, HD, 3, 1, kMaxL).alloc, &configured);
  if (err != cudaSuccess) return err;
  CUtensorMap map;
  err = encode(&map, qkv, 3ull * C, L, B, HD);
  if (err != cudaSuccess) return err;
  const int P = row_parts(B, heads, L);
  const int R = ((L + P - 1) / P + 3) / 4 * 4;       // rows a part, a multiple of 4
  const int parts = (L + R - 1) / R;
  mha_f32_head_kernel<HD><<<B * heads * parts, kThreads, Layout(L, HD, 3, 1, R).alloc,
                            stream>>>(map, kmask, out, L, C, heads, scale, parts, R);
  return cudaGetLastError();
}

// qkv [B, L, 3C] f32, kmask [L] f32, out [B, L, C] f32, all contiguous and
// 16-byte aligned; 1 <= L <= kMaxL, C / heads in {16, 32}.
static inline cudaError_t launch(const void* qkv, const float* kmask, float* out, int B,
                                 int L, int C, int heads, float scale, cudaStream_t stream) {
  if (B <= 0 || L <= 0 || L > kMaxL || heads <= 0 || C % heads != 0 ||
      reinterpret_cast<uintptr_t>(out) % 16 != 0) {
    return cudaErrorInvalidValue;
  }
  switch (C / heads) {
    case 16: return launch_hd<16>(qkv, kmask, out, B, L, C, heads, scale, stream);
    case 32: return launch_hd<32>(qkv, kmask, out, B, L, C, heads, scale, stream);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace oryon_attn_f32_head
