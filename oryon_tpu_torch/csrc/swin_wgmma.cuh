// Swin window attention at head dimension 32, designed for Hopper: the device
// code of K3 (packed windows, [Bw, N, C] rows, bf16 bias) and K4 (the same
// read off the padded feature map [B, Hp, Wp, 3C], f32 bias) for windows of
// up to 64 tokens.  Every other head dimension stays on the WMMA kernel of
// swin_attn.cu.
//
// What bounds the function on an H100: bytes.  A (window, head) of 49 tokens
// is 9.4 KB of q, k, v and 3.1 KB of output against 0.31 MFLOP, 25 FLOPs a
// byte.  What the design does about it:
//
//  * The unit of work is one (window, head), and one warpgroup computes it
//    whole out of registers.  The window's rows pad to the 64 of a wgmma
//    tile.  S[64, 64] = Q K^T is `wgmma` m64n64k16 x 2 with Q and K read from
//    shared memory; the softmax runs on the 32 accumulator registers a thread
//    holds (scale and bias in one FMA, a row's values in the four lanes of a
//    quad, so a row maximum or sum is two shuffles, one reciprocal a row,
//    probabilities normalised BEFORE the cast to bf16, as the reference
//    does); O[64, 32] = P V is m64n32k16 x 4 with P as the register A operand
//    and V read from its [keys, 32] tile as it lies (head dimension
//    contiguous: the transposed-B form).  No S, P or O scratch.
//  * Tiles arrive by TMA into a ring, and blocks are persistent.  A row of a
//    head is 64 bytes: the tensor maps take the 64-byte swizzle and a tile is
//    4 KB; a stage is the q, k and v tiles of one item.  K3 reads a 3-D map
//    over [Bw, N, C] with a box of 64 rows: rows past N are out of bounds and
//    arrive as zeros.  K4 reads a 4-D map over [B, Hp, Wp, 3C] with a box of
//    [w, w] pixels, which lands as w * w consecutive rows in token order, so
//    the window partition is the TMA unit's address arithmetic; the rows the
//    box never writes are zeroed once a block (0 weight x garbage V would be
//    NaN).  One producer warp starts the loads; a full and an empty
//    `mbarrier` a stage.  A block walks its items in window-major order, the
//    heads of a window one after the other.
//  * The bias arrives in one aligned read.  A pre-pass (bias_fragments_kernel
//    below, one small launch a call) lays the [nw, heads, N, N] bias out in
//    the order the accumulator registers hold S: per (window position, head)
//    and thread its 32 values, pad columns at -inf (they replace the `key <
//    N` test) and pad rows at 0, as 16-byte vectors that a warp reads
//    coalesced: eight loads a thread in f32 (K4), four in bf16 (K3, whose
//    reference rounds the bias to bf16), started before the wait for the tile.
//  * The output leaves through shared memory: a warp stages its 16 rows
//    (swizzled, conflict-free) and writes whole 64-byte rows with 16-byte
//    stores, rows at or past N never.
//
// Arithmetic: f32 logits acc * scale + bias, exp2 with log2(e) folded into
// the subtraction of the row maximum (one FMA and one `ex2.approx` a logit),
// f32 row sums of the unrounded exponentials, weights times the reciprocal of
// the sum rounded to bf16, f32 sums in P V.

#pragma once

#include "attn_wgmma.cuh"

namespace oryon_swin_wg {

using namespace oryon_hopper;
using oryon_attn_wg::fast_exp2;
using oryon_attn_wg::fence_regs;
using oryon_attn_wg::pack_bf16;
using oryon_attn_wg::wgmma_ss;

constexpr int kHD = 32;                     // head dimension this kernel takes
constexpr int kRows = 64;                   // rows of a tile (N <= 64)
constexpr int kTileBytes = kRows * kHD * 2; // one [64 rows, 32 bf16] tile
constexpr int kStageBytes = 3 * kTileBytes; // q, k, v of one (window, head)
constexpr float kLog2e = 1.4426950408889634f;

enum Order { kStrided = 0, kContiguous = 1 };

struct Params {
  __nv_bfloat16* out;   // [Bw, N, C] (K3) or [B, Hp, Wp, C] (K4)
  const void* frag;     // the bias in fragment order (see bias_fragments_kernel)
  int N, C, heads, nw;  // tokens a window, channels, heads, windows an image
  int items;            // windows * heads
  int order;            // how the items are dealt to the blocks (Order)
  int col_k, col_v;     // first column of k and of v in their maps
  int w, Wp, nwx;       // K4: window side, map width, windows across the map
  long long img_pixels; // K4: Hp * Wp
  uint32_t tx_bytes;    // bytes the three loads of a stage deliver
  float scale;
};

// --------------------------------------------------------------- bias pre-pass

// Thread `tid` of a warpgroup holds, of a [64, 64] f32 accumulator, the
// elements (row, col) = (16 * warp + lane / 4 + 8 * (e >> 1),
// 8 * j + 2 * (lane % 4) + (e & 1)) for j < 8, e < 4 in register 4 * j + e.
// The fragment layout keeps those of one (window position, head) together:
// f32:  [nw * heads, 8 (j), 128 (tid), 4 (e)]
// bf16: [nw * heads, 4 (j / 2), 128 (tid), 8 (j % 2, e)]
// with -inf where col >= N and 0 where row >= N.  One block a (position, head).
template <typename OutT>
__global__ void __launch_bounds__(128)
bias_fragments_kernel(const float* __restrict__ bias, void* __restrict__ frag, int N) {
  __shared__ float sb[kRows * kRows];
  const float* src = bias + size_t(blockIdx.x) * N * N;
  for (int i = threadIdx.x; i < N * N; i += 128) sb[i] = src[i];
  __syncthreads();
  const int tid = threadIdx.x;
  const int row0 = (tid / 32) * 16 + (tid % 32) / 4;
  const int c2 = (tid % 4) * 2;
  const auto val = [&](int j, int e) {
    const int row = row0 + 8 * (e >> 1);
    const int col = j * 8 + c2 + (e & 1);
    return col >= N ? -INFINITY : (row < N ? sb[row * N + col] : 0.f);
  };
  if constexpr (sizeof(OutT) == 4) {
    float4* dst = static_cast<float4*>(frag) + size_t(blockIdx.x) * 8 * 128 + tid;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      dst[j * 128] = make_float4(val(j, 0), val(j, 1), val(j, 2), val(j, 3));
    }
  } else {
    uint4* dst = static_cast<uint4*>(frag) + size_t(blockIdx.x) * 4 * 128 + tid;
#pragma unroll
    for (int jj = 0; jj < 4; ++jj) {
      dst[jj * 128] = make_uint4(pack_bf16(val(2 * jj, 0), val(2 * jj, 1)),
                                 pack_bf16(val(2 * jj, 2), val(2 * jj, 3)),
                                 pack_bf16(val(2 * jj + 1, 0), val(2 * jj + 1, 1)),
                                 pack_bf16(val(2 * jj + 1, 2), val(2 * jj + 1, 3)));
    }
  }
}

// bias [nw, heads, N, N] f32 -> frag, f32 (K4) or rounded to bf16 (K3).
template <typename OutT>
cudaError_t launch_bias_fragments(const void* bias, void* frag, int nw, int heads,
                                  int N, cudaStream_t stream) {
  bias_fragments_kernel<OutT><<<nw * heads, 128, 0, stream>>>(
      static_cast<const float*>(bias), frag, N);
  return cudaGetLastError();
}

// ---------------------------------------------------------------- PTX pieces

#define ORYON_ACC16(d)                                                         \
  "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),      \
      "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), \
      "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])

// D[64, 32] (+)= A[64, 16] . B[16, 32]: A from registers (four packed bf16
// pairs a thread), B MN-major in shared memory (the transposed-B bit set).
// scale_d = 0 overwrites D.
__device__ __forceinline__ void wgmma_rs_tb_n32(float (&d)[16], uint32_t a0,
                                                uint32_t a1, uint32_t a2, uint32_t a3,
                                                uint64_t desc_b, int scale_d) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %21, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15}, "
      "{%16, %17, %18, %19}, %20, p, 1, 1, 1;\n"
      "}\n"
      : ORYON_ACC16(d)
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "l"(desc_b), "r"(scale_d));
}

__device__ __forceinline__ void fence_regs(float (&r)[16]) {
#pragma unroll
  for (int i = 0; i < 16; ++i) asm volatile("" : "+f"(r[i])::"memory");
}
__device__ __forceinline__ void fence_regs(uint32_t (&r)[16]) {
#pragma unroll
  for (int i = 0; i < 16; ++i) asm volatile("" : "+r"(r[i])::"memory");
}

// A thread's 32 bias values of one item, as loaded and as floats.
template <bool BAND>
struct BiasRegs;

template <>
struct BiasRegs<true> {   // f32: eight coalesced 16-byte loads
  float4 v[8];
  __device__ __forceinline__ void load(const void* frag, size_t block, int tid) {
    const float4* src = static_cast<const float4*>(frag) + block * (8 * 128) + tid;
#pragma unroll
    for (int j = 0; j < 8; ++j) v[j] = __ldg(src + j * 128);
  }
  __device__ __forceinline__ float at(int j, int e) const {
    return e == 0 ? v[j].x : e == 1 ? v[j].y : e == 2 ? v[j].z : v[j].w;
  }
};

template <>
struct BiasRegs<false> {  // bf16 pairs: four coalesced 16-byte loads
  uint4 v[4];
  __device__ __forceinline__ void load(const void* frag, size_t block, int tid) {
    const uint4* src = static_cast<const uint4*>(frag) + block * (4 * 128) + tid;
#pragma unroll
    for (int jj = 0; jj < 4; ++jj) v[jj] = __ldg(src + jj * 128);
  }
  __device__ __forceinline__ float at(int j, int e) const {
    const uint4 u = v[j >> 1];
    const uint32_t word = (j & 1) ? ((e >> 1) ? u.w : u.z) : ((e >> 1) ? u.y : u.x);
    return __uint_as_float((e & 1) ? (word & 0xffff0000u) : (word << 16));
  }
};

// The softmax of a whole [64, 64] logit tile on the accumulator registers of
// S: logit = acc * scale + bias (pad keys carry -inf in the bias), the row
// maximum and the row sum of this thread's two rows through its quad, and P =
// exp2((logit - max) * log2 e) / sum rounded to bf16 and packed as the A
// fragments of the P V product.
template <bool BAND>
__device__ __forceinline__ void softmax_tile(float (&s)[32], const BiasRegs<BAND>& bias,
                                             float scale, uint32_t (&pk)[16]) {
  float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
  for (int j = 0; j < 8; ++j) {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      s[4 * j + e] = fmaf(s[4 * j + e], scale, bias.at(j, e));
      mx[e >> 1] = fmaxf(mx[e >> 1], s[4 * j + e]);
    }
  }
  float sum[2] = {0.f, 0.f};
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
    mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
    mx[r] *= -kLog2e;
  }
#pragma unroll
  for (int j = 0; j < 8; ++j) {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      s[4 * j + e] = fast_exp2(fmaf(s[4 * j + e], kLog2e, mx[e >> 1]));
      sum[e >> 1] += s[4 * j + e];
    }
  }
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    sum[r] += __shfl_xor_sync(0xffffffffu, sum[r], 1);
    sum[r] += __shfl_xor_sync(0xffffffffu, sum[r], 2);
    sum[r] = 1.f / sum[r];
  }
#pragma unroll
  for (int j = 0; j < 8; ++j) {
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      pk[2 * j + r] = pack_bf16(s[4 * j + 2 * r] * sum[r], s[4 * j + 2 * r + 1] * sum[r]);
    }
  }
}

// ------------------------------------------------------------------- kernel

// Shared memory, from a 1024-byte aligned base: the ring of stages (q, k, v
// tiles of 4 KB), a 4 KB output staging tile a consumer warpgroup (1 KB a
// warp), the barriers.
template <int kWG, int kStages>
struct Smem {
  static constexpr int ring_off = 0;
  static constexpr int out_off = kStages * kStageBytes;
  static constexpr int bar_off = out_off + kWG * kTileBytes;
  static constexpr int bytes = bar_off + 2 * kStages * 8;
  static constexpr int alloc = bytes + 1024;  // room to align the base
};

// kWG consumer warpgroups and one producer warp.  Item number `its` of a
// block goes to stage its % kStages and to warpgroup its % kWG; kStages is a
// multiple of kWG, so a stage always belongs to the same warpgroup.
template <bool BAND, int kWG, int kStages, int kMinBlocks>
__global__ void __launch_bounds__(kWG * 128 + 32, kMinBlocks)
swin_wgmma_kernel(const __grid_constant__ CUtensorMap map_q,
                  const __grid_constant__ CUtensorMap map_k,
                  const __grid_constant__ CUtensorMap map_v, const Params p) {
  using Lay = Smem<kWG, kStages>;
  static_assert(kStages % kWG == 0, "a stage belongs to one warpgroup");

  extern __shared__ unsigned char smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t base = (raw + 1023u) & ~1023u;
  unsigned char* gbase = smem_raw + (base - raw);
  const uint32_t bar_full = base + Lay::bar_off;      // [kStages]
  const uint32_t bar_empty = bar_full + kStages * 8;  // [kStages]

  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;

  // The block's items: first + n * stride + {0 .. kWG - 1} below limit, for
  // n = 0, 1, ...  Strided: groups of kWG neighbouring items dealt round
  // robin over the blocks; contiguous: one range of items a block.
  int first, stride, limit;
  if (p.order == kContiguous) {
    first = int((long long)p.items * blockIdx.x / gridDim.x);
    limit = int((long long)p.items * (blockIdx.x + 1) / gridDim.x);
    stride = kWG;
  } else {
    first = blockIdx.x * kWG;
    limit = p.items;
    stride = gridDim.x * kWG;
  }

  if (threadIdx.x == 0) {
    for (int s = 0; s < kStages; ++s) {
      mbar_init(bar_full + s * 8, 1);   // the producer's one arrive
      mbar_init(bar_empty + s * 8, 4);  // one arrive a warp of the stage's warpgroup
    }
    mbar_init_fence();
  }
  if (BAND && p.N < kRows) {
    // rows N..63 of every tile stay zero: the boxes write rows 0..N-1 only
    uint4* ring = reinterpret_cast<uint4*>(gbase + Lay::ring_off);
    for (int i = threadIdx.x; i < kStages * kStageBytes / 16; i += kWG * 128 + 32) {
      ring[i] = make_uint4(0, 0, 0, 0);
    }
    fence_proxy_async();
  }
  __syncthreads();

  if (warp == kWG * 4) {
    // ------------------------------------------------------ producer warp
    if (lane == 0) {
      for (int its = 0;; ++its) {
        const int item = first + (its / kWG) * stride + its % kWG;
        if (item >= limit) break;
        const int stage = its % kStages;
        const uint32_t round = its / kStages;
        mbar_wait(bar_empty + stage * 8, (round & 1u) ^ 1u);  // free at first
        const int win = item / p.heads;
        const int col = (item - win * p.heads) * kHD;
        const uint32_t full = bar_full + stage * 8;
        const uint32_t dst = base + Lay::ring_off + stage * kStageBytes;
        mbar_arrive_expect_tx(full, p.tx_bytes);
        if constexpr (BAND) {
          const int b = win / p.nw;
          const int wi = win - b * p.nw;
          const int y = (wi / p.nwx) * p.w;
          const int x = (wi % p.nwx) * p.w;
          tma_load_tile4(dst, &map_q, full, col, x, y, b);
          tma_load_tile4(dst + kTileBytes, &map_k, full, p.col_k + col, x, y, b);
          tma_load_tile4(dst + 2 * kTileBytes, &map_v, full, p.col_v + col, x, y, b);
        } else {
          tma_load_tile(dst, &map_q, full, col, 0, win);
          tma_load_tile(dst + kTileBytes, &map_k, full, p.col_k + col, 0, win);
          tma_load_tile(dst + 2 * kTileBytes, &map_v, full, p.col_v + col, 0, win);
        }
      }
    }
    return;
  }

  // ------------------------------------------------- consumer warpgroups
  const int wg = warp / 4;
  const int tid = threadIdx.x % 128;
  const int c2 = (lane % 4) * 2;
  // the output rows this lane writes back: two of its warp's 16, and where
  // they lie from the window's first pixel
  unsigned char* slab = gbase + Lay::out_off + wg * kTileBytes + (warp % 4) * 1024;
  int out_row[2];
  long long out_off[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    out_row[i] = (lane + 32 * i) / 4;  // within the warp's slab
    const int t = (warp % 4) * 16 + out_row[i];
    long long pixel = t;
    if constexpr (BAND) pixel = (long long)(t / p.w) * p.Wp + t % p.w;
    out_off[i] = t < p.N ? pixel * p.C + (lane % 4) * 8 : -1;
  }

  for (int n = 0;; ++n) {
    const int item = first + n * stride + wg;
    if (item >= limit) break;
    const int its = n * kWG + wg;
    const int stage = its % kStages;
    const int win = item / p.heads;
    const int h = item - win * p.heads;
    const int b = win / p.nw;
    const int wi = win - b * p.nw;

    // the item's bias first: independent loads, in flight during the wait
    BiasRegs<BAND> bias;
    bias.load(p.frag, size_t(wi) * p.heads + h, tid);

    const uint32_t q_smem = base + Lay::ring_off + stage * kStageBytes;
    const uint64_t q_desc = make_desc<kSwizzle64>(q_smem);
    const uint64_t k_desc = make_desc<kSwizzle64>(q_smem + kTileBytes);
    const uint64_t v_desc = make_desc<kSwizzle64>(q_smem + 2 * kTileBytes);
    mbar_wait(bar_full + stage * 8, (its / kStages) & 1u);

    // S[64, 64] = Q[64, 32] . K^T: two k16 steps of 32 bytes
    float s[32];
    fence_regs(s);
    wgmma_fence();
    wgmma_ss(s, q_desc, k_desc, 0);
    wgmma_ss(s, q_desc + 2, k_desc + 2, 1);
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(s);

    uint32_t pk[16];
    softmax_tile<BAND>(s, bias, p.scale, pk);

    // O[64, 32] = P[64, 64] . V[64, 32]: four k16 steps of 16 key rows (1 KB)
    float o[16];
    fence_regs(o);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      wgmma_rs_tb_n32(o, pk[4 * kk + 0], pk[4 * kk + 1], pk[4 * kk + 2], pk[4 * kk + 3],
                      v_desc + kk * (1024 >> 4), kk > 0);
    }
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(o);
    fence_regs(pk);
    __syncwarp();
    if (lane == 0) mbar_arrive(bar_empty + stage * 8);  // the stage may be refilled

    // stage this warp's [16, 32] rows as bf16 (16-byte chunks swizzled by the
    // row pair, conflict-free both ways), then whole rows out, 16 bytes a lane
#pragma unroll
    for (int j = 0; j < 4; ++j) {
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const int row = lane / 4 + 8 * r;
        *reinterpret_cast<uint32_t*>(slab + row * 64 + ((j ^ ((row >> 1) & 3)) << 4) +
                                     c2 * 2) = pack_bf16(o[4 * j + 2 * r], o[4 * j + 2 * r + 1]);
      }
    }
    __syncwarp();
    long long win_off;  // of the window's first pixel, in elements of out
    if constexpr (BAND) {
      const long long pixel = (long long)b * p.img_pixels +
                              (long long)((wi / p.nwx) * p.w) * p.Wp + (wi % p.nwx) * p.w;
      win_off = pixel * p.C + h * kHD;
    } else {
      win_off = (long long)win * p.N * p.C + h * kHD;
    }
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int row = out_row[i];
      const uint4 val = *reinterpret_cast<const uint4*>(
          slab + row * 64 + (((lane % 4) ^ ((row >> 1) & 3)) << 4));
      if (out_off[i] >= 0) {
        *reinterpret_cast<uint4*>(p.out + win_off + out_off[i]) = val;
      }
    }
    __syncwarp();  // the next item overwrites the slab
  }
}

// --------------------------------------------------------------- host side

// The defaults below are the configuration the measurements chose (PERF.md;
// tools/swin_tile_sweep.py times the others): consumer warpgroups a block,
// ring stages, resident blocks asked of the compiler, item order.
constexpr int kDefaultWG = 2, kDefaultStages = 4, kDefaultBlocks = 2;
constexpr int kDefaultOrder = kStrided;

// (Internal linkage: a second library built from this header, as the sweep
// tool's, must configure its own copy of the kernel, and a static of a
// function with external linkage is one object for the whole process.)
template <bool BAND, int kWG, int kStages, int kMinBlocks>
static cudaError_t launch_config(const CUtensorMap& mq, const CUtensorMap& mk,
                                 const CUtensorMap& mv, const Params& p,
                                 cudaStream_t stream) {
  using Lay = Smem<kWG, kStages>;
  auto kernel = swin_wgmma_kernel<BAND, kWG, kStages, kMinBlocks>;
  static int resident = 0;  // blocks the card holds at once
  if (resident == 0) {
    cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, Lay::alloc);
    if (err != cudaSuccess) return err;
    int device = 0, sms = 0, per_sm = 0;
    err = cudaGetDevice(&device);
    if (err != cudaSuccess) return err;
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
    if (err != cudaSuccess) return err;
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel,
                                                        kWG * 128 + 32, Lay::alloc);
    if (err != cudaSuccess) return err;
    if (per_sm < 1) return cudaErrorLaunchOutOfResources;
    resident = sms * per_sm;
  }
  const int groups = (p.items + kWG - 1) / kWG;
  const int grid = groups < resident ? groups : resident;
  kernel<<<grid, kWG * 128 + 32, Lay::alloc, stream>>>(mq, mk, mv, p);
  return cudaGetLastError();
}

// K3: q, k, v, out [Bw, N, C] bf16 with C = heads * 32 and N <= 64; frag the
// bias in bf16 fragment order.  A map each over [Bw, N, C], box [64, 32].
template <int kWG = kDefaultWG, int kStages = kDefaultStages,
          int kMinBlocks = kDefaultBlocks>
cudaError_t launch_packed(const void* q, const void* k, const void* v,
                          const void* frag, void* out, int Bw, int nw, int N, int C,
                          int heads, float scale, int order, cudaStream_t stream) {
  CUtensorMap maps[3];
  const void* bases[3] = {q, k, v};
  for (int i = 0; i < 3; ++i) {
    cudaError_t err = encode_map(&maps[i], bases[i], 2, C, N, Bw, 2ull * C,
                                 2ull * C * uint64_t(N), kHD, kRows);
    if (err != cudaSuccess) return err;
  }
  Params p{};
  p.out = static_cast<__nv_bfloat16*>(out);
  p.frag = frag;
  p.N = N;
  p.C = C;
  p.heads = heads;
  p.nw = nw;
  p.items = Bw * heads;
  p.order = order;
  p.tx_bytes = kStageBytes;  // whole boxes: the rows past N arrive as zeros
  p.scale = scale;
  return launch_config<false, kWG, kStages, kMinBlocks>(maps[0], maps[1], maps[2], p,
                                                        stream);
}

// K4: qkv_map [B, Hp, Wp, 3C] bf16 with C = heads * 32 and window <= 8; frag
// the bias in f32 fragment order; out [B, Hp, Wp, C].  One 4-D map serves q,
// k and v (columns h*32, C + h*32, 2C + h*32), box [window, window, 32].
template <int kWG = kDefaultWG, int kStages = kDefaultStages,
          int kMinBlocks = kDefaultBlocks>
cudaError_t launch_band(const void* qkv_map, const void* frag, void* out, int B,
                        int Hp, int Wp, int C, int heads, int window, float scale,
                        int order, cudaStream_t stream) {
  CUtensorMap map;
  const uint64_t dims[4] = {3ull * C, uint64_t(Wp), uint64_t(Hp), uint64_t(B)};
  const uint64_t strides[3] = {6ull * C, 6ull * C * Wp, 6ull * C * Wp * Hp};
  const uint32_t box[4] = {kHD, uint32_t(window), uint32_t(window), 1};
  cudaError_t err = encode_map_nd(&map, qkv_map, 2, 4, dims, strides, box);
  if (err != cudaSuccess) return err;
  Params p{};
  p.out = static_cast<__nv_bfloat16*>(out);
  p.frag = frag;
  p.N = window * window;
  p.C = C;
  p.heads = heads;
  p.nwx = Wp / window;
  p.nw = (Hp / window) * p.nwx;
  p.items = B * p.nw * heads;
  p.order = order;
  p.col_k = C;
  p.col_v = 2 * C;
  p.w = window;
  p.Wp = Wp;
  p.img_pixels = (long long)Hp * Wp;
  p.tx_bytes = 3u * uint32_t(p.N) * kHD * 2;  // the boxes hold N rows exactly
  p.scale = scale;
  return launch_config<true, kWG, kStages, kMinBlocks>(map, map, map, p, stream);
}

}  // namespace oryon_swin_wg
