// Streaming softmax attention for one (image, head, 64-query tile): the WMMA
// device code shared by the CLIP-tower attention kernels.
//
//   mha_lanes.cu  K1     packed [B, L, 3C] rows, additive key mask
//                 K1-i8  the same with int8 logits (per-head absmax scales)
//   flash.cu      K5     [B, H, L, D] rows, segment ids
//
// It serves K1, K1-i8 and K5 at head dimensions 16, 32 and 128.  At head
// dimension 64 (the ViT-L tower) all three run the wgmma kernel of
// attn_wgmma.cuh instead, through C entry points of its own that the Python
// wrappers choose by the head dimension.
//
// The three differ only in where a row of q, k, v and out lives (base pointer
// plus batch, head and row strides, AttnParams) and in how a logit is formed
// from the tensor-core product (Mode).  Each is its own kernel instantiation
// with its own C entry point.
//
// Design (see mha_lanes.cu for what bounds it): one block of 4 warps owns 64
// query rows and walks the keys in tiles of 64.  Each warp owns 16 query
// rows: S = Q K^T and O += P V run on the tensor cores through WMMA (f32 or
// int32 accumulation); the softmax is online (running max and running sum
// per row, in f32), O is kept in f32 in shared memory and rescaled by
// exp(m_old - m_new) before each P V product.  The exponentials are rounded
// to bf16 before the P V product and the row sum adds the rounded values;
// normalisation is deferred to the end.  L need not be aligned: keys at or
// past L are masked, query rows past L are not written.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <mma.h>
#include <stdint.h>

#include <type_traits>

namespace oryon_attn {

using namespace nvcuda;

constexpr int kBQ = 64;        // query rows per block
constexpr int kBK = 64;        // keys per tile
constexpr int kWarps = 4;      // each warp owns 16 query rows
constexpr int kThreads = kWarps * 32;

enum Mode {
  kKeyMask = 0,    // logit = acc * scale + kmask[key]
  kKeyMaskI8 = 1,  // logit = float(int32 acc) * (qm * km / 127^2) + kmask[key]
  kSegments = 2,   // logit = acc * scale where seg[query] == seg[key], else masked
};

// Element (b, h, row, d) of q, k, v lies at base + b*sb + h*sh + row*sr + d,
// of out at out + b*ob + h*oh + row*orow + d (strides in elements).
struct AttnParams {
  const __nv_bfloat16* q;
  const __nv_bfloat16* k;
  const __nv_bfloat16* v;
  __nv_bfloat16* out;
  long long sb, sh, sr;
  long long ob, oh, orow;
  const float* kmask;    // [L] additive f32 (kKeyMask, kKeyMaskI8)
  const int* seg;        // [B, L] segment ids or null = one segment (kSegments)
  const float* absmax;   // [B, heads, 2]: max|q*scale|, max|k| (kKeyMaskI8)
  int L;
  int heads;
  float scale;
};

template <int HD>
struct Layout {
  static constexpr int LDH = HD + 8;    // bf16 row stride of the Q, K, V tiles
  static constexpr int LDS = kBK + 4;   // f32 row stride of a warp's S tile
  static constexpr int LDP = kBK + 8;   // bf16 row stride of a warp's P tile
  static constexpr int LDO = HD + 4;    // f32 row stride of a warp's O tile
  static constexpr size_t q_off = 0;
  static constexpr size_t k_off = q_off + size_t(kBQ) * LDH * 2;
  static constexpr size_t v_off = k_off + size_t(kBK) * LDH * 2;
  static constexpr size_t s_off = v_off + size_t(kBK) * LDH * 2;
  static constexpr size_t p_off = s_off + size_t(kWarps) * 16 * LDS * 4;
  static constexpr size_t o_off = p_off + size_t(kWarps) * 16 * LDP * 2;
  static constexpr size_t m_off = o_off + size_t(kWarps) * 16 * LDO * 4;
  static constexpr size_t bytes = m_off + size_t(kBK) * 4;
};

// An int8 tile is stored as HD/16 planes of [64 rows][16 bytes]: every WMMA
// fragment then starts on a 32-byte boundary with a 16-byte row stride.
constexpr int kPlane = 64 * 16;

// Copy rows [row0, row0 + 64) x HD columns into a shared bf16 tile; rows at
// or past L become zeros.
template <int HD>
__device__ __forceinline__ void load_tile(__nv_bfloat16* dst,
                                          const __nv_bfloat16* base,
                                          long long sr, int row0, int L) {
  constexpr int kVec = HD / 8;  // 16-byte vectors per row
  for (int idx = threadIdx.x; idx < 64 * kVec; idx += kThreads) {
    const int r = idx / kVec;
    const int c = idx % kVec;
    const int row = row0 + r;
    uint4 val = make_uint4(0, 0, 0, 0);
    if (row < L) {
      val = *reinterpret_cast<const uint4*>(base + row * sr + c * 8);
    }
    *reinterpret_cast<uint4*>(dst + r * Layout<HD>::LDH + c * 8) = val;
  }
}

// The same rows quantised to int8 planes: round_half_even((x * pre) * r), two
// f32 multiplies in this order, as the reference does.
template <int HD>
__device__ __forceinline__ void load_tile_i8(signed char* dst,
                                             const __nv_bfloat16* base,
                                             long long sr, int row0, int L,
                                             float pre, float r) {
  constexpr int kVec = HD / 8;
  for (int idx = threadIdx.x; idx < 64 * kVec; idx += kThreads) {
    const int rr = idx / kVec;
    const int c = idx % kVec;
    const int row = row0 + rr;
    uint2 packed = make_uint2(0, 0);
    if (row < L) {
      const uint4 raw = *reinterpret_cast<const uint4*>(base + row * sr + c * 8);
      const __nv_bfloat16* x = reinterpret_cast<const __nv_bfloat16*>(&raw);
      alignas(8) signed char qv[8];
#pragma unroll
      for (int e = 0; e < 8; ++e) {
        const float f = __bfloat162float(x[e]) * pre;
        qv[e] = static_cast<signed char>(__float2int_rn(f * r));
      }
      packed = *reinterpret_cast<const uint2*>(qv);
    }
    *reinterpret_cast<uint2*>(dst + (c / 2) * kPlane + rr * 16 + (c % 2) * 8) =
        packed;
  }
}

template <int HD, int MODE>
__global__ void __launch_bounds__(kThreads)
attn_stream_kernel(const AttnParams p) {
  using Lay = Layout<HD>;
  constexpr bool kI8 = (MODE == kKeyMaskI8);
  using QKElem = std::conditional_t<kI8, signed char, __nv_bfloat16>;
  using Acc = std::conditional_t<kI8, int, float>;

  extern __shared__ __align__(128) unsigned char smem[];
  __nv_bfloat16* sQ = reinterpret_cast<__nv_bfloat16*>(smem + Lay::q_off);
  __nv_bfloat16* sK = reinterpret_cast<__nv_bfloat16*>(smem + Lay::k_off);
  __nv_bfloat16* sV = reinterpret_cast<__nv_bfloat16*>(smem + Lay::v_off);
  signed char* sQ8 = reinterpret_cast<signed char*>(smem + Lay::q_off);
  signed char* sK8 = reinterpret_cast<signed char*>(smem + Lay::k_off);
  float* sM = reinterpret_cast<float*>(smem + Lay::m_off);
  int* sSeg = reinterpret_cast<int*>(smem + Lay::m_off);

  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int q0 = blockIdx.x * kBQ;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int L = p.L;
  const __nv_bfloat16* qb = p.q + b * p.sb + h * p.sh;
  const __nv_bfloat16* kb = p.k + b * p.sb + h * p.sh;
  const __nv_bfloat16* vb = p.v + b * p.sb + h * p.sh;

  Acc* sS = reinterpret_cast<Acc*>(smem + Lay::s_off) + warp * 16 * Lay::LDS;
  __nv_bfloat16* sP =
      reinterpret_cast<__nv_bfloat16*>(smem + Lay::p_off) + warp * 16 * Lay::LDP;
  float* sO = reinterpret_cast<float*>(smem + Lay::o_off) + warp * 16 * Lay::LDO;

  // two lanes per query row: lane>>1 is the row, lane&1 the half of the
  // columns this lane handles in the softmax and the rescale
  const int row = lane >> 1;
  const int half = lane & 1;
  const int q = q0 + warp * 16 + row;

  float rk = 0.f;            // 127 / max|k|                     (kKeyMaskI8)
  float logit_mul = p.scale; // what the tensor-core sum is multiplied by
  int qseg = 1;              // this row's segment id            (kSegments)
  if constexpr (kI8) {
    const float qm = p.absmax[(size_t(b) * p.heads + h) * 2];
    const float km = p.absmax[(size_t(b) * p.heads + h) * 2 + 1];
    rk = 127.0f / km;
    logit_mul = (qm * km) / (127.0f * 127.0f);
    load_tile_i8<HD>(sQ8, qb, p.sr, q0, L, p.scale, 127.0f / qm);
  } else {
    load_tile<HD>(sQ, qb, p.sr, q0, L);
  }
  if constexpr (MODE == kSegments) {
    if (p.seg != nullptr) qseg = p.seg[size_t(b) * L + min(q, L - 1)];
  }
  for (int d = half * (HD / 2); d < (half + 1) * (HD / 2); ++d) {
    sO[row * Lay::LDO + d] = 0.f;
  }
  __syncthreads();

  wmma::fragment<wmma::matrix_a, 16, 16, 16, QKElem, wmma::row_major>
      qa[HD / 16];
#pragma unroll
  for (int k = 0; k < HD / 16; ++k) {
    if constexpr (kI8) {
      wmma::load_matrix_sync(qa[k], sQ8 + k * kPlane + warp * 16 * 16, 16);
    } else {
      wmma::load_matrix_sync(qa[k], sQ + warp * 16 * Lay::LDH + k * 16, Lay::LDH);
    }
  }

  float m_run = -INFINITY;  // running max of this lane's row
  float l_run = 0.f;        // running sum of bf16-rounded exponentials

  for (int k0 = 0; k0 < L; k0 += kBK) {
    if constexpr (kI8) {
      load_tile_i8<HD>(sK8, kb, p.sr, k0, L, 1.0f, rk);
    } else {
      load_tile<HD>(sK, kb, p.sr, k0, L);
    }
    load_tile<HD>(sV, vb, p.sr, k0, L);
    for (int j = threadIdx.x; j < kBK; j += kThreads) {
      if constexpr (MODE == kSegments) {
        sSeg[j] = (p.seg != nullptr && k0 + j < L)
                      ? p.seg[size_t(b) * L + k0 + j] : 1;
      } else {
        sM[j] = (k0 + j < L) ? p.kmask[k0 + j] : -INFINITY;
      }
    }
    __syncthreads();

    // S[16, 64] = Q_w[16, HD] . K^T[HD, 64]
#pragma unroll
    for (int n = 0; n < kBK / 16; ++n) {
      wmma::fragment<wmma::accumulator, 16, 16, 16, Acc> acc;
      wmma::fill_fragment(acc, Acc(0));
#pragma unroll
      for (int k = 0; k < HD / 16; ++k) {
        wmma::fragment<wmma::matrix_b, 16, 16, 16, QKElem, wmma::col_major> kf;
        if constexpr (kI8) {
          wmma::load_matrix_sync(kf, sK8 + k * kPlane + n * 16 * 16, 16);
        } else {
          wmma::load_matrix_sync(kf, sK + n * 16 * Lay::LDH + k * 16, Lay::LDH);
        }
        wmma::mma_sync(acc, qa[k], kf, acc);
      }
      wmma::store_matrix_sync(sS + n * 16, acc, Lay::LDS, wmma::mem_row_major);
    }
    __syncwarp();

    // online softmax over this tile: each lane owns 32 of its row's 64 keys
    float s[kBK / 2];
    float tmax = -INFINITY;
#pragma unroll
    for (int j = 0; j < kBK / 2; ++j) {
      const int col = half * (kBK / 2) + j;
      const float raw = static_cast<float>(sS[row * Lay::LDS + col]);
      if constexpr (MODE == kSegments) {
        s[j] = (k0 + col < L && sSeg[col] == qseg) ? raw * logit_mul : -INFINITY;
      } else {
        s[j] = raw * logit_mul + sM[col];
      }
      tmax = fmaxf(tmax, s[j]);
    }
    tmax = fmaxf(tmax, __shfl_xor_sync(0xffffffffu, tmax, 1));
    const float m_new = fmaxf(m_run, tmax);
    // a row that has seen no unmasked key yet keeps weights of exactly 0
    const float m_safe = (m_new == -INFINITY) ? 0.f : m_new;
    const float corr = __expf(m_run - m_safe);  // 0 until the first real key
    float psum = 0.f;
#pragma unroll
    for (int j = 0; j < kBK / 2; ++j) {
      const __nv_bfloat16 pj = __float2bfloat16(__expf(s[j] - m_safe));
      psum += __bfloat162float(pj);
      sP[row * Lay::LDP + half * (kBK / 2) + j] = pj;
    }
    psum += __shfl_xor_sync(0xffffffffu, psum, 1);
    l_run = l_run * corr + psum;
    m_run = m_new;
    for (int d = half * (HD / 2); d < (half + 1) * (HD / 2); ++d) {
      sO[row * Lay::LDO + d] *= corr;
    }
    __syncwarp();

    // O_w[16, HD] += P[16, 64] . V[64, HD]
#pragma unroll
    for (int n = 0; n < HD / 16; ++n) {
      wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc;
      wmma::load_matrix_sync(acc, sO + n * 16, Lay::LDO, wmma::mem_row_major);
#pragma unroll
      for (int k = 0; k < kBK / 16; ++k) {
        wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16,
                       wmma::row_major> pa;
        wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16,
                       wmma::row_major> vf;
        wmma::load_matrix_sync(pa, sP + k * 16, Lay::LDP);
        wmma::load_matrix_sync(vf, sV + k * 16 * Lay::LDH + n * 16, Lay::LDH);
        wmma::mma_sync(acc, pa, vf, acc);
      }
      wmma::store_matrix_sync(sO + n * 16, acc, Lay::LDO, wmma::mem_row_major);
    }
    __syncthreads();  // K, V and the mask tile are overwritten next
  }

  if (q < L) {
    const float inv = 1.f / l_run;
    __nv_bfloat16* dst = p.out + b * p.ob + h * p.oh + q * p.orow;
    for (int d = half * (HD / 2); d < (half + 1) * (HD / 2); d += 2) {
      *reinterpret_cast<__nv_bfloat162*>(dst + d) = __floats2bfloat162_rn(
          sO[row * Lay::LDO + d] * inv, sO[row * Lay::LDO + d + 1] * inv);
    }
  }
}

// Launch one instantiation over (query tiles, heads, batch).
template <int HD, int MODE>
cudaError_t launch(const AttnParams& p, int B, cudaStream_t stream) {
  constexpr size_t bytes = Layout<HD>::bytes;
  static bool configured = false;
  if (!configured) {
    cudaError_t err = cudaFuncSetAttribute(
        attn_stream_kernel<HD, MODE>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, int(bytes));
    if (err != cudaSuccess) return err;
    configured = true;
  }
  dim3 grid((p.L + kBQ - 1) / kBQ, p.heads, B);
  attn_stream_kernel<HD, MODE><<<grid, kThreads, bytes, stream>>>(p);
  return cudaGetLastError();
}

template <int MODE>
cudaError_t launch_hd(int hd, const AttnParams& p, int B, cudaStream_t stream) {
  switch (hd) {
    case 16: return launch<16, MODE>(p, B, stream);
    case 32: return launch<32, MODE>(p, B, stream);
    case 64: return cudaErrorInvalidValue;  // belongs to attn_wgmma.cuh
    case 128: return launch<128, MODE>(p, B, stream);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace oryon_attn
