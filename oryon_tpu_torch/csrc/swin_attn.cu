// Swin window attention: softmax(q k^T * scale + bias) v inside each window of
// N = w*w tokens (49 for Swin-B), per head.  Two kernels (K3, K4).
//
// Replaces: oryon_tpu/ops/pallas/swin_attn.py::packed_window_attention (K3,
// SwinConfig.attn_impl="pallas") and ::band_window_attention (K4,
// attn_impl="band"), the Pallas TPU kernels `_kernel` and `_band_kernel`.
//
// What bounds them on an H100: bytes.  At stage 1 of Swin-B on 16 images
// (3136 windows of 49 tokens, C = 128, 4 heads of 32) q, k, v and the output
// are about 157 MB read and written once against 3.9 GFLOP, some 25 FLOPs a
// byte, far below the card's 295; the 49 x 49 logits must therefore never
// reach device memory and the rows must move as 16-byte loads along C.
//
// What does not carry over: the TPU kernels pack P windows (K3) or a whole
// w-row band (K4) into one block-diagonal [343, 343] product, with -1e9 off
// the diagonal, only to fill the TPU's 128 x 128 matrix unit; those terms
// are exactly 0 after the f32 softmax.  Here every window is computed on
// its own, so K3's `pack` argument has no counterpart.
//
// Design: one block of 8 warps per window and group of heads: all heads at
// C = 128, four of the eight at C = 256, the most whose rows leave room for
// two blocks on an SM (one resident block of 152 KB took 0.44 ms at stage 2,
// two of 103 KB take 0.26 ms).  The block copies the window's 49 rows of
// q | k | v (its heads' columns) into shared memory with 16-byte loads, rows
// 49..63 zeroed; K3 reads them from the window-partitioned [Bw, N, C]
// tensors, K4 gathers them from the padded, rolled map [B, Hp, Wp, 3C] by
// address arithmetic, so that no window partition or reverse ever exists in
// device memory.  The (head, 16-query-row chunk) items are then dealt to the
// warps.  For each item the chunk's bias values are fetched first (32
// independent loads a lane, in flight during the product), then
// S[16, 64] = Q K^T on the tensor cores (WMMA bf16, f32 sums), a softmax
// over the 49 real keys with the lanes along the keys (bias added in f32;
// probabilities normalised BEFORE the cast to bf16, as the reference does,
// unlike K1), O[16, hd] = P V, and the real rows are written back as bf16,
// to [Bw, N, C] (K3) or scattered to [B, Hp, Wp, C] (K4).  K3's bias arrives
// rounded to bf16 (the reference rounds it), K4's stays f32: the two kernels
// are one device function with a different row address and bias type.
// Simple first: 16 warps an SM with long dependent chains per item, no
// pipelining of the gather with the products (times on an H100 80GB HBM3 at
// 700 W).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <mma.h>
#include <stdint.h>

#include <type_traits>

using namespace nvcuda;

namespace {

constexpr int kRows = 64;       // window rows in shared memory (N <= 64)
constexpr int kWWarps = 8;
constexpr int kWThreads = kWWarps * 32;
constexpr int kLDS = kRows + 4;  // f32 row stride of a warp's S (and O) chunk
constexpr int kLDP = kRows + 8;  // bf16 row stride of a warp's P chunk
constexpr int kMaxSmem = 232448;

struct WinParams {
  const __nv_bfloat16* q;   // row of token t of window win: q + pixel * in_stride
  const __nv_bfloat16* k;
  const __nv_bfloat16* v;
  __nv_bfloat16* out;       // out + pixel * C
  const void* bias;         // [nw, heads, N, N], bf16 (K3) or f32 (K4)
  long long in_stride;      // C (K3) or 3C (K4)
  int N, C, heads, nw;      // tokens a window, channels, heads, windows an image
  int hpb;                  // heads a block (divides heads); grid.y = heads / hpb
  int w, Hp, Wp;            // K4: window side and the padded map
  float scale;
};

// Shared memory of a block that holds CB = hpb * hd channels of q, k and v.
__host__ __device__ inline size_t smem_bytes(int CB) {
  return size_t(kRows) * (3 * CB + 8) * 2 +
         size_t(kWWarps) * 16 * (kLDS * 4 + kLDP * 2);
}

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

// Index of token t of window win among the rows of its tensor.
template <bool BAND>
__device__ __forceinline__ long long token_pixel(const WinParams& p, int win,
                                                 int t) {
  if constexpr (BAND) {
    const int nwx = p.Wp / p.w;
    const int b = win / p.nw;
    const int wi = win % p.nw;
    const int y = (wi / nwx) * p.w + t / p.w;
    const int x = (wi % nwx) * p.w + t % p.w;
    return ((long long)b * p.Hp + y) * p.Wp + x;
  } else {
    return (long long)win * p.N + t;
  }
}

template <int HD, bool BAND>
__global__ void __launch_bounds__(kWThreads)
window_attn_kernel(const WinParams p) {
  using BiasT = std::conditional_t<BAND, float, __nv_bfloat16>;
  constexpr int LDO = HD + 4;
  extern __shared__ __align__(128) unsigned char smem[];
  const int C = p.C;
  const int N = p.N;
  const int CB = p.hpb * HD;  // channels of this block's heads
  const int col0 = blockIdx.y * CB;
  const int LD = 3 * CB + 8;  // bf16 row stride of the q | k | v rows
  __nv_bfloat16* sX = reinterpret_cast<__nv_bfloat16*>(smem);
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  unsigned char* scratch = smem + size_t(kRows) * LD * 2;
  float* sS = reinterpret_cast<float*>(scratch) + warp * 16 * kLDS;
  float* sO = sS;             // S is dead once P is written
  __nv_bfloat16* sP = reinterpret_cast<__nv_bfloat16*>(
      scratch + size_t(kWWarps) * 16 * kLDS * 4) + warp * 16 * kLDP;

  const int win = blockIdx.x;
  const int wi = win % p.nw;

  // gather the window's rows: q | k | v side by side, rows >= N zero
  const int vec_sec = CB / 8;
  const int vec_row = 3 * vec_sec;
  for (int idx = threadIdx.x; idx < kRows * vec_row; idx += kWThreads) {
    const int t = idx / vec_row;
    const int rem = idx % vec_row;
    const int sec = rem / vec_sec;
    const int c = rem % vec_sec;
    uint4 val = make_uint4(0, 0, 0, 0);
    if (t < N) {
      const __nv_bfloat16* src = (sec == 0) ? p.q : (sec == 1) ? p.k : p.v;
      val = *reinterpret_cast<const uint4*>(
          src + token_pixel<BAND>(p, win, t) * p.in_stride + col0 + c * 8);
    }
    *reinterpret_cast<uint4*>(sX + t * LD + sec * CB + c * 8) = val;
  }
  __syncthreads();

  const int nchunks = (N + 15) / 16;
  const BiasT* bias = static_cast<const BiasT*>(p.bias);
  for (int item = warp; item < p.hpb * nchunks; item += kWWarps) {
    const int hl = item / nchunks;             // head within the block
    const int h = blockIdx.y * p.hpb + hl;     // head within the tensor
    const int r0 = (item % nchunks) * 16;
    const int c0 = lane;                       // this lane's two keys
    const int c1 = lane + 32;

    // the chunk's bias values first: independent loads, in flight during S
    float b0[16], b1[16];
#pragma unroll
    for (int r = 0; r < 16; ++r) {
      const int i = r0 + r;
      b0[r] = 0.f;
      b1[r] = 0.f;
      if (i < N) {
        const BiasT* brow = bias + ((size_t(wi) * p.heads + h) * N + i) * N;
        if (c0 < N) b0[r] = to_f32(brow[c0]);
        if (c1 < N) b1[r] = to_f32(brow[c1]);
      }
    }

    // S[16, 64] = Q[16, HD] . K^T[HD, 64]
    wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16, wmma::row_major>
        qa[HD / 16];
#pragma unroll
    for (int k = 0; k < HD / 16; ++k) {
      wmma::load_matrix_sync(qa[k], sX + r0 * LD + hl * HD + k * 16, LD);
    }
#pragma unroll
    for (int n = 0; n < kRows / 16; ++n) {
      wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc;
      wmma::fill_fragment(acc, 0.f);
#pragma unroll
      for (int k = 0; k < HD / 16; ++k) {
        wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16,
                       wmma::col_major> kf;
        wmma::load_matrix_sync(kf, sX + n * 16 * LD + CB + hl * HD + k * 16, LD);
        wmma::mma_sync(acc, qa[k], kf, acc);
      }
      wmma::store_matrix_sync(sS + n * 16, acc, kLDS, wmma::mem_row_major);
    }
    __syncwarp();

    // softmax of each row over its N real keys: lane owns keys lane, lane + 32
#pragma unroll
    for (int r = 0; r < 16; ++r) {
      const int i = r0 + r;
      float p0 = 0.f, p1 = 0.f;
      if (i < N) {
        float s0 = -INFINITY, s1 = -INFINITY;
        if (c0 < N) s0 = sS[r * kLDS + c0] * p.scale + b0[r];
        if (c1 < N) s1 = sS[r * kLDS + c1] * p.scale + b1[r];
        float m = fmaxf(s0, s1);
        for (int off = 16; off > 0; off >>= 1) {
          m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, off));
        }
        const float e0 = __expf(s0 - m);
        const float e1 = __expf(s1 - m);
        float sum = e0 + e1;
        for (int off = 16; off > 0; off >>= 1) {
          sum += __shfl_xor_sync(0xffffffffu, sum, off);
        }
        p0 = e0 / sum;
        p1 = e1 / sum;
      }
      sP[r * kLDP + c0] = __float2bfloat16(p0);
      sP[r * kLDP + c1] = __float2bfloat16(p1);
    }
    __syncwarp();

    // O[16, HD] = P[16, 64] . V[64, HD]
#pragma unroll
    for (int n = 0; n < HD / 16; ++n) {
      wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc;
      wmma::fill_fragment(acc, 0.f);
#pragma unroll
      for (int k = 0; k < kRows / 16; ++k) {
        wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16,
                       wmma::row_major> pa;
        wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16,
                       wmma::row_major> vf;
        wmma::load_matrix_sync(pa, sP + k * 16, kLDP);
        wmma::load_matrix_sync(vf, sX + k * 16 * LD + 2 * CB + hl * HD + n * 16, LD);
        wmma::mma_sync(acc, pa, vf, acc);
      }
      wmma::store_matrix_sync(sO + n * 16, acc, LDO, wmma::mem_row_major);
    }
    __syncwarp();

    // the real rows go out as bf16, 16 bytes a lane
    constexpr int kVec = HD / 8;
    for (int vi = lane; vi < 16 * kVec; vi += 32) {
      const int r = vi / kVec;
      const int c = vi % kVec;
      const int i = r0 + r;
      if (i < N) {
        const float* o = sO + r * LDO + c * 8;
        alignas(16) __nv_bfloat162 packed[4];
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          packed[e] = __floats2bfloat162_rn(o[2 * e], o[2 * e + 1]);
        }
        *reinterpret_cast<uint4*>(p.out + token_pixel<BAND>(p, win, i) * C +
                                  h * HD + c * 8) =
            *reinterpret_cast<const uint4*>(packed);
      }
    }
    __syncwarp();   // the next item overwrites S and P
  }
}

template <int HD, bool BAND>
cudaError_t launch(const WinParams& p, int windows, cudaStream_t stream) {
  static bool configured = false;
  if (!configured) {
    cudaError_t err = cudaFuncSetAttribute(
        window_attn_kernel<HD, BAND>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, kMaxSmem);
    if (err != cudaSuccess) return err;
    configured = true;
  }
  const dim3 grid(windows, p.heads / p.hpb);
  window_attn_kernel<HD, BAND><<<grid, kWThreads, smem_bytes(p.hpb * HD), stream>>>(p);
  return cudaGetLastError();
}

template <bool BAND>
cudaError_t launch_hd(WinParams p, int windows, cudaStream_t stream) {
  if (p.N <= 0 || p.N > kRows || p.heads <= 0 || p.C % p.heads != 0 ||
      p.nw <= 0 || windows % p.nw != 0) {
    return cudaErrorInvalidValue;
  }
  // as many heads a block as leave room for two blocks on an SM
  const int hd = p.C / p.heads;
  p.hpb = 1;
  for (int d = 2; d <= p.heads; ++d) {
    if (p.heads % d == 0 && smem_bytes(d * hd) <= size_t(kMaxSmem) / 2) p.hpb = d;
  }
  switch (hd) {
    case 16: return launch<16, BAND>(p, windows, stream);
    case 32: return launch<32, BAND>(p, windows, stream);
    case 64: return launch<64, BAND>(p, windows, stream);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

// K3.  q, k, v, out [Bw, N, C] bf16 (Bw = images * nw, the windows of one
// image consecutive); bias [nw, heads, N, N] bf16; all contiguous.
// Returns a cudaError_t code (0 on success).
extern "C" int oryon_packed_window_attention_bf16(
    const void* q, const void* k, const void* v, const void* bias, void* out,
    int Bw, int nw, int N, int C, int heads, float scale, void* stream) {
  WinParams p{};
  p.q = static_cast<const __nv_bfloat16*>(q);
  p.k = static_cast<const __nv_bfloat16*>(k);
  p.v = static_cast<const __nv_bfloat16*>(v);
  p.out = static_cast<__nv_bfloat16*>(out);
  p.bias = bias;
  p.in_stride = C;
  p.N = N;
  p.C = C;
  p.heads = heads;
  p.nw = nw;
  p.scale = scale;
  if (Bw <= 0) return int(cudaErrorInvalidValue);
  return int(launch_hd<false>(p, Bw, static_cast<cudaStream_t>(stream)));
}

// K4.  qkv_map [B, Hp, Wp, 3C] bf16 (Hp, Wp multiples of window; padded and,
// for shifted blocks, rolled); bias [nw, heads, N, N] f32 with nw row-major
// over the (Hp/window, Wp/window) grid; out [B, Hp, Wp, C] bf16.
extern "C" int oryon_band_window_attention_bf16(
    const void* qkv_map, const void* bias, void* out, int B, int Hp, int Wp,
    int C, int heads, int window, float scale, void* stream) {
  if (B <= 0 || window <= 0 || Hp % window != 0 || Wp % window != 0) {
    return int(cudaErrorInvalidValue);
  }
  const auto* base = static_cast<const __nv_bfloat16*>(qkv_map);
  WinParams p{};
  p.q = base;
  p.k = base + C;
  p.v = base + 2 * C;
  p.out = static_cast<__nv_bfloat16*>(out);
  p.bias = bias;
  p.in_stride = 3 * C;
  p.N = window * window;
  p.C = C;
  p.heads = heads;
  p.nw = (Hp / window) * (Wp / window);
  p.w = window;
  p.Hp = Hp;
  p.Wp = Wp;
  p.scale = scale;
  return int(launch_hd<true>(p, B * p.nw, static_cast<cudaStream_t>(stream)));
}
