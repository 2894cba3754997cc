// The Hopper pieces the wgmma kernels of this library share (attn_wgmma.cuh:
// K1, K1-i8 and K5 at head dimension 64; match_wgmma.cuh and match_tf32.cuh:
// K2 in its bf16 and fp32 modes; swin_wgmma.cuh: K3 and K4 at head dimension
// 32):
// `mbarrier`s, TMA tile loads through tensor maps, shared-memory matrix
// descriptors and the wgmma fences, as inline PTX, and the host-side encoding
// of a tensor map.

#pragma once

#include <cuda.h>  // CUtensorMap and its enums; cuTensorMapEncodeTiled itself
                   // is looked up at run time, so nothing links against libcuda
#include <cuda_runtime.h>
#include <stdint.h>

namespace oryon_hopper {

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint32_t bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(bar), "r"(count)
               : "memory");
}

// After the barriers are initialised by one thread, before any other thread
// or the TMA unit uses them.
__device__ __forceinline__ void mbar_init_fence() {
  asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];" ::"r"(bar) : "memory");
}

__device__ __forceinline__ void mbar_arrive_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(bar),
               "r"(bytes)
               : "memory");
}

// Wait until the barrier has left the phase of the given parity.  A barrier
// that never completes (a programming error) traps after about 2^28 polls
// instead of hanging the card.
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done = 0;
  for (uint32_t polls = 0; !done; ++polls) {
    asm volatile(
        "{\n"
        ".reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n"
        "}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
    if (polls == (1u << 28)) __trap();
  }
}

// One box of the map (its shape is the map's) at (col, row, plane) into
// shared memory; elements past the tensor's end arrive as zeros.  The box's
// bytes are counted on the barrier.
__device__ __forceinline__ void tma_load_tile(uint32_t dst, const CUtensorMap* map,
                                              uint32_t bar, int col, int row,
                                              int plane) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%3, %4, %5}], [%2];"
      ::"r"(dst), "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(col),
      "r"(row), "r"(plane)
      : "memory");
}

// The same for a map of four dimensions: the box's rows land in shared memory
// one after the other, c1 fastest, then c2 (a [w, w] patch of a feature map
// becomes w * w consecutive rows).
__device__ __forceinline__ void tma_load_tile4(uint32_t dst, const CUtensorMap* map,
                                               uint32_t bar, int c0, int c1, int c2,
                                               int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%3, %4, %5, %6}], [%2];"
      ::"r"(dst), "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1),
      "r"(c2), "r"(c3)
      : "memory");
}

// A contiguous run of `bytes` (a multiple of 16; both addresses 16-byte
// aligned) from device memory into shared memory, counted on the barrier.
__device__ __forceinline__ void bulk_load(uint32_t dst, const void* src, uint32_t bytes,
                                          uint32_t bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];"
      ::"r"(dst), "l"(src), "r"(bytes), "r"(bar)
      : "memory");
}

// Makes this thread's ordinary shared-memory writes visible to the
// asynchronous proxy (TMA, wgmma operand reads) before a barrier hands the
// memory over.
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
}

__device__ __forceinline__ void named_barrier_sync(int id, int threads) {
  asm volatile("bar.sync %0, %1;" ::"r"(id), "r"(threads) : "memory");
}

// Shared-memory matrix descriptor of a tile whose rows are one swizzle span
// wide (128 bytes under the 128-byte swizzle, 64 bytes under the 64-byte
// swizzle), as TMA writes it with the matching swizzle of the tensor map:
// 8-row groups lie `8 * row bytes` apart (the stride byte offset); the leading
// byte offset is not used (one swizzle atom along K).  A K-major operand (the
// K values of a row are contiguous) advances its start address by 32 bytes
// per wgmma k step (16 bf16, 32 int8 or 8 tf32 values); tile bases are 1024-byte
// aligned, so the step leaves the swizzle phase (address bits 7 and up) alone.
// An MN-major B operand (a [keys, head dim] V tile read as it lies, with the
// transposed-B bit of the instruction) takes the same descriptor: its rows are
// the K values, 8-row groups the stride byte offset apart, and a k16 step
// advances the start address by 16 rows (2048 bytes under the 128-byte
// swizzle, 1024 under the 64-byte one).
enum Swizzle { kSwizzle128 = 1, kSwizzle64 = 2 };

template <int SWIZZLE>
__device__ __forceinline__ uint64_t make_desc(uint32_t smem_addr) {
  constexpr int kRowBytes = (SWIZZLE == kSwizzle128) ? 128 : 64;
  uint64_t desc = 0;
  desc |= uint64_t((smem_addr & 0x3FFFFu) >> 4);  // start address
  desc |= uint64_t(1) << 16;                      // leading byte offset (unused)
  desc |= uint64_t((8 * kRowBytes) >> 4) << 32;   // stride byte offset
  desc |= uint64_t(SWIZZLE) << 62;                // swizzle mode
  return desc;
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;" ::: "memory");
}
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;" ::"n"(N) : "memory");
}

// --------------------------------------------------------------- host side

typedef CUresult (*EncodeTiledFn)(CUtensorMap*, CUtensorMapDataType, cuuint32_t,
                                  void*, const cuuint64_t*, const cuuint64_t*,
                                  const cuuint32_t*, const cuuint32_t*,
                                  CUtensorMapInterleave, CUtensorMapSwizzle,
                                  CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled looked up in the loaded libcuda, so that the link
// line needs no -lcuda.
inline EncodeTiledFn encode_tiled_fn() {
  static EncodeTiledFn fn = [] {
    void* ptr = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    cudaError_t err = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &ptr, 12000, cudaEnableDefault, &found);
#else
    cudaError_t err = cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &ptr,
                                              cudaEnableDefault, &found);
#endif
    if (err != cudaSuccess || found != cudaDriverEntryPointSuccess) ptr = nullptr;
    return reinterpret_cast<EncodeTiledFn>(ptr);
  }();
  return fn;
}

// A map over a tensor of `rank` (3 or 4) dimensions, dims[0] the contiguous
// one, of elements of `elem_bytes` (4: f32, 2: bf16, 1: int8 as bytes; the
// bits are copied as they lie); strides[i] is
// the byte stride of dimension i + 1.  It loads boxes of box[] elements with
// zero fill out of bounds.  A box row (box[0] elements) is one swizzle span:
// 128 bytes takes the 128-byte swizzle, 64 bytes the 64-byte one.
inline cudaError_t encode_map_nd(CUtensorMap* map, const void* base, int elem_bytes,
                                 int rank, const uint64_t* dims,
                                 const uint64_t* strides, const uint32_t* box) {
  EncodeTiledFn fn = encode_tiled_fn();
  if (fn == nullptr) return cudaErrorNotSupported;
  if (reinterpret_cast<uintptr_t>(base) % 16 != 0) return cudaErrorMisalignedAddress;
  const uint32_t span = box[0] * elem_bytes;
  if ((span != 128 && span != 64) || rank < 3 || rank > 4) return cudaErrorInvalidValue;
  cuuint64_t g_dims[4], g_strides[3];
  cuuint32_t g_box[4];
  const cuuint32_t elem_strides[4] = {1, 1, 1, 1};
  for (int i = 0; i < rank; ++i) {
    g_dims[i] = dims[i];
    g_box[i] = box[i];
    if (i + 1 < rank) g_strides[i] = strides[i];
  }
  const CUresult res = fn(
      map,
      elem_bytes == 4   ? CU_TENSOR_MAP_DATA_TYPE_FLOAT32
      : elem_bytes == 2 ? CU_TENSOR_MAP_DATA_TYPE_BFLOAT16
                        : CU_TENSOR_MAP_DATA_TYPE_UINT8,
      rank, const_cast<void*>(base), g_dims, g_strides, g_box, elem_strides,
      CU_TENSOR_MAP_INTERLEAVE_NONE,
      span == 128 ? CU_TENSOR_MAP_SWIZZLE_128B : CU_TENSOR_MAP_SWIZZLE_64B,
      CU_TENSOR_MAP_L2_PROMOTION_L2_128B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return res == CUDA_SUCCESS ? cudaSuccess : cudaErrorInvalidValue;
}

// The three-dimensional form: a map over [planes, rows, cols] that loads
// boxes of [box_rows, box_cols].
inline cudaError_t encode_map(CUtensorMap* map, const void* base, int elem_bytes,
                              uint64_t cols, uint64_t rows, uint64_t planes,
                              uint64_t row_bytes, uint64_t plane_bytes,
                              uint32_t box_cols, uint32_t box_rows) {
  const uint64_t dims[3] = {cols, rows, planes};
  const uint64_t strides[2] = {row_bytes, plane_bytes};
  const uint32_t box[3] = {box_cols, box_rows, 1};
  return encode_map_nd(map, base, elem_bytes, 3, dims, strides, box);
}

}  // namespace oryon_hopper
