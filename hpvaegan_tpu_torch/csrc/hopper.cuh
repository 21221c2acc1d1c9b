// Hopper building blocks of the wgmma kernels (conv3d_dw.cu,
// conv3d_pack.cu, conv3d_fuse.cu): mbarriers, TMA loads of tiles of
// bf16 NTHWC activations and THWIO weights with the 128-byte swizzle,
// wgmma m64n64k16 with A from registers or from shared memory and B from
// shared memory, the bf16 store of an accumulator's pixel, and the
// host-side encoding of tensor maps.
//
// A TMA tile with the 128-byte swizzle stores 16-byte chunk c of 128-byte
// row r at chunk position c ^ (r & 7) of a 1024-byte-aligned buffer: the
// layout of bf16_mma.cuh's swz(), so ldmatrix reads it with swz().
#pragma once

#include <cuda.h>  // CUtensorMap and its enums; no libcuda link: the
                   // encoder is looked up through the runtime
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace hopper {

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar), "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar) : "memory");
}

__device__ __forceinline__ void mbar_arrive_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar),
               "r"(bytes)
               : "memory");
}

// until the phase of parity `parity` of the barrier has completed
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done = 0;
  while (!done)
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
}

// one box of a 5-D tensor map (c, w, h, t, b) into shared memory
__device__ __forceinline__ void tma_load_5d(uint32_t dst, const CUtensorMap* map,
                                            uint32_t bar, int w, int h, int t,
                                            int b) {
  asm volatile(
      "cp.async.bulk.tensor.5d.shared::cluster.global.tile.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%2, %3, %4, %5, %6}], [%7];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(0), "r"(w), "r"(h), "r"(t), "r"(b),
      "r"(bar)
      : "memory");
}

// one box of a 2-D tensor map (co, row) into shared memory
__device__ __forceinline__ void tma_load_2d(uint32_t dst, const CUtensorMap* map,
                                            uint32_t bar, int row) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.tile.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%2, %3}], [%4];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(0), "r"(row), "r"(bar)
      : "memory");
}

// matrix descriptor of a B tile at `addr` (1024-aligned atoms): K rows of
// N = 64 bf16, N contiguous in 128-byte rows (MN-major), 128-byte
// swizzle; 8-row K groups 1024 bytes apart (SBO); one 64-wide N atom
// (LBO unused)
__device__ __forceinline__ uint64_t mn_desc(uint32_t addr) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) | ((uint64_t)1 << 16) |
         ((uint64_t)(1024 >> 4) << 32) | ((uint64_t)1 << 62);
}

// matrix descriptor of an A tile at `addr`: 64 rows (pixels) of 128 bytes
// with K (input channels) contiguous, 128-byte swizzle, 8-row groups 1024
// bytes apart (SBO).  `addr` may start at any row and any 32-byte K step
// of a 1024-aligned swizzled buffer: the tensor cores apply the swizzle to
// the address bits, so a one-pixel shift needs no base offset (measured:
// tools/kernel_variants.py k1-a)
__device__ __forceinline__ uint64_t k_desc(uint32_t addr) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) | ((uint64_t)1 << 16) |
         ((uint64_t)(1024 >> 4) << 32) | ((uint64_t)1 << 62);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// d (64 x 64 f32) += a (64 x 16 bf16, registers) * B (16 x 64 bf16, desc)
__device__ __forceinline__ void wgmma_64x64(float (&d)[32], const uint32_t (&a)[4],
                                            uint64_t desc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, "
      "%31}, {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]),
        "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]),
        "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]), "+f"(d[26]),
        "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(1));
}

// d (64 x 64 f32) += A (64 x 16 bf16, K-major desc) * B (16 x 64 bf16, desc)
__device__ __forceinline__ void wgmma_64x64_ss(float (&d)[32], uint64_t da,
                                               uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, "
      "%31}, %32, %33, p, 1, 1, 0, 1;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]),
        "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]),
        "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]), "+f"(d[26]),
        "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(da), "l"(db), "r"(1));
}

// Store one pixel's 64 bf16 channels from an m64n64 accumulator: `pk[j]`
// is this lane's channel pair 8j + 2(lane % 4) as bf16x2.  Lanes 2i and
// 2i + 1 swap halves so that each stores 8 bytes (4 consecutive
// channels) a chunk pair.  Every lane of the warp must call it (it
// shuffles); `dst` is the pixel's first channel, or nullptr to store
// nothing.
__device__ __forceinline__ void store_pixel_bf16(__nv_bfloat16* dst,
                                                 const uint32_t (&pk)[8], int lane) {
  const bool odd = lane & 1;
#pragma unroll
  for (int r = 0; r < 4; ++r) {
    const uint32_t got = __shfl_xor_sync(0xffffffffu, odd ? pk[2 * r] : pk[2 * r + 1], 1);
    if (dst != nullptr) {
      // chunk 2r + odd, channel pairs (lane & 2) and (lane & 2) + 1
      const uint2 v = odd ? make_uint2(got, pk[2 * r + 1]) : make_uint2(pk[2 * r], got);
      *reinterpret_cast<uint2*>(dst + 8 * (2 * r + odd) + 2 * (lane & 2)) = v;
    }
  }
}

// cuTensorMapEncodeTiled from the driver, through the runtime (the
// libraries are not linked against libcuda)
typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                const cuuint32_t*, CUtensorMapInterleave,
                                CUtensorMapSwizzle, CUtensorMapL2promotion,
                                CUtensorMapFloatOOBfill);

inline EncodeTiled encode_tiled() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult q;
#if CUDART_VERSION >= 12050
    if (cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &p, 12000,
                                         cudaEnableDefault, &q) == cudaSuccess &&
        q == cudaDriverEntryPointSuccess)
#else
    if (cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault,
                                &q) == cudaSuccess &&
        q == cudaDriverEntryPointSuccess)
#endif
      fn = reinterpret_cast<EncodeTiled>(p);
  }
  return fn;
}

inline int encode(CUtensorMap* map, const void* base, cuuint32_t rank,
                  const cuuint64_t* dims, const cuuint64_t* strides,
                  const cuuint32_t* box) {
  const EncodeTiled fn = encode_tiled();
  if (fn == nullptr) return (int)cudaErrorInvalidValue;
  const cuuint32_t elem[5] = {1, 1, 1, 1, 1};
  const CUresult res =
      fn(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, rank, const_cast<void*>(base), dims,
         strides, box, elem, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
         CU_TENSOR_MAP_L2_PROMOTION_L2_256B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return res == CUDA_SUCCESS ? 0 : 1000 + (int)res;
}

// a 5-D map (c, w, h, t, b) of a bf16 NTHWC tensor with 64 channels and
// boxes of (64, box_w, box_h, 1, 1), 128-byte swizzle, zero fill outside
inline int encode_nthwc(CUtensorMap* map, const void* base, int B, int T, int H,
                        int W, int box_w, int box_h = 1) {
  const cuuint64_t dims[5] = {64, (cuuint64_t)W, (cuuint64_t)H, (cuuint64_t)T,
                              (cuuint64_t)B};
  const cuuint64_t row = 64 * 2;
  const cuuint64_t strides[4] = {row, row * W, row * W * H, row * W * H * T};
  const cuuint32_t box[5] = {64, (cuuint32_t)box_w, (cuuint32_t)box_h, 1, 1};
  return encode(map, base, 5, dims, strides, box);
}

// a 2-D map (co, row) of bf16 THWIO weights (3,3,3,64,64): 27 * 64 input
// channel rows of 64 output channels, boxes of box_rows rows
inline int encode_weights(CUtensorMap* map, const void* base, int box_rows) {
  const cuuint64_t dims[2] = {64, 27 * 64};
  const cuuint64_t strides[1] = {64 * 2};
  const cuuint32_t box[2] = {64, (cuuint32_t)box_rows};
  return encode(map, base, 2, dims, strides, box);
}

}  // namespace hopper
