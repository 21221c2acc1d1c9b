// Tensor-core building blocks of the bf16 kernels (conv3d_pack.cu,
// conv3d_dw.cu, conv3d_fuse.cu): bf16 tiles of 64-channel pixel rows in
// shared memory, read by ldmatrix, multiplied by mma.sync m16n8k16 with
// f32 accumulation.
//
// A 64-channel bf16 row (one pixel, or one input channel of a weight tap)
// is 128 bytes: eight 16-byte chunks of 8 channels.  Chunk c of row r is
// stored at chunk position c ^ (r & 7), so the 8 rows an ldmatrix 8x8
// matrix reads (8 consecutive pixels or channels) fall in 8 different
// bank groups.
#pragma once

#include <cuda_bf16.h>
#include <stdint.h>

namespace bf16_mma {

constexpr int ROW_BYTES = 128;  // 64 bf16 channels

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// byte offset of 16-byte chunk `chunk` (0..7) of row `row`
__device__ __forceinline__ uint32_t swz(int row, int chunk) {
  return (uint32_t)(row * ROW_BYTES + ((chunk ^ (row & 7)) << 4));
}

// byte offset of channel pair (co, co + 1), co even, of row `row`
__device__ __forceinline__ uint32_t swz_pair(int row, int co) {
  return swz(row, co >> 3) + (uint32_t)((co & 7) * 2);
}

// four 8x8 b16 matrices; lane l gives the row address of matrix l / 8
__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr)
               : "memory");
}

// the same, each matrix transposed
__device__ __forceinline__ void ldsm_x4_t(uint32_t (&r)[4], uint32_t addr) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr)
      : "memory");
}

// d += a (16x16, row-major) * b (16x8, column-major), bf16 in, f32 out
__device__ __forceinline__ void mma(float (&d)[4], const uint32_t (&a)[4],
                                    uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// 16 bytes global -> shared without registers; `valid` false fills zeros
// (nothing is read from `src`, which must still be a global address)
__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src,
                                           bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
               :
               : "r"(dst), "l"(src), "r"(valid ? 16 : 0)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// wait until at most N of this thread's newest copy groups are in flight
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// acc[n] += A (16 pixels x 64 channels) * W (64 x 64) for one tap: the A
// row of this lane is pixel row `a_row` of `a_base`; `w_base` holds the
// tap's 64 input-channel rows of 64 output channels.  The lane's ldmatrix
// rows: A = its pixel, channels 8 * (lane >> 4) on of each k16 step;
// B = input channel ((lane >> 3) & 1) * 8 + (lane & 7) of the step, n8
// tile lane >> 4 of each pair.
__device__ __forceinline__ void tap_16x64(float (&acc)[8][4], uint32_t a_base,
                                          int a_row, uint32_t w_base,
                                          int lane) {
  const int a_half = lane >> 4;
  const int b_k = ((lane >> 3) & 1) * 8 + (lane & 7);
  const int b_half = lane >> 4;
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) {
    uint32_t a[4];
    ldsm_x4(a, a_base + swz(a_row, kk * 2 + a_half));
    const int k = kk * 16 + b_k;
#pragma unroll
    for (int np = 0; np < 4; ++np) {
      uint32_t b[4];
      ldsm_x4_t(b, w_base + swz(k, np * 2 + b_half));
      mma(acc[2 * np], a, b[0], b[1]);
      mma(acc[2 * np + 1], a, b[2], b[3]);
    }
  }
}

}  // namespace bf16_mma
