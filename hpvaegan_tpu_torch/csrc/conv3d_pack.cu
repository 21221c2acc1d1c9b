// K1 forward: 3x3x3 SAME conv, 64 -> 64 channels, stride 1, f32 and bf16.
//
// Replaces the TPU kernel conv3d64_pallas
// (hpvaegan_tpu/ops/pallas/conv3d_pack.py:182).  It computes the same
// function,
//
//   y[b,t,h,w,co] = bias[co]
//       + sum_{dt,dh,dw,ci} x[b, t+dt-1, h+dh-1, w+dw-1, ci] * w[dt,dh,dw,ci,co]
//
// with zeros outside the input, optionally followed by LeakyReLU(slope),
// on NTHWC activations and THWIO weights.  The TPU kernel's W-pair lane
// packing (build_w2) only filled the TPU's 128-lane matrix unit; here the
// weights are read as THWIO directly and ragged edges are bounds-checked,
// so nothing outside the input is ever read.
//
// Design of the f32 instance (CUDA cores; f32 has no tensor-core route
// with f32 numerics):
//   * one block per (b, t, TILE_H x TILE_W output tile), all 64 output
//     channels; 128 threads, each owning 8 output columns x 8 channels
//     (64 f32 accumulators in registers);
//   * per temporal tap the (TILE_H+2) x (TILE_W+2) x 64 input slab is
//     staged in shared memory, channel-major, zero-filled outside the
//     input;
//   * per H tap the three W taps' 64x64 weight tiles (48 KB) are staged
//     in shared memory; each thread loads its 10 input values once per
//     input channel and reuses them across the three W taps;
//   * f32 FMA into f32 accumulators; bias and LeakyReLU fused in the
//     epilogue, stored as float4.
// Bound: 110,592 FMAs per output voxel against 512 bytes moved, so the
// kernel is bound by f32 operations (non-tensor-core FMA rate), not by
// device memory.  Inputs and weights are re-read from L2, not from HBM.
//
// The bf16 instance (conv3d64_pallas with bf16 x, conv3d_pack.py:190-197:
// x, w and the bias in bf16, f32 accumulation, bias and LeakyReLU in f32,
// the output rounded to bf16 once) is conv3d64_fwd_bf16_kernel below, on
// the tensor cores:
//   * an implicit GEMM: M = output pixels, N = 64 output channels,
//     K = 27 taps x 64 input channels, on mma.sync m16n8k16 (bf16 in, f32
//     accumulate);
//   * one block per (b, t, 8 x 32 output tile), 8 warps, one output row of
//     32 pixels each (two m16 tiles x eight n8 tiles: 64 f32 accumulators
//     a thread);
//   * per temporal tap the 10 x 34 x 64 bf16 input slab, per H tap the
//     three W taps' 64 x 64 bf16 weights in shared memory (68,096 bytes),
//     both 16-byte chunks XOR-swizzled by row so that ldmatrix reads 8
//     consecutive pixels (A, the shifted slab rows) or 8 consecutive input
//     channels (B, ldmatrix.trans of the ci-major weights) without bank
//     conflicts;
//   * epilogue: bias + LeakyReLU in f32, round to nearest even, bf16x2
//     stores.
// Bound: 2*27*64*64 FLOP per voxel against 256 bytes moved, so the
// tensor-core rate (989 TFLOP/s dense bf16) bounds it, not the 3.35 TB/s
// of device memory.  wgmma/TMA and a pipelined load are later work.
//
// Plain C interface, loaded with ctypes; launches on the caller's stream
// and returns cudaGetLastError().

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stddef.h>
#include <stdint.h>

#include "bf16_mma.cuh"

namespace {

using namespace bf16_mma;

constexpr int C = 64;
constexpr int TILE_H = 4;
constexpr int TILE_W = 32;
constexpr int PX = 8;                     // output columns per thread
constexpr int CO = 8;                     // output channels per thread
constexpr int CGROUPS = C / CO;           // 8
constexpr int PGROUPS_W = TILE_W / PX;    // 4
constexpr int THREADS = TILE_H * PGROUPS_W * CGROUPS;  // 128
constexpr int SLAB_H = TILE_H + 2;
constexpr int SLAB_W = TILE_W + 2;
constexpr int SLAB_PIX = SLAB_H * SLAB_W;  // 204
// one float of padding per channel row spreads the staging stores over
// more banks (the compute reads are conflict-free either way)
constexpr int SLAB_STRIDE = SLAB_PIX + 1;
constexpr int SMEM_X = C * SLAB_STRIDE;    // floats
constexpr int SMEM_W = 3 * C * C;          // floats: the 3 W taps of one H tap
constexpr size_t SMEM_BYTES = (size_t)(SMEM_X + SMEM_W) * sizeof(float);
static_assert((SMEM_X * sizeof(float)) % 16 == 0, "weight tile must be 16-byte aligned");

__global__ void __launch_bounds__(THREADS, 2)
conv3d64_fwd_kernel(const float* __restrict__ x, const float* __restrict__ w,
                    const float* __restrict__ bias, float* __restrict__ y,
                    int T, int H, int W, int tiles_w, int has_act,
                    float slope) {
  extern __shared__ __align__(16) float smem[];
  float* xs = smem;           // [C][SLAB_STRIDE]
  float* ws = smem + SMEM_X;  // [3][C][C]  (dw, ci, co)

  const int tid = threadIdx.x;
  const int cg = tid % CGROUPS;
  const int pg = tid / CGROUPS;
  const int r = pg / PGROUPS_W;
  const int c0 = (pg % PGROUPS_W) * PX;

  const int h0 = (blockIdx.x / tiles_w) * TILE_H;
  const int w0 = (blockIdx.x % tiles_w) * TILE_W;
  const int t = blockIdx.y;
  const int b = blockIdx.z;
  const size_t frame = (size_t)H * W * C;

  float acc[PX][CO];
#pragma unroll
  for (int j = 0; j < PX; ++j)
#pragma unroll
    for (int k = 0; k < CO; ++k) acc[j][k] = 0.f;

  for (int dt = 0; dt < 3; ++dt) {
    const int tt = t + dt - 1;
    if (tt < 0 || tt >= T) continue;  // uniform across the block
    const float* xt = x + ((size_t)b * T + tt) * frame;

    __syncthreads();  // every thread is done with the previous slab/weights
    for (int i = tid; i < SLAB_PIX * (C / 4); i += THREADS) {
      const int pix = i / (C / 4);
      const int c4 = i % (C / 4);
      const int sr = pix / SLAB_W;
      const int sc = pix - sr * SLAB_W;
      const int hh = h0 - 1 + sr;
      const int ww = w0 - 1 + sc;
      float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
      if (hh >= 0 && hh < H && ww >= 0 && ww < W)
        v = __ldg(reinterpret_cast<const float4*>(
                      xt + ((size_t)hh * W + ww) * C) + c4);
      float* dst = xs + (c4 * 4) * SLAB_STRIDE + pix;
      dst[0] = v.x;
      dst[SLAB_STRIDE] = v.y;
      dst[2 * SLAB_STRIDE] = v.z;
      dst[3 * SLAB_STRIDE] = v.w;
    }

    for (int dh = 0; dh < 3; ++dh) {
      if (dh > 0) __syncthreads();  // the previous H tap's weights are consumed
      const float4* wsrc = reinterpret_cast<const float4*>(
          w + (size_t)(dt * 3 + dh) * 3 * C * C);
      float4* wdst = reinterpret_cast<float4*>(ws);
      for (int i = tid; i < 3 * C * C / 4; i += THREADS) wdst[i] = __ldg(wsrc + i);
      __syncthreads();

      const float* xrow = xs + (r + dh) * SLAB_W + c0;
      const float4* w4 = reinterpret_cast<const float4*>(ws) + cg * (CO / 4);
#pragma unroll 2
      for (int ci = 0; ci < C; ++ci) {
        float xv[PX + 2];
#pragma unroll
        for (int j = 0; j < PX + 2; ++j) xv[j] = xrow[ci * SLAB_STRIDE + j];
#pragma unroll
        for (int dw = 0; dw < 3; ++dw) {
          const float4 wa = w4[(dw * C + ci) * (C / 4)];
          const float4 wb = w4[(dw * C + ci) * (C / 4) + 1];
#pragma unroll
          for (int j = 0; j < PX; ++j) {
            const float xj = xv[j + dw];
            acc[j][0] = fmaf(xj, wa.x, acc[j][0]);
            acc[j][1] = fmaf(xj, wa.y, acc[j][1]);
            acc[j][2] = fmaf(xj, wa.z, acc[j][2]);
            acc[j][3] = fmaf(xj, wa.w, acc[j][3]);
            acc[j][4] = fmaf(xj, wb.x, acc[j][4]);
            acc[j][5] = fmaf(xj, wb.y, acc[j][5]);
            acc[j][6] = fmaf(xj, wb.z, acc[j][6]);
            acc[j][7] = fmaf(xj, wb.w, acc[j][7]);
          }
        }
      }
    }
  }

  const int h = h0 + r;
  if (h >= H) return;
  float bv[CO];
#pragma unroll
  for (int k = 0; k < CO; ++k) bv[k] = bias != nullptr ? bias[cg * CO + k] : 0.f;
  float* yrow = y + (((size_t)b * T + t) * H + h) * (size_t)W * C;
#pragma unroll
  for (int j = 0; j < PX; ++j) {
    const int ww = w0 + c0 + j;
    if (ww >= W) break;
    float o[CO];
#pragma unroll
    for (int k = 0; k < CO; ++k) {
      const float v = acc[j][k] + bv[k];
      o[k] = (has_act && v < 0.f) ? v * slope : v;
    }
    float4* dst = reinterpret_cast<float4*>(yrow + (size_t)ww * C + cg * CO);
    dst[0] = make_float4(o[0], o[1], o[2], o[3]);
    dst[1] = make_float4(o[4], o[5], o[6], o[7]);
  }
}

// ---------------------------------------------------------------------------
// bf16 on the tensor cores
// ---------------------------------------------------------------------------

constexpr int BF_TILE_H = 8;
constexpr int BF_TILE_W = 32;
constexpr int BF_THREADS = 32 * BF_TILE_H;     // one warp per output row
constexpr int BF_SLAB_W = BF_TILE_W + 2;
constexpr int BF_SLAB_PIX = (BF_TILE_H + 2) * BF_SLAB_W;  // 340
constexpr size_t BF_SMEM_X = (size_t)BF_SLAB_PIX * ROW_BYTES;  // 43,520
constexpr size_t BF_SMEM_W = (size_t)3 * C * ROW_BYTES;        // 24,576
constexpr size_t BF_SMEM_BYTES = BF_SMEM_X + BF_SMEM_W;

__global__ void __launch_bounds__(BF_THREADS, 2)
conv3d64_fwd_bf16_kernel(const __nv_bfloat16* __restrict__ x,
                         const __nv_bfloat16* __restrict__ w,
                         const __nv_bfloat16* __restrict__ bias,
                         __nv_bfloat16* __restrict__ y, int T, int H, int W,
                         int tiles_w, int has_act, float slope) {
  extern __shared__ __align__(128) unsigned char smem_bf[];
  unsigned char* xs = smem_bf;              // [340 pixels][64 ci], swizzled
  unsigned char* ws = smem_bf + BF_SMEM_X;  // [3 W taps * 64 ci][64 co], swizzled
  const uint32_t xs_s = smem_u32(xs);
  const uint32_t ws_s = smem_u32(ws);

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;  // output row of the tile
  const int h0 = (blockIdx.x / tiles_w) * BF_TILE_H;
  const int w0 = (blockIdx.x % tiles_w) * BF_TILE_W;
  const int t = blockIdx.y;
  const int b = blockIdx.z;
  const size_t frame = (size_t)H * W * C;

  // ldmatrix row of this lane: A = pixel (lane & 15) of an m16 tile, input
  // channels 8 * (lane >> 4) on of the k16 step; B = input channel
  // ((lane >> 3) & 1) * 8 + (lane & 7) of the k16 step, n8 tile lane >> 4
  // of the pair
  const int a_pix = lane & 15;
  const int a_half = lane >> 4;
  const int b_k = ((lane >> 3) & 1) * 8 + (lane & 7);
  const int b_half = lane >> 4;

  float acc[2][8][4];
#pragma unroll
  for (int m = 0; m < 2; ++m)
#pragma unroll
    for (int n = 0; n < 8; ++n)
#pragma unroll
      for (int k = 0; k < 4; ++k) acc[m][n][k] = 0.f;

  for (int dt = 0; dt < 3; ++dt) {
    const int tt = t + dt - 1;
    if (tt < 0 || tt >= T) continue;  // uniform across the block
    const __nv_bfloat16* xt = x + ((size_t)b * T + tt) * frame;

    __syncthreads();  // every warp is done with the previous slab/weights
    for (int i = tid; i < BF_SLAB_PIX * 8; i += BF_THREADS) {
      const int pix = i >> 3;
      const int ch = i & 7;
      const int sr = pix / BF_SLAB_W;
      const int sc = pix - sr * BF_SLAB_W;
      const int hh = h0 - 1 + sr;
      const int ww = w0 - 1 + sc;
      uint4 v = make_uint4(0u, 0u, 0u, 0u);
      if (hh >= 0 && hh < H && ww >= 0 && ww < W)
        v = __ldg(reinterpret_cast<const uint4*>(
                      xt + ((size_t)hh * W + ww) * C) + ch);
      *reinterpret_cast<uint4*>(xs + swz(pix, ch)) = v;
    }

    for (int dh = 0; dh < 3; ++dh) {
      if (dh > 0) __syncthreads();  // the previous H tap's weights are consumed
      const uint4* wsrc = reinterpret_cast<const uint4*>(
          w + (size_t)(dt * 3 + dh) * 3 * C * C);
      for (int i = tid; i < 3 * C * 8; i += BF_THREADS)
        *reinterpret_cast<uint4*>(ws + swz(i >> 3, i & 7)) = __ldg(wsrc + i);
      __syncthreads();

#pragma unroll 1
      for (int dw = 0; dw < 3; ++dw) {
        const int pix0 = (warp + dh) * BF_SLAB_W + dw + a_pix;
        const uint32_t wtap = ws_s + (uint32_t)(dw * C * ROW_BYTES);
#pragma unroll
        for (int kk = 0; kk < 4; ++kk) {
          uint32_t a[2][4];
#pragma unroll
          for (int m = 0; m < 2; ++m)
            ldsm_x4(a[m], xs_s + swz(pix0 + m * 16, kk * 2 + a_half));
          const int k = kk * 16 + b_k;
#pragma unroll
          for (int np = 0; np < 4; ++np) {
            uint32_t bq[4];
            ldsm_x4_t(bq, wtap + swz(k, np * 2 + b_half));
#pragma unroll
            for (int m = 0; m < 2; ++m) {
              mma(acc[m][2 * np], a[m], bq[0], bq[1]);
              mma(acc[m][2 * np + 1], a[m], bq[2], bq[3]);
            }
          }
        }
      }
    }
  }

  // accumulator (m, n, j): pixel m*16 + lane/4 (+8 for j >= 2), output
  // channels n*8 + 2*(lane%4) + (j & 1)
  const int h = h0 + warp;
  if (h >= H) return;
  const int g = lane >> 2;
  const int q = lane & 3;
  __nv_bfloat16* yrow = y + (((size_t)b * T + t) * H + h) * (size_t)W * C;
#pragma unroll
  for (int n = 0; n < 8; ++n) {
    const int co = n * 8 + 2 * q;
    const float b0 = bias != nullptr ? __bfloat162float(bias[co]) : 0.f;
    const float b1 = bias != nullptr ? __bfloat162float(bias[co + 1]) : 0.f;
#pragma unroll
    for (int m = 0; m < 2; ++m)
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int ww = w0 + m * 16 + g + half * 8;
        if (ww >= W) continue;
        float v0 = acc[m][n][2 * half] + b0;
        float v1 = acc[m][n][2 * half + 1] + b1;
        if (has_act) {
          v0 = v0 < 0.f ? v0 * slope : v0;
          v1 = v1 < 0.f ? v1 * slope : v1;
        }
        *reinterpret_cast<__nv_bfloat162*>(yrow + (size_t)ww * C + co) =
            __floats2bfloat162_rn(v0, v1);
      }
  }
}

}  // namespace

extern "C" {

// x: (B,T,H,W,64) f32, w: (3,3,3,64,64) f32 THWIO, bias: (64,) f32 or
// NULL, y: (B,T,H,W,64) f32; all contiguous and 16-byte aligned.
// Returns the CUDA error code of the launch (0 on success).
int conv3d64_fwd_f32(const float* x, const float* w, const float* bias,
                     float* y, int B, int T, int H, int W, int has_act,
                     float slope, void* stream) {
  cudaError_t err = cudaFuncSetAttribute(
      conv3d64_fwd_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)SMEM_BYTES);
  if (err != cudaSuccess) return (int)err;
  const int tiles_w = (W + TILE_W - 1) / TILE_W;
  const int tiles_h = (H + TILE_H - 1) / TILE_H;
  const dim3 grid((unsigned)(tiles_w * tiles_h), (unsigned)T, (unsigned)B);
  conv3d64_fwd_kernel<<<grid, THREADS, SMEM_BYTES, (cudaStream_t)stream>>>(
      x, w, bias, y, T, H, W, tiles_w, has_act, slope);
  return (int)cudaGetLastError();
}

// Dynamic shared memory and threads per block of one launch, for reports.
int conv3d64_fwd_f32_config(int* smem_bytes, int* threads) {
  *smem_bytes = (int)SMEM_BYTES;
  *threads = THREADS;
  return 0;
}

// The bf16 instance: x, y (B,T,H,W,64) bf16; w (3,3,3,64,64) bf16 THWIO;
// bias (64,) bf16 or NULL; f32 accumulation, y rounded to nearest even.
// All contiguous and 16-byte aligned.  Returns the CUDA error code.
int conv3d64_fwd_bf16(const void* x, const void* w, const void* bias, void* y,
                      int B, int T, int H, int W, int has_act, float slope,
                      void* stream) {
  cudaError_t err = cudaFuncSetAttribute(
      conv3d64_fwd_bf16_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)BF_SMEM_BYTES);
  if (err != cudaSuccess) return (int)err;
  const int tiles_w = (W + BF_TILE_W - 1) / BF_TILE_W;
  const int tiles_h = (H + BF_TILE_H - 1) / BF_TILE_H;
  const dim3 grid((unsigned)(tiles_w * tiles_h), (unsigned)T, (unsigned)B);
  conv3d64_fwd_bf16_kernel<<<grid, BF_THREADS, BF_SMEM_BYTES,
                             (cudaStream_t)stream>>>(
      static_cast<const __nv_bfloat16*>(x),
      static_cast<const __nv_bfloat16*>(w),
      static_cast<const __nv_bfloat16*>(bias),
      static_cast<__nv_bfloat16*>(y), T, H, W, tiles_w, has_act, slope);
  return (int)cudaGetLastError();
}

int conv3d64_fwd_bf16_config(int* smem_bytes, int* threads) {
  *smem_bytes = (int)BF_SMEM_BYTES;
  *threads = BF_THREADS;
  return 0;
}

}  // extern "C"
