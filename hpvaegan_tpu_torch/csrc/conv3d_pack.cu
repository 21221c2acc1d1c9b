// K1 forward: 3x3x3 SAME conv, 64 -> 64 channels, stride 1, f32.
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
// Design (simple first; the tensor-core version is later work):
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
// Plain C interface, loaded with ctypes; launches on the caller's stream
// and returns cudaGetLastError().

#include <cuda_runtime.h>
#include <stddef.h>

namespace {

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

}  // extern "C"
