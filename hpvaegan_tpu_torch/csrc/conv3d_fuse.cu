// K2: two fused 3x3x3 SAME convs, 64 -> 64 -> 64 channels, f32 and bf16,
//
//   z = lrelu(conv(x, w1) + b1),   y = lrelu(conv(z, w2) + b2)
//
// with the intermediate z kept in shared memory; optionally z is written
// out too (with_mid, the backward's residual).
//
// Replaces the TPU kernel conv3d64_pair_pallas
// (hpvaegan_tpu/ops/pallas/conv3d_fuse.py:215), the WDiscriminator body's
// conv pairs under --pfuse.  NTHWC activations, THWIO weights.
//
// Design (simple first), after the TPU kernel's grid with T innermost
// (conv3d_fuse.py:19-26):
//   * one block per (b, TILE_H x TILE_W output column), 128 threads; the
//     block streams T;
//   * a 3-slot ring of z slices in shared memory, each slice with a
//     1-row/1-column halo ((TILE_H+2) x (TILE_W+2) x 64), so each T step
//     computes ONE new z slice (conv1 over the three x slices around it)
//     and contracts the three cached slices with w2.  Only the spatial
//     halo of z is recomputed by neighbouring blocks, never the temporal
//     one;
//   * z outside the volume is ZERO: it is conv2's SAME padding, not
//     lrelu(conv1(zero-padded x) + b1), which is generally non-zero.  The
//     epilogue of conv1 writes 0 for halo pixels outside H x W (the TPU
//     kernel's row masks and zero lane groups, conv3d_fuse.py:171-173),
//     and conv2 skips the temporal taps whose z slice is outside [0, T)
//     (its zeroed ring slots, :176-193);
//   * per temporal tap the x slab (TILE_H+4) x (TILE_W+4) x 64 is staged
//     channel-major, zero outside the input; per H tap the three W taps'
//     64x64 weights (48 KB); each thread owns 8 consecutive W pixels (7 in
//     conv2) x 8 output channels in registers, as in conv3d_pack.cu.
// Bound: 2 x 2*27*64*64 FLOP per output voxel against one read of x and
// one write of y (and of z with with_mid), so it is bound by f32
// operations.  The recomputed z halo costs (TILE_H+2)(TILE_W+2) /
// (TILE_H*TILE_W) = 1.52x conv1's work.
//
// The bf16 instance (conv3d64_pair_pallas with bf16 x, conv3d_fuse.py:
// 225-233, z ring in x's dtype :173, 282) is conv3d64_pair_bf16_kernel, on
// the tensor cores, with the same grid and T streaming:
//   * bf16 x, weights and biases; f32 accumulation on mma.sync m16n8k16;
//     each z value is rounded to bf16 as it enters the ring, so conv2
//     reads the rounded z; y and z are stored rounded to nearest even;
//   * the ring, the x slab and the weights are bf16 pixel (or input
//     channel) rows of 128 bytes, XOR-swizzled (bf16_mma.cuh): 3 x 128 z
//     pixels + 180 x pixels + 3 x 64 weight rows = 96,768 bytes, two
//     256-thread blocks an SM;
//   * conv1: the z slice's 8 x 16 pixels are 8 m16 tiles, one row a warp;
//     conv2: the 6 x 14 output pixels are 6 m16 tiles (the last 12 rows
//     padding), warps 0-5; each warp all 64 output channels.
// Bound by the bf16 tensor-core rate; every H tap's weights are staged
// again from L2 for each z slice and each output slice (as in the f32
// instance), which the next design should keep resident instead.
//
// Plain C interface, loaded with ctypes; launches on the caller's stream
// and returns cudaGetLastError().

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stddef.h>
#include <stdint.h>

#include "bf16_mma.cuh"

namespace {

constexpr int C = 64;
constexpr int TILE_H = 6;
constexpr int TILE_W = 14;
constexpr int ZH = TILE_H + 2;   // z slice with its halo: 8 x 16
constexpr int ZW = TILE_W + 2;
constexpr int XH = TILE_H + 4;   // x slab feeding it: 10 x 18
constexpr int XW = TILE_W + 4;
constexpr int CO = 8;                  // output channels per thread
constexpr int CGROUPS = C / CO;        // 8
constexpr int THREADS = 128;
constexpr int PX1 = 8;                 // conv1: 8 rows x 2 groups of 8 px
constexpr int PX2 = 7;                 // conv2: 6 rows x 2 groups of 7 px
constexpr int CONV2_THREADS = TILE_H * (TILE_W / PX2) * CGROUPS;  // 96
static_assert(ZH * (ZW / PX1) * CGROUPS == THREADS, "conv1 tiling");
static_assert(ZW % PX1 == 0 && TILE_W % PX2 == 0, "pixel groups");
constexpr int ZSTRIDE = ZH * ZW + 1;   // floats per channel plane
constexpr int XSTRIDE = XH * XW + 1;
constexpr int SMEM_Z = 3 * C * ZSTRIDE;
constexpr int SMEM_X = C * XSTRIDE;
constexpr int SMEM_W = 3 * C * C;
constexpr size_t SMEM_BYTES = (size_t)(SMEM_Z + SMEM_X + SMEM_W) * sizeof(float);
static_assert(((SMEM_Z + SMEM_X) * sizeof(float)) % 16 == 0,
              "weight tile must be 16-byte aligned");

// acc[j][k] += sum_{ci, dw} slab[ci][row][c0 + j + dw] * ws[dw][ci][cg*8 + k]
// for one H tap; `row` points at the slab row of this thread's pixels.
template <int PX, int STRIDE>
__device__ __forceinline__ void accum_taps(const float* row, const float* ws,
                                           int cg, float (&acc)[PX][CO]) {
  const float4* w4 = reinterpret_cast<const float4*>(ws) + cg * (CO / 4);
#pragma unroll 2
  for (int ci = 0; ci < C; ++ci) {
    float xv[PX + 2];
#pragma unroll
    for (int j = 0; j < PX + 2; ++j) xv[j] = row[ci * STRIDE + j];
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

// the three W taps of weight tap (dt, dh): 3 x 64 x 64 floats
__device__ __forceinline__ void stage_weights(float* ws, const float* w,
                                              int dt, int dh) {
  const float4* src = reinterpret_cast<const float4*>(
      w + (size_t)(dt * 3 + dh) * 3 * C * C);
  float4* dst = reinterpret_cast<float4*>(ws);
  for (int i = threadIdx.x; i < 3 * C * C / 4; i += THREADS) dst[i] = __ldg(src + i);
}

__device__ __forceinline__ float lrelu(float v, float slope) {
  return v < 0.f ? v * slope : v;
}

struct Geometry {
  int T, H, W, h0, w0;
  size_t frame;      // floats of one (b, t) slice
  size_t batch_off;  // floats before batch b
};

// z[tz] over rows h0-1 .. h0+TILE_H, columns w0-1 .. w0+TILE_W, into one
// ring slot; zero at pixels outside the volume.
__device__ void conv1_slice(const float* __restrict__ x, const float* __restrict__ w1,
                            const float* __restrict__ b1, float slope,
                            const Geometry& g, int tz, float* zslot,
                            float* xs, float* ws) {
  const int tid = threadIdx.x;
  const int cg = tid % CGROUPS;
  const int pg = tid / CGROUPS;
  const int r = pg / (ZW / PX1);
  const int c0 = (pg % (ZW / PX1)) * PX1;

  float acc[PX1][CO];
#pragma unroll
  for (int j = 0; j < PX1; ++j)
#pragma unroll
    for (int k = 0; k < CO; ++k) acc[j][k] = 0.f;

  for (int kt = 0; kt < 3; ++kt) {
    const int tx = tz + kt - 1;
    if (tx < 0 || tx >= g.T) continue;  // uniform across the block
    const float* xt = x + g.batch_off + (size_t)tx * g.frame;
    __syncthreads();  // the previous slab and weights are consumed
    for (int i = tid; i < XH * XW * (C / 4); i += THREADS) {
      const int pix = i / (C / 4);
      const int c4 = i % (C / 4);
      const int sr = pix / XW;
      const int sc = pix - sr * XW;
      const int hh = g.h0 - 2 + sr;
      const int ww = g.w0 - 2 + sc;
      float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
      if (hh >= 0 && hh < g.H && ww >= 0 && ww < g.W)
        v = __ldg(reinterpret_cast<const float4*>(
                      xt + ((size_t)hh * g.W + ww) * C) + c4);
      float* dst = xs + (c4 * 4) * XSTRIDE + pix;
      dst[0] = v.x;
      dst[XSTRIDE] = v.y;
      dst[2 * XSTRIDE] = v.z;
      dst[3 * XSTRIDE] = v.w;
    }
    for (int dh = 0; dh < 3; ++dh) {
      if (dh > 0) __syncthreads();
      stage_weights(ws, w1, kt, dh);
      __syncthreads();
      accum_taps<PX1, XSTRIDE>(xs + (r + dh) * XW + c0, ws, cg, acc);
    }
  }

  const int hz = g.h0 - 1 + r;
  float bv[CO];
#pragma unroll
  for (int k = 0; k < CO; ++k) bv[k] = b1[cg * CO + k];
#pragma unroll
  for (int j = 0; j < PX1; ++j) {
    const int wz = g.w0 - 1 + c0 + j;
    const bool inside = hz >= 0 && hz < g.H && wz >= 0 && wz < g.W;
#pragma unroll
    for (int k = 0; k < CO; ++k)
      zslot[(cg * CO + k) * ZSTRIDE + r * ZW + c0 + j] =
          inside ? lrelu(acc[j][k] + bv[k], slope) : 0.f;
  }
}

__global__ void __launch_bounds__(THREADS, 1)
conv3d64_pair_kernel(const float* __restrict__ x, const float* __restrict__ w1,
                     const float* __restrict__ b1, const float* __restrict__ w2,
                     const float* __restrict__ b2, float* __restrict__ y,
                     float* __restrict__ mid, int T, int H, int W, int tiles_w,
                     float slope) {
  extern __shared__ __align__(16) float smem[];
  float* zr = smem;                    // [3][C][ZSTRIDE]
  float* xs = smem + SMEM_Z;           // [C][XSTRIDE]
  float* ws = smem + SMEM_Z + SMEM_X;  // [3][C][C]  (dw, ci, co)

  Geometry g;
  g.T = T;
  g.H = H;
  g.W = W;
  g.h0 = (blockIdx.x / tiles_w) * TILE_H;
  g.w0 = (blockIdx.x % tiles_w) * TILE_W;
  g.frame = (size_t)H * W * C;
  g.batch_off = (size_t)blockIdx.y * T * g.frame;

  const int tid = threadIdx.x;
  const int cg = tid % CGROUPS;
  const int pg = tid / CGROUPS;
  const bool active = tid < CONV2_THREADS;
  const int r = pg / (TILE_W / PX2);
  const int c0 = (pg % (TILE_W / PX2)) * PX2;
  float bv[CO];
#pragma unroll
  for (int k = 0; k < CO; ++k) bv[k] = b2[cg * CO + k];

  conv1_slice(x, w1, b1, slope, g, 0, zr, xs, ws);
  for (int t = 0; t < T; ++t) {
    if (t + 1 < T)
      conv1_slice(x, w1, b1, slope, g, t + 1,
                  zr + ((t + 1) % 3) * C * ZSTRIDE, xs, ws);

    float acc[PX2][CO];
#pragma unroll
    for (int j = 0; j < PX2; ++j)
#pragma unroll
      for (int k = 0; k < CO; ++k) acc[j][k] = 0.f;
    for (int kt = 0; kt < 3; ++kt) {
      const int tz = t + kt - 1;
      if (tz < 0 || tz >= T) continue;  // z outside [0, T) is zero
      const float* zslot = zr + (tz % 3) * C * ZSTRIDE;
      for (int dh = 0; dh < 3; ++dh) {
        __syncthreads();  // z writes visible; previous weights consumed
        stage_weights(ws, w2, kt, dh);
        __syncthreads();
        if (active)
          accum_taps<PX2, ZSTRIDE>(zslot + (r + dh) * ZW + c0, ws, cg, acc);
      }
    }

    const int h = g.h0 + r;
    if (!active || h >= H) continue;
    const size_t row = g.batch_off + (size_t)t * g.frame + (size_t)h * W * C;
    const float* zmid = zr + (t % 3) * C * ZSTRIDE + (r + 1) * ZW + 1;
#pragma unroll
    for (int j = 0; j < PX2; ++j) {
      const int ww = g.w0 + c0 + j;
      if (ww >= W) break;
      float o[CO];
#pragma unroll
      for (int k = 0; k < CO; ++k) o[k] = lrelu(acc[j][k] + bv[k], slope);
      float4* dst = reinterpret_cast<float4*>(y + row + (size_t)ww * C + cg * CO);
      dst[0] = make_float4(o[0], o[1], o[2], o[3]);
      dst[1] = make_float4(o[4], o[5], o[6], o[7]);
      if (mid != nullptr) {
        float m[CO];
#pragma unroll
        for (int k = 0; k < CO; ++k) m[k] = zmid[(cg * CO + k) * ZSTRIDE + c0 + j];
        float4* mdst = reinterpret_cast<float4*>(mid + row + (size_t)ww * C + cg * CO);
        mdst[0] = make_float4(m[0], m[1], m[2], m[3]);
        mdst[1] = make_float4(m[4], m[5], m[6], m[7]);
      }
    }
  }
}

// ---------------------------------------------------------------------------
// bf16 on the tensor cores
// ---------------------------------------------------------------------------

constexpr int BF_THREADS = 256;               // 8 warps
constexpr int Z_PIX = ZH * ZW;                // 128: one z slice with its halo
constexpr int X_PIX = XH * XW;                // 180: the x slab feeding it
constexpr int OUT_PIX = TILE_H * TILE_W;      // 84
constexpr int OUT_MTILES = (OUT_PIX + 15) / 16;  // 6
static_assert(Z_PIX == 16 * BF_THREADS / 32, "conv1: one z row of 16 a warp");
static_assert(ZW == 16, "conv1: one z row is one m16 tile");
constexpr int RB = bf16_mma::ROW_BYTES;
constexpr size_t BF_SMEM_Z = (size_t)3 * Z_PIX * RB;   // 49,152
constexpr size_t BF_SMEM_X = (size_t)X_PIX * RB;       // 23,040
constexpr size_t BF_SMEM_W = (size_t)3 * C * RB;       // 24,576
constexpr size_t BF_SMEM_BYTES = BF_SMEM_Z + BF_SMEM_X + BF_SMEM_W;

// the three W taps of weight tap (dt, dh) into `ws`: 3 x 64 rows of 64
__device__ __forceinline__ void stage_weights_bf16(unsigned char* ws,
                                                   const __nv_bfloat16* w,
                                                   int dt, int dh) {
  const uint4* src = reinterpret_cast<const uint4*>(
      w + (size_t)(dt * 3 + dh) * 3 * C * C);
  for (int i = threadIdx.x; i < 3 * C * 8; i += BF_THREADS)
    *reinterpret_cast<uint4*>(ws + bf16_mma::swz(i >> 3, i & 7)) = __ldg(src + i);
}

// z[tz] over rows h0-1 .. h0+TILE_H, columns w0-1 .. w0+TILE_W into ring
// slot `zslot`: zero outside the volume, bf16 rounded.  Warp w computes z
// row w (16 pixels) for all 64 channels.
__device__ void conv1_slice_bf16(const __nv_bfloat16* __restrict__ x,
                                 const __nv_bfloat16* __restrict__ w1,
                                 const __nv_bfloat16* __restrict__ b1,
                                 float slope, const Geometry& g, int tz,
                                 unsigned char* zslot, unsigned char* xs,
                                 unsigned char* ws) {
  using namespace bf16_mma;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const uint32_t xs_s = smem_u32(xs);
  const uint32_t ws_s = smem_u32(ws);

  float acc[8][4];
#pragma unroll
  for (int n = 0; n < 8; ++n)
#pragma unroll
    for (int k = 0; k < 4; ++k) acc[n][k] = 0.f;

  for (int kt = 0; kt < 3; ++kt) {
    const int tx = tz + kt - 1;
    if (tx < 0 || tx >= g.T) continue;  // uniform across the block
    const __nv_bfloat16* xt = x + g.batch_off + (size_t)tx * g.frame;
    __syncthreads();  // the previous slab and weights are consumed
    for (int i = tid; i < X_PIX * 8; i += BF_THREADS) {
      const int pix = i >> 3;
      const int ch = i & 7;
      const int sr = pix / XW;
      const int sc = pix - sr * XW;
      const int hh = g.h0 - 2 + sr;
      const int ww = g.w0 - 2 + sc;
      uint4 v = make_uint4(0u, 0u, 0u, 0u);
      if (hh >= 0 && hh < g.H && ww >= 0 && ww < g.W)
        v = __ldg(reinterpret_cast<const uint4*>(
                      xt + ((size_t)hh * g.W + ww) * C) + ch);
      *reinterpret_cast<uint4*>(xs + swz(pix, ch)) = v;
    }
    for (int dh = 0; dh < 3; ++dh) {
      if (dh > 0) __syncthreads();
      stage_weights_bf16(ws, w1, kt, dh);
      __syncthreads();
#pragma unroll 1
      for (int dw = 0; dw < 3; ++dw)
        tap_16x64(acc, xs_s, (warp + dh) * XW + (lane & 15) + dw,
                  ws_s + (uint32_t)(dw * C * RB), lane);
    }
  }

  // accumulator (n, j): z pixel (warp, lane/4 (+8 for j >= 2)), channels
  // n*8 + 2*(lane%4) + (j & 1)
  const int hz = g.h0 - 1 + warp;
  const int q = lane & 3;
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int zc = (lane >> 2) + half * 8;
    const int wz = g.w0 - 1 + zc;
    const bool inside = hz >= 0 && hz < g.H && wz >= 0 && wz < g.W;
    const int zp = warp * ZW + zc;
#pragma unroll
    for (int n = 0; n < 8; ++n) {
      const int co = n * 8 + 2 * q;
      float v0 = 0.f, v1 = 0.f;
      if (inside) {
        v0 = lrelu(acc[n][2 * half] + __bfloat162float(b1[co]), slope);
        v1 = lrelu(acc[n][2 * half + 1] + __bfloat162float(b1[co + 1]), slope);
      }
      *reinterpret_cast<__nv_bfloat162*>(zslot + swz_pair(zp, co)) =
          __floats2bfloat162_rn(v0, v1);
    }
  }
}

__global__ void __launch_bounds__(BF_THREADS, 2)
conv3d64_pair_bf16_kernel(const __nv_bfloat16* __restrict__ x,
                          const __nv_bfloat16* __restrict__ w1,
                          const __nv_bfloat16* __restrict__ b1,
                          const __nv_bfloat16* __restrict__ w2,
                          const __nv_bfloat16* __restrict__ b2,
                          __nv_bfloat16* __restrict__ y,
                          __nv_bfloat16* __restrict__ mid, int T, int H, int W,
                          int tiles_w, float slope) {
  using namespace bf16_mma;
  extern __shared__ __align__(128) unsigned char smem_bf[];
  unsigned char* zr = smem_bf;                          // [3][128 px] rows
  unsigned char* xs = smem_bf + BF_SMEM_Z;              // [180 px] rows
  unsigned char* ws = smem_bf + BF_SMEM_Z + BF_SMEM_X;  // [3 * 64 ci] rows
  const uint32_t zr_s = smem_u32(zr);
  const uint32_t ws_s = smem_u32(ws);

  Geometry g;
  g.T = T;
  g.H = H;
  g.W = W;
  g.h0 = (blockIdx.x / tiles_w) * TILE_H;
  g.w0 = (blockIdx.x % tiles_w) * TILE_W;
  g.frame = (size_t)H * W * C;
  g.batch_off = (size_t)blockIdx.y * T * g.frame;

  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const bool active = warp < OUT_MTILES;
  // this lane's ldmatrix row in conv2: output pixel warp*16 + lane%16
  // (rows past the tile read pixel OUT_PIX - 1 and are never stored)
  const int a_p = min(warp * 16 + (lane & 15), OUT_PIX - 1);
  const int a_zp = (a_p / TILE_W) * ZW + a_p % TILE_W;  // its z pixel at tap (0, 0)

  conv1_slice_bf16(x, w1, b1, slope, g, 0, zr, xs, ws);
  for (int t = 0; t < T; ++t) {
    if (t + 1 < T)
      conv1_slice_bf16(x, w1, b1, slope, g, t + 1,
                       zr + (size_t)((t + 1) % 3) * Z_PIX * RB, xs, ws);

    float acc[8][4];
#pragma unroll
    for (int n = 0; n < 8; ++n)
#pragma unroll
      for (int k = 0; k < 4; ++k) acc[n][k] = 0.f;
    for (int kt = 0; kt < 3; ++kt) {
      const int tz = t + kt - 1;
      if (tz < 0 || tz >= T) continue;  // z outside [0, T) is zero
      const uint32_t zslot = zr_s + (uint32_t)((tz % 3) * Z_PIX * RB);
      for (int dh = 0; dh < 3; ++dh) {
        __syncthreads();  // z writes visible; previous weights consumed
        stage_weights_bf16(ws, w2, kt, dh);
        __syncthreads();
        if (active) {
#pragma unroll 1
          for (int dw = 0; dw < 3; ++dw)
            tap_16x64(acc, zslot, a_zp + dh * ZW + dw,
                      ws_s + (uint32_t)(dw * C * RB), lane);
        }
      }
    }
    if (!active) continue;

    // accumulator (n, j): output pixel warp*16 + lane/4 (+8 for j >= 2),
    // channels n*8 + 2*(lane%4) + (j & 1)
    const unsigned char* zmid = zr + (size_t)(t % 3) * Z_PIX * RB;
    const int q = lane & 3;
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int p = warp * 16 + (lane >> 2) + half * 8;
      if (p >= OUT_PIX) continue;
      const int r = p / TILE_W;
      const int c = p % TILE_W;
      const int h = g.h0 + r;
      const int ww = g.w0 + c;
      if (h >= H || ww >= W) continue;
      const size_t at = g.batch_off + (size_t)t * g.frame
                        + ((size_t)h * W + ww) * C;
      const int zp = (r + 1) * ZW + c + 1;
#pragma unroll
      for (int n = 0; n < 8; ++n) {
        const int co = n * 8 + 2 * q;
        const float v0 = lrelu(acc[n][2 * half] + __bfloat162float(b2[co]), slope);
        const float v1 = lrelu(acc[n][2 * half + 1] + __bfloat162float(b2[co + 1]),
                               slope);
        *reinterpret_cast<__nv_bfloat162*>(y + at + co) =
            __floats2bfloat162_rn(v0, v1);
        if (mid != nullptr)
          *reinterpret_cast<__nv_bfloat162*>(mid + at + co) =
              *reinterpret_cast<const __nv_bfloat162*>(zmid + swz_pair(zp, co));
      }
    }
  }
}

}  // namespace

extern "C" {

// x: (B,T,H,W,64) f32; w1, w2: (3,3,3,64,64) f32 THWIO; b1, b2: (64,) f32;
// y: (B,T,H,W,64) f32; mid: like y, or NULL; all contiguous and 16-byte
// aligned.  Returns the CUDA error code of the launch (0 on success).
int conv3d64_pair_f32(const float* x, const float* w1, const float* b1,
                      const float* w2, const float* b2, float* y, float* mid,
                      int B, int T, int H, int W, float slope, void* stream) {
  cudaError_t err = cudaFuncSetAttribute(
      conv3d64_pair_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)SMEM_BYTES);
  if (err != cudaSuccess) return (int)err;
  const int tiles_w = (W + TILE_W - 1) / TILE_W;
  const int tiles_h = (H + TILE_H - 1) / TILE_H;
  const dim3 grid((unsigned)(tiles_w * tiles_h), (unsigned)B);
  conv3d64_pair_kernel<<<grid, THREADS, SMEM_BYTES, (cudaStream_t)stream>>>(
      x, w1, b1, w2, b2, y, mid, T, H, W, tiles_w, slope);
  return (int)cudaGetLastError();
}

// The bf16 instance: every tensor bf16 (f32 accumulation, z rounded to
// bf16 before conv2, y and z rounded to nearest even).
int conv3d64_pair_bf16(const void* x, const void* w1, const void* b1,
                       const void* w2, const void* b2, void* y, void* mid,
                       int B, int T, int H, int W, float slope, void* stream) {
  cudaError_t err = cudaFuncSetAttribute(
      conv3d64_pair_bf16_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)BF_SMEM_BYTES);
  if (err != cudaSuccess) return (int)err;
  using E = __nv_bfloat16;
  const int tiles_w = (W + TILE_W - 1) / TILE_W;
  const int tiles_h = (H + TILE_H - 1) / TILE_H;
  const dim3 grid((unsigned)(tiles_w * tiles_h), (unsigned)B);
  conv3d64_pair_bf16_kernel<<<grid, BF_THREADS, BF_SMEM_BYTES,
                              (cudaStream_t)stream>>>(
      static_cast<const E*>(x), static_cast<const E*>(w1),
      static_cast<const E*>(b1), static_cast<const E*>(w2),
      static_cast<const E*>(b2), static_cast<E*>(y), static_cast<E*>(mid), T,
      H, W, tiles_w, slope);
  return (int)cudaGetLastError();
}

// Dynamic shared memory and threads per block of one launch, for reports.
int conv3d64_pair_f32_config(int* smem_bytes, int* threads) {
  *smem_bytes = (int)SMEM_BYTES;
  *threads = THREADS;
  return 0;
}

int conv3d64_pair_bf16_config(int* smem_bytes, int* threads) {
  *smem_bytes = (int)BF_SMEM_BYTES;
  *threads = BF_THREADS;
  return 0;
}

}  // extern "C"
