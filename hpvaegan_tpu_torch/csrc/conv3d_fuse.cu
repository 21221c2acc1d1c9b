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
// Both instances follow the TPU kernel's grid with T innermost
// (conv3d_fuse.py:19-26): one block per (b, output tile), streaming T
// through a 3-slot ring of z slices with a 1-pixel spatial halo, so each
// T step computes ONE new z slice (conv1 over the three x slices around
// it) and contracts the three cached slices with w2.  Only the spatial
// halo of z is recomputed by neighbouring blocks, never the temporal one.
// z outside the volume is ZERO: it is conv2's SAME padding, not
// lrelu(conv1(zero-padded x) + b1), which is generally non-zero.  The
// epilogue of conv1 writes 0 for halo pixels outside H x W (the TPU
// kernel's row masks and zero lane groups, conv3d_fuse.py:171-173), and
// conv2 skips the temporal taps whose z slice is outside [0, T) (its
// zeroed ring slots, :176-193).
//
// The f32 instance (conv3d64_pair_kernel), exact f32 on the CUDA cores
// (no TF32), designed for Hopper:
//   * Bound: 2 x 2*27*64*64 FLOP per output voxel at the 67 TFLOP/s f32
//     rate against one read of x and one write of y (and z with with_mid):
//     operations.  The recomputed z halo makes the work (10 x 18) /
//     (8 x 16) = 1.41x conv1's (the previous 6 x 14 tile: 1.52x), so
//     the kernel cannot pass 2 / 2.41 = 0.83 of the bound.
//   * Occupancy: 256 threads (8 warps) a block, one block an SM by shared
//     memory: 139,008 bytes of z ring (3 x 64 channels x 181 floats),
//     61,696 of x slab (64 x 241) and 2 x 12,288 of weight stages =
//     225,280 bytes.  Every thread works in conv2 (8 output pixels x 4
//     channels, 32 accumulators); 240 of 256 in conv1 (6 z pixels x 8
//     channels, 48 accumulators); ptxas: 193 registers, no spills (the
//     channel loop fully unrolled: 3% faster than unrolled by 4,
//     tools/kernel_variants.py k2-unroll).
//     (The previous f32 kernel ran 4 warps an SM, 3 of them in conv2.)
//   * Streamed weights: both convs walk one stream of weight stages, each
//     the three W taps of one (dt, dh) for 16 input channels (12 KB: the
//     three W taps share each loaded x or z value), double-buffered in
//     shared memory and copied with cp.async: the next stage's weights
//     land while this stage's FMAs run.  One block barrier per stage (72
//     per T step; before, 36 barriers around synchronous 48 KB copies).
//   * x slab: staged once per (z slice, temporal tap), channel-major, as
//     before (a float4 load, four 4-byte stores); 15 float4 a thread,
//     behind one extra barrier per x slice while the weight copies are in
//     flight: 3% of the time (kernel_variants k2-parts).  What is left
//     is instruction issue in the FMA loops (FFMA is 88-91% of their
//     instructions) and the halo; shared-memory bandwidth is not the
//     limit (k2-loads).
//   * Halo: a 3-slot f32 z ring holds 768 bytes a z pixel, so at most
//     ~190 z pixels fit beside the x slab and the weights: 10 x 18 is the
//     largest tile whose conv2 tiling fills the 256 threads.  Recomputing
//     at most 1.3x (a 12 x 16 tile) needs a z ring in registers or in a
//     cluster's distributed shared memory; not done here.
//
// The bf16 instance (conv3d64_pair_pallas with bf16 x, conv3d_fuse.py:
// 225-233, z ring in x's dtype :173, 282) is conv3d64_pair_bf16_kernel, on
// the tensor cores, with a 6 x 14 output tile:
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
// again from L2 for each z slice and each output slice, which the next
// design should stream as the f32 instance does.
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

__device__ __forceinline__ float lrelu(float v, float slope) {
  return v < 0.f ? v * slope : v;
}

struct Geometry {
  int T, H, W, h0, w0;
  size_t frame;      // elements of one (b, t) slice
  size_t batch_off;  // elements before batch b
};

// ---------------------------------------------------------------------------
// f32 on the CUDA cores
// ---------------------------------------------------------------------------

constexpr int F_TILE_H = 8;              // output tile
constexpr int F_TILE_W = 16;
constexpr int F_ZH = F_TILE_H + 2;       // z slice with its halo: 10 x 18
constexpr int F_ZW = F_TILE_W + 2;
constexpr int F_XH = F_TILE_H + 4;       // x slab feeding it: 12 x 20
constexpr int F_XW = F_TILE_W + 4;
constexpr int F_THREADS = 256;
constexpr int F_ZSTRIDE = F_ZH * F_ZW + 1;  // floats per channel plane
constexpr int F_XSTRIDE = F_XH * F_XW + 1;
constexpr int F_QCI = 16;                   // input channels per weight stage
constexpr int F_WSTAGE = 3 * F_QCI * C;     // floats: (dw, 16 ci, 64 co)
// conv1: 6 z pixels x 8 channels a thread; 10 rows x 3 groups x 8 = 240
constexpr int PX1 = 6, CO1 = 8;
constexpr int CONV1_THREADS = F_ZH * (F_ZW / PX1) * (C / CO1);
// conv2: 8 output pixels x 4 channels a thread; 8 rows x 2 x 16 = 256
constexpr int PX2 = 8, CO2 = 4;
static_assert(F_TILE_H * (F_TILE_W / PX2) * (C / CO2) == F_THREADS, "conv2 tiling");
static_assert(CONV1_THREADS <= F_THREADS && F_ZW % PX1 == 0, "conv1 tiling");
constexpr int F_SMEM_Z = 3 * C * F_ZSTRIDE;
constexpr int F_SMEM_X = C * F_XSTRIDE;
constexpr size_t F_SMEM_BYTES =
    (size_t)(F_SMEM_Z + F_SMEM_X + 2 * F_WSTAGE) * sizeof(float);
static_assert(((F_SMEM_Z + F_SMEM_X) * sizeof(float)) % 16 == 0,
              "weight stages must be 16-byte aligned");

// One weight stage of the stream: conv (1 or 2), the slice it serves
// (z slice ts for conv1, output slice ts for conv2), temporal tap kt, H
// tap dh and input-channel quarter q.  Its weights are the three W taps
// of (kt, dh) for input channels 16q..16q+15: 3 x 16 x 64 floats.
// Order: conv1(0), then for each t: conv1(t + 1) (if t + 1 < T), conv2(t);
// inside a layer kt (only taps whose slice lies in [0, T)), dh, q.
struct Stage {
  int conv, ts, kt, dh, q;
  __device__ bool valid() const { return conv != 0; }
  __device__ static int kt_lo(int ts) { return ts == 0 ? 1 : 0; }
  __device__ static int kt_hi(int ts, int T) { return min(2, T - ts); }
  __device__ static Stage first(int conv, int ts) { return {conv, ts, kt_lo(ts), 0, 0}; }
  __device__ bool first_of_layer() const {
    return kt == kt_lo(ts) && dh == 0 && q == 0;
  }
  __device__ Stage next(int T) const {
    Stage s = *this;
    if (++s.q < 4) return s;
    s.q = 0;
    if (++s.dh < 3) return s;
    s.dh = 0;
    if (++s.kt <= kt_hi(ts, T)) return s;
    if (conv == 1)  // after conv1(ts): conv2(ts - 1), or conv1(1) first
      return ts == 0 ? (T > 1 ? first(1, 1) : first(2, 0)) : first(2, ts - 1);
    if (ts + 2 < T) return first(1, ts + 2);
    if (ts + 1 < T) return first(2, ts + 1);
    return {0, 0, 0, 0, 0};
  }
  __device__ bool last_of_layer(int T) const {
    const Stage n = next(T);
    return !n.valid() || n.first_of_layer();
  }
};

// start the copy of stage s's weights into `dst` (16-byte cp.async, one
// commit group by the caller)
__device__ __forceinline__ void load_stage(const Stage& s, const float* __restrict__ w1,
                                           const float* __restrict__ w2,
                                           uint32_t dst) {
  const float* w = s.conv == 1 ? w1 : w2;
  for (int i = threadIdx.x; i < F_WSTAGE / 4; i += F_THREADS) {
    const int dw = i / (F_QCI * C / 4);
    const int rest = i - dw * (F_QCI * C / 4);
    const float* src = w + (size_t)((s.kt * 3 + s.dh) * 3 + dw) * C * C +
                       (size_t)s.q * F_QCI * C + rest * 4;
    bf16_mma::cp_async16(dst + 16u * i, src, true);
  }
}

// x[tx] over rows h0-2 .. h0+TILE_H+1, columns w0-2 .. w0+TILE_W+1,
// channel-major, zero outside the input
__device__ __forceinline__ void stage_x(const float* __restrict__ x, const Geometry& g,
                                        int tx, float* xs) {
  const float* xt = x + g.batch_off + (size_t)tx * g.frame;
  for (int i = threadIdx.x; i < F_XH * F_XW * (C / 4); i += F_THREADS) {
    const int pix = i / (C / 4);
    const int c4 = i % (C / 4);
    const int sr = pix / F_XW;
    const int sc = pix - sr * F_XW;
    const int hh = g.h0 - 2 + sr;
    const int ww = g.w0 - 2 + sc;
    float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
    if (hh >= 0 && hh < g.H && ww >= 0 && ww < g.W)
      v = __ldg(reinterpret_cast<const float4*>(xt + ((size_t)hh * g.W + ww) * C) + c4);
    float* dst = xs + (c4 * 4) * F_XSTRIDE + pix;
    dst[0] = v.x;
    dst[F_XSTRIDE] = v.y;
    dst[2 * F_XSTRIDE] = v.z;
    dst[3 * F_XSTRIDE] = v.w;
  }
}

// acc[j][k] += sum_{ci, dw} src[ci][row][c0 + j + dw] * ws[dw][ci][co(k)]
// over the stage's 16 input channels (src already offset to channel 16q).
// co(k) = 4 cg + k for k < 4, 32 + 4 cg + k - 4 otherwise when CO == 8
// (the two float4 of a warp's 8 channel groups fill 128 contiguous bytes
// each), 4 cg + k when CO == 4.
template <int PX, int CO, int STRIDE>
__device__ __forceinline__ void stage_fma(const float* src, const float* ws, int cg,
                                          float (&acc)[PX][CO]) {
  const float4* w4 = reinterpret_cast<const float4*>(ws) + cg;
#pragma unroll
  for (int ci = 0; ci < F_QCI; ++ci) {
    float xv[PX + 2];
#pragma unroll
    for (int j = 0; j < PX + 2; ++j) xv[j] = src[ci * STRIDE + j];
#pragma unroll
    for (int dw = 0; dw < 3; ++dw) {
      float wv[CO];
      const float4 wa = w4[(dw * F_QCI + ci) * (C / 4)];
      wv[0] = wa.x; wv[1] = wa.y; wv[2] = wa.z; wv[3] = wa.w;
      if constexpr (CO == 8) {
        const float4 wb = w4[(dw * F_QCI + ci) * (C / 4) + 8];
        wv[4] = wb.x; wv[5] = wb.y; wv[6] = wb.z; wv[7] = wb.w;
      }
#pragma unroll
      for (int j = 0; j < PX; ++j)
#pragma unroll
        for (int k = 0; k < CO; ++k) acc[j][k] = fmaf(xv[j + dw], wv[k], acc[j][k]);
    }
  }
}

__global__ void __launch_bounds__(F_THREADS, 1)
conv3d64_pair_kernel(const float* __restrict__ x, const float* __restrict__ w1,
                     const float* __restrict__ b1, const float* __restrict__ w2,
                     const float* __restrict__ b2, float* __restrict__ y,
                     float* __restrict__ mid, int T, int H, int W, int tiles_w,
                     float slope) {
  extern __shared__ __align__(16) float smem[];
  float* zr = smem;                          // [3][C][F_ZSTRIDE]
  float* xs = smem + F_SMEM_Z;               // [C][F_XSTRIDE]
  float* ws = smem + F_SMEM_Z + F_SMEM_X;    // [2][3 dw][16 ci][64 co]

  Geometry g;
  g.T = T;
  g.H = H;
  g.W = W;
  g.h0 = (blockIdx.x / tiles_w) * F_TILE_H;
  g.w0 = (blockIdx.x % tiles_w) * F_TILE_W;
  g.frame = (size_t)H * W * C;
  g.batch_off = (size_t)blockIdx.y * T * g.frame;

  const int tid = threadIdx.x;
  // conv1: z row r1, columns c1..c1+5, channels of group cg1
  const bool conv1_on = tid < CONV1_THREADS;
  const int cg1 = tid % (C / CO1);
  const int r1 = (tid / (C / CO1)) / (F_ZW / PX1);
  const int c1 = ((tid / (C / CO1)) % (F_ZW / PX1)) * PX1;
  // conv2: output row r2, columns c2..c2+7, channels 4 cg2 .. 4 cg2 + 3
  const int cg2 = tid % (C / CO2);
  const int r2 = (tid / (C / CO2)) / (F_TILE_W / PX2);
  const int c2 = ((tid / (C / CO2)) % (F_TILE_W / PX2)) * PX2;

  float acc1[PX1][CO1];
  float acc2[PX2][CO2];

  const uint32_t ws_s = bf16_mma::smem_u32(ws);
  Stage cur = Stage::first(1, 0);
  load_stage(cur, w1, w2, ws_s);
  bf16_mma::cp_async_commit();
  for (int i = 0; cur.valid(); ++i) {
    const Stage nxt = cur.next(T);
    // this stage's weights have landed, and every thread is done with the
    // previous stage: its weight buffer, x slab and z slots may be reused
    bf16_mma::cp_async_wait<0>();
    __syncthreads();
    if (nxt.valid())
      load_stage(nxt, w1, w2, ws_s + (uint32_t)(((i + 1) & 1) * F_WSTAGE * 4));
    bf16_mma::cp_async_commit();
    const float* wst = ws + (i & 1) * F_WSTAGE;
    const int slice = cur.ts + cur.kt - 1;  // x slice (conv1) or z slice (conv2)

    if (cur.conv == 1) {
      if (cur.first_of_layer()) {
#pragma unroll
        for (int j = 0; j < PX1; ++j)
#pragma unroll
          for (int k = 0; k < CO1; ++k) acc1[j][k] = 0.f;
      }
      if (cur.dh == 0 && cur.q == 0) {  // a new x slice
        stage_x(x, g, slice, xs);
        __syncthreads();
      }
      if (conv1_on)
        stage_fma<PX1, CO1, F_XSTRIDE>(
            xs + cur.q * F_QCI * F_XSTRIDE + (r1 + cur.dh) * F_XW + c1, wst, cg1,
            acc1);
      if (cur.last_of_layer(T) && conv1_on) {
        // z[ts] into its ring slot: zero outside the volume (conv2's SAME
        // padding), lrelu(conv1 + b1) inside
        float* zslot = zr + (cur.ts % 3) * C * F_ZSTRIDE;
        const int hz = g.h0 - 1 + r1;
#pragma unroll
        for (int k = 0; k < CO1; ++k) {
          const int co = (k < 4 ? 0 : 28) + 4 * cg1 + k;
          const float bv = b1[co];
#pragma unroll
          for (int j = 0; j < PX1; ++j) {
            const int wz = g.w0 - 1 + c1 + j;
            const bool inside = hz >= 0 && hz < H && wz >= 0 && wz < W;
            zslot[co * F_ZSTRIDE + r1 * F_ZW + c1 + j] =
                inside ? lrelu(acc1[j][k] + bv, slope) : 0.f;
          }
        }
      }
    } else {
      if (cur.first_of_layer()) {
#pragma unroll
        for (int j = 0; j < PX2; ++j)
#pragma unroll
          for (int k = 0; k < CO2; ++k) acc2[j][k] = 0.f;
      }
      const float* zslot = zr + (slice % 3) * C * F_ZSTRIDE;
      stage_fma<PX2, CO2, F_ZSTRIDE>(
          zslot + cur.q * F_QCI * F_ZSTRIDE + (r2 + cur.dh) * F_ZW + c2, wst, cg2,
          acc2);
      const int h = g.h0 + r2;
      if (cur.last_of_layer(T) && h < H) {
        const size_t row = g.batch_off + (size_t)cur.ts * g.frame + (size_t)h * W * C;
        const float* zmid = zr + (cur.ts % 3) * C * F_ZSTRIDE + (r2 + 1) * F_ZW + 1;
        const float4 bv = reinterpret_cast<const float4*>(b2)[cg2];
#pragma unroll
        for (int j = 0; j < PX2; ++j) {
          const int ww = g.w0 + c2 + j;
          if (ww >= W) break;
          *reinterpret_cast<float4*>(y + row + (size_t)ww * C + CO2 * cg2) =
              make_float4(lrelu(acc2[j][0] + bv.x, slope), lrelu(acc2[j][1] + bv.y, slope),
                          lrelu(acc2[j][2] + bv.z, slope), lrelu(acc2[j][3] + bv.w, slope));
          if (mid != nullptr) {
            const float* zc = zmid + (CO2 * cg2) * F_ZSTRIDE + c2 + j;
            *reinterpret_cast<float4*>(mid + row + (size_t)ww * C + CO2 * cg2) =
                make_float4(zc[0], zc[F_ZSTRIDE], zc[2 * F_ZSTRIDE], zc[3 * F_ZSTRIDE]);
          }
        }
      }
    }
    cur = nxt;
  }
}

// the bf16 instance's tiles
constexpr int TILE_H = 6;
constexpr int TILE_W = 14;
constexpr int ZH = TILE_H + 2;   // z slice with its halo: 8 x 16
constexpr int ZW = TILE_W + 2;
constexpr int XH = TILE_H + 4;   // x slab feeding it: 10 x 18
constexpr int XW = TILE_W + 4;

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

int occupancy(const void* kernel, int threads, size_t smem, int* blocks) {
  return (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(blocks, kernel, threads,
                                                            smem);
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
      (int)F_SMEM_BYTES);
  if (err != cudaSuccess) return (int)err;
  const int tiles_w = (W + F_TILE_W - 1) / F_TILE_W;
  const int tiles_h = (H + F_TILE_H - 1) / F_TILE_H;
  const dim3 grid((unsigned)(tiles_w * tiles_h), (unsigned)B);
  conv3d64_pair_kernel<<<grid, F_THREADS, F_SMEM_BYTES, (cudaStream_t)stream>>>(
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

// Dynamic shared memory, threads and blocks an SM (occupancy API on the
// current device) of one launch, for reports.  Returns the CUDA error code.
int conv3d64_pair_f32_config(int* smem_bytes, int* threads, int* blocks_per_sm) {
  *smem_bytes = (int)F_SMEM_BYTES;
  *threads = F_THREADS;
  const cudaError_t err = cudaFuncSetAttribute(
      conv3d64_pair_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)F_SMEM_BYTES);
  if (err != cudaSuccess) return (int)err;
  return occupancy((const void*)conv3d64_pair_kernel, F_THREADS, F_SMEM_BYTES,
                   blocks_per_sm);
}

int conv3d64_pair_bf16_config(int* smem_bytes, int* threads, int* blocks_per_sm) {
  *smem_bytes = (int)BF_SMEM_BYTES;
  *threads = BF_THREADS;
  const cudaError_t err = cudaFuncSetAttribute(
      conv3d64_pair_bf16_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)BF_SMEM_BYTES);
  if (err != cudaSuccess) return (int)err;
  return occupancy((const void*)conv3d64_pair_bf16_kernel, BF_THREADS,
                   BF_SMEM_BYTES, blocks_per_sm);
}

}  // extern "C"
