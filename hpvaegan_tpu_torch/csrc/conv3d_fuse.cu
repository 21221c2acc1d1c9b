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
// 225-233, z ring in x's dtype :173, 282) is conv3d64_pair_bf16_kernel,
// designed for Hopper:
//   * bf16 x, weights and biases; f32 accumulation; each z value is
//     rounded to bf16 as it enters the ring, so conv2 reads the rounded z;
//     y and z are stored rounded to nearest even.
//   * Bound: 2 x 2*27*64*64 FLOP per output voxel at the bf16 tensor-core
//     rate against x read and y (and z) written once: operations.  The
//     previous design (mma.sync, a 6 x 14 tile, synchronous copies)
//     reached 0.17 of it: it staged 12.1 GB of weights and x a launch at
//     (4,13,144,256), each weight stage serving 84 output pixels.
//   * Products: wgmma m64n64k16 for both convs, both operands by
//     descriptor from shared memory, as in K1's forward: A (x or z
//     shifted by the tap) K-major from the TMA buffer or the z slot, B
//     (the tap's weights) MN-major, 128-byte swizzle.
//   * Flattened tiles: x, z and y tiles share a row stride of 32 pixels,
//     so the tap (dh, dw) of a pixel is the pixel 32 dh + dw further on
//     and every product is a run of 64 consecutive pixels; the 2 (z) or
//     4 (y) columns past a row's valid ones are computed and dropped.  An
//     output tile of 6 x 28 needs a z slice of 8 x 30 (4 m64 tiles) and
//     an x slab of 10 x 32: 1.33x the work of the two convs' outputs
//     (the previous 6 x 14 tile: 1.26x in conv1 alone, with 2 of 8 warps
//     idle in conv2).  A weight stage holds the three H taps, so each
//     stage wait covers 12 (conv1) or 9 (conv2) wgmmas of the block.
//   * z stays on chip: a 3-slot ring of bf16 z slices (33,792 bytes
//     each); a block walks all of T for its tile column, computing one new
//     z slice (conv1 over three x slabs) and one output slice (conv2 over
//     three z slices) a step.  z outside the volume, and in the dropped
//     columns, is written as zero.
//   * Copies off the critical path: one producer thread issues TMA loads
//     of x slabs (2 slots, box 64 x 32 x 10, zero fill = the SAME padding)
//     and of weight stages (3 H taps x 32 input channels, 12 KB, a ring of
//     3) with full/empty mbarriers; 2 consumer warpgroups (setmaxnreg
//     40/232) split the m64 tiles (conv1 2 + 2, conv2 2 + 1) and meet at a
//     named barrier around each z slice's epilogue.
//   * Persistent: one block an SM (224,256 bytes) walks the (b, tile row,
//     tile column) columns round-robin.
//   * What bounds it now (tools/kernel_variants.py k2b-parts, PERF.md):
//     the products, 1.33x the outputs' work; cutting the wgmmas halves
//     the time, cutting the weight or x loads saves 0-3%.  Cutting the y
//     epilogue saves a quarter: both warpgroups run it at the same point
//     of the stream, while no products are in flight.  Holding y until
//     the next conv1's first products are issued was slower (k2b-store),
//     and so were 3 consumer warpgroups (k2b-warps) and 2 weight stages
//     (k2b-ring).  Unlike two K1 launches, it cannot skip the halo: at
//     K1's rate its products alone take longer than K1 twice, while the
//     z round trip it saves is a few per cent of that.
//   * ptxas (sm_90a, CUDA 12.8): 168 registers at launch (setmaxnreg then
//     gives the consumers 232), no spills, no stack; 224,256 bytes of
//     dynamic shared memory, one block an SM.  chip_smoke.py prints both.
//
// Plain C interface, loaded with ctypes; launches on the caller's stream
// and returns cudaGetLastError().

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stddef.h>
#include <stdint.h>

#include "bf16_mma.cuh"
#include "hopper.cuh"

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

// ---------------------------------------------------------------------------
// bf16 on the tensor cores: wgmma fed by TMA rings
// ---------------------------------------------------------------------------

// Pixels of a tile are flattened row by row with a row stride of PB_S = 32
// pixels, the width of the x slab: x pixel p + 32 dh + dw is z pixel p's
// tap (dh, dw), and z pixel p + 32 dh + dw output pixel p's.  So every
// product is a run of 64 consecutive flattened pixels (wgmma's M), and
// the columns past a row's valid ones are computed and dropped.
constexpr int RB = bf16_mma::ROW_BYTES;
constexpr int PB_S = 32;                     // row stride of x, z and y tiles
constexpr int PB_OH = 6;                     // output tile: 6 x 28
constexpr int PB_OW = PB_S - 4;
constexpr int PB_ZH = PB_OH + 2;             // z slice with its halo: 8 x 30
constexpr int PB_XH = PB_OH + 4;             // x slab: 10 x 32
constexpr int PB_ZMT = PB_ZH * PB_S / 64;    // conv1 m64 tiles: 4
constexpr int PB_YMT = PB_OH * PB_S / 64;    // conv2 m64 tiles: 3
static_assert(PB_ZH * PB_S % 64 == 0 && PB_OH * PB_S % 64 == 0, "m64 tiles");
// a tap reads 2 pixels past the x slab (conv1) or the z slice (conv2)
constexpr int PB_TAIL = 2;
static_assert(PB_ZMT * 64 + 2 * PB_S + 2 == PB_XH * PB_S + PB_TAIL &&
              PB_YMT * 64 + 2 * PB_S + 2 == PB_ZH * PB_S + PB_TAIL, "reads past a tile");
constexpr int PB_Z_BYTES = (PB_ZH * PB_S * RB + PB_TAIL * RB + 1023) / 1024 * 1024;
constexpr int PB_X_LOAD = PB_XH * PB_S * RB;                          // 40,960
constexpr int PB_X_BYTES = (PB_X_LOAD + PB_TAIL * RB + 1023) / 1024 * 1024;
constexpr int PB_X_STAGES = 2;
static_assert(PB_X_STAGES >= 2, "x ring: a slab is released after the next one's first products");
constexpr int PB_Z_TAIL = PB_Z_BYTES - PB_ZH * PB_S * RB;  // never written
constexpr int PB_X_TAIL = PB_X_BYTES - PB_X_LOAD;
static_assert(PB_Z_TAIL >= PB_TAIL * RB && PB_X_TAIL >= PB_TAIL * RB, "tails");
constexpr int PB_QCI = 32;                   // input channels a weight stage
constexpr int PB_W_BYTES = 3 * PB_QCI * RB;  // the three dh taps: 12,288
constexpr int PB_W_STAGES = 3;
constexpr int PB_CONSUMERS = 2;
constexpr int PB_THREADS = (PB_CONSUMERS + 1) * 128;
constexpr int PB_PRODUCER_REGS = 40;
constexpr int PB_CONSUMER_REGS = 232;
constexpr size_t PB_SMEM_BYTES = 3 * (size_t)PB_Z_BYTES +
                                 (size_t)PB_X_STAGES * PB_X_BYTES +
                                 (size_t)PB_W_STAGES * PB_W_BYTES + 1024 + 1024;
static_assert(PB_W_BYTES % 1024 == 0, "weight stages keep the swizzle atoms aligned");
static_assert(PB_QCI == 32, "A fragments are double-buffered by k16 step");
static_assert(PB_PRODUCER_REGS * 128 + PB_CONSUMER_REGS * 128 * PB_CONSUMERS <= 65536,
              "register budget of one block");

// a column of the persistent walk: (b, tile row, tile column), all of T
struct PairColumn {
  int b, h0, w0;
  __device__ PairColumn(int col, int tiles_h, int tiles_w) {
    w0 = (col % tiles_w) * PB_OW;
    const int r = col / tiles_w;
    h0 = (r % tiles_h) * PB_OH;
    b = r / tiles_h;
  }
};

// The stream both roles walk for one column: step -1 computes z[0]; step
// s >= 0 computes z[s + 1] (if s + 1 < T), then y[s].  conv1 of z[f] takes
// x slices f - 1 .. f + 1, conv2 of y[s] z slices s - 1 .. s + 1, each
// only inside [0, T); per slice, weight stages (dw, q) for q the input
// channel halves, each holding the three H taps.

// d[m] += sum_dh A(m, dh, dw) W(dh) over one weight stage's two k16 steps,
// for this warpgroup's NT m64 tiles from tile m0: one wgmma group.  A is
// read by the tensor cores straight from `src` (the x slab or a z slice):
// the 64 flattened pixels from 64 (m0 + m) + 32 dh + dw, input channels
// 16 (2 q + kk) on.
template <int NT>
__device__ __forceinline__ void pair_stage(float (&d)[NT][32], uint32_t src, int m0,
                                           int dw, int q, uint32_t wst) {
  hopper::wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < 2; ++kk)
#pragma unroll
    for (int m = 0; m < NT; ++m)
#pragma unroll
      for (int dh = 0; dh < 3; ++dh)
        hopper::wgmma_64x64_ss(
            d[m],
            hopper::k_desc(src + (uint32_t)((64 * (m0 + m) + PB_S * dh + dw) * RB +
                                            (2 * q + kk) * 32)),
            hopper::mn_desc(wst + (uint32_t)(dh * PB_QCI * RB + kk * 16 * RB)));
  hopper::wgmma_commit();
}

// consumer-side ring positions and the block's shared memory
struct PairRings {
  uint32_t zring, xring, wring, bars;
  int xg = 0, wgn = 0;
  __device__ uint32_t x_full(int s) const { return bars + 8u * s; }
  __device__ uint32_t x_empty(int s) const { return bars + 8u * (PB_X_STAGES + s); }
  __device__ uint32_t w_full(int s) const { return bars + 8u * (2 * PB_X_STAGES + s); }
  __device__ uint32_t w_empty(int s) const {
    return bars + 8u * (2 * PB_X_STAGES + PB_W_STAGES + s);
  }
  __device__ uint32_t zslot(int f) const { return zring + (uint32_t)(f % 3) * PB_Z_BYTES; }
  // the slots of the last stage issued, released once its products are
  // done: after the next stage's products are issued, or at a conv's end
  int done_w = -1, done_x = -1;
  __device__ void release() {
    __syncwarp();
    if ((threadIdx.x & 31) == 0) {
      if (done_w >= 0) hopper::mbar_arrive(w_empty(done_w));
      if (done_x >= 0) hopper::mbar_arrive(x_empty(done_x));
    }
    done_w = done_x = -1;
  }
};

__device__ __forceinline__ void consumers_sync() {
  asm volatile("bar.sync 1, %0;\n" ::"n"(PB_CONSUMERS * 128) : "memory");
}

// One conv of the stream for this warpgroup's NT tiles starting at tile
// m0: conv1 (x slices through the x ring) or conv2 (z slices of the ring).
template <int NT>
__device__ __forceinline__ void pair_conv(float (&d)[NT][32], PairRings& r, bool conv1,
                                          int f, int T, int m0) {
#pragma unroll
  for (int m = 0; m < NT; ++m)
#pragma unroll
    for (int i = 0; i < 32; ++i) d[m][i] = 0.f;
  for (int kt = 0; kt < 3; ++kt) {
    const int src_f = f + kt - 1;
    if (src_f < 0 || src_f >= T) continue;
    uint32_t src;
    int xs = -1;
    if (conv1) {
      xs = r.xg % PB_X_STAGES;
      hopper::mbar_wait(r.x_full(xs), (r.xg / PB_X_STAGES) & 1);
      src = r.xring + (uint32_t)xs * PB_X_BYTES;
      ++r.xg;
    } else {
      src = r.zslot(src_f);
    }
#pragma unroll 1
    for (int dw = 0; dw < 3; ++dw)
#pragma unroll 1
      for (int q = 0; q < C / PB_QCI; ++q, ++r.wgn) {
        const int s = r.wgn % PB_W_STAGES;
        hopper::mbar_wait(r.w_full(s), (r.wgn / PB_W_STAGES) & 1);
        pair_stage<NT>(d, src, m0, dw, q, r.wring + (uint32_t)s * PB_W_BYTES);
        hopper::wgmma_wait<1>();  // the previous stage's products are done
        r.release();
        r.done_w = s;
        if (dw == 2 && q == C / PB_QCI - 1) r.done_x = xs;
      }
  }
  hopper::wgmma_wait<0>();
  r.release();
}

// z[f] = lrelu(conv1 + b1), bf16, into its ring slot: zero outside the
// volume and in the columns past the z tile
template <int NT>
__device__ __forceinline__ void pair_store_z(const float (&d)[NT][32], const PairRings& r,
                                             int f, int m0, const PairColumn& cl, int H,
                                             int W, const float (&b1v)[16], float slope) {
  const int lane = threadIdx.x & 31;
  const int wi = (threadIdx.x >> 5) & 3;
  const uint32_t slot = r.zslot(f);
#pragma unroll
  for (int m = 0; m < NT; ++m)
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int p = 64 * (m0 + m) + 16 * wi + (lane >> 2) + 8 * half;
      const int zr = p / PB_S, zc = p % PB_S;
      const int hz = cl.h0 - 1 + zr, wz = cl.w0 - 1 + zc;
      const bool inside = zc < PB_OW + 2 && hz >= 0 && hz < H && wz >= 0 && wz < W;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int co = 8 * j + 2 * (lane & 3);
        float v0 = 0.f, v1 = 0.f;
        if (inside) {
          v0 = lrelu(d[m][4 * j + 2 * half] + b1v[2 * j], slope);
          v1 = lrelu(d[m][4 * j + 2 * half + 1] + b1v[2 * j + 1], slope);
        }
        const __nv_bfloat162 v = __floats2bfloat162_rn(v0, v1);
        asm volatile("st.shared.b32 [%0], %1;\n" ::"r"(slot + bf16_mma::swz_pair(p, co)),
                     "r"(*reinterpret_cast<const uint32_t*>(&v))
                     : "memory");
      }
    }
  // the tensor cores read z through the async proxy
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// y[t] = lrelu(conv2 + b2) (and z[t] with mid) for the valid pixels
template <int NT>
__device__ __forceinline__ void pair_store_y(const float (&d)[NT][32], const PairRings& r,
                                             int t, int m0, const PairColumn& cl, int T,
                                             int H, int W, const float (&b2v)[16],
                                             float slope, __nv_bfloat16* __restrict__ y,
                                             __nv_bfloat16* __restrict__ mid) {
  const int lane = threadIdx.x & 31;
  const int wi = (threadIdx.x >> 5) & 3;
  const uint32_t slot = r.zslot(t);
#pragma unroll
  for (int m = 0; m < NT; ++m)
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int p = 64 * (m0 + m) + 16 * wi + (lane >> 2) + 8 * half;
      const int oy = p / PB_S, ox = p % PB_S;
      const int h = cl.h0 + oy, w = cl.w0 + ox;
      const bool valid = ox < PB_OW && h < H && w < W;
      const size_t at = ((((size_t)cl.b * T + t) * H + h) * W + w) * C;
      uint32_t pk[8];
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const __nv_bfloat162 v =
            __floats2bfloat162_rn(lrelu(d[m][4 * j + 2 * half] + b2v[2 * j], slope),
                                  lrelu(d[m][4 * j + 2 * half + 1] + b2v[2 * j + 1], slope));
        pk[j] = *reinterpret_cast<const uint32_t*>(&v);
      }
      hopper::store_pixel_bf16(valid ? y + at : nullptr, pk, lane);
      if (mid != nullptr && valid) {
        // z[t] at this pixel, 8 bytes of a chunk pair, as store_pixel_bf16
        const int zp = p + PB_S + 1;
        const int odd = lane & 1;
#pragma unroll
        for (int rr = 0; rr < 4; ++rr) {
          const int co = 8 * (2 * rr + odd) + 2 * (lane & 2);
          uint2 v;
          asm volatile("ld.shared.v2.b32 {%0, %1}, [%2];\n"
                       : "=r"(v.x), "=r"(v.y)
                       : "r"(slot + bf16_mma::swz_pair(zp, co)));
          *reinterpret_cast<uint2*>(mid + at + co) = v;
        }
      }
    }
}

// The consumer warpgroup's walk over its columns: NT1 conv1 tiles from
// tile m1, NT2 conv2 tiles from tile m2.
template <int NT1, int NT2>
__device__ __forceinline__ void pair_consumer(PairRings& r, int m1, int m2, int T, int H,
                                              int W, int tiles_h, int tiles_w, int ncols,
                                              const __nv_bfloat16* __restrict__ b1,
                                              const __nv_bfloat16* __restrict__ b2,
                                              float slope, __nv_bfloat16* __restrict__ y,
                                              __nv_bfloat16* __restrict__ mid) {
  const int lane = threadIdx.x & 31;
  float b1v[16], b2v[16];
#pragma unroll
  for (int j = 0; j < 8; ++j)
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      b1v[2 * j + e] = __bfloat162float(b1[8 * j + 2 * (lane & 3) + e]);
      b2v[2 * j + e] = __bfloat162float(b2[8 * j + 2 * (lane & 3) + e]);
    }
  for (int col = blockIdx.x; col < ncols; col += gridDim.x) {
    const PairColumn cl(col, tiles_h, tiles_w);
    for (int s = -1; s < T; ++s) {
      if (s + 1 < T) {
        float d[NT1][32];
        pair_conv<NT1>(d, r, true, s + 1, T, m1);
        consumers_sync();  // every warp is done reading z[s - 2]'s slot
        pair_store_z<NT1>(d, r, s + 1, m1, cl, H, W, b1v, slope);
      }
      consumers_sync();    // z[s + 1] is in its slot
      if (s < 0) continue;
      float d[NT2][32];
      pair_conv<NT2>(d, r, false, s, T, m2);
      pair_store_y<NT2>(d, r, s, m2, cl, T, H, W, b2v, slope, y, mid);
    }
  }
}

// the m64 tiles of warpgroup w among mt: a share each, the first mt % n
// warpgroups one more
__host__ __device__ constexpr int pb_tiles(int mt, int w) {
  return mt / PB_CONSUMERS + (w < mt % PB_CONSUMERS ? 1 : 0);
}
__host__ __device__ constexpr int pb_first(int mt, int w) {
  return w * (mt / PB_CONSUMERS) + (w < mt % PB_CONSUMERS ? w : mt % PB_CONSUMERS);
}
static_assert(PB_YMT >= PB_CONSUMERS && PB_ZMT >= PB_CONSUMERS, "a tile a warpgroup");

// consumer warpgroup wg's walk, its tile counts fixed at compile time
template <int WG>
__device__ __forceinline__ void pair_dispatch(int wg, PairRings& r, int T, int H, int W,
                                              int tiles_h, int tiles_w, int ncols,
                                              const __nv_bfloat16* __restrict__ b1,
                                              const __nv_bfloat16* __restrict__ b2,
                                              float slope, __nv_bfloat16* __restrict__ y,
                                              __nv_bfloat16* __restrict__ mid) {
  if constexpr (WG < PB_CONSUMERS) {
    if (wg == WG)
      pair_consumer<pb_tiles(PB_ZMT, WG), pb_tiles(PB_YMT, WG)>(
          r, pb_first(PB_ZMT, WG), pb_first(PB_YMT, WG), T, H, W, tiles_h, tiles_w,
          ncols, b1, b2, slope, y, mid);
    else
      pair_dispatch<WG + 1>(wg, r, T, H, W, tiles_h, tiles_w, ncols, b1, b2, slope, y,
                            mid);
  }
}

__global__ void __launch_bounds__(PB_THREADS, 1)
conv3d64_pair_bf16_kernel(const __grid_constant__ CUtensorMap x_map,
                          const __grid_constant__ CUtensorMap w1_map,
                          const __grid_constant__ CUtensorMap w2_map,
                          const __nv_bfloat16* __restrict__ b1,
                          const __nv_bfloat16* __restrict__ b2,
                          __nv_bfloat16* __restrict__ y,
                          __nv_bfloat16* __restrict__ mid, int T, int H, int W,
                          int tiles_h, int tiles_w, int ncols, float slope) {
  extern __shared__ unsigned char smem_raw[];
  PairRings r;
  r.zring = (bf16_mma::smem_u32(smem_raw) + 1023u) & ~1023u;
  r.xring = r.zring + 3 * PB_Z_BYTES;
  r.wring = r.xring + PB_X_STAGES * PB_X_BYTES;
  r.bars = r.wring + PB_W_STAGES * PB_W_BYTES;
  const int wg = threadIdx.x >> 7;  // consumers, then the producer

  // the pixels a tap reads past each z and x tile are never loaded or
  // stored: zero the slots' tails once
  for (int i = threadIdx.x; i < 3 * PB_Z_TAIL / 16 + PB_X_STAGES * PB_X_TAIL / 16;
       i += PB_THREADS) {
    const int zi = i - 3 * PB_Z_TAIL / 16;
    const uint32_t at =
        zi < 0 ? r.zring + (i / (PB_Z_TAIL / 16) + 1) * PB_Z_BYTES - PB_Z_TAIL +
                     (i % (PB_Z_TAIL / 16)) * 16
               : r.xring + (zi / (PB_X_TAIL / 16) + 1) * PB_X_BYTES - PB_X_TAIL +
                     (zi % (PB_X_TAIL / 16)) * 16;
    asm volatile("st.shared.v4.b32 [%0], {%1, %1, %1, %1};\n" ::"r"(at), "r"(0)
                 : "memory");
  }
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
  if (threadIdx.x == 0) {
    for (int s = 0; s < PB_X_STAGES; ++s) {
      hopper::mbar_init(r.x_full(s), 1);
      hopper::mbar_init(r.x_empty(s), PB_CONSUMERS * 4);  // one arrive per warp
    }
    for (int s = 0; s < PB_W_STAGES; ++s) {
      hopper::mbar_init(r.w_full(s), 1);
      hopper::mbar_init(r.w_empty(s), PB_CONSUMERS * 4);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (wg == PB_CONSUMERS) {
    // ---------------------------- producer ----------------------------
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(PB_PRODUCER_REGS));
    if (threadIdx.x != PB_CONSUMERS * 128) return;
    auto weights = [&](const CUtensorMap* map, int kt) {
      for (int dw = 0; dw < 3; ++dw)
        for (int q = 0; q < C / PB_QCI; ++q, ++r.wgn) {
          const int s = r.wgn % PB_W_STAGES;
          hopper::mbar_wait(r.w_empty(s), ((r.wgn / PB_W_STAGES) & 1) ^ 1);
          hopper::mbar_arrive_tx(r.w_full(s), PB_W_BYTES);
          const uint32_t st = r.wring + (uint32_t)s * PB_W_BYTES;
          for (int dh = 0; dh < 3; ++dh)
            hopper::tma_load_2d(st + (uint32_t)(dh * PB_QCI * RB), map, r.w_full(s),
                                ((kt * 3 + dh) * 3 + dw) * C + q * PB_QCI);
        }
    };
    for (int col = blockIdx.x; col < ncols; col += gridDim.x) {
      const PairColumn cl(col, tiles_h, tiles_w);
      for (int s = -1; s < T; ++s) {
        for (int kt = 0; kt < 3 && s + 1 < T; ++kt) {  // conv1 of z[s + 1]
          const int tx = s + kt;
          if (tx < 0 || tx >= T) continue;
          const int xs = r.xg % PB_X_STAGES;
          hopper::mbar_wait(r.x_empty(xs), ((r.xg / PB_X_STAGES) & 1) ^ 1);
          hopper::mbar_arrive_tx(r.x_full(xs), PB_X_LOAD);
          hopper::tma_load_5d(r.xring + (uint32_t)xs * PB_X_BYTES, &x_map, r.x_full(xs),
                              cl.w0 - 2, cl.h0 - 2, tx, cl.b);
          ++r.xg;
          weights(&w1_map, kt);
        }
        for (int kt = 0; kt < 3 && s >= 0; ++kt) {     // conv2 of y[s]
          const int tz = s + kt - 1;
          if (tz >= 0 && tz < T) weights(&w2_map, kt);
        }
      }
    }
  } else {
    // ---------------------------- consumers ---------------------------
    asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(PB_CONSUMER_REGS));
    pair_dispatch<0>(wg, r, T, H, W, tiles_h, tiles_w, ncols, b1, b2, slope, y, mid);
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
// bf16 before conv2, y and z rounded to nearest even).  `grid` persistent
// blocks walk the (B, H / 6, W / 28) columns of output tiles round-robin
// (conv3d_fuse.py's pair_plan), each through all of T.  Returns the CUDA
// error code (or 1000 + the driver's error when a tensor map cannot be
// encoded).
int conv3d64_pair_bf16(const void* x, const void* w1, const void* b1,
                       const void* w2, const void* b2, void* y, void* mid,
                       int B, int T, int H, int W, float slope, int grid,
                       void* stream) {
  CUtensorMap x_map, w1_map, w2_map;
  int err = hopper::encode_nthwc(&x_map, x, B, T, H, W, PB_S, PB_XH);
  if (err == 0) err = hopper::encode_weights(&w1_map, w1, PB_QCI);
  if (err == 0) err = hopper::encode_weights(&w2_map, w2, PB_QCI);
  if (err != 0) return err;
  cudaError_t cerr = cudaFuncSetAttribute(
      conv3d64_pair_bf16_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)PB_SMEM_BYTES);
  if (cerr != cudaSuccess) return (int)cerr;
  using E = __nv_bfloat16;
  const int tiles_w = (W + PB_OW - 1) / PB_OW;
  const int tiles_h = (H + PB_OH - 1) / PB_OH;
  conv3d64_pair_bf16_kernel<<<grid, PB_THREADS, PB_SMEM_BYTES, (cudaStream_t)stream>>>(
      x_map, w1_map, w2_map, static_cast<const E*>(b1), static_cast<const E*>(b2),
      static_cast<E*>(y), static_cast<E*>(mid), T, H, W, tiles_h, tiles_w,
      B * tiles_h * tiles_w, slope);
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

// The bf16 instance's also gives its output tile (rows, columns), for the
// launch plan.
int conv3d64_pair_bf16_config(int* smem_bytes, int* threads, int* blocks_per_sm,
                              int* tile_h, int* tile_w) {
  *smem_bytes = (int)PB_SMEM_BYTES;
  *threads = PB_THREADS;
  *tile_h = PB_OH;
  *tile_w = PB_OW;
  const cudaError_t err = cudaFuncSetAttribute(
      conv3d64_pair_bf16_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)PB_SMEM_BYTES);
  if (err != cudaSuccess) return (int)err;
  return occupancy((const void*)conv3d64_pair_bf16_kernel, PB_THREADS,
                   PB_SMEM_BYTES, blocks_per_sm);
}

}  // extern "C"
