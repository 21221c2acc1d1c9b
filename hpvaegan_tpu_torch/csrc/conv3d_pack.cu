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
// the output rounded to bf16 once) is conv3d64_fwd_bf16_kernel below,
// designed for Hopper.  The input gradient is the same kernel on
// flip_swap(w).
//   * Bound: 2*27*64*64 FLOP per voxel at the bf16 tensor-core rate
//     (989 TFLOP/s) against 256 bytes per voxel moved (3.35 TB/s):
//     operations, by 3x.  The previous design (mma.sync, one warp per
//     output row of an 8 x 32 tile, synchronous copies) reached 0.36 of
//     it: it staged 1.32 GB a launch at (2,13,144,256), 63% of it weights
//     that served 256 output pixels each, with no copy overlapped, and
//     mma.sync is not the card's full tensor-core rate.
//   * Products: wgmma.mma_async m64n64k16, bf16 in, f32 accumulate.  M = 64
//     output pixels of a row, N = the 64 output channels, K = 16 input
//     channels of one tap.  Both operands are read by the tensor cores
//     from shared memory: B (the tap's ci x co weights) through an
//     MN-major 128-byte-swizzle descriptor, A (x shifted by the tap's dw)
//     through a K-major one that starts at the shifted pixel of the TMA
//     buffer.  The tensor cores apply the swizzle to the address bits, so
//     a one-pixel shift inside a swizzle atom needs no base offset; A by
//     descriptor was 3-8% faster than A from registers by ldmatrix
//     (tools/kernel_variants.py k1-a, PERF.md).
//   * Reuse: a consumer warpgroup owns 4 output rows of 64 pixels (4
//     accumulators of 64 x 64, 128 registers a thread).  A weight stage
//     holds the three H taps (dt, 0..2, dw) for 32 input channels, so x
//     row j shifted by dw feeds the wgmmas of output rows j, j - 1 and
//     j - 2 from one stage: 12 wgmmas a k16 step behind one stage wait.
//   * Weights amortised: a block is 2 consumer warpgroups, an 8 x 64 output
//     tile (512 pixels, from 256), and each 12 KB weight stage serves it
//     all.  Per output frame a block stages 3 x 84,480 bytes of x slab and
//     216 KB of weights, 0.9 KB an output pixel (1.37 KB before).
//   * Copies off the critical path: one producer thread issues TMA loads
//     (5-D NTHWC map for x, boxes of 64 x 66 x 10 with the halo; 2-D map
//     over the 27 * 64 weight rows) into an x ring of 2 slabs and a weight
//     ring of 4 stages with full/empty mbarriers.  TMA's zero fill is the
//     SAME padding in H and W and the ragged edge; frames outside [0, T)
//     are skipped.  setmaxnreg gives the producer warpgroup 40 registers
//     and each consumer thread 232.
//   * Persistent: one block an SM (221,184 bytes of shared memory) walks
//     the (b, t, 8-row, 64-column) tiles round-robin, so the producer
//     loads the next tile while the consumers store this one.
//   * Epilogue: bias + LeakyReLU in f32, round to nearest even, bf16x2
//     stores straight from the accumulators.
//   * What bounds it now (kernel_variants k1-parts, PERF.md): the
//     products.  Cutting the weight loads, the x loads or the stores
//     saves 1-9% each; cutting the wgmmas saves half the time.
//   * ptxas (sm_90a, CUDA 12.8): 168 registers at launch (setmaxnreg then
//     gives the consumers 232), no spills, no stack; 221,184 bytes of
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

using namespace bf16_mma;
using namespace hopper;

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
// bf16 on the tensor cores: wgmma fed by TMA rings
// ---------------------------------------------------------------------------

constexpr int HK_TILE_W = 64;                   // output pixels of a row: wgmma's M
constexpr int HK_ROWS = 4;                      // output rows a consumer warpgroup
constexpr int HK_CONSUMERS = 2;                 // warpgroups
constexpr int HK_TILE_H = HK_ROWS * HK_CONSUMERS;  // 8
constexpr int HK_SLAB_W = HK_TILE_W + 2;        // 66
constexpr int HK_SLAB_H = HK_TILE_H + 2;        // 10
constexpr int HK_X_LOAD = HK_SLAB_W * HK_SLAB_H * ROW_BYTES;  // 84,480
constexpr int HK_X_BYTES = (HK_X_LOAD + 1023) / 1024 * 1024;  // 84,992
constexpr int HK_X_STAGES = 2;
static_assert(HK_X_STAGES >= 2, "x ring: a slab is released after the next one's first products");
constexpr int HK_QCI = 32;                      // input channels a weight stage
constexpr int HK_KSTEPS = HK_QCI / 16;          // k16 steps a weight stage
constexpr int HK_W_BYTES = 3 * HK_QCI * ROW_BYTES;  // the three dh taps: 12,288
constexpr int HK_W_STAGES = 4;
constexpr int HK_THREADS = (HK_CONSUMERS + 1) * 128;
constexpr int HK_PRODUCER_REGS = 40;
constexpr int HK_CONSUMER_REGS = 232;
constexpr size_t HK_SMEM_BYTES = (size_t)HK_X_STAGES * HK_X_BYTES +
                                 (size_t)HK_W_STAGES * HK_W_BYTES +
                                 1024 /* barriers */ + 1024 /* align */;
static_assert(HK_W_BYTES % 1024 == 0 && HK_X_BYTES % 1024 == 0,
              "stages keep the 128-byte swizzle atoms aligned");
static_assert(HK_KSTEPS == 2, "A fragments are double-buffered by k16 step");
static_assert(HK_PRODUCER_REGS * 128 + HK_CONSUMER_REGS * 128 * HK_CONSUMERS <= 65536,
              "register budget of one block");

// the output tile `tile` of the persistent walk: (b, t, tile row, tile column)
struct FwdTile {
  int b, t, h0, w0;
  __device__ FwdTile(int tile, int T, int tiles_h, int tiles_w) {
    w0 = (tile % tiles_w) * HK_TILE_W;
    int r = tile / tiles_w;
    h0 = (r % tiles_h) * HK_TILE_H;
    r /= tiles_h;
    t = r % T;
    b = r / T;
  }
};

__global__ void __launch_bounds__(HK_THREADS, 1)
conv3d64_fwd_bf16_kernel(const __grid_constant__ CUtensorMap x_map,
                         const __grid_constant__ CUtensorMap w_map,
                         const __nv_bfloat16* __restrict__ bias,
                         __nv_bfloat16* __restrict__ y, int T, int H, int W,
                         int tiles_h, int tiles_w, int ntiles, int has_act,
                         float slope) {
  extern __shared__ unsigned char smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t xring = (raw + 1023u) & ~1023u;
  const uint32_t wring = xring + HK_X_STAGES * HK_X_BYTES;
  const uint32_t bars = wring + HK_W_STAGES * HK_W_BYTES;
  auto x_full = [&](int s) { return bars + 8u * s; };
  auto x_empty = [&](int s) { return bars + 8u * (HK_X_STAGES + s); };
  auto w_full = [&](int s) { return bars + 8u * (2 * HK_X_STAGES + s); };
  auto w_empty = [&](int s) { return bars + 8u * (2 * HK_X_STAGES + HK_W_STAGES + s); };

  const int wg = threadIdx.x >> 7;  // 0..1 consumers, 2 producer
  if (threadIdx.x == 0) {
    for (int s = 0; s < HK_X_STAGES; ++s) {
      mbar_init(x_full(s), 1);
      mbar_init(x_empty(s), HK_CONSUMERS * 4);  // one arrive per consumer warp
    }
    for (int s = 0; s < HK_W_STAGES; ++s) {
      mbar_init(w_full(s), 1);
      mbar_init(w_empty(s), HK_CONSUMERS * 4);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (wg == HK_CONSUMERS) {
    // ---------------------------- producer ----------------------------
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(HK_PRODUCER_REGS));
    if (threadIdx.x != HK_CONSUMERS * 128) return;
    int xg = 0, wgn = 0;
    for (int tile = blockIdx.x; tile < ntiles; tile += gridDim.x) {
      const FwdTile tl(tile, T, tiles_h, tiles_w);
      for (int dt = 0; dt < 3; ++dt) {
        const int tt = tl.t + dt - 1;
        if (tt < 0 || tt >= T) continue;
        const int xs = xg % HK_X_STAGES;
        mbar_wait(x_empty(xs), ((xg / HK_X_STAGES) & 1) ^ 1);
        mbar_arrive_tx(x_full(xs), HK_X_LOAD);
        tma_load_5d(xring + (uint32_t)xs * HK_X_BYTES, &x_map, x_full(xs), tl.w0 - 1,
                    tl.h0 - 1, tt, tl.b);
        ++xg;
        for (int dw = 0; dw < 3; ++dw)
          for (int q = 0; q < C / HK_QCI; ++q, ++wgn) {
            const int s = wgn % HK_W_STAGES;
            mbar_wait(w_empty(s), ((wgn / HK_W_STAGES) & 1) ^ 1);
            mbar_arrive_tx(w_full(s), HK_W_BYTES);
            const uint32_t st = wring + (uint32_t)s * HK_W_BYTES;
            for (int dh = 0; dh < 3; ++dh)
              tma_load_2d(st + (uint32_t)(dh * HK_QCI * ROW_BYTES), &w_map, w_full(s),
                          ((dt * 3 + dh) * 3 + dw) * C + q * HK_QCI);
          }
      }
    }
  } else {
    // ---------------------------- consumers ---------------------------
    asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(HK_CONSUMER_REGS));
    const int lane = threadIdx.x & 31;
    const int wi = (threadIdx.x >> 5) & 3;  // warp: output pixels 16wi..16wi+15
    const int gq = lane >> 2;
    const int q4 = lane & 3;
    float bv[16];
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int e = 0; e < 2; ++e)
        bv[2 * j + e] = bias != nullptr ? __bfloat162float(bias[8 * j + 2 * q4 + e]) : 0.f;

    // a stage's slots are released once its products are done: after the
    // next stage's products are issued (wgmma_wait<1>), or at a tile's end
    int xg = 0, wgn = 0, done_w = -1, done_x = -1;
    auto release = [&]() {
      __syncwarp();
      if (lane == 0) {
        if (done_w >= 0) mbar_arrive(w_empty(done_w));
        if (done_x >= 0) mbar_arrive(x_empty(done_x));
      }
      done_w = done_x = -1;
    };
    for (int tile = blockIdx.x; tile < ntiles; tile += gridDim.x) {
      const FwdTile tl(tile, T, tiles_h, tiles_w);
      float acc[HK_ROWS][32];
#pragma unroll
      for (int o = 0; o < HK_ROWS; ++o)
#pragma unroll
        for (int i = 0; i < 32; ++i) acc[o][i] = 0.f;

      for (int dt = 0; dt < 3; ++dt) {
        const int tt = tl.t + dt - 1;
        if (tt < 0 || tt >= T) continue;
        const int xs = xg++ % HK_X_STAGES;
        mbar_wait(x_full(xs), ((xg - 1) / HK_X_STAGES) & 1);
        // this warpgroup's first slab row
        const uint32_t xrow0 =
            xring + (uint32_t)xs * HK_X_BYTES + wg * HK_ROWS * HK_SLAB_W * ROW_BYTES;
#pragma unroll 1
        for (int dw = 0; dw < 3; ++dw)
#pragma unroll 1
          for (int q = 0; q < C / HK_QCI; ++q, ++wgn) {
            const int s = wgn % HK_W_STAGES;
            mbar_wait(w_full(s), (wgn / HK_W_STAGES) & 1);
            const uint32_t st = wring + (uint32_t)s * HK_W_BYTES;
            wgmma_fence();
            // x row j of this warpgroup's slab rows, shifted by dw, feeds
            // output row j - dh with the weights of tap (dt, dh, dw)
#pragma unroll
            for (int kk = 0; kk < HK_KSTEPS; ++kk)
#pragma unroll
              for (int j = 0; j < HK_ROWS + 2; ++j)
#pragma unroll
                for (int dh = 0; dh < 3; ++dh) {
                  const int o = j - dh;
                  if (o >= 0 && o < HK_ROWS)
                    wgmma_64x64_ss(
                        acc[o],
                        k_desc(xrow0 + (uint32_t)((j * HK_SLAB_W + dw) * ROW_BYTES +
                                                  (q * HK_KSTEPS + kk) * 32)),
                        mn_desc(st + (uint32_t)(dh * HK_QCI * ROW_BYTES +
                                                kk * 16 * ROW_BYTES)));
                }
            wgmma_commit();
            wgmma_wait<1>();  // the previous stage's products are done
            release();
            done_w = s;
            if (dw == 2 && q == C / HK_QCI - 1) done_x = xs;
          }
      }
      wgmma_wait<0>();
      release();

      // accumulator (o, 4j + e): output row o of the warpgroup, pixel
      // 16wi + lane/4 (+8 for e >= 2), channels 8j + 2(lane%4) + (e & 1)
#pragma unroll
      for (int o = 0; o < HK_ROWS; ++o) {
        const int h = tl.h0 + wg * HK_ROWS + o;
        if (h >= H) break;
        __nv_bfloat16* yrow = y + (((size_t)tl.b * T + tl.t) * H + h) * (size_t)W * C;
#pragma unroll
        for (int half = 0; half < 2; ++half) {
          const int ww = tl.w0 + 16 * wi + gq + 8 * half;
          uint32_t pk[8];
#pragma unroll
          for (int j = 0; j < 8; ++j) {
            float v0 = acc[o][4 * j + 2 * half] + bv[2 * j];
            float v1 = acc[o][4 * j + 2 * half + 1] + bv[2 * j + 1];
            if (has_act) {
              v0 = v0 < 0.f ? v0 * slope : v0;
              v1 = v1 < 0.f ? v1 * slope : v1;
            }
            const __nv_bfloat162 v = __floats2bfloat162_rn(v0, v1);
            pk[j] = *reinterpret_cast<const uint32_t*>(&v);
          }
          store_pixel_bf16(ww < W ? yrow + (size_t)ww * C : nullptr, pk, lane);
        }
      }
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
// All contiguous and 16-byte aligned.  `grid` persistent blocks walk the
// (B, T, H / 8, W / 64) output tiles round-robin (conv3d_pack.py's
// fwd_plan).  Returns the CUDA error code (or 1000 + the driver's error
// when a tensor map cannot be encoded).
int conv3d64_fwd_bf16(const void* x, const void* w, const void* bias, void* y,
                      int B, int T, int H, int W, int has_act, float slope,
                      int grid, void* stream) {
  CUtensorMap x_map, w_map;
  int err = hopper::encode_nthwc(&x_map, x, B, T, H, W, HK_SLAB_W, HK_SLAB_H);
  if (err != 0) return err;
  err = hopper::encode_weights(&w_map, w, HK_QCI);
  if (err != 0) return err;
  cudaError_t cerr = cudaFuncSetAttribute(
      conv3d64_fwd_bf16_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)HK_SMEM_BYTES);
  if (cerr != cudaSuccess) return (int)cerr;
  const int tiles_w = (W + HK_TILE_W - 1) / HK_TILE_W;
  const int tiles_h = (H + HK_TILE_H - 1) / HK_TILE_H;
  const int ntiles = B * T * tiles_h * tiles_w;
  conv3d64_fwd_bf16_kernel<<<grid, HK_THREADS, HK_SMEM_BYTES, (cudaStream_t)stream>>>(
      x_map, w_map, static_cast<const __nv_bfloat16*>(bias),
      static_cast<__nv_bfloat16*>(y), T, H, W, tiles_h, tiles_w, ntiles, has_act,
      slope);
  return (int)cudaGetLastError();
}

// Dynamic shared memory and threads of one block, blocks an SM (the
// occupancy API on the current device) and the output tile (rows,
// columns), for the launch plan and reports.  Returns the CUDA error code.
int conv3d64_fwd_bf16_config(int* smem_bytes, int* threads, int* blocks_per_sm,
                             int* tile_h, int* tile_w) {
  *smem_bytes = (int)HK_SMEM_BYTES;
  *threads = HK_THREADS;
  *tile_h = HK_TILE_H;
  *tile_w = HK_TILE_W;
  const cudaError_t err = cudaFuncSetAttribute(
      conv3d64_fwd_bf16_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)HK_SMEM_BYTES);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      blocks_per_sm, conv3d64_fwd_bf16_kernel, HK_THREADS, HK_SMEM_BYTES);
}

}  // extern "C"
