// K1 weight gradient: 3x3x3 SAME conv, 64 -> 64 channels, stride 1, f32
// and bf16 operands (f32 sums and result either way).
//
// Replaces the TPU kernel conv3d64_dw_pallas
// (hpvaegan_tpu/ops/pallas/conv3d_pack.py:307).  It computes the same
// function,
//
//   dw[dt,dh,dw,ci,co] = sum_{b,t,h,w} x[b, t+dt-1, h+dh-1, w+dw-1, ci]
//                                      * dy[b, t, h, w, co]
//
// with zeros outside the input, on NTHWC activations, into THWIO f32.
//
// The TPU kernel walks its grid in order and carries the whole sum in a
// VMEM block with a constant index map.  Blocks of a CUDA grid run in
// parallel and in no order, so the sum is split in two passes instead:
//   1. conv3d64_dw_partial: block (p, c) owns one (dt, dh) tap pair p and
//      one chunk c of the (b, t, h, W-tile) row tiles.  Its 256 threads
//      hold the pair's 3 x 64 x 64 sums in registers (each thread a
//      4 ci x 4 co tile for all three W taps: 48 accumulators).  Per row
//      tile the block stages the x row (TILE_W + 2 pixels, zero outside
//      the input) and the dy row (TILE_W pixels) in shared memory; per
//      pixel a thread reads four float4 (one dy, three x) for 48 FMAs.
//      Rows whose shifted x row lies outside the input add nothing and
//      are skipped.  Each block writes its sums to its own slice of the
//      scratch buffer `partial` (nchunk, 27*64*64).
//   2. conv3d64_dw_reduce sums the chunks in a fixed order.  No atomics:
//      the result is the same from run to run.
// Bound: the same 2*27*64*64 FLOP per voxel as the forward against two
// reads of 256 bytes per voxel, so it is bound by f32 operations (the
// non-tensor-core FMA rate), not by device memory.
//
// The bf16 instance (conv3d64_dw_pallas with bf16 x and dy,
// conv3d_pack.py:315-320: bf16 operands, f32 sums, f32 dw) keeps the same
// two passes and the same (tap pair, chunk) grid, with the products on the
// tensor cores (conv3d64_dw_bf16_partial): per row tile the block stages
// the bf16 x row (TILE_W + 2 pixels) and dy row (TILE_W pixels) in shared
// memory, XOR-swizzled by pixel, with cp.async into two stages so that the
// next tile's rows arrive while this one's are multiplied; each W tap's
// 64 x 64 sums are a GEMM
// dw[ci][co] += x_shift^T[ci][pixel] * dy[pixel][co] with K = the row's
// pixels, on mma.sync m16n8k16 with both operands read by ldmatrix.trans.
// Six warps: (W tap, half of the input channels), 32 ci x 64 co each (64
// f32 accumulators a thread).  Bound by the tensor-core rate as the
// forward; the chunk partials and the fixed-order reduce are unchanged.
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
constexpr int TILE_W = 64;        // dy pixels per row tile
constexpr int THREADS = 256;      // 16 ci groups x 16 co groups
constexpr int TAPS = 27 * C * C;  // floats of one full dw
constexpr int REDUCE_THREADS = 256;

__global__ void __launch_bounds__(THREADS, 3)
conv3d64_dw_partial(const float* __restrict__ x, const float* __restrict__ dy,
                    float* __restrict__ partial, int T, int H, int W,
                    int tiles_w, long long n_tiles, int nchunk) {
  __shared__ __align__(16) float xs[(TILE_W + 2) * C];  // [pixel][ci]
  __shared__ __align__(16) float ds[TILE_W * C];        // [pixel][co]

  const int pair = blockIdx.x;  // dt * 3 + dh
  const int dt = pair / 3;
  const int dh = pair % 3;
  const int chunk = blockIdx.y;
  const long long begin = n_tiles * chunk / nchunk;
  const long long end = n_tiles * (chunk + 1) / nchunk;

  const int tid = threadIdx.x;
  const int co0 = (tid % 16) * 4;
  const int ci0 = (tid / 16) * 4;

  float acc[3][4][4];
#pragma unroll
  for (int d = 0; d < 3; ++d)
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int k = 0; k < 4; ++k) acc[d][i][k] = 0.f;

  for (long long tile = begin; tile < end; ++tile) {
    const int wt = (int)(tile % tiles_w);
    const long long row = tile / tiles_w;  // ((b * T) + t) * H + h
    const int h = (int)(row % H);
    const long long bt = row / H;
    const int t = (int)(bt % T);
    const long long b = bt / T;
    const int tt = t + dt - 1;
    const int hh = h + dh - 1;
    if (tt < 0 || tt >= T || hh < 0 || hh >= H) continue;  // uniform
    const int w0 = wt * TILE_W;
    const int n = min(TILE_W, W - w0);

    __syncthreads();  // every thread is done with the previous tile
    const float* xrow = x + ((b * T + tt) * H + hh) * (size_t)W * C;
    for (int i = tid; i < (TILE_W + 2) * (C / 4); i += THREADS) {
      const int pix = i / (C / 4);
      const int c4 = i % (C / 4);
      const int ww = w0 - 1 + pix;
      float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
      if (ww >= 0 && ww < W)
        v = __ldg(reinterpret_cast<const float4*>(xrow + (size_t)ww * C) + c4);
      reinterpret_cast<float4*>(xs)[i] = v;
    }
    const float* dyrow = dy + ((b * T + t) * H + h) * (size_t)W * C;
    for (int i = tid; i < TILE_W * (C / 4); i += THREADS) {
      const int pix = i / (C / 4);
      const int c4 = i % (C / 4);
      float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
      if (w0 + pix < W)
        v = __ldg(reinterpret_cast<const float4*>(dyrow + (size_t)(w0 + pix) * C)
                  + c4);
      reinterpret_cast<float4*>(ds)[i] = v;
    }
    __syncthreads();

    for (int j = 0; j < n; ++j) {
      const float4 d = *reinterpret_cast<const float4*>(ds + j * C + co0);
      const float dv[4] = {d.x, d.y, d.z, d.w};
#pragma unroll
      for (int tap = 0; tap < 3; ++tap) {
        const float4 a = *reinterpret_cast<const float4*>(xs + (j + tap) * C + ci0);
        const float xv[4] = {a.x, a.y, a.z, a.w};
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int k = 0; k < 4; ++k)
            acc[tap][i][k] = fmaf(xv[i], dv[k], acc[tap][i][k]);
      }
    }
  }

  // THWIO order: this block's three taps are contiguous at pair * 3
  float* out = partial + (size_t)chunk * TAPS + (size_t)pair * 3 * C * C;
#pragma unroll
  for (int tap = 0; tap < 3; ++tap)
#pragma unroll
    for (int i = 0; i < 4; ++i)
      *reinterpret_cast<float4*>(out + (size_t)tap * C * C + (ci0 + i) * C + co0) =
          make_float4(acc[tap][i][0], acc[tap][i][1], acc[tap][i][2],
                      acc[tap][i][3]);
}

__global__ void conv3d64_dw_reduce(const float* __restrict__ partial,
                                   float* __restrict__ dw, int nchunk) {
  const int i = blockIdx.x * REDUCE_THREADS + threadIdx.x;
  if (i >= TAPS) return;
  float s = 0.f;
  for (int c = 0; c < nchunk; ++c) s += partial[(size_t)c * TAPS + i];
  dw[i] = s;
}

// ---------------------------------------------------------------------------
// bf16 on the tensor cores
// ---------------------------------------------------------------------------

constexpr int BF_THREADS = 192;       // 6 warps: (W tap, ci half)
constexpr int XROW_BYTES = (TILE_W + 2) * ROW_BYTES;  // one staged x row
constexpr int DROW_BYTES = TILE_W * ROW_BYTES;        // one staged dy row

// One row tile of a (dt, dh) tap pair: the dy row (t, h) from w0 on and the
// x row (t + dt - 1, h + dh - 1) from w0 - 1 on; `valid` false when the x
// row lies outside the input (the tile adds nothing).
struct DwTile {
  bool valid;
  const __nv_bfloat16* xrow;
  const __nv_bfloat16* dyrow;
  int w0, n;
};

__device__ __forceinline__ DwTile dw_tile(
    const __nv_bfloat16* x, const __nv_bfloat16* dy, long long tile, int dt,
    int dh, int T, int H, int W, int tiles_w) {
  DwTile d;
  const int wt = (int)(tile % tiles_w);
  const long long row = tile / tiles_w;  // ((b * T) + t) * H + h
  const int h = (int)(row % H);
  const long long bt = row / H;
  const int t = (int)(bt % T);
  const long long b = bt / T;
  const int tt = t + dt - 1;
  const int hh = h + dh - 1;
  d.valid = tt >= 0 && tt < T && hh >= 0 && hh < H;
  d.xrow = d.valid ? x + ((b * T + tt) * H + hh) * (size_t)W * C : x;
  d.dyrow = dy + ((b * T + t) * H + h) * (size_t)W * C;
  d.w0 = wt * TILE_W;
  d.n = min(TILE_W, W - d.w0);
  return d;
}

// start the copies of a tile's x and dy rows into one stage (zeros outside
// the input), as one commit group
__device__ __forceinline__ void dw_load_async(const DwTile& d, int W,
                                              uint32_t xs_s, uint32_t ds_s) {
  for (int i = threadIdx.x; i < (TILE_W + 2) * 8; i += BF_THREADS) {
    const int pix = i >> 3;
    const int ww = d.w0 - 1 + pix;
    const bool in = ww >= 0 && ww < W;
    cp_async16(xs_s + swz(pix, i & 7),
               reinterpret_cast<const uint4*>(d.xrow + (size_t)(in ? ww : 0) * C)
                   + (i & 7), in);
  }
  for (int i = threadIdx.x; i < TILE_W * 8; i += BF_THREADS) {
    const int pix = i >> 3;
    const bool in = pix < d.n;
    cp_async16(ds_s + swz(pix, i & 7),
               reinterpret_cast<const uint4*>(
                   d.dyrow + (size_t)(d.w0 + (in ? pix : 0)) * C) + (i & 7),
               in);
  }
}

__global__ void __launch_bounds__(BF_THREADS, 3)
conv3d64_dw_bf16_partial(const __nv_bfloat16* __restrict__ x,
                         const __nv_bfloat16* __restrict__ dy,
                         float* __restrict__ partial, int T, int H, int W,
                         int tiles_w, long long n_tiles, int nchunk) {
  // two stages: the next tile's rows arrive while this one is multiplied
  __shared__ __align__(128) unsigned char xs[2][XROW_BYTES];
  __shared__ __align__(128) unsigned char ds[2][DROW_BYTES];

  const int pair = blockIdx.x;  // dt * 3 + dh
  const int dt = pair / 3;
  const int dh = pair % 3;
  const int chunk = blockIdx.y;
  const long long begin = n_tiles * chunk / nchunk;
  const long long end = n_tiles * (chunk + 1) / nchunk;

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int tap = warp >> 1;        // W tap of this warp's sums
  const int ci0 = (warp & 1) * 32;  // its 32 input channels
  // ldmatrix.trans rows of this lane: pixel ((lane >> 3) & 1) * 8 +
  // (lane & 7) of the k16 step (A: (lane >> 4) picks the k half instead)
  const int a_k = (lane >> 4) * 8 + (lane & 7);
  const int a_half = (lane >> 3) & 1;
  const int b_k = ((lane >> 3) & 1) * 8 + (lane & 7);
  const int b_half = lane >> 4;

  float acc[2][8][4];
#pragma unroll
  for (int m = 0; m < 2; ++m)
#pragma unroll
    for (int n = 0; n < 8; ++n)
#pragma unroll
      for (int k = 0; k < 4; ++k) acc[m][n][k] = 0.f;

  // the tiles of this chunk whose x row lies inside the input, in order
  auto next_valid = [&](long long tile) {
    while (tile < end && !dw_tile(x, dy, tile, dt, dh, T, H, W, tiles_w).valid)
      ++tile;
    return tile;
  };
  long long cur = next_valid(begin);
  if (cur < end)
    dw_load_async(dw_tile(x, dy, cur, dt, dh, T, H, W, tiles_w), W,
             smem_u32(xs[0]), smem_u32(ds[0]));
  cp_async_commit();
  for (int s = 0; cur < end; s ^= 1) {
    const long long nxt = next_valid(cur + 1);
    if (nxt < end)
      dw_load_async(dw_tile(x, dy, nxt, dt, dh, T, H, W, tiles_w), W,
               smem_u32(xs[s ^ 1]), smem_u32(ds[s ^ 1]));
    cp_async_commit();
    cp_async_wait<1>();  // this tile's rows have landed (ours)
    __syncthreads();     // ... and every thread's

    const uint32_t xs_s = smem_u32(xs[s]);
    const uint32_t ds_s = smem_u32(ds[s]);
    const int n = dw_tile(x, dy, cur, dt, dh, T, H, W, tiles_w).n;
    // K = the tile's pixels, 16 at a time; dy is zero past n
    for (int k0 = 0; k0 < n; k0 += 16) {
      uint32_t a[2][4];
      // A[m = ci][k = pixel] = x[pixel + tap][ci]: stored pixel-major, so
      // ldmatrix.trans; matrices (ci 0-7, px 0-7), (ci 8-15, px 0-7),
      // (ci 0-7, px 8-15), (ci 8-15, px 8-15)
#pragma unroll
      for (int m = 0; m < 2; ++m)
        ldsm_x4_t(a[m], xs_s + swz(k0 + a_k + tap, (ci0 + m * 16) / 8 + a_half));
#pragma unroll
      for (int np = 0; np < 4; ++np) {
        uint32_t bq[4];
        ldsm_x4_t(bq, ds_s + swz(k0 + b_k, np * 2 + b_half));
#pragma unroll
        for (int m = 0; m < 2; ++m) {
          mma(acc[m][2 * np], a[m], bq[0], bq[1]);
          mma(acc[m][2 * np + 1], a[m], bq[2], bq[3]);
        }
      }
    }
    __syncthreads();  // every warp is done with stage s before it refills
    cur = nxt;
  }

  // accumulator (m, n, j): ci = ci0 + m*16 + lane/4 (+8 for j >= 2),
  // co = n*8 + 2*(lane%4) + (j & 1); THWIO: tap (pair * 3 + tap)
  float* out = partial + (size_t)chunk * TAPS + (size_t)(pair * 3 + tap) * C * C;
  const int g = lane >> 2;
  const int q = lane & 3;
#pragma unroll
  for (int m = 0; m < 2; ++m)
#pragma unroll
    for (int n = 0; n < 8; ++n)
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int ci = ci0 + m * 16 + g + half * 8;
        *reinterpret_cast<float2*>(out + ci * C + n * 8 + 2 * q) =
            make_float2(acc[m][n][2 * half], acc[m][n][2 * half + 1]);
      }
}

}  // namespace

extern "C" {

// x, dy: (B,T,H,W,64) f32; partial: (nchunk, 27*64*64) f32 scratch;
// dw: (3,3,3,64,64) f32 THWIO; all contiguous and 16-byte aligned.
// Returns the CUDA error code of the launches (0 on success).
int conv3d64_dw_f32(const float* x, const float* dy, float* partial,
                    float* dw, int B, int T, int H, int W, int nchunk,
                    void* stream) {
  const cudaStream_t s = (cudaStream_t)stream;
  const int tiles_w = (W + TILE_W - 1) / TILE_W;
  const long long n_tiles = (long long)B * T * H * tiles_w;
  conv3d64_dw_partial<<<dim3(9, (unsigned)nchunk), THREADS, 0, s>>>(
      x, dy, partial, T, H, W, tiles_w, n_tiles, nchunk);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  conv3d64_dw_reduce<<<(TAPS + REDUCE_THREADS - 1) / REDUCE_THREADS,
                       REDUCE_THREADS, 0, s>>>(partial, dw, nchunk);
  return (int)cudaGetLastError();
}

// The bf16 instance: x, dy (B,T,H,W,64) bf16; partial and dw f32 as above.
int conv3d64_dw_bf16(const void* x, const void* dy, float* partial,
                     float* dw, int B, int T, int H, int W, int nchunk,
                     void* stream) {
  const cudaStream_t s = (cudaStream_t)stream;
  const int tiles_w = (W + TILE_W - 1) / TILE_W;
  const long long n_tiles = (long long)B * T * H * tiles_w;
  conv3d64_dw_bf16_partial<<<dim3(9, (unsigned)nchunk), BF_THREADS, 0, s>>>(
      static_cast<const __nv_bfloat16*>(x),
      static_cast<const __nv_bfloat16*>(dy), partial, T, H, W, tiles_w,
      n_tiles, nchunk);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  conv3d64_dw_reduce<<<(TAPS + REDUCE_THREADS - 1) / REDUCE_THREADS,
                       REDUCE_THREADS, 0, s>>>(partial, dw, nchunk);
  return (int)cudaGetLastError();
}

}  // extern "C"
