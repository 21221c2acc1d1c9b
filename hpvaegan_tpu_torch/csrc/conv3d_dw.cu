// K1 weight gradient: 3x3x3 SAME conv, 64 -> 64 channels, stride 1, f32.
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
// Plain C interface, loaded with ctypes; launches on the caller's stream
// and returns cudaGetLastError().

#include <cuda_runtime.h>
#include <stddef.h>

namespace {

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

}  // extern "C"
