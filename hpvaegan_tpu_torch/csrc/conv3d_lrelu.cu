// K3: 3x3x3 SAME conv + bias + LeakyReLU(slope), any C_in and C_out, f32.
//
// Replaces the TPU kernel conv3d_lrelu_pallas
// (hpvaegan_tpu/ops/pallas/conv3d.py:138).  It computes the same function,
//
//   y[b,t,h,w,co] = lrelu(bias[co]
//       + sum_{dt,dh,dw,ci} x[b, t+dt-1, h+dh-1, w+dw-1, ci] * w[dt,dh,dw,ci,co])
//
// with zeros outside the input, on NTHWC activations and THWIO weights,
// f32 in and out.  The TPU kernel falls back to XLA's conv for T < 3 and
// when no H block fits its VMEM budget; that fallback is the same
// function, and this kernel computes every T and every size itself.
//
// Design (CUDA cores, f32 FMA), K1's f32 structure with channel loops:
//   * one block per (b, t, output tile, block of CO_BLK output channels);
//     128 threads, each owning 8 consecutive output columns x 4 output
//     channels (32 f32 accumulators);
//   * input channels in chunks of CI_BLK = 8: per temporal tap and chunk
//     the (TILE_H+2) x 34 x 8 input slab and the chunk's 9 (dh, dw) taps
//     x 8 x CO_BLK weights are staged in shared memory, zero-filled
//     outside the input and past C_in / C_out, so ragged channel counts
//     need no masks in the inner loop;
//   * CO_BLK is 32 (a 4 x 32 output tile) or, for C_out <= 8, 8 (a
//     16 x 32 tile), so a 64 -> 3 conv does not spend most of its work
//     on channels that do not exist;
//   * bias and LeakyReLU in the epilogue; scalar stores (C_out may be odd).
// Bound: 2*27*C_in*C_out FLOP per output voxel against 4*(C_in + C_out)
// bytes read and written, so f32 operations bound it for any C_in*C_out
// above ~4 (the main path's 3 -> 64, 64 -> 64, 64 -> 3).  Channel
// padding to multiples of 8 (C_in) and of CO_BLK (C_out) is wasted work;
// tensor cores (TF32 would change the numerics) are later work.
//
// Plain C interface, loaded with ctypes; launches on the caller's stream
// and returns cudaGetLastError().

#include <cuda_runtime.h>
#include <stddef.h>

namespace {

constexpr int THREADS = 128;
constexpr int TILE_W = 32;
constexpr int PX = 8;                    // output columns per thread
constexpr int CO = 4;                    // output channels per thread
constexpr int PGROUPS_W = TILE_W / PX;   // 4
constexpr int CI_BLK = 8;                // input channels per staged chunk
constexpr int SLAB_W = TILE_W + 2;

template <int CO_BLK>
struct Tile {
  static constexpr int CGROUPS = CO_BLK / CO;                        // 8 or 2
  static constexpr int TILE_H = THREADS / (CGROUPS * PGROUPS_W);     // 4 or 16
  static constexpr int SLAB_PIX = (TILE_H + 2) * SLAB_W;
  static constexpr int SLAB_STRIDE = SLAB_PIX + 1;  // spreads staging stores
  static constexpr int SMEM_X = CI_BLK * SLAB_STRIDE;                 // floats
  static constexpr int SMEM_X_PAD = (SMEM_X + 3) / 4 * 4;  // float4-align ws
  static constexpr int SMEM_W = 9 * CI_BLK * CO_BLK;                  // floats
  static constexpr size_t SMEM_BYTES =
      (size_t)(SMEM_X_PAD + SMEM_W) * sizeof(float);
};

template <int CO_BLK>
__global__ void __launch_bounds__(THREADS)
conv3d_lrelu_kernel(const float* __restrict__ x, const float* __restrict__ w,
                    const float* __restrict__ bias, float* __restrict__ y,
                    int T, int H, int W, int C_in, int C_out, int tiles_w,
                    int tiles, float slope) {
  using P = Tile<CO_BLK>;
  extern __shared__ __align__(16) float smem[];
  float* xs = smem;                   // [CI_BLK][SLAB_STRIDE]
  float* ws = smem + P::SMEM_X_PAD;   // [9 taps][CI_BLK][CO_BLK]

  const int tid = threadIdx.x;
  const int cg = tid % P::CGROUPS;
  const int pg = tid / P::CGROUPS;
  const int r = pg / PGROUPS_W;
  const int c0 = (pg % PGROUPS_W) * PX;

  const int tile = blockIdx.x % tiles;
  const int co0 = (blockIdx.x / tiles) * CO_BLK;
  const int h0 = (tile / tiles_w) * P::TILE_H;
  const int w0 = (tile % tiles_w) * TILE_W;
  const int t = blockIdx.y;
  const int b = blockIdx.z;
  const size_t frame = (size_t)H * W * C_in;
  const size_t tap_stride = (size_t)C_in * C_out;

  float acc[PX][CO];
#pragma unroll
  for (int j = 0; j < PX; ++j)
#pragma unroll
    for (int k = 0; k < CO; ++k) acc[j][k] = 0.f;

  for (int dt = 0; dt < 3; ++dt) {
    const int tt = t + dt - 1;
    if (tt < 0 || tt >= T) continue;  // uniform across the block
    const float* xt = x + ((size_t)b * T + tt) * frame;

    for (int ci0 = 0; ci0 < C_in; ci0 += CI_BLK) {
      __syncthreads();  // every thread is done with the previous chunk
      for (int i = tid; i < P::SLAB_PIX * CI_BLK; i += THREADS) {
        const int pix = i / CI_BLK;
        const int ci = i - pix * CI_BLK;
        const int sr = pix / SLAB_W;
        const int sc = pix - sr * SLAB_W;
        const int hh = h0 - 1 + sr;
        const int ww = w0 - 1 + sc;
        float v = 0.f;
        if (hh >= 0 && hh < H && ww >= 0 && ww < W && ci0 + ci < C_in)
          v = __ldg(xt + ((size_t)hh * W + ww) * C_in + ci0 + ci);
        xs[ci * P::SLAB_STRIDE + pix] = v;
      }
      for (int i = tid; i < P::SMEM_W; i += THREADS) {
        const int co = i % CO_BLK;
        const int ci = (i / CO_BLK) % CI_BLK;
        const int tap = i / (CO_BLK * CI_BLK);  // dh * 3 + dw
        float v = 0.f;
        if (ci0 + ci < C_in && co0 + co < C_out)
          v = __ldg(w + (size_t)(dt * 9 + tap) * tap_stride
                    + (size_t)(ci0 + ci) * C_out + co0 + co);
        ws[i] = v;
      }
      __syncthreads();

#pragma unroll
      for (int dh = 0; dh < 3; ++dh) {
        const float* xrow = xs + (r + dh) * SLAB_W + c0;
#pragma unroll 2
        for (int ci = 0; ci < CI_BLK; ++ci) {
          float xv[PX + 2];
#pragma unroll
          for (int j = 0; j < PX + 2; ++j) xv[j] = xrow[ci * P::SLAB_STRIDE + j];
#pragma unroll
          for (int dw = 0; dw < 3; ++dw) {
            const float4 wv = reinterpret_cast<const float4*>(
                ws + ((dh * 3 + dw) * CI_BLK + ci) * CO_BLK)[cg];
#pragma unroll
            for (int j = 0; j < PX; ++j) {
              const float xj = xv[j + dw];
              acc[j][0] = fmaf(xj, wv.x, acc[j][0]);
              acc[j][1] = fmaf(xj, wv.y, acc[j][1]);
              acc[j][2] = fmaf(xj, wv.z, acc[j][2]);
              acc[j][3] = fmaf(xj, wv.w, acc[j][3]);
            }
          }
        }
      }
    }
  }

  const int h = h0 + r;
  if (h >= H) return;
  float* yrow = y + (((size_t)b * T + t) * H + h) * (size_t)W * C_out;
#pragma unroll
  for (int k = 0; k < CO; ++k) {
    const int co = co0 + cg * CO + k;
    if (co >= C_out) break;
    const float bv = bias[co];
#pragma unroll
    for (int j = 0; j < PX; ++j) {
      const int ww = w0 + c0 + j;
      if (ww >= W) break;
      const float v = acc[j][k] + bv;
      yrow[(size_t)ww * C_out + co] = v >= 0.f ? v : v * slope;
    }
  }
}

template <int CO_BLK>
int launch(const float* x, const float* w, const float* bias, float* y, int B,
           int T, int H, int W, int C_in, int C_out, float slope,
           cudaStream_t stream) {
  using P = Tile<CO_BLK>;
  cudaError_t err = cudaFuncSetAttribute(
      conv3d_lrelu_kernel<CO_BLK>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)P::SMEM_BYTES);
  if (err != cudaSuccess) return (int)err;
  const int tiles_w = (W + TILE_W - 1) / TILE_W;
  const int tiles = tiles_w * ((H + P::TILE_H - 1) / P::TILE_H);
  const int co_blocks = (C_out + CO_BLK - 1) / CO_BLK;
  const dim3 grid((unsigned)(tiles * co_blocks), (unsigned)T, (unsigned)B);
  conv3d_lrelu_kernel<CO_BLK><<<grid, THREADS, P::SMEM_BYTES, stream>>>(
      x, w, bias, y, T, H, W, C_in, C_out, tiles_w, tiles, slope);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// x: (B,T,H,W,C_in) f32, w: (3,3,3,C_in,C_out) f32 THWIO, bias: (C_out,)
// f32, y: (B,T,H,W,C_out) f32; all contiguous.  Returns the CUDA error
// code of the launch (0 on success).
int conv3d_lrelu_f32(const float* x, const float* w, const float* bias,
                     float* y, int B, int T, int H, int W, int C_in, int C_out,
                     float slope, void* stream) {
  if (C_out <= 8)
    return launch<8>(x, w, bias, y, B, T, H, W, C_in, C_out, slope,
                     (cudaStream_t)stream);
  return launch<32>(x, w, bias, y, B, T, H, W, C_in, C_out, slope,
                    (cudaStream_t)stream);
}

// Output channels per block, dynamic shared memory and threads of one
// launch for C_out, for reports.
int conv3d_lrelu_f32_config(int C_out, int* co_blk, int* smem_bytes,
                            int* threads) {
  *co_blk = C_out <= 8 ? 8 : 32;
  *smem_bytes = (int)(C_out <= 8 ? Tile<8>::SMEM_BYTES : Tile<32>::SMEM_BYTES);
  *threads = THREADS;
  return 0;
}

}  // extern "C"
