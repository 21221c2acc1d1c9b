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
//   1. a partial kernel: block (p, c) owns one group p of taps and one
//      chunk c of the rows, and writes its taps' sums to its own slice of
//      the scratch buffer `partial` (nchunk, 27*64*64);
//   2. conv3d64_dw_reduce sums the chunks in a fixed order.  No atomics:
//      the result is the same from run to run.
// conv3d64_dw_{f32,bf16}_config report each instance's block, shared
// memory, blocks an SM (the occupancy API) and grid blocks a chunk, from
// which the wrapper plans the chunks and the scratch.
//
// The f32 instance (conv3d64_dw_partial): block (p, c) owns one (dt, dh)
// tap pair p and one chunk c of the (b, t, h, W-tile) row tiles.  Its 256
// threads hold the pair's 3 x 64 x 64 sums in registers (each thread a
// 4 ci x 4 co tile for all three W taps: 48 accumulators).  Per row tile
// the block stages the x row (TILE_W + 2 pixels, zero outside the input)
// and the dy row (TILE_W pixels) in shared memory; per pixel a thread
// reads four float4 (one dy, three x) for 48 FMAs.  Rows whose shifted x
// row lies outside the input add nothing and are skipped.  Bound: the
// same 2*27*64*64 FLOP per voxel as the forward against two reads of 256
// bytes per voxel, so it is bound by f32 operations (the non-tensor-core
// FMA rate), not by device memory.
//
// The bf16 instance (conv3d64_dw_pallas with bf16 x and dy,
// conv3d_pack.py:315-320: bf16 operands, f32 sums, f32 dw) is
// conv3d64_dw_bf16_partial, designed for Hopper:
//   * Bound: 2*27*64*64 FLOP per voxel at the bf16 tensor-core rate
//     (989 TFLOP/s) against 256 bytes per voxel read once (3.35 TB/s):
//     operations, by 3x.
//   * Products: wgmma.mma_async m64n64k16, bf16 in, f32 accumulate.  For
//     each tap dw[ci][co] += x_shift^T[ci][pixel] * dy[pixel][co]: M = the
//     64 input channels, N = the 64 output channels, K = pixels of a row.
//     A (x_shift^T) comes from registers, loaded by ldmatrix.trans at the
//     tap's one-pixel shift (warp i of a warpgroup: input channels
//     16i..16i+15, mma.sync's A-fragment layout); a shift inside a
//     128-byte swizzle atom would need a descriptor's base-offset field.
//     B (dy) is read by the tensor cores from shared memory through a
//     matrix descriptor: MN-major (transposed), 128-byte swizzle, 8-row
//     groups 1024 bytes apart.
//   * Reuse: block (dt, c) owns one temporal tap dt and all nine (dh, dw)
//     taps.  Three consumer warpgroups, one per dh, each hold their three
//     W taps' 3 x 64 x 64 f32 sums (96 accumulator registers a thread).
//     The block walks its chunk's rows along H: each dy row is loaded
//     once and multiplied by all nine taps, each x row is loaded once and
//     serves the three dh of three consecutive dy rows from a ring.  So
//     the input passes through shared memory 3 times (once per dt), where
//     the mma.sync design (one block per (dt, dh) pair) read it 9 times;
//     and a staged A fragment feeds 1 wgmma, a staged dy tile 9, where the
//     mma.sync design read both from shared memory for every product.
//   * Loads: one producer thread issues TMA loads (cp.async.bulk.tensor,
//     5-D tensor maps over NTHWC encoded on the host for each call and
//     passed as __grid_constant__ parameters) into a ring of BW_STAGES = 5
//     stages with full/empty mbarriers.  A stage holds one dy row tile
//     (128 pixels, 16 KB) and one x row tile (130 pixels with the W halo,
//     16.25 KB).  TMA zero-fills coordinates outside the volume: that is
//     the SAME padding in W (and past the ragged W edge), so there are no
//     masks; x rows outside H are neither loaded nor multiplied.
//     The stage of tick g holds dy row h and x row h + 1; warpgroup dh
//     multiplies dy of tick g by x of tick g - (2 - dh) and then releases
//     that x tick.  Each run of rows inside one (b, t, W tile) column
//     starts with two ticks that load only x rows h - 1 and h.
//   * Warp specialisation: 3 consumer warpgroups + 1 producer warpgroup
//     (512 threads, 1 block an SM by registers); setmaxnreg gives the
//     producer 40 registers and each consumer thread 152 (one if/else, no
//     block barrier after the split); ptxas: 128 registers at launch, no
//     spills.  Shared memory: 5 x 33,792 bytes of stages + barriers + 1 KB
//     to align the ring to 1024 bytes = 171,008.  Ring depths 4 to 6 time
//     within the noise (tools/kernel_variants.py dw-ring), so the loads
//     are not what bounds it: per k16 step a consumer warpgroup reads 6 KB
//     of A fragments and its 3 wgmmas 6 KB of B, as many shared-memory
//     cycles as the tensor cores spend on them.
//   * Within a row a warpgroup double-buffers its A fragments: the loads
//     of k-step k + 1 run while the wgmmas of step k are in flight
//     (wgmma.wait_group 1).
//   * The partials stay: 3 blocks (one per dt) a chunk, nchunk from the
//     card's SMs; the fixed-order reduce is the f32 instance's.
//
// Plain C interface, loaded with ctypes; launches on the caller's stream
// and returns cudaGetLastError() (or 1000 + the driver's error when a
// tensor map cannot be encoded).

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
// bf16 on the tensor cores: wgmma fed by a TMA ring
// ---------------------------------------------------------------------------

constexpr int BW_TILE_W = 128;                 // dy pixels per row tile
constexpr int BW_XPIX = BW_TILE_W + 2;         // x pixels with the W halo
constexpr int BW_STAGES = 5;
constexpr int BW_DY_BYTES = BW_TILE_W * ROW_BYTES;   // 16,384
constexpr int BW_X_LOAD = BW_XPIX * ROW_BYTES;       // 16,640
constexpr int BW_X_BYTES = 17 * 1024;                // x tile, 1024-aligned
constexpr int BW_STAGE_BYTES = BW_DY_BYTES + BW_X_BYTES;  // 33,792
constexpr int BW_CONSUMERS = 3;                // warpgroups, one per dh
constexpr int BW_THREADS = (BW_CONSUMERS + 1) * 128;
constexpr int BW_PRODUCER_REGS = 40;
constexpr int BW_CONSUMER_REGS = 152;
constexpr size_t BW_SMEM_BYTES =
    (size_t)BW_STAGES * BW_STAGE_BYTES + 1024 /* barriers */ + 1024 /* align */;
static_assert(BW_STAGE_BYTES % 1024 == 0, "stages keep the 128-byte swizzle atoms aligned");
static_assert(BW_X_LOAD <= BW_X_BYTES, "x tile");
static_assert(BW_PRODUCER_REGS * 128 + BW_CONSUMER_REGS * 128 * BW_CONSUMERS <= 65536,
              "register budget of one block");

// The rows of dt's chunk c: the (b, t, W tile) columns whose x slice
// t + dt - 1 lies inside [0, T), each of H rows, split evenly.
struct DwRows {
  long long begin, end;
  int t_lo, nt, H, tiles_w;
  __device__ DwRows(int dt, int chunk, int nchunk, int B, int T, int H_,
                    int tiles_w_) {
    t_lo = dt == 0 ? 1 : 0;
    nt = T - (dt != 1);
    H = H_;
    tiles_w = tiles_w_;
    const long long rows = nt > 0 ? (long long)B * nt * H * tiles_w : 0;
    begin = rows * chunk / nchunk;
    end = rows * (chunk + 1) / nchunk;
  }
  // the column of row r: its b, t, W tile; and its h
  __device__ void locate(long long r, int& b, int& t, int& wt, int& h) const {
    h = (int)(r % H);
    const long long col = r / H;
    wt = (int)(col % tiles_w);
    const long long bt = col / tiles_w;
    t = t_lo + (int)(bt % nt);
    b = (int)(bt / nt);
  }
};

__global__ void __launch_bounds__(BW_THREADS, 1)
conv3d64_dw_bf16_partial(const __grid_constant__ CUtensorMap x_map,
                         const __grid_constant__ CUtensorMap dy_map,
                         float* __restrict__ partial, int B, int T, int H, int W,
                         int tiles_w, int nchunk) {
  extern __shared__ unsigned char smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t ring = (raw + 1023u) & ~1023u;  // stage s at ring + s * STAGE
  const uint32_t bars = ring + BW_STAGES * BW_STAGE_BYTES;
  auto full = [&](int s) { return bars + 8u * s; };
  auto empty = [&](int s) { return bars + 8u * (BW_STAGES + s); };

  const int dt = blockIdx.x;
  const int chunk = blockIdx.y;
  const int wg = threadIdx.x >> 7;  // 0..2 consumers (dh), 3 producer
  const DwRows rows(dt, chunk, nchunk, B, T, H, tiles_w);

  if (threadIdx.x == 0) {
    for (int s = 0; s < BW_STAGES; ++s) {
      mbar_init(full(s), 1);                      // the producer's arrive
      mbar_init(empty(s), BW_CONSUMERS * 4);      // one arrive per consumer warp
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (wg == BW_CONSUMERS) {
    // ---------------------------- producer ----------------------------
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(BW_PRODUCER_REGS));
    if (threadIdx.x != BW_CONSUMERS * 128) return;
    int g = 0;
    for (long long r = rows.begin; r < rows.end;) {
      int b, t, wt, ha;
      rows.locate(r, b, t, wt, ha);
      const int n = (int)min((long long)(H - ha), rows.end - r);
      const int tx = t + dt - 1;
      const int w0 = wt * BW_TILE_W;
      for (int k = -2; k < n; ++k, ++g) {
        const int s = g % BW_STAGES;
        mbar_wait(empty(s), ((g / BW_STAGES) & 1) ^ 1);
        // tick k < 0: x row ha + k + 1 alone; else dy row ha + k and x row ha + k + 1
        const int xh = ha + k + 1;
        const bool has_x = xh >= 0 && xh < H;
        const bool has_dy = k >= 0;
        mbar_arrive_tx(full(s), (has_x ? BW_X_LOAD : 0) + (has_dy ? BW_DY_BYTES : 0));
        const uint32_t st = ring + (uint32_t)s * BW_STAGE_BYTES;
        if (has_dy) tma_load_5d(st, &dy_map, full(s), w0, ha + k, t, b);
        if (has_x) tma_load_5d(st + BW_DY_BYTES, &x_map, full(s), w0 - 1, xh, tx, b);
      }
      r += n;
    }
  } else {
    // ---------------------------- consumers ---------------------------
    asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(BW_CONSUMER_REGS));
    const int dh = wg;
    const int lane = threadIdx.x & 31;
    const int wi = (threadIdx.x >> 5) & 3;  // warp in the warpgroup: ci 16wi..
    // ldmatrix.trans rows of this lane (as in mma.sync's A fragment):
    // pixel (lane >> 4) * 8 + (lane & 7) of the k16 step, ci chunk
    // 2 wi + ((lane >> 3) & 1)
    const int a_k = (lane >> 4) * 8 + (lane & 7);
    const int a_chunk = 2 * wi + ((lane >> 3) & 1);

    float acc[3][32];
#pragma unroll
    for (int d = 0; d < 3; ++d)
#pragma unroll
      for (int i = 0; i < 32; ++i) acc[d][i] = 0.f;

    int g = 0;
    for (long long r = rows.begin; r < rows.end;) {
      int b, t, wt, ha;
      rows.locate(r, b, t, wt, ha);
      const int n = (int)min((long long)(H - ha), rows.end - r);
      const int ksteps = (min(BW_TILE_W, W - wt * BW_TILE_W) + 15) / 16;
      for (int k = -2; k < n; ++k, ++g) {
        const int s = g % BW_STAGES;
        mbar_wait(full(s), (g / BW_STAGES) & 1);
        const int gx = g - (2 - dh);  // the tick whose x row this warpgroup takes
        const int xh = ha + k + dh - 1;
        if (k >= 0 && xh >= 0 && xh < H) {
          const uint32_t dys = ring + (uint32_t)s * BW_STAGE_BYTES;
          const uint32_t xs =
              ring + (uint32_t)(gx % BW_STAGES) * BW_STAGE_BYTES + BW_DY_BYTES;
          uint32_t a[2][3][4];
#pragma unroll 1
          for (int kk = 0; kk < ksteps; kk += 2) {
#pragma unroll
            for (int half = 0; half < 2; ++half) {
              const int step = kk + half;
              if (step < ksteps) {
                wgmma_wait<1>();  // step - 2, the last reader of a[half], is done
#pragma unroll
                for (int tap = 0; tap < 3; ++tap)
                  ldsm_x4_t(a[half][tap], xs + swz(step * 16 + a_k + tap, a_chunk));
                wgmma_fence();
                const uint64_t desc = mn_desc(dys + (uint32_t)step * 2048u);
#pragma unroll
                for (int tap = 0; tap < 3; ++tap) wgmma_64x64(acc[tap], a[half][tap], desc);
                wgmma_commit();
              }
            }
          }
          wgmma_wait<0>();
        }
        // this warp is done with tick gx: release it to the producer
        __syncwarp();
        if (gx >= 0 && lane == 0) mbar_arrive(empty(gx % BW_STAGES));
      }
      r += n;
    }

    // accumulator (tap, 4j + e): ci = 16 wi + lane/4 (+8 for e >= 2),
    // co = 8j + 2 (lane % 4) + (e & 1); THWIO tap (dt * 3 + dh) * 3 + dw
    const int gq = lane >> 2;
    const int q = lane & 3;
#pragma unroll
    for (int tap = 0; tap < 3; ++tap) {
      float* out = partial + (size_t)chunk * TAPS +
                   (size_t)((dt * 3 + dh) * 3 + tap) * C * C;
#pragma unroll
      for (int j = 0; j < 8; ++j)
#pragma unroll
        for (int e2 = 0; e2 < 2; ++e2) {
          const int ci = 16 * wi + gq + 8 * e2;
          *reinterpret_cast<float2*>(out + ci * C + 8 * j + 2 * q) =
              make_float2(acc[tap][4 * j + 2 * e2], acc[tap][4 * j + 2 * e2 + 1]);
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
  CUtensorMap x_map, dy_map;
  int err = hopper::encode_nthwc(&x_map, x, B, T, H, W, BW_XPIX);
  if (err != 0) return err;
  err = hopper::encode_nthwc(&dy_map, dy, B, T, H, W, BW_TILE_W);
  if (err != 0) return err;
  cudaError_t cerr = cudaFuncSetAttribute(conv3d64_dw_bf16_partial,
                                          cudaFuncAttributeMaxDynamicSharedMemorySize,
                                          (int)BW_SMEM_BYTES);
  if (cerr != cudaSuccess) return (int)cerr;
  const int tiles_w = (W + BW_TILE_W - 1) / BW_TILE_W;
  conv3d64_dw_bf16_partial<<<dim3(3, (unsigned)nchunk), BW_THREADS, BW_SMEM_BYTES, s>>>(
      x_map, dy_map, partial, B, T, H, W, tiles_w, nchunk);
  cerr = cudaGetLastError();
  if (cerr != cudaSuccess) return (int)cerr;
  conv3d64_dw_reduce<<<(TAPS + REDUCE_THREADS - 1) / REDUCE_THREADS,
                       REDUCE_THREADS, 0, s>>>(partial, dw, nchunk);
  return (int)cudaGetLastError();
}

// The launch plan of each instance, for the wrapper and for reports:
// threads and dynamic shared memory of one block, blocks an SM on the
// current device (occupancy API), grid blocks a chunk (tap groups) and
// W pixels a row tile.  Returns the CUDA error code (0 on success).
int conv3d64_dw_f32_config(int* threads, int* smem_bytes, int* blocks_per_sm,
                           int* blocks_per_chunk, int* tile_w) {
  *threads = THREADS;
  *smem_bytes = 0;
  *blocks_per_chunk = 9;
  *tile_w = TILE_W;
  return occupancy((const void*)conv3d64_dw_partial, THREADS, 0, blocks_per_sm);
}

int conv3d64_dw_bf16_config(int* threads, int* smem_bytes, int* blocks_per_sm,
                            int* blocks_per_chunk, int* tile_w) {
  *threads = BW_THREADS;
  *smem_bytes = (int)BW_SMEM_BYTES;
  *blocks_per_chunk = 3;
  *tile_w = BW_TILE_W;
  const cudaError_t err = cudaFuncSetAttribute(
      conv3d64_dw_bf16_partial, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)BW_SMEM_BYTES);
  if (err != cudaSuccess) return (int)err;
  return occupancy((const void*)conv3d64_dw_bf16_partial, BW_THREADS, BW_SMEM_BYTES,
                   blocks_per_sm);
}

}  // extern "C"
