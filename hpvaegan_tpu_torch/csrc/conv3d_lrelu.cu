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
// Bound: 2*27*C_in*C_out FLOP per output voxel at the f32 FMA rate
// against 4*(C_in + C_out) bytes read and written: operations for the
// main path's 3 -> 64, 64 -> 64 and 64 -> 3 (f32 has no tensor-core route
// with f32 numerics; TF32 would change them).
//
// Design for Hopper (CUDA cores, f32 FMA).  One stage loop, three instances
// chosen by the wrapper from (C_in, C_out) (conv3d.py k3_instance), each
// persistent: the wrapper launches (SMs x blocks an SM) blocks, from the
// kernel's own occupancy report (conv3d.py k3_plan).  A block's work is
// one stream of stages landing in a ring in shared memory by cp.async
// (16-byte copies where the channel counts and the pointers allow, else
// 4-byte ones; zero fill outside the input and past C_in or C_out), one
// commit group and one barrier a stage, so the next stage's copies run
// under this stage's FMAs and a tile's epilogue (bias, LeakyReLU, stores)
// under the next stage's copies.  The previous design (one block per
// tile and 8 or 32 output channels, channels padded to 8, synchronous
// scalar staging, 48 barriers a block) reached 0.14-0.48 of the bound.
//
//   * wide (C_in > 4, C_out > 8; the 64 -> 64 body conv): a block of 128
//     threads walks 4 x 32 output tiles of 64 output channels (blocks of
//     64 beyond that) round-robin, tile index ((((b*T + t)*tiles_h + th)
//     *tiles_w + tw)*co_blocks + cb); a stage is (tile, temporal tap whose
//     frame lies in [0, T), 16 input channels): that frame's x slab with
//     its 1-pixel halo, pixel-major as it lies in memory, and the 9 (dh,
//     dw) taps' weights (a zero tail only in the last chunk of a ragged
//     C_in).  Each thread owns 8 columns x 8 channels (64 accumulators),
//     channels 4cg..4cg+3 and 32+4cg..32+4cg+3, so a quarter warp reads
//     128 contiguous bytes of a weight row; a float4 x load carries 4
//     input channels, so 10 x and 24 weight float4 loads feed 768 FFMAs.
//     2 stages of 49,920 bytes, 2 blocks an SM.  What bounds it
//     (tools/kernel_variants.py k3-parts, PERF.md): the FMAs; without the
//     x copies it is 4% faster, without the weight copies 10%, without
//     the stores 1%.  A third stage (1 block an SM) is 36% slower
//     (k3-ring).
//   * narrow_in (C_in <= 4, C_out > 8; the 3 -> 64 encoder head): C_in a
//     template constant, so no channel is padding.  The same tiles and
//     thread tile; all 27 taps' weights of the block's 64 output channels
//     stay resident for the block's life (20.7 KB at C_in 3; the grid is
//     a multiple of co_blocks, so a block's tiles share their channel
//     block), and a stage is a whole tile: its three frames' x slabs,
//     channel-major, 7.3 KB, copied by threads that each keep a (frame,
//     column, channel) and walk its rows (6% faster than one copy an
//     iteration with its indices by division: k3-copies).  2 stages, 4
//     blocks an SM by its registers.  What bounds it (k3-parts): the FMAs
//     with the 64-channel stores, 245 MB a launch at (2,13,144,256):
//     without the stores 15% faster, without the x copies 13%, without
//     the FMAs 58%.
//   * narrow_out (C_out <= 8; the 64 -> 3 tail): C_out a template
//     constant, so no accumulator is padding.  The output is cut into
//     units (spatial 8 x 64 tile, t) with T innermost, and block k takes
//     the run of units [k*U/grid, (k+1)*U/grid): it streams the frames of
//     each spatial tile, staging every x frame once, in stages of 8 input
//     channels, and adding it to the three outputs f-1, f and f+1 it
//     feeds, held in registers (3 x 4 columns x C_out accumulators a
//     thread); a finished output is stored and the slots shift.  So an x
//     value is staged once, not three times, and feeds 81 FMAs at C_out
//     3.  x sits pixel-major in two float4 planes of 4 channels with a
//     skew of one pixel every 8 columns, so the 8 threads of a quarter
//     warp read 8 different bank groups.  All 27 taps' weights stay
//     resident where they take at most 27 KB (C_in <= 64 at C_out <= 4,
//     conv3d_lrelu_narrow_out_res: 7% faster than weights in every stage,
//     k3-out-weights), else each stage carries its channels' weights.
//     2 stages of 23,680 bytes (+ 27,648 resident at 64 -> 3), 3 blocks
//     an SM.  What bounds it (k3-parts): the FMAs and the x copies
//     overlap poorly: without the FMAs it takes 56% of its time, without
//     the x copies 78%, without the stores 98%.  Tried on the version
//     with weights in every stage (k3-out-occupancy, k3-out-chunk,
//     k3-out-l2): 8 columns a thread (2 blocks an SM) 6% slower; 4, 16 or
//     32 channels a stage 12-29% slower; an L2 prefetch size on the x
//     copies 2-14% slower (8 columns).
//   * ptxas (sm_90a, CUDA 12.8): wide 254 registers, narrow_in<3> 127,
//     narrow_out_res<3> 168, narrow_out<3> 159, narrow_out<8> 168, no
//     spills, no stack.
//     chip_smoke.py prints each with its instance's launch config.
//
// Plain C interface, loaded with ctypes; launches on the caller's stream
// and returns cudaGetLastError().

#include <cuda_runtime.h>
#include <limits.h>
#include <stddef.h>
#include <stdint.h>

#include "bf16_mma.cuh"  // cp_async16, cp_async_commit, cp_async_wait, smem_u32

namespace {

using bf16_mma::cp_async16;
using bf16_mma::cp_async_commit;
using bf16_mma::cp_async_wait;
using bf16_mma::smem_u32;

// 4 bytes global -> shared without registers; `valid` false fills a zero
// (nothing is read from `src`, which must still be a global address)
__device__ __forceinline__ void cp_async4(uint32_t dst, const void* src, bool valid) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n"
               :
               : "r"(dst), "l"(src), "r"(valid ? 4 : 0)
               : "memory");
}

// cp_async16 for narrow_out's x slabs (its own, so that a variant can
// give it an L2 prefetch size: tools/kernel_variants.py k3-out-l2)
__device__ __forceinline__ void cp_async16_x(uint32_t dst, const void* src, bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
               :
               : "r"(dst), "l"(src), "r"(valid ? 16 : 0)
               : "memory");
}

__device__ __forceinline__ float lrelu(float v, float slope) {
  return v < 0.f ? v * slope : v;
}

__device__ __forceinline__ float comp(const float4& v, int i) {
  return i == 0 ? v.x : i == 1 ? v.y : i == 2 ? v.z : v.w;
}

struct Problem {
  const float* x;
  const float* w;
  const float* bias;
  float* y;
  int T, H, W, C_in, C_out;
  int tiles_h, tiles_w, co_blocks, ntiles, nchunk;
  int vec_x, vec_w, vec_y;  // 16-byte copies of x, w; float4 stores of y
  float slope;
};

struct TilePos {
  int b, t, h0, w0, co0;
};

__device__ __forceinline__ int frame_of(const Problem& p, int tile) {
  return (tile / (p.co_blocks * p.tiles_w * p.tiles_h)) % p.T;
}

// One stage of a block's stream (wide): a tile of its round-robin walk, a temporal tap whose frame lies inside [0, T), an
// input-channel chunk.
struct TileStage {
  int tile, dt, chunk;
  __device__ static int dt_lo(int t) { return t == 0 ? 1 : 0; }
  __device__ static int dt_hi(int t, int T) { return t == T - 1 ? 1 : 2; }
  __device__ static TileStage at(const Problem& p, int tile) {
    return {tile, dt_lo(frame_of(p, tile)), 0};
  }
  __device__ static TileStage first(const Problem& p) { return at(p, blockIdx.x); }
  __device__ bool valid(const Problem& p) const { return tile < p.ntiles; }
  __device__ bool last_of_tile(const Problem& p) const {
    return chunk == p.nchunk - 1 && dt == dt_hi(frame_of(p, tile), p.T);
  }
  __device__ void next(const Problem& p) {
    if (++chunk < p.nchunk) return;
    chunk = 0;
    if (dt < dt_hi(frame_of(p, tile), p.T)) {
      ++dt;
      return;
    }
    *this = at(p, tile + gridDim.x);
  }
};

// One stage a tile (narrow_in): the tiles of the block's round-robin walk.
struct TileOnce {
  int tile;
  __device__ static TileOnce first(const Problem&) { return {(int)blockIdx.x}; }
  __device__ bool valid(const Problem& p) const { return tile < p.ntiles; }
  __device__ void next(const Problem&) { tile += gridDim.x; }
};

// ---------------------------------------------------------------------------
// 8 output columns x 8 output channels a thread (wide, narrow_in)
// ---------------------------------------------------------------------------

struct Px8Co8 {
  using StageT = TileStage;
  static constexpr int THREADS = 128;
  static constexpr int TILE_H = 4, TILE_W = 32, CO_BLK = 64, PX = 8;
  static constexpr int SLAB_W = TILE_W + 2;
  static constexpr int SLAB_PIX = (TILE_H + 2) * SLAB_W;  // 204
  __host__ __device__ static int res_floats(int) { return 0; }  // nothing resident
  float acc[PX][8];
  int cg, r, c0;

  __device__ static void load_res(const Problem&, float*) {}

  __device__ void init(const float*) {
    cg = threadIdx.x % 8;
    const int pg = threadIdx.x / 8;
    r = pg / (TILE_W / PX);
    c0 = (pg % (TILE_W / PX)) * PX;
  }

  __device__ void zero() {
#pragma unroll
    for (int j = 0; j < PX; ++j)
#pragma unroll
      for (int k = 0; k < 8; ++k) acc[j][k] = 0.f;
  }

  // tile index ((((b*T + t)*tiles_h + th)*tiles_w + tw)*co_blocks + cb)
  __device__ static TilePos tile_pos(const Problem& p, int tile) {
    TilePos o;
    const int cb = tile % p.co_blocks;
    int r = tile / p.co_blocks;
    const int tw = r % p.tiles_w;
    r /= p.tiles_w;
    const int th = r % p.tiles_h;
    r /= p.tiles_h;
    o.t = r % p.T;
    o.b = r / p.T;
    o.h0 = th * TILE_H;
    o.w0 = tw * TILE_W;
    o.co0 = cb * CO_BLK;
    return o;
  }

  __device__ static TilePos position(const Problem& p, const TileStage& s) {
    return tile_pos(p, s.tile);
  }

  // after a stage's products: the epilogue once the tile is complete
  __device__ void after(const Problem& p, const TileStage& s) {
    if (!s.last_of_tile(p)) return;
    store(p, position(p, s));
    zero();
  }

  // acc[j] += xv[j + dw] * (wa, wb)
  __device__ __forceinline__ void fma8(const float (&xv)[PX + 2], int dw, const float4& wa,
                                       const float4& wb) {
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

  __device__ void store(const Problem& p, const TilePos& o) const {
    const int h = o.h0 + r;
    if (h >= p.H) return;
    const int coa = o.co0 + 4 * cg, cob = coa + 32;
    float bv[8];
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      bv[k] = coa + k < p.C_out ? __ldg(p.bias + coa + k) : 0.f;
      bv[4 + k] = cob + k < p.C_out ? __ldg(p.bias + cob + k) : 0.f;
    }
    float* row = p.y + (((size_t)o.b * p.T + o.t) * p.H + h) * (size_t)p.W * p.C_out;
#pragma unroll
    for (int j = 0; j < PX; ++j) {
      const int ww = o.w0 + c0 + j;
      if (ww >= p.W) break;
      float v[8];
#pragma unroll
      for (int k = 0; k < 8; ++k) v[k] = lrelu(acc[j][k] + bv[k], p.slope);
      float* px = row + (size_t)ww * p.C_out;
      if (p.vec_y) {
        if (coa < p.C_out)
          *reinterpret_cast<float4*>(px + coa) = make_float4(v[0], v[1], v[2], v[3]);
        if (cob < p.C_out)
          *reinterpret_cast<float4*>(px + cob) = make_float4(v[4], v[5], v[6], v[7]);
      } else {
#pragma unroll
        for (int k = 0; k < 4; ++k) {
          if (coa + k < p.C_out) px[coa + k] = v[k];
          if (cob + k < p.C_out) px[cob + k] = v[4 + k];
        }
      }
    }
  }
};

// wide: any C_in > 4, C_out > 8
struct Wide : Px8Co8 {
  static constexpr int CI = 16;  // input channels a stage
  static constexpr int STAGES = 2;  // wide ring
  static constexpr int MIN_BLOCKS = 2;
  static constexpr int X_FLOATS = SLAB_PIX * CI;      // [pixel][ci]
  static constexpr int W_FLOATS = 9 * CI * CO_BLK;    // [dh*3 + dw][ci][co]
  static constexpr int STAGE_FLOATS = X_FLOATS + W_FLOATS;

  __device__ static void load_x(const Problem& p, const TilePos& o, const TileStage& s,
                                float* dst) {
    const int ci0 = s.chunk * CI;
    const float* xt =
        p.x + ((size_t)o.b * p.T + o.t + s.dt - 1) * p.H * (size_t)p.W * p.C_in;
    const uint32_t d = smem_u32(dst);
    if (p.vec_x) {
      for (int i = threadIdx.x; i < SLAB_PIX * (CI / 4); i += THREADS) {
        const int pix = i / (CI / 4);
        const int ci = ci0 + 4 * (i % (CI / 4));
        const int hh = o.h0 - 1 + pix / SLAB_W, ww = o.w0 - 1 + pix % SLAB_W;
        const bool ok = hh >= 0 && hh < p.H && ww >= 0 && ww < p.W && ci < p.C_in;
        cp_async16(d + 16u * i, ok ? xt + ((size_t)hh * p.W + ww) * p.C_in + ci : p.x, ok);
      }
    } else {
      for (int i = threadIdx.x; i < SLAB_PIX * CI; i += THREADS) {
        const int pix = i / CI;
        const int ci = ci0 + i % CI;
        const int hh = o.h0 - 1 + pix / SLAB_W, ww = o.w0 - 1 + pix % SLAB_W;
        const bool ok = hh >= 0 && hh < p.H && ww >= 0 && ww < p.W && ci < p.C_in;
        cp_async4(d + 4u * i, ok ? xt + ((size_t)hh * p.W + ww) * p.C_in + ci : p.x, ok);
      }
    }
  }

  // the chunk's 9 (dh, dw) taps x CI input channels x 64 output channels
  // of temporal tap s.dt, [tap][ci][co], zero past C_in and C_out
  __device__ static void load_w(const Problem& p, const TilePos& o, const TileStage& s,
                                float* dst) {
    const int ci0 = s.chunk * CI;
    const float* wt = p.w + (size_t)s.dt * 9 * p.C_in * p.C_out;
    const uint32_t d = smem_u32(dst);
    if (p.vec_w) {
      for (int i = threadIdx.x; i < 9 * CI * (CO_BLK / 4); i += THREADS) {
        const int co = o.co0 + 4 * (i % (CO_BLK / 4));
        const int rest = i / (CO_BLK / 4);
        const int ci = ci0 + rest % CI;
        const int tap = rest / CI;
        const bool ok = ci < p.C_in && co < p.C_out;
        cp_async16(d + 16u * i, ok ? wt + ((size_t)tap * p.C_in + ci) * p.C_out + co : p.w,
                   ok);
      }
    } else {
      for (int i = threadIdx.x; i < 9 * CI * CO_BLK; i += THREADS) {
        const int co = o.co0 + i % CO_BLK;
        const int rest = i / CO_BLK;
        const int ci = ci0 + rest % CI;
        const int tap = rest / CI;
        const bool ok = ci < p.C_in && co < p.C_out;
        cp_async4(d + 4u * i, ok ? wt + ((size_t)tap * p.C_in + ci) * p.C_out + co : p.w,
                  ok);
      }
    }
  }

  __device__ void compute(const Problem&, const TileStage&, const float* st) {
    const float* ws = st + X_FLOATS + 4 * cg;
#pragma unroll 1
    for (int dh = 0; dh < 3; ++dh) {
      const float* xrow = st + ((r + dh) * SLAB_W + c0) * CI;
      const float* wdh = ws + dh * 3 * CI * CO_BLK;
#pragma unroll 2
      for (int q = 0; q < CI / 4; ++q) {
        float4 x4[PX + 2];
#pragma unroll
        for (int j = 0; j < PX + 2; ++j)
          x4[j] = *reinterpret_cast<const float4*>(xrow + j * CI + 4 * q);
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          float xv[PX + 2];
#pragma unroll
          for (int j = 0; j < PX + 2; ++j) xv[j] = comp(x4[j], c);
#pragma unroll
          for (int dw = 0; dw < 3; ++dw) {
            const float* wr = wdh + (dw * CI + 4 * q + c) * CO_BLK;
            fma8(xv, dw, *reinterpret_cast<const float4*>(wr),
                 *reinterpret_cast<const float4*>(wr + 32));
          }
        }
      }
    }
  }
};

// narrow_in: C_in = CIN <= 4, C_out > 8
template <int CIN>
struct NarrowIn : Px8Co8 {
  using StageT = TileOnce;
  static constexpr int CI = CIN;
  static constexpr int STAGES = 2;  // narrow_in ring
  static constexpr int MIN_BLOCKS = 2;  // narrow_in blocks an SM
  static constexpr int X_FLOATS = 3 * CIN * SLAB_PIX;  // [dt][ci][pixel]
  static constexpr int W_FLOATS = 0;
  static constexpr int STAGE_FLOATS = X_FLOATS;
  static constexpr int RES_FLOATS = 27 * CIN * CO_BLK;  // [dt*9 + dh*3 + dw][ci][co]
  __host__ __device__ static int res_floats(int) { return RES_FLOATS; }
  static_assert(X_FLOATS % 4 == 0, "resident weights 16-byte aligned");
  const float* wres;

  __device__ void init(const float* res) {
    Px8Co8::init(res);
    wres = res + 4 * cg;
  }

  // the block's 64 output channels of all 27 taps, for its life: with a
  // grid that is a multiple of co_blocks, every tile of a block's walk
  // has the block's channel block blockIdx.x % co_blocks
  __device__ static void load_res(const Problem& p, float* dst) {
    const int co0 = (blockIdx.x % p.co_blocks) * CO_BLK;
    const uint32_t d = smem_u32(dst);
    if (p.vec_w) {
      for (int i = threadIdx.x; i < RES_FLOATS / 4; i += THREADS) {
        const int co = co0 + 4 * (i % (CO_BLK / 4));
        const int row = i / (CO_BLK / 4);  // tap * CIN + ci
        const bool ok = co < p.C_out;
        cp_async16(d + 16u * i, ok ? p.w + (size_t)row * p.C_out + co : p.w, ok);
      }
    } else {
      for (int i = threadIdx.x; i < RES_FLOATS; i += THREADS) {
        const int co = co0 + i % CO_BLK;
        const int row = i / CO_BLK;
        const bool ok = co < p.C_out;
        cp_async4(d + 4u * i, ok ? p.w + (size_t)row * p.C_out + co : p.w, ok);
      }
    }
  }

  __device__ static TilePos position(const Problem& p, const TileOnce& s) {
    return tile_pos(p, s.tile);
  }

  // the tile's three frames, channel-major, zero outside the input
  __device__ static void load_x(const Problem& p, const TilePos& o, const TileOnce&,
                                float* dst) {
    const float* xb = p.x + (size_t)o.b * p.T * p.H * (size_t)p.W * CIN;
    const uint32_t d = smem_u32(dst);
    // a thread keeps one (frame, column, channel) and walks the slab's rows
    for (int i = threadIdx.x; i < 3 * SLAB_W * CIN; i += THREADS) {
      const int ci = i % CIN, sc = (i / CIN) % SLAB_W, dt = i / (CIN * SLAB_W);
      const int tt = o.t + dt - 1, ww = o.w0 - 1 + sc;
      const bool col_ok = tt >= 0 && tt < p.T && ww >= 0 && ww < p.W;
      const long long at = (((long long)tt * p.H + o.h0 - 1) * p.W + ww) * CIN + ci;
      const uint32_t dc = d + 4u * ((dt * CIN + ci) * SLAB_PIX + sc);
#pragma unroll
      for (int sr = 0; sr < TILE_H + 2; ++sr) {
        const int hh = o.h0 - 1 + sr;
        const bool ok = col_ok && hh >= 0 && hh < p.H;
        cp_async4(dc + 4u * sr * SLAB_W, ok ? xb + at + (long long)sr * p.W * CIN : p.x, ok);
      }
    }
  }

  __device__ static void load_w(const Problem&, const TilePos&, const TileOnce&, float*) {}

  __device__ void compute(const Problem& p, const TileOnce& s, const float* st) {
    const int t = frame_of(p, s.tile);
#pragma unroll 1
    for (int dt = 0; dt < 3; ++dt) {
      if (t + dt - 1 < 0 || t + dt - 1 >= p.T) continue;  // uniform across the block
#pragma unroll
      for (int dh = 0; dh < 3; ++dh)
#pragma unroll
        for (int c = 0; c < CIN; ++c) {
          const float* xrow = st + (dt * CIN + c) * SLAB_PIX + (r + dh) * SLAB_W + c0;
          float xv[PX + 2];
#pragma unroll
          for (int j = 0; j < PX + 2; ++j) xv[j] = xrow[j];
#pragma unroll
          for (int dw = 0; dw < 3; ++dw) {
            const float* wr = wres + (((dt * 3 + dh) * 3 + dw) * CIN + c) * CO_BLK;
            fma8(xv, dw, *reinterpret_cast<const float4*>(wr),
                 *reinterpret_cast<const float4*>(wr + 32));
          }
        }
    }
  }

  __device__ void after(const Problem& p, const TileOnce& s) {
    store(p, position(p, s));
    zero();
  }
};

// ---------------------------------------------------------------------------
// narrow_out: C_out = COUT <= 8, any C_in, streaming T
// ---------------------------------------------------------------------------

// A block's run of outputs: units u = s*T + t (s the spatial tile,
// ((b*tiles_h + th)*tiles_w + tw)) in [ub, ue), block k of the grid taking
// [k*U/grid, (k+1)*U/grid) of the U = ntiles units.  A piece of the run is
// one spatial tile's outputs [ta, tb); its stages are the frames f from
// max(ta-1, 0) to min(tb, T-1), each in input-channel chunks, and every
// frame feeds the outputs f-1, f and f+1 that lie in the piece.
struct RunStage {
  int s, ta, tb, f, chunk, ue;
  __device__ void piece(const Problem& p, int u) {
    s = u / p.T;
    ta = u % p.T;
    tb = min(p.T, ue - s * p.T);
    f = max(ta - 1, 0);
    chunk = 0;
  }
  __device__ static RunStage first(const Problem& p) {
    RunStage r;
    const int ub = (int)((long long)blockIdx.x * p.ntiles / gridDim.x);
    r.ue = (int)((long long)(blockIdx.x + 1) * p.ntiles / gridDim.x);
    if (ub < r.ue)
      r.piece(p, ub);
    else
      r.s = -1;
    return r;
  }
  __device__ bool valid(const Problem&) const { return s >= 0; }
  __device__ int f_hi(const Problem& p) const { return min(tb, p.T - 1); }
  __device__ bool feeds(int t) const { return t >= ta && t < tb; }
  __device__ void next(const Problem& p) {
    if (++chunk < p.nchunk) return;
    chunk = 0;
    if (f < f_hi(p)) {
      ++f;
      return;
    }
    const int u = s * p.T + tb;
    if (u < ue)
      piece(p, u);
    else
      s = -1;
  }
};

// RES: all 27 taps' weights of every input channel stay in shared memory
// for the block's life (where they fit: resident_out), else each stage
// carries its channels' weights
template <int COUT, bool RES>
struct NarrowOut {
  using StageT = RunStage;
  static constexpr int PX = 4;  // output columns a thread
  static constexpr int CO_PAD = COUT <= 4 ? 4 : 8;  // a weight row in shared memory
  static constexpr int TCOLS = 64 / PX, TROWS = 128 / TCOLS;  // a 64-column tile
  static constexpr int THREADS = TCOLS * TROWS;  // 128
  static constexpr int TILE_W = PX * TCOLS, TILE_H = TROWS, CO_BLK = COUT;
  static constexpr int NQ = 2;       // float4 planes of a stage
  static constexpr int CI = 4 * NQ;  // input channels a stage
  static constexpr int STAGES = 2;   // narrow_out ring
  static constexpr int MIN_BLOCKS = 3;  // narrow_out blocks an SM
  static constexpr int SLAB_W = TILE_W + 2;
  static constexpr int SLAB_POS = SLAB_W + (SLAB_W - 1) / 8;      // + 1 skew per 8
  static constexpr int X_FLOATS = (TILE_H + 2) * NQ * SLAB_POS * 4;  // [row][q][pos][4]
  static constexpr int W_FLOATS = RES ? 0 : 27 * CI * CO_PAD;  // [dt][dh][dw][ci][co]
  static constexpr int STAGE_FLOATS = X_FLOATS + W_FLOATS;
  static_assert(X_FLOATS % 4 == 0, "weights 16-byte aligned");
  // [dt*9 + dh*3 + dw][ci, to a whole stage][co]
  __host__ __device__ static int res_floats(int C_in) {
    return RES ? 27 * ((C_in + CI - 1) / CI * CI) * CO_PAD : 0;
  }
  // acc[0], acc[1], acc[2]: the outputs f-1, f and f+1 of the stage's frame f
  float acc[3][PX][COUT];
  int tc, tr;

  __device__ static int pos(int col) { return col + col / 8; }

  const float* wres;

  // a (tap, ci) row of COUT weights a copy group; zero past C_in (the
  // padding to CO_PAD is never read)
  __device__ static void load_res(const Problem& p, float* dst) {
    if constexpr (RES) {
      const int cin = p.nchunk * CI;
      const uint32_t d = smem_u32(dst);
      for (int i = threadIdx.x; i < 27 * cin; i += THREADS) {
        const int ci = i % cin, tap = i / cin;
        const bool ok = ci < p.C_in;
        const float* src = p.w + ((size_t)tap * p.C_in + ci) * COUT;
#pragma unroll
        for (int co = 0; co < COUT; ++co)
          cp_async4(d + 4u * (i * CO_PAD + co), ok ? src + co : p.w, ok);
      }
    }
  }

  __device__ void init(const float* res) {
    wres = res;
    tc = threadIdx.x % TCOLS;
    tr = threadIdx.x / TCOLS;
  }

  __device__ void zero_slot(int i) {
#pragma unroll
    for (int j = 0; j < PX; ++j)
#pragma unroll
      for (int k = 0; k < COUT; ++k) acc[i][j][k] = 0.f;
  }

  __device__ void zero() {
#pragma unroll
    for (int i = 0; i < 3; ++i) zero_slot(i);
  }

  // (b, h0, w0) of the spatial tile, the stage's frame in t
  __device__ static TilePos position(const Problem& p, const RunStage& r) {
    TilePos o;
    o.b = r.s / (p.tiles_h * p.tiles_w);
    const int rest = r.s % (p.tiles_h * p.tiles_w);
    o.h0 = (rest / p.tiles_w) * TILE_H;
    o.w0 = (rest % p.tiles_w) * TILE_W;
    o.t = r.f;
    o.co0 = 0;
    return o;
  }

  __device__ static void load_x(const Problem& p, const TilePos& o, const RunStage& r,
                                float* dst) {
    const int ci0 = r.chunk * CI;
    const float* xt = p.x + ((size_t)o.b * p.T + o.t) * p.H * (size_t)p.W * p.C_in;
    const uint32_t d = smem_u32(dst);
    if (p.vec_x) {
      for (int i = threadIdx.x; i < (TILE_H + 2) * SLAB_W * NQ; i += THREADS) {
        const int q = i % NQ, pix = i / NQ;
        const int sr = pix / SLAB_W, sc = pix % SLAB_W;
        const int hh = o.h0 - 1 + sr, ww = o.w0 - 1 + sc;
        const int ci = ci0 + 4 * q;
        const bool ok = hh >= 0 && hh < p.H && ww >= 0 && ww < p.W && ci < p.C_in;
        cp_async16_x(d + 16u * ((sr * NQ + q) * SLAB_POS + pos(sc)),
                     ok ? xt + ((size_t)hh * p.W + ww) * p.C_in + ci : p.x, ok);
      }
    } else {
      for (int i = threadIdx.x; i < (TILE_H + 2) * SLAB_W * CI; i += THREADS) {
        const int c = i % CI, pix = i / CI;
        const int sr = pix / SLAB_W, sc = pix % SLAB_W;
        const int hh = o.h0 - 1 + sr, ww = o.w0 - 1 + sc;
        const int ci = ci0 + c;
        const bool ok = hh >= 0 && hh < p.H && ww >= 0 && ww < p.W && ci < p.C_in;
        cp_async4(d + 4u * (((sr * NQ + c / 4) * SLAB_POS + pos(sc)) * 4 + c % 4),
                  ok ? xt + ((size_t)hh * p.W + ww) * p.C_in + ci : p.x, ok);
      }
    }
  }

  // all 27 taps of the chunk's input channels
  __device__ static void load_w(const Problem& p, const TilePos&, const RunStage& r,
                                float* dst) {
    if constexpr (RES) return;
    const int ci0 = r.chunk * CI;
    const uint32_t d = smem_u32(dst);
    for (int i = threadIdx.x; i < W_FLOATS; i += THREADS) {
      const int co = i % CO_PAD;
      const int rest = i / CO_PAD;
      const int ci = ci0 + rest % CI;
      const int tap = rest / CI;
      const bool ok = ci < p.C_in && co < COUT;
      cp_async4(d + 4u * i, ok ? p.w + ((size_t)tap * p.C_in + ci) * COUT + co : p.w, ok);
    }
  }

  // acc[i] += x row (tr + dh) * w[dt = 2 - i][dh] for each output i the
  // frame feeds (a branch uniform across the block)
  __device__ void compute(const Problem& p, const RunStage& r, const float* st) {
    const bool on[3] = {r.feeds(r.f - 1), r.feeds(r.f), r.feeds(r.f + 1)};
    // the weights of the stage's channels and the distance between taps
    const float* ws = RES ? wres + r.chunk * CI * CO_PAD : st + X_FLOATS;
    const int tap_stride = RES ? p.nchunk * CI * CO_PAD : CI * CO_PAD;
    const int c0 = tc * PX;
#pragma unroll
    for (int dh = 0; dh < 3; ++dh)
#pragma unroll
      for (int q = 0; q < NQ; ++q) {
        const float* xrow = st + ((tr + dh) * NQ + q) * SLAB_POS * 4;
        float4 x4[PX + 2];
#pragma unroll
        for (int j = 0; j < PX + 2; ++j)
          x4[j] = *reinterpret_cast<const float4*>(xrow + pos(c0 + j) * 4);
#pragma unroll
        for (int i = 0; i < 3; ++i) {
          if (!on[i]) continue;
#pragma unroll
          for (int dw = 0; dw < 3; ++dw)
#pragma unroll
            for (int c = 0; c < 4; ++c) {
              const float* wr =
                  ws + (((2 - i) * 3 + dh) * 3 + dw) * tap_stride + (4 * q + c) * CO_PAD;
              float wv[CO_PAD];
              const float4 wa = *reinterpret_cast<const float4*>(wr);
              wv[0] = wa.x; wv[1] = wa.y; wv[2] = wa.z; wv[3] = wa.w;
              if constexpr (CO_PAD == 8) {
                const float4 wb = *reinterpret_cast<const float4*>(wr + 4);
                wv[4] = wb.x; wv[5] = wb.y; wv[6] = wb.z; wv[7] = wb.w;
              }
#pragma unroll
              for (int j = 0; j < PX; ++j) {
                const float xj = comp(x4[j + dw], c);
#pragma unroll
                for (int k = 0; k < COUT; ++k) acc[i][j][k] = fmaf(xj, wv[k], acc[i][j][k]);
              }
            }
        }
      }
  }

  // after a frame's last chunk: output f-1 is complete; the slots move
  // down one frame.  After a piece's last frame: output f too, if it is
  // the last frame of the volume.
  __device__ void after(const Problem& p, const RunStage& r) {
    if (r.chunk != p.nchunk - 1) return;
    const TilePos o = position(p, r);
    if (r.feeds(r.f - 1)) store(p, o, r.f - 1);
#pragma unroll
    for (int j = 0; j < PX; ++j)
#pragma unroll
      for (int k = 0; k < COUT; ++k) {
        acc[0][j][k] = acc[1][j][k];
        acc[1][j][k] = acc[2][j][k];
        acc[2][j][k] = 0.f;
      }
    if (r.f == r.f_hi(p)) {
      if (r.feeds(r.f)) store(p, o, r.f);
      zero();
    }
  }

  // acc[0] as output frame t
  __device__ void store(const Problem& p, const TilePos& o, int t) const {
    const int h = o.h0 + tr;
    if (h >= p.H) return;
    float bv[COUT];
#pragma unroll
    for (int k = 0; k < COUT; ++k) bv[k] = __ldg(p.bias + k);
    float* row = p.y + (((size_t)o.b * p.T + t) * p.H + h) * (size_t)p.W * COUT;
#pragma unroll
    for (int j = 0; j < PX; ++j) {
      const int ww = o.w0 + tc * PX + j;
      if (ww >= p.W) break;
#pragma unroll
      for (int k = 0; k < COUT; ++k)
        row[(size_t)ww * COUT + k] = lrelu(acc[0][j][k] + bv[k], p.slope);
    }
  }
};

// ---------------------------------------------------------------------------
// the stage loop: a ring of stages, one commit group and one barrier a stage
// ---------------------------------------------------------------------------

template <class K>
__device__ __forceinline__ void load_stage(const Problem& p, const typename K::StageT& s,
                                           float* dst) {
  const TilePos o = K::position(p, s);
  K::load_x(p, o, s, dst);
  K::load_w(p, o, s, dst + K::X_FLOATS);
}

template <class K>
__device__ __forceinline__ void run(const Problem& p, float* smem) {
  static_assert(K::STAGES >= 2, "a stage is overwritten only after the barrier that ends its use");
  using S = typename K::StageT;
  S cur = S::first(p);
  if (!cur.valid(p)) return;
  S ld = cur;
  float* res = smem + K::STAGES * K::STAGE_FLOATS;
  K::load_res(p, res);  // lands with the first stage
#pragma unroll 1
  for (int s = 0; s < K::STAGES - 1; ++s) {
    if (ld.valid(p)) {
      load_stage<K>(p, ld, smem + s * K::STAGE_FLOATS);
      ld.next(p);
    }
    cp_async_commit();
  }
  K k;
  k.init(res);
  k.zero();
#pragma unroll 1
  for (int i = 0; cur.valid(p); ++i) {
    // stage i has landed, and every thread is done with stage i - 1,
    // whose slot the copy below refills
    cp_async_wait<K::STAGES - 2>();
    __syncthreads();
    if (ld.valid(p)) {
      load_stage<K>(p, ld, smem + ((i + K::STAGES - 1) % K::STAGES) * K::STAGE_FLOATS);
      ld.next(p);
    }
    cp_async_commit();
    k.compute(p, cur, smem + (i % K::STAGES) * K::STAGE_FLOATS);
    k.after(p, cur);
    cur.next(p);
  }
}

__global__ void __launch_bounds__(Wide::THREADS, Wide::MIN_BLOCKS)
conv3d_lrelu_wide(const Problem p) {
  extern __shared__ __align__(16) float smem[];
  run<Wide>(p, smem);
}

template <int CIN>
__global__ void __launch_bounds__(NarrowIn<CIN>::THREADS, NarrowIn<CIN>::MIN_BLOCKS)
conv3d_lrelu_narrow_in(const Problem p) {
  extern __shared__ __align__(16) float smem[];
  run<NarrowIn<CIN>>(p, smem);
}

template <int COUT>
__global__ void __launch_bounds__(NarrowOut<COUT, false>::THREADS,
                                  NarrowOut<COUT, false>::MIN_BLOCKS)
conv3d_lrelu_narrow_out(const Problem p) {
  extern __shared__ __align__(16) float smem[];
  run<NarrowOut<COUT, false>>(p, smem);
}

// narrow_out with its weights resident
template <int COUT>
__global__ void __launch_bounds__(NarrowOut<COUT, true>::THREADS,
                                  NarrowOut<COUT, true>::MIN_BLOCKS)
conv3d_lrelu_narrow_out_res(const Problem p) {
  extern __shared__ __align__(16) float smem[];
  run<NarrowOut<COUT, true>>(p, smem);
}

// ---------------------------------------------------------------------------
// host side
// ---------------------------------------------------------------------------

enum Instance { WIDE = 0, NARROW_IN = 1, NARROW_OUT = 2 };

int instance_of(int C_in, int C_out) {
  return C_out <= 8 ? NARROW_OUT : C_in <= 4 ? NARROW_IN : WIDE;
}

template <class K>
struct Tag {
  using type = K;
};

// narrow_out keeps its weights resident where all 27 taps of every input
// channel take at most 27 KB (C_in <= 64 for C_out <= 4): then 3 blocks
// still fit an SM
template <int COUT>
bool resident_out(int C_in) {
  using K = NarrowOut<COUT, true>;
  return K::res_floats(C_in) <= 27 * 64 * 4;
}

template <int COUT, class F>
int narrow_out(int C_in, F&& f) {
  if (resident_out<COUT>(C_in))
    return f(Tag<NarrowOut<COUT, true>>{}, conv3d_lrelu_narrow_out_res<COUT>);
  return f(Tag<NarrowOut<COUT, false>>{}, conv3d_lrelu_narrow_out<COUT>);
}

// f(Tag<K>{}, kernel) for the instance's traits K and kernel; an instance
// that is not the one for (C_in, C_out) is refused
template <class F>
int dispatch(int instance, int C_in, int C_out, F&& f) {
  if (C_in < 1 || C_out < 1 || instance != instance_of(C_in, C_out))
    return (int)cudaErrorInvalidValue;
  if (instance == WIDE) return f(Tag<Wide>{}, conv3d_lrelu_wide);
  if (instance == NARROW_IN) switch (C_in) {
      case 1: return f(Tag<NarrowIn<1>>{}, conv3d_lrelu_narrow_in<1>);
      case 2: return f(Tag<NarrowIn<2>>{}, conv3d_lrelu_narrow_in<2>);
      case 3: return f(Tag<NarrowIn<3>>{}, conv3d_lrelu_narrow_in<3>);
      case 4: return f(Tag<NarrowIn<4>>{}, conv3d_lrelu_narrow_in<4>);
    }
  switch (C_out) {
    case 1: return narrow_out<1>(C_in, f);
    case 2: return narrow_out<2>(C_in, f);
    case 3: return narrow_out<3>(C_in, f);
    case 4: return narrow_out<4>(C_in, f);
    case 5: return narrow_out<5>(C_in, f);
    case 6: return narrow_out<6>(C_in, f);
    case 7: return narrow_out<7>(C_in, f);
    case 8: return narrow_out<8>(C_in, f);
  }
  return (int)cudaErrorInvalidValue;
}

template <class K>
size_t smem_bytes(int C_in) {
  return ((size_t)K::STAGES * K::STAGE_FLOATS + K::res_floats(C_in)) * sizeof(float);
}

bool aligned16(const void* p) { return ((uintptr_t)p & 15) == 0; }

}  // namespace

extern "C" {

// x: (B,T,H,W,C_in) f32, w: (3,3,3,C_in,C_out) f32 THWIO, bias: (C_out,)
// f32, y: (B,T,H,W,C_out) f32; all contiguous.  `instance` is the one for
// (C_in, C_out) (0 wide, 1 narrow_in, 2 narrow_out; conv3d.py
// k3_instance); `grid` persistent blocks walk the output tiles
// round-robin (conv3d.py k3_plan).  Returns the CUDA error code of the
// launch (0 on success).
int conv3d_lrelu_f32(const float* x, const float* w, const float* bias, float* y, int B,
                     int T, int H, int W, int C_in, int C_out, float slope, int instance,
                     int grid, void* stream) {
  return dispatch(instance, C_in, C_out, [&](auto tag, auto kernel) -> int {
    using K = typename decltype(tag)::type;
    Problem p;
    p.x = x;
    p.w = w;
    p.bias = bias;
    p.y = y;
    p.T = T;
    p.H = H;
    p.W = W;
    p.C_in = C_in;
    p.C_out = C_out;
    p.tiles_h = (H + K::TILE_H - 1) / K::TILE_H;
    p.tiles_w = (W + K::TILE_W - 1) / K::TILE_W;
    p.co_blocks = (C_out + K::CO_BLK - 1) / K::CO_BLK;
    p.nchunk = (C_in + K::CI - 1) / K::CI;
    const long long ntiles = (long long)B * T * p.tiles_h * p.tiles_w * p.co_blocks;
    if (B < 1 || T < 1 || H < 1 || W < 1 || grid < 1 || ntiles > INT_MAX)
      return (int)cudaErrorInvalidValue;
    // narrow_in keeps one block of output channels resident a block
    if (instance == NARROW_IN && grid % p.co_blocks != 0) return (int)cudaErrorInvalidValue;
    p.ntiles = (int)ntiles;
    p.vec_x = C_in % 4 == 0 && aligned16(x);
    p.vec_w = C_out % 4 == 0 && aligned16(w);
    p.vec_y = C_out % 4 == 0 && aligned16(y);
    p.slope = slope;
    const size_t smem = smem_bytes<K>(C_in);
    cudaError_t err =
        cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
    kernel<<<grid, K::THREADS, smem, (cudaStream_t)stream>>>(p);
    return (int)cudaGetLastError();
  });
}

// The launch configuration of (instance, C_in, C_out) on the current
// device, for the launch plan and reports: out[0..8] = threads, dynamic
// shared memory bytes, blocks an SM (the occupancy API), tile rows, tile
// columns, output channels a tile, input channels a stage, ring stages,
// bytes of weights resident for a block's life.
// Returns the CUDA error code.
int conv3d_lrelu_f32_config(int instance, int C_in, int C_out, int* out) {
  return dispatch(instance, C_in, C_out, [&](auto tag, auto kernel) -> int {
    using K = typename decltype(tag)::type;
    const size_t smem = smem_bytes<K>(C_in);
    cudaError_t err =
        cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
    int blocks = 0;
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, kernel, K::THREADS, smem);
    if (err != cudaSuccess) return (int)err;
    out[0] = K::THREADS;
    out[1] = (int)smem;
    out[2] = blocks;
    out[3] = K::TILE_H;
    out[4] = K::TILE_W;
    out[5] = K::CO_BLK;
    out[6] = K::CI;
    out[7] = K::STAGES;
    out[8] = K::res_floats(C_in) * (int)sizeof(float);
    return 0;
  });
}

}  // extern "C"
