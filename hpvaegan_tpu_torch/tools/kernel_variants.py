"""Time variants of a kernel's source against each other on the card.

    python -m hpvaegan_tpu_torch.tools.kernel_variants k2-parts [...]

Each variant is the source in ``csrc/`` with some text replaced, built by
nvcc with the package's flags into ``build/kernels/variants/``, loaded
with ctypes and called directly at the critic's shape (4,13,144,256,64)
(K1-fwd: the top stage's, (2,13,144,256,64)): all variants in one
process, in turns, two rounds, CUDA events around 5 (K2 f32), 10 (K2
bf16) or 20 (K1) launches after 2 warm-up ones.  Each line gives the
round, the variant, its max |result - plain version| on a small ragged
shape and its ms.  Variants marked "(wrong)" cut work out to see what a
part of the kernel costs; their results are not meant to agree.

Experiments:

* ``k2-unroll``: K2 f32's channel loop fully unrolled (the source), by 8,
  4 or 2;
* ``k2-parts``: K2 f32 with conv1's or conv2's FMA loop, the x slab
  staging, or the per-stage barriers cut out (wrong);
* ``k2-loads``: K2 f32 with each thread's weight or activation loads made
  one broadcast address (wrong): is shared memory the limit?
* ``dw-ring``: K1-dw bf16 with 4, 5 (the source) or 6 ring stages;
* ``k1-parts``: K1-fwd bf16 with the weight loads, the x loads, the
  wgmmas or the stores cut out (wrong);
* ``k1-ring``: K1-fwd bf16 with 4 (the source), 3 or 2 weight stages
  beside its 2 x slabs;
* ``k1-a``: K1-fwd bf16 with A straight from the TMA buffer by a K-major
  descriptor (the source), the same with the start's row inside its
  swizzle atom in the descriptor's base-offset field (wrong: the tensor
  cores swizzle the address bits themselves), or A from registers by
  ldmatrix;
* ``k2b-parts``: K2 bf16 with the weight loads, the x loads, the wgmmas
  or the y stores cut out (wrong);
* ``k2b-store``: K2 bf16 with each y frame stored right after its conv2
  (the source) or held in registers, packed, and stored while the next
  conv1's first products run;
* ``k2b-ring``: K2 bf16 with 3 (the source) or 2 weight stages;
* ``k2b-warps``: K2 bf16 with 2 (the source) or 3 consumer warpgroups
  sharing the m64 tiles (conv1 2 + 2 or 2 + 1 + 1, conv2 2 + 1 or
  1 + 1 + 1);
* ``k3-parts``: K3 (all three instances: timed at 64 -> 64, 3 -> 64 and
  64 -> 3 at the top stage's (2,13,144,256)) with the x copies, the weight
  copies, the FMAs or the stores cut out (wrong);
* ``k3-ring``: K3 with each instance's ring one stage deeper than the
  source's (wide 2 -> 3, narrow_in 2 -> 3, narrow_out 2 -> 3);
* ``k3-in-blocks``: K3 narrow_in compiled for 2 (the source), 3 or 4
  blocks an SM (``__launch_bounds__``: 255, 168 or 128 registers), timed
  at 3 -> 64;
* ``k3-out-chunk``: K3 narrow_out with stages of 8 (the source), 4, 16
  or 32 input channels, timed at 64 -> 3;
* ``k3-out-occupancy``: K3 narrow_out with 4 output columns a thread
  (a 64 x 8 tile) compiled for 3 (the source), 2 or 4 blocks an SM, or
  with 8 columns (a 64 x 16 tile at C_out <= 4) at 2, timed at 64 -> 3;
* ``k3-copies``: K3 narrow_in's x copies as in the source (a thread
  keeps a slab column and walks its rows) or with each copy's indices
  recomputed by division, timed at 3 -> 64;
* ``k3-out-weights``: K3 narrow_out with its weights resident where they
  fit (the source) or carried by every stage, timed at 64 -> 3;
* ``k3-out-l2``: K3 narrow_out's 16-byte x copies with no L2 prefetch
  size (the source), ``.L2::128B`` or ``.L2::256B``, timed at 64 -> 3.
"""
from __future__ import annotations

import argparse
import ctypes
import subprocess
import sys
from typing import Dict, List, Tuple

import torch

from ..ops.kernels import _build
from ..ops.kernels import conv3d as k3
from ..ops.kernels import conv3d_fuse as cf
from ..ops.kernels import conv3d_pack as cp

__all__ = ["EXPERIMENTS", "variant_sources"]

Edit = Tuple[str, str]

_K2_C1 = ("      if (conv1_on)\n        stage_fma<PX1, CO1, F_XSTRIDE>(",
          "      if (conv1_on && T < 0)\n        stage_fma<PX1, CO1, F_XSTRIDE>(")
_K2_C2 = ("      stage_fma<PX2, CO2, F_ZSTRIDE>(",
          "      if (T < 0) stage_fma<PX2, CO2, F_ZSTRIDE>(")
_K2_LOOP = "#pragma unroll\n  for (int ci = 0; ci < F_QCI; ++ci) {"
_DW_RING = "constexpr int BW_STAGES = 5;"

_K1_W = ("mbar_arrive_tx(w_full(s), HK_W_BYTES);",
         "mbar_arrive_tx(w_full(s), 0);")
_K1_W2 = ("for (int dh = 0; dh < 3; ++dh)\n              tma_load_2d(",
          "for (int dh = 0; dh < 3 * (T < 0); ++dh)\n              tma_load_2d(")
_K1_X = ("mbar_arrive_tx(x_full(xs), HK_X_LOAD);\n        tma_load_5d(",
         "mbar_arrive_tx(x_full(xs), 0);\n        if (T < 0) tma_load_5d(")
_K1_RING = ("constexpr int HK_X_STAGES = 2;", "constexpr int HK_W_STAGES = 4;")
_K1_A_DESC = """            wgmma_fence();
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
                                                  (q * HK_KSTEPS + kk) * 32)),"""
# A from registers: ldmatrix rows (mma.sync's A fragment) from the slab;
# the registers are rewritten only after the previous stage's products
_K1_A_REGS = """            wgmma_wait<0>();
            uint32_t a[HK_KSTEPS][HK_ROWS + 2][4];
#pragma unroll
            for (int kk = 0; kk < HK_KSTEPS; ++kk)
#pragma unroll
              for (int j = 0; j < HK_ROWS + 2; ++j)
                ldsm_x4(a[kk][j], xrow0 + swz(16 * wi + (lane & 15) + j * HK_SLAB_W + dw,
                                              (q * HK_KSTEPS + kk) * 2 + (lane >> 4)));
            wgmma_fence();
#pragma unroll
            for (int kk = 0; kk < HK_KSTEPS; ++kk)
#pragma unroll
              for (int j = 0; j < HK_ROWS + 2; ++j)
#pragma unroll
                for (int dh = 0; dh < 3; ++dh) {
                  const int o = j - dh;
                  if (o >= 0 && o < HK_ROWS)
                    wgmma_64x64(acc[o], a[kk][j],"""
# the descriptor with the start's row inside its swizzle atom in the
# base-offset field
_K1_A_BO = ("k_desc(xrow0 + (uint32_t)((j * HK_SLAB_W + dw) * ROW_BYTES +\n"
            "                                                  (q * HK_KSTEPS + kk) * 32)),",
            "k_desc_bo(xrow0 + (uint32_t)((j * HK_SLAB_W + dw) * ROW_BYTES +\n"
            "                                                  (q * HK_KSTEPS + kk) * 32)),")
_K1_BO_HELPER = """
__device__ __forceinline__ uint64_t k_desc_bo(uint32_t addr) {
  return k_desc(addr) | ((uint64_t)((addr >> 7) & 7) << 49);
}

// the output tile `tile` of the persistent walk"""
_K1_TILE = "\n// the output tile `tile` of the persistent walk"

_K2B_W = ("hopper::mbar_arrive_tx(r.w_full(s), PB_W_BYTES);",
          "hopper::mbar_arrive_tx(r.w_full(s), 0);")
_K2B_W2 = ("for (int dh = 0; dh < 3; ++dh)\n            hopper::tma_load_2d(",
           "for (int dh = 0; dh < 3 * (T < 0); ++dh)\n"
           "            hopper::tma_load_2d(")
_K2B_X = ("hopper::mbar_arrive_tx(r.x_full(xs), PB_X_LOAD);\n"
          "          hopper::tma_load_5d(",
          "hopper::mbar_arrive_tx(r.x_full(xs), 0);\n"
          "          if (T < 0) hopper::tma_load_5d(")

_K2B_MMA = ("        hopper::wgmma_64x64_ss(\n            d[m],",
            "        if (m0 < 0) hopper::wgmma_64x64_ss(\n            d[m],")

# y[t] packed after conv2 and stored by the next conv1 once its first
# stage's products are issued (the last frame of a column: by the next
# column's, or at the end)
_K2B_DEFER = [
    ("""                                          int f, int T, int m0) {
#pragma unroll
  for (int m = 0; m < NT; ++m)
#pragma unroll
    for (int i = 0; i < 32; ++i) d[m][i] = 0.f;
""", """                                          int f, int T, int m0, Fn&& after_first) {
#pragma unroll
  for (int m = 0; m < NT; ++m)
#pragma unroll
    for (int i = 0; i < 32; ++i) d[m][i] = 0.f;
  bool first = true;
"""),
    ("template <int NT>\n__device__ __forceinline__ void pair_conv(",
     "template <int NT, class Fn>\n__device__ __forceinline__ void pair_conv("),
    ("""        pair_stage<NT>(d, src, m0, dw, q, r.wring + (uint32_t)s * PB_W_BYTES);
""", """        pair_stage<NT>(d, src, m0, dw, q, r.wring + (uint32_t)s * PB_W_BYTES);
        if (first) {
          after_first();
          first = false;
        }
"""),
    ("""  int b, h0, w0;
  __device__ PairColumn(""", """  int b = 0, h0 = 0, w0 = 0;
  PairColumn() = default;
  __device__ PairColumn("""),
    ("""// The consumer warpgroup's walk over its columns""", """template <int NT>
struct PendingY {
  float d[NT][32];
  int t = -1;
  PairColumn cl;
  __device__ void store(const PairRings& r, int m0, int T, int H, int W,
                        const float (&b2v)[16], float slope,
                        __nv_bfloat16* __restrict__ y, __nv_bfloat16* __restrict__ mid) {
    if (t < 0) return;
    pair_store_y<NT>(d, r, t, m0, cl, T, H, W, b2v, slope, y, mid);
    t = -1;
  }
};

// The consumer warpgroup's walk over its columns"""),
    ("""  for (int col = blockIdx.x; col < ncols; col += gridDim.x) {
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
}""", """  PendingY<NT2> yp;
  auto store_y = [&]() { yp.store(r, m2, T, H, W, b2v, slope, y, mid); };
  for (int col = blockIdx.x; col < ncols; col += gridDim.x) {
    const PairColumn cl(col, tiles_h, tiles_w);
    for (int s = -1; s < T; ++s) {
      if (s + 1 < T) {
        float d[NT1][32];
        pair_conv<NT1>(d, r, true, s + 1, T, m1, store_y);
        consumers_sync();  // every warp is done reading z[s - 2]'s slot
        pair_store_z<NT1>(d, r, s + 1, m1, cl, H, W, b1v, slope);
      } else {
        store_y();
      }
      consumers_sync();    // z[s + 1] is in its slot
      if (s < 0) continue;
      pair_conv<NT2>(yp.d, r, false, s, T, m2, [] {});
      yp.t = s;
      yp.cl = cl;
    }
  }
  store_y();
}"""),
]

_K3_STORES = [
    ("    if (h >= p.H) return;\n    const int coa",
     "    if (h >= p.H || p.T > 0) return;\n    const int coa"),
    ("    if (h >= p.H) return;\n    float bv[COUT];",
     "    if (h >= p.H || p.T > 0) return;\n    float bv[COUT];")]
_K3_WIDE_RING = "  static constexpr int STAGES = 2;  // wide ring"
_K3_IN_RING = "  static constexpr int STAGES = 2;  // narrow_in ring"
_K3_OUT_RING = "  static constexpr int STAGES = 2;   // narrow_out ring"
_K3_IN_BLOCKS = "  static constexpr int MIN_BLOCKS = 2;  // narrow_in blocks an SM"
_K3_OUT_PX = "  static constexpr int PX = 4;  // output columns a thread"
_K3_OUT_BLOCKS = "  static constexpr int MIN_BLOCKS = 3;  // narrow_out blocks an SM"
_K3_X_COPY = ('  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\\n"\n'
              '               :\n               : "r"(dst), "l"(src), "r"(valid ? 16 : 0)')
_K3_OUT_NQ = "  static constexpr int NQ = 2;       // float4 planes of a stage"

_K3_IN_COPY_NEW = """\
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
    }"""
_K3_IN_COPY_OLD = """\
    for (int i = threadIdx.x; i < 3 * SLAB_PIX * CIN; i += THREADS) {
      const int dt = i / (SLAB_PIX * CIN);
      const int rest = i % (SLAB_PIX * CIN);
      const int pix = rest / CIN, ci = rest % CIN;
      const int tt = o.t + dt - 1;
      const int hh = o.h0 - 1 + pix / SLAB_W, ww = o.w0 - 1 + pix % SLAB_W;
      const bool ok = tt >= 0 && tt < p.T && hh >= 0 && hh < p.H && ww >= 0 && ww < p.W;
      cp_async4(d + 4u * ((dt * CIN + ci) * SLAB_PIX + pix),
                ok ? xb + (((size_t)tt * p.H + hh) * p.W + ww) * CIN + ci : p.x, ok);
    }"""
# narrow_in's x copy loop with every copy's indices recomputed by
# division (a thread per 4-byte piece of the slab)
_K3_FLAT = [(_K3_IN_COPY_NEW, _K3_IN_COPY_OLD)]

# experiment -> (source name, {variant: edits})
EXPERIMENTS: Dict[str, Tuple[str, Dict[str, List[Edit]]]] = {
    "k2-unroll": ("conv3d_fuse", {
        "full": [],
        **{f"by {n}": [(_K2_LOOP, _K2_LOOP.replace(
            "#pragma unroll", f"#pragma unroll {n}"))] for n in (8, 4, 2)},
    }),
    "k2-parts": ("conv3d_fuse", {
        "full": [],
        "no conv1 FMA (wrong)": [_K2_C1],
        "no conv2 FMA (wrong)": [_K2_C2],
        "no FMA (wrong)": [_K2_C1, _K2_C2],
        "no x staging (wrong)": [(
            "        stage_x(x, g, slice, xs);",
            "        if (T < 0) stage_x(x, g, slice, xs);")],
        "barriers only at layers and x slices (wrong)": [(
            "    bf16_mma::cp_async_wait<0>();\n    __syncthreads();",
            "    bf16_mma::cp_async_wait<0>();\n"
            "    if (cur.first_of_layer() || (cur.dh == 0 && cur.q == 0))"
            " __syncthreads();")],
    }),
    "k2-loads": ("conv3d_fuse", {
        "full": [],
        "conv1 weights broadcast (wrong)": [("wst, cg1,", "wst, 0,")],
        "conv2 weights broadcast (wrong)": [("wst, cg2,", "wst, 0,")],
        "conv1 x broadcast (wrong)": [(
            "xs + cur.q * F_QCI * F_XSTRIDE + (r1 + cur.dh) * F_XW + c1,",
            "xs + cur.q * F_QCI * F_XSTRIDE,")],
        "conv2 z broadcast (wrong)": [(
            "zslot + cur.q * F_QCI * F_ZSTRIDE + (r2 + cur.dh) * F_ZW + c2,",
            "zslot + cur.q * F_QCI * F_ZSTRIDE,")],
    }),
    "dw-ring": ("conv3d_dw", {
        f"{n} stages": ([] if n == 5 else
                        [(_DW_RING, _DW_RING.replace("5", str(n)))])
        for n in (4, 5, 6)}),
    "k1-parts": ("conv3d_pack", {
        "full": [],
        "no weight loads (wrong)": [_K1_W, _K1_W2],
        "no x loads (wrong)": [_K1_X],
        "no wgmma (wrong)": [("if (o >= 0 && o < HK_ROWS)",
                              "if (o >= 0 && o < HK_ROWS && T < 0)")],
        "no stores (wrong)": [("if (h >= H) break;",
                               "if (h >= H || T > 0) break;")],
    }),
    "k1-ring": ("conv3d_pack", {
        "2 x slabs, 4 weight stages": [],
        "2 x slabs, 2 weight stages": [(_K1_RING[1], _K1_RING[1].replace(
            "4", "2"))],
        "2 x slabs, 3 weight stages": [(_K1_RING[1], _K1_RING[1].replace(
            "4", "3"))],
    }),
    "k1-a": ("conv3d_pack", {
        "A by descriptor": [],
        "A by descriptor with a base offset (wrong)": [
            _K1_A_BO, (_K1_TILE, _K1_BO_HELPER)],
        "A from registers": [(_K1_A_DESC, _K1_A_REGS)],
    }),
    "k2b-parts": ("conv3d_fuse", {
        "full": [],
        "no weight loads (wrong)": [_K2B_W, _K2B_W2],
        "no x loads (wrong)": [_K2B_X],
        "no wgmma (wrong)": [_K2B_MMA],
        "no y stores (wrong)": [(
            "hopper::store_pixel_bf16(valid ? y + at : nullptr, pk, lane);",
            "hopper::store_pixel_bf16(nullptr, pk, lane);")],
    }),
    "k2b-store": ("conv3d_fuse", {
        "y stored right after conv2": [],
        "y stored behind the next conv1's first products": _K2B_DEFER,
    }),
    "k2b-ring": ("conv3d_fuse", {
        "3 weight stages": [],
        "2 weight stages": [("constexpr int PB_W_STAGES = 3;",
                             "constexpr int PB_W_STAGES = 2;")],
    }),
    "k3-parts": ("conv3d_lrelu", {
        "full": [],
        "no x copies (wrong)": [("  K::load_x(p, o, s, dst);",
                                 "  if (p.T < 0) K::load_x(p, o, s, dst);")],
        "no weight copies (wrong)": [
            ("  K::load_w(p, o, s, dst + K::X_FLOATS);",
             "  if (p.T < 0) K::load_w(p, o, s, dst + K::X_FLOATS);"),
            ("  K::load_res(p, res);", "  if (p.T < 0) K::load_res(p, res);")],
        "no FMAs (wrong)": [("    k.compute(p, cur, smem",
                             "    if (p.T < 0) k.compute(p, cur, smem")],
        "no stores (wrong)": _K3_STORES,
    }),
    "k3-ring": ("conv3d_lrelu", {
        "the source's rings": [],
        "wide 3 stages": [(_K3_WIDE_RING, _K3_WIDE_RING.replace("2", "3"))],
        "narrow_in 3 stages": [(_K3_IN_RING, _K3_IN_RING.replace("2", "3"))],
        "narrow_out 3 stages": [(_K3_OUT_RING,
                                 _K3_OUT_RING.replace("2", "3"))],
    }),
    "k3-in-blocks": ("conv3d_lrelu", {
        f"{n} blocks an SM": ([] if n == 2 else [(
            _K3_IN_BLOCKS, _K3_IN_BLOCKS.replace("2", str(n)))])
        for n in (2, 3, 4)}),
    "k3-out-chunk": ("conv3d_lrelu", {
        f"{4 * n} input channels a stage": ([] if n == 2 else [(
            _K3_OUT_NQ, _K3_OUT_NQ.replace("2", str(n)))])
        for n in (2, 1, 4, 8)}),
    "k3-out-occupancy": ("conv3d_lrelu", {
        "4 columns a thread, 3 blocks an SM": [],
        **{f"4 columns, {n} blocks an SM": [
            (_K3_OUT_BLOCKS, _K3_OUT_BLOCKS.replace("3", str(n)))]
           for n in (2, 4)},
        "8 columns (C_out <= 4), 2 blocks an SM": [
            (_K3_OUT_PX, _K3_OUT_PX.replace("4;", "COUT <= 4 ? 8 : 4;")),
            (_K3_OUT_BLOCKS, _K3_OUT_BLOCKS.replace("3", "2"))],
    }),
    "k3-copies": ("conv3d_lrelu", {
        "copies walking slab columns and weight rows": [],
        "one copy an iteration, indices by division": _K3_FLAT,
    }),
    "k3-out-weights": ("conv3d_lrelu", {
        "weights resident where they fit": [],
        "weights in every stage": [(
            "  return K::res_floats(C_in) <= 27 * 64 * 4;",
            "  return C_in < 0;")],
    }),
    "k3-out-l2": ("conv3d_lrelu", {
        "no L2 prefetch size": [],
        **{f"L2::{n}B": [(_K3_X_COPY, _K3_X_COPY.replace(
            "cp.async.cg.shared.global", f"cp.async.cg.shared.global.L2::{n}B"))]
           for n in (128, 256)},
    }),
    "k2b-warps": ("conv3d_fuse", {
        "2 consumer warpgroups": [],
        "3 consumer warpgroups": [
            ("constexpr int PB_CONSUMERS = 2;", "constexpr int PB_CONSUMERS = 3;"),
            ("constexpr int PB_CONSUMER_REGS = 232;",
             "constexpr int PB_CONSUMER_REGS = 152;")],
    }),
}

SHAPE = (4, 13, 144, 256, 64)        # the critic's
K1_SHAPE = (2, 13, 144, 256, 64)     # the top stage's
CHECK_SHAPE = (1, 2, 9, 130, 64)     # ragged in every tile of both kernels


def variant_sources(experiment: str) -> Tuple[str, Dict[str, str]]:
    """(source name, {variant: source text}); raises if an edit does not
    match the source exactly once."""
    name, variants = EXPERIMENTS[experiment]
    base = (_build.CSRC_DIR / f"{name}.cu").read_text()
    out = {}
    for variant, edits in variants.items():
        text = base
        for old, new in edits:
            if text.count(old) != 1:
                raise ValueError(f"{experiment}/{variant}: the edit does not "
                                 f"match {name}.cu exactly once: {old!r}")
            text = text.replace(old, new)
        out[variant] = text
    return name, out


def _build_variants(experiment: str) -> Dict[str, ctypes.CDLL]:
    name, sources = variant_sources(experiment)
    out_dir = _build.BUILD_DIR / "variants" / experiment
    out_dir.mkdir(parents=True, exist_ok=True)
    procs = {}
    for i, (variant, text) in enumerate(sources.items()):
        src = out_dir / f"{name}_{i}.cu"
        src.write_text(text)
        procs[variant] = (subprocess.Popen(
            [_build._nvcc(), *_build.NVCC_FLAGS, "-I", str(_build.CSRC_DIR),
             "-o", str(out_dir / f"{name}_{i}.so"), str(src)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True),
            out_dir / f"{name}_{i}.so")
    libs = {}
    try:
        for variant, (proc, lib) in procs.items():
            log, _ = proc.communicate(timeout=_build.NVCC_TIMEOUT_S)
            if proc.returncode != 0:
                raise RuntimeError(
                    f"nvcc failed on {experiment}/{variant}:\n{log}")
            libs[variant] = ctypes.CDLL(str(lib))
    finally:  # stop the builds still running when one failed
        for proc, _ in procs.values():
            if proc.poll() is None:
                proc.kill()
                proc.communicate()
    return libs


def _k2_runner(lib: ctypes.CDLL, shape, dev, g):
    fn = lib.conv3d64_pair_f32
    fn.argtypes = [ctypes.c_void_p] * 7 + [ctypes.c_int] * 4 + [
        ctypes.c_float, ctypes.c_void_p]
    scale = (27 * 64) ** -0.5
    x = torch.randn(shape, device=dev, generator=g)
    w1, w2 = ((torch.rand((3, 3, 3, 64, 64), device=dev, generator=g) * 2
               - 1) * scale for _ in range(2))
    b1, b2 = ((torch.rand(64, device=dev, generator=g) * 2 - 1) * scale
              for _ in range(2))
    y = torch.empty_like(x)

    def run():
        err = fn(x.data_ptr(), w1.data_ptr(), b1.data_ptr(), w2.data_ptr(),
                 b2.data_ptr(), y.data_ptr(), None, *shape[:4], cf.SLOPE,
                 torch.cuda.current_stream().cuda_stream)
        cp._raise_on(err, "variant")
        return y
    return run, lambda: cf.conv3d64_pair_plain(x, w1, b1, w2, b2)


def _dw_runner(lib: ctypes.CDLL, shape, dev, g):
    fn = lib.conv3d64_dw_bf16
    fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 5 + [
        ctypes.c_void_p]
    x, dy = (torch.randn(shape, device=dev, generator=g).to(torch.bfloat16)
             for _ in range(2))
    cfg = cp.dw_kernel_config(torch.bfloat16)
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    plan = cp.dw_plan(sms, cfg["blocks_per_sm"], cfg["blocks_per_chunk"],
                      cfg["tile_w"], shape[:4])
    partial = torch.empty(plan.scratch_floats, device=dev)
    dw = torch.empty((3, 3, 3, 64, 64), device=dev)

    def run():
        err = fn(x.data_ptr(), dy.data_ptr(), partial.data_ptr(),
                 dw.data_ptr(), *shape[:4], plan.nchunk,
                 torch.cuda.current_stream().cuda_stream)
        cp._raise_on(err, "variant")
        return dw
    return run, lambda: cp.conv3d64_dw_plain(x, dy)


def _grid(lib: ctypes.CDLL, config: str, shape, dev) -> int:
    """The persistent grid of a variant, from its own launch report."""
    cfg = getattr(lib, config)
    cfg.argtypes = [ctypes.POINTER(ctypes.c_int)] * 5
    vals = [ctypes.c_int() for _ in range(5)]
    cp._raise_on(cfg(*(ctypes.byref(v) for v in vals)), "variant config")
    _, _, per_sm, tile_h, tile_w = (v.value for v in vals)
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    return cp.fwd_plan(sms, per_sm, tile_h, tile_w, shape).grid


def _k1_runner(lib: ctypes.CDLL, shape, dev, g):
    fn = lib.conv3d64_fwd_bf16
    fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 5 + [
        ctypes.c_float, ctypes.c_int, ctypes.c_void_p]
    scale = (27 * 64) ** -0.5
    x = torch.randn(shape, device=dev, generator=g).to(torch.bfloat16)
    w = ((torch.rand((3, 3, 3, 64, 64), device=dev, generator=g) * 2 - 1)
         * scale)
    b = (torch.rand(64, device=dev, generator=g) * 2 - 1) * scale
    wb, bb = w.to(torch.bfloat16), b.to(torch.bfloat16)
    y = torch.empty_like(x)
    grid = _grid(lib, "conv3d64_fwd_bf16_config", shape[:4], dev)

    def run():
        err = fn(x.data_ptr(), wb.data_ptr(), bb.data_ptr(), y.data_ptr(),
                 *shape[:4], 1, 0.2, grid,
                 torch.cuda.current_stream().cuda_stream)
        cp._raise_on(err, "variant")
        return y
    return run, lambda: cp.conv3d64_plain(x, w, b, neg_slope=0.2)


def _k2b_runner(lib: ctypes.CDLL, shape, dev, g):
    fn = lib.conv3d64_pair_bf16
    fn.argtypes = [ctypes.c_void_p] * 7 + [ctypes.c_int] * 4 + [
        ctypes.c_float, ctypes.c_int, ctypes.c_void_p]
    scale = (27 * 64) ** -0.5
    x = torch.randn(shape, device=dev, generator=g).to(torch.bfloat16)
    w1, w2 = ((torch.rand((3, 3, 3, 64, 64), device=dev, generator=g) * 2
               - 1) * scale for _ in range(2))
    b1, b2 = ((torch.rand(64, device=dev, generator=g) * 2 - 1) * scale
              for _ in range(2))
    bf = [t.to(torch.bfloat16) for t in (w1, b1, w2, b2)]
    y = torch.empty_like(x)
    grid = _grid(lib, "conv3d64_pair_bf16_config", (shape[0], 1, *shape[2:4]),
                 dev)

    def run():
        err = fn(x.data_ptr(), *(t.data_ptr() for t in bf), y.data_ptr(),
                 None, *shape[:4], cf.SLOPE, grid,
                 torch.cuda.current_stream().cuda_stream)
        cp._raise_on(err, "variant")
        return y
    return run, lambda: cf.conv3d64_pair_plain(x, w1, b1, w2, b2)


def _k3_runner(c_out: int):
    """K3 with ``c_out`` output channels (C_in from the shape), launched
    with the grid the variant's own report gives."""
    def make(lib: ctypes.CDLL, shape, dev, g):
        fn = lib.conv3d_lrelu_f32
        fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 6 + [
            ctypes.c_float, ctypes.c_int, ctypes.c_int, ctypes.c_void_p]
        cfg_fn = lib.conv3d_lrelu_f32_config
        cfg_fn.argtypes = [ctypes.c_int] * 3 + [ctypes.POINTER(ctypes.c_int)]
        c_in = shape[-1]
        instance = k3.INSTANCES.index(k3.k3_instance(c_in, c_out))
        vals = (ctypes.c_int * len(k3._CONFIG))()
        cp._raise_on(cfg_fn(instance, c_in, c_out, vals), "variant config")
        cfg = dict(zip(k3._CONFIG, vals))
        sms = torch.cuda.get_device_properties(dev).multi_processor_count
        grid = k3.k3_plan(shape, c_out, sms, cfg).grid
        print(f"  {shape} -> {c_out}: launch config {cfg}, grid {grid}",
              flush=True)
        scale = (27 * c_in) ** -0.5
        x = torch.randn(shape, device=dev, generator=g)
        w = (torch.rand((3, 3, 3, c_in, c_out), device=dev, generator=g) * 2
             - 1) * scale
        b = (torch.rand(c_out, device=dev, generator=g) * 2 - 1) * scale
        y = torch.empty((*shape[:4], c_out), device=dev)

        def run():
            err = fn(x.data_ptr(), w.data_ptr(), b.data_ptr(), y.data_ptr(),
                     *shape, c_out, k3.NEG_SLOPE, instance, grid,
                     torch.cuda.current_stream().cuda_stream)
            cp._raise_on(err, "variant")
            return y
        return run, lambda: k3.conv3d_lrelu_plain(x, w, b)
    return make


# K3's instances at the top stage's shape: (C_in, C_out) per experiment
K3_FULL = {"wide": (64, 64), "narrow_in": (3, 64), "narrow_out": (64, 3)}
K3_TIMED = {"k3-in-blocks": ("narrow_in",), "k3-out-chunk": ("narrow_out",),
            "k3-out-l2": ("narrow_out",), "k3-out-occupancy": ("narrow_out",),
            "k3-copies": ("narrow_in",), "k3-out-weights": ("narrow_out",)}


def _runners(experiment: str):
    """[(make, shape it is timed at, check shape, launches timed)] of an
    experiment."""
    if experiment.startswith("k3-"):
        out = []
        for inst in K3_TIMED.get(experiment, tuple(K3_FULL)):
            c_in, c_out = K3_FULL[inst]
            out.append((_k3_runner(c_out), (*K1_SHAPE[:4], c_in),
                        (1, 3, 19, 70, c_in), 20))
        return out
    if experiment.startswith("dw-"):
        return [(_dw_runner, SHAPE, CHECK_SHAPE, 20)]
    if experiment.startswith("k1-"):
        return [(_k1_runner, K1_SHAPE, CHECK_SHAPE, 20)]
    if experiment.startswith("k2b-"):
        return [(_k2b_runner, SHAPE, CHECK_SHAPE, 10)]
    return [(_k2_runner, SHAPE, CHECK_SHAPE, 5)]


def run_experiment(experiment: str) -> None:
    dev = torch.device("cuda", 0)
    libs = _build_variants(experiment)
    g = torch.Generator(device=dev).manual_seed(0)
    for make, shape, check_shape, iters in _runners(experiment):
        errs, runs = {}, {}
        for variant, lib in libs.items():
            run, plain = make(lib, check_shape, dev, g)
            errs[variant] = float((run().float() - plain().float())
                                  .abs().max())
            runs[variant] = make(lib, shape, dev, g)[0]
        for rnd in range(2):
            for variant, run in runs.items():
                for _ in range(2):
                    run()
                torch.cuda.synchronize()
                e0 = torch.cuda.Event(enable_timing=True)
                e1 = torch.cuda.Event(enable_timing=True)
                e0.record()
                for _ in range(iters):
                    run()
                e1.record()
                e1.synchronize()
                print(f"{experiment} round {rnd} {variant}: max_abs_err "
                      f"{errs[variant]:.3e}, "
                      f"{e0.elapsed_time(e1) / iters:.4f} ms at {shape}",
                      flush=True)
        del runs


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("experiments", nargs="+", choices=sorted(EXPERIMENTS))
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        sys.exit("kernel_variants needs a CUDA card")
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip(), flush=True)
    for experiment in args.experiments:
        run_experiment(experiment)


if __name__ == "__main__":
    main()
