// The tiles of the fused V-cycle legs: K_down and K_up on one device
// (csrc/mg_fused.cu: A5, A6 and their custom-mask forms C2, C3) and their
// mesh-block forms D3 and D4 (csrc/mg_sharded.cu) run the two bodies
// below, k_down_body and k_up_body, instantiated with kBlock false
// (k_down_kernel, k_up_kernel) or true (k_down_block_kernel,
// k_up_block_kernel).
//
// What bounds them on an H100: memory, with no tensor-core work. K_down
// reads b (4 B/node) and writes the coarse field (1 B per fine node): 5
// B/node, plus 1.25 for the fine and child int8 masks on a custom level.
// K_up reads b and the coarse correction (4 + 1) and writes the iterate
// (4): 9 B/node, plus 1 for the mask. On a mesh block the coarse fields
// are row-coarse only (the lane transfers run between the legs): D3 writes
// 2 B/node (6 in all), D4 reads 2 (10 in all).
//
// The design: a block owns a tile (K_down: TJ coarse rows x 128 fine
// columns; K_up: 2 TJ fine rows x 128 fine columns) and stages its inputs
// with a one-node halo into shared memory once, in 16-byte pieces (wp %
// 128 == 0): K_down through registers, masking on the way in; K_up by
// cp.async (raw b, and the coarse correction), which holds no registers
// while the bytes are in flight. Each residual (K_down) or corrected
// iterate (K_up) is computed once per node into shared memory, and its
// stencil and transfer partners are read from there; a thread walks one
// fine column down the tile, carrying the rows it shares with the next
// node in registers, and the halo columns are spread over the threads.
// The interior test is one column span per row (interior_span), or the
// staged int8 tile on a custom level. The tile height TJ is picked per
// level (kernels/mg_fused.tile_rows: K_down 16, 8 or 4, only 4 on a custom
// level; K_up 8 or 4) so that the small levels still put two blocks on
// every SM.
//
// On one device the legs also do the lane (column) half of each grid
// transfer, which the TPU runs outside its kernels as banded MXU matmuls:
// K_down lane-restricts its row-restricted residuals and writes the child's
// input layout with the child mask; K_up stages the child's correction at
// coarse columns and prolongs it along lanes as it reads it (ECL).
//
// A mesh block (kBlock) is a canvas of its own, g.hp x g.wp = Hb x Wb, at
// the global origin (roff, coff; roff even) of the level. Its legs leave
// the lane transfers to the mesh (parallel/mg_sharded.py runs them on the
// gathered block row, since a child block does not align with a fine one):
// D3 writes its row-restricted residual (Hb/2, Wb) straight out in float4s,
// with no halo-column residual and no lane step; D4 takes the correction
// already lane-prolonged, (Hb/2, Wb), staged as b is, so ECL is a plain
// read of the staged column. Three things differ from one device, all
// outside the per-node arithmetic:
// - the interior test takes global coordinates (the span of row roff + r,
//   columns shifted by coff);
// - the tiles at the block's first and last rows stage their halo rows
//   from the exchanged rows (LegSide up / dn) by the same 16-byte copies;
// - only the tiles at the block's x edges stage the halo column, from the
//   exchanged columns (LegSide left / right), 4 bytes a row in the slot of
//   the one staged float4 that lies off the block; no other tile branches
//   on a source.
// On a 1x1 mesh the ring hands a block its own last column and row as its
// halos: the global interior test (every read is masked, or read only at
// an interior node) zeros them, as on one device.
//
// One value per node: every step is a rounding helper of common.cuh
// (down_residual, restrict_rows, restrict_lanes, midpoint, corrected_at,
// up_smooth), which round as the plain torch versions do, so the fields
// equal the plain versions' bit for bit, and stitched mesh blocks, through
// the lane transfers the mesh runs between its legs, equal A5 / A6.
#pragma once

#include <climits>

#include "common.cuh"

namespace ist_legs {

using ist::Geom;
using ist::TW;

constexpr int kThreads = 128;  // threads per tile block, one per fine column
constexpr int kTC = 64;        // coarse columns per K_down tile on one device
constexpr int kFW = 136;       // staged fine columns: F0 - 4 .. F0 + 131 (34 float4)
constexpr int kXW = 130;       // fine columns F0 - 1 .. F0 + 128 of the computed tiles
constexpr int kEW = 72;        // staged coarse columns: C0 - 4 .. C0 + 67 (18 float4)

// Where a field's values outside a mesh block come from (kBlock): its
// exchanged rows above (up: rows -nup .. -1, row stride g.wp) and below
// (dn: the row after the field's last), and the columns left and right of
// the block (left[k], right[k]: row lrow + k, k < lrows). Null on one
// device.
struct LegSide {
  const float* up = nullptr;
  const float* dn = nullptr;
  const float* left = nullptr;
  const float* right = nullptr;
  int nup = 0, lrow = 0, lrows = 0;
};

// A mesh block's global origin (roff even) and the sides of its fields: b,
// and on K_up the lane-prolonged correction ec.
struct LegHalo {
  LegSide b, ec;
  int roff = 0, coff = 0;
};

// A field of `rows` rows, g.wp columns, staged a float4 at a time (row r,
// columns c .. c + 3; c % 4 == 0). row_in: the row has a source, the
// field's own or, on a mesh block, an exchanged row above or below (rows
// -nup .. rows); row_at: that row's start. On a mesh block the float4
// that lies left (right) of the block holds the block's halo column at c +
// 3 (c), which side_at / side_in give: exchanged column k = r - lrow,
// 0 <= k < lrows. The sources are picked by selects, so on one device a
// float4 stays one predicated load.
template <bool kBlock>
__device__ __forceinline__ bool row_in(const LegSide& sd, int rows, int r) {
  return kBlock ? r >= -sd.nup && r <= rows : r >= 0 && r < rows;
}

template <bool kBlock>
__device__ __forceinline__ const float* row_at(const float* __restrict__ f, const LegSide& sd,
                                               int rows, int wp, int r) {
  if (!kBlock) return f + (ptrdiff_t)r * wp;
  return r < 0 ? sd.up + (ptrdiff_t)(r + sd.nup) * wp : r < rows ? f + (ptrdiff_t)r * wp : sd.dn;
}

__device__ __forceinline__ bool side_in(const LegSide& sd, int r) {
  return r - sd.lrow >= 0 && r - sd.lrow < sd.lrows;
}

__device__ __forceinline__ const float* side_at(const LegSide& sd, int r, int c) {
  return (c < 0 ? sd.left : sd.right) + (r - sd.lrow);
}

// K_up's staging: issue the copies of NR rows r0 .. r0 + NR - 1 and fine
// columns f0 .. f0 + kFW - 1 (f0 % 4 == 0) of a field of `rows` rows into s
// (row stride kFW), zero off the canvas and, on a mesh block, at rows
// outside [rlo, rhi); a custom level (kMask) also stages its int8 mask into
// sm. The caller waits (cp_async_wait_all).
template <bool kMask, bool kBlock, int NR>
__device__ __forceinline__ void stage_fine(const Geom& g, const LegSide& sd,
                                           const float* __restrict__ src, int rows, int r0,
                                           int f0, int rlo, int rhi, float* __restrict__ s,
                                           int8_t* __restrict__ sm) {
  constexpr int kQ = kFW / 4;
  for (int q = threadIdx.x; q < NR * kQ; q += kThreads) {
    const int rl = q / kQ, cl = (q % kQ) * 4;
    const int r = r0 + rl, c = f0 + cl;
    const bool cin = c >= 0 && c < g.wp;
    const bool rin = row_in<kBlock>(sd, rows, r) && (!kBlock || (r >= rlo && r < rhi));
    const bool ok = cin && rin;
    if (!kBlock || cin) {
      ist::cp_async16(s + rl * kFW + cl, ok ? row_at<kBlock>(src, sd, rows, g.wp, r) + c : src,
                      ok);
    } else {  // a mesh block's halo column, 4 bytes into the off-block float4
      const bool sok = r >= rlo && r < rhi && side_in(sd, r);
      ist::cp_async4(s + rl * kFW + cl + (c < 0 ? 3 : 0), sok ? side_at(sd, r, c) : src, sok);
    }
    if (kMask) ist::cp_async4(sm + rl * kFW + cl, g.mask + (ok ? (size_t)r * g.wp + c : 0), ok);
  }
}

// K_down's staging: the same rows and columns of b through registers,
// every load issued before the first store, each value zeroed off the
// interior (at its global node on a mesh block) on its way into shared
// memory (K_down reads masked values only).
template <bool kMask, bool kBlock, int NR>
__device__ __forceinline__ void stage_masked(const Geom& g, const LegHalo& h,
                                             const float* __restrict__ src, int r0, int f0,
                                             float* __restrict__ s, int8_t* __restrict__ sm) {
  constexpr int kQ = kFW / 4;
  constexpr int kN = NR * kQ;
  constexpr int kPer = (kN + kThreads - 1) / kThreads;
  float4 v[kPer];
  char4 m[kPer];
#pragma unroll
  for (int k = 0; k < kPer; ++k) {
    const int q = threadIdx.x + k * kThreads;
    const int r = r0 + q / kQ, c = f0 + (q % kQ) * 4;
    const bool cin = c >= 0 && c < g.wp;
    v[k] = make_float4(0.f, 0.f, 0.f, 0.f);
    m[k] = make_char4(0, 0, 0, 0);
    if (q < kN && cin && row_in<kBlock>(h.b, g.hp, r)) {
      const float* p = row_at<kBlock>(src, h.b, g.hp, g.wp, r) + c;
      v[k] = __ldg(reinterpret_cast<const float4*>(p));
      if (kMask) m[k] = *reinterpret_cast<const char4*>(g.mask + (p - src));
    }
    if (kBlock && q < kN && !cin && side_in(h.b, r)) {  // the halo column
      const float x = __ldg(side_at(h.b, r, c));
      if (c < 0) {
        v[k].w = x;
      } else {
        v[k].x = x;
      }
    }
  }
#pragma unroll
  for (int k = 0; k < kPer; ++k) {
    const int q = threadIdx.x + k * kThreads;
    if (q >= kN) break;
    const int rl = q / kQ, cl = (q % kQ) * 4;
    float4 x = v[k];
    if (kMask) {
      x.x = m[k].x ? x.x : 0.f;
      x.y = m[k].y ? x.y : 0.f;
      x.z = m[k].z ? x.z : 0.f;
      x.w = m[k].w ? x.w : 0.f;
    } else {
      const int2 sp = ist::interior_span(g, (kBlock ? h.roff : 0) + r0 + rl);
      const int c = (kBlock ? h.coff : 0) + f0 + cl;
      x.x = (c > sp.x && c < sp.y) ? x.x : 0.f;
      x.y = (c + 1 > sp.x && c + 1 < sp.y) ? x.y : 0.f;
      x.z = (c + 2 > sp.x && c + 2 < sp.y) ? x.z : 0.f;
      x.w = (c + 3 > sp.x && c + 3 < sp.y) ? x.w : 0.f;
    }
    *reinterpret_cast<float4*>(s + rl * kFW + cl) = x;
    if (kMask) *reinterpret_cast<char4*>(sm + rl * kFW + cl) = m[k];
  }
}

// The interior test of staged node (rl, cl) (staged origin r0, f0; on a
// mesh block shifted to its global node).
template <bool kMask, bool kBlock>
__device__ __forceinline__ bool staged_interior(const Geom& g, const LegHalo& h,
                                                const int8_t* sm, int r0, int f0, int rl,
                                                int cl) {
  static_assert(!(kMask && kBlock), "mesh blocks are gamma/rect only");
  if (kMask) return sm[rl * kFW + cl] != 0;
  const int2 sp = ist::interior_span(g, (kBlock ? h.roff : 0) + r0 + rl);
  const int c = (kBlock ? h.coff : 0) + f0 + cl;
  return c > sp.x && c < sp.y;
}

// K_down's body (A5; C2 with kMask; D3 with kBlock): coarse rows J0 .. J0 + TJ - 1
// and fine columns F0 .. F0 + 127. Staged: b at fine rows 2 J0 - 2 .. 2 J0
// + 2 TJ, masked. Residuals at fine rows 2 J0 - 1 .. 2 J0 + 2 TJ - 1,
// row-restricted into srr. One device: also the residuals at the halo
// column 2 C0 - 1 (C0 = F0 / 2), then the lane restriction onto coarse
// columns C0 .. C0 + 63 of the child's input layout gc (gc.hp x gc.wp; its
// mask when custom). A mesh block: srr's rows J < Hb / 2 straight out to
// out (Hb / 2, Wb).
template <bool kMask, bool kBlock, int TJ>
__device__ __forceinline__ void k_down_body(const float* __restrict__ b, float* __restrict__ out,
                                            const Geom& g, const Geom& gc, const LegHalo& h,
                                            float cs) {
  constexpr int NB = 2 * TJ + 3;         // staged fine rows
  constexpr int kRS = kBlock ? TW : kXW;  // srr's row stride
  constexpr int kR0 = kBlock ? 0 : 1;     // srr's column of fine column F0
  __shared__ __align__(16) float sb[NB * kFW];
  __shared__ __align__(16) int8_t sm[kMask ? NB * kFW : 16];
  __shared__ __align__(16) float srr[TJ * kRS];
  const int t = threadIdx.x;
  const int J0 = blockIdx.y * TJ, F0 = blockIdx.x * TW, C0 = F0 / 2;
  const int r0 = 2 * J0 - 2, f0 = F0 - 4;
  stage_masked<kMask, kBlock, NB>(g, h, b, r0, f0, sb, sm);
  __syncthreads();
  // the residual at staged node (rl, cl), 1 <= rl <= 2 TJ + 1, 1 <= cl <= kFW - 2
  auto R = [&](int rl, int cl) -> float {
    if (!staged_interior<kMask, kBlock>(g, h, sm, r0, f0, rl, cl)) return 0.f;
    const float* p = sb + rl * kFW + cl;
    return ist::down_residual(g, cs, p[0], p[-1], p[1], p[-kFW], p[kFW]);
  };
  // one device: the halo column 2 C0 - 1 (staged column 3), a coarse row a thread
  if (!kBlock && t < TJ)
    srr[t * kRS] = ist::restrict_rows(R(2 * t + 1, 3), R(2 * t + 2, 3), R(2 * t + 3, 3));
  {
    const int cl = t + 4;  // fine column F0 + t
    float below = R(1, cl);
#pragma unroll
    for (int j = 0; j < TJ; ++j) {
      const float center = R(2 * j + 2, cl);
      const float upper = R(2 * j + 3, cl);
      srr[j * kRS + kR0 + t] = ist::restrict_rows(below, center, upper);
      below = upper;
    }
  }
  __syncthreads();
  if (kBlock) {  // the row-restricted residual, a float4 a thread at a time
    const int hc = g.hp / 2;
    for (int q = t; q < TJ * (TW / 4); q += kThreads) {
      const int j = q / (TW / 4), c4 = (q % (TW / 4)) * 4;
      if (J0 + j < hc)
        *reinterpret_cast<float4*>(out + (size_t)(J0 + j) * g.wp + F0 + c4) =
            *reinterpret_cast<const float4*>(srr + j * kRS + c4);
    }
    return;
  }
  // lane restriction onto coarse column C: srr columns 2c, 2c + 1, 2c + 2
  // hold fine columns 2C - 1, 2C, 2C + 1; as lane_restrict, fine columns
  // past nx and coarse rows past ny / 2 are zero before the child mask
  const int c = t % kTC, C = C0 + c;
  const int ch = g.ny / 2 + 1;
  for (int j = t / kTC; j < TJ; j += kThreads / kTC) {
    const int J = J0 + j;
    if (J >= gc.hp || C >= gc.wp) continue;
    const float* q = srr + j * kRS + 2 * c;
    const float hi = 2 * C + 1 <= g.nx ? q[2] : 0.f;
    const float v = ist::restrict_lanes(q[0], q[1], hi);
    out[(size_t)J * gc.wp + C] = (J < ch && ist::interior<kMask>(gc, J, C)) ? v : 0.f;
  }
}

// K_up's body (A6; C3 with kMask; D4 with kBlock): fine rows i0 .. i0 + 2 TJ - 1
// and columns F0 .. F0 + 127. Staged: b at rows i0 - 1 .. i0 + 2 TJ (raw)
// and the coarse correction ec at coarse rows J0 - 1 .. J0 + TJ whose
// global row lies in [0, ch) (others zero): on one device at coarse columns
// C0 - 4 .. C0 + 67 (row stride ldc), on a mesh block lane-prolonged at
// fine columns F0 - 4 .. F0 + 131 (row stride Wb, Hb / 2 rows). The
// corrected iterate at rows i0 - 1 .. i0 + 2 TJ and columns F0 - 1 .. F0 +
// 128 goes to sx, then the sweep writes the tile and, with the dot, the
// block's partial of (b, out).
template <bool kMask, bool kBlock, int TJ>
__device__ __forceinline__ void k_up_body(const float* __restrict__ b,
                                          const float* __restrict__ ec, float* __restrict__ out,
                                          float* __restrict__ dot_p, const Geom& g,
                                          const LegHalo& h, float cs, int ldc, int ch) {
  constexpr int TI = 2 * TJ;  // fine rows per tile
  constexpr int NB = TI + 2;  // staged fine rows
  constexpr int NE = TJ + 2;  // staged coarse rows
  constexpr int kES = kBlock ? kFW : kEW;  // se's row stride
  __shared__ __align__(16) float sb[NB * kFW];
  __shared__ __align__(16) int8_t sm[kMask ? NB * kFW : 16];
  __shared__ __align__(16) float se[NE * kES];
  __shared__ float sx[NB * kXW];
  const int t = threadIdx.x;
  const int i0 = blockIdx.y * TI, F0 = blockIdx.x * TW;
  const int J0 = i0 / 2, C0 = F0 / 2;
  const int r0 = i0 - 1, f0 = F0 - 4;
  // raw: only interior nodes are read
  stage_fine<kMask, kBlock, NB>(g, h.b, b, g.hp, r0, f0, INT_MIN, INT_MAX, sb, sm);
  if (kBlock) {  // the lane-prolonged correction, staged as b is
    const int goff = h.roff / 2;
    stage_fine<false, true, NE>(g, h.ec, ec, g.hp / 2, J0 - 1, f0, -goff, ch - goff, se,
                                nullptr);
  } else if (ldc % 4 == 0) {  // a fused child's padded canvas: 16-byte copies
    constexpr int kQ = kEW / 4;
    for (int q = t; q < NE * kQ; q += kThreads) {
      const int J = J0 - 1 + q / kQ, C = C0 - 4 + (q % kQ) * 4;
      const bool ok = J >= 0 && J < ch && C >= 0 && C < ldc;
      ist::cp_async16(se + (q / kQ) * kEW + (q % kQ) * 4, ec + (ok ? (size_t)J * ldc + C : 0), ok);
    }
  } else {  // a plain child's grid (ch, cw)
    for (int q = t; q < NE * kEW; q += kThreads) {
      const int J = J0 - 1 + q / kEW, C = C0 - 4 + q % kEW;
      se[q] = (J >= 0 && J < ch && C >= 0 && C < ldc) ? __ldg(ec + (size_t)J * ldc + C) : 0.f;
    }
  }
  ist::cp_async_wait_all();
  __syncthreads();
  // the lane-prolonged correction at staged coarse row k, fine column f
  // (f >= F0 - 1): a mesh block's is staged; on one device even columns
  // copy, odd ones average, zero past column nx
  auto ECL = [&](int k, int f) -> float {
    if (kBlock) return se[k * kES + f - f0];
    if (f > g.nx) return 0.f;
    const float* e = se + k * kES + (f >> 1) - C0 + 4;
    return (f & 1) ? ist::midpoint(e[0], e[1]) : e[0];
  };
  // the corrected iterate at staged row rl (fine row r0 + rl, parity: rl
  // even is an odd fine row) from the lane-prolonged rows e0 = row k, e1 = k + 1
  auto XC = [&](int rl, int cl, float e0, float e1) -> float {
    if (!staged_interior<kMask, kBlock>(g, h, sm, r0, f0, rl, cl)) return 0.f;
    const float p = (rl & 1) ? e1 : ist::midpoint(e0, e1);
    return ist::corrected_at(cs, sb[rl * kFW + cl], p);
  };
  // fine row r0 + rl takes coarse rows (staged) rl / 2 and rl / 2 + 1 when
  // odd (rl even), and (rl + 1) / 2 when even (rl odd)
  if (t < 2 * NB) {  // the halo columns F0 - 1 and F0 + 128
    const int rl = t % NB, side = t / NB;
    const int f = side ? F0 + TW : F0 - 1;
    const int k = (rl & 1) ? (rl + 1) / 2 - 1 : rl / 2;
    sx[rl * kXW + (side ? kXW - 1 : 0)] = XC(rl, f - f0, ECL(k, f), ECL(k + 1, f));
  }
  {
    const int f = F0 + t;
    float e[NE];
#pragma unroll
    for (int k = 0; k < NE; ++k) e[k] = ECL(k, f);
#pragma unroll
    for (int rl = 0; rl < NB; ++rl) {
      const int k = (rl & 1) ? (rl + 1) / 2 - 1 : rl / 2;
      sx[rl * kXW + t + 1] = XC(rl, t + 4, e[k], e[k + 1]);
    }
  }
  __syncthreads();
  float s_dot = 0.f;
  {
    const int f = F0 + t;
    float up = sx[t + 1], cur = sx[kXW + t + 1];
#pragma unroll 4
    for (int rl = 1; rl <= TI; ++rl) {
      const float* x = sx + rl * kXW + t + 1;
      const float dn = x[kXW];
      float o = 0.f;
      if (staged_interior<kMask, kBlock>(g, h, sm, r0, f0, rl, t + 4)) {
        const float bm = sb[rl * kFW + t + 4];
        o = ist::up_smooth(g, cs, cur, x[-1], x[1], up, dn, bm);
        s_dot += bm * o;
      }
      const int i = r0 + rl;
      if (i < g.hp) out[(size_t)i * g.wp + f] = o;
      up = cur;
      cur = dn;
    }
  }
  if (dot_p != nullptr) {
    s_dot = ist::block_reduce<false>(s_dot);
    if (t == 0) dot_p[blockIdx.y * gridDim.x + blockIdx.x] = s_dot;
  }
}

// The kernels: one device's take their level's geometry alone; a mesh
// block's also its halo (a __grid_constant__ parameter: the bodies read it
// in place).
template <bool kMask, int TJ>
__global__ void __launch_bounds__(kThreads)
    k_down_kernel(const float* __restrict__ b, float* __restrict__ out, Geom g, Geom gc,
                  float cs) {
  k_down_body<kMask, false, TJ>(b, out, g, gc, LegHalo{}, cs);
}

template <int TJ>
__global__ void __launch_bounds__(kThreads)
    k_down_block_kernel(const float* __restrict__ b, float* __restrict__ out, Geom g,
                        const __grid_constant__ LegHalo h, float cs) {
  k_down_body<false, true, TJ>(b, out, g, g, h, cs);
}

template <bool kMask, int TJ>
__global__ void __launch_bounds__(kThreads)
    k_up_kernel(const float* __restrict__ b, const float* __restrict__ ec,
                float* __restrict__ out, float* __restrict__ dot_p, Geom g, float cs, int ldc,
                int ch) {
  k_up_body<kMask, false, TJ>(b, ec, out, dot_p, g, LegHalo{}, cs, ldc, ch);
}

template <int TJ>
__global__ void __launch_bounds__(kThreads)
    k_up_block_kernel(const float* __restrict__ b, const float* __restrict__ ec,
                      float* __restrict__ out, float* __restrict__ dot_p, Geom g,
                      const __grid_constant__ LegHalo h, float cs, int ch) {
  k_up_body<false, true, TJ>(b, ec, out, dot_p, g, h, cs, g.wp, ch);
}

// The tile heights kernels/mg_fused.tile_rows can pick: K_down 16, 8 or 4
// (4 on a custom level), K_up 8 or 4. A mesh block's D3 grid covers its Hb
// / 2 coarse rows (the last tile cut at the block's edge); D4's tiles
// divide Hb (Hb % 16 == 0 on every shard-fused level).
template <bool kMask, bool kBlock, int TJ>
void launch_down_tj(const dim3& grid, const float* b, float* out, const Geom& g, const Geom& gc,
                    const LegHalo& h, float cs, cudaStream_t s) {
  if constexpr (kBlock) {
    k_down_block_kernel<TJ><<<grid, kThreads, 0, s>>>(b, out, g, h, cs);
  } else {
    k_down_kernel<kMask, TJ><<<grid, kThreads, 0, s>>>(b, out, g, gc, cs);
  }
}

template <bool kMask, bool kBlock>
int launch_down(const float* b, float* out, const Geom& g, const Geom& gc, const LegHalo& h,
                float cs, int tj, cudaStream_t s) {
  if (tj <= 0) return (int)cudaErrorInvalidValue;
  const dim3 grid = kBlock ? dim3(g.wp / TW, (g.hp / 2 + tj - 1) / tj)
                           : dim3((gc.wp + kTC - 1) / kTC, (gc.hp + tj - 1) / tj);
  if (tj == 4) {
    launch_down_tj<kMask, kBlock, 4>(grid, b, out, g, gc, h, cs, s);
  } else if constexpr (!kMask) {
    if (tj == 16) {
      launch_down_tj<false, kBlock, 16>(grid, b, out, g, gc, h, cs, s);
    } else if (tj == 8) {
      launch_down_tj<false, kBlock, 8>(grid, b, out, g, gc, h, cs, s);
    } else {
      return (int)cudaErrorInvalidValue;
    }
  } else {
    return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

template <bool kMask, bool kBlock, int TJ>
void launch_up_tj(const dim3& grid, const float* b, const float* ec, float* out, float* dot_p,
                  const Geom& g, const LegHalo& h, float cs, int ldc, int ch, cudaStream_t s) {
  if constexpr (kBlock) {
    k_up_block_kernel<TJ><<<grid, kThreads, 0, s>>>(b, ec, out, dot_p, g, h, cs, ch);
  } else {
    k_up_kernel<kMask, TJ><<<grid, kThreads, 0, s>>>(b, ec, out, dot_p, g, cs, ldc, ch);
  }
}

template <bool kMask, bool kBlock>
int launch_up(const float* b, const float* ec, float* out, float* dot_p, const Geom& g,
              const LegHalo& h, float cs, int tj, int ldc, int ch, cudaStream_t s) {
  if (tj <= 0 || (kBlock && g.hp % (2 * tj) != 0)) return (int)cudaErrorInvalidValue;
  const dim3 grid(g.wp / TW, (g.hp + 2 * tj - 1) / (2 * tj));
  switch (tj) {
    case 8: launch_up_tj<kMask, kBlock, 8>(grid, b, ec, out, dot_p, g, h, cs, ldc, ch, s); break;
    case 4: launch_up_tj<kMask, kBlock, 4>(grid, b, ec, out, dot_p, g, h, cs, ldc, ch, s); break;
    default: return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

}  // namespace ist_legs
