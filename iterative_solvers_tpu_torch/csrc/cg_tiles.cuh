// The tiles of the fused CG / PCG iteration: K1 and K2 / K2-pcg on one
// device (csrc/cg_fused.cu) and their mesh-block forms D5 and D6 / D6-pcg
// (csrc/cg_fused_sharded.cu) are the two kernels below, instantiated with
// kBlock false or true.
//
// The design: a CUDA block owns a tile of TJ rows x 128 columns, TJ a
// divisor of the band height `by` picked per layout (kernels/cg_fused.
// tile_grid: K2 8 rows; K1, whose 8 B/node make a tile's two halo rows
// dear, the tallest of 32, 16 and 8 that still puts four blocks on every
// SM), so that a small grid fills the card. The block stages the tile's z_k
// once into shared memory (stage_zk): each warp takes every fourth staged
// row, each lane 4 adjacent columns, from 16-byte loads of d (K2: r or w)
// and z_prev with four rows' loads in flight (wp % 128 == 0), plus the
// tile's halo rows and columns. A halo row inside the band is formed raw,
// as the tile's own rows are; at a band edge it is the masked z_k of its
// row (K1, which writes it to the side buffer from the tiles at band
// edges) or K1's side row (K2). Then each warp sweeps TJ / 4 consecutive
// rows, carrying the rows above and below in registers and taking the
// column neighbours from the next lanes by shuffles; K2 reads x and r (and
// u) and writes x', r' and z_k in 16-byte pieces. The interior test is one
// column span per row on gamma/rect (ist::interior_span), the int8 mask
// staged by cp.async on a custom layout. One partial per block, reduced by
// the caller in a fixed order.
//
// A mesh block (kBlock) is a canvas of its own, g.hp x g.wp = Hb x Wb, at
// the global origin (roff, coff) of a canvas wg columns wide. Three things
// differ, all outside the per-node sweep:
// - the interior test takes the global row and columns (the span is
//   shifted by coff once per row);
// - a tile strip at the block's left / right edge stages its halo column
//   from the exchanged column `left` / `right` (z_k = direction(d, beta,
//   z_prev) from the raw pair, 0 where the global column lies off the
//   canvas, as K1 / K2 take 0 there): 2 TJ threads of an edge tile, no
//   branch per node;
// - K1's tiles at the block's first and last rows stage that band-edge
//   halo row from `up` / `dn`, masked by its own global row as every
//   band-edge row is. Blocks start and end on band edges (Hb % by == 0), so
//   K2's halo rows there are K1's side rows, as everywhere else.
// On a 1x1 mesh the ring hands a block its own last column as `left` and
// its own last row as `up`: the off-canvas column test and the row's own
// interior mask zero them. Stitched blocks therefore equal K1 / K2 /
// K2-pcg on the whole canvas bit for bit at every node, side rows included.
//
// One value per node: every per-node step is a rounding helper of
// common.cuh (direction, stencil_rn, x_update, r_update), which round as
// the plain torch versions do, so the fields equal theirs bit for bit.
//
// In-place race: the TPU kernels wrote x, r and z in place, legal there
// because a whole block sat in VMEM before any write. Here other blocks may
// still stage z_prev and w (their halos) while one writes, so K2 writes x',
// r' and z_k to fresh buffers (the caller swaps them in). On CUDA a fresh
// buffer costs the same write traffic as an in-place one.
#pragma once

#include "common.cuh"

namespace ist_tiles {

using ist::Geom;
using ist::TW;

constexpr int kThreads = 128;  // threads per tile block: 4 warps
constexpr int kWarps = kThreads / 32;
constexpr int kSW = 136;       // staged row stride: tile column j at 4 + j, 16-byte aligned
constexpr int kRowsInFlight = 4;  // staged rows per warp whose loads are issued together
constexpr int kK2Rows = 8;     // K2's tile rows (kernels/cg_fused.K2_TILE_ROWS)

// Where a mesh block's values outside the block come from (kBlock): the
// exchanged rows up / dn (2, Wb) and columns left / right (2, Hb) of the
// raw (d, z_prev) pair, 16-byte aligned; the block's global origin and
// the canvas width. D6 passes no rows (its halo rows are K1's side rows).
// Unused (zero) on one device.
struct Halo {
  const float* up;
  const float* dn;
  const float* left;
  const float* right;
  int roff, coff, wg;
};

__device__ __forceinline__ unsigned bits4(char4 m) {
  return (m.x != 0) | (m.y != 0) << 1 | (m.z != 0) << 2 | (m.w != 0) << 3;
}

// The interior flags of nodes (r, c .. c + 3) of the tile (staged row rl,
// c % 4 == 0, tile column c - c0), as bits 0 .. 3: the staged int8 mask sm
// on a custom layout, the row's interior span on gamma/rect; a mesh block
// tests its global row and columns.
template <bool kMask, bool kBlock>
__device__ __forceinline__ unsigned interior4(const Geom& g, const Halo& h, const int8_t* sm,
                                              int rl, int r, int c, int c0) {
  static_assert(!(kMask && kBlock), "mesh blocks are gamma/rect only");
  if (kMask) return bits4(*reinterpret_cast<const char4*>(sm + rl * TW + c - c0));
  if (kBlock) {
    r += h.roff;
    c += h.coff;
  }
  const int2 sp = ist::interior_span(g, r);
  unsigned in = 0u;
#pragma unroll
  for (int j = 0; j < 4; ++j) in |= (unsigned)(c + j > sp.x && c + j < sp.y) << j;
  return in;
}

// One block's tile: rows row0 .. row0 + TJ - 1, columns c0 .. c0 + 127,
// staged with its halo rows as staged rows 0 .. TJ + 1 (row stride kSW,
// tile column j at staged column 4 + j, the halo columns at 3 and 132).
// `top` / `bottom`: the halo row is a band edge.
struct Tile {
  int row0, c0, band;
  bool top, bottom;

  __device__ bool edge(int rl, int nr) const {
    return (rl == 0 && top) || (rl == nr - 1 && bottom);
  }
};

// Tile t of the layout: tiles run along a row of TW-column strips first.
template <int TJ>
__device__ __forceinline__ Tile tile_at(const Geom& g, int t, int by) {
  const int strips = g.wp / TW;
  Tile tl;
  tl.row0 = (t / strips) * TJ;
  tl.c0 = (t % strips) * TW;
  tl.band = tl.row0 / by;
  tl.top = tl.row0 % by == 0;
  tl.bottom = (tl.row0 + TJ) % by == 0;
  return tl;
}

__device__ __forceinline__ float4 ldg4(const float* p) {
  return __ldg(reinterpret_cast<const float4*>(p));
}

__device__ __forceinline__ float4 direction4(float4 d, float beta, float4 z) {
  return make_float4(ist::direction(d.x, beta, z.x), ist::direction(d.y, beta, z.y),
                     ist::direction(d.z, beta, z.z), ist::direction(d.w, beta, z.w));
}

__device__ __forceinline__ float max_abs4(float m, float4 v) {
  return fmaxf(fmaxf(m, fmaxf(fabsf(v.x), fabsf(v.y))), fmaxf(fabsf(v.z), fabsf(v.w)));
}

// z_k at the halo column c (c0 - 1 or c0 + 128) of block-local row r: raw
// inside the canvas; off it 0 on one device, and on a mesh block the
// exchanged column's pair where the global column lies on the canvas.
template <bool kBlock>
__device__ __forceinline__ float halo_column(const Geom& g, const Halo& h,
                                             const float* __restrict__ d,
                                             const float* __restrict__ zp, float beta, int r,
                                             int c) {
  if (c >= 0 && c < g.wp) {
    const size_t i = (size_t)r * g.wp + c;
    return ist::direction(__ldg(d + i), beta, __ldg(zp + i));
  }
  if (kBlock && h.coff + c >= 0 && h.coff + c < h.wg) {
    const float* col = c < 0 ? h.left : h.right;
    return ist::direction(__ldg(col + r), beta, __ldg(col + g.hp + r));
  }
  return 0.f;
}

// Stage the tile's z_k = direction(d, beta, z_prev) into sk, each node
// once: warp w takes staged rows w, w + 4, ..., lane l the columns c0 + 4l
// .. c0 + 4l + 3, from 16-byte loads (kRowsInFlight rows' loads issued
// before their stores); threads 0 .. 2 TJ - 1 take the halo columns of the
// tile's rows. A halo row inside the band is formed raw, as the tile's own
// rows; at a band edge it is K1's side row (K2: `side`) or the masked z_k
// of its row (K1: side == nullptr, which also sums (d, z_k) and max |z_k|
// over the tile's rows into s_rz, s_max; a mesh block's rows -1 and Hb
// from up / dn). A custom layout also stages the int8 mask of the staged
// rows into sm (cp.async; the caller waits).
template <bool kMask, bool kBlock, int TJ>
__device__ __forceinline__ void stage_zk(const Geom& g, const Halo& h, const Tile& tl,
                                         const float* __restrict__ d,
                                         const float* __restrict__ zp,
                                         const float* __restrict__ side, float beta, float* sk,
                                         int8_t* sm, float& s_rz, float& s_max) {
  constexpr int NR = TJ + 2;
  constexpr int kRowsPerWarp = (NR + kWarps - 1) / kWarps;
  const int t = threadIdx.x, lane = t & 31, w = t >> 5;
  if (kMask) {
    for (int q = t; q < NR * (TW / 16); q += kThreads) {
      const int rl = q / (TW / 16), cb = (q % (TW / 16)) * 16;
      const int r = tl.row0 - 1 + rl;
      const bool ok = r >= 0 && r < g.hp;
      ist::cp_async16(sm + rl * TW + cb, g.mask + (ok ? (size_t)r * g.wp + tl.c0 + cb : 0), ok);
    }
  }
  if (t < 2 * TJ) {
    const int rl = 1 + (t >> 1);
    sk[rl * kSW + ((t & 1) ? 4 + TW : 3)] = halo_column<kBlock>(
        g, h, d, zp, beta, tl.row0 - 1 + rl, (t & 1) ? tl.c0 + TW : tl.c0 - 1);
  }
  const int c = tl.c0 + 4 * lane;
#pragma unroll
  for (int k0 = 0; k0 < kRowsPerWarp; k0 += kRowsInFlight) {
    float4 dv[kRowsInFlight], zv[kRowsInFlight];
    char4 mv[kRowsInFlight];  // K1 on a custom layout: a band edge's mask
#pragma unroll
    for (int k = 0; k < kRowsInFlight; ++k) {
      const int rl = w + kWarps * (k0 + k), r = tl.row0 - 1 + rl;
      dv[k] = zv[k] = make_float4(0.f, 0.f, 0.f, 0.f);
      mv[k] = make_char4(0, 0, 0, 0);
      if (k0 + k >= kRowsPerWarp || rl >= NR) continue;
      if (side != nullptr && tl.edge(rl, NR)) {
        dv[k] = ldg4(side + ((size_t)tl.band * 2 + (rl != 0)) * g.wp + c);
      } else if (r >= 0 && r < g.hp) {
        const size_t i = (size_t)r * g.wp + c;
        dv[k] = ldg4(d + i);
        zv[k] = ldg4(zp + i);
        if (kMask && tl.edge(rl, NR)) mv[k] = *reinterpret_cast<const char4*>(g.mask + i);
      } else if (kBlock && side == nullptr) {  // K1: the block's row -1 or Hb
        const float* row = r < 0 ? h.up : h.dn;
        dv[k] = ldg4(row + c);
        zv[k] = ldg4(row + g.wp + c);
      }
    }
#pragma unroll
    for (int k = 0; k < kRowsInFlight; ++k) {
      const int rl = w + kWarps * (k0 + k);
      if (k0 + k >= kRowsPerWarp || rl >= NR) break;
      float4 zk;
      if (tl.edge(rl, NR)) {
        if (side != nullptr) {
          zk = dv[k];  // K1's side row
        } else {       // K1: masked by its own row
          const unsigned in = kMask ? bits4(mv[k])
                                    : interior4<false, kBlock>(g, h, nullptr, rl,
                                                               tl.row0 - 1 + rl, c, 0);
          zk = direction4(dv[k], beta, zv[k]);
          zk = make_float4((in & 1u) ? zk.x : 0.f, (in & 2u) ? zk.y : 0.f,
                           (in & 4u) ? zk.z : 0.f, (in & 8u) ? zk.w : 0.f);
        }
      } else {
        zk = direction4(dv[k], beta, zv[k]);
        if (side == nullptr && rl > 0 && rl < NR - 1) {
          const float4 dk = dv[k];
          s_rz += dk.x * zk.x + dk.y * zk.y + dk.z * zk.z + dk.w * zk.w;
          s_max = max_abs4(s_max, zk);
        }
      }
      *reinterpret_cast<float4*>(sk + rl * kSW + 4 + 4 * lane) = zk;
    }
  }
}

// A z_k at the lane's nodes (r, c .. c + 3) of staged row rl from the
// staged rows above (up), at (cur) and below (dn); the column neighbours
// come from the next lanes, the tile's halo columns from sk. Zero off the
// interior. Every lane of the warp calls it (shuffles).
template <bool kMask, bool kBlock>
__device__ __forceinline__ float4 apply_row(const Geom& g, const Halo& h, const float* sk,
                                            const int8_t* sm, int rl, int r, int c, int c0,
                                            float4 up, float4 cur, float4 dn) {
  const int lane = threadIdx.x & 31;
  float zl = __shfl_up_sync(0xffffffffu, cur.w, 1);
  float zr = __shfl_down_sync(0xffffffffu, cur.x, 1);
  if (lane == 0) zl = sk[rl * kSW + 3];
  if (lane == 31) zr = sk[rl * kSW + 4 + TW];
  const unsigned in = interior4<kMask, kBlock>(g, h, sm, rl, r, c, c0);
  float4 az;
  az.x = (in & 1u) ? ist::stencil_rn(g, cur.x, zl, cur.y, up.x, dn.x) : 0.f;
  az.y = (in & 2u) ? ist::stencil_rn(g, cur.y, cur.x, cur.z, up.y, dn.y) : 0.f;
  az.z = (in & 4u) ? ist::stencil_rn(g, cur.z, cur.y, cur.w, up.z, dn.z) : 0.f;
  az.w = (in & 8u) ? ist::stencil_rn(g, cur.w, cur.z, zr, up.w, dn.w) : 0.f;
  return az;
}

__device__ __forceinline__ float4 lds4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}

// Sum a, sum (or with kMaxB max) b and max c over the block's threads in
// one pass, valid in thread 0: a fixed shuffle and warp order, no atomics,
// so the same inputs give the same bits on every run.
template <bool kMaxB>
__device__ __forceinline__ void block_reduce3(float& a, float& b, float& c) {
  __shared__ float part[3][kWarps];
  for (int o = 16; o > 0; o >>= 1) {
    a += __shfl_down_sync(0xffffffffu, a, o);
    const float tb = __shfl_down_sync(0xffffffffu, b, o);
    b = kMaxB ? fmaxf(b, tb) : b + tb;
    c = fmaxf(c, __shfl_down_sync(0xffffffffu, c, o));
  }
  const int w = threadIdx.x >> 5;
  if ((threadIdx.x & 31) == 0) {
    part[0][w] = a;
    part[1][w] = b;
    part[2][w] = c;
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    for (int k = 1; k < kWarps; ++k) {
      a += part[0][k];
      b = kMaxB ? fmaxf(b, part[1][k]) : b + part[1][k];
      c = fmaxf(c, part[2][k]);
    }
  }
}

// K1 (A2; D5 with kBlock): stage the tile's z_k, then warp w sweeps its
// TJ / 4 rows down the tile, carrying the rows above and below in
// registers. The tiles at band edges write the band's side rows.
template <bool kMask, bool kBlock, int TJ>
__global__ void __launch_bounds__(kThreads)
    k1_kernel(const float* __restrict__ d, const float* __restrict__ zp,
              const float* __restrict__ beta_p, float* __restrict__ side,
              float* __restrict__ rz_p, float* __restrict__ azz_p, float* __restrict__ zmax_p,
              Geom g, Halo h, int by) {
  constexpr int NR = TJ + 2;
  constexpr int S = TJ / kWarps;
  __shared__ __align__(16) float sk[NR * kSW];  // z_k
  __shared__ __align__(16) int8_t sm[kMask ? NR * TW : 16];
  const int t = threadIdx.x, w = t >> 5;
  const Tile tl = tile_at<TJ>(g, blockIdx.x, by);
  float s_rz = 0.f, s_azz = 0.f, s_max = 0.f;
  stage_zk<kMask, kBlock, TJ>(g, h, tl, d, zp, nullptr, *beta_p, sk, sm, s_rz, s_max);
  ist::cp_async_wait_all();
  __syncthreads();
  if (tl.top) side[(size_t)tl.band * 2 * g.wp + tl.c0 + t] = sk[4 + t];
  if (tl.bottom)
    side[((size_t)tl.band * 2 + 1) * g.wp + tl.c0 + t] = sk[(NR - 1) * kSW + 4 + t];
  const int c = tl.c0 + 4 * (t & 31);
  const float* p = sk + 4 + 4 * (t & 31);
  float4 up = lds4(p + w * S * kSW), cur = lds4(p + (w * S + 1) * kSW);
#pragma unroll
  for (int j = 0; j < S; ++j) {
    const int rl = 1 + w * S + j;
    const float4 dn = lds4(p + (rl + 1) * kSW);
    const float4 az = apply_row<kMask, kBlock>(g, h, sk, sm, rl, tl.row0 - 1 + rl, c, tl.c0,
                                               up, cur, dn);
    s_azz += az.x * cur.x + az.y * cur.y + az.z * cur.z + az.w * cur.w;
    up = cur;
    cur = dn;
  }
  block_reduce3<false>(s_rz, s_azz, s_max);
  if (t == 0) {
    rz_p[blockIdx.x] = s_rz;
    azz_p[blockIdx.x] = s_azz;
    zmax_p[blockIdx.x] = s_max;
  }
}

// K2 (A3; A4 with kPcg: z_k = w + beta * z_prev, else r + beta * z_prev and
// w is not read; D6 / D6-pcg with kBlock): the same staging and sweep,
// reading x and r (and u) and writing x', r' and z_k in 16-byte pieces. u
// (may be null) adds the max |x' - u| partial.
template <bool kPcg, bool kMask, bool kBlock, int TJ>
__global__ void __launch_bounds__(kThreads)
    k2_kernel(const float* __restrict__ x, const float* __restrict__ r,
              const float* __restrict__ zp, const float* __restrict__ w,
              const float* __restrict__ side, const float* __restrict__ scal,
              const float* __restrict__ u, float* __restrict__ xo, float* __restrict__ ro,
              float* __restrict__ zo, float* __restrict__ r2_p, float* __restrict__ rmax_p,
              float* __restrict__ err_p, Geom g, Halo h, int by) {
  constexpr int NR = TJ + 2;
  constexpr int S = TJ / kWarps;
  __shared__ __align__(16) float sk[NR * kSW];  // z_k
  __shared__ __align__(16) int8_t sm[kMask ? NR * TW : 16];
  const int t = threadIdx.x, warp = t >> 5;
  const Tile tl = tile_at<TJ>(g, blockIdx.x, by);
  const float alpha = scal[0];
  float unused = 0.f, s_r2 = 0.f, s_max = 0.f, s_err = 0.f;
  stage_zk<kMask, kBlock, TJ>(g, h, tl, kPcg ? w : r, zp, side, scal[1], sk, sm, unused,
                              unused);
  ist::cp_async_wait_all();
  __syncthreads();
  const int c = tl.c0 + 4 * (t & 31);
  const float* p = sk + 4 + 4 * (t & 31);
  float4 up = lds4(p + warp * S * kSW), cur = lds4(p + (warp * S + 1) * kSW);
#pragma unroll
  for (int j = 0; j < S; ++j) {
    const int rl = 1 + warp * S + j, rr = tl.row0 - 1 + rl;
    const size_t i = (size_t)rr * g.wp + c;
    const float4 xv = ldg4(x + i);
    const float4 rv = ldg4(r + i);
    const float4 dn = lds4(p + (rl + 1) * kSW);
    const float4 az = apply_row<kMask, kBlock>(g, h, sk, sm, rl, rr, c, tl.c0, up, cur, dn);
    const float4 xn =
        make_float4(ist::x_update(xv.x, alpha, cur.x), ist::x_update(xv.y, alpha, cur.y),
                    ist::x_update(xv.z, alpha, cur.z), ist::x_update(xv.w, alpha, cur.w));
    const float4 rn =
        make_float4(ist::r_update(rv.x, alpha, az.x), ist::r_update(rv.y, alpha, az.y),
                    ist::r_update(rv.z, alpha, az.z), ist::r_update(rv.w, alpha, az.w));
    *reinterpret_cast<float4*>(xo + i) = xn;
    *reinterpret_cast<float4*>(ro + i) = rn;
    *reinterpret_cast<float4*>(zo + i) = cur;
    s_r2 += rn.x * rn.x + rn.y * rn.y + rn.z * rn.z + rn.w * rn.w;
    s_max = max_abs4(s_max, rn);
    if (u != nullptr) {
      const float4 uv = ldg4(u + i);
      s_err = max_abs4(s_err, make_float4(__fsub_rn(xn.x, uv.x), __fsub_rn(xn.y, uv.y),
                                          __fsub_rn(xn.z, uv.z), __fsub_rn(xn.w, uv.w)));
    }
    up = cur;
    cur = dn;
  }
  block_reduce3<true>(s_r2, s_max, s_err);
  if (t == 0) {
    r2_p[blockIdx.x] = s_r2;
    rmax_p[blockIdx.x] = s_max;
    if (u != nullptr) err_p[blockIdx.x] = s_err;
  }
}

// The tile heights kernels/cg_fused.tile_grid can pick: K1 32, 16 or 8, K2 8.
template <bool kMask, bool kBlock>
int launch_k1(const float* d, const float* zp, const float* beta, float* side, float* rz_p,
              float* azz_p, float* zmax_p, const Geom& g, const Halo& h, int by, int tj,
              cudaStream_t s) {
  if (tj <= 0 || by % tj != 0) return (int)cudaErrorInvalidValue;
  const int tiles = (g.wp / TW) * (g.hp / tj);
  switch (tj) {
    case 32:
      k1_kernel<kMask, kBlock, 32><<<tiles, kThreads, 0, s>>>(d, zp, beta, side, rz_p, azz_p,
                                                              zmax_p, g, h, by);
      break;
    case 16:
      k1_kernel<kMask, kBlock, 16><<<tiles, kThreads, 0, s>>>(d, zp, beta, side, rz_p, azz_p,
                                                              zmax_p, g, h, by);
      break;
    case 8:
      k1_kernel<kMask, kBlock, 8><<<tiles, kThreads, 0, s>>>(d, zp, beta, side, rz_p, azz_p,
                                                             zmax_p, g, h, by);
      break;
    default: return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

template <bool kPcg, bool kMask, bool kBlock>
int launch_k2(const float* x, const float* r, const float* zp, const float* w, const float* side,
              const float* scal, const float* u, float* xo, float* ro, float* zo, float* r2_p,
              float* rmax_p, float* err_p, const Geom& g, const Halo& h, int by, int tj,
              cudaStream_t s) {
  if (tj != kK2Rows || by % tj != 0) return (int)cudaErrorInvalidValue;
  const int tiles = (g.wp / TW) * (g.hp / kK2Rows);
  k2_kernel<kPcg, kMask, kBlock, kK2Rows><<<tiles, kThreads, 0, s>>>(
      x, r, zp, w, side, scal, u, xo, ro, zo, r2_p, rmax_p, err_p, g, h, by);
  return (int)cudaGetLastError();
}

}  // namespace ist_tiles
