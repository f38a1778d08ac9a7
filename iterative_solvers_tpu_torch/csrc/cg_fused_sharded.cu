// The fused CG / PCG iteration on one block of a mesh-sharded field: block
// K1 (D5) and block K2 / K2-pcg (D6).
//
// ist_k1_block replaces iterative_solvers_tpu/parallel/cg_fused_sharded.py:
// _make_k1_block / _k1_call (D5); ist_k2_block and ist_k2_pcg_block replace
// _make_k2_block / _k2_call (D6, pcg=False / True).
//
// Each runs a column sweep (ist::k1_column, ist::k2_column) with its
// single-device kernel's per-node arithmetic (K1, A2; K2, A3/A4: the
// rounding helpers of common.cuh) on a block whose global origin (roff,
// coff) offsets the mask, with the neighbour rows and columns of the
// direction's ingredients d (r for MSG CG, w = M r for PCG) and z_prev as
// operands:
// up / dn (2, Wb) hold rows -1 and Hb of d (row 0) and z_prev (row 1),
// left / right (2, Hb) columns -1 and Wb. A thread forms z_k = d + beta *
// z_prev at a neighbour node by the same helper as the block that owns
// the node, so every node of a block, edge or not, takes the single-device
// kernel's arithmetic and the stitched blocks equal K1 / K2 / K2-pcg bit for
// bit; the partials cover the whole block. The TPU kernels zero the wrapped
// lane of their lane rolls and correct the edge columns afterwards ((A z, z)
// edge terms, r' edge strips and the |r'|^2, max |r'| partials without the
// edge lanes); that fix-up has no counterpart here.
//
// As on one device, a band's halo rows are masked by their own row's
// interior, and a column neighbour is read raw on the canvas (wg columns
// wide) and as 0 off it. In D5 only the threads of the block's two edge
// columns take the halo-selecting read (zk_at) within their band; the
// others read the block directly (z_inside): with zk_at everywhere D5 ran
// far slower than K1 on an H100, where D6, which streams three outputs per
// node, ran the same either way (PERF.md §6).
// D6 reads no row of another band: its halo rows are D5's side rows, and
// its neighbour columns D5's column operands (d and z_prev do not change
// between the two kernels, so one exchange serves both). x', r' and z_k go
// to fresh buffers, as K2's do (csrc/cg_fused.cu: threads of other blocks
// still read z_prev and w at c +- 1).
//
// What bounds them on an H100: the single-device kernels' memory-bound
// sweeps, D5 8 B/node, D6 24 (MSG) or 28 (PCG) B/node, +4 with u; the halo
// operands add 4 (Wb + Hb) reads per block.
#include "common.cuh"

using ist::Geom;
using ist::TW;

namespace {

struct Block {
  int hb, wb, roff, coff, wg;  // extent, global origin, canvas width
};

// z_k = d + beta * z_prev at block-local (i, cc), i in -1 .. hb and cc in
// -1 .. wb, never both outside the block; 0 at a column off the canvas.
__device__ __forceinline__ float zk_at(const float* __restrict__ d, const float* __restrict__ zp,
                                       const float* __restrict__ up,
                                       const float* __restrict__ dn,
                                       const float* __restrict__ left,
                                       const float* __restrict__ right, const Block& b,
                                       float beta, int i, int cc) {
  const int gc = b.coff + cc;
  if (gc < 0 || gc >= b.wg) return 0.f;
  float dv, zv;
  if (cc < 0) {
    dv = left[i];
    zv = left[b.hb + i];
  } else if (cc >= b.wb) {
    dv = right[i];
    zv = right[b.hb + i];
  } else if (i < 0) {
    dv = up[cc];
    zv = up[b.wb + cc];
  } else if (i >= b.hb) {
    dv = dn[cc];
    zv = dn[b.wb + cc];
  } else {
    const size_t k = (size_t)i * b.wb + cc;
    dv = d[k];
    zv = zp[k];
  }
  return ist::direction(dv, beta, zv);
}

// z_k at a node inside the block: the reads of a thread off the block's
// edge columns within its band (no halo, no branch; the same expression).
__device__ __forceinline__ float z_inside(const float* __restrict__ d,
                                          const float* __restrict__ zp, const Block& b,
                                          float beta, int i, int cc) {
  const size_t k = (size_t)i * b.wb + cc;
  return ist::direction(d[k], beta, zp[k]);
}

__global__ void k1_block_kernel(const float* __restrict__ d, const float* __restrict__ zp,
                                const float* __restrict__ beta_p, const float* __restrict__ up,
                                const float* __restrict__ dn, const float* __restrict__ left,
                                const float* __restrict__ right, float* __restrict__ side,
                                float* __restrict__ rz_p, float* __restrict__ azz_p,
                                float* __restrict__ zmax_p, Geom g, Block b, int by) {
  const int c = blockIdx.x * TW + threadIdx.x;
  const int band = blockIdx.y;
  const float beta = *beta_p;
  auto in = [&](int i, int cc) { return ist::interior<false>(g, b.roff + i, b.coff + cc); };
  auto zk = [&](int i, int cc) { return zk_at(d, zp, up, dn, left, right, b, beta, i, cc); };
  auto dv = [&](int i, int cc) { return d[(size_t)i * b.wb + cc]; };
  float s_up, s_dn, s_rz = 0.f, s_azz = 0.f, s_max = 0.f;
  if (c == 0 || c == b.wb - 1) {
    ist::k1_column(g, in, zk, zk, dv, c, band * by, by, s_up, s_dn, s_rz, s_azz, s_max);
  } else {
    auto zin = [&](int i, int cc) { return z_inside(d, zp, b, beta, i, cc); };
    ist::k1_column(g, in, zin, zk, dv, c, band * by, by, s_up, s_dn, s_rz, s_azz, s_max);
  }
  side[((size_t)band * 2 + 0) * b.wb + c] = s_up;
  side[((size_t)band * 2 + 1) * b.wb + c] = s_dn;
  s_rz = ist::block_reduce<false>(s_rz);
  s_azz = ist::block_reduce<false>(s_azz);
  s_max = ist::block_reduce<true>(s_max);
  if (threadIdx.x == 0) {
    const int p = band * gridDim.x + blockIdx.x;
    rz_p[p] = s_rz;
    azz_p[p] = s_azz;
    zmax_p[p] = s_max;
  }
}

// kPcg: z_k = w + beta * z_prev (D6-pcg); else r + beta * z_prev (D6), and w
// is not read. u (may be null) adds the max |x' - u| partial.
template <bool kPcg>
__global__ void k2_block_kernel(const float* __restrict__ x, const float* __restrict__ r,
                                const float* __restrict__ zp, const float* __restrict__ w,
                                const float* __restrict__ left,
                                const float* __restrict__ right,
                                const float* __restrict__ side, const float* __restrict__ scal,
                                const float* __restrict__ u, float* __restrict__ xo,
                                float* __restrict__ ro, float* __restrict__ zo,
                                float* __restrict__ r2_p, float* __restrict__ rmax_p,
                                float* __restrict__ err_p, Geom g, Block b, int by) {
  const int c = blockIdx.x * TW + threadIdx.x;
  const int band = blockIdx.y;
  const float alpha = scal[0];
  const float beta = scal[1];
  const float* __restrict__ dir = kPcg ? w : r;
  auto in = [&](int i, int cc) { return ist::interior<false>(g, b.roff + i, b.coff + cc); };
  // rows outside the block come from the side rows, never through zk
  auto zk = [&](int i, int cc) {
    return zk_at(dir, zp, nullptr, nullptr, left, right, b, beta, i, cc);
  };
  const float s_up = side[((size_t)band * 2 + 0) * b.wb + c];
  const float s_dn = side[((size_t)band * 2 + 1) * b.wb + c];
  float s_r2 = 0.f, s_max = 0.f, s_err = 0.f;
  ist::k2_column(g, in, zk, x, r, u, xo, ro, zo, b.wb, c, band * by, by, s_up, s_dn, alpha,
                 s_r2, s_max, s_err);
  s_r2 = ist::block_reduce<false>(s_r2);
  s_max = ist::block_reduce<true>(s_max);
  if (u != nullptr) s_err = ist::block_reduce<true>(s_err);
  if (threadIdx.x == 0) {
    const int p = band * gridDim.x + blockIdx.x;
    r2_p[p] = s_r2;
    rmax_p[p] = s_max;
    if (u != nullptr) err_p[p] = s_err;
  }
}

}  // namespace

extern "C" int ist_k1_block(const float* d, const float* zp, const float* beta, const float* up,
                            const float* dn, const float* left, const float* right, float* side,
                            float* rz_p, float* azz_p, float* zmax_p, int nx, int ny, int gamma,
                            int hb, int wb, int by, int roff, int coff, int wg, float cd,
                            float cx, float cy, cudaStream_t stream) {
  const Geom g{nx, ny, gamma, hb, wb, cd, cx, cy};
  k1_block_kernel<<<dim3(wb / TW, hb / by), TW, 0, stream>>>(
      d, zp, beta, up, dn, left, right, side, rz_p, azz_p, zmax_p, g,
      Block{hb, wb, roff, coff, wg}, by);
  return (int)cudaGetLastError();
}

extern "C" int ist_k2_block(const float* x, const float* r, const float* zp, const float* left,
                            const float* right, const float* side, const float* scal,
                            const float* u, float* xo, float* ro, float* zo, float* r2_p,
                            float* rmax_p, float* err_p, int nx, int ny, int gamma, int hb,
                            int wb, int by, int roff, int coff, int wg, float cd, float cx,
                            float cy, cudaStream_t stream) {
  const Geom g{nx, ny, gamma, hb, wb, cd, cx, cy};
  k2_block_kernel<false><<<dim3(wb / TW, hb / by), TW, 0, stream>>>(
      x, r, zp, nullptr, left, right, side, scal, u, xo, ro, zo, r2_p, rmax_p, err_p, g,
      Block{hb, wb, roff, coff, wg}, by);
  return (int)cudaGetLastError();
}

extern "C" int ist_k2_pcg_block(const float* x, const float* r, const float* zp, const float* w,
                                const float* left, const float* right, const float* side,
                                const float* scal, const float* u, float* xo, float* ro,
                                float* zo, float* r2_p, float* rmax_p, float* err_p, int nx,
                                int ny, int gamma, int hb, int wb, int by, int roff, int coff,
                                int wg, float cd, float cx, float cy, cudaStream_t stream) {
  const Geom g{nx, ny, gamma, hb, wb, cd, cx, cy};
  k2_block_kernel<true><<<dim3(wb / TW, hb / by), TW, 0, stream>>>(
      x, r, zp, w, left, right, side, scal, u, xo, ro, zo, r2_p, rmax_p, err_p, g,
      Block{hb, wb, roff, coff, wg}, by);
  return (int)cudaGetLastError();
}
