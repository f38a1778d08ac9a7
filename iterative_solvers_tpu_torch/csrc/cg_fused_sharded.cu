// The fused CG / PCG iteration on one block of a mesh-sharded field: block
// K1 (D5) and block K2 / K2-pcg (D6).
//
// ist_k1_block replaces the JAX package's parallel/cg_fused_sharded.py:
// _make_k1_block / _k1_call (D5); ist_k2_block and ist_k2_pcg_block replace
// _make_k2_block / _k2_call (D6, pcg=False / True).
//
// Each is its single-device tile kernel (K1, A2; K2, A3/A4) instantiated
// with kBlock (csrc/cg_tiles.cuh) on the block as a canvas of its own: the
// block's global origin (roff, coff) shifts the interior test, and the
// exchanged neighbour rows and columns of the direction's ingredients d (r
// for MSG CG, w = M r for PCG) and z_prev are operands: up / dn (2, Wb)
// hold rows -1 and Hb of d (row 0) and z_prev (row 1), left / right (2, Hb)
// columns -1 and Wb. A tile forms z_k = d + beta * z_prev at a neighbour
// node by the helper the owning block uses, so every node takes the
// single-device arithmetic and the stitched blocks equal K1 / K2 / K2-pcg
// bit for bit; the partials cover the whole block, one per tile. The TPU
// kernels zero the wrapped lane of their lane rolls and correct the edge
// columns afterwards ((A z, z) edge terms, r' edge strips and the |r'|^2,
// max |r'| partials without the edge lanes); that fix-up has no
// counterpart here.
// D6 reads no row of another band: its halo rows are D5's side rows, and
// its neighbour columns D5's column operands (d and z_prev do not change
// between the two kernels, so one exchange serves both). x', r' and z_k go
// to fresh buffers, as K2's do.
//
// What bounds them on an H100: the single-device kernels' memory-bound
// sweeps, D5 8 B/node, D6 24 (MSG) or 28 (PCG) B/node, +4 with u; the halo
// operands add 16 (Wb + Hb) bytes read per block for D5 and 16 Hb for D6,
// and only the tiles at the block's edges read them (2 TJ threads of a
// tile in an edge strip, the lanes of D5's first and last rows). The grid
// is K1's and K2's on a Hb x Wb canvas (kernels/cg_fused.tile_grid): at
// the 1152 x 1152 block of a 1024² grid
// on one rank (and of 2048² on each rank of a (2, 2) mesh), 648 D5 tiles
// of 16 rows and 1296 D6 tiles of 8 rows, where one block per 128-row band
// and 128 columns gave 81 for the 132 SMs.
#include "cg_tiles.cuh"

using ist::Geom;
using ist_tiles::Halo;
using ist_tiles::launch_k1;
using ist_tiles::launch_k2;

extern "C" int ist_k1_block(const float* d, const float* zp, const float* beta, const float* up,
                            const float* dn, const float* left, const float* right, float* side,
                            float* rz_p, float* azz_p, float* zmax_p, int nx, int ny, int gamma,
                            int hb, int wb, int by, int tj, int roff, int coff, int wg,
                            float cd, float cx, float cy, cudaStream_t stream) {
  const Geom g{nx, ny, gamma, hb, wb, cd, cx, cy};
  return launch_k1<false, true>(d, zp, beta, side, rz_p, azz_p, zmax_p, g,
                                Halo{up, dn, left, right, roff, coff, wg}, by, tj, stream);
}

extern "C" int ist_k2_block(const float* x, const float* r, const float* zp, const float* left,
                            const float* right, const float* side, const float* scal,
                            const float* u, float* xo, float* ro, float* zo, float* r2_p,
                            float* rmax_p, float* err_p, int nx, int ny, int gamma, int hb,
                            int wb, int by, int tj, int roff, int coff, int wg, float cd,
                            float cx, float cy, cudaStream_t stream) {
  const Geom g{nx, ny, gamma, hb, wb, cd, cx, cy};
  return launch_k2<false, false, true>(x, r, zp, nullptr, side, scal, u, xo, ro, zo, r2_p,
                                       rmax_p, err_p, g,
                                       Halo{nullptr, nullptr, left, right, roff, coff, wg}, by,
                                       tj, stream);
}

extern "C" int ist_k2_pcg_block(const float* x, const float* r, const float* zp, const float* w,
                                const float* left, const float* right, const float* side,
                                const float* scal, const float* u, float* xo, float* ro,
                                float* zo, float* r2_p, float* rmax_p, float* err_p, int nx,
                                int ny, int gamma, int hb, int wb, int by, int tj, int roff,
                                int coff, int wg, float cd, float cx, float cy,
                                cudaStream_t stream) {
  const Geom g{nx, ny, gamma, hb, wb, cd, cx, cy};
  return launch_k2<true, false, true>(x, r, zp, w, side, scal, u, xo, ro, zo, r2_p, rmax_p,
                                      err_p, g,
                                      Halo{nullptr, nullptr, left, right, roff, coff, wg}, by,
                                      tj, stream);
}
