// Fused CG / PCG iteration kernels K1, K2 and K2-pcg.
//
// K1 replaces the JAX package's kernels/cg_fused.py:_make_k1 (A2);
// K2 replaces cg_fused.py:_make_k2 (A3, plain CG);
// K2-pcg replaces cg_fused.py:_make_k2_pcg (A4).
// Their kMask = true instantiations (the *_custom launchers) replace the same
// bodies with custom=True, which take the int8 interior mask as an operand:
// +1 B/node each. Those trust the fields to be pre-masked and check the
// halo rows for band validity only; the halo rows here are masked by their
// own row's mask, which agrees on pre-masked fields (every solver field is).
//
// What bounds them on an H100: all are memory-bound stencil sweeps with no
// tensor-core work. K1 reads two f32 streams (d, z_prev; 8 B/node) and writes
// only per-block partial sums plus two halo rows per band. K2-pcg reads four
// streams (x, r, z_prev, w) and writes three (x', r', z_k): 28 B/node. K2 is
// the same kernel with the direction built from r itself (z_k = r + beta *
// z_prev): three reads, three writes, 24 B/node. With a true solution u
// (one more read, +4 B/node) both also emit per-block max |x' - u|. The
// product A z_k is formed on chip in both kernels and never stored, so Az
// costs no device-memory traffic at all; the stencil is simply evaluated
// twice per iteration.
//
// Bands: the TPU's band of `by` rows (the JAX package's VMEM rule, kept so
// that padded fields compare like for like) is the unit of the halo
// contract. A band's rows row0-1 and row0+by of z_k are written by K1 into a
// side buffer (2, wp) per band and read back by K2, which therefore reads no
// row of another band's direction; the rows just outside a band are masked
// by their own row, the rows and columns inside it are read raw.
//
// The design (csrc/cg_tiles.cuh, shared with the mesh blocks D5/D6): a
// CUDA block owns a tile of TJ rows x 128 columns (kernels/cg_fused.
// tile_grid), so that a small grid fills the card (1024²: 720 K1 and 1440
// K2 blocks, where one block per band column gave 45); it stages the
// tile's z_k once into shared memory from 16-byte loads, then each warp
// sweeps its rows with the rows above and below in registers and the
// column neighbours by shuffles. One partial per block.
#include "cg_tiles.cuh"

using ist::Geom;
using ist_tiles::Halo;
using ist_tiles::launch_k1;
using ist_tiles::launch_k2;

extern "C" int ist_k1(const float* d, const float* zp, const float* beta, float* side,
                      float* rz_p, float* azz_p, float* zmax_p, int nx, int ny, int gamma,
                      int hp, int wp, int by, int tj, float cd, float cx, float cy,
                      cudaStream_t stream) {
  const Geom g{nx, ny, gamma, hp, wp, cd, cx, cy};
  return launch_k1<false, false>(d, zp, beta, side, rz_p, azz_p, zmax_p, g, Halo{}, by, tj,
                                 stream);
}

extern "C" int ist_k1_custom(const float* d, const float* zp, const float* beta, float* side,
                             float* rz_p, float* azz_p, float* zmax_p, const int8_t* mask,
                             int nx, int ny, int hp, int wp, int by, int tj, float cd, float cx,
                             float cy, cudaStream_t stream) {
  const Geom g{nx, ny, 0, hp, wp, cd, cx, cy, mask};
  return launch_k1<true, false>(d, zp, beta, side, rz_p, azz_p, zmax_p, g, Halo{}, by, tj,
                                stream);
}

extern "C" int ist_k2(const float* x, const float* r, const float* zp, const float* side,
                      const float* scal, const float* u, float* xo, float* ro, float* zo,
                      float* r2_p, float* rmax_p, float* err_p, int nx, int ny, int gamma,
                      int hp, int wp, int by, int tj, float cd, float cx, float cy,
                      cudaStream_t stream) {
  const Geom g{nx, ny, gamma, hp, wp, cd, cx, cy};
  return launch_k2<false, false, false>(x, r, zp, nullptr, side, scal, u, xo, ro, zo, r2_p,
                                        rmax_p, err_p, g, Halo{}, by, tj, stream);
}

extern "C" int ist_k2_custom(const float* x, const float* r, const float* zp, const float* side,
                             const float* scal, const float* u, float* xo, float* ro,
                             float* zo, float* r2_p, float* rmax_p, float* err_p,
                             const int8_t* mask, int nx, int ny, int hp, int wp, int by, int tj,
                             float cd, float cx, float cy, cudaStream_t stream) {
  const Geom g{nx, ny, 0, hp, wp, cd, cx, cy, mask};
  return launch_k2<false, true, false>(x, r, zp, nullptr, side, scal, u, xo, ro, zo, r2_p,
                                       rmax_p, err_p, g, Halo{}, by, tj, stream);
}

extern "C" int ist_k2_pcg(const float* x, const float* r, const float* zp, const float* w,
                          const float* side, const float* scal, const float* u, float* xo,
                          float* ro, float* zo, float* r2_p, float* rmax_p, float* err_p,
                          int nx, int ny, int gamma, int hp, int wp, int by, int tj, float cd,
                          float cx, float cy, cudaStream_t stream) {
  const Geom g{nx, ny, gamma, hp, wp, cd, cx, cy};
  return launch_k2<true, false, false>(x, r, zp, w, side, scal, u, xo, ro, zo, r2_p, rmax_p,
                                       err_p, g, Halo{}, by, tj, stream);
}

extern "C" int ist_k2_pcg_custom(const float* x, const float* r, const float* zp,
                                 const float* w, const float* side, const float* scal,
                                 const float* u, float* xo, float* ro, float* zo, float* r2_p,
                                 float* rmax_p, float* err_p, const int8_t* mask, int nx,
                                 int ny, int hp, int wp, int by, int tj, float cd, float cx,
                                 float cy, cudaStream_t stream) {
  const Geom g{nx, ny, 0, hp, wp, cd, cx, cy, mask};
  return launch_k2<true, true, false>(x, r, zp, w, side, scal, u, xo, ro, zo, r2_p, rmax_p,
                                      err_p, g, Halo{}, by, tj, stream);
}
