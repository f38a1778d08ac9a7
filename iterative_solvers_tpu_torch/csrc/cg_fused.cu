// Fused CG / PCG iteration kernels K1, K2 and K2-pcg.
//
// K1 replaces iterative_solvers_tpu/kernels/cg_fused.py:_make_k1 (A2);
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
// direction z_k = d + beta * z_prev and the product A z_k are formed in
// registers in both kernels and never stored, so Az costs no device-memory
// traffic at all; the stencil is simply evaluated twice per iteration.
//
// The column sweeps are ist::k1_column / ist::k2_column (common.cuh), which
// the mesh-block forms D5 / D6 (csrc/cg_fused_sharded.cu) share.
//
// Halos: a band's rows row0-1 and row0+by of z_k are written by K1 into a
// side buffer (2, wp) per band and read back by K2, which therefore reads no
// row of another band's direction. K1 and K2 tile rows identically (band
// height `by`, full padded width per band). Within a band, column
// neighbours are recomputed from the read-only inputs.
//
// In-place race: the TPU kernel wrote x, r and z in place, legal there
// because a whole block sat in VMEM before any write. Here threads of other
// blocks may still read z_prev and w at c +- 1 while one writes, so K2 writes
// x', r' and z_k to fresh buffers (the caller swaps them in). On CUDA a
// fresh buffer costs the same write traffic as an in-place one.
#include "common.cuh"

using ist::Geom;
using ist::TW;

namespace {

template <bool kMask>
__global__ void k1_kernel(const float* __restrict__ d, const float* __restrict__ zp,
                          const float* __restrict__ beta_p, float* __restrict__ side,
                          float* __restrict__ rz_p, float* __restrict__ azz_p,
                          float* __restrict__ zmax_p, Geom g, int by) {
  const int c = blockIdx.x * TW + threadIdx.x;
  const int band = blockIdx.y;
  const int wp = g.wp;
  const float beta = *beta_p;
  auto in = [&](int r, int cc) { return ist::interior<kMask>(g, r, cc); };
  auto zk = [&](int r, int cc) -> float {
    if (cc < 0 || cc >= wp) return 0.f;
    const size_t i = (size_t)r * wp + cc;
    return d[i] + beta * zp[i];
  };
  auto dv = [&](int r, int cc) { return d[(size_t)r * wp + cc]; };
  float up, dn, s_rz = 0.f, s_azz = 0.f, s_max = 0.f;
  ist::k1_column(g, in, zk, zk, dv, c, band * by, by, up, dn, s_rz, s_azz, s_max);
  side[((size_t)band * 2 + 0) * wp + c] = up;
  side[((size_t)band * 2 + 1) * wp + c] = dn;
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

// kPcg: z_k = w + beta * z_prev (A4); else z_k = r + beta * z_prev (A3), and
// w is not read. u (may be null) adds the max |x' - u| partial.
template <bool kPcg, bool kMask>
__global__ void k2_kernel(const float* __restrict__ x, const float* __restrict__ r,
                          const float* __restrict__ zp, const float* __restrict__ w,
                          const float* __restrict__ side, const float* __restrict__ scal,
                          const float* __restrict__ u, float* __restrict__ xo,
                          float* __restrict__ ro, float* __restrict__ zo,
                          float* __restrict__ r2_p, float* __restrict__ rmax_p,
                          float* __restrict__ err_p, Geom g, int by) {
  const int c = blockIdx.x * TW + threadIdx.x;
  const int band = blockIdx.y;
  const int wp = g.wp;
  const float alpha = scal[0];
  const float beta = scal[1];
  const float* __restrict__ dir = kPcg ? w : r;
  auto in = [&](int rr, int cc) { return ist::interior<kMask>(g, rr, cc); };
  auto zk = [&](int rr, int cc) -> float {
    if (cc < 0 || cc >= wp) return 0.f;
    const size_t i = (size_t)rr * wp + cc;
    return dir[i] + beta * zp[i];
  };
  float s_r2 = 0.f, s_max = 0.f, s_err = 0.f;
  ist::k2_column(g, in, zk, x, r, u, xo, ro, zo, wp, c, band * by, by,
                 side[((size_t)band * 2 + 0) * wp + c], side[((size_t)band * 2 + 1) * wp + c],
                 alpha, s_r2, s_max, s_err);
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

extern "C" int ist_k1(const float* d, const float* zp, const float* beta, float* side,
                      float* rz_p, float* azz_p, float* zmax_p, int nx, int ny, int gamma,
                      int hp, int wp, int by, float cd, float cx, float cy,
                      cudaStream_t stream) {
  const Geom g{nx, ny, gamma, hp, wp, cd, cx, cy};
  k1_kernel<false><<<dim3(wp / TW, hp / by), TW, 0, stream>>>(d, zp, beta, side, rz_p, azz_p,
                                                              zmax_p, g, by);
  return (int)cudaGetLastError();
}

extern "C" int ist_k1_custom(const float* d, const float* zp, const float* beta, float* side,
                             float* rz_p, float* azz_p, float* zmax_p, const int8_t* mask,
                             int nx, int ny, int hp, int wp, int by, float cd, float cx,
                             float cy, cudaStream_t stream) {
  const Geom g{nx, ny, 0, hp, wp, cd, cx, cy, mask};
  k1_kernel<true><<<dim3(wp / TW, hp / by), TW, 0, stream>>>(d, zp, beta, side, rz_p, azz_p,
                                                             zmax_p, g, by);
  return (int)cudaGetLastError();
}

extern "C" int ist_k2(const float* x, const float* r, const float* zp, const float* side,
                      const float* scal, const float* u, float* xo, float* ro, float* zo,
                      float* r2_p, float* rmax_p, float* err_p, int nx, int ny, int gamma,
                      int hp, int wp, int by, float cd, float cx, float cy,
                      cudaStream_t stream) {
  const Geom g{nx, ny, gamma, hp, wp, cd, cx, cy};
  k2_kernel<false, false><<<dim3(wp / TW, hp / by), TW, 0, stream>>>(
      x, r, zp, nullptr, side, scal, u, xo, ro, zo, r2_p, rmax_p, err_p, g, by);
  return (int)cudaGetLastError();
}

extern "C" int ist_k2_custom(const float* x, const float* r, const float* zp, const float* side,
                             const float* scal, const float* u, float* xo, float* ro,
                             float* zo, float* r2_p, float* rmax_p, float* err_p,
                             const int8_t* mask, int nx, int ny, int hp, int wp, int by,
                             float cd, float cx, float cy, cudaStream_t stream) {
  const Geom g{nx, ny, 0, hp, wp, cd, cx, cy, mask};
  k2_kernel<false, true><<<dim3(wp / TW, hp / by), TW, 0, stream>>>(
      x, r, zp, nullptr, side, scal, u, xo, ro, zo, r2_p, rmax_p, err_p, g, by);
  return (int)cudaGetLastError();
}

extern "C" int ist_k2_pcg(const float* x, const float* r, const float* zp, const float* w,
                          const float* side, const float* scal, const float* u, float* xo,
                          float* ro, float* zo, float* r2_p, float* rmax_p, float* err_p,
                          int nx, int ny, int gamma, int hp, int wp, int by, float cd,
                          float cx, float cy, cudaStream_t stream) {
  const Geom g{nx, ny, gamma, hp, wp, cd, cx, cy};
  k2_kernel<true, false><<<dim3(wp / TW, hp / by), TW, 0, stream>>>(
      x, r, zp, w, side, scal, u, xo, ro, zo, r2_p, rmax_p, err_p, g, by);
  return (int)cudaGetLastError();
}

extern "C" int ist_k2_pcg_custom(const float* x, const float* r, const float* zp,
                                 const float* w, const float* side, const float* scal,
                                 const float* u, float* xo, float* ro, float* zo, float* r2_p,
                                 float* rmax_p, float* err_p, const int8_t* mask, int nx,
                                 int ny, int hp, int wp, int by, float cd, float cx, float cy,
                                 cudaStream_t stream) {
  const Geom g{nx, ny, 0, hp, wp, cd, cx, cy, mask};
  k2_kernel<true, true><<<dim3(wp / TW, hp / by), TW, 0, stream>>>(
      x, r, zp, w, side, scal, u, xo, ro, zo, r2_p, rmax_p, err_p, g, by);
  return (int)cudaGetLastError();
}
