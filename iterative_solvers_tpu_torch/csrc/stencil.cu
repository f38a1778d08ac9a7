// Masked 5-point stencil y = A x on the padded layout.
//
// Replaces iterative_solvers_tpu/kernels/stencil_pallas.py:_make_kernel (A1),
// the apply of the padded operator (the facade's final residual of the
// fused plain-CG solve), and, as stencil_kernel<true>, the custom-mask body
// stencil_pallas.py:_make_kernel_custom (C1).
//
// What bounds it on an H100: a memory-bound sweep, one f32 read of x and one
// f32 write of y: 8 B/node (9 with the int8 mask of a custom domain). Each
// thread owns one column of a band and walks its rows, keeping the rows
// above and below in registers; the column neighbours c +- 1 are re-read
// through L1. The interior mask (the algebraic gamma/rect predicate, or the
// custom int8 mask) is applied to every read and to the output, as A1 did;
// C1 trusts its halo rows to be pre-masked, so on pre-masked input, as every
// solver field is, the two agree.
#include "common.cuh"

using ist::Geom;
using ist::TW;

namespace {

template <bool kMask>
__global__ void stencil_kernel(const float* __restrict__ x, float* __restrict__ y, Geom g,
                               int by) {
  const int wp = g.wp;
  auto in = [&](int i, int cc) { return ist::interior<kMask>(g, i, cc); };
  // masked read; the interior test also keeps every read on the canvas
  auto X = [&](int i, int cc) -> float { return in(i, cc) ? x[(size_t)i * wp + cc] : 0.f; };
  ist::stencil_column(g, in, X, y, wp, blockIdx.x * TW + threadIdx.x, blockIdx.y * by, by);
}

}  // namespace

extern "C" int ist_stencil(const float* x, float* y, int nx, int ny, int gamma, int hp,
                           int wp, int by, float cd, float cx, float cy,
                           cudaStream_t stream) {
  const Geom g{nx, ny, gamma, hp, wp, cd, cx, cy};
  stencil_kernel<false><<<dim3(wp / TW, hp / by), TW, 0, stream>>>(x, y, g, by);
  return (int)cudaGetLastError();
}

extern "C" int ist_stencil_custom(const float* x, float* y, const int8_t* mask, int nx, int ny,
                                  int hp, int wp, int by, float cd, float cx, float cy,
                                  cudaStream_t stream) {
  const Geom g{nx, ny, 0, hp, wp, cd, cx, cy, mask};
  stencil_kernel<true><<<dim3(wp / TW, hp / by), TW, 0, stream>>>(x, y, g, by);
  return (int)cudaGetLastError();
}
