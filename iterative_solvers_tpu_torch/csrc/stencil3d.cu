// Masked 7-point stencil y = A x on the padded 3D layout (S7).
//
// Replaces iterative_solvers_tpu/kernels/stencil3d_pallas.py:_make_kernel_3d
// (B1, one z-plane per program) and _make_kernel_3d_chunked (B2, bz planes
// per program): the same function, split on the TPU only by what fit in
// VMEM. It is the inner PCG's A z and the plain f32 CG baseline's operator.
//
// What bounds it on an H100: a memory-bound sweep, one f32 read of x and one
// f32 write of y: 8 B/node, 8 f32 operations. The z-march
// (csrc/zmarch3d.cuh) reads each plane of x once per chunk: the y/x
// neighbours come from a shared tile of the current plane, the z
// neighbours from the thread's registers. Reads and the output are masked by
// the algebraic box predicate. The node update is the fmaf chain of
// ist3::apply7, XLA's order, so the kernel equals its plain version
// (ops/stencil.py: stencil_apply_3d) bit for bit.
#include "zmarch3d.cuh"

using ist3::Box;
using ist3::Coef;
using ist3::Nbr;

namespace {

__global__ void stencil3d_kernel(const float* __restrict__ x, float* __restrict__ y, Box g,
                                 Coef k) {
  const int z0 = blockIdx.z * g.bz;
  auto X = [&](int z, int r, int c) -> float {
    return g.interior(z, r, c) ? x[g.at(z, r, c)] : 0.f;
  };
  ist3::zmarch(z0, min(z0 + g.bz, g.d), X, [&](int z, int r, int c, const Nbr& v) {
    if (g.on_canvas(r, c)) y[g.at(z, r, c)] = g.interior(z, r, c) ? ist3::apply7(k, v) : 0.f;
  });
}

}  // namespace

extern "C" int ist_stencil3d(const float* x, float* y, int nx, int ny, int nz, int d, int hp,
                             int wp, int bz, float cd, float cx, float cy, float cz,
                             cudaStream_t stream) {
  const Box g{nx, ny, nz, d, hp, wp, bz};
  stencil3d_kernel<<<ist3::grid_dim(g, d), ist3::block_dim(), 0, stream>>>(
      x, y, g, Coef{cd, cx, cy, cz});
  return (int)cudaGetLastError();
}
