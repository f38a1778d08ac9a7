// Masked 7-point stencil y = A x on the padded 3D layout (S7).
//
// Replaces iterative_solvers_tpu/kernels/stencil3d_pallas.py:_make_kernel_3d
// (B1, one z-plane per program) and _make_kernel_3d_chunked (B2, bz planes
// per program): the same function, split on the TPU only by what fit in
// VMEM. It is the inner PCG's A z and the plain f32 CG baseline's operator.
//
// What bounds it on an H100: a memory-bound sweep, one f32 read of x and one
// f32 write of y: 8 B/node, 8 f32 operations. The design is D2's
// (csrc/halo_pallas.cu) without halo operands: the staged z-march of
// csrc/zstream3d.cuh, 8 x 128 tiles, one warp a row and four columns a lane,
// each plane of x and its halo staged by 16-byte cp.async copies issued
// kLook planes ahead, one barrier a plane, y stored as one float4 a lane.
// Reads are masked by the copies' zero-fill, the output by the box
// predicate. The node update is the fmaf chain of ist3::apply7, XLA's
// order, so the kernel equals its plain version (ops/stencil.py:
// stencil_apply_3d) bit for bit.
#include "zstream3d.cuh"

namespace {

__global__ void __launch_bounds__(ist3::kZThreads)
    stencil3d_kernel(const float* __restrict__ x, float* __restrict__ y, ist3::Box g,
                     ist3::Coef k) {
  extern __shared__ __align__(16) float smem[];
  const ist3::ZSource src[1] = {{x}};
  ist3::zstream<1>(g, 0, 0, src, smem,
                   [&](int t, int r, int c, const bool (&in)[4], const ist3::Nbr4 (&v)[1]) {
                     ist3::F4 o;
#pragma unroll
                     for (int e = 0; e < 4; ++e)
                       o.v[e] = in[e] ? ist3::apply7(k, v[0].at(e)) : 0.f;
                     ist3::st4(y + g.at(t, r, c), o);
                   });
}

}  // namespace

// bz: planes per block (kernels/stencil3d_layout.py: zstream_chunk)
extern "C" int ist_stencil3d(const float* x, float* y, int nx, int ny, int nz, int d, int hp,
                             int wp, int bz, float cd, float cx, float cy, float cz,
                             cudaStream_t stream) {
  const ist3::Box g{nx, ny, nz, d, hp, wp, bz};
  if (!ist3::zstream_fits(g)) return (int)cudaErrorInvalidValue;
  const size_t smem = ist3::zstream_smem(1);
  if (int e = (int)cudaFuncSetAttribute((const void*)stencil3d_kernel,
                                        cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem))
    return e;
  stencil3d_kernel<<<ist3::zstream_grid(g), ist3::kZThreads, smem, stream>>>(
      x, y, g, ist3::Coef{cd, cx, cy, cz});
  return (int)cudaGetLastError();
}
