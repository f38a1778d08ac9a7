// Masked 5-point (D1) and 7-point (D2) stencils on one block of a
// mesh-sharded field.
//
// ist_stencil_block replaces the JAX package's parallel/halo_pallas.py:
// _make_block_kernel / _block_stencil_call (D1); ist_stencil3d_block
// replaces _make_block_kernel_3d / _block_stencil_call_3d (D2).
//
// D1 is A1's arithmetic (ist::stencil_rn) in a column sweep on the block
// (ist::stencil_column); D2 is S7's arithmetic (ist3::apply7) on the staged
// z-march of csrc/zstream3d.cuh. Each has three additions. The block's
// global origin offsets the algebraic mask; the exchanged neighbour rows
// (D1) or z-planes (D2) are operands; and so are the exchanged neighbour
// columns, which D1's thread at the block's edge reads where the
// single-device kernel reads its neighbour column, and D2's tiles at the
// block's x edge stage where the single-device march stages its own. (The
// TPU kernels zero the wrapped lane of their lane roll and add the
// neighbour columns afterwards as edge strips.) So every node of a block,
// edge or not, takes the single-device expression, and stitched blocks
// equal the single-device apply bit for bit. Every read is masked at its
// node's global position: the halos are raw values, and a halo that wraps
// around the grid lands on non-interior nodes and reads as 0.
//
// What bounds them on an H100: A1's and S7's memory-bound sweeps, 8 B/node
// (one f32 read of x, one f32 write of y); the halo operands add
// 2 (Wb + Hb) (D1) or 2 (Hp Wb + Dz_b Hp) (D2) reads per block. D2's
// design: on S7's z-march (one node a thread, 4-byte loads, each read
// behind a five-way branch on its source, two barriers a plane) it ran at
// 24 % of that bound at 512^3 (NVIDIA H100 80GB HBM3, 700 W; PERF.md); the
// staged march streams 16 bytes a lane from a cp.async ring kLook planes
// deep, with one barrier a plane, and picks each staged plane's source once
// per plane (72-73 % there).
#include "common.cuh"
#include "zstream3d.cuh"

using ist::Geom;
using ist::TW;

namespace {

__global__ void stencil_block_kernel(const float* __restrict__ x, const float* __restrict__ up,
                                     const float* __restrict__ dn,
                                     const float* __restrict__ left,
                                     const float* __restrict__ right, float* __restrict__ y,
                                     Geom g, int by, int roff, int coff) {
  const int hb = g.hp, wb = g.wp;  // the block's extent (the mask uses nx, ny only)
  auto in = [&](int i, int cc) { return ist::interior<false>(g, roff + i, coff + cc); };
  auto X = [&](int i, int cc) -> float {
    if (!in(i, cc)) return 0.f;
    if (cc < 0) return left[i];
    if (cc >= wb) return right[i];
    if (i < 0) return up[cc];
    if (i >= hb) return dn[cc];
    return x[(size_t)i * wb + cc];
  };
  ist::stencil_column(g, in, X, y, wb, blockIdx.x * TW + threadIdx.x, blockIdx.y * by, by);
}

// D2: S7's arithmetic on the staged z-march (csrc/zstream3d.cuh). Planes
// -1 and Dz_b are staged from zup and zdn, the halo columns by the block's
// x-edge tiles; every read is masked at its node's global position by the
// copies' zero-fill and the march's column mask, so each node takes S7's
// fmaf chain on S7's values.
__global__ void __launch_bounds__(ist3::kZThreads)
    stencil3d_block_kernel(const float* __restrict__ x, const float* __restrict__ zup,
                           const float* __restrict__ zdn, const float* __restrict__ left,
                           const float* __restrict__ right, float* __restrict__ y, ist3::Box g,
                           ist3::Coef k, int zoff, int coff) {
  extern __shared__ __align__(16) float smem[];
  const ist3::ZSource src[1] = {{x, zup, zdn, left, right}};
  ist3::zstream<1>(g, zoff, coff, src, smem,
                   [&](int t, int r, int c, const bool (&in)[4], const ist3::Nbr4 (&v)[1]) {
                     ist3::F4 o;
#pragma unroll
                     for (int e = 0; e < 4; ++e)
                       o.v[e] = in[e] ? ist3::apply7(k, v[0].at(e)) : 0.f;
                     ist3::st4(y + g.at(t, r, c), o);
                   });
}

}  // namespace

extern "C" int ist_stencil_block(const float* x, const float* up, const float* dn,
                                 const float* left, const float* right, float* y, int nx,
                                 int ny, int gamma, int hb, int wb, int by, int roff, int coff,
                                 float cd, float cx, float cy, cudaStream_t stream) {
  const Geom g{nx, ny, gamma, hb, wb, cd, cx, cy};
  stencil_block_kernel<<<dim3(wb / TW, hb / by), TW, 0, stream>>>(x, up, dn, left, right, y, g,
                                                                  by, roff, coff);
  return (int)cudaGetLastError();
}

// bz: planes per block (kernels/stencil3d_layout.py: zstream_chunk)
extern "C" int ist_stencil3d_block(const float* x, const float* zup, const float* zdn,
                                   const float* left, const float* right, float* y, int nx,
                                   int ny, int nz, int dzb, int hp, int wb, int bz, int zoff,
                                   int coff, float cd, float cx, float cy, float cz,
                                   cudaStream_t stream) {
  const ist3::Box g{nx, ny, nz, dzb, hp, wb, bz};
  if (!ist3::zstream_fits(g)) return (int)cudaErrorInvalidValue;
  const size_t smem = ist3::zstream_smem(1);
  if (int e = (int)cudaFuncSetAttribute((const void*)stencil3d_block_kernel,
                                        cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem))
    return e;
  stencil3d_block_kernel<<<ist3::zstream_grid(g), ist3::kZThreads, smem, stream>>>(
      x, zup, zdn, left, right, y, g, ist3::Coef{cd, cx, cy, cz}, zoff, coff);
  return (int)cudaGetLastError();
}
