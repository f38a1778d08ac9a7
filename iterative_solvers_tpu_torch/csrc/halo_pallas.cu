// Masked 5-point (D1) and 7-point (D2) stencils on one block of a
// mesh-sharded field.
//
// ist_stencil_block replaces iterative_solvers_tpu/parallel/halo_pallas.py:
// _make_block_kernel / _block_stencil_call (D1); ist_stencil3d_block
// replaces _make_block_kernel_3d / _block_stencil_call_3d (D2).
//
// Each is its single-device kernel run on a block: A1's column sweep
// (ist::stencil_column) and S7's z-march (ist3::zmarch, ist3::apply7), with
// three additions. The block's global origin offsets the algebraic mask;
// the exchanged neighbour rows (D1) or z-planes (D2) are operands; and so
// are the exchanged neighbour columns, which a thread at the block's edge
// reads where the single-device kernel reads its neighbour column. (The
// TPU kernels zero the wrapped lane of their lane roll and add the
// neighbour columns afterwards as edge strips.) So every node of a block,
// edge or not, takes the single-device expression, and stitched blocks
// equal the single-device apply bit for bit. Every read is masked at its
// node's global position: the halos are raw values, and a halo that wraps
// around the grid lands on non-interior nodes and reads as 0.
//
// What bounds them on an H100: A1's and S7's memory-bound sweeps, 8 B/node
// (one f32 read of x, one f32 write of y); the halo operands add
// 2 (Wb + Hb) (D1) or 2 (Hp Wb + Dz_b Hp) (D2) reads per block.
#include "common.cuh"
#include "zmarch3d.cuh"

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

__global__ void stencil3d_block_kernel(const float* __restrict__ x,
                                       const float* __restrict__ zup,
                                       const float* __restrict__ zdn,
                                       const float* __restrict__ left,
                                       const float* __restrict__ right, float* __restrict__ y,
                                       ist3::Box g, ist3::Coef k, int zoff, int coff) {
  // g: the block (d = Dz_b planes, hp rows, wp = Wb columns) with the
  // global interval counts; interior tests take global z and x
  auto in = [&](int z, int r, int c) { return g.interior(zoff + z, r, coff + c); };
  auto X = [&](int z, int r, int c) -> float {
    if (!in(z, r, c)) return 0.f;
    if (c < 0) return left[(size_t)z * g.hp + r];
    if (c >= g.wp) return right[(size_t)z * g.hp + r];
    if (z < 0) return zup[(size_t)r * g.wp + c];
    if (z >= g.d) return zdn[(size_t)r * g.wp + c];
    return x[g.at(z, r, c)];
  };
  const int z0 = blockIdx.z * g.bz;
  ist3::zmarch(z0, min(z0 + g.bz, g.d), X, [&](int z, int r, int c, const ist3::Nbr& v) {
    if (g.on_canvas(r, c)) y[g.at(z, r, c)] = in(z, r, c) ? ist3::apply7(k, v) : 0.f;
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

extern "C" int ist_stencil3d_block(const float* x, const float* zup, const float* zdn,
                                   const float* left, const float* right, float* y, int nx,
                                   int ny, int nz, int dzb, int hp, int wb, int bz, int zoff,
                                   int coff, float cd, float cx, float cy, float cz,
                                   cudaStream_t stream) {
  const ist3::Box g{nx, ny, nz, dzb, hp, wb, bz};
  stencil3d_block_kernel<<<ist3::grid_dim(g, dzb), ist3::block_dim(), 0, stream>>>(
      x, zup, zdn, left, right, y, g, ist3::Coef{cd, cx, cy, cz}, zoff, coff);
  return (int)cudaGetLastError();
}
