// The fused V-cycle legs on one block of a mesh-sharded level: K_down (D3)
// and K_up with its optional dot epilogue (D4).
//
// ist_k_down_block replaces iterative_solvers_tpu/parallel/mg_sharded.py:
// _make_k_down_block / _k_down_call (D3); ist_k_up_block replaces
// _make_k_up_block / _k_up_call (D4).
//
// Each runs a column sweep (ist::k_down_column; ist::k_up_column with
// ist::corrected) on a block whose global origin (roff, coff; roff even)
// offsets the mask and the row parity, with the exchanged neighbour rows
// and columns as operands. The sweeps call the per-node helpers that A5's
// and A6's tiles call (csrc/common.cuh), so every node takes the
// single-device expression: stitched blocks, through the lane transfers
// the mesh runs between its legs, equal A5 / A6 bit for bit. The TPU
// kernels zero the wrapped lane and correct the edge columns afterwards
// (edge strips, and a dot partial without the edge lanes); here the edge
// columns read their neighbours directly and the dot partial covers the
// whole block.
//
// Halo operands, raw values (every read is masked at its global node):
// - D3 reads b at rows -2 .. Hb (two rows above the block, one below) and,
//   for the residual rows -1 .. Hb - 1, the neighbour columns -1 and Wb;
//   the sender of a column puts its received row -1 in front (the corner).
// - D4 reads b at rows -1 .. Hb, the coarse correction ec at coarse rows
//   goff - 1 .. goff + Hb/2 (goff = roff / 2), and at the neighbour
//   columns b for rows 0 .. Hb - 1 and ec for coarse rows goff .. goff +
//   Hb/2 (the last one the sender's received row below: the corner). The
//   corrected iterate at the neighbour column is formed here, by the same
//   expression as inside the block.
//
// What bounds them on an H100: memory, 6 and 10 B/node (the row-restricted
// residual out, the lane-prolonged correction in); the halo operands add
// O(Hb + Wb) reads per block.
#include "common.cuh"

using ist::Geom;
using ist::TW;

namespace {

__global__ void k_down_block_kernel(const float* __restrict__ b, const float* __restrict__ up2,
                                    const float* __restrict__ dn,
                                    const float* __restrict__ left,
                                    const float* __restrict__ right, float* __restrict__ rr,
                                    Geom g, float cs, int by, int roff, int coff) {
  const int hb = g.hp, wb = g.wp;
  auto in = [&](int i, int cc) { return ist::interior<false>(g, roff + i, coff + cc); };
  auto B = [&](int i, int cc) -> float {
    if (!in(i, cc)) return 0.f;
    if (cc < 0) return left[i + 1];  // rows -1 .. hb - 1
    if (cc >= wb) return right[i + 1];
    if (i < 0) return up2[(size_t)(i + 2) * wb + cc];  // rows -2, -1
    if (i >= hb) return dn[cc];
    return b[(size_t)i * wb + cc];
  };
  ist::k_down_column(g, in, B, cs, rr, wb, blockIdx.x * TW + threadIdx.x, blockIdx.y * by, by);
}

__global__ void k_up_block_kernel(const float* __restrict__ b, const float* __restrict__ bup,
                                  const float* __restrict__ bdn,
                                  const float* __restrict__ bleft,
                                  const float* __restrict__ bright,
                                  const float* __restrict__ ec, const float* __restrict__ ecup,
                                  const float* __restrict__ ecdn,
                                  const float* __restrict__ ecleft,
                                  const float* __restrict__ ecright, float* __restrict__ out,
                                  float* __restrict__ dot_p, Geom g, float cs, int by, int ch,
                                  int roff, int coff) {
  const int hb = g.hp, wb = g.wp, hc = hb / 2, goff = roff / 2;
  auto in = [&](int i, int cc) { return ist::interior<false>(g, roff + i, coff + cc); };
  auto Bv = [&](int i, int cc) -> float {  // raw b at a node the caller found interior
    if (cc < 0) return bleft[i];
    if (cc >= wb) return bright[i];
    if (i < 0) return bup[cc];
    if (i >= hb) return bdn[cc];
    return b[(size_t)i * wb + cc];
  };
  auto XC = [&](int i, int cc) -> float {
    if (!in(i, cc)) return 0.f;
    // coarse correction at global coarse row J; rows outside [0, ch) are zero
    auto EC = [&](int J) -> float {
      if (J < 0 || J >= ch) return 0.f;
      const int j = J - goff;  // -1 .. hc
      if (cc < 0) return ecleft[j];
      if (cc >= wb) return ecright[j];
      if (j < 0) return ecup[cc];
      if (j >= hc) return ecdn[cc];
      return ec[(size_t)j * wb + cc];
    };
    return ist::corrected(cs, roff + i, Bv(i, cc), EC);
  };
  float s_dot = ist::k_up_column(g, in, XC, Bv, cs, out, wb, blockIdx.x * TW + threadIdx.x,
                                 blockIdx.y * by, by);
  if (dot_p != nullptr) {
    s_dot = ist::block_reduce<false>(s_dot);
    if (threadIdx.x == 0) dot_p[blockIdx.y * gridDim.x + blockIdx.x] = s_dot;
  }
}

}  // namespace

extern "C" int ist_k_down_block(const float* b, const float* up2, const float* dn,
                                const float* left, const float* right, float* rr, int nx,
                                int ny, int gamma, int hb, int wb, int by, int roff, int coff,
                                float cd, float cx, float cy, float cs, cudaStream_t stream) {
  const Geom g{nx, ny, gamma, hb, wb, cd, cx, cy};
  k_down_block_kernel<<<dim3(wb / TW, hb / by), TW, 0, stream>>>(b, up2, dn, left, right, rr, g,
                                                                 cs, by, roff, coff);
  return (int)cudaGetLastError();
}

extern "C" int ist_k_up_block(const float* b, const float* bup, const float* bdn,
                              const float* bleft, const float* bright, const float* ec,
                              const float* ecup, const float* ecdn, const float* ecleft,
                              const float* ecright, float* out, float* dot_p, int nx, int ny,
                              int gamma, int hb, int wb, int by, int ch, int roff, int coff,
                              float cd, float cx, float cy, float cs, cudaStream_t stream) {
  const Geom g{nx, ny, gamma, hb, wb, cd, cx, cy};
  k_up_block_kernel<<<dim3(wb / TW, hb / by), TW, 0, stream>>>(
      b, bup, bdn, bleft, bright, ec, ecup, ecdn, ecleft, ecright, out, dot_p, g, cs, by, ch,
      roff, coff);
  return (int)cudaGetLastError();
}
