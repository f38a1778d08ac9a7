// Masked 5-point stencil y = A x on the padded layout.
//
// Replaces iterative_solvers_tpu/kernels/stencil_pallas.py:_make_kernel (A1),
// the apply of the padded operator (the operator of every CG on
// operator="pallas" without the fused engine, the facade's final residual of
// the fused plain-CG solve), and, as stencil_kernel<true, TJ>, the
// custom-mask body stencil_pallas.py:_make_kernel_custom (C1).
//
// What bounds it on an H100: a memory-bound sweep, one f32 read of x on the
// interior and one f32 write of y over the canvas (plus one byte a node of
// the int8 mask on a custom domain); 8 B/node at most.
//
// The design is K1's tile (csrc/cg_tiles.cuh) without the direction update
// and the dot: a block of 128 threads owns a tile of TJ rows x 128 columns,
// TJ from PaddedStencilOperator.tile_grid (K1's rule: the tallest of 32, 16
// and 8 that divides the canvas's rows and still puts four blocks on every
// SM; the bands play no part), so that even a 1024^2 layout (1280 x 1152)
// fills the card: 720 blocks. The block stages its tile once in shared
// memory: each warp takes every fourth staged row, each lane 4 adjacent
// columns, with all of the warp's 16-byte loads issued before any is used,
// plus the tile's two halo rows and (2 TJ threads, 4 bytes each) its two
// halo columns. Every read is masked on the way in: a load is issued only
// for the lanes whose 4 nodes hold an interior one (so padding rows and
// columns are never read), and the loaded float4 is zeroed off the
// interior. The interior test is one span per row on gamma/rect
// (ist::interior_span); a custom layout first stages its int8 mask tile by
// cp.async, so the mask is read once per node. Then each warp sweeps TJ / 4
// consecutive rows, carrying the rows above and below in registers and
// taking the column neighbours from the next lanes by shuffles, and writes
// y, masked, in 16-byte stores. The operator is out of place and no block writes what
// another reads, so halo rows are read from x directly: no side buffer.
//
// Every node takes ist::stencil_rn, each product and sum rounded on its own
// in the plain version's order, so A1 and C1 equal
// PaddedStencilOperator.apply_plain bit for bit, and the column sweep of the
// mesh block D1 and the streaming C4 / C5 (the same expression) equal A1.
#include "cg_tiles.cuh"

using ist::Geom;
using ist::TW;
using ist_tiles::kSW;
using ist_tiles::kThreads;
using ist_tiles::kWarps;

namespace {

__device__ __forceinline__ float4 masked4(float4 v, unsigned in) {
  return make_float4((in & 1u) ? v.x : 0.f, (in & 2u) ? v.y : 0.f, (in & 4u) ? v.z : 0.f,
                     (in & 8u) ? v.w : 0.f);
}

template <bool kMask, int TJ>
__global__ void __launch_bounds__(kThreads)
    stencil_kernel(const float* __restrict__ x, float* __restrict__ y, Geom g) {
  constexpr int NR = TJ + 2;  // staged rows: the tile's and its two halo rows
  constexpr int S = TJ / kWarps;  // rows each warp sweeps
  constexpr int kRowsPerWarp = (NR + kWarps - 1) / kWarps;  // rows each warp stages
  __shared__ __align__(16) float sx[NR * kSW];
  __shared__ __align__(16) int8_t sm[kMask ? NR * TW : 16];
  const int t = threadIdx.x, lane = t & 31, w = t >> 5;
  const int strips = g.wp / TW;
  const int row0 = (blockIdx.x / strips) * TJ, c0 = (blockIdx.x % strips) * TW;
  if (kMask) {  // the staged rows' int8 mask, zeros off the canvas
    for (int q = t; q < NR * (TW / 16); q += kThreads) {
      const int rl = q / (TW / 16), cb = (q % (TW / 16)) * 16;
      const int r = row0 - 1 + rl;
      const bool ok = r >= 0 && r < g.hp;
      ist::cp_async16(sm + rl * TW + cb, g.mask + (ok ? (size_t)r * g.wp + c0 + cb : 0), ok);
    }
    ist::cp_async_wait_all();
    __syncthreads();
  }
  if (t < 2 * TJ) {  // the halo columns c0 - 1 and c0 + 128 of the tile's rows
    const int rl = 1 + (t >> 1), r = row0 - 1 + rl, c = (t & 1) ? c0 + TW : c0 - 1;
    sx[rl * kSW + ((t & 1) ? 4 + TW : 3)] =
        ist::interior<kMask>(g, r, c) ? __ldg(x + (size_t)r * g.wp + c) : 0.f;
  }
  // interior flags of a lane's 4 nodes: K1's test (the staged mask, or the row's span)
  const ist_tiles::Halo h{};  // one device: no mesh block
  auto interior4 = [&](int rl, int r, int c) {
    return ist_tiles::interior4<kMask, false>(g, h, sm, rl, r, c, c0);
  };
  const int c = c0 + 4 * lane;
  float4 v[kRowsPerWarp];
  unsigned in[kRowsPerWarp];
#pragma unroll
  for (int k = 0; k < kRowsPerWarp; ++k) {
    const int rl = w + kWarps * k, r = row0 - 1 + rl;
    in[k] = rl < NR ? interior4(rl, r, c) : 0u;
    v[k] = in[k] ? ist_tiles::ldg4(x + (size_t)r * g.wp + c)
                 : make_float4(0.f, 0.f, 0.f, 0.f);
  }
#pragma unroll
  for (int k = 0; k < kRowsPerWarp; ++k) {
    const int rl = w + kWarps * k;
    if (rl < NR)
      *reinterpret_cast<float4*>(sx + rl * kSW + 4 + 4 * lane) = masked4(v[k], in[k]);
  }
  __syncthreads();
  const float* p = sx + 4 + 4 * lane;
  float4 up = ist_tiles::lds4(p + w * S * kSW);
  float4 cur = ist_tiles::lds4(p + (w * S + 1) * kSW);
#pragma unroll
  for (int j = 0; j < S; ++j) {
    const int rl = 1 + w * S + j, r = row0 - 1 + rl;
    const float4 dn = ist_tiles::lds4(p + (rl + 1) * kSW);
    float l = __shfl_up_sync(0xffffffffu, cur.w, 1);
    float rt = __shfl_down_sync(0xffffffffu, cur.x, 1);
    if (lane == 0) l = sx[rl * kSW + 3];
    if (lane == 31) rt = sx[rl * kSW + 4 + TW];
    const unsigned m = interior4(rl, r, c);
    float4 o;
    o.x = (m & 1u) ? ist::stencil_rn(g, cur.x, l, cur.y, up.x, dn.x) : 0.f;
    o.y = (m & 2u) ? ist::stencil_rn(g, cur.y, cur.x, cur.z, up.y, dn.y) : 0.f;
    o.z = (m & 4u) ? ist::stencil_rn(g, cur.z, cur.y, cur.w, up.z, dn.z) : 0.f;
    o.w = (m & 8u) ? ist::stencil_rn(g, cur.w, cur.z, rt, up.w, dn.w) : 0.f;
    *reinterpret_cast<float4*>(y + (size_t)r * g.wp + c) = o;
    up = cur;
    cur = dn;
  }
}

// The tile heights PaddedStencilOperator.tile_grid can pick for A1 / C1: 32, 16, 8.
template <bool kMask>
int launch(const float* x, float* y, const Geom& g, int tj, cudaStream_t s) {
  if (tj <= 0 || g.hp % tj != 0 || g.wp % TW != 0) return (int)cudaErrorInvalidValue;
  const int tiles = (g.wp / TW) * (g.hp / tj);
  switch (tj) {
    case 32: stencil_kernel<kMask, 32><<<tiles, kThreads, 0, s>>>(x, y, g); break;
    case 16: stencil_kernel<kMask, 16><<<tiles, kThreads, 0, s>>>(x, y, g); break;
    case 8: stencil_kernel<kMask, 8><<<tiles, kThreads, 0, s>>>(x, y, g); break;
    default: return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int ist_stencil(const float* x, float* y, int nx, int ny, int gamma, int hp,
                           int wp, int tj, float cd, float cx, float cy,
                           cudaStream_t stream) {
  const Geom g{nx, ny, gamma, hp, wp, cd, cx, cy};
  return launch<false>(x, y, g, tj, stream);
}

extern "C" int ist_stencil_custom(const float* x, float* y, const int8_t* mask, int nx, int ny,
                                  int hp, int wp, int tj, float cd, float cx, float cy,
                                  cudaStream_t stream) {
  const Geom g{nx, ny, 0, hp, wp, cd, cx, cy, mask};
  return launch<true>(x, y, g, tj, stream);
}
