// Fused V-cycle leg kernels K_down and K_up for the multigrid fine levels,
// and the weighted-Jacobi sweep K_jacobi of the FMG warm start.
//
// K_down replaces the JAX package's kernels/mg_fused.py:_make_k_down (A5);
// K_up replaces mg_fused.py:_make_k_up (A6), with and without its dot epilogue;
// K_jacobi replaces mg_fused.py:_make_k_jacobi (A7).
// The kMask = true instantiations of K_down and K_up (ist_k_down_custom,
// ist_k_up_custom) replace the custom-mask bodies mg_fused.py:
// _make_k_down_custom (C2) and _make_k_up_custom (C3): the interior is read
// from the int8 mask (+1 B/node). Those bodies mask by float multiplies and
// trust the level RHS to be pre-masked; here every read is masked, which
// agrees on such input. K_jacobi has no custom form, as on the TPU.
//
// The tiles, their staging and their launchers live in csrc/mg_tiles.cuh,
// shared with the mesh blocks D3/D4 (csrc/mg_sharded.cu); here they are
// instantiated with kBlock = false, on the level's whole padded canvas.
//
// K_jacobi reads x and b once and writes the swept iterate: 12 B/node. Like
// the TPU kernel it masks every read of x and b, so values the FMG
// prolongation left on boundary nodes are discarded, and masks its output.
#include "mg_tiles.cuh"

using ist::Geom;
using ist::TW;
using ist_legs::LegHalo;
using ist_legs::launch_down;
using ist_legs::launch_up;

namespace {

__global__ void k_jacobi_kernel(const float* __restrict__ x, const float* __restrict__ b,
                                float* __restrict__ out, Geom g, float cs, int by) {
  const int c = blockIdx.x * TW + threadIdx.x;
  const int row0 = blockIdx.y * by;
  const int wp = g.wp;
  // masked read; the interior test also keeps every read on the canvas
  auto X = [&](int i, int cc) -> float {
    return ist::interior<false>(g, i, cc) ? x[(size_t)i * wp + cc] : 0.f;
  };
  float prev = X(row0 - 1, c);
  float cur = X(row0, c);
  for (int k = 0; k < by; ++k) {
    const int i = row0 + k;
    const float next = X(i + 1, c);
    float o = 0.f;
    if (ist::interior<false>(g, i, c)) {
      const float ax = g.cd * cur + g.cx * (X(i, c - 1) + X(i, c + 1)) + g.cy * (prev + next);
      o = cur + cs * (b[(size_t)i * wp + c] - ax);
    }
    out[(size_t)i * wp + c] = o;
    prev = cur;
    cur = next;
  }
}

}  // namespace

extern "C" int ist_k_down(const float* b, float* out, int nx, int ny, int gamma, int hp,
                          int wp, int tj, int ho, int wo, float cd, float cx, float cy, float cs,
                          cudaStream_t stream) {
  const Geom g{nx, ny, gamma, hp, wp, cd, cx, cy};
  const Geom gc{nx / 2, ny / 2, gamma, ho, wo, cd, cx, cy};
  return launch_down<false, false>(b, out, g, gc, LegHalo{}, cs, tj, stream);
}

extern "C" int ist_k_down_custom(const float* b, float* out, const int8_t* cmask,
                                 const int8_t* mask, int nx, int ny, int hp, int wp, int tj,
                                 int ho, int wo, float cd, float cx, float cy, float cs,
                                 cudaStream_t stream) {
  const Geom g{nx, ny, 0, hp, wp, cd, cx, cy, mask};
  const Geom gc{nx / 2, ny / 2, 0, ho, wo, cd, cx, cy, cmask};
  return launch_down<true, false>(b, out, g, gc, LegHalo{}, cs, tj, stream);
}

extern "C" int ist_k_up(const float* b, const float* ec, float* out, float* dot_p, int nx,
                        int ny, int gamma, int hp, int wp, int tj, int ldc, int ch, float cd,
                        float cx, float cy, float cs, cudaStream_t stream) {
  const Geom g{nx, ny, gamma, hp, wp, cd, cx, cy};
  return launch_up<false, false>(b, ec, out, dot_p, g, LegHalo{}, cs, tj, ldc, ch, stream);
}

extern "C" int ist_k_up_custom(const float* b, const float* ec, float* out, float* dot_p,
                               const int8_t* mask, int nx, int ny, int hp, int wp, int tj,
                               int ldc, int ch, float cd, float cx, float cy, float cs,
                               cudaStream_t stream) {
  const Geom g{nx, ny, 0, hp, wp, cd, cx, cy, mask};
  return launch_up<true, false>(b, ec, out, dot_p, g, LegHalo{}, cs, tj, ldc, ch, stream);
}

extern "C" int ist_k_jacobi(const float* x, const float* b, float* out, int nx, int ny,
                            int gamma, int hp, int wp, int by, float cd, float cx, float cy,
                            float cs, cudaStream_t stream) {
  const Geom g{nx, ny, gamma, hp, wp, cd, cx, cy};
  k_jacobi_kernel<<<dim3(wp / TW, hp / by), TW, 0, stream>>>(x, b, out, g, cs, by);
  return (int)cudaGetLastError();
}
