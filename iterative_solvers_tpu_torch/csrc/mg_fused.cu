// Fused V-cycle leg kernels K_down and K_up for the multigrid fine levels,
// and the weighted-Jacobi sweep K_jacobi of the FMG warm start.
//
// K_down replaces iterative_solvers_tpu/kernels/mg_fused.py:_make_k_down (A5);
// K_up replaces mg_fused.py:_make_k_up (A6), with and without its dot epilogue;
// K_jacobi replaces mg_fused.py:_make_k_jacobi (A7).
// The kMask = true instantiations of K_down and K_up (ist_k_down_custom,
// ist_k_up_custom) replace the custom-mask bodies mg_fused.py:
// _make_k_down_custom (C2) and _make_k_up_custom (C3): the interior is read
// from the int8 mask (+1 B/node). Those bodies mask by float multiplies and
// trust the level RHS to be pre-masked; here every read is masked, which
// agrees on such input. K_jacobi has no custom form, as on the TPU.
//
// What bounds them on an H100: both are memory-bound stencil sweeps with no
// tensor-core work. K_down reads the level RHS b once (4 B/node) and writes
// the row-restricted residual (hp/2, wp): 6 B/node. K_up reads b and the
// lane-prolonged coarse correction (hp/2, wp) and writes the post-smoothed
// iterate: 10 B/node. The pre-smoothed iterate x = (omega/d) b, the
// residual before restriction, the row-prolonged correction and the
// corrected iterate are all formed in registers from b and ec and never
// stored; neighbours are recomputed from the read-only inputs (served from
// L1/L2), which trades cheap arithmetic for device-memory traffic.
//
// K_jacobi reads x and b once and writes the swept iterate: 12 B/node. Like
// the TPU kernel it masks every read of x and b, so values the FMG
// prolongation left on boundary nodes are discarded, and masks its output.
//
// Stride-2 rows: Mosaic needed reshape-split and stack+reshape tricks. Here
// coarse row J is computed from fine rows 2J-1, 2J, 2J+1 directly, and fine
// row i takes ec row i/2 (even) or the mean of rows (i-1)/2, (i+1)/2 (odd).
#include "common.cuh"

using ist::Geom;
using ist::TW;

namespace {

template <bool kMask>
__global__ void k_down_kernel(const float* __restrict__ b, float* __restrict__ rr, Geom g,
                              float cs, int by) {
  const int wp = g.wp;
  auto in = [&](int i, int cc) { return ist::interior<kMask>(g, i, cc); };
  // masked level RHS; the interior test also keeps every read on the canvas
  auto B = [&](int i, int cc) -> float { return in(i, cc) ? b[(size_t)i * wp + cc] : 0.f; };
  ist::k_down_column(g, in, B, cs, rr, wp, blockIdx.x * TW + threadIdx.x, blockIdx.y * by, by);
}

template <bool kMask>
__global__ void k_up_kernel(const float* __restrict__ b, const float* __restrict__ ec,
                            float* __restrict__ out, float* __restrict__ dot_p, Geom g,
                            float cs, int by, int ch) {
  const int wp = g.wp;
  auto in = [&](int i, int cc) { return ist::interior<kMask>(g, i, cc); };
  // corrected iterate cs * b + P ec at fine row i (zero off the interior);
  // coarse rows outside [0, ch) are zero
  auto XC = [&](int i, int cc) -> float {
    if (!in(i, cc)) return 0.f;
    auto EC = [&](int J) -> float { return (J >= 0 && J < ch) ? ec[(size_t)J * wp + cc] : 0.f; };
    return ist::corrected(cs, i, b[(size_t)i * wp + cc], EC);
  };
  auto B = [&](int i, int cc) -> float { return b[(size_t)i * wp + cc]; };
  float s_dot = ist::k_up_column(g, in, XC, B, cs, out, wp, blockIdx.x * TW + threadIdx.x,
                                 blockIdx.y * by, by);
  if (dot_p != nullptr) {
    s_dot = ist::block_reduce<false>(s_dot);
    if (threadIdx.x == 0) dot_p[blockIdx.y * gridDim.x + blockIdx.x] = s_dot;
  }
}

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

extern "C" int ist_k_down(const float* b, float* rr, int nx, int ny, int gamma, int hp,
                          int wp, int by, float cd, float cx, float cy, float cs,
                          cudaStream_t stream) {
  const Geom g{nx, ny, gamma, hp, wp, cd, cx, cy};
  k_down_kernel<false><<<dim3(wp / TW, hp / by), TW, 0, stream>>>(b, rr, g, cs, by);
  return (int)cudaGetLastError();
}

extern "C" int ist_k_down_custom(const float* b, float* rr, const int8_t* mask, int nx, int ny,
                                 int hp, int wp, int by, float cd, float cx, float cy, float cs,
                                 cudaStream_t stream) {
  const Geom g{nx, ny, 0, hp, wp, cd, cx, cy, mask};
  k_down_kernel<true><<<dim3(wp / TW, hp / by), TW, 0, stream>>>(b, rr, g, cs, by);
  return (int)cudaGetLastError();
}

extern "C" int ist_k_up(const float* b, const float* ec, float* out, float* dot_p, int nx,
                        int ny, int gamma, int hp, int wp, int by, int ch, float cd,
                        float cx, float cy, float cs, cudaStream_t stream) {
  const Geom g{nx, ny, gamma, hp, wp, cd, cx, cy};
  k_up_kernel<false><<<dim3(wp / TW, hp / by), TW, 0, stream>>>(b, ec, out, dot_p, g, cs, by,
                                                                ch);
  return (int)cudaGetLastError();
}

extern "C" int ist_k_up_custom(const float* b, const float* ec, float* out, float* dot_p,
                               const int8_t* mask, int nx, int ny, int hp, int wp, int by,
                               int ch, float cd, float cx, float cy, float cs,
                               cudaStream_t stream) {
  const Geom g{nx, ny, 0, hp, wp, cd, cx, cy, mask};
  k_up_kernel<true><<<dim3(wp / TW, hp / by), TW, 0, stream>>>(b, ec, out, dot_p, g, cs, by,
                                                               ch);
  return (int)cudaGetLastError();
}

extern "C" int ist_k_jacobi(const float* x, const float* b, float* out, int nx, int ny,
                            int gamma, int hp, int wp, int by, float cd, float cx, float cy,
                            float cs, cudaStream_t stream) {
  const Geom g{nx, ny, gamma, hp, wp, cd, cx, cy};
  k_jacobi_kernel<<<dim3(wp / TW, hp / by), TW, 0, stream>>>(x, b, out, g, cs, by);
  return (int)cudaGetLastError();
}
