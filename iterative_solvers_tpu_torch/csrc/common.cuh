// Shared pieces of the fused CG and multigrid kernels.
//
// Layout: every field is a row-major f32 canvas (hp, wp) with wp % 128 == 0
// and hp a multiple of the band height `by`. A block owns TW consecutive
// columns of one band of rows; each thread owns one column and walks the
// band's rows, so the grid is (wp / TW, hp / by). The interior mask is the
// algebraic gamma/rect predicate on global indices (no mask is read), and
// column neighbours c-1 / c+1 are bound-checked: the TPU kernels used a
// wrapping lane roll there, which gives the same result because the wrapped
// column is never interior and holds 0.
//
// Custom domains: each kernel is a template on kMask. The kMask = false
// instantiation is the gamma/rect kernel as it was; kMask = true reads the
// interior from an int8 mask on the padded canvas (g.mask, 1 B/node, false
// off the canvas) and is exported as the *_custom launcher. It replaces the
// TPU's custom-mask bodies, which stream the same int8 operand.
#pragma once

#include <cstdint>

#include <cuda_runtime.h>

namespace ist {

constexpr int TW = 128;  // columns per block == threads per block

struct Geom {
  int nx, ny, gamma, hp, wp;
  float cd, cx, cy;  // stencil diagonal, x- and y-neighbour coefficients
  const int8_t* mask = nullptr;  // custom domains: (hp, wp) int8 interior
};

template <bool kMask>
__device__ __forceinline__ bool interior(const Geom& g, int r, int c) {
  if (kMask)
    return r >= 0 && r < g.hp && c >= 0 && c < g.wp && g.mask[(size_t)r * g.wp + c] != 0;
  bool in = r > 0 && r < g.ny && c > 0 && c < g.nx;
  if (g.gamma) in = in && !(c <= g.nx / 2 && r <= g.ny / 2);
  return in;
}

// The 5-point stencil on masked values: the centre, its row neighbours
// (left, right) and its column neighbours (up, down). One expression for
// every kernel that applies A alone, so they contract it into the same
// FMAs and agree bit for bit.
__device__ __forceinline__ float stencil5(const Geom& g, float c, float l, float r, float u,
                                          float d) {
  return g.cd * c + g.cx * (l + r) + g.cy * (u + d);
}

// Sum (or max) over the TW threads of a block; the result is valid in
// thread 0. Fixed shuffle order, no atomics: the same inputs give the same
// bits on every run.
template <bool kMax>
__device__ float block_reduce(float v) {
  __shared__ float part[TW / 32];
  for (int o = 16; o > 0; o >>= 1) {
    const float t = __shfl_down_sync(0xffffffffu, v, o);
    v = kMax ? fmaxf(v, t) : v + t;
  }
  if ((threadIdx.x & 31) == 0) part[threadIdx.x >> 5] = v;
  __syncthreads();
  if (threadIdx.x == 0) {
    v = part[0];
    for (int k = 1; k < TW / 32; ++k) v = kMax ? fmaxf(v, part[k]) : v + part[k];
  }
  __syncthreads();  // part[] may be reused by the next call
  return v;
}

}  // namespace ist
