// Shared pieces of the fused CG and multigrid kernels.
//
// Layout: every field is a row-major f32 canvas (hp, wp) with wp % 128 == 0
// and hp a multiple of the band height `by`. In the column sweep below (the
// mesh block D1) a block owns TW consecutive columns of one band of rows;
// each thread owns one column and walks the band's rows, so the grid is
// (wp / TW, hp / by). The tiled kernels (A1 / C1 in stencil.cu, K1/K2 and
// their mesh blocks D5/D6 in cg_tiles.cuh, the V-cycle legs and their mesh
// blocks D3/D4 in mg_tiles.cuh) cut their own tiles. The interior mask is the
// algebraic gamma/rect predicate on global indices (no mask is read), and
// column neighbours c-1 / c+1 are bound-checked: the TPU kernels used a
// wrapping lane roll there, which gives the same result because the
// wrapped column is never interior and holds 0.
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

// Asynchronous global -> shared copies (cp.async): bytes in flight hold no
// registers, and a source size of 0 fills the destination with zeros.
__device__ __forceinline__ void cp_async16(void* dst, const void* src, bool valid) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(d), "l"(src),
               "r"(valid ? 16 : 0));
}

__device__ __forceinline__ void cp_async4(void* dst, const void* src, bool valid) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(d), "l"(src),
               "r"(valid ? 4 : 0));
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

// Close the copies issued since the last commit into one group; wait until
// at most N groups are still in flight (the oldest ones have landed).
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// The per-node arithmetic of the fused CG iteration and of the V-cycle
// legs: one helper per step, each rounded as its plain torch version
// rounds (every product and sum on its own, no contraction), so that a
// node's value does not depend on which kernel computed it: the tiles of
// K1/K2 and their mesh blocks D5/D6 (csrc/cg_tiles.cuh), A5/A6 and their
// mesh blocks D3/D4 (csrc/mg_tiles.cuh) and the plain versions agree bit
// for bit.

// The 5-point stencil (cd c + cx (l + r)) + cy (u + d) at an interior node,
// from masked values: the centre, its row neighbours (left, right) and its
// column neighbours (up, down). One expression for every kernel that applies
// A, alone (A1 / C1, C4 / C5, D1) or inside an iteration, so they agree bit
// for bit with each other and with PaddedStencilOperator.apply_plain.
__device__ __forceinline__ float stencil_rn(const Geom& g, float c, float l, float r, float u,
                                            float d) {
  return __fadd_rn(__fadd_rn(__fmul_rn(g.cd, c), __fmul_rn(g.cx, __fadd_rn(l, r))),
                   __fmul_rn(g.cy, __fadd_rn(u, d)));
}

// The CG direction z_k = d + beta z_prev (d = r for MSG CG, w = M r for PCG).
__device__ __forceinline__ float direction(float d, float beta, float z) {
  return __fadd_rn(d, __fmul_rn(beta, z));
}

// K2's updates x' = x + alpha z_k and r' = r - alpha A z_k.
__device__ __forceinline__ float x_update(float x, float alpha, float z) {
  return __fadd_rn(x, __fmul_rn(alpha, z));
}

__device__ __forceinline__ float r_update(float r, float alpha, float az) {
  return __fsub_rn(r, __fmul_rn(alpha, az));
}

// K_down's residual b - A x of the pre-smoothed iterate x = cs * b at an
// interior node, from the masked level RHS at the node (c), its row
// neighbours (l, r) and its column neighbours (u, d).
__device__ __forceinline__ float down_residual(const Geom& g, float cs, float c, float l,
                                               float r, float u, float d) {
  return __fsub_rn(c, stencil_rn(g, __fmul_rn(cs, c), __fmul_rn(cs, l), __fmul_rn(cs, r),
                                 __fmul_rn(cs, u), __fmul_rn(cs, d)));
}

// The [1,2,1]/4 row restriction of the residuals at fine rows 2J-1, 2J, 2J+1.
__device__ __forceinline__ float restrict_rows(float below, float center, float upper) {
  return __fadd_rn(__fadd_rn(__fmul_rn(0.25f, below), __fmul_rn(0.5f, center)),
                   __fmul_rn(0.25f, upper));
}

// The [1,2,1]/4 lane restriction of fine columns 2C-1, 2C, 2C+1, in the
// order of kernels/mg_fused.py lane_restrict: 0.25 (lo + hi) + 0.5 mid.
__device__ __forceinline__ float restrict_lanes(float lo, float mid, float hi) {
  return __fadd_rn(__fmul_rn(0.25f, __fadd_rn(lo, hi)), __fmul_rn(0.5f, mid));
}

// Linear interpolation at an odd fine index, lanes and rows alike.
__device__ __forceinline__ float midpoint(float a, float b) {
  return __fmul_rn(0.5f, __fadd_rn(a, b));
}

// K_up's corrected iterate cs * b + p at an interior node, p the prolonged
// coarse correction there.
__device__ __forceinline__ float corrected_at(float cs, float b, float p) {
  return __fadd_rn(__fmul_rn(cs, b), p);
}

// K_up's post-smoothing sweep at an interior node: the corrected iterate at
// the node (c) and its neighbours (zero off the interior), the level RHS bm.
__device__ __forceinline__ float up_smooth(const Geom& g, float cs, float c, float l, float r,
                                           float u, float d, float bm) {
  return __fadd_rn(c, __fmul_rn(cs, __fsub_rn(bm, stencil_rn(g, c, l, r, u, d))));
}

// The interior columns lo < c < hi of row r on a gamma/rect level (none off
// rows 1 .. ny - 1): the predicate of interior<false> as one span per row.
__device__ __forceinline__ int2 interior_span(const Geom& g, int r) {
  if (r <= 0 || r >= g.ny) return make_int2(0, 0);
  return make_int2((g.gamma && r <= g.ny / 2) ? g.nx / 2 : 0, g.nx);
}

// The column sweep of the mesh block stencil D1 (csrc/halo_pallas.cu): one
// thread owns column c and walks rows row0 .. row0 + by - 1 (indices local
// to the field it writes, row stride ld); the caller says where values come
// from: in(i, cc) is the interior test of a node, x returns a masked value
// (0 off the interior). Each node takes A1's expression (stencil_rn), so
// stitched blocks equal A1's tiles (csrc/stencil.cu) bit for bit.

// y = A x on one column (D1).
template <class In, class X>
__device__ __forceinline__ void stencil_column(const Geom& g, const In& in, const X& x,
                                               float* __restrict__ y, int ld, int c, int row0,
                                               int by) {
  float prev = x(row0 - 1, c);
  float cur = x(row0, c);
  for (int k = 0; k < by; ++k) {
    const int i = row0 + k;
    const float next = x(i + 1, c);
    float o = 0.f;
    if (in(i, c)) o = stencil_rn(g, cur, x(i, c - 1), x(i, c + 1), prev, next);
    y[(size_t)i * ld + c] = o;
    prev = cur;
    cur = next;
  }
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
