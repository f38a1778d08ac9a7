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

// The column sweeps of the 2D stencil (A1) and the V-cycle legs (A5, A6),
// shared with their mesh-block forms (csrc/halo_pallas.cu, mg_sharded.cu)
// so that a block and the single-device canvas take the same arithmetic at
// every node. One thread owns column c and walks rows row0 .. row0 + by - 1
// (indices local to the field it writes, row stride ld); the caller says
// where values come from: in(i, cc) is the interior test of a node, X / B
// return a masked value (0 off the interior), XC the corrected iterate.

// y = A x on one column (A1).
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
    if (in(i, c)) o = stencil5(g, cur, x(i, c - 1), x(i, c + 1), prev, next);
    y[(size_t)i * ld + c] = o;
    prev = cur;
    cur = next;
  }
}

// K_down on one column (A5): the residual of the pre-smoothed iterate
// x = cs * B at fine rows row0 - 1 .. row0 + by - 1, row-restricted [1,2,1]/4
// into coarse rows row0 / 2 .. row0 / 2 + by / 2 - 1 (row0 even).
template <class In, class B>
__device__ __forceinline__ void k_down_column(const Geom& g, const In& in, const B& b, float cs,
                                              float* __restrict__ rr, int ld, int c, int row0,
                                              int by) {
  auto R = [&](int i) -> float {
    if (!in(i, c)) return 0.f;
    const float bc = b(i, c);
    const float ax = g.cd * (cs * bc) + g.cx * (cs * b(i, c - 1) + cs * b(i, c + 1)) +
                     g.cy * (cs * b(i - 1, c) + cs * b(i + 1, c));
    return bc - ax;
  };
  float below = R(row0 - 1);
  for (int j = 0; j < by / 2; ++j) {
    const int J = row0 / 2 + j;
    const float center = R(2 * J);
    const float upper = R(2 * J + 1);
    rr[(size_t)J * ld + c] = 0.25f * below + 0.5f * center + 0.25f * upper;
    below = upper;
  }
}

// K_up's corrected iterate cs * b + P ec at a node of fine row i (a global
// index: its parity picks the prolongation; ec(J) is the coarse correction
// at global coarse row J of the node's column).
template <class EC>
__device__ __forceinline__ float corrected(float cs, int i, float b, const EC& ec) {
  const float p = (i & 1) ? 0.5f * (ec((i - 1) / 2) + ec((i + 1) / 2)) : ec(i / 2);
  return cs * b + p;
}

// K_up on one column (A6): one post-smoothing sweep of the corrected
// iterate XC; b(i, c) is the level RHS at an interior node. Returns the
// column's share of (b, out).
template <class In, class XC, class B>
__device__ __forceinline__ float k_up_column(const Geom& g, const In& in, const XC& xc,
                                             const B& b, float cs, float* __restrict__ out,
                                             int ld, int c, int row0, int by) {
  float s_dot = 0.f;
  float prev = xc(row0 - 1, c);
  float cur = xc(row0, c);
  for (int k = 0; k < by; ++k) {
    const int i = row0 + k;
    const float next = xc(i + 1, c);
    float o = 0.f;
    if (in(i, c)) {
      const float bm = b(i, c);
      const float ax = g.cd * cur + g.cx * (xc(i, c - 1) + xc(i, c + 1)) + g.cy * (prev + next);
      o = cur + cs * (bm - ax);
      s_dot += bm * o;
    }
    out[(size_t)i * ld + c] = o;
    prev = cur;
    cur = next;
  }
  return s_dot;
}

// The column sweeps of the fused CG iteration (A2, A3/A4), shared with
// their mesh-block forms (csrc/cg_fused_sharded.cu) in the same way. zk(i,
// cc) is the direction z_k = d + beta * z_prev at a node, formed by the
// caller as that one expression (nvcc contracts it into fmaf(beta, z, d))
// and 0 off the canvas; band-internal and column neighbours are read raw,
// the band's halo rows masked by their own row.

// K1 on one column (A2): the band's z_k halo rows (returned through up /
// dn; zh(i, cc) reads them) and the column's shares of (d, z_k), (A z_k,
// z_k) and max |z_k|.
template <class In, class ZK, class ZH, class D>
__device__ __forceinline__ void k1_column(const Geom& g, const In& in, const ZK& zk, const ZH& zh,
                                          const D& d, int c, int row0, int by, float& up,
                                          float& dn, float& s_rz, float& s_azz, float& s_max) {
  up = in(row0 - 1, c) ? zh(row0 - 1, c) : 0.f;
  dn = in(row0 + by, c) ? zh(row0 + by, c) : 0.f;
  float prev = up, cur = zk(row0, c);
  for (int k = 0; k < by; ++k) {
    const int r = row0 + k;
    const float next = (k + 1 < by) ? zk(r + 1, c) : dn;
    float az = 0.f;
    if (in(r, c)) az = g.cd * cur + g.cx * (zk(r, c - 1) + zk(r, c + 1)) + g.cy * (prev + next);
    s_rz += d(r, c) * cur;
    s_azz += az * cur;
    s_max = fmaxf(s_max, fabsf(cur));
    prev = cur;
    cur = next;
  }
}

// K2 / K2-pcg on one column (A3, A4): x' = x + alpha z_k, r' = r - alpha
// A z_k and z_k written at rows row0 .. row0 + by - 1 (row stride ld), the
// band's halo rows up / dn from K1's side buffer; the column's shares of
// |r'|^2, max |r'| and, with u, max |x' - u|.
template <class In, class ZK>
__device__ __forceinline__ void k2_column(const Geom& g, const In& in, const ZK& zk,
                                          const float* __restrict__ x,
                                          const float* __restrict__ r,
                                          const float* __restrict__ u, float* __restrict__ xo,
                                          float* __restrict__ ro, float* __restrict__ zo, int ld,
                                          int c, int row0, int by, float up, float dn,
                                          float alpha, float& s_r2, float& s_max,
                                          float& s_err) {
  float prev = up;
  float cur = zk(row0, c);
  for (int k = 0; k < by; ++k) {
    const int rr = row0 + k;
    const size_t i = (size_t)rr * ld + c;
    const float next = (k + 1 < by) ? zk(rr + 1, c) : dn;
    float az = 0.f;
    if (in(rr, c))
      az = g.cd * cur + g.cx * (zk(rr, c - 1) + zk(rr, c + 1)) + g.cy * (prev + next);
    const float xn = x[i] + alpha * cur;
    const float rn = r[i] - alpha * az;
    xo[i] = xn;
    ro[i] = rn;
    zo[i] = cur;
    s_r2 += rn * rn;
    s_max = fmaxf(s_max, fabsf(rn));
    if (u != nullptr) s_err = fmaxf(s_err, fabsf(xn - u[i]));
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
