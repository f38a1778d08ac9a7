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
// The legs also do the lane (column) half of each grid transfer, which the
// TPU runs outside its kernels as banded MXU matmuls (lane_restrict_mm /
// lane_prolong_mm, iterative_solvers_tpu/solvers/multigrid.py:625-637)
// because Mosaic has no stride-2 lanes:
// - K_down: x = cs b (pre-smoothing from zero), the residual b - A x, the
//   [1,2,1]/4 row and lane restrictions and the child's interior mask,
//   written straight onto the child's input layout (its padded canvas when
//   the child is a fused level, else its grid).
// - K_up: the child's correction as the child returns it, prolonged along
//   lanes then rows, the corrected iterate cs b + P ec, one post-smoothing
//   sweep, and with the dot the block partials of (b, out).
// Every step rounds as its plain torch version does (csrc/common.cuh), so
// the fields equal the plain versions' and the mesh blocks D3/D4 (whose
// column sweeps call the same helpers) bit for bit.
//
// What bounds them on an H100: memory, with no tensor-core work. K_down
// reads b (4 B/node) and writes the coarse field (1 B per fine node): 5
// B/node, plus 1.25 for the fine and child int8 masks on a custom level.
// K_up reads b and the coarse correction (4 + 1) and writes the iterate
// (4): 9 B/node, plus 1 for the mask.
//
// The design: a block owns a tile (K_down: TJ coarse rows x 64 coarse
// columns; K_up: 2 TJ fine rows x 128 fine columns) and stages its inputs
// with a one-node halo into shared memory once, in 16-byte pieces (wp %
// 128 == 0): K_down through registers, masking on the way in; K_up by
// cp.async (raw b, and the coarse correction), which holds no registers
// while the bytes are in flight. Each residual (K_down) or corrected
// iterate (K_up) is computed once per node into shared memory, and its
// stencil and transfer partners are read from there; a thread walks one
// fine column down the tile, carrying the rows it shares with the next
// node in registers, and the halo columns are spread over the threads.
// The interior test is one column span per row (interior_span), or the
// staged int8 tile on a custom level. The tile height TJ is picked per
// level (kernels/mg_fused.py: K_down 16, 8 or 4, only 4 on a custom level;
// K_up 8 or 4) so that the small levels still put two blocks on every SM.
//
// K_jacobi reads x and b once and writes the swept iterate: 12 B/node. Like
// the TPU kernel it masks every read of x and b, so values the FMG
// prolongation left on boundary nodes are discarded, and masks its output.
#include "common.cuh"

using ist::Geom;
using ist::TW;

namespace {

constexpr int kThreads = 128;  // threads per tile block, one per fine column
constexpr int kTC = 64;        // coarse columns per tile
constexpr int kFW = 136;       // staged fine columns: F0 - 4 .. F0 + 131 (34 float4)
constexpr int kXW = 130;       // fine columns F0 - 1 .. F0 + 128 of the computed tiles
constexpr int kEW = 72;        // staged coarse columns: C0 - 4 .. C0 + 67 (18 float4)

// K_up's staging: issue the copies of NR rows r0 .. r0 + NR - 1 and fine
// columns f0 .. f0 + kFW - 1 (f0 % 4 == 0) of the level field src into s
// (row stride kFW), zero off the canvas; a custom level (kMask) also
// stages its int8 mask into sm. The caller waits (cp_async_wait_all).
template <bool kMask, int NR>
__device__ __forceinline__ void stage_fine(const Geom& g, const float* __restrict__ src, int r0,
                                           int f0, float* __restrict__ s,
                                           int8_t* __restrict__ sm) {
  constexpr int kQ = kFW / 4;
  for (int q = threadIdx.x; q < NR * kQ; q += kThreads) {
    const int rl = q / kQ, cl = (q % kQ) * 4;
    const int r = r0 + rl, c = f0 + cl;
    const bool ok = r >= 0 && r < g.hp && c >= 0 && c < g.wp;
    const size_t o = ok ? (size_t)r * g.wp + c : 0;
    ist::cp_async16(s + rl * kFW + cl, src + o, ok);
    if (kMask) ist::cp_async4(sm + rl * kFW + cl, g.mask + o, ok);
  }
}

// K_down's staging: the same rows and columns through registers, every
// load issued before the first store, each value zeroed off the interior
// on its way into shared memory (K_down reads masked values only).
template <bool kMask, int NR>
__device__ __forceinline__ void stage_masked(const Geom& g, const float* __restrict__ src,
                                             int r0, int f0, float* __restrict__ s,
                                             int8_t* __restrict__ sm) {
  constexpr int kQ = kFW / 4;
  constexpr int kN = NR * kQ;
  constexpr int kPer = (kN + kThreads - 1) / kThreads;
  float4 v[kPer];
  char4 m[kPer];
#pragma unroll
  for (int k = 0; k < kPer; ++k) {
    const int q = threadIdx.x + k * kThreads;
    const int r = r0 + q / kQ, c = f0 + (q % kQ) * 4;
    v[k] = make_float4(0.f, 0.f, 0.f, 0.f);
    m[k] = make_char4(0, 0, 0, 0);
    if (q < kN && r >= 0 && r < g.hp && c >= 0 && c < g.wp) {
      const size_t o = (size_t)r * g.wp + c;
      v[k] = __ldg(reinterpret_cast<const float4*>(src + o));
      if (kMask) m[k] = *reinterpret_cast<const char4*>(g.mask + o);
    }
  }
#pragma unroll
  for (int k = 0; k < kPer; ++k) {
    const int q = threadIdx.x + k * kThreads;
    if (q >= kN) break;
    const int rl = q / kQ, cl = (q % kQ) * 4;
    float4 x = v[k];
    if (kMask) {
      x.x = m[k].x ? x.x : 0.f;
      x.y = m[k].y ? x.y : 0.f;
      x.z = m[k].z ? x.z : 0.f;
      x.w = m[k].w ? x.w : 0.f;
    } else {
      const int2 sp = ist::interior_span(g, r0 + rl);
      const int c = f0 + cl;
      x.x = (c > sp.x && c < sp.y) ? x.x : 0.f;
      x.y = (c + 1 > sp.x && c + 1 < sp.y) ? x.y : 0.f;
      x.z = (c + 2 > sp.x && c + 2 < sp.y) ? x.z : 0.f;
      x.w = (c + 3 > sp.x && c + 3 < sp.y) ? x.w : 0.f;
    }
    *reinterpret_cast<float4*>(s + rl * kFW + cl) = x;
    if (kMask) *reinterpret_cast<char4*>(sm + rl * kFW + cl) = m[k];
  }
}

// The interior test of staged node (rl, cl) (staged origin r0, f0).
template <bool kMask>
__device__ __forceinline__ bool staged_interior(const Geom& g, const int8_t* sm, int r0, int f0,
                                                int rl, int cl) {
  if (kMask) return sm[rl * kFW + cl] != 0;
  const int2 sp = ist::interior_span(g, r0 + rl);
  const int c = f0 + cl;
  return c > sp.x && c < sp.y;
}

// K_down (A5; C2 with kMask): coarse rows J0 .. J0 + TJ - 1 and columns
// C0 .. C0 + 63 of the child's input layout gc (gc.hp x gc.wp; its mask
// when custom). Staged: b at fine rows 2 J0 - 2 .. 2 J0 + 2 TJ, masked.
// Residuals at fine rows 2 J0 - 1 .. 2 J0 + 2 TJ - 1 and columns
// 2 C0 - 1 .. 2 C0 + 127, row-restricted into srr, then lane-restricted.
template <bool kMask, int TJ>
__global__ void __launch_bounds__(kThreads)
    k_down_kernel(const float* __restrict__ b, float* __restrict__ out, Geom g, Geom gc,
                  float cs) {
  constexpr int NB = 2 * TJ + 3;  // staged fine rows
  __shared__ __align__(16) float sb[NB * kFW];
  __shared__ __align__(16) int8_t sm[kMask ? NB * kFW : 16];
  __shared__ float srr[TJ * kXW];  // row-restricted, fine columns 2 C0 - 1 .. 2 C0 + 127
  const int t = threadIdx.x;
  const int J0 = blockIdx.y * TJ, C0 = blockIdx.x * kTC;
  const int r0 = 2 * J0 - 2, f0 = 2 * C0 - 4;
  stage_masked<kMask, NB>(g, b, r0, f0, sb, sm);
  __syncthreads();
  // the residual at staged node (rl, cl), 1 <= rl <= 2 TJ + 1, 1 <= cl <= kFW - 2
  auto R = [&](int rl, int cl) -> float {
    if (!staged_interior<kMask>(g, sm, r0, f0, rl, cl)) return 0.f;
    const float* p = sb + rl * kFW + cl;
    return ist::down_residual(g, cs, p[0], p[-1], p[1], p[-kFW], p[kFW]);
  };
  // the halo column 2 C0 - 1 (staged column 3): one coarse row per thread
  if (t < TJ)
    srr[t * kXW] = ist::restrict_rows(R(2 * t + 1, 3), R(2 * t + 2, 3), R(2 * t + 3, 3));
  {
    const int cl = t + 4;  // fine column 2 C0 + t
    float below = R(1, cl);
#pragma unroll
    for (int j = 0; j < TJ; ++j) {
      const float center = R(2 * j + 2, cl);
      const float upper = R(2 * j + 3, cl);
      srr[j * kXW + t + 1] = ist::restrict_rows(below, center, upper);
      below = upper;
    }
  }
  __syncthreads();
  // lane restriction onto coarse column C: srr columns 2c, 2c + 1, 2c + 2
  // hold fine columns 2C - 1, 2C, 2C + 1; as lane_restrict, fine columns
  // past nx and coarse rows past ny / 2 are zero before the child mask
  const int c = t % kTC, C = C0 + c;
  const int ch = g.ny / 2 + 1;
  for (int j = t / kTC; j < TJ; j += kThreads / kTC) {
    const int J = J0 + j;
    if (J >= gc.hp || C >= gc.wp) continue;
    const float* q = srr + j * kXW + 2 * c;
    const float hi = 2 * C + 1 <= g.nx ? q[2] : 0.f;
    const float v = ist::restrict_lanes(q[0], q[1], hi);
    out[(size_t)J * gc.wp + C] = (J < ch && ist::interior<kMask>(gc, J, C)) ? v : 0.f;
  }
}

// K_up (A6; C3 with kMask): fine rows i0 .. i0 + 2 TJ - 1 and columns
// F0 .. F0 + 127. Staged: b at rows i0 - 1 .. i0 + 2 TJ (raw) and the
// coarse correction ec (row stride ldc, rows >= ch zero) at coarse rows
// J0 - 1 .. J0 + TJ, columns C0 - 4 .. C0 + 67. The corrected iterate at
// rows i0 - 1 .. i0 + 2 TJ and columns F0 - 1 .. F0 + 128 goes to sx, then
// the sweep writes the tile.
template <bool kMask, int TJ>
__global__ void __launch_bounds__(kThreads)
    k_up_kernel(const float* __restrict__ b, const float* __restrict__ ec,
                float* __restrict__ out, float* __restrict__ dot_p, Geom g, float cs, int ldc,
                int ch) {
  constexpr int TI = 2 * TJ;  // fine rows per tile
  constexpr int NB = TI + 2;  // staged fine rows
  constexpr int NE = TJ + 2;  // staged coarse rows
  __shared__ __align__(16) float sb[NB * kFW];
  __shared__ __align__(16) int8_t sm[kMask ? NB * kFW : 16];
  __shared__ __align__(16) float se[NE * kEW];
  __shared__ float sx[NB * kXW];
  const int t = threadIdx.x;
  const int i0 = blockIdx.y * TI, F0 = blockIdx.x * TW;
  const int J0 = i0 / 2, C0 = F0 / 2;
  const int r0 = i0 - 1, f0 = F0 - 4;
  stage_fine<kMask, NB>(g, b, r0, f0, sb, sm);  // raw: only interior nodes are read
  if (ldc % 4 == 0) {  // a fused child's padded canvas: 16-byte copies
    constexpr int kQ = kEW / 4;
    for (int q = t; q < NE * kQ; q += kThreads) {
      const int J = J0 - 1 + q / kQ, C = C0 - 4 + (q % kQ) * 4;
      const bool ok = J >= 0 && J < ch && C >= 0 && C < ldc;
      ist::cp_async16(se + (q / kQ) * kEW + (q % kQ) * 4, ec + (ok ? (size_t)J * ldc + C : 0), ok);
    }
  } else {  // a plain child's grid (ch, cw)
    for (int q = t; q < NE * kEW; q += kThreads) {
      const int J = J0 - 1 + q / kEW, C = C0 - 4 + q % kEW;
      se[q] = (J >= 0 && J < ch && C >= 0 && C < ldc) ? __ldg(ec + (size_t)J * ldc + C) : 0.f;
    }
  }
  ist::cp_async_wait_all();
  __syncthreads();
  // the lane-prolonged correction at staged coarse row k, fine column f
  // (f >= -1): even columns copy, odd ones average; zero past column nx
  auto ECL = [&](int k, int f) -> float {
    if (f > g.nx) return 0.f;
    const float* e = se + k * kEW + (f >> 1) - C0 + 4;
    return (f & 1) ? ist::midpoint(e[0], e[1]) : e[0];
  };
  // the corrected iterate at staged row rl (fine row r0 + rl, parity: rl
  // even is an odd fine row) from the lane-prolonged rows e0 = row k, e1 = k + 1
  auto XC = [&](int rl, int cl, float e0, float e1) -> float {
    if (!staged_interior<kMask>(g, sm, r0, f0, rl, cl)) return 0.f;
    const float p = (rl & 1) ? e1 : ist::midpoint(e0, e1);
    return ist::corrected_at(cs, sb[rl * kFW + cl], p);
  };
  // fine row r0 + rl takes coarse rows (staged) rl / 2 and rl / 2 + 1 when
  // odd (rl even), and (rl + 1) / 2 when even (rl odd)
  if (t < 2 * NB) {  // the halo columns F0 - 1 and F0 + 128
    const int rl = t % NB, side = t / NB;
    const int f = side ? F0 + TW : F0 - 1;
    const int k = (rl & 1) ? (rl + 1) / 2 - 1 : rl / 2;
    sx[rl * kXW + (side ? kXW - 1 : 0)] = XC(rl, f - f0, ECL(k, f), ECL(k + 1, f));
  }
  {
    const int f = F0 + t;
    float e[NE];
#pragma unroll
    for (int k = 0; k < NE; ++k) e[k] = ECL(k, f);
#pragma unroll
    for (int rl = 0; rl < NB; ++rl) {
      const int k = (rl & 1) ? (rl + 1) / 2 - 1 : rl / 2;
      sx[rl * kXW + t + 1] = XC(rl, t + 4, e[k], e[k + 1]);
    }
  }
  __syncthreads();
  float s_dot = 0.f;
  {
    const int f = F0 + t;
    float up = sx[t + 1], cur = sx[kXW + t + 1];
#pragma unroll 4
    for (int rl = 1; rl <= TI; ++rl) {
      const float* x = sx + rl * kXW + t + 1;
      const float dn = x[kXW];
      float o = 0.f;
      if (staged_interior<kMask>(g, sm, r0, f0, rl, t + 4)) {
        const float bm = sb[rl * kFW + t + 4];
        o = ist::up_smooth(g, cs, cur, x[-1], x[1], up, dn, bm);
        s_dot += bm * o;
      }
      const int i = r0 + rl;
      if (i < g.hp) out[(size_t)i * g.wp + f] = o;
      up = cur;
      cur = dn;
    }
  }
  if (dot_p != nullptr) {
    s_dot = ist::block_reduce<false>(s_dot);
    if (t == 0) dot_p[blockIdx.y * gridDim.x + blockIdx.x] = s_dot;
  }
}

// The tile heights kernels/mg_fused.tile_rows can pick: K_down 16, 8 or 4
// (4 on a custom level), K_up 8 or 4.
template <bool kMask>
int launch_down(const float* b, float* out, const Geom& g, const Geom& gc, float cs, int tj,
                cudaStream_t s) {
  const dim3 grid((gc.wp + kTC - 1) / kTC, (gc.hp + tj - 1) / tj);
  if (tj == 4) {
    k_down_kernel<kMask, 4><<<grid, kThreads, 0, s>>>(b, out, g, gc, cs);
  } else if constexpr (!kMask) {
    if (tj == 16) {
      k_down_kernel<false, 16><<<grid, kThreads, 0, s>>>(b, out, g, gc, cs);
    } else if (tj == 8) {
      k_down_kernel<false, 8><<<grid, kThreads, 0, s>>>(b, out, g, gc, cs);
    } else {
      return (int)cudaErrorInvalidValue;
    }
  } else {
    return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

template <bool kMask>
int launch_up(const float* b, const float* ec, float* out, float* dot_p, const Geom& g,
              float cs, int tj, int ldc, int ch, cudaStream_t s) {
  const dim3 grid(g.wp / TW, (g.hp + 2 * tj - 1) / (2 * tj));
  switch (tj) {
    case 8:
      k_up_kernel<kMask, 8><<<grid, kThreads, 0, s>>>(b, ec, out, dot_p, g, cs, ldc, ch);
      break;
    case 4:
      k_up_kernel<kMask, 4><<<grid, kThreads, 0, s>>>(b, ec, out, dot_p, g, cs, ldc, ch);
      break;
    default: return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
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

extern "C" int ist_k_down(const float* b, float* out, int nx, int ny, int gamma, int hp,
                          int wp, int tj, int ho, int wo, float cd, float cx, float cy, float cs,
                          cudaStream_t stream) {
  const Geom g{nx, ny, gamma, hp, wp, cd, cx, cy};
  const Geom gc{nx / 2, ny / 2, gamma, ho, wo, cd, cx, cy};
  return launch_down<false>(b, out, g, gc, cs, tj, stream);
}

extern "C" int ist_k_down_custom(const float* b, float* out, const int8_t* cmask,
                                 const int8_t* mask, int nx, int ny, int hp, int wp, int tj,
                                 int ho, int wo, float cd, float cx, float cy, float cs,
                                 cudaStream_t stream) {
  const Geom g{nx, ny, 0, hp, wp, cd, cx, cy, mask};
  const Geom gc{nx / 2, ny / 2, 0, ho, wo, cd, cx, cy, cmask};
  return launch_down<true>(b, out, g, gc, cs, tj, stream);
}

extern "C" int ist_k_up(const float* b, const float* ec, float* out, float* dot_p, int nx,
                        int ny, int gamma, int hp, int wp, int tj, int ldc, int ch, float cd,
                        float cx, float cy, float cs, cudaStream_t stream) {
  const Geom g{nx, ny, gamma, hp, wp, cd, cx, cy};
  return launch_up<false>(b, ec, out, dot_p, g, cs, tj, ldc, ch, stream);
}

extern "C" int ist_k_up_custom(const float* b, const float* ec, float* out, float* dot_p,
                               const int8_t* mask, int nx, int ny, int hp, int wp, int tj,
                               int ldc, int ch, float cd, float cx, float cy, float cs,
                               cudaStream_t stream) {
  const Geom g{nx, ny, 0, hp, wp, cd, cx, cy, mask};
  return launch_up<true>(b, ec, out, dot_p, g, cs, tj, ldc, ch, stream);
}

extern "C" int ist_k_jacobi(const float* x, const float* b, float* out, int nx, int ny,
                            int gamma, int hp, int wp, int by, float cd, float cx, float cy,
                            float cs, cudaStream_t stream) {
  const Geom g{nx, ny, gamma, hp, wp, cd, cx, cy};
  k_jacobi_kernel<<<dim3(wp / TW, hp / by), TW, 0, stream>>>(x, b, out, g, cs, by);
  return (int)cudaGetLastError();
}
