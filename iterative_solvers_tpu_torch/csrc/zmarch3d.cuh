// The z-march shared by the 3D kernels (S7, J3, R3), and the per-node
// arithmetic of the V-cycle legs D3 and U3 (csrc/mg_fused3d.cu).
//
// Layout: every volume is a row-major f32 canvas (d, hp, wp), d = nz + 1.
// A block of TY x TX threads owns a TY-row by TX-column tile of the (y, x)
// plane and marches z over a chunk of planes; each thread owns one (y, x)
// column. Per plane, the value the stencil acts on is put in a shared tile
// with a one-cell halo (y and x neighbours), while each thread keeps its own
// column's z - 1, z and z + 1 values in registers, so each plane of the
// input is read once per chunk (plus the halo cells and the two warm-up
// planes at the chunk's start). One kernel takes any depth d: there is no
// divisibility rule and no ragged tail, which is what split every TPU kernel
// into a per-plane and a z-chunked body. The chunk depth is a launch
// argument, chosen so the grid fills the card at every level size.
//
// The interior mask is the algebraic box predicate
// 0 < z < nz && 0 < y < ny && 0 < x < nx; no mask is read. A masked read of
// a non-interior node returns 0 without touching memory, which also keeps
// every read on the canvas.
#pragma once

#include <cuda_runtime.h>

namespace ist3 {

constexpr int TX = 32;  // columns per block (kernels/stencil3d_layout.py ZMARCH_TX)
constexpr int TY = 8;   // rows per block (ZMARCH_TY)

struct Box {
  int nx, ny, nz, d, hp, wp, bz;  // bz: planes per block (z-chunk depth)

  __device__ __forceinline__ bool interior(int z, int y, int x) const {
    return z > 0 && z < nz && y > 0 && y < ny && x > 0 && x < nx;
  }
  __device__ __forceinline__ size_t at(int z, int y, int x) const {
    return ((size_t)z * hp + y) * wp + x;
  }
  __device__ __forceinline__ bool on_canvas(int y, int x) const { return y < hp && x < wp; }
};

struct Coef {
  float cd, cx, cy, cz;
};

inline dim3 block_dim() { return dim3(TX, TY); }

inline dim3 grid_dim(const Box& g, int planes) {
  return dim3((g.wp + TX - 1) / TX, (g.hp + TY - 1) / TY, (planes + g.bz - 1) / g.bz);
}

// The seven values around one node: its own and its six neighbours.
struct Nbr {
  float c, w, e, n, s, zm, zp;  // n: row y - 1, s: row y + 1, zm: plane z - 1
};

// cd c + cx (W + E) + cy (N + S) + cz (Zm + Zp) as the chain
// fma(cz, Zm + Zp, fma(cy, N + S, fma(cd, c, cx (W + E)))): the order the
// JAX package's XLA evaluates and the plain versions emulate
// (ops/stencil.py: combine7). Every step is an explicit round-to-nearest
// intrinsic, so no contraction choice of the compiler changes the bits.
__device__ __forceinline__ float apply7(const Coef& k, const Nbr& v) {
  const float t = __fmul_rn(k.cx, __fadd_rn(v.w, v.e));
  const float u = __fmaf_rn(k.cd, v.c, t);
  const float w = __fmaf_rn(k.cy, __fadd_rn(v.n, v.s), u);
  return __fmaf_rn(k.cz, __fadd_rn(v.zm, v.zp), w);
}

// The legs' per-node steps (D3, U3), each rounded as its plain torch
// version rounds (kernels/mg_fused3d.py), so that the legs equal their plain
// versions bit for bit; the transfers' weights are ist::restrict_rows,
// ist::restrict_lanes and ist::midpoint (csrc/common.cuh).
// D3's residual b - A x at an interior node, x = cs * b at each of the seven.
__device__ __forceinline__ float residual7(const Coef& k, float b, const Nbr& x) {
  return __fsub_rn(b, apply7(k, x));
}

// U3's post-smoothing sweep x~ + cs (b - A x~) at an interior node.
__device__ __forceinline__ float smooth7(const Coef& k, float cs, float b, const Nbr& v) {
  return __fadd_rn(v.c, __fmul_rn(cs, residual7(k, b, v)));
}

// One plane's tile of TY x TX values plus a one-cell halo (no corners).
struct Tile {
  float v[TY + 2][TX + 2];
};

// Put plane z's values in the tile: the thread's own cell from its register
// `own`, the halo cells from `val(z, y, x)`. Call between two
// __syncthreads().
template <class Val>
__device__ __forceinline__ void fill_tile(Tile& t, int z, int y0, int x0, float own,
                                          const Val& val) {
  const int tx = threadIdx.x, ty = threadIdx.y;
  t.v[ty + 1][tx + 1] = own;
  if (ty == 0) t.v[0][tx + 1] = val(z, y0 - 1, x0 + tx);
  if (ty == TY - 1) t.v[TY + 1][tx + 1] = val(z, y0 + TY, x0 + tx);
  if (tx == 0) t.v[ty + 1][0] = val(z, y0 + ty, x0 - 1);
  if (tx == TX - 1) t.v[ty + 1][TX + 1] = val(z, y0 + ty, x0 + TX);
}

__device__ __forceinline__ Nbr gather(const Tile& t, float zm, float zp) {
  const int tx = threadIdx.x + 1, ty = threadIdx.y + 1;
  return {t.v[ty][tx], t.v[ty][tx - 1], t.v[ty][tx + 1], t.v[ty - 1][tx], t.v[ty + 1][tx],
          zm, zp};
}

// March planes t0 .. t1 - 1 of the thread's column with the stencil acting on
// val(z, y, x) (which must return 0 off the interior); emit(z, y, x, nbr) is
// called on every plane by every thread (threads off the canvas included,
// so a reduction may synchronise) and must itself skip writes off the canvas.
template <class Val, class Emit>
__device__ __forceinline__ void zmarch(int t0, int t1, const Val& val, const Emit& emit) {
  __shared__ Tile tile;
  const int x0 = blockIdx.x * TX, y0 = blockIdx.y * TY;
  const int x = x0 + threadIdx.x, y = y0 + threadIdx.y;
  float prev = val(t0 - 1, y, x);
  float cur = val(t0, y, x);
  for (int z = t0; z < t1; ++z) {
    const float next = val(z + 1, y, x);
    __syncthreads();  // every thread is done with the previous plane's tile
    fill_tile(tile, z, y0, x0, cur, val);
    __syncthreads();
    emit(z, y, x, gather(tile, prev, next));
    prev = cur;
    cur = next;
  }
}

}  // namespace ist3
