// The staged z-march of the 3D kernels: the 7-point apply S7
// (csrc/stencil3d.cu), the FMG's Jacobi sweep J3 and the V-cycle legs D3
// and U3 (csrc/mg_fused3d.cu), the mesh block stencil D2
// (csrc/halo_pallas.cu) and the double-f32 residual R3 (csrc/resid_ff.cu).
//
// Layout: every volume is a row-major f32 canvas (d, hp, wp), d = nz + 1.
// The interior mask is the algebraic box predicate 0 < z < nz && 0 < y < ny
// && 0 < x < nx; no mask is read. A block owns a (y, x) tile and marches z
// over a chunk of planes. Every input plane of the tile, with its halo rows
// and columns, is staged into a ring of shared-memory stages by 16-byte
// cp.async copies issued kLook planes ahead, so each plane's loads are in
// flight while the planes before it compute. A copy reads only where its
// row and one of its four columns are interior; rows, columns and planes
// off the interior are zero-filled, which masks them and keeps every read
// on the canvas. A staged row holds the tile's columns and one float4 on
// either side (kQ float4, kW floats): staged column j is column x0 - 4 + j,
// so the tile's edge columns x0 - 1 and x0 + 128 are staged columns 3 and
// 132. One kernel takes any depth d: there is no divisibility rule and no
// ragged tail, which is what split every TPU kernel into a per-plane and a
// z-chunked body. The chunk depth is a launch argument, chosen so the grid
// fills the card at every level size.
//
// The plain 7-point march (zstream): tiles of kZY rows x kZX columns, one
// warp a tile row, four adjacent columns a lane, so shared memory is read
// 16 bytes at a time and the west and east neighbours come from the next
// lanes by shuffles. A thread keeps its nodes' z - 1, z and z + 1 values in
// registers; only the rows above and below come from shared memory. The
// ring has kLook + 2 stages: at step i plane i - 1 (whose rows above and
// below the output needs) and plane i are read while planes i + 1 ..
// i + kLook are in flight. One barrier a plane. The source of each staged
// plane is chosen per plane (ZSource), so a mesh block stages planes -1 and
// d from its halo operands; its halo columns, where it has them, are copied
// by the tiles at the block's x edge only, 4 bytes a row, into staged
// column 3 or 132. The chunk depth is a launch argument
// (kernels/stencil3d_layout.py: zstream_chunk).
#pragma once

#include "common.cuh"

namespace ist3 {

struct Box {
  int nx, ny, nz, d, hp, wp, bz;  // bz: planes per block (z-chunk depth)

  __device__ __forceinline__ size_t at(int z, int y, int x) const {
    return ((size_t)z * hp + y) * wp + x;
  }
};

struct Coef {
  float cd, cx, cy, cz;
};

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

// The per-node steps of D3, U3 and J3, each rounded as its plain torch
// version rounds (kernels/mg_fused3d.py), so that the kernels equal their
// plain versions bit for bit; the transfers' weights are ist::restrict_rows,
// ist::restrict_lanes and ist::midpoint (csrc/common.cuh).
// D3's residual b - A x at an interior node, x = cs * b at each of the seven.
__device__ __forceinline__ float residual7(const Coef& k, float b, const Nbr& x) {
  return __fsub_rn(b, apply7(k, x));
}

// The weighted-Jacobi step x + cs (b - A x) at an interior node: U3's
// post-smoothing sweep and J3.
__device__ __forceinline__ float smooth7(const Coef& k, float cs, float b, const Nbr& v) {
  return __fadd_rn(v.c, __fmul_rn(cs, residual7(k, b, v)));
}

constexpr int kLook = 3;     // planes whose copies are in flight ahead of the one read
constexpr int kQ = 34;       // float4 per staged row
constexpr int kW = 4 * kQ;   // staged row: 4 columns left of the tile, 4 right

// Four consecutive nodes of a row, one thread's share of a shared-memory row.
struct F4 {
  float v[4];
};

__device__ __forceinline__ F4 ld4(const float* p) {
  const float4 q = *reinterpret_cast<const float4*>(p);
  return {{q.x, q.y, q.z, q.w}};
}

__device__ __forceinline__ void st4(float* p, const F4& a) {
  *reinterpret_cast<float4*>(p) = make_float4(a.v[0], a.v[1], a.v[2], a.v[3]);
}

// One 16-byte copy a thread per staged plane: row r0 + q / kQ, columns
// f0 + 4 (q % kQ) .. + 3 of a level field, read only when they hold an
// interior node (else zero-filled). The offset within a plane is fixed.
// (The legs D3 and U3.)
struct PlaneCopy {
  size_t off;
  bool ok;  // the row and the four columns hold an interior node

  __device__ PlaneCopy(const Box& g, int q, int r0, int f0) {
    const int r = r0 + q / kQ, c = f0 + (q % kQ) * 4;
    ok = r > 0 && r < g.ny && c + 3 > 0 && c < g.nx;
    off = ok ? (size_t)r * g.wp + c : 0;
  }
  __device__ void issue(const Box& g, const float* __restrict__ src, int p, float* dst) const {
    const bool on = ok && p > 0 && p < g.nz;
    ist::cp_async16(dst, src + (on ? (size_t)p * g.hp * g.wp + off : 0), on);
  }
};

// --- the plain 7-point march ---------------------------------------------------
constexpr int kZY = 8;                  // rows per tile, a warp each
constexpr int kZX = 128;                // columns per tile, four a lane
constexpr int kZH = kZY + 2;            // staged rows: y0 - 1 .. y0 + 8
constexpr int kZStages = kLook + 2;     // planes i - 1 and i read, i + 1 .. i + kLook in flight
constexpr int kZThreads = 32 * kZY;
constexpr int kZSlots = (kZH * kQ + kZThreads - 1) / kZThreads;  // copies a thread, a plane
constexpr int kZRing = kZStages * kZH * kW;                      // floats of one ring

constexpr size_t zstream_smem(int rings) { return sizeof(float) * rings * kZRing; }

// Where one input's planes come from: the block's own planes 0 .. d - 1
// and, on a mesh block, plane -1 (zup), plane d (zdn), each (hp, wp), and
// the columns left of and right of the block (left, right: (d, hp)). Null
// where the input has none: a single-device canvas's planes -1 and d are
// never interior, and its tiles' edge columns are its own.
struct ZSource {
  const float* x;
  const float* zup = nullptr;
  const float* zdn = nullptr;
  const float* left = nullptr;
  const float* right = nullptr;
};

// A thread's copy q of a staged plane: a float4 of row r (kind 0), or the
// block's halo column left (1) or right (2) at row r, into staged column 3
// or 132; -1: none. Interior tests take the block's global origin (zoff,
// coff); rows are global already.
struct ZCopy {
  int q, kind;
  size_t off;  // kind 0: r * wp + c; else r
  bool ok;     // the row and (one of) the columns are interior

  __device__ void init(const Box& g, int coff, const ZSource& s, int q_, int y0, int x0) {
    q = q_;
    const int r = y0 - 1 + q / kQ, f = q % kQ, c = x0 - 4 + 4 * f;
    const bool rin = r > 0 && r < g.ny;
    kind = q >= kZH * kQ ? -1
           : (s.left && x0 == 0 && f == 0) ? 1
           : (s.right && x0 + kZX == g.wp && f == kQ - 1) ? 2
                                                          : 0;
    if (kind == 0) {
      ok = rin && c >= 0 && c + 4 <= g.wp && coff + c + 3 > 0 && coff + c < g.nx;
      off = ok ? (size_t)r * g.wp + c : 0;
    } else {
      const int gc = kind == 1 ? coff - 1 : coff + g.wp;
      ok = kind > 0 && rin && gc > 0 && gc < g.nx;
      off = ok ? (size_t)r : 0;
    }
  }

  // stage plane p (-1 .. d) of s into the stage st
  __device__ void issue(const Box& g, int zoff, const ZSource& s, int p, float* st) const {
    if (kind < 0) return;
    const bool pin = zoff + p > 0 && zoff + p < g.nz;
    if (kind == 0) {
      const float* base = p < 0 ? s.zup : p >= g.d ? s.zdn : s.x + (size_t)p * g.hp * g.wp;
      const bool on = ok && pin;
      ist::cp_async16(st + 4 * q, on ? base + off : s.x, on);
    } else {
      const bool on = ok && pin && p >= 0 && p < g.d;
      const float* col = kind == 1 ? s.left : s.right;
      ist::cp_async4(st + 4 * q + (kind == 1 ? 3 : 0), on ? col + (size_t)p * g.hp + off : s.x,
                     on);
    }
  }
};

// The seven values around each of a lane's four nodes: its own (c) and
// those of planes z - 1 and z + 1, of rows y - 1 (n) and y + 1 (s), and the
// west neighbour of node 0 (w) and east neighbour of node 3 (e).
struct Nbr4 {
  F4 c, zm, zp, n, s;
  float w, e;

  __device__ __forceinline__ Nbr at(int k) const {
    return {c.v[k], k ? c.v[k - 1] : w, k < 3 ? c.v[k + 1] : e, n.v[k], s.v[k], zm.v[k],
            zp.v[k]};
  }
};

// March the planes z0 .. z1 - 1 of the block's chunk (blockIdx.z, g.bz
// planes deep) of the tile (blockIdx.y, blockIdx.x) over R inputs, each
// staged in its own ring of smem (zstream_smem(R) bytes). For every output
// plane t every thread calls emit(t, y, x, in, v): its nodes are row y,
// columns x .. x + 3 (local), in[k] says node k is interior, v[r] holds
// input r's masked values around them (all zero when the tile holds no
// interior node: then nothing is staged). (zoff, coff): the block's global
// origin in z and x; g: the block (d planes, hp rows, wp columns) with the
// grid's interval counts.
template <int R, class Emit>
__device__ __forceinline__ void zstream(const Box& g, int zoff, int coff,
                                        const ZSource (&src)[R], float* smem,
                                        const Emit& emit) {
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int x0 = blockIdx.x * kZX, y0 = blockIdx.y * kZY;
  const int z0 = blockIdx.z * g.bz, z1 = min(z0 + g.bz, g.d);
  const int y = y0 + warp, x = x0 + 4 * lane;
  Nbr4 v[R] = {};
  bool in[4] = {false, false, false, false};
  if (coff + x0 >= g.nx || y0 >= g.ny) {  // no interior node in the tile
    for (int t = z0; t < z1; ++t) emit(t, y, x, in, v);
    return;
  }
  bool cin[4];  // the thread's columns are interior
#pragma unroll
  for (int k = 0; k < 4; ++k) cin[k] = coff + x + k > 0 && coff + x + k < g.nx;
  const bool yin = y > 0 && y < g.ny;
  const bool wok = coff + x0 - 1 > 0, eok = coff + x0 + kZX < g.nx;  // the edge columns
  ZCopy cp[R][kZSlots];
#pragma unroll
  for (int r = 0; r < R; ++r)
#pragma unroll
    for (int j = 0; j < kZSlots; ++j) cp[r][j].init(g, coff, src[r], tid + j * kZThreads, y0, x0);

  const int p0 = z0 - 1, steps = z1 - z0 + 2;  // staged planes z0 - 1 .. z1
  auto stage = [&](int i) {
    if (i < steps) {
#pragma unroll
      for (int r = 0; r < R; ++r)
#pragma unroll
        for (int j = 0; j < kZSlots; ++j)
          cp[r][j].issue(g, zoff, src[r], p0 + i, smem + r * kZRing + (i % kZStages) * kZH * kW);
    }
    ist::cp_async_commit();
  };
  for (int i = 0; i < kLook; ++i) stage(i);

  const int rl = warp + 1, at = rl * kW + 4 + 4 * lane;
  for (int i = 0; i < steps; ++i) {
    ist::cp_async_wait<kLook - 1>();
    __syncthreads();  // plane i has landed; every thread is done with step i - 1
    stage(i + kLook);
#pragma unroll
    for (int r = 0; r < R; ++r) {
      F4 n = ld4(smem + r * kZRing + (i % kZStages) * kZH * kW + at);
#pragma unroll
      for (int k = 0; k < 4; ++k) n.v[k] = cin[k] ? n.v[k] : 0.f;
      v[r].zm = v[r].c;
      v[r].c = v[r].zp;
      v[r].zp = n;
    }
    if (i < 2) continue;
    // output plane t = p0 + i - 1: its rows above and below are stage i - 1's
    const int t = p0 + i - 1;
    const bool tin = yin && zoff + t > 0 && zoff + t < g.nz;
#pragma unroll
    for (int r = 0; r < R; ++r) {
      const float* sp = smem + r * kZRing + ((i - 1) % kZStages) * kZH * kW;
      v[r].n = ld4(sp + at - kW);
      v[r].s = ld4(sp + at + kW);
      const float wv = __shfl_up_sync(0xffffffffu, v[r].c.v[3], 1);
      const float ev = __shfl_down_sync(0xffffffffu, v[r].c.v[0], 1);
      v[r].w = lane == 0 ? (wok ? sp[rl * kW + 3] : 0.f) : wv;
      v[r].e = lane == 31 ? (eok ? sp[rl * kW + 4 + kZX] : 0.f) : ev;
    }
#pragma unroll
    for (int k = 0; k < 4; ++k) in[k] = tin && cin[k];
    emit(t, y, x, in, v);
  }
}

inline dim3 zstream_grid(const Box& g) {
  return dim3(g.wp / kZX, g.hp / kZY, (g.d + g.bz - 1) / g.bz);
}

// The launch shape a march takes: wp a multiple of kZX, hp of kZY, bz >= 1.
inline bool zstream_fits(const Box& g) {
  return g.bz >= 1 && g.wp % kZX == 0 && g.hp % kZY == 0;
}

}  // namespace ist3
