// Fused legs of the 3D V-cycle's fine levels (D3, U3) and the weighted-Jacobi
// sweep of the FMG warm start (J3), on the padded (d, hp, wp) layout.
//
// D3 (k_down3d) replaces iterative_solvers_tpu/kernels/mg_fused3d.py:
//   _make_k_resid_3d (B3) + _make_k_zrestrict (B4), and their chunked fusion
//   _make_k_down_chunked_3d (B6), together with the y/x full weighting that
//   the JAX package runs outside its kernels (banded MXU matmuls,
//   iterative_solvers_tpu/solvers/multigrid.py:341-377): the residual of the
//   pre-smoothed iterate x = cs b (cs = omega / d), restricted [1,2,1]/4
//   along z, then y, then x, masked by the child's interior and written
//   straight onto the child's input layout (ho, wo per plane: its padded
//   canvas when the child is a fused level, else its grid), zeros included.
// U3 (k_up3d) replaces _make_k_up_3d (B5) and _make_k_up_chunked_3d (B7),
//   with the y/x prolongation folded in: the child's correction ec as the
//   child returns it (on the same layout), interpolated along y, then x,
//   then z, the corrected iterate x~ = cs b + P ec and one post-smoothing
//   sweep x~ + cs (b - A x~).
// J3 (k_jacobi3d) replaces _make_k_jacobi_3d (B8) and
//   _make_k_jacobi_chunked_3d (B9): x + (omega/d)(b - A x), with masked
//   reads of x and b and masked output.
//
// What bounds them on an H100: memory, with no tensor-core work. D3 reads
// b at interior nodes (4 B/node) and writes the child's canvas (~0.8 B per
// fine node at 512^3): ~4.8 B/node. U3 reads b and the child's grid of ec
// (4 + 0.5) and writes the iterate (4): ~8.5 B/node. J3 reads x and b and
// writes: 12 B/node. Measured on an H100 the legs run at 43 % (D3) and
// 59 % (U3) of that bound: they are held by shared-memory traffic and the
// latency of each plane's step, not by device memory (PERF.md).
//
// J3 is S7's march (csrc/stencil3d.cu) with one more input: x staged in
// the cp.async ring of ist3::zstream, b read in the emit as one float4 a
// lane (a node-only input needs no halo, so it is not staged), the output
// stored as one float4 a lane.
//
// The legs' design: the staged z-march of csrc/zstream3d.cuh (its copies,
// constants and float4 helpers live there, shared with D2, R3, S7 and J3).
// A block owns a (y, x) tile and marches z over a chunk of planes; every
// input plane of the tile, with its halo, is staged into a ring of
// shared-memory stages by 16-byte cp.async copies issued kLook = 3 planes
// ahead (4 times the same), so each plane's loads are in flight while the
// planes before it compute. The copies read interior rows and columns
// only: rows and planes off the interior are zero-filled, which masks
// them. A warp owns one row of the tile and each lane four adjacent
// columns, so shared memory is read and written 16 bytes at a time and the
// west and east neighbours come from the next lanes by shuffles. A thread
// keeps its nodes' z - 1, z and z + 1 values in registers, so only the
// in-plane neighbours come from shared memory.
// - D3's block owns 4 coarse rows x 64 coarse columns. It forms the
//   residual at fine rows 2 Y0 - 1 .. 2 Y0 + 7 and columns 2 X0 - 1 ..
//   2 X0 + 127 from b staged with two halo rings, and x = cs b where each
//   use needs it (one rounded product, the same at every use: cheaper here
//   than a shared plane of x, which doubled the shared-memory traffic). Its
//   threads keep the z running sums and, after each odd fine plane 2C + 1,
//   restrict them along y and x into coarse plane C.
// - U3's block owns 8 fine rows x 128 fine columns (hp and wp are
//   multiples of 8 and 128, so tiles are never ragged). It prolongs each
//   coarse plane along y and x once, at fine resolution with its halo, and
//   keeps two such planes (each feeds three fine planes); it forms x~ once
//   per node of the tile and its ring (three more warps take the ring) into
//   a shared plane, then sweeps.
// The z-chunk depth is a launch argument (kernels/mg_fused3d.py:
// leg_chunk), chosen so every level's grid fills the card. Blocks whose
// tile holds no interior node only write zeros. Each step rounds as the
// plain versions do (csrc/zstream3d.cuh, csrc/common.cuh), so D3 and U3
// equal them bit for bit.
#include "zstream3d.cuh"

using ist3::Box;
using ist3::Coef;
using ist3::Nbr;

namespace {

using ist3::F4;
using ist3::kLook;
using ist3::kQ;
using ist3::kW;
using ist3::ld4;
using ist3::PlaneCopy;
using ist3::st4;

// --- D3 -----------------------------------------------------------------------
constexpr int kCY = 4;            // coarse rows per tile
constexpr int kCX = 64;           // coarse columns per tile
constexpr int kRH = 2 * kCY + 1;  // residual rows: fine 2 Y0 - 1 .. 2 Y0 + 7
constexpr int kBH = 2 * kCY + 3;  // staged rows: fine 2 Y0 - 2 .. 2 Y0 + 8
constexpr int kDStages = kLook + 2;  // plane t stays staged while t + 1 .. t + 1 + kLook land
constexpr int kDThreads = 32 * kRH;  // a warp per residual row

constexpr size_t down_smem() { return sizeof(float) * kW * (kDStages * kBH + kRH); }

// Coarse planes c0 .. c1 - 1 of the tile (Y0, X0) of the child's layout
// (dc, ho, wo), from b staged at fine rows 2 Y0 - 2 .. 2 Y0 + 8 and columns
// 2 X0 - 4 .. 2 X0 + 131 (staged column j: fine 2 X0 - 4 + j). The march
// walks planes p = 2 c0 - 2 .. 2 c1; at p it forms the residual R(p - 1) of
// x = cs b. Warp w owns residual row w (staged row w + 1), four columns a
// lane (staged 4 + 4 lane ..), lane 0 also staged column 3 (fine 2 X0 - 1).
// x is formed where it is used, from the staged b (the copies zero-fill
// rows and planes off the interior, so only columns are masked): the same
// product cs b at every use. After each odd plane 2C + 1 the z-restricted
// residuals (rz, staged columns) are restricted along y, then x, into
// coarse plane C, one warp a coarse row, the west partner by a shuffle.
__global__ void __launch_bounds__(kDThreads)
    k_down3d_kernel(const float* __restrict__ b, float* __restrict__ out, Box g, Coef k,
                    float cs, int dc, int ho, int wo) {
  extern __shared__ __align__(16) float smem[];
  float* sb = smem;                     // kDStages staged b planes
  float* rz = sb + kDStages * kBH * kW;  // the z-restricted residuals of a coarse plane
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int X0 = blockIdx.x * kCX, Y0 = blockIdx.y * kCY;
  const int c0 = blockIdx.z * g.bz, c1 = min(c0 + g.bz, dc);
  // a coarse node (C, Y, X) of the output: the child's interior, else 0
  auto store = [&](int C, int j, int i, float v) {
    const int Y = Y0 + j, X = X0 + i;
    if (Y >= ho || X >= wo) return;
    const bool in = C > 0 && C < g.nz / 2 && Y > 0 && Y < g.ny / 2 && X > 0 && X < g.nx / 2;
    out[((size_t)C * ho + Y) * wo + X] = in ? v : 0.f;
  };
  if (X0 >= g.nx / 2 || Y0 >= g.ny / 2) {  // no child interior node in the tile
    for (int C = c0; C < c1; ++C)
      for (int q = tid; q < kCY * kCX; q += kDThreads) store(C, q / kCX, q % kCX, 0.f);
    return;
  }
  const int r0 = 2 * Y0 - 2, f0 = 2 * X0 - 4;  // the staged origin (fine row, column)
  const int rl = warp + 1, at = rl * kW + 4 + 4 * lane;
  auto colin = [&](int cl) { return f0 + cl > 0 && f0 + cl < g.nx; };
  bool cin[4];  // the thread's four columns are interior
#pragma unroll
  for (int e = 0; e < 4; ++e) cin[e] = colin(4 + 4 * lane + e);
  const bool yin = r0 + rl > 0 && r0 + rl < g.ny;
  const bool c2 = colin(2), c3 = colin(3), c132 = colin(kW - 4);
  const PlaneCopy cp0(g, tid, r0, f0), cp1(g, tid + kDThreads, r0, f0);
  const bool copies1 = tid + kDThreads < kBH * kQ;

  const int p0 = 2 * c0 - 2, steps = 2 * (c1 - c0) + 3;
  auto stage = [&](int i) {
    if (i < steps) {
      float* s = sb + (i % kDStages) * kBH * kW;
      cp0.issue(g, b, p0 + i, s + 4 * tid);
      if (copies1) cp1.issue(g, b, p0 + i, s + 4 * (tid + kDThreads));
    }
    ist::cp_async_commit();
  };
  for (int i = 0; i < kLook; ++i) stage(i);

  // masked b of the thread's nodes at planes t - 1, t, t + 1, and of
  // staged column 3 (lane 0's fifth node); the z running sums
  F4 bm{}, bc{}, bn{};
  float em = 0.f, ecn = 0.f, en = 0.f;
  float acc[5] = {0.f, 0.f, 0.f, 0.f, 0.f};
  int pending = -1;  // the coarse plane whose z-restricted tile awaits its y/x restriction
  // y, then x, full weighting of rz into coarse plane C: warp j < 4 takes
  // coarse row Y0 + j from rz rows 2j .. 2j + 2; lane l the coarse columns
  // X0 + 2l (fine 4l - 1 .. 4l + 1) and X0 + 2l + 1 (fine 4l + 1 .. 4l + 3)
  auto restrict_yx = [&](int C) {
    if (warp >= kCY) return;
    const float* r = rz + 2 * warp * kW;
    const F4 lo = ld4(r + 4 + 4 * lane), mid = ld4(r + kW + 4 + 4 * lane),
             hi = ld4(r + 2 * kW + 4 + 4 * lane);
    float ry[4];
#pragma unroll
    for (int e = 0; e < 4; ++e) ry[e] = ist::restrict_lanes(lo.v[e], mid.v[e], hi.v[e]);
    const float west = __shfl_up_sync(0xffffffffu, ry[3], 1);
    const float ry3 = ist::restrict_lanes(r[3], r[kW + 3], r[2 * kW + 3]);  // fine 2 X0 - 1
    store(C, warp, 2 * lane, ist::restrict_lanes(lane == 0 ? ry3 : west, ry[0], ry[1]));
    store(C, warp, 2 * lane + 1, ist::restrict_lanes(ry[1], ry[2], ry[3]));
  };

  for (int i = 0; i < steps; ++i) {
    const int p = p0 + i;
    ist::cp_async_wait<kLook - 1>();
    __syncthreads();  // plane p has landed; every thread is done with step i - 1
    stage(i + kLook);
    const float* s = sb + (i % kDStages) * kBH * kW;
    {
      F4 v = ld4(s + at);
#pragma unroll
      for (int e = 0; e < 4; ++e) v.v[e] = cin[e] ? v.v[e] : 0.f;
      bm = bc;
      bc = bn;
      bn = v;
      em = ecn;
      ecn = en;
      en = c3 ? s[rl * kW + 3] : 0.f;
    }
    if (pending >= 0) {  // rz was filled at step i - 1
      restrict_yx(pending);
      pending = -1;
    }
    if (i < 2) continue;
    // the residual at plane t = p - 1: x(t) in plane from its staged b, x(t
    // - 1) and x(t + 1) at the thread's nodes from its registers
    const int t = p - 1;
    const bool tin = t > 0 && t < g.nz && yin;
    const float* sp = sb + ((i - 1) % kDStages) * kBH * kW;
    F4 xc;
#pragma unroll
    for (int e = 0; e < 4; ++e) xc.v[e] = __fmul_rn(cs, bc.v[e]);
    const float x3 = __fmul_rn(cs, ecn);  // staged column 3
    const float wv = __shfl_up_sync(0xffffffffu, xc.v[3], 1);
    const float ev = __shfl_down_sync(0xffffffffu, xc.v[0], 1);
    const float W = lane == 0 ? x3 : wv;
    const float E = lane == 31 ? __fmul_rn(cs, c132 ? sp[at + 4] : 0.f) : ev;
    const F4 N = ld4(sp + at - kW), S = ld4(sp + at + kW);
    float R[5] = {0.f, 0.f, 0.f, 0.f, 0.f};
#pragma unroll
    for (int e = 0; e < 4; ++e)
      if (tin && cin[e])
        R[e] = ist3::residual7(
            k, bc.v[e],
            Nbr{xc.v[e], e ? xc.v[e - 1] : W, e < 3 ? xc.v[e + 1] : E, __fmul_rn(cs, N.v[e]),
                __fmul_rn(cs, S.v[e]), __fmul_rn(cs, bm.v[e]), __fmul_rn(cs, bn.v[e])});
    if (lane == 0 && tin && c3) {
      const float* v = sp + rl * kW + 3;
      R[4] = ist3::residual7(k, ecn, Nbr{x3, __fmul_rn(cs, c2 ? v[-1] : 0.f), xc.v[0],
                                         __fmul_rn(cs, v[-kW]), __fmul_rn(cs, v[kW]),
                                         __fmul_rn(cs, em), __fmul_rn(cs, en)});
    }
    const bool last = (t & 1) && t > 2 * c0;  // t = 2C + 1 ends coarse plane C
    if (t & 1) {  // the last term of coarse plane C, the first of C + 1
      if (last) {
        float z[5];
#pragma unroll
        for (int e = 0; e < 5; ++e) z[e] = __fadd_rn(acc[e], __fmul_rn(0.25f, R[e]));
        st4(rz + at - kW, F4{{z[0], z[1], z[2], z[3]}});
        if (lane == 0) rz[(rl - 1) * kW + 3] = z[4];
        pending = (t - 1) / 2;
      }
#pragma unroll
      for (int e = 0; e < 5; ++e) acc[e] = __fmul_rn(0.25f, R[e]);
    } else {
#pragma unroll
      for (int e = 0; e < 5; ++e) acc[e] = __fadd_rn(acc[e], __fmul_rn(0.5f, R[e]));
    }
  }
  __syncthreads();
  if (pending >= 0) restrict_yx(pending);
}

// --- U3 -----------------------------------------------------------------------
constexpr int kTY = 8;             // fine rows per tile
constexpr int kTX = 128;           // fine columns per tile
constexpr int kUH = kTY + 2;       // staged rows: y0 - 1 .. y0 + 8
constexpr int kEH = kTY / 2 + 2;   // staged coarse rows: Y0 - 1 .. Y0 + 4
constexpr int kEW = kTX / 2 + 8;   // staged coarse columns: X0 - 4 .. X0 + 67 (18 float4)
constexpr int kEStages = 4;        // staged coarse planes
constexpr int kUStages = kLook + 1;  // staged b planes
constexpr int kUThreads = 32 * (kTY + 3);  // a warp per tile row, 3 for the ring

constexpr size_t up_smem() {
  return sizeof(float) * (kUStages * kUH * kW + kEStages * kEH * kEW + 4 * kUH * kW);
}

// The interior in (y, x) of the four nodes at row y, columns x .. x + 3.
__device__ __forceinline__ void inplane4(const Box& g, int y, int x, bool in[4]) {
#pragma unroll
  for (int k = 0; k < 4; ++k) in[k] = y > 0 && y < g.ny && x + k > 0 && x + k < g.nx;
}

// Stage coarse plane zc of ec (the child's layout (dc, ho, wo); only its
// grid (dc, hc, wc) is read) at rows Y0 - 1 .. Y0 + 4 and columns
// X0 - 4 .. X0 + 67 into s: 16-byte copies when the row stride allows
// (a fused child's padded canvas), else 4-byte ones (a plain child's grid).
__device__ __forceinline__ void stage_coarse(const Box& g, const float* __restrict__ ec, int zc,
                                             int Y0, int X0, int dc, int ho, int wo,
                                             float* __restrict__ s) {
  const int hc = g.ny / 2 + 1, wc = g.nx / 2 + 1;
  const bool zin = zc >= 0 && zc < dc;
  const size_t plane = (size_t)zc * ho;
  if (wo % 4 == 0) {
    constexpr int kEQ = kEW / 4;
    for (int q = threadIdx.x; q < kEH * kEQ; q += kUThreads) {
      const int Y = Y0 - 1 + q / kEQ, X = X0 - 4 + (q % kEQ) * 4;
      const bool ok = zin && Y >= 0 && Y < hc && X >= 0 && X < wc;
      ist::cp_async16(s + q * 4, ec + (ok ? (plane + Y) * wo + X : 0), ok);
    }
  } else {
    for (int q = threadIdx.x; q < kEH * kEW; q += kUThreads) {
      const int Y = Y0 - 1 + q / kEW, X = X0 - 4 + q % kEW;
      const bool ok = zin && Y >= 0 && Y < hc && X >= 0 && X < wc;
      ist::cp_async4(s + q, ec + (ok ? (plane + Y) * wo + X : 0), ok);
    }
  }
}

// Output planes z0 .. z1 - 1 of the tile (y0, x0), staged at rows
// y0 - 1 .. y0 + 8 and columns x0 - 4 .. x0 + 131 (staged column j: fine
// x0 - 4 + j). The march walks planes s = z0 - 1 .. z1, forming x~(s) at
// the tile and its ring and sweeping plane s - 1; at even s it also
// prolongs coarse plane s / 2 + 1 along y and x into E (E holds coarse
// planes m and m + 1 in slots m & 1). Warp w < 8 owns tile row w (staged
// row w + 1), four columns a lane (staged 4 + 4 lane ..); the other warps
// form x~ on the ring (staged rows 0 and 9, columns 0 .. 3 and 132 .. 135).
__global__ void __launch_bounds__(kUThreads)
    k_up3d_kernel(const float* __restrict__ b, const float* __restrict__ ec,
                  float* __restrict__ out, Box g, Coef k, float cs, int dc, int ho, int wo) {
  extern __shared__ __align__(16) float smem[];
  float* sb = smem;                       // kUStages staged b planes
  float* se = sb + kUStages * kUH * kW;   // kEStages staged coarse planes
  float* sE = se + kEStages * kEH * kEW;  // the y/x-prolonged coarse planes, 2 slots
  float* sx = sE + 2 * kUH * kW;          // x~ of two planes (s and s - 1)
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int x0 = blockIdx.x * kTX, y0 = blockIdx.y * kTY;
  const int z0 = blockIdx.z * g.bz, z1 = min(z0 + g.bz, g.d);
  const bool own = warp < kTY;
  if (x0 >= g.nx || y0 >= g.ny) {  // no interior node in the tile
    if (own)
      for (int t = z0; t < z1; ++t) st4(out + g.at(t, y0 + warp, x0 + 4 * lane), F4{});
    return;
  }
  const int Y0 = y0 / 2, X0 = x0 / 2;

  // the thread's four x~ nodes: staged row rl, float4 f (rl < 0: none)
  int rl = -1, f = 0;
  if (own) {
    rl = warp + 1;
    f = lane + 1;
  } else {
    const int h = tid - 32 * kTY;
    if (h < 2 * kQ) {
      rl = h < kQ ? 0 : kUH - 1;
      f = h % kQ;
    } else if (h < 2 * kQ + 2 * kTY) {
      rl = 1 + (h - 2 * kQ) % kTY;
      f = h < 2 * kQ + kTY ? 0 : kQ - 1;
    }
  }
  const int at = rl * kW + 4 * f;
  bool in[4];
  inplane4(g, y0 - 1 + rl, x0 - 4 + 4 * f, in);
  if (rl < 0) in[0] = in[1] = in[2] = in[3] = false;
  const PlaneCopy cp(g, tid, y0 - 1, x0 - 4);
  const bool copies = tid < kUH * kQ;
  // the thread's float4 of E (staged row er, float4 tid % kQ): fine columns
  // x0 - 4 + 4 f' .. + 3 take staged coarse columns 2 f' + 2 .. 2 f' + 4;
  // fine row y0 - 1 + er is odd when er is even (staged coarse rows er / 2
  // and er / 2 + 1), even when er is odd (row (er + 1) / 2)
  const int er = tid / kQ;
  const int e_at = ((er & 1) ? (er + 1) / 2 : er / 2) * kEW + 2 * (tid % kQ) + 2;

  const int s0 = z0 - 1, steps = z1 - z0 + 2;  // z0 is even: s0 is odd
  auto ec_slot = [&](int zc) { return se + ((zc + kEStages) % kEStages) * kEH * kEW; };
  // group i: b plane s0 + i and, when that plane is even and another plane
  // follows it, the coarse plane its step prolongs; group 0 also the two
  // coarse planes of the prologue
  auto stage = [&](int i) {
    const int s = s0 + i;
    if (i == 0)
      for (int zc = s0 >> 1; zc <= (s0 >> 1) + 1; ++zc)
        stage_coarse(g, ec, zc, Y0, X0, dc, ho, wo, ec_slot(zc));
    if (i < steps) {
      if (copies) cp.issue(g, b, s, sb + (i % kUStages) * kUH * kW + 4 * tid);
      if (!(s & 1) && s + 1 <= z1)
        stage_coarse(g, ec, s / 2 + 1, Y0, X0, dc, ho, wo, ec_slot(s / 2 + 1));
    }
    ist::cp_async_commit();
  };
  // prolong staged coarse plane zc along y, then x, into its E slot
  auto prolong_yx = [&](int zc) {
    if (tid >= kUH * kQ) return;
    const float* e = ec_slot(zc) + e_at;
    float T[3];
#pragma unroll
    for (int c = 0; c < 3; ++c) T[c] = (er & 1) ? e[c] : ist::midpoint(e[c], e[kEW + c]);
    st4(sE + (zc & 1) * kUH * kW + 4 * tid,
        F4{{T[0], ist::midpoint(T[0], T[1]), T[1], ist::midpoint(T[1], T[2])}});
  };
  for (int i = 0; i < kLook; ++i) stage(i);
  ist::cp_async_wait<kLook - 1>();
  __syncthreads();
  prolong_yx(s0 >> 1);
  prolong_yx((s0 >> 1) + 1);

  F4 xm{}, xc{}, xn{}, bc{}, bn{};
  for (int i = 0; i < steps; ++i) {
    const int s = s0 + i;
    ist::cp_async_wait<kLook - 1>();
    __syncthreads();  // plane s has landed; every thread is done with step i - 1
    stage(i + kLook);
    if (!(s & 1) && s + 1 <= z1) prolong_yx(s / 2 + 1);
    float* xt = sx + (i & 1) * kUH * kW;
    const bool zin = s > 0 && s < g.nz;
    if (rl >= 0) {
      // x~(s) = cs b + Pz E: E of coarse plane s / 2 (s even), or the
      // midpoint of planes (s - 1) / 2 and (s + 1) / 2
      F4 bv = ld4(sb + (i % kUStages) * kUH * kW + at);
      const F4 lo = ld4(sE + ((s >> 1) & 1) * kUH * kW + at);
      F4 pz = lo;
      if (s & 1) {
        const F4 hi = ld4(sE + (((s >> 1) + 1) & 1) * kUH * kW + at);
#pragma unroll
        for (int e = 0; e < 4; ++e) pz.v[e] = ist::midpoint(lo.v[e], hi.v[e]);
      }
      F4 xv;
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const bool q = zin && in[e];
        bv.v[e] = q ? bv.v[e] : 0.f;
        xv.v[e] = q ? ist::corrected_at(cs, bv.v[e], pz.v[e]) : 0.f;
      }
      st4(xt + at, xv);
      xm = xc;
      xc = xn;
      xn = xv;
      bc = bn;
      bn = bv;
    }
    if (i < 2 || !own) continue;
    // sweep plane t = s - 1 from x~(t) (the tile of step i - 1) and the
    // thread's x~(t - 1), x~(t), x~(t + 1), b(t)
    const int t = s - 1;
    const bool tin = t > 0 && t < g.nz;
    const float* xp = sx + ((i - 1) & 1) * kUH * kW;
    const float wv = __shfl_up_sync(0xffffffffu, xc.v[3], 1);
    const float ev = __shfl_down_sync(0xffffffffu, xc.v[0], 1);
    const float W = lane == 0 ? xp[at - 1] : wv, E = lane == 31 ? xp[at + 4] : ev;
    const F4 N = ld4(xp + at - kW), S = ld4(xp + at + kW);
    F4 o;
#pragma unroll
    for (int e = 0; e < 4; ++e)
      o.v[e] = (tin && in[e]) ? ist3::smooth7(k, cs, bc.v[e],
                                              Nbr{xc.v[e], e ? xc.v[e - 1] : W,
                                                  e < 3 ? xc.v[e + 1] : E, N.v[e], S.v[e],
                                                  xm.v[e], xn.v[e]})
                              : 0.f;
    st4(out + g.at(t, y0 + warp, x0 + 4 * lane), o);
  }
}

// J3: the plain 7-point march (ist3::zstream) over x; b is read in the
// emit as one float4 a lane, only where one of the lane's nodes is interior
// (as R3 reads bh, bl), and each interior node takes ist3::smooth7, the
// rounding of the plain version.
__global__ void __launch_bounds__(ist3::kZThreads)
    k_jacobi3d_kernel(const float* __restrict__ x, const float* __restrict__ b,
                      float* __restrict__ out, Box g, Coef k, float cs) {
  extern __shared__ __align__(16) float smem[];
  const ist3::ZSource src[1] = {{x}};
  ist3::zstream<1>(g, 0, 0, src, smem,
                   [&](int t, int r, int c, const bool (&in)[4], const ist3::Nbr4 (&v)[1]) {
                     const size_t idx = g.at(t, r, c);
                     F4 o{};
                     if (in[0] || in[1] || in[2] || in[3]) {
                       const F4 bv = ld4(b + idx);
#pragma unroll
                       for (int e = 0; e < 4; ++e)
                         if (in[e]) o.v[e] = ist3::smooth7(k, cs, bv.v[e], v[0].at(e));
                     }
                     st4(out + idx, o);
                   });
}

}  // namespace

// bz: coarse planes per block (D3), fine planes per block, even (U3)
extern "C" int ist_k_down3d(const float* b, float* out, int nx, int ny, int nz, int d, int hp,
                            int wp, int bz, int dc, int ho, int wo, float cd, float cx,
                            float cy, float cz, float cs, cudaStream_t stream) {
  const Box g{nx, ny, nz, d, hp, wp, bz};
  if (bz < 1 || wp % 128 || hp % 8) return (int)cudaErrorInvalidValue;
  const size_t smem = down_smem();
  if (int e = (int)cudaFuncSetAttribute((const void*)k_down3d_kernel,
                                        cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem))
    return e;
  const dim3 grid((wo + kCX - 1) / kCX, (ho + kCY - 1) / kCY, (dc + bz - 1) / bz);
  k_down3d_kernel<<<grid, kDThreads, smem, stream>>>(b, out, g, Coef{cd, cx, cy, cz}, cs, dc,
                                                     ho, wo);
  return (int)cudaGetLastError();
}

extern "C" int ist_k_up3d(const float* b, const float* ec, float* out, int nx, int ny, int nz,
                          int d, int hp, int wp, int bz, int dc, int ho, int wo, float cd,
                          float cx, float cy, float cz, float cs, cudaStream_t stream) {
  const Box g{nx, ny, nz, d, hp, wp, bz};
  if (bz < 2 || bz % 2 || wp % kTX || hp % kTY) return (int)cudaErrorInvalidValue;
  const size_t smem = up_smem();
  if (int e = (int)cudaFuncSetAttribute((const void*)k_up3d_kernel,
                                        cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem))
    return e;
  const dim3 grid(wp / kTX, hp / kTY, (d + bz - 1) / bz);
  k_up3d_kernel<<<grid, kUThreads, smem, stream>>>(b, ec, out, g, Coef{cd, cx, cy, cz}, cs, dc,
                                                   ho, wo);
  return (int)cudaGetLastError();
}

// bz: planes per block (kernels/stencil3d_layout.py: zstream_chunk)
extern "C" int ist_k_jacobi3d(const float* x, const float* b, float* out, int nx, int ny,
                              int nz, int d, int hp, int wp, int bz, float cd, float cx,
                              float cy, float cz, float cs, cudaStream_t stream) {
  const Box g{nx, ny, nz, d, hp, wp, bz};
  if (!ist3::zstream_fits(g)) return (int)cudaErrorInvalidValue;
  const size_t smem = ist3::zstream_smem(1);
  if (int e = (int)cudaFuncSetAttribute((const void*)k_jacobi3d_kernel,
                                        cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem))
    return e;
  k_jacobi3d_kernel<<<ist3::zstream_grid(g), ist3::kZThreads, smem, stream>>>(
      x, b, out, g, Coef{cd, cx, cy, cz}, cs);
  return (int)cudaGetLastError();
}
