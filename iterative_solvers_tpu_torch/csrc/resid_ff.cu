// Compensated double-f32 true residual (rh, rl) = (bh + bl) - A (xh + xl).
//
// Replaces iterative_solvers_tpu/kernels/resid_ff.py:_make_k_resid_ff_2d (A8)
// and, for the 3D box, its 3D bodies (R3, below): the only high-precision
// work of the double-f32 refinement outer. On a custom domain the JAX
// package runs the jnp ops/ddf32.residual_ff instead (its kernel takes no
// mask operand); the port runs A8's kMask = true instantiation
// (ist_k_resid_ff_custom), which reads the int8 interior mask (+1 B/node)
// and computes exactly that residual on the custom interior.
//
// What bounds it on an H100: a memory-bound sweep. It reads xh, xl, bh, bl
// and writes rh, rl: 24 B/node. The ~60 f32 operations per node are far
// below the card's f32 rate for those bytes. Each thread owns one column of a
// band and walks its rows, keeping the rows above and below of xh and xl in
// registers; column neighbours are re-read through L1. Every read of xh and
// xl is masked by the interior (predicate or custom mask), and so is the output.
//
// Rounding: the arithmetic is ops/ddf32.residual_ff operation for operation,
// in its order: TwoSum first differences per axis, the coefficient applied
// exactly (a power of two) or by Dekker's TwoProd with f32 constants split on
// the host, Σ axis errors, then A xl, then delta * xh, then the renormalising
// TwoSums. nvcc contracts a * b + c into one FMA by default, which breaks
// TwoSum and Dekker's split, so every operation here is a __fadd_rn /
// __fsub_rn / __fmul_rn intrinsic, which is never contracted: rh matches the
// plain torch version bit for bit. The library's other kernels keep nvcc's
// default contraction.
#include "common.cuh"
#include "zstream3d.cuh"

using ist::Geom;
using ist::TW;

namespace {

struct AxisC {
  int pow2;
  float cf, cf_hi, cf_lo, c_lo;
};

struct FF {
  float s, e;
};

__device__ __forceinline__ FF two_sum(float a, float b) {
  const float s = __fadd_rn(a, b);
  const float bb = __fsub_rn(s, a);
  return {s, __fadd_rn(__fsub_rn(a, __fsub_rn(s, bb)), __fsub_rn(b, bb))};
}

// (main, err) of c * (t + e_sum) for the exact pair t + e_sum
__device__ __forceinline__ FF scaled_term(float t, float e_sum, const AxisC& c) {
  if (c.pow2) return {__fmul_rn(c.cf, t), __fmul_rn(c.cf, e_sum)};
  const float p = __fmul_rn(c.cf, t);
  const float k = __fmul_rn(4097.f, t);
  const float t_hi = __fsub_rn(k, __fsub_rn(k, t));
  const float t_lo = __fsub_rn(t, t_hi);
  const float pe = __fadd_rn(
      __fadd_rn(__fadd_rn(__fsub_rn(__fmul_rn(c.cf_hi, t_hi), p), __fmul_rn(c.cf_hi, t_lo)),
                __fmul_rn(c.cf_lo, t_hi)),
      __fmul_rn(c.cf_lo, t_lo));
  return {p, __fadd_rn(__fadd_rn(pe, __fmul_rn(c.c_lo, t)), __fmul_rn(c.cf, e_sum))};
}

// (main, err) of c * (lo - 2 x + hi) through exact first differences
__device__ __forceinline__ FF axis_diff2(float x, float lo, float hi, const AxisC& c) {
  const FF d1 = two_sum(lo, -x);
  const FF d2 = two_sum(hi, -x);
  const FF t = two_sum(d1.s, d2.s);
  return scaled_term(t.s, __fadd_rn(__fadd_rn(d1.e, d2.e), t.e), c);
}

template <bool kMask>
__global__ void k_resid_ff_kernel(const float* __restrict__ xh, const float* __restrict__ xl,
                                  const float* __restrict__ bh, const float* __restrict__ bl,
                                  float* __restrict__ rh, float* __restrict__ rl, Geom g,
                                  int by, AxisC ax, AxisC ay, int has_delta, float delta) {
  const int c = blockIdx.x * TW + threadIdx.x;
  const int row0 = blockIdx.y * by;
  const int wp = g.wp;
  // masked reads; the interior test also keeps every read on the canvas
  auto H = [&](int i, int cc) -> float {
    return ist::interior<kMask>(g, i, cc) ? xh[(size_t)i * wp + cc] : 0.f;
  };
  auto L = [&](int i, int cc) -> float {
    return ist::interior<kMask>(g, i, cc) ? xl[(size_t)i * wp + cc] : 0.f;
  };
  float h_up = H(row0 - 1, c), h = H(row0, c);
  float l_up = L(row0 - 1, c), l = L(row0, c);
  for (int k = 0; k < by; ++k) {
    const int i = row0 + k;
    const size_t idx = (size_t)i * wp + c;
    const float h_dn = H(i + 1, c);
    const float l_dn = L(i + 1, c);
    float o_h = 0.f, o_l = 0.f;
    if (ist::interior<kMask>(g, i, c)) {
      const FF mx = axis_diff2(h, H(i, c - 1), H(i, c + 1), ax);
      const FF my = axis_diff2(h, h_up, h_dn, ay);
      // plain f32 A xl, in the stencil's order: cd x + cx (W + E) + cy (N + S)
      const float axl = __fadd_rn(
          __fadd_rn(__fmul_rn(g.cd, l), __fmul_rn(g.cx, __fadd_rn(L(i, c - 1), L(i, c + 1)))),
          __fmul_rn(g.cy, __fadd_rn(l_up, l_dn)));
      float corr = __fadd_rn(__fadd_rn(mx.e, my.e), axl);
      if (has_delta) corr = __fadd_rn(corr, __fmul_rn(delta, h));
      const FF S = two_sum(mx.s, my.s);
      const FF t1 = two_sum(bh[idx], -S.s);
      const float r_lo = __fadd_rn(__fsub_rn(__fsub_rn(bl[idx], S.e), corr), t1.e);
      const FF r = two_sum(t1.s, r_lo);
      o_h = r.s;
      o_l = r.e;
    }
    rh[idx] = o_h;
    rl[idx] = o_l;
    h_up = h;
    h = h_dn;
    l_up = l;
    l = l_dn;
  }
}

// R3: the 3D box on the (d, hp, wp) layout. Replaces
// iterative_solvers_tpu/kernels/resid_ff.py:_make_k_resid_ff_3d (B10, one
// plane per program) and _make_k_resid_ff_chunked_3d (B11, bz planes per
// program). It runs the staged z-march of csrc/zstream3d.cuh on two rings,
// xh and xl: each plane of both is staged once per chunk by 16-byte
// cp.async copies kLook planes ahead, a lane's four nodes take their
// z - 1, z, z + 1 values from registers and their rows above and below from
// shared memory; bh and bl are read once, a float4 a lane, and rh and rl
// written so. 24 B/node, ~90 uncontracted f32 operations per node. Order,
// as ops/ddf32.residual_ff: axis mains and errors x, y, z; the mains summed
// exactly x + y, then + z (TwoSum, errors summed in order);
// corr = ((ex + ey) + ez) + A xl (+ delta xh), A xl as S7 computes it.
// Four nodes a lane fit two blocks an SM without spills (108 registers);
// the kernel reaches 73 % of its bound at 512^3, against 42 % on S7's
// z-march (NVIDIA H100 80GB HBM3, 700 W; PERF.md).
struct ResidFF3 {
  AxisC ax, ay, az;
  ist3::Coef k;
  int has_delta;
  float delta;

  // (rh, rl) at an interior node: xh's and xl's values around it, bh and bl
  __device__ __forceinline__ FF at(const ist3::Nbr& vh, const ist3::Nbr& vl, float bh,
                                   float bl) const {
    const float h = vh.c;
    const FF mx = axis_diff2(h, vh.w, vh.e, ax);
    const FF my = axis_diff2(h, vh.n, vh.s, ay);
    const FF mz = axis_diff2(h, vh.zm, vh.zp, az);
    // plain f32 A xl, in the stencil's order (S7's fmaf chain)
    const float axl = ist3::apply7(k, vl);
    float corr = __fadd_rn(__fadd_rn(__fadd_rn(mx.e, my.e), mz.e), axl);
    if (has_delta) corr = __fadd_rn(corr, __fmul_rn(delta, h));
    const FF S2 = two_sum(mx.s, my.s);
    const FF S = two_sum(S2.s, mz.s);
    const float es = __fadd_rn(S2.e, S.e);
    const FF t1 = two_sum(bh, -S.s);
    const float r_lo = __fadd_rn(__fsub_rn(__fsub_rn(bl, es), corr), t1.e);
    return two_sum(t1.s, r_lo);
  }
};

__global__ void __launch_bounds__(ist3::kZThreads, 2)
    k_resid_ff3d_kernel(const float* __restrict__ xh, const float* __restrict__ xl,
                        const float* __restrict__ bh, const float* __restrict__ bl,
                        float* __restrict__ rh, float* __restrict__ rl, ist3::Box g,
                        ResidFF3 f) {
  extern __shared__ __align__(16) float smem[];
  const ist3::ZSource src[2] = {{xh}, {xl}};
  ist3::zstream<2>(g, 0, 0, src, smem,
                   [&](int t, int r, int c, const bool (&in)[4], const ist3::Nbr4 (&v)[2]) {
                     const size_t idx = g.at(t, r, c);
                     ist3::F4 oh{}, ol{};
                     if (in[0] || in[1] || in[2] || in[3]) {
                       const ist3::F4 b_h = ist3::ld4(bh + idx), b_l = ist3::ld4(bl + idx);
#pragma unroll
                       for (int e = 0; e < 4; ++e)
                         if (in[e]) {
                           const FF o = f.at(v[0].at(e), v[1].at(e), b_h.v[e], b_l.v[e]);
                           oh.v[e] = o.s;
                           ol.v[e] = o.e;
                         }
                     }
                     ist3::st4(rh + idx, oh);
                     ist3::st4(rl + idx, ol);
                   });
}

}  // namespace

// bz: planes per block (kernels/stencil3d_layout.py: zstream_chunk)
extern "C" int ist_k_resid_ff3d(const float* xh, const float* xl, const float* bh,
                                const float* bl, float* rh, float* rl, int nx, int ny, int nz,
                                int d, int hp, int wp, int bz, int pow2_x, int pow2_y,
                                int pow2_z, int has_delta, float cd, float cx, float cy, float cz,
                                float cx_hi, float cx_lo, float cx_res, float cy_hi, float cy_lo,
                                float cy_res, float cz_hi, float cz_lo, float cz_res, float delta,
                                cudaStream_t stream) {
  const ist3::Box g{nx, ny, nz, d, hp, wp, bz};
  if (!ist3::zstream_fits(g)) return (int)cudaErrorInvalidValue;
  const ResidFF3 f{AxisC{pow2_x, cx, cx_hi, cx_lo, cx_res},
                   AxisC{pow2_y, cy, cy_hi, cy_lo, cy_res},
                   AxisC{pow2_z, cz, cz_hi, cz_lo, cz_res},
                   ist3::Coef{cd, cx, cy, cz},
                   has_delta,
                   delta};
  const size_t smem = ist3::zstream_smem(2);
  if (int e = (int)cudaFuncSetAttribute((const void*)k_resid_ff3d_kernel,
                                        cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem))
    return e;
  k_resid_ff3d_kernel<<<ist3::zstream_grid(g), ist3::kZThreads, smem, stream>>>(
      xh, xl, bh, bl, rh, rl, g, f);
  return (int)cudaGetLastError();
}

extern "C" int ist_k_resid_ff(const float* xh, const float* xl, const float* bh,
                              const float* bl, float* rh, float* rl, int nx, int ny,
                              int gamma, int hp, int wp, int by, int pow2_x, int pow2_y,
                              int has_delta, float cd, float cx, float cy, float cx_hi,
                              float cx_lo, float cx_res, float cy_hi, float cy_lo,
                              float cy_res, float delta, cudaStream_t stream) {
  const Geom g{nx, ny, gamma, hp, wp, cd, cx, cy};
  const AxisC ax{pow2_x, cx, cx_hi, cx_lo, cx_res};
  const AxisC ay{pow2_y, cy, cy_hi, cy_lo, cy_res};
  k_resid_ff_kernel<false><<<dim3(wp / TW, hp / by), TW, 0, stream>>>(
      xh, xl, bh, bl, rh, rl, g, by, ax, ay, has_delta, delta);
  return (int)cudaGetLastError();
}

extern "C" int ist_k_resid_ff_custom(const float* xh, const float* xl, const float* bh,
                                     const float* bl, float* rh, float* rl, const int8_t* mask,
                                     int nx, int ny, int hp, int wp, int by, int pow2_x,
                                     int pow2_y, int has_delta, float cd, float cx, float cy,
                                     float cx_hi, float cx_lo, float cx_res, float cy_hi,
                                     float cy_lo, float cy_res, float delta,
                                     cudaStream_t stream) {
  const Geom g{nx, ny, 0, hp, wp, cd, cx, cy, mask};
  const AxisC ax{pow2_x, cx, cx_hi, cx_lo, cx_res};
  const AxisC ay{pow2_y, cy, cy_hi, cy_lo, cy_res};
  k_resid_ff_kernel<true><<<dim3(wp / TW, hp / by), TW, 0, stream>>>(
      xh, xl, bh, bl, rh, rl, g, by, ax, ay, has_delta, delta);
  return (int)cudaGetLastError();
}
