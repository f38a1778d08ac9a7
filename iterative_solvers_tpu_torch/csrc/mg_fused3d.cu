// Fused legs of the 3D V-cycle's fine levels (D3, U3) and the weighted-Jacobi
// sweep of the FMG warm start (J3), on the padded (d, hp, wp) layout.
//
// D3 (k_down3d) replaces iterative_solvers_tpu/kernels/mg_fused3d.py:
//   _make_k_resid_3d (B3) + _make_k_zrestrict (B4), and their chunked fusion
//   _make_k_down_chunked_3d (B6): the residual of the pre-smoothed iterate
//   x = (omega/d) b, z-restricted [1,2,1]/4, written as the half-depth
//   (dc, hp, wp) field, dc = nz/2 + 1. The y/x restriction stays in torch.
// U3 (k_up3d) replaces _make_k_up_3d (B5) and _make_k_up_chunked_3d (B7):
//   the z-prolongation of the y/x-prolonged coarse correction ec (dc, hp, wp),
//   the corrected iterate x~ = (omega/d) b + Pz ec and one post-smoothing
//   sweep x~ + (omega/d)(b - A x~). Fine plane t takes ec[t/2] (even) or the
//   mean of ec[(t-1)/2] and ec[(t+1)/2] (odd); coarse planes outside [0, dc)
//   read as 0.
// J3 (k_jacobi3d) replaces _make_k_jacobi_3d (B8) and
//   _make_k_jacobi_chunked_3d (B9): x + (omega/d)(b - A x), with masked
//   reads of x and b and masked output.
//
// What bounds them on an H100: memory-bound sweeps with no tensor-core work.
// D3 reads b once (4 B/node) and writes half as many nodes (2 B/node): 6
// B/node. U3 reads b and ec and writes the iterate: 10 B/node. J3 reads x
// and b and writes: 12 B/node. The pre-smoothed iterate, the residual before
// restriction and the corrected iterate are formed in registers and the
// shared tile and never stored. All three march z (csrc/zmarch3d.cuh), so
// one kernel serves every depth: the TPU's per-plane and z-chunked bodies,
// and its ragged tail, are one code path here.
#include "zmarch3d.cuh"

using ist3::Box;
using ist3::Coef;
using ist3::Nbr;

namespace {

// grid z: chunks of g.bz coarse planes; each marches fine planes 2c0-1 .. 2c1-1
__global__ void k_down3d_kernel(const float* __restrict__ b, float* __restrict__ rr, Box g,
                                 Coef k, float cs, int dc) {
  const int c0 = blockIdx.z * g.bz, c1 = min(c0 + g.bz, dc);
  auto B = [&](int z, int r, int c) -> float {
    return g.interior(z, r, c) ? b[g.at(z, r, c)] : 0.f;
  };
  float acc = 0.f;  // the coarse plane being summed: 1/4 R[2C-1] + 1/2 R[2C] + 1/4 R[2C+1]
  const int t1 = min(2 * c1, g.d);
  ist3::zmarch(2 * c0 - 1, t1, B, [&](int t, int r, int c, const Nbr& v) {
    // residual of the pre-smoothed iterate x = cs * B at fine plane t
    float R = 0.f;
    if (g.interior(t, r, c)) {
      const Nbr x{__fmul_rn(cs, v.c), __fmul_rn(cs, v.w), __fmul_rn(cs, v.e),
                  __fmul_rn(cs, v.n), __fmul_rn(cs, v.s), __fmul_rn(cs, v.zm),
                  __fmul_rn(cs, v.zp)};
      R = __fsub_rn(v.c, ist3::apply7(k, x));
    }
    if (t & 1) {  // t = 2C + 1: last term of coarse plane C, first of C + 1
      acc += 0.25f * R;
      const int C = (t - 1) / 2;
      if (C >= c0 && g.on_canvas(r, c)) rr[g.at(C, r, c)] = acc;
      acc = 0.25f * R;
    } else {
      acc += 0.5f * R;
    }
  });
  // the march ended on an even plane 2C: plane 2C + 1 lies off the volume
  const int tl = t1 - 1, r = blockIdx.y * ist3::TY + threadIdx.y,
            c = blockIdx.x * ist3::TX + threadIdx.x;
  if (!(tl & 1) && g.on_canvas(r, c)) rr[g.at(tl / 2, r, c)] = acc;
}

__global__ void k_up3d_kernel(const float* __restrict__ b, const float* __restrict__ ec,
                              float* __restrict__ out, Box g, Coef k, float cs, int dc) {
  const int z0 = blockIdx.z * g.bz;
  auto EC = [&](int zc, int r, int c) -> float {
    return (zc >= 0 && zc < dc) ? ec[g.at(zc, r, c)] : 0.f;
  };
  // corrected iterate cs * b + Pz ec at fine plane s (zero off the interior)
  auto XC = [&](int s, int r, int c) -> float {
    if (!g.interior(s, r, c)) return 0.f;
    const float p =
        (s & 1) ? 0.5f * (EC((s - 1) / 2, r, c) + EC((s + 1) / 2, r, c)) : EC(s / 2, r, c);
    return cs * b[g.at(s, r, c)] + p;
  };
  ist3::zmarch(z0, min(z0 + g.bz, g.d), XC, [&](int t, int r, int c, const Nbr& v) {
    if (!g.on_canvas(r, c)) return;
    float o = 0.f;
    if (g.interior(t, r, c)) o = v.c + cs * (b[g.at(t, r, c)] - ist3::apply7(k, v));
    out[g.at(t, r, c)] = o;
  });
}

__global__ void k_jacobi3d_kernel(const float* __restrict__ x, const float* __restrict__ b,
                                  float* __restrict__ out, Box g, Coef k, float cs) {
  const int z0 = blockIdx.z * g.bz;
  auto X = [&](int z, int r, int c) -> float {
    return g.interior(z, r, c) ? x[g.at(z, r, c)] : 0.f;
  };
  ist3::zmarch(z0, min(z0 + g.bz, g.d), X, [&](int t, int r, int c, const Nbr& v) {
    if (!g.on_canvas(r, c)) return;
    float o = 0.f;
    if (g.interior(t, r, c)) o = v.c + cs * (b[g.at(t, r, c)] - ist3::apply7(k, v));
    out[g.at(t, r, c)] = o;
  });
}

}  // namespace

extern "C" int ist_k_down3d(const float* b, float* rr, int nx, int ny, int nz, int d, int hp,
                            int wp, int bz, int dc, float cd, float cx, float cy, float cz,
                            float cs, cudaStream_t stream) {
  const Box g{nx, ny, nz, d, hp, wp, bz};
  k_down3d_kernel<<<ist3::grid_dim(g, dc), ist3::block_dim(), 0, stream>>>(
      b, rr, g, Coef{cd, cx, cy, cz}, cs, dc);
  return (int)cudaGetLastError();
}

extern "C" int ist_k_up3d(const float* b, const float* ec, float* out, int nx, int ny, int nz,
                          int d, int hp, int wp, int bz, int dc, float cd, float cx, float cy,
                          float cz, float cs, cudaStream_t stream) {
  const Box g{nx, ny, nz, d, hp, wp, bz};
  k_up3d_kernel<<<ist3::grid_dim(g, d), ist3::block_dim(), 0, stream>>>(
      b, ec, out, g, Coef{cd, cx, cy, cz}, cs, dc);
  return (int)cudaGetLastError();
}

extern "C" int ist_k_jacobi3d(const float* x, const float* b, float* out, int nx, int ny,
                              int nz, int d, int hp, int wp, int bz, float cd, float cx,
                              float cy, float cz, float cs, cudaStream_t stream) {
  const Box g{nx, ny, nz, d, hp, wp, bz};
  k_jacobi3d_kernel<<<ist3::grid_dim(g, d), ist3::block_dim(), 0, stream>>>(
      x, b, out, g, Coef{cd, cx, cy, cz}, cs);
  return (int)cudaGetLastError();
}
