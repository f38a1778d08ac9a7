// The 5-point stencil written in place over its input (C4), and streamed
// through a ring of shared-memory row stages filled by cp.async (C5).
//
// Replaces iterative_solvers_tpu/kernels/stencil_pipelined.py:
//   _make_inplace_kernel (C4)   -> stencil_inplace_kernel<kMask>
//   _make_pipelined_kernel (C5) -> stencil_pipelined_kernel<kMask, L>
// kMask = true reads a custom layout's int8 interior (the *_custom
// launchers), as C1 does; both mask every read and the output, as the TPU
// kernels do, so an unmasked input (the nnz chain's all-ones canvas) is fine.
//
// What bounds them on an H100: one f32 read and one f32 write per node,
// 8 B/node (9 with the int8 mask); the staged halo rows add 2 rows per panel.
//
// In place, CUDA blocks run in no fixed order, so a block may read nothing
// that another block writes, and a thread nothing that another thread of
// its block may already have overwritten:
// - every block owns whole full-width panels, so there are no column edges
//   between blocks; the two rows just outside its rows (the only rows it
//   reads and others write) come from a side buffer staged before the
//   launch, as the TPU kernel's side operand is;
// - inside a block, row i is copied into shared memory before anyone
//   writes row i - 1, and the stencil reads rows only from shared memory,
//   so a global row is written only after its last global read.
//
// C4: one block per panel of `by` rows. A ring of three shared rows holds
// rows i - 1, i, i + 1; each step loads row i + 1 (one coalesced pass with
// no global stores, so its loads overlap), synchronises, and writes row i
// from shared memory. Shared memory: 3 rows of wp floats (99.8 KB at
// wp = 8320), above 48 KB by opt-in.
//
// C5: each block walks a contiguous range of panels through a ring of
// L + 2 row stages: rows i - 1 .. i + 1 resident, i + 2 .. i + L in flight
// as cp.async groups (16-byte copies, one commit group per row, waited with
// cp.async.wait_group L - 1). The TPU kernel's stages were panels and its
// write-back ring (n_out) kept stores in flight; here stores leave from
// registers, so there is no write-back ring. An optional scale folds into
// the epilogue, as in C4 (the TPU kernel has none; the SpMV chain needs it). In place, the rows bordering
// each block's range come from the side buffer; inside the range, row i is
// written only after its copy completed, and every copy in flight is of a
// row below i + 1. Out of place (y != x) no row is staged.
#include "common.cuh"

using ist::Geom;

namespace {

constexpr int kThreads = 1024;

__device__ __forceinline__ void cp_async16(float* smem, const float* gmem) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s), "l"(gmem) : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// Row i of the output from the shared rows prev (i - 1), cur (i) and next
// (i + 1); every thread writes its columns c = tid, tid + blockDim, ...
// kRaw: the rows hold the input as copied, so every read is masked here
// (C5); otherwise they were masked as they were loaded (C4).
template <bool kMask, bool kRaw>
__device__ __forceinline__ void write_row(const Geom& g, int i, const float* prev,
                                          const float* cur, const float* next, float scale,
                                          float* out) {
  const int wp = g.wp;
  auto at = [&](const float* row, int r, int c) -> float {
    if (c < 0 || c >= wp) return 0.f;
    return !kRaw || ist::interior<kMask>(g, r, c) ? row[c] : 0.f;
  };
  for (int c = threadIdx.x; c < wp; c += blockDim.x) {
    float o = 0.f;
    if (ist::interior<kMask>(g, i, c))
      o = ist::stencil5(g, cur[c], at(cur, i, c - 1), at(cur, i, c + 1), at(prev, i - 1, c),
                        at(next, i + 1, c)) * scale;
    out[(size_t)i * wp + c] = o;
  }
}

template <bool kMask>
__global__ void __launch_bounds__(kThreads)
    stencil_inplace_kernel(float* __restrict__ x, const float* __restrict__ side, Geom g, int by,
                           float scale) {
  extern __shared__ __align__(16) float ring3[];  // 3 rows of wp floats
  const int wp = g.wp;
  const int row0 = blockIdx.x * by;
  const float* up = side + (size_t)blockIdx.x * 2 * wp;  // row0 - 1, staged
  const float* dn = up + wp;                             // row0 + by, staged
  for (int c = threadIdx.x; c < wp; c += blockDim.x) {
    ring3[c] = ist::interior<kMask>(g, row0 - 1, c) ? up[c] : 0.f;
    ring3[wp + c] = ist::interior<kMask>(g, row0, c) ? x[(size_t)row0 * wp + c] : 0.f;
  }
  for (int k = 0; k < by; ++k) {
    const int i = row0 + k;
    // slot k % 3 holds row i - 1, (k + 1) % 3 row i, (k + 2) % 3 receives i + 1
    const float* prev = ring3 + (k % 3) * wp;
    const float* cur = ring3 + ((k + 1) % 3) * wp;
    float* next = ring3 + ((k + 2) % 3) * wp;
    const float* src = k + 1 < by ? x + (size_t)(i + 1) * wp : dn;
    // the slot being filled held row i - 2, last read before the previous
    // step's barrier (its columns by their owners only)
    for (int c = threadIdx.x; c < wp; c += blockDim.x)
      next[c] = ist::interior<kMask>(g, i + 1, c) ? src[c] : 0.f;
    __syncthreads();
    write_row<kMask, false>(g, i, prev, cur, next, scale, x);
  }
}

template <bool kMask, int L>
__global__ void __launch_bounds__(kThreads)
    stencil_pipelined_kernel(const float* x, float* y, const float* side, Geom g,
                             int rows_per_block, float scale) {
  constexpr int S = L + 2;  // ring stages
  extern __shared__ __align__(16) float stages[];  // S rows of wp floats
  const int wp = g.wp, hp = g.hp;
  const int r0 = blockIdx.x * rows_per_block;
  const int r1 = min(r0 + rows_per_block, hp);
  const float* up = side ? side + (size_t)blockIdx.x * 2 * wp : nullptr;
  // issue the copy of row j (t = j - r0 + 1) into its stage, then commit a
  // group (empty for rows off the canvas or past r1: those are masked, or
  // never read); every thread commits once per row, so the group counts
  // agree across threads
  auto fetch = [&](int j) {
    const int t = j - r0 + 1;
    if (j >= 0 && j < hp && j <= r1) {
      const float* src = x + (size_t)j * wp;
      if (up && j == r0 - 1) src = up;
      if (up && j == r1) src = up + wp;
      float* dst = stages + (t % S) * wp;
      for (int q = threadIdx.x; q < wp / 4; q += blockDim.x) cp_async16(dst + 4 * q, src + 4 * q);
    }
    cp_async_commit();
  };
  for (int j = r0 - 1; j < r0 + L; ++j) fetch(j);  // rows r0 - 1 .. r0 + L - 1
  for (int i = r0; i < r1; ++i) {
    const int t = i - r0 + 1;
    // the stage of row i + L held row i - 2, last read before the barrier
    // that closed the previous step
    fetch(i + L);
    cp_async_wait<L - 1>();  // this thread's copies of rows <= i + 1 landed
    __syncthreads();         // ... and every thread's
    const float* prev = stages + ((t - 1) % S) * wp;
    const float* cur = stages + (t % S) * wp;
    const float* next = stages + ((t + 1) % S) * wp;
    // masked reads: rows off the canvas (never copied) are never interior
    write_row<kMask, true>(g, i, prev, cur, next, scale, y);
    __syncthreads();  // every read of this step's stages before the next copies
  }
  cp_async_wait<0>();
}

int set_smem(const void* fn, size_t bytes) {
  return (int)cudaFuncSetAttribute(fn, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
}

template <bool kMask>
int launch_inplace(float* x, const float* side, const Geom& g, int by, float scale,
                   cudaStream_t stream) {
  const size_t smem = 3 * (size_t)g.wp * sizeof(float);
  if (int e = set_smem((const void*)stencil_inplace_kernel<kMask>, smem)) return e;
  stencil_inplace_kernel<kMask><<<g.hp / by, kThreads, smem, stream>>>(x, side, g, by, scale);
  return (int)cudaGetLastError();
}

template <bool kMask, int L>
int launch_pipelined_l(const float* x, float* y, const float* side, const Geom& g,
                       int rows_per_block, int blocks, float scale, cudaStream_t stream) {
  const size_t smem = (L + 2) * (size_t)g.wp * sizeof(float);
  if (int e = set_smem((const void*)stencil_pipelined_kernel<kMask, L>, smem)) return e;
  stencil_pipelined_kernel<kMask, L>
      <<<blocks, kThreads, smem, stream>>>(x, y, side, g, rows_per_block, scale);
  return (int)cudaGetLastError();
}

template <bool kMask>
int launch_pipelined(const float* x, float* y, const float* side, const Geom& g,
                     int rows_per_block, int lookahead, float scale, cudaStream_t stream) {
  const int blocks = (g.hp + rows_per_block - 1) / rows_per_block;
  switch (lookahead) {
    case 1: return launch_pipelined_l<kMask, 1>(x, y, side, g, rows_per_block, blocks, scale,
                                                     stream);
    case 2: return launch_pipelined_l<kMask, 2>(x, y, side, g, rows_per_block, blocks, scale,
                                                     stream);
    case 3: return launch_pipelined_l<kMask, 3>(x, y, side, g, rows_per_block, blocks, scale,
                                                     stream);
    case 4: return launch_pipelined_l<kMask, 4>(x, y, side, g, rows_per_block, blocks, scale,
                                                     stream);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

// x (hp, wp) is overwritten with scale * A x; side (hp / by, 2, wp) holds the
// rows just above and below each panel, staged from x before the launch.
extern "C" int ist_stencil_inplace(float* x, const float* side, int nx, int ny, int gamma, int hp,
                                   int wp, int by, float cd, float cx, float cy, float scale,
                                   cudaStream_t stream) {
  const Geom g{nx, ny, gamma, hp, wp, cd, cx, cy};
  return launch_inplace<false>(x, side, g, by, scale, stream);
}

extern "C" int ist_stencil_inplace_custom(float* x, const float* side, const int8_t* mask, int nx,
                                          int ny, int hp, int wp, int by, float cd, float cx,
                                          float cy, float scale, cudaStream_t stream) {
  const Geom g{nx, ny, 0, hp, wp, cd, cx, cy, mask};
  return launch_inplace<true>(x, side, g, by, scale, stream);
}

// y = scale * A x; y == x in place, with side (blocks, 2, wp) holding the
// rows just above and below each block's range; side == NULL out of place.
// `by` (the panel height) only sizes rows_per_block, a multiple of it.
extern "C" int ist_stencil_pipelined(const float* x, float* y, const float* side, int nx, int ny,
                                     int gamma, int hp, int wp, int by, float cd, float cx,
                                     float cy, float scale, int rows_per_block, int lookahead,
                                     cudaStream_t stream) {
  (void)by;
  const Geom g{nx, ny, gamma, hp, wp, cd, cx, cy};
  return launch_pipelined<false>(x, y, side, g, rows_per_block, lookahead, scale, stream);
}

extern "C" int ist_stencil_pipelined_custom(const float* x, float* y, const float* side,
                                            const int8_t* mask, int nx, int ny, int hp, int wp,
                                            int by, float cd, float cx, float cy, float scale,
                                            int rows_per_block, int lookahead,
                                            cudaStream_t stream) {
  (void)by;
  const Geom g{nx, ny, 0, hp, wp, cd, cx, cy, mask};
  return launch_pipelined<true>(x, y, side, g, rows_per_block, lookahead, scale, stream);
}
