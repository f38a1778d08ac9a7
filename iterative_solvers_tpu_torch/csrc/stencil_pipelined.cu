// The 5-point stencil written in place over its input (C4), and streamed
// in place or out of place with a chosen depth of copies in flight (C5):
// one streaming body for both.
//
// Replaces iterative_solvers_tpu/kernels/stencil_pipelined.py:
//   _make_inplace_kernel (C4)   -> stencil_stream_kernel<kMask, G>, depth set by the width
//   _make_pipelined_kernel (C5) -> stencil_stream_kernel<kMask, G>, depth = lookahead
// kMask = true reads a custom layout's int8 interior (the *_custom
// launchers), as C1 does; both mask every read and the output, as the TPU
// kernels do, so an unmasked input (the nnz chain's all-ones canvas) is fine.
//
// What bounds them on an H100: one f32 read and one f32 write per node,
// 8 B/node (9 with the int8 mask); the side rows add 2 rows per range.
//
// The grid follows the card, not the TPU's panel height: each block owns a
// contiguous range of `rows` full-width rows (the wrapper's planner gives
// one range per SM), so no two blocks share a column edge. A block streams
// its rows through a ring of `stages` = depth + 2 full-row stages in shared
// memory: rows i and i + 1 resident, rows i + 2 .. i + 1 + depth in flight
// while row i is computed. Each row arrives by one bulk copy (the TMA's
// 1-D form, `cp.async.bulk`) that one thread issues and that completes on
// the stage's mbarrier, so no register or instruction of the other threads
// is spent on loads. A thread owns G float4 column groups q = tid + k T and
// keeps row i - 1 of them in registers: when row i + 1 lands it masks its
// groups of that row and writes them back to the stage (so the row's
// horizontal neighbours are masked when it becomes row i), takes row i's
// horizontal neighbours from the lanes beside it (shuffles; the warp's two
// ends from the stage) and stores row i of the output as 16-byte stores
// from registers. The int8 mask (kMask) is read once per node, a step ahead
// into registers. G (1..5, the fewest groups a row of at most 1024 threads
// needs) is a template argument, so the per-group state stays in registers.
//
// In place, CUDA blocks run in no fixed order, so a block reads nothing
// that another block writes, and nothing of its own after writing it:
// - the two rows just outside a block's range (the only rows it reads that
//   others write) come from a side buffer that stage_side_kernel fills
//   before the stencil's launch, on the same stream, as the TPU kernel's
//   side operand is staged;
// - inside a block, global row i is written at step i, after its copy into
//   the ring completed (it was row i + 1 at step i - 1), and every copy in
//   flight is of a row below i + 1, so a row is written only after its one
//   global read.
// Out of place (y != x) the rows bordering a range are read from x itself.
// The TPU kernel's stages were panels and its write-back ring (n_out) kept
// stores in flight; here stores leave from registers. An optional scale
// multiplies the stencil's result (the TPU kernel has none; the SpMV chain
// needs it), after the expression that A1 evaluates, so at scale 1 both
// kernels equal A1 bit for bit.
#include "common.cuh"

using ist::Geom;

namespace {

constexpr int kMaxThreads = 1024;
constexpr int kMaxGroups = 5;  // float4 groups a thread: wp <= 4 * kMaxThreads * kMaxGroups
constexpr int kMaxStages = 6;  // depth <= 4 (MAX_LOOKAHEAD in the wrapper)

__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint64_t* bar) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;\n" ::"r"(smem_addr(bar)) : "memory");
}

// the barriers' initialisation, visible to the bulk copies that complete on them
__device__ __forceinline__ void mbar_init_fence() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(smem_addr(bar)) : "memory");
}

// the one arrival of a phase that also waits for `bytes` of copies
__device__ __forceinline__ void mbar_arrive_expect(uint64_t* bar, unsigned bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(smem_addr(bar)),
               "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void mbar_wait(uint64_t* bar, unsigned parity) {
  const unsigned a = smem_addr(bar);
  unsigned done;
  do {
    asm volatile(
        "{\n .reg .pred p;\n mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        " selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(a), "r"(parity)
        : "memory");
  } while (!done);
}

// `bytes` (a multiple of 16, both ends 16-byte aligned) from global to shared memory
__device__ __forceinline__ void bulk_load(void* dst, const void* src, unsigned bytes,
                                          uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];\n"
      ::"r"(smem_addr(dst)), "l"(src), "r"(bytes), "r"(smem_addr(bar))
      : "memory");
}

// order this thread's generic writes to shared memory before later bulk copies into it
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// kMask: the int8 mask's four bytes at row r, columns c .. c + 3 (0 off the
// canvas), one 4-byte load; the caller turns it into bits when it needs them
__device__ __forceinline__ unsigned mask_word(const Geom& g, int r, int c) {
  if (r < 0 || r >= g.hp) return 0u;
  return __ldg(reinterpret_cast<const unsigned*>(g.mask + (size_t)r * g.wp + c));
}

__device__ __forceinline__ unsigned word_bits(unsigned w) {
  return (unsigned)((w & 0xffu) != 0) | (unsigned)((w & 0xff00u) != 0) << 1 |
         (unsigned)((w & 0xff0000u) != 0) << 2 | (unsigned)((w & 0xff000000u) != 0) << 3;
}

// bit k: node (r, c + k) is interior
template <bool kMask>
__device__ __forceinline__ unsigned interior4(const Geom& g, int r, int c) {
  if constexpr (kMask) {
    return word_bits(mask_word(g, r, c));
  } else {
    const int2 s = ist::interior_span(g, r);
    unsigned b = 0;
#pragma unroll
    for (int k = 0; k < 4; ++k) b |= (unsigned)(c + k > s.x && c + k < s.y) << k;
    return b;
  }
}

__device__ __forceinline__ float4 masked(float4 v, unsigned b) {
  return make_float4(b & 1 ? v.x : 0.f, b & 2 ? v.y : 0.f, b & 4 ? v.z : 0.f,
                     b & 8 ? v.w : 0.f);
}

template <bool kMask, int G>
__global__ void __launch_bounds__(kMaxThreads, 1)
    stencil_stream_kernel(const float* x, float* y, const float* side, Geom g, int rows,
                          int stages, float scale) {
  extern __shared__ __align__(128) float4 ring[];  // `stages` rows of wp / 4 float4
  __shared__ uint64_t full[kMaxStages];
  const int wp = g.wp, hp = g.hp, nq = wp / 4, T = blockDim.x, tid = threadIdx.x;
  const int lane = tid & 31;
  const int r0 = blockIdx.x * rows, r1 = min(r0 + rows, hp);
  const float* up = side ? side + (size_t)blockIdx.x * 2 * wp : nullptr;  // rows r0 - 1, r1
  const unsigned row_bytes = (unsigned)wp * 4u;
  // row j (r0 - 1 <= j <= r1) takes stage t % stages, t = j - r0 + 1, and
  // completes the (t / stages)-th phase of that stage's barrier
  auto slot = [&](int j) { return (j - r0 + 1) % stages; };
  auto stage = [&](int j) { return ring + (size_t)slot(j) * nq; };
  auto wait_row = [&](int j) { mbar_wait(&full[slot(j)], (unsigned)((j - r0 + 1) / stages) & 1u); };
  auto fetch = [&](int j) {  // thread 0: the copy of row j (an arrival alone off the canvas)
    if (j > r1) return;
    uint64_t* bar = &full[slot(j)];
    if (j < 0 || j >= hp) {
      mbar_arrive(bar);
      return;
    }
    const float* src = x + (size_t)j * wp;
    if (up && j == r0 - 1) src = up;
    if (up && j == r1) src = up + wp;
    mbar_arrive_expect(bar, row_bytes);
    bulk_load(stage(j), src, row_bytes, bar);
  };
  if (tid == 0) {
    for (int s = 0; s < stages; ++s) mbar_init(&full[s]);
    mbar_init_fence();
  }
  __syncthreads();
  if (tid == 0)
    for (int j = r0 - 1; j < r0 - 1 + stages; ++j) fetch(j);

  // Thread tid owns the float4 groups q = tid + k T, k < G. T and nq are
  // multiples of 32, so a warp's 32 lanes hold 32 consecutive groups or none.
  float4 prev[G];    // row i - 1 of this thread's groups, masked
  unsigned mc[G];    // interior bits of row i
  unsigned mw[G];    // kMask: the mask word of row i + 1, loaded a step ahead
  wait_row(r0 - 1);
  wait_row(r0);
  {
    const float4* sp = stage(r0 - 1);
    float4* sc = stage(r0);
#pragma unroll
    for (int k = 0; k < G; ++k) {
      const int q = tid + k * T;
      if (q < nq) {
        prev[k] = masked(sp[q], interior4<kMask>(g, r0 - 1, 4 * q));
        mc[k] = interior4<kMask>(g, r0, 4 * q);
        sc[q] = masked(sc[q], mc[k]);
        if constexpr (kMask) mw[k] = mask_word(g, r0 + 1, 4 * q);
      }
    }
  }
  fence_proxy_async();
  __syncthreads();
  if (tid == 0) fetch(r0 - 1 + stages);  // into the stage of row r0 - 1

  for (int i = r0; i < r1; ++i) {
    wait_row(i + 1);
    const float4* cur4 = stage(i);
    const float* cur = reinterpret_cast<const float*>(cur4);
    float4* nxt4 = stage(i + 1);
#pragma unroll
    for (int k = 0; k < G; ++k) {
      const int q = tid + k * T;
      if (q < nq) {  // the whole warp or none of it
        const int c = 4 * q;
        unsigned mn;
        if constexpr (kMask) {
          mn = word_bits(mw[k]);
          mw[k] = mask_word(g, i + 2, c);
        } else {
          mn = interior4<false>(g, i + 1, c);
        }
        const float4 nv = masked(nxt4[q], mn);
        nxt4[q] = nv;  // row i + 1 masked, for its horizontal neighbours at step i + 1
        const float4 cv = cur4[q];
        // the horizontal neighbours from the lanes beside, the warp's ends from the stage
        float l = __shfl_up_sync(0xffffffffu, cv.w, 1);
        float r = __shfl_down_sync(0xffffffffu, cv.x, 1);
        if (lane == 0) l = c > 0 ? cur[c - 1] : 0.f;
        if (lane == 31) r = c + 4 < wp ? cur[c + 4] : 0.f;
        const float4 pv = prev[k];
        const unsigned m = mc[k];
        float4 o;
        o.x = m & 1 ? ist::stencil_rn(g, cv.x, l, cv.y, pv.x, nv.x) * scale : 0.f;
        o.y = m & 2 ? ist::stencil_rn(g, cv.y, cv.x, cv.z, pv.y, nv.y) * scale : 0.f;
        o.z = m & 4 ? ist::stencil_rn(g, cv.z, cv.y, cv.w, pv.z, nv.z) * scale : 0.f;
        o.w = m & 8 ? ist::stencil_rn(g, cv.w, cv.z, r, pv.w, nv.w) * scale : 0.f;
        reinterpret_cast<float4*>(y)[(size_t)i * nq + q] = o;
        prev[k] = cv;
        mc[k] = mn;
      }
    }
    // every read of row i's stage and every write-back of row i + 1 before
    // the stage of row i takes its next copy
    fence_proxy_async();
    __syncthreads();
    if (tid == 0) fetch(i + stages);
  }
}

// side[k] = the rows k rows - 1 and (k + 1) rows of x, zeros off the canvas
// (stage_rows in the wrapper is its plain version); one block a row.
__global__ void stage_side_kernel(const float* __restrict__ x, float* __restrict__ side, int hp,
                                  int wp, int rows) {
  const int k = blockIdx.x, e = blockIdx.y;
  const int j = e == 0 ? k * rows - 1 : (k + 1) * rows;
  const float4* src = reinterpret_cast<const float4*>(x + (size_t)j * wp);
  float4* dst = reinterpret_cast<float4*>(side + ((size_t)k * 2 + e) * wp);
  const bool on = j >= 0 && j < hp;
  for (int q = threadIdx.x; q < wp / 4; q += blockDim.x)
    dst[q] = on ? src[q] : make_float4(0.f, 0.f, 0.f, 0.f);
}

template <bool kMask, int G>
int launch_stream_g(const float* x, float* y, const float* side, const Geom& g, int rows,
                    int stages, float scale, cudaStream_t stream) {
  const int nq = g.wp / 4;
  const int threads = ((nq + G - 1) / G + 31) / 32 * 32;  // as few as cover a row in G groups
  const size_t smem = (size_t)stages * g.wp * sizeof(float);
  if (int e = (int)cudaFuncSetAttribute((const void*)stencil_stream_kernel<kMask, G>,
                                        cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem))
    return e;
  stencil_stream_kernel<kMask, G><<<(g.hp + rows - 1) / rows, threads, smem, stream>>>(
      x, y, side, g, rows, stages, scale);
  return (int)cudaGetLastError();
}

// y = scale * A x over `rows`-row ranges with `depth` copies in flight; y ==
// x in place, side (ranges, 2, wp) then receives the rows bordering each
// range before the stencil's launch; side == NULL out of place.
template <bool kMask>
int launch_stream(const float* x, float* y, float* side, const Geom& g, int rows, int depth,
                  float scale, cudaStream_t stream) {
  const int nq = g.wp / 4;
  const int groups = (nq + kMaxThreads - 1) / kMaxThreads;
  if (depth < 1 || depth + 2 > kMaxStages || groups > kMaxGroups || rows < 1 || g.wp % 128)
    return (int)cudaErrorInvalidValue;
  const int ranges = (g.hp + rows - 1) / rows;
  if (side) {
    stage_side_kernel<<<dim3(ranges, 2), 256, 0, stream>>>(x, side, g.hp, g.wp, rows);
    if (int e = (int)cudaGetLastError()) return e;
  }
  const int stages = depth + 2;
  switch (groups) {
    case 1: return launch_stream_g<kMask, 1>(x, y, side, g, rows, stages, scale, stream);
    case 2: return launch_stream_g<kMask, 2>(x, y, side, g, rows, stages, scale, stream);
    case 3: return launch_stream_g<kMask, 3>(x, y, side, g, rows, stages, scale, stream);
    case 4: return launch_stream_g<kMask, 4>(x, y, side, g, rows, stages, scale, stream);
    default: return launch_stream_g<kMask, 5>(x, y, side, g, rows, stages, scale, stream);
  }
}

}  // namespace

// C4: x (hp, wp) is overwritten with scale * A x; side (ranges, 2, wp) holds
// the rows just above and below each range of `rows` rows, staged from x
// before the launch.
extern "C" int ist_stencil_inplace(float* x, float* side, int nx, int ny, int gamma, int hp,
                                   int wp, int rows, float cd, float cx, float cy, float scale,
                                   int depth, cudaStream_t stream) {
  const Geom g{nx, ny, gamma, hp, wp, cd, cx, cy};
  return launch_stream<false>(x, x, side, g, rows, depth, scale, stream);
}

extern "C" int ist_stencil_inplace_custom(float* x, float* side, const int8_t* mask, int nx,
                                          int ny, int hp, int wp, int rows, float cd, float cx,
                                          float cy, float scale, int depth, cudaStream_t stream) {
  const Geom g{nx, ny, 0, hp, wp, cd, cx, cy, mask};
  return launch_stream<true>(x, x, side, g, rows, depth, scale, stream);
}

// C5: y = scale * A x; y == x in place, with side as C4's; side == NULL out
// of place.
extern "C" int ist_stencil_pipelined(const float* x, float* y, float* side, int nx, int ny,
                                     int gamma, int hp, int wp, int rows, float cd, float cx,
                                     float cy, float scale, int depth, cudaStream_t stream) {
  const Geom g{nx, ny, gamma, hp, wp, cd, cx, cy};
  return launch_stream<false>(x, y, side, g, rows, depth, scale, stream);
}

extern "C" int ist_stencil_pipelined_custom(const float* x, float* y, float* side,
                                            const int8_t* mask, int nx, int ny, int hp, int wp,
                                            int rows, float cd, float cx, float cy, float scale,
                                            int depth, cudaStream_t stream) {
  const Geom g{nx, ny, 0, hp, wp, cd, cx, cy, mask};
  return launch_stream<true>(x, y, side, g, rows, depth, scale, stream);
}
