// Native CSR assembly engine for masked finite-difference grids.
//
// TPU-native framework's counterpart of the reference's C++ GridSystem
// assembly (reference solver/grid_system.cpp:157-274: per-node dynamic
// push_back construction with exception-based control flow). This engine is
// a different design: two flat passes over the node grid (count, then fill)
// with O(1) branch-free interior predicates, no allocation, no exceptions —
// it emits the CSR arrays for the compacted row-major unknown ordering
// directly into caller-provided buffers (Python/ctypes owns the memory).
//
// Geometry contract matches core/domain.py:
//   rect  : interior <=> 0 < ix < nx  &&  0 < iy < ny
//   gamma : rect-interior && !(ix <= nx/2 && iy <= ny/2)
// (the algebraic form of the reference predicates, grid_system.cpp:17-43).
//
// Build: g++ -O3 -march=native -shared -fPIC assembly.cpp -o libassembly.so

#include <cstdint>

namespace {

constexpr int kRect = 0;
constexpr int kGamma = 1;

struct Geom {
  int nx, ny, shape;

  inline bool interior(int ix, int iy) const {
    if (ix <= 0 || ix >= nx || iy <= 0 || iy >= ny) return false;
    if (shape == kGamma && ix <= nx / 2 && iy <= ny / 2) return false;
    return true;
  }
};

}  // namespace

extern "C" {

// Number of unknowns for the given geometry.
std::int64_t ist_num_unknowns(int nx, int ny, int shape) {
  Geom g{nx, ny, shape};
  std::int64_t n = 0;
  for (int iy = 1; iy < ny; ++iy)
    for (int ix = 1; ix < nx; ++ix) n += g.interior(ix, iy);
  return n;
}

// Compacted row-major rank of every node; -1 for non-interior.
// rank: (ny+1)*(nx+1) int64 buffer.
void ist_ranks(int nx, int ny, int shape, std::int64_t* rank) {
  Geom g{nx, ny, shape};
  std::int64_t r = 0;
  for (int iy = 0; iy <= ny; ++iy)
    for (int ix = 0; ix <= nx; ++ix)
      rank[(std::int64_t)iy * (nx + 1) + ix] = g.interior(ix, iy) ? r++ : -1;
}

// CSR assembly of the 5-point operator over interior unknowns.
// row_map: (N+1) int64; entries: (nnz) int64; values: (nnz) double.
// Within each row, entries are emitted in column order (west, south handled
// by symmetry of the scan): we emit (south, west, diag, east, north) which
// IS ascending column order for row-major ranking. Returns nnz, or -1 if
// the provided capacity is insufficient.
std::int64_t ist_assemble_csr(int nx, int ny, int shape, double cd, double cx,
                              double cy, std::int64_t capacity,
                              std::int64_t* row_map, std::int64_t* entries,
                              double* values) {
  Geom g{nx, ny, shape};
  const std::int64_t stride = nx + 1;

  // Rank arithmetic is closed-form for these shapes (row-major rank ==
  // number of interior nodes before the node): gamma rows 1..ny/2 hold
  // nx-1-nx/2 unknowns, the rest hold nx-1. No rank array, no allocation.
  const int half_x = nx / 2, half_y = ny / 2;
  const std::int64_t narrow = (shape == kGamma) ? (nx - 1 - half_x) : (nx - 1);
  const std::int64_t wide = nx - 1;

  auto row_start_rank = [&](std::int64_t iy) -> std::int64_t {
    const std::int64_t n_narrow =
        (shape == kGamma) ? (iy - 1 < half_y ? iy - 1 : half_y) : 0;
    const std::int64_t n_wide =
        (shape == kGamma) ? (iy - 1 > half_y ? iy - 1 - half_y : 0) : (iy - 1);
    return n_narrow * narrow + n_wide * wide;
  };

  auto rank_of = [&](int ix, int iy) -> std::int64_t {
    if (!g.interior(ix, iy)) return -1;
    const int first_ix = (shape == kGamma && iy <= half_y) ? half_x + 1 : 1;
    return row_start_rank(iy) + (ix - first_ix);
  };

  std::int64_t nnz = 0;
  std::int64_t row = 0;
  row_map[0] = 0;
  for (int iy = 1; iy < ny; ++iy) {
    const std::int64_t base = row_start_rank(iy);
    (void)base;
    for (int ix = 1; ix < nx; ++ix) {
      if (!g.interior(ix, iy)) continue;
      // neighbors in ascending-rank order: S, W, diag, E, N
      const int nix[5] = {ix, ix - 1, ix, ix + 1, ix};
      const int niy[5] = {iy - 1, iy, iy, iy, iy + 1};
      const double cv[5] = {cy, cx, cd, cx, cy};
      for (int k = 0; k < 5; ++k) {
        const std::int64_t c =
            (k == 2) ? row : rank_of(nix[k], niy[k]);
        if (c < 0) continue;
        if (nnz >= capacity) return -1;
        entries[nnz] = c;
        values[nnz] = cv[k];
        ++nnz;
      }
      ++row;
      row_map[row] = nnz;
    }
  }
  (void)stride;
  return nnz;
}

// 3D 7-point box assembly (core/domain.py Domain3D: interior is the open
// box 1..n-1 in every dimension; unknowns ranked row-major over (z, y, x)).
// Closed-form ranks, entries emitted in ascending column order
// (z-1, y-1, x-1, diag, x+1, y+1, z+1). Returns nnz, or -1 on capacity.
std::int64_t ist_assemble_csr3d(int nx, int ny, int nz, double cd, double cx,
                                double cy, double cz, std::int64_t capacity,
                                std::int64_t* row_map, std::int64_t* entries,
                                double* values) {
  const std::int64_t mx = nx - 1, my = ny - 1, mz = nz - 1;
  std::int64_t nnz = 0, row = 0;
  row_map[0] = 0;
  for (std::int64_t iz = 1; iz <= mz; ++iz)
    for (std::int64_t iy = 1; iy <= my; ++iy)
      for (std::int64_t ix = 1; ix <= mx; ++ix) {
        const std::int64_t dz[7] = {-1, 0, 0, 0, 0, 0, 1};
        const std::int64_t dy[7] = {0, -1, 0, 0, 0, 1, 0};
        const std::int64_t dx[7] = {0, 0, -1, 0, 1, 0, 0};
        const double cv[7] = {cz, cy, cx, cd, cx, cy, cz};
        for (int k = 0; k < 7; ++k) {
          const std::int64_t jz = iz + dz[k], jy = iy + dy[k], jx = ix + dx[k];
          if (jz < 1 || jz > mz || jy < 1 || jy > my || jx < 1 || jx > mx)
            continue;
          if (nnz >= capacity) return -1;
          entries[nnz] = ((jz - 1) * my + (jy - 1)) * mx + (jx - 1);
          values[nnz] = cv[k];
          ++nnz;
        }
        ++row;
        row_map[row] = nnz;
      }
  return nnz;
}

// Physical coordinates of each unknown, compacted order.
void ist_node_coords(int nx, int ny, int shape, double x0, double x1,
                     double y0, double y1, double* xs, double* ys) {
  Geom g{nx, ny, shape};
  const double hx = (x1 - x0) / nx, hy = (y1 - y0) / ny;
  std::int64_t r = 0;
  for (int iy = 1; iy < ny; ++iy)
    for (int ix = 1; ix < nx; ++ix)
      if (g.interior(ix, iy)) {
        xs[r] = x0 + ix * hx;
        ys[r] = y0 + iy * hy;
        ++r;
      }
}

}  // extern "C"
