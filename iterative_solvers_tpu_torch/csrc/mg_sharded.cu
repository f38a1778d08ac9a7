// The fused V-cycle legs on one block of a mesh-sharded level: K_down (D3)
// and K_up with its optional dot epilogue (D4).
//
// ist_k_down_block replaces iterative_solvers_tpu/parallel/mg_sharded.py:
// _make_k_down_block / _k_down_call (D3); ist_k_up_block replaces
// _make_k_up_block / _k_up_call (D4).
//
// Each is its single-device leg tile (K_down, A5; K_up, A6) instantiated
// with kBlock (csrc/mg_tiles.cuh) on the block as a canvas of its own: D3 a
// tile of TJ coarse rows x 128 fine columns, b staged through registers and
// masked, the row-restricted residual (Hb/2, Wb) written in float4s; D4 a
// tile of 2 TJ fine rows x 128 columns, b and the lane-prolonged coarse
// correction ec staged by cp.async, the corrected iterate formed once per
// node into shared memory (neighbour columns included) and swept from
// there. The block's global origin (roff, coff; roff even) offsets the
// interior test and the row parity. The lane transfers stay with the mesh
// (parallel/mg_sharded.py), between the legs.
//
// Where the halos come from (raw values; every value is masked at its
// global node, or read only at an interior one):
// - D3 reads b at rows -2 .. Hb: the tiles at the block's first rows
//   stage rows -2, -1 from `up2`, the last tile row Hb from `dn`, 16 bytes
//   at a time as they stage the block's own rows. Its residual rows -1 ..
//   Hb - 1 need the neighbour columns -1 and Wb: `left` / `right` hold
//   them at rows -1 .. Hb - 1 (the sender puts its received row -1 in
//   front: the corner), staged 4 bytes a row by the tiles at the block's x
//   edges only.
// - D4 reads b at rows -1 .. Hb (`bup`, `bdn`) and ec at coarse rows goff -
//   1 .. goff + Hb/2 (goff = roff / 2; `ecup`, `ecdn`), rows outside [0,
//   ch) zero; at the neighbour columns b for rows 0 .. Hb - 1 (`bleft`,
//   `bright`) and ec for coarse rows goff .. goff + Hb/2 (`ecleft`,
//   `ecright`, the last one the sender's received row below: the corner).
//   The corrected iterate at the neighbour column is formed here, by the
//   same expression as inside the block.
// On a 1x1 mesh the ring hands the block its own last row and column: the
// global interior test zeros them. The TPU kernels zero the wrapped lane
// and correct the edge columns afterwards (edge strips, and a dot partial
// without the edge lanes); here the edge tiles read their neighbours
// directly and the dot partials (one per tile, summed by the caller in a
// fixed order) cover the whole block.
//
// What bounds them on an H100: memory, 6 and 10 B/node (the row-restricted
// residual out, the lane-prolonged correction in); the halo operands add
// O(Hb + Wb) reads per block. The tile heights come from
// kernels/mg_fused.tile_rows (parallel/mg_sharded.py: D3 16, 8 or 4, its
// last tile cut at the block's edge; D4 8 or 4, dividing Hb).
#include "mg_tiles.cuh"

using ist::Geom;
using ist_legs::LegHalo;
using ist_legs::LegSide;

extern "C" int ist_k_down_block(const float* b, const float* up2, const float* dn,
                                const float* left, const float* right, float* rr, int nx,
                                int ny, int gamma, int hb, int wb, int tj, int roff, int coff,
                                float cd, float cx, float cy, float cs, cudaStream_t stream) {
  const Geom g{nx, ny, gamma, hb, wb, cd, cx, cy};
  LegHalo h;
  h.b = LegSide{up2, dn, left, right, 2, -1, hb + 1};
  h.roff = roff;
  h.coff = coff;
  return ist_legs::launch_down<false, true>(b, rr, g, g, h, cs, tj, stream);
}

extern "C" int ist_k_up_block(const float* b, const float* bup, const float* bdn,
                              const float* bleft, const float* bright, const float* ec,
                              const float* ecup, const float* ecdn, const float* ecleft,
                              const float* ecright, float* out, float* dot_p, int nx, int ny,
                              int gamma, int hb, int wb, int tj, int ch, int roff, int coff,
                              float cd, float cx, float cy, float cs, cudaStream_t stream) {
  const Geom g{nx, ny, gamma, hb, wb, cd, cx, cy};
  LegHalo h;
  h.b = LegSide{bup, bdn, bleft, bright, 1, 0, hb};
  h.ec = LegSide{ecup, ecdn, ecleft, ecright, 1, 0, hb / 2 + 1};
  h.roff = roff;
  h.coff = coff;
  return ist_legs::launch_up<false, true>(b, ec, out, dot_p, g, h, cs, tj, wb, ch, stream);
}
