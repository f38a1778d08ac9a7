// Native bulk text IO for results persistence.
//
// The reference's ResultsIO (reference solver/dirichlet_solver.cpp:255-457)
// streams whole solution vectors through C++ iostreams; this framework's
// counterpart keeps the section layout in Python (results_io.py) and moves
// the bulk value<->text conversion — the actual hot loop, millions of values
// at 17 significant digits for large grids — into this engine, called via
// ctypes over preallocated buffers.
//
// Build: g++ -O3 -shared -fPIC -std=c++17 textio.cpp -o libtextio.so

#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>

extern "C" {

// One "%.17e\n" line per value. Returns bytes written, or -1 if `cap` is
// insufficient (caller sizes cap generously: 32 bytes/value is enough).
std::int64_t ist_format_doubles(const double* v, std::int64_t n, char* out,
                                std::int64_t cap) {
  std::int64_t pos = 0;
  for (std::int64_t i = 0; i < n; ++i) {
    if (cap - pos < 32) return -1;
    int w = std::snprintf(out + pos, 32, "%.17e\n", v[i]);
    if (w <= 0) return -1;
    pos += w;
  }
  return pos;
}

// gnuplot triples: "x y z\n" per node (reference dirichlet_solver.hpp:44-76).
std::int64_t ist_format_xyz(const double* x, const double* y, const double* z,
                            std::int64_t n, char* out, std::int64_t cap) {
  std::int64_t pos = 0;
  for (std::int64_t i = 0; i < n; ++i) {
    if (cap - pos < 96) return -1;
    int w = std::snprintf(out + pos, 96, "%.17e %.17e %.17e\n", x[i], y[i], z[i]);
    if (w <= 0) return -1;
    pos += w;
  }
  return pos;
}

// Parse whitespace-separated doubles from `buf` into `out` (up to `cap`).
// Stops at the first token that is not a number. Returns the count parsed;
// `consumed`, when non-null, receives the byte offset just past the last
// parsed value.
std::int64_t ist_parse_doubles(const char* buf, std::int64_t len, double* out,
                               std::int64_t cap, std::int64_t* consumed) {
  std::int64_t count = 0;
  const char* p = buf;
  const char* end = buf + len;
  while (count < cap) {
    while (p < end && (*p == ' ' || *p == '\n' || *p == '\r' || *p == '\t')) ++p;
    if (p >= end) break;
    char* next = nullptr;
    double v = std::strtod(p, &next);
    if (next == p) break;  // not a number (e.g. a section header)
    out[count++] = v;
    p = next;
  }
  if (consumed) *consumed = p - buf;
  return count;
}

}  // extern "C"
