// Per-tile HEVC deblocking arithmetic, shared by the CUDA kernel
// (deblock_kernel.cu, built by nvcc) and the host build that the CPU tests
// load (host_shim.cpp, built by g++).
//
// A tile is the 64 pixels of one shifted 8x8 tile, t[row * 8 + col], held
// in the compute type T: int (K1, K1c) or int16_t (K1-i16, the JAX
// package's dtype=int16 path).  deblock_tile<T, CHROMA> runs the four edge
// phases in the reference's order (quirk Q7): upper-vert, lower-vert,
// left-hor, right-hor, each gated by its BS byte (luma: BS > 0, chroma:
// BS == 2; cpu.h:164, 463).  Segment geometry is
// ops/deblock.py::_SEGMENT_GEOMETRY, including the Q3 P/Q column mismatch of
// right-hor; the formulas are those of ops/filters.py.  All math is int with
// arithmetic right shift of negative values (Q8; what nvcc and g++ do, and
// what C++20 requires), narrowed to T where T's own operations would wrap
// (nar below).
#pragma once

#include <cstddef>
#include <cstdint>

#ifdef __CUDACC__
#define GVCT_HD __host__ __device__ __forceinline__
#else
#define GVCT_HD inline
#endif

namespace gvct {

// Thresholds derived once per launch.  beta and tc are non-negative, so C++
// truncating division equals Python's floor division used by the reference
// model (cpu.h:1099, 1109, 1191, 1235-1236, 1245).
struct Thresholds {
  int beta, beta8, beta316, tc, tc2, tc52, tc_half, tc10;
};

GVCT_HD Thresholds make_thresholds(int beta, int tc) {
  Thresholds th;
  th.beta = beta;
  th.beta8 = beta / 8;
  th.beta316 = 3 * beta / 16;
  th.tc = tc;
  th.tc2 = 2 * tc;
  th.tc52 = 5 * tc / 2;
  th.tc_half = tc / 2;
  th.tc10 = 10 * tc;
  return th;
}

GVCT_HD int iabs(int x) { return x < 0 ? -x : x; }
// [-c, c] clamp (cpu.h:1117-1120); c >= 0
GVCT_HD int clip1(int d, int c) { return d < -c ? -c : (d > c ? c : d); }
// [0, 255] clamp (cpu.h:1123-1126)
GVCT_HD int clip2(int v) { return v < 0 ? 0 : (v > 255 ? 255 : v); }

// Narrowing to the compute type T.  C++ promotes int16_t operands to int,
// so T = int16_t's wrap-around is written out: + - * wrap alike whether a
// chain of them is narrowed after each operation or once at its end
// (arithmetic mod 2^16), so narrowing each chain before it reaches a
// shift, compare, abs, clamp or store gives what int16 vector operations
// give.  The conversion is modular in nvcc and g++ (and in C++20).  For
// T = int every helper is the plain operation, so K1's code is unchanged.
// Every threshold fits int16 (at most 10 * 24), so comparing a narrowed
// value with an int threshold is the int16 compare.
template <typename T>
GVCT_HD int nar(int x) { return static_cast<T>(x); }
template <typename T>
GVCT_HD int shr(int x, int k) { return nar<T>(x) >> k; }
template <typename T>
GVCT_HD int absn(int x) { return nar<T>(iabs(nar<T>(x))); }
template <typename T>
GVCT_HD int clip1n(int d, int c) { return clip1(nar<T>(d), c); }
template <typename T>
GVCT_HD int clip2n(int v) { return clip2(nar<T>(v)); }

// Tile-local index of P pixel (filter row r, distance j) and Q pixel, per
// phase 0..3 = upper-vert, lower-vert, left-hor, right-hor.
template <int PHASE>
GVCT_HD constexpr int p_at(int r, int j) {
  return PHASE == 0 ? r * 8 + (3 - j)
       : PHASE == 1 ? (4 + r) * 8 + (3 - j)
       : PHASE == 2 ? (3 - j) * 8 + r
                    : (3 - j) * 8 + 4 + r;  // right-hor: P from cols 4-7
}
template <int PHASE>
GVCT_HD constexpr int q_at(int r, int j) {
  return PHASE == 0 ? r * 8 + 4 + j
       : PHASE == 1 ? (4 + r) * 8 + 4 + j
                    : (4 + j) * 8 + r;      // left-hor and right-hor (Q3)
}

// Luma segment: 4 rows x 4 pixels per side, distances 0-2 may change
// (cpu.h:1359-1429).  All reads come before the writes they feed.
template <typename T, int PHASE>
GVCT_HD void luma_segment(T (&t)[64], const Thresholds& th) {
  T p[4][4], q[4][4];
#pragma unroll
  for (int r = 0; r < 4; ++r) {
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      p[r][j] = t[p_at<PHASE>(r, j)];
      q[r][j] = t[q_at<PHASE>(r, j)];
    }
  }
  const int dp0 = absn<T>(p[0][2] - 2 * p[0][1] + p[0][0]);
  const int dp3 = absn<T>(p[3][2] - 2 * p[3][1] + p[3][0]);
  const int dq0 = absn<T>(q[0][2] - 2 * q[0][1] + q[0][0]);
  const int dq3 = absn<T>(q[3][2] - 2 * q[3][1] + q[3][0]);
  if (nar<T>(dp0 + dq0 + dp3 + dq3) >= th.beta) return;  // cond1 (cpu.h:1086)

  const bool strong =
      (nar<T>(dp0 + dq0) < th.beta8) && (nar<T>(dp3 + dq3) < th.beta8) &&             // cond2
      (nar<T>(absn<T>(p[0][3] - p[0][0]) + absn<T>(q[0][0] - q[0][3])) < th.beta8) &&  // cond3
      (nar<T>(absn<T>(p[3][3] - p[3][0]) + absn<T>(q[3][0] - q[3][3])) < th.beta8) &&
      (absn<T>(p[0][0] - q[0][0]) < th.tc52) && (absn<T>(p[3][0] - q[3][0]) < th.tc52);  // cond4

  if (strong) {  // cpu.h:1128-1213, in ops/filters.py's value form
    const int c = th.tc2;
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      const int p0 = p[r][0], p1 = p[r][1], p2 = p[r][2], p3 = p[r][3];
      const int q0 = q[r][0], q1 = q[r][1], q2 = q[r][2], q3 = q[r][3];
      const int s = p1 + p0 + q0;
      const int u = q1 + q0 + p0;
      t[p_at<PHASE>(r, 0)] = clip2n<T>(p0 + clip1n<T>(shr<T>(2 * s + p2 + q1 + 4, 3) - p0, c));
      t[p_at<PHASE>(r, 1)] = clip2n<T>(p1 + clip1n<T>(shr<T>(s + p2 + 2, 2) - p1, c));
      t[p_at<PHASE>(r, 2)] = clip2n<T>(p2 + clip1n<T>(shr<T>(2 * (p3 + p2) + p2 + s + 4, 3) - p2, c));
      t[q_at<PHASE>(r, 0)] = clip2n<T>(q0 + clip1n<T>(shr<T>(2 * u + q2 + p1 + 4, 3) - q0, c));
      t[q_at<PHASE>(r, 1)] = clip2n<T>(q1 + clip1n<T>(shr<T>(u + q2 + 2, 2) - q1, c));
      t[q_at<PHASE>(r, 2)] = clip2n<T>(q2 + clip1n<T>(shr<T>(2 * (q3 + q2) + q2 + u + 4, 3) - q2, c));
    }
    return;
  }
  // normal filter (cpu.h:1215-1357): per-row |delta0| gate, cond5/cond6
  const bool cond5 = nar<T>(dp0 + dp3) < th.beta316;
  const bool cond6 = nar<T>(dq0 + dq3) < th.beta316;
#pragma unroll
  for (int r = 0; r < 4; ++r) {
    const int p0 = p[r][0], p1 = p[r][1], p2 = p[r][2];
    const int q0 = q[r][0], q1 = q[r][1], q2 = q[r][2];
    const int delta0 = shr<T>(9 * (q0 - p0) - 3 * (q1 - p1) + 8, 4);
    if (absn<T>(delta0) >= th.tc10) continue;
    const int d = clip1(delta0, th.tc2);
    t[p_at<PHASE>(r, 0)] = clip2n<T>(p0 + d);
    t[q_at<PHASE>(r, 0)] = clip2n<T>(q0 - d);
    if (cond5) t[p_at<PHASE>(r, 1)] = clip2n<T>(p1 + clip1(shr<T>(shr<T>(p2 + p0 + 1, 1) - p1 + d, 1), th.tc_half));
    if (cond6) t[q_at<PHASE>(r, 1)] = clip2n<T>(q1 + clip1(shr<T>(shr<T>(q2 + q0 + 1, 1) - q1 - d, 1), th.tc_half));
  }
}

// Chroma segment: 4 rows x 2 pixels per side, only distance 0 changes
// (cpu.h:1431-1488).  dq is computed with its operands swapped and then
// subtracted (cpu.h:1453-1461, 1475-1476): a floor shift of a negative
// number is not symmetric, so it is not -dp.
template <typename T, int PHASE>
GVCT_HD void chroma_segment(T (&t)[64], int tc) {
#pragma unroll
  for (int r = 0; r < 4; ++r) {
    const int p0 = t[p_at<PHASE>(r, 0)], p1 = t[p_at<PHASE>(r, 1)];
    const int q0 = t[q_at<PHASE>(r, 0)], q1 = t[q_at<PHASE>(r, 1)];
    const int dp = clip1(shr<T>(4 * (p0 - q0) + p1 - q1 + 4, 3), tc);
    const int dq = clip1(shr<T>(4 * (q0 - p0) + q1 - p1 + 4, 3), tc);
    t[p_at<PHASE>(r, 0)] = clip2n<T>(p0 + dp);
    t[q_at<PHASE>(r, 0)] = clip2n<T>(q0 - dq);
  }
}

template <typename T, bool CHROMA, int PHASE>
GVCT_HD void segment(T (&t)[64], int bs, const Thresholds& th) {
  if constexpr (CHROMA) {
    if (bs == 2) chroma_segment<T, PHASE>(t, th.tc);
  } else {
    if (bs > 0) luma_segment<T, PHASE>(t, th);
  }
}

// The four phases of one tile, in Q7 order; bs = {ver1, ver2, hor1, hor2}.
template <typename T, bool CHROMA>
GVCT_HD void deblock_tile(T (&t)[64], const int (&bs)[4], const Thresholds& th) {
  segment<T, CHROMA, 0>(t, bs[0], th);
  segment<T, CHROMA, 1>(t, bs[1], th);
  segment<T, CHROMA, 2>(t, bs[2], th);
  segment<T, CHROMA, 3>(t, bs[3], th);
}

// Load, filter and store the tile whose pixel (r, c) lies at
// tile + (r * 8 + c) * plane: plane = By*Bx for the tile-planes layout
// T[r, c, by, bx] (K1), plane = Bx for the rows layout R[by, r, c, bx]
// (T5).  Its four BS bytes are at `map` in each map.  `in` may equal
// `out`: a tile's segments never leave the tile, and all 64 loads precede
// the stores.
template <typename T, bool CHROMA>
GVCT_HD void deblock_tile_at(const uint8_t* in, uint8_t* out,
                             const uint8_t* v1, const uint8_t* v2,
                             const uint8_t* h1, const uint8_t* h2,
                             size_t plane, size_t tile, size_t map,
                             const Thresholds& th) {
  T t[64];
#pragma unroll
  for (int k = 0; k < 64; ++k) t[k] = in[tile + k * plane];
  const int bs[4] = {v1[map], v2[map], h1[map], h2[map]};
  deblock_tile<T, CHROMA>(t, bs, th);
#pragma unroll
  for (int k = 0; k < 64; ++k) out[tile + k * plane] = static_cast<uint8_t>(t[k]);
}

// T5's thread: tile (by, bx) of the rows layout R[by, r, c, bx] of a grid
// bx_n tiles wide, its BS bytes at (by, bx) of the (By, Bx) maps.
template <bool CHROMA>
GVCT_HD void deblock_rows_tile(const uint8_t* in, uint8_t* out,
                               const uint8_t* v1, const uint8_t* v2,
                               const uint8_t* h1, const uint8_t* h2,
                               int bx_n, size_t by, size_t bx, const Thresholds& th) {
  const size_t row = static_cast<size_t>(bx_n);
  deblock_tile_at<int, CHROMA>(in, out, v1, v2, h1, h2, row, by * 64 * row + bx, by * row + bx,
                               th);
}

}  // namespace gvct
