// Per-row and per-tile HEVC deblocking arithmetic, shared by the CUDA
// kernels (deblock_kernel.cu, built by nvcc) and the host build that the
// CPU tests load (host_shim.cpp, built by g++).  The filter math of one
// segment row (row_terms, luma_decision, strong_row, normal_row,
// chroma_row) is written once here; the thread-per-tile loop below (T5)
// and the quad of deblock_quad.cuh (K1, K1c, K1-i16, K1-i16c) both call it.
//
// The compute type T is int (K1, K1c, T5) or int16_t (K1-i16, K1-i16c, the
// JAX package's dtype=int16 path).  A tile is the 64 pixels of one shifted
// 8x8 tile, t[row * 8 + col], held in T.  deblock_tile<T, CHROMA> runs the
// four edge phases in the reference's order (quirk Q7): upper-vert, lower-vert,
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

// -- the filter math of one segment row ------------------------------------------
//
// Written once, per row, and called by both kernel designs: the thread per
// tile below (T5) and the quad of four lanes per tile (deblock_quad.cuh,
// K1, K1c, K1-i16, K1-i16c).  p[j] and q[j] are the row's pixels at
// distance j from the edge on the P and Q side.

// The BS gate of a segment (luma: BS > 0, chroma: BS == 2; cpu.h:164, 463).
template <bool CHROMA>
GVCT_HD bool gated_on(int bs) { return CHROMA ? bs == 2 : bs > 0; }

// A luma segment row's part of the segment's decision (cpu.h:1074-1114):
// its second derivatives dp and dq (cond1, cond5 and cond6 add them over
// rows 0 and 3) and whether it passes cond2-cond4 of the strong filter.
// The same struct holds a segment's terms: rows 0 and 3 added.
struct RowTerms {
  int dp, dq;
  bool strong;
};

GVCT_HD RowTerms add_terms(const RowTerms& a, const RowTerms& b) {
  return RowTerms{a.dp + b.dp, a.dq + b.dq, a.strong && b.strong};
}

// dp and dq of a row (strong left false).
template <typename T>
GVCT_HD RowTerms row_d(const int (&p)[4], const int (&q)[4]) {
  return RowTerms{absn<T>(p[2] - 2 * p[1] + p[0]), absn<T>(q[2] - 2 * q[1] + q[0]), false};
}

// cond2-cond4 of a row whose dp and dq are rt's.
template <typename T>
GVCT_HD bool row_strong(const int (&p)[4], const int (&q)[4], const RowTerms& rt,
                        const Thresholds& th) {
  return nar<T>(rt.dp + rt.dq) < th.beta8 &&                                 // cond2
         nar<T>(absn<T>(p[3] - p[0]) + absn<T>(q[0] - q[3])) < th.beta8 &&  // cond3
         absn<T>(p[0] - q[0]) < th.tc52;                                      // cond4
}

template <typename T>
GVCT_HD RowTerms row_terms(const int (&p)[4], const int (&q)[4], const Thresholds& th) {
  RowTerms rt = row_d<T>(p, q);
  rt.strong = row_strong<T>(p, q, rt, th);
  return rt;
}

// cond1 (cpu.h:1086) fails: the segment is left as it is.
template <typename T>
GVCT_HD bool skips(const RowTerms& seg, const Thresholds& th) {
  return nar<T>(seg.dp + seg.dq) >= th.beta;
}

enum LumaMode : int { kSkip, kStrong, kNormal };

struct LumaDecision {
  int mode;
  bool cond5, cond6;
};

// The segment's decision from its terms (add_terms of rows 0 and 3).
template <typename T>
GVCT_HD LumaDecision luma_decision(const RowTerms& seg, const Thresholds& th) {
  LumaDecision d;
  d.mode = skips<T>(seg, th) ? kSkip : seg.strong ? kStrong : kNormal;
  d.cond5 = nar<T>(seg.dp) < th.beta316;
  d.cond6 = nar<T>(seg.dq) < th.beta316;
  return d;
}

// Strong filter of one row, distances 0-2 (cpu.h:1128-1213, in
// ops/filters.py's value form).
template <typename T>
GVCT_HD void strong_row(int (&p)[4], int (&q)[4], int c) {
  const int p0 = p[0], p1 = p[1], p2 = p[2], p3 = p[3];
  const int q0 = q[0], q1 = q[1], q2 = q[2], q3 = q[3];
  const int s = p1 + p0 + q0;
  const int u = q1 + q0 + p0;
  p[0] = clip2n<T>(p0 + clip1n<T>(shr<T>(2 * s + p2 + q1 + 4, 3) - p0, c));
  p[1] = clip2n<T>(p1 + clip1n<T>(shr<T>(s + p2 + 2, 2) - p1, c));
  p[2] = clip2n<T>(p2 + clip1n<T>(shr<T>(2 * (p3 + p2) + p2 + s + 4, 3) - p2, c));
  q[0] = clip2n<T>(q0 + clip1n<T>(shr<T>(2 * u + q2 + p1 + 4, 3) - q0, c));
  q[1] = clip2n<T>(q1 + clip1n<T>(shr<T>(u + q2 + 2, 2) - q1, c));
  q[2] = clip2n<T>(q2 + clip1n<T>(shr<T>(2 * (q3 + q2) + q2 + u + 4, 3) - q2, c));
}

// Normal filter of one row (cpu.h:1215-1357): the row's own |delta0| gate,
// then p1/q1 under the segment's cond5/cond6.
template <typename T>
GVCT_HD void normal_row(int (&p)[4], int (&q)[4], const LumaDecision& dec, const Thresholds& th) {
  const int p0 = p[0], p1 = p[1], p2 = p[2];
  const int q0 = q[0], q1 = q[1], q2 = q[2];
  const int delta0 = shr<T>(9 * (q0 - p0) - 3 * (q1 - p1) + 8, 4);
  if (absn<T>(delta0) >= th.tc10) return;
  const int d = clip1(delta0, th.tc2);
  p[0] = clip2n<T>(p0 + d);
  q[0] = clip2n<T>(q0 - d);
  if (dec.cond5) p[1] = clip2n<T>(p1 + clip1(shr<T>(shr<T>(p2 + p0 + 1, 1) - p1 + d, 1), th.tc_half));
  if (dec.cond6) q[1] = clip2n<T>(q1 + clip1(shr<T>(shr<T>(q2 + q0 + 1, 1) - q1 - d, 1), th.tc_half));
}

// One luma row under its segment's decision.
template <typename T>
GVCT_HD void luma_row(int (&p)[4], int (&q)[4], const LumaDecision& dec, const Thresholds& th) {
  if (dec.mode == kStrong) {
    strong_row<T>(p, q, th.tc2);
  } else if (dec.mode == kNormal) {
    normal_row<T>(p, q, dec, th);
  }
}

// One chroma row: only distance 0 changes (cpu.h:1431-1488).  dq is
// computed with its operands swapped and then subtracted (cpu.h:1453-1461,
// 1475-1476): a floor shift of a negative number is not symmetric, so it
// is not -dp.
template <typename T>
GVCT_HD void chroma_row(int& p0, int p1, int& q0, int q1, int tc) {
  const int dp = clip1(shr<T>(4 * (p0 - q0) + p1 - q1 + 4, 3), tc);
  const int dq = clip1(shr<T>(4 * (q0 - p0) + q1 - p1 + 4, 3), tc);
  const int np = clip2n<T>(p0 + dp);
  q0 = clip2n<T>(q0 - dq);
  p0 = np;
}

// -- one thread per tile (T5) -------------------------------------------------------

// Luma segment: 4 rows x 4 pixels per side, distances 0-2 may change
// (cpu.h:1359-1429).  cond1 is tested on dp and dq alone, before the strong
// conditions; the strong/normal choice is one branch for the four rows.
// All reads come before the writes they feed.
template <typename T, int PHASE>
GVCT_HD void luma_segment(T (&t)[64], const Thresholds& th) {
  int p[4][4], q[4][4];
#pragma unroll
  for (int r = 0; r < 4; ++r) {
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      p[r][j] = t[p_at<PHASE>(r, j)];
      q[r][j] = t[q_at<PHASE>(r, j)];
    }
  }
  RowTerms r0 = row_d<T>(p[0], q[0]), r3 = row_d<T>(p[3], q[3]);
  if (skips<T>(add_terms(r0, r3), th)) return;
  r0.strong = row_strong<T>(p[0], q[0], r0, th);
  r3.strong = r0.strong && row_strong<T>(p[3], q[3], r3, th);
  const LumaDecision dec = luma_decision<T>(add_terms(r0, r3), th);
  if (dec.mode == kStrong) {
#pragma unroll
    for (int r = 0; r < 4; ++r) strong_row<T>(p[r], q[r], th.tc2);
  } else {
#pragma unroll
    for (int r = 0; r < 4; ++r) normal_row<T>(p[r], q[r], dec, th);
  }
#pragma unroll
  for (int r = 0; r < 4; ++r) {
#pragma unroll
    for (int j = 0; j < 3; ++j) {
      t[p_at<PHASE>(r, j)] = p[r][j];
      t[q_at<PHASE>(r, j)] = q[r][j];
    }
  }
}

// Chroma segment: 4 rows x 2 pixels per side.
template <typename T, int PHASE>
GVCT_HD void chroma_segment(T (&t)[64], int tc) {
#pragma unroll
  for (int r = 0; r < 4; ++r) {
    int p0 = t[p_at<PHASE>(r, 0)], q0 = t[q_at<PHASE>(r, 0)];
    chroma_row<T>(p0, t[p_at<PHASE>(r, 1)], q0, t[q_at<PHASE>(r, 1)], tc);
    t[p_at<PHASE>(r, 0)] = p0;
    t[q_at<PHASE>(r, 0)] = q0;
  }
}

template <typename T, bool CHROMA, int PHASE>
GVCT_HD void segment(T (&t)[64], int bs, const Thresholds& th) {
  if (!gated_on<CHROMA>(bs)) return;
  if constexpr (CHROMA) {
    chroma_segment<T, PHASE>(t, th.tc);
  } else {
    luma_segment<T, PHASE>(t, th);
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
// tile + (r * 8 + c) * plane (plane = Bx for T5's rows layout
// R[by, r, c, bx]).  Its four BS bytes are at `map` in each map.  `in` may equal
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
