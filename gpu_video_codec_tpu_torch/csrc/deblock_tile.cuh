// Per-row HEVC deblocking arithmetic, shared by the CUDA kernels
// (deblock_kernel.cu, built by nvcc) and the host build that the CPU tests
// load (host_shim.cpp, built by g++).  The filter math of one segment row
// (row_terms, luma_decision, strong_row, normal_row, chroma_row) is written
// once here; the quad of deblock_quad.cuh (K1, K1c, K1-i16, K1-i16c on the
// tile-planes layout, T5 on the rows layout) calls it.
//
// The compute type T is int (K1, K1c, T5, K2) or int16_t (K1-i16, K1-i16c,
// the JAX package's dtype=int16 path).  The bit depth BD is 8 (HEVC Main:
// every kernel) or 10 (Main 10: K2-10, deblock_packed_kernel<10>); it sets
// the clip of every filtered sample, [0, 2^BD - 1] (H.265 8.7.2.5's
// Clip1), and defaults to 8, so the 8-bit kernels compile as they did.  The
// thresholds come in scaled by 2^(BD - 8) (the C entries scale the tables'
// beta' and tc').  A tile's four edge phases run in the
// reference's order (quirk Q7): upper-vert, lower-vert, left-hor,
// right-hor, each gated by its BS byte (luma: BS > 0, chroma: BS == 2;
// cpu.h:164, 463).  Segment geometry is ops/deblock.py::_SEGMENT_GEOMETRY,
// including the Q3 P/Q column mismatch of right-hor; the formulas are those
// of ops/filters.py.  All math is int with arithmetic right shift of
// negative values (Q8; what nvcc and g++ do, and what C++20 requires),
// narrowed to T where T's own operations would wrap (nar below).
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
// [0, 2^BD - 1] clamp (cpu.h:1123-1126 at BD 8)
template <int BD = 8>
GVCT_HD int clip2(int v) {
  constexpr int kTop = (1 << BD) - 1;
  return v < 0 ? 0 : (v > kTop ? kTop : v);
}

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
template <typename T, int BD = 8>
GVCT_HD int clip2n(int v) { return clip2<BD>(nar<T>(v)); }

// -- the filter math of one segment row ------------------------------------------
//
// Written once, per row, and called by the quad of four lanes per tile
// (deblock_quad.cuh: K1, K1c, K1-i16, K1-i16c, T5) and, in two-lane form,
// mirrored by T1 (swar_tile.cuh).  p[j] and q[j] are the row's pixels at
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

// The segment's decision from its terms (rows 0 and 3 added).
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
template <typename T, int BD = 8>
GVCT_HD void strong_row(int (&p)[4], int (&q)[4], int c) {
  const int p0 = p[0], p1 = p[1], p2 = p[2], p3 = p[3];
  const int q0 = q[0], q1 = q[1], q2 = q[2], q3 = q[3];
  const int s = p1 + p0 + q0;
  const int u = q1 + q0 + p0;
  p[0] = clip2n<T, BD>(p0 + clip1n<T>(shr<T>(2 * s + p2 + q1 + 4, 3) - p0, c));
  p[1] = clip2n<T, BD>(p1 + clip1n<T>(shr<T>(s + p2 + 2, 2) - p1, c));
  p[2] = clip2n<T, BD>(p2 + clip1n<T>(shr<T>(2 * (p3 + p2) + p2 + s + 4, 3) - p2, c));
  q[0] = clip2n<T, BD>(q0 + clip1n<T>(shr<T>(2 * u + q2 + p1 + 4, 3) - q0, c));
  q[1] = clip2n<T, BD>(q1 + clip1n<T>(shr<T>(u + q2 + 2, 2) - q1, c));
  q[2] = clip2n<T, BD>(q2 + clip1n<T>(shr<T>(2 * (q3 + q2) + q2 + u + 4, 3) - q2, c));
}

// Normal filter of one row (cpu.h:1215-1357): the row's own |delta0| gate,
// then p1/q1 under the segment's cond5/cond6.
template <typename T, int BD = 8>
GVCT_HD void normal_row(int (&p)[4], int (&q)[4], const LumaDecision& dec, const Thresholds& th) {
  const int p0 = p[0], p1 = p[1], p2 = p[2];
  const int q0 = q[0], q1 = q[1], q2 = q[2];
  const int delta0 = shr<T>(9 * (q0 - p0) - 3 * (q1 - p1) + 8, 4);
  if (absn<T>(delta0) >= th.tc10) return;
  const int d = clip1(delta0, th.tc2);
  p[0] = clip2n<T, BD>(p0 + d);
  q[0] = clip2n<T, BD>(q0 - d);
  if (dec.cond5) {
    p[1] = clip2n<T, BD>(p1 + clip1(shr<T>(shr<T>(p2 + p0 + 1, 1) - p1 + d, 1), th.tc_half));
  }
  if (dec.cond6) {
    q[1] = clip2n<T, BD>(q1 + clip1(shr<T>(shr<T>(q2 + q0 + 1, 1) - q1 - d, 1), th.tc_half));
  }
}

// One luma row under its segment's decision.
template <typename T, int BD = 8>
GVCT_HD void luma_row(int (&p)[4], int (&q)[4], const LumaDecision& dec, const Thresholds& th) {
  if (dec.mode == kStrong) {
    strong_row<T, BD>(p, q, th.tc2);
  } else if (dec.mode == kNormal) {
    normal_row<T, BD>(p, q, dec, th);
  }
}

// One chroma row: only distance 0 changes (cpu.h:1431-1488).  dq is
// computed with its operands swapped and then subtracted (cpu.h:1453-1461,
// 1475-1476): a floor shift of a negative number is not symmetric, so it
// is not -dp.
template <typename T, int BD = 8>
GVCT_HD void chroma_row(int& p0, int p1, int& q0, int q1, int tc) {
  const int dp = clip1(shr<T>(4 * (p0 - q0) + p1 - q1 + 4, 3), tc);
  const int dq = clip1(shr<T>(4 * (q0 - p0) + q1 - p1 + 4, 3), tc);
  const int np = clip2n<T, BD>(p0 + dp);
  q0 = clip2n<T, BD>(q0 - dq);
  p0 = np;
}

}  // namespace gvct
