// Per-tile HEVC deblocking arithmetic, shared by the CUDA kernel
// (deblock_kernel.cu, built by nvcc) and the host build that the CPU tests
// load (host_shim.cpp, built by g++).
//
// A tile is the 64 pixels of one shifted 8x8 tile, t[row * 8 + col], held
// as int.  deblock_tile<CHROMA> runs the four edge phases in the reference's
// order (quirk Q7): upper-vert, lower-vert, left-hor, right-hor, each gated
// by its BS byte (luma: BS > 0, chroma: BS == 2; cpu.h:164, 463).  Segment
// geometry is ops/deblock.py::_SEGMENT_GEOMETRY, including the Q3 P/Q column
// mismatch of right-hor; the formulas are those of ops/filters.py.  All math
// is int with arithmetic right shift of negative values (Q8; what nvcc and
// g++ do, and what C++20 requires).
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
template <int PHASE>
GVCT_HD void luma_segment(int (&t)[64], const Thresholds& th) {
  int p[4][4], q[4][4];
#pragma unroll
  for (int r = 0; r < 4; ++r) {
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      p[r][j] = t[p_at<PHASE>(r, j)];
      q[r][j] = t[q_at<PHASE>(r, j)];
    }
  }
  const int dp0 = iabs(p[0][2] - 2 * p[0][1] + p[0][0]);
  const int dp3 = iabs(p[3][2] - 2 * p[3][1] + p[3][0]);
  const int dq0 = iabs(q[0][2] - 2 * q[0][1] + q[0][0]);
  const int dq3 = iabs(q[3][2] - 2 * q[3][1] + q[3][0]);
  if (dp0 + dq0 + dp3 + dq3 >= th.beta) return;  // cond1 (cpu.h:1086)

  const bool strong =
      (dp0 + dq0 < th.beta8) && (dp3 + dq3 < th.beta8) &&                 // cond2
      (iabs(p[0][3] - p[0][0]) + iabs(q[0][0] - q[0][3]) < th.beta8) &&   // cond3
      (iabs(p[3][3] - p[3][0]) + iabs(q[3][0] - q[3][3]) < th.beta8) &&
      (iabs(p[0][0] - q[0][0]) < th.tc52) && (iabs(p[3][0] - q[3][0]) < th.tc52);  // cond4

  if (strong) {  // cpu.h:1128-1213, in ops/filters.py's value form
    const int c = th.tc2;
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      const int p0 = p[r][0], p1 = p[r][1], p2 = p[r][2], p3 = p[r][3];
      const int q0 = q[r][0], q1 = q[r][1], q2 = q[r][2], q3 = q[r][3];
      const int s = p1 + p0 + q0;
      const int u = q1 + q0 + p0;
      t[p_at<PHASE>(r, 0)] = clip2(p0 + clip1(((2 * s + p2 + q1 + 4) >> 3) - p0, c));
      t[p_at<PHASE>(r, 1)] = clip2(p1 + clip1(((s + p2 + 2) >> 2) - p1, c));
      t[p_at<PHASE>(r, 2)] = clip2(p2 + clip1(((2 * (p3 + p2) + p2 + s + 4) >> 3) - p2, c));
      t[q_at<PHASE>(r, 0)] = clip2(q0 + clip1(((2 * u + q2 + p1 + 4) >> 3) - q0, c));
      t[q_at<PHASE>(r, 1)] = clip2(q1 + clip1(((u + q2 + 2) >> 2) - q1, c));
      t[q_at<PHASE>(r, 2)] = clip2(q2 + clip1(((2 * (q3 + q2) + q2 + u + 4) >> 3) - q2, c));
    }
    return;
  }
  // normal filter (cpu.h:1215-1357): per-row |delta0| gate, cond5/cond6
  const bool cond5 = dp0 + dp3 < th.beta316;
  const bool cond6 = dq0 + dq3 < th.beta316;
#pragma unroll
  for (int r = 0; r < 4; ++r) {
    const int p0 = p[r][0], p1 = p[r][1], p2 = p[r][2];
    const int q0 = q[r][0], q1 = q[r][1], q2 = q[r][2];
    const int delta0 = (9 * (q0 - p0) - 3 * (q1 - p1) + 8) >> 4;
    if (iabs(delta0) >= th.tc10) continue;
    const int d = clip1(delta0, th.tc2);
    t[p_at<PHASE>(r, 0)] = clip2(p0 + d);
    t[q_at<PHASE>(r, 0)] = clip2(q0 - d);
    if (cond5) t[p_at<PHASE>(r, 1)] = clip2(p1 + clip1((((p2 + p0 + 1) >> 1) - p1 + d) >> 1, th.tc_half));
    if (cond6) t[q_at<PHASE>(r, 1)] = clip2(q1 + clip1((((q2 + q0 + 1) >> 1) - q1 - d) >> 1, th.tc_half));
  }
}

// Chroma segment: 4 rows x 2 pixels per side, only distance 0 changes
// (cpu.h:1431-1488).  dq is computed with its operands swapped and then
// subtracted (cpu.h:1453-1461, 1475-1476): a floor shift of a negative
// number is not symmetric, so it is not -dp.
template <int PHASE>
GVCT_HD void chroma_segment(int (&t)[64], int tc) {
#pragma unroll
  for (int r = 0; r < 4; ++r) {
    const int p0 = t[p_at<PHASE>(r, 0)], p1 = t[p_at<PHASE>(r, 1)];
    const int q0 = t[q_at<PHASE>(r, 0)], q1 = t[q_at<PHASE>(r, 1)];
    const int dp = clip1((4 * (p0 - q0) + p1 - q1 + 4) >> 3, tc);
    const int dq = clip1((4 * (q0 - p0) + q1 - p1 + 4) >> 3, tc);
    t[p_at<PHASE>(r, 0)] = clip2(p0 + dp);
    t[q_at<PHASE>(r, 0)] = clip2(q0 - dq);
  }
}

template <bool CHROMA, int PHASE>
GVCT_HD void segment(int (&t)[64], int bs, const Thresholds& th) {
  if constexpr (CHROMA) {
    if (bs == 2) chroma_segment<PHASE>(t, th.tc);
  } else {
    if (bs > 0) luma_segment<PHASE>(t, th);
  }
}

// The four phases of one tile, in Q7 order; bs = {ver1, ver2, hor1, hor2}.
template <bool CHROMA>
GVCT_HD void deblock_tile(int (&t)[64], const int (&bs)[4], const Thresholds& th) {
  segment<CHROMA, 0>(t, bs[0], th);
  segment<CHROMA, 1>(t, bs[1], th);
  segment<CHROMA, 2>(t, bs[2], th);
  segment<CHROMA, 3>(t, bs[3], th);
}

// Load, filter and store the tile at `tile` of a tile-planes tensor whose
// (r, c) planes are `plane` bytes apart (T[r, c, by, bx] layout), with its
// four BS bytes at `map` in each map.  `in` may equal `out`: a tile's
// segments never leave the tile, and all 64 loads precede the stores.
template <bool CHROMA>
GVCT_HD void deblock_tile_at(const uint8_t* in, uint8_t* out,
                             const uint8_t* v1, const uint8_t* v2,
                             const uint8_t* h1, const uint8_t* h2,
                             size_t plane, size_t tile, size_t map,
                             const Thresholds& th) {
  int t[64];
#pragma unroll
  for (int k = 0; k < 64; ++k) t[k] = in[tile + k * plane];
  const int bs[4] = {v1[map], v2[map], h1[map], h2[map]};
  deblock_tile<CHROMA>(t, bs, th);
#pragma unroll
  for (int k = 0; k < 64; ++k) out[tile + k * plane] = static_cast<uint8_t>(t[k]);
}

}  // namespace gvct
