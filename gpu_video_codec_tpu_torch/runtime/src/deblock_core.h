// Shared segment-filter core for the native CPU runtime.
//
// Everything the per-tile (scalar / SSE4.1) sweep needs: threshold tables,
// clip helpers, the phase coordinate maps, the bit-exact luma/chroma segment
// filters, and the per-tile gather/filter/scatter (`filter_tile_segment`).
// Lives in a header so BOTH translation units -- the baseline deblock_cpu.cpp
// and the AVX-512 batched path (deblock_cpu_avx512.cpp, compiled with wider
// ISA flags and selected by runtime cpuid) -- share one definition of the
// semantics; the AVX-512 row sweep falls back to these per-tile routines for
// tail tiles (nx % 4 != 0).
//
// Semantics match the golden model bit-for-bit, including the documented
// quirk decisions: out-of-bounds boundary-strength reads are defined as 0
// (Q2), the right-horizontal P/Q column mismatch (Q3), the intra-tile phase
// order (Q7), int32 arithmetic with arithmetic >> (Q8).  Reference locations
// cited as cpu.h:<line> (hevc_deblocking_filter_cpu.h).

#ifndef GVCT_DEBLOCK_CORE_H_
#define GVCT_DEBLOCK_CORE_H_

#include <cstdint>
#include <cstring>
#include <algorithm>

#ifdef __SSE4_1__
// SIMD segment filter: one SSE lane per filter row (4 rows per segment) --
// the same branchless lanes-over-rows formulation as the TPU VPU path
// (ops/filters.py), with bit-exact int32 semantics (_mm_srai_epi32 is the
// arithmetic >> of quirk Q8; min/max are exact clips).
#include <smmintrin.h>
#endif

namespace gvct {

constexpr int kBlock = 8;

// QP -> beta / tC lookup (HEVC spec constants; cpu.h:1021-1033 in the ref).
constexpr int kBeta[52] = {
    0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0,
    6, 7, 8, 9, 10, 11, 12, 13, 14, 15, 16, 17, 18, 20, 22, 24,
    26, 28, 30, 32, 34, 36, 38, 40, 42, 44, 46, 48, 50, 52, 54, 56,
    58, 60, 62, 64};
constexpr int kTc[52] = {
    0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0,
    0, 0, 1, 1, 1, 1, 1, 1, 1, 1, 1, 2, 2, 2, 2, 3,
    3, 3, 3, 4, 4, 4, 5, 5, 6, 6, 7, 8, 9, 10, 11, 13,
    14, 16, 18, 20};

inline int get_beta(int qp) { return kBeta[qp > 51 ? 51 : qp]; }
inline int get_tc(int qp) { return kTc[qp > 51 ? 51 : qp]; }

inline int clip1(int d, int c) { return std::min(std::max(-c, d), c); }
inline int clip2(int v) { return std::min(std::max(0, v), 255); }

// Tile-local (row, col) of the P/Q pixel at filter row r, edge distance j,
// per phase.  Phases: 0 upper-vert, 1 lower-vert, 2 left-hor, 3 right-hor.
// Same geometry table as ops/deblock.py `_SEGMENT_GEOMETRY`.  PHASE is a
// template parameter so every coordinate folds to a compile-time constant
// offset in the segment loops (the per-pixel switch dispatch of a runtime
// phase costs ~2x on the whole filter).
template <int PHASE>
inline void p_coord(int r, int j, int &row, int &col) {
  if (PHASE == 0)      { row = r;     col = 3 - j; }
  else if (PHASE == 1) { row = 4 + r; col = 3 - j; }
  else if (PHASE == 2) { row = 3 - j; col = r;     }
  else                 { row = 3 - j; col = 4 + r; }  // Q3: P from cols 4..7
}
template <int PHASE>
inline void q_coord(int r, int j, int &row, int &col) {
  if (PHASE == 0)      { row = r;     col = 4 + j; }
  else if (PHASE == 1) { row = 4 + r; col = 4 + j; }
  else                 { row = 4 + j; col = r;     }  // phases 2, 3 share Q cols 0..3
}

struct PlaneView {
  uint8_t *data;
  int stride;  // extended width
  inline uint8_t &at(int row, int col) const {
    // 64-bit offset: consistent with the pack/unpack transforms; int would
    // overflow for planes >= 2 GiB
    return data[(long long)row * stride + col];
  }
};

#ifdef __SSE4_1__
// 4 int32 lanes = the 4 filter rows of one segment.
inline __m128i clip1_v(__m128i d, __m128i c) {
  return _mm_min_epi32(_mm_max_epi32(_mm_sub_epi32(_mm_setzero_si128(), c), d), c);
}
inline __m128i clip2_v(__m128i v) {
  return _mm_min_epi32(_mm_max_epi32(_mm_setzero_si128(), v), _mm_set1_epi32(255));
}
#endif

// One luma segment, COLUMN-MAJOR grids: p[j][r] / q[j][r] = pixel at edge
// distance j, filter row r -- so each p[j]/q[j] is 4 contiguous int32 = one
// SSE vector, and the whole filter is elementwise over the row lanes (the
// same lanes-over-rows formulation as ops/filters.py on the TPU VPU).
// Filtered IN PLACE (deltas read only originals); `touched` = how many edge-
// distance columns changed.  Mirrors the decision + strong/normal cascade
// (golden model models/golden.py, ref cpu.h:1359-1429); int32 arithmetic
// with arithmetic >> throughout (quirk Q8).
inline void luma_segment(int p[4][4], int q[4][4], int beta, int tc, int &touched) {
  touched = 0;

  const int dp0 = std::abs(p[2][0] - 2 * p[1][0] + p[0][0]);
  const int dp3 = std::abs(p[2][3] - 2 * p[1][3] + p[0][3]);
  const int dq0 = std::abs(q[2][0] - 2 * q[1][0] + q[0][0]);
  const int dq3 = std::abs(q[2][3] - 2 * q[1][3] + q[0][3]);
  if (dp0 + dp3 + dq0 + dq3 >= beta) return;  // condition (1)

  const int b8 = beta / 8;
  const bool cond2 = (dp0 + dq0) < b8 && (dp3 + dq3) < b8;
  const bool cond3 =
      (std::abs(p[3][0] - p[0][0]) + std::abs(q[0][0] - q[3][0])) < b8 &&
      (std::abs(p[3][3] - p[0][3]) + std::abs(q[0][3] - q[3][3])) < b8;
  const int tc52 = 5 * tc / 2;
  const bool cond4 = std::abs(p[0][0] - q[0][0]) < tc52 &&
                     std::abs(p[0][3] - q[0][3]) < tc52;

#ifdef __SSE4_1__
  const __m128i p0 = _mm_loadu_si128((const __m128i *)p[0]);
  const __m128i p1 = _mm_loadu_si128((const __m128i *)p[1]);
  const __m128i p2 = _mm_loadu_si128((const __m128i *)p[2]);
  const __m128i p3 = _mm_loadu_si128((const __m128i *)p[3]);
  const __m128i q0 = _mm_loadu_si128((const __m128i *)q[0]);
  const __m128i q1 = _mm_loadu_si128((const __m128i *)q[1]);
  const __m128i q2 = _mm_loadu_si128((const __m128i *)q[2]);
  const __m128i q3 = _mm_loadu_si128((const __m128i *)q[3]);
  const __m128i v4 = _mm_set1_epi32(4);
#define ADD_ _mm_add_epi32
#define SUB_ _mm_sub_epi32
#define SLL_ _mm_slli_epi32
#define SRA_ _mm_srai_epi32

  if (cond2 && cond3 && cond4) {
    // strong filter: 3 pixels each side, all rows at once
    const __m128i c = _mm_set1_epi32(2 * tc);
    // (x2 + 2*x1 - 6*x0 + 2*y0 + y1 + 4) >> 3
    const __m128i d0p = clip1_v(SRA_(ADD_(ADD_(ADD_(p2, SLL_(p1, 1)),
        SUB_(ADD_(SLL_(q0, 1), q1), ADD_(SLL_(p0, 2), SLL_(p0, 1)))), v4), 3), c);
    const __m128i d0q = clip1_v(SRA_(ADD_(ADD_(ADD_(q2, SLL_(q1, 1)),
        SUB_(ADD_(SLL_(p0, 1), p1), ADD_(SLL_(q0, 2), SLL_(q0, 1)))), v4), 3), c);
    // (x2 - 3*x1 + x0 + y0 + 2) >> 2
    const __m128i two = _mm_set1_epi32(2);
    const __m128i d1p = clip1_v(SRA_(ADD_(ADD_(SUB_(p2, ADD_(SLL_(p1, 1), p1)),
        ADD_(p0, q0)), two), 2), c);
    const __m128i d1q = clip1_v(SRA_(ADD_(ADD_(SUB_(q2, ADD_(SLL_(q1, 1), q1)),
        ADD_(q0, p0)), two), 2), c);
    // (2*x3 - 5*x2 + x1 + x0 + y0 + 4) >> 3
    const __m128i d2p = clip1_v(SRA_(ADD_(ADD_(SUB_(SLL_(p3, 1),
        ADD_(SLL_(p2, 2), p2)), ADD_(p1, ADD_(p0, q0))), v4), 3), c);
    const __m128i d2q = clip1_v(SRA_(ADD_(ADD_(SUB_(SLL_(q3, 1),
        ADD_(SLL_(q2, 2), q2)), ADD_(q1, ADD_(q0, p0))), v4), 3), c);
    _mm_storeu_si128((__m128i *)p[0], clip2_v(ADD_(p0, d0p)));
    _mm_storeu_si128((__m128i *)p[1], clip2_v(ADD_(p1, d1p)));
    _mm_storeu_si128((__m128i *)p[2], clip2_v(ADD_(p2, d2p)));
    _mm_storeu_si128((__m128i *)q[0], clip2_v(ADD_(q0, d0q)));
    _mm_storeu_si128((__m128i *)q[1], clip2_v(ADD_(q1, d1q)));
    _mm_storeu_si128((__m128i *)q[2], clip2_v(ADD_(q2, d2q)));
    touched = 3;
    return;
  }

  // normal filter: per-row lane mask instead of a branch
  const bool cond5 = (dp0 + dp3) < 3 * beta / 16;
  const bool cond6 = (dq0 + dq3) < 3 * beta / 16;
  // delta0 = (9*(q0-p0) - 3*(q1-p1) + 8) >> 4
  const __m128i a = SUB_(q0, p0);
  const __m128i b = SUB_(q1, p1);
  const __m128i delta0 = SRA_(ADD_(SUB_(ADD_(SLL_(a, 3), a),
      ADD_(SLL_(b, 1), b)), _mm_set1_epi32(8)), 4);
  const __m128i rowmask =
      _mm_cmplt_epi32(_mm_abs_epi32(delta0), _mm_set1_epi32(10 * tc));
  const __m128i one = _mm_set1_epi32(1);
  const __m128i D = clip1_v(delta0, _mm_set1_epi32(2 * tc));
  const __m128i c2 = _mm_set1_epi32(tc / 2);
  const __m128i dp1 = clip1_v(SRA_(ADD_(SUB_(SRA_(ADD_(ADD_(p2, p0), one), 1), p1), D), 1), c2);
  const __m128i dq1 = clip1_v(SRA_(SUB_(SUB_(SRA_(ADD_(ADD_(q2, q0), one), 1), q1), D), 1), c2);
  _mm_storeu_si128((__m128i *)p[0],
                   _mm_blendv_epi8(p0, clip2_v(ADD_(p0, D)), rowmask));
  _mm_storeu_si128((__m128i *)q[0],
                   _mm_blendv_epi8(q0, clip2_v(SUB_(q0, D)), rowmask));
  if (cond5)
    _mm_storeu_si128((__m128i *)p[1],
                     _mm_blendv_epi8(p1, clip2_v(ADD_(p1, dp1)), rowmask));
  if (cond6)
    _mm_storeu_si128((__m128i *)q[1],
                     _mm_blendv_epi8(q1, clip2_v(ADD_(q1, dq1)), rowmask));
  touched = 2;
#undef ADD_
#undef SUB_
#undef SLL_
#undef SRA_
#else
  if (cond2 && cond3 && cond4) {
    // strong filter: 3 pixels each side, all rows
    const int c = 2 * tc;
    for (int r = 0; r < 4; ++r) {
      const int d0p = clip1((p[2][r] + 2 * p[1][r] - 6 * p[0][r] + 2 * q[0][r] + q[1][r] + 4) >> 3, c);
      const int d1p = clip1((p[2][r] - 3 * p[1][r] + p[0][r] + q[0][r] + 2) >> 2, c);
      const int d2p = clip1((2 * p[3][r] - 5 * p[2][r] + p[1][r] + p[0][r] + q[0][r] + 4) >> 3, c);
      const int d0q = clip1((q[2][r] + 2 * q[1][r] - 6 * q[0][r] + 2 * p[0][r] + p[1][r] + 4) >> 3, c);
      const int d1q = clip1((q[2][r] - 3 * q[1][r] + q[0][r] + p[0][r] + 2) >> 2, c);
      const int d2q = clip1((2 * q[3][r] - 5 * q[2][r] + q[1][r] + q[0][r] + p[0][r] + 4) >> 3, c);
      // all six deltas above read only originals; writes are safe now
      p[0][r] = clip2(p[0][r] + d0p);
      p[1][r] = clip2(p[1][r] + d1p);
      p[2][r] = clip2(p[2][r] + d2p);
      q[0][r] = clip2(q[0][r] + d0q);
      q[1][r] = clip2(q[1][r] + d1q);
      q[2][r] = clip2(q[2][r] + d2q);
    }
    touched = 3;
    return;
  }

  // normal filter: per-row gate, up to 2 pixels each side
  const int c = 2 * tc, c2 = tc / 2, b316 = 3 * beta / 16;
  const bool cond5 = (dp0 + dp3) < b316;
  const bool cond6 = (dq0 + dq3) < b316;
  for (int r = 0; r < 4; ++r) {
    const int delta0 = (9 * (q[0][r] - p[0][r]) - 3 * (q[1][r] - p[1][r]) + 8) >> 4;
    if (std::abs(delta0) >= 10 * tc) continue;
    const int D = clip1(delta0, c);
    const int dp1 = clip1((((p[2][r] + p[0][r] + 1) >> 1) - p[1][r] + D) >> 1, c2);
    const int dq1 = clip1((((q[2][r] + q[0][r] + 1) >> 1) - q[1][r] - D) >> 1, c2);
    p[0][r] = clip2(p[0][r] + D);
    q[0][r] = clip2(q[0][r] - D);
    if (cond5) p[1][r] = clip2(p[1][r] + dp1);
    if (cond6) q[1][r] = clip2(q[1][r] + dq1);
  }
  touched = 2;
#endif
}

// Only distance-0 pixels change (reference modifies only p0/q0,
// cpu.h:1475-1485).  Column-major like luma: p[j][r].
inline void chroma_segment(int p[2][4], int q[2][4], int tc) {
#ifdef __SSE4_1__
  const __m128i p0 = _mm_loadu_si128((const __m128i *)p[0]);
  const __m128i p1 = _mm_loadu_si128((const __m128i *)p[1]);
  const __m128i q0 = _mm_loadu_si128((const __m128i *)q[0]);
  const __m128i q1 = _mm_loadu_si128((const __m128i *)q[1]);
  const __m128i v4 = _mm_set1_epi32(4);
  const __m128i c = _mm_set1_epi32(tc);
  // dp = (((p0-q0)<<2) + p1 - q1 + 4) >> 3; dq with operands swapped (the
  // reference's P/Q delta asymmetry, cpu.h:1453-1461)
  const __m128i dp = clip1_v(_mm_srai_epi32(_mm_add_epi32(_mm_add_epi32(
      _mm_slli_epi32(_mm_sub_epi32(p0, q0), 2), _mm_sub_epi32(p1, q1)), v4), 3), c);
  const __m128i dq = clip1_v(_mm_srai_epi32(_mm_add_epi32(_mm_add_epi32(
      _mm_slli_epi32(_mm_sub_epi32(q0, p0), 2), _mm_sub_epi32(q1, p1)), v4), 3), c);
  _mm_storeu_si128((__m128i *)p[0], clip2_v(_mm_add_epi32(p0, dp)));
  _mm_storeu_si128((__m128i *)q[0], clip2_v(_mm_sub_epi32(q0, dq)));
#else
  for (int r = 0; r < 4; ++r) {
    const int dp = clip1((((p[0][r] - q[0][r]) * 4) + p[1][r] - q[1][r] + 4) >> 3, tc);
    const int dq = clip1((((q[0][r] - p[0][r]) * 4) + q[1][r] - p[1][r] + 4) >> 3, tc);
    p[0][r] = clip2(p[0][r] + dp);
    q[0][r] = clip2(q[0][r] - dq);
  }
#endif
}

// Flat BS read with the OOB -> 0 rule (quirk Q2).
inline int bs_flat(const uint8_t *bs, long long n, long long idx) {
  return (idx >= 0 && idx < n) ? bs[idx] : 0;
}

#ifdef __SSE4_1__
// Vectorized tile-segment gather/scatter.  HORIZONTAL phases (2, 3) are the
// easy case: grid column j over the 4 filter rows is 4 CONTIGUOUS bytes of
// one plane row.  VERTICAL phases (0, 1) load 4 plane rows of 8 bytes and
// 4x4-transpose them into column vectors.  Values are in [0, 255] so the
// packus saturating narrows are exact.
inline __m128i load4u8(const uint8_t *src) {
  int tmp;
  std::memcpy(&tmp, src, 4);  // strict-aliasing-safe; compiles to one mov
  return _mm_cvtepu8_epi32(_mm_cvtsi32_si128(tmp));
}
inline void store4u8(uint8_t *dst, __m128i v) {
  const int tmp = _mm_cvtsi128_si32(_mm_packus_epi16(_mm_packus_epi32(v, v), v));
  std::memcpy(dst, &tmp, 4);
}
inline void store8u8(uint8_t *dst, __m128i lo, __m128i hi) {
  _mm_storel_epi64((__m128i *)dst,
                   _mm_packus_epi16(_mm_packus_epi32(lo, hi), lo));
}
#define GVCT_TRANSPOSE4_EPI32(r0, r1, r2, r3)       \
  do {                                              \
    __m128i t0 = _mm_unpacklo_epi32(r0, r1);        \
    __m128i t1 = _mm_unpacklo_epi32(r2, r3);        \
    __m128i t2 = _mm_unpackhi_epi32(r0, r1);        \
    __m128i t3 = _mm_unpackhi_epi32(r2, r3);        \
    r0 = _mm_unpacklo_epi64(t0, t1);                \
    r1 = _mm_unpackhi_epi64(t0, t1);                \
    r2 = _mm_unpacklo_epi64(t2, t3);                \
    r3 = _mm_unpackhi_epi64(t2, t3);                \
  } while (0)
#endif

template <int PHASE, bool CHROMA>
inline void filter_tile_segment(const PlaneView &pl, int by, int bx,
                                int beta, int tc) {
  const int r0 = by * kBlock, c0 = bx * kBlock;
#ifdef __SSE4_1__
  if (!CHROMA) {
    alignas(16) int p[4][4], q[4][4];  // column-major: p[j][r]
    int touched;
    if (PHASE >= 2) {
      // horizontal: p[j] = row (3-j or depending) cols 0..3 / 4..7, contiguous
      const int cbase = c0 + (PHASE == 3 ? 4 : 0);  // Q3: right-hor P cols 4..7
      for (int j = 0; j < 4; ++j) {
        _mm_store_si128((__m128i *)p[j], load4u8(&pl.at(r0 + 3 - j, cbase)));
        _mm_store_si128((__m128i *)q[j], load4u8(&pl.at(r0 + 4 + j, c0)));
      }
      luma_segment(p, q, beta, tc, touched);
      if (touched) {
        for (int j = 0; j < 4; ++j) {
          store4u8(&pl.at(r0 + 3 - j, cbase), _mm_load_si128((const __m128i *)p[j]));
          store4u8(&pl.at(r0 + 4 + j, c0), _mm_load_si128((const __m128i *)q[j]));
        }
      }
    } else {
      // vertical: 4 row loads of 8 bytes, transpose halves to column vectors
      const int rbase = r0 + (PHASE == 1 ? 4 : 0);
      __m128i rows_lo[4], rows_hi[4];
      for (int r = 0; r < 4; ++r) {
        const uint8_t *src = &pl.at(rbase + r, c0);
        const __m128i bytes = _mm_loadl_epi64((const __m128i *)src);
        rows_lo[r] = _mm_cvtepu8_epi32(bytes);                       // cols 0..3
        rows_hi[r] = _mm_cvtepu8_epi32(_mm_srli_si128(bytes, 4));    // cols 4..7
      }
      GVCT_TRANSPOSE4_EPI32(rows_lo[0], rows_lo[1], rows_lo[2], rows_lo[3]);
      GVCT_TRANSPOSE4_EPI32(rows_hi[0], rows_hi[1], rows_hi[2], rows_hi[3]);
      // cols 0..3 = p[3..0] (p col is 3-j); cols 4..7 = q[0..3]
      for (int j = 0; j < 4; ++j) {
        _mm_store_si128((__m128i *)p[j], rows_lo[3 - j]);
        _mm_store_si128((__m128i *)q[j], rows_hi[j]);
      }
      luma_segment(p, q, beta, tc, touched);
      if (touched) {
        for (int j = 0; j < 4; ++j) {
          rows_lo[3 - j] = _mm_load_si128((const __m128i *)p[j]);
          rows_hi[j] = _mm_load_si128((const __m128i *)q[j]);
        }
        GVCT_TRANSPOSE4_EPI32(rows_lo[0], rows_lo[1], rows_lo[2], rows_lo[3]);
        GVCT_TRANSPOSE4_EPI32(rows_hi[0], rows_hi[1], rows_hi[2], rows_hi[3]);
        for (int r = 0; r < 4; ++r)
          store8u8(&pl.at(rbase + r, c0), rows_lo[r], rows_hi[r]);
      }
    }
  } else {
    alignas(16) int p[2][4], q[2][4];
    if (PHASE >= 2) {
      const int cbase = c0 + (PHASE == 3 ? 4 : 0);
      for (int j = 0; j < 2; ++j) {
        _mm_store_si128((__m128i *)p[j], load4u8(&pl.at(r0 + 3 - j, cbase)));
        _mm_store_si128((__m128i *)q[j], load4u8(&pl.at(r0 + 4 + j, c0)));
      }
      chroma_segment(p, q, tc);
      store4u8(&pl.at(r0 + 3, cbase), _mm_load_si128((const __m128i *)p[0]));
      store4u8(&pl.at(r0 + 4, c0), _mm_load_si128((const __m128i *)q[0]));
    } else {
      // vertical chroma touches cols 2..5 (p1 p0 q0 q1): 4-byte row loads
      const int rbase = r0 + (PHASE == 1 ? 4 : 0);
      __m128i rows[4];
      for (int r = 0; r < 4; ++r) rows[r] = load4u8(&pl.at(rbase + r, c0 + 2));
      GVCT_TRANSPOSE4_EPI32(rows[0], rows[1], rows[2], rows[3]);
      // cols 2,3,4,5 = p[1], p[0], q[0], q[1]
      _mm_store_si128((__m128i *)p[1], rows[0]);
      _mm_store_si128((__m128i *)p[0], rows[1]);
      _mm_store_si128((__m128i *)q[0], rows[2]);
      _mm_store_si128((__m128i *)q[1], rows[3]);
      chroma_segment(p, q, tc);
      rows[1] = _mm_load_si128((const __m128i *)p[0]);
      rows[2] = _mm_load_si128((const __m128i *)q[0]);
      GVCT_TRANSPOSE4_EPI32(rows[0], rows[1], rows[2], rows[3]);
      for (int r = 0; r < 4; ++r) store4u8(&pl.at(rbase + r, c0 + 2), rows[r]);
    }
  }
#else
  if (!CHROMA) {
    int p[4][4], q[4][4], touched;  // column-major: p[j][r]
    for (int j = 0; j < 4; ++j)
      for (int r = 0; r < 4; ++r) {
        int rr, cc;
        p_coord<PHASE>(r, j, rr, cc);
        p[j][r] = pl.at(r0 + rr, c0 + cc);
        q_coord<PHASE>(r, j, rr, cc);
        q[j][r] = pl.at(r0 + rr, c0 + cc);
      }
    luma_segment(p, q, beta, tc, touched);
    for (int j = 0; j < touched; ++j)
      for (int r = 0; r < 4; ++r) {
        int rr, cc;
        p_coord<PHASE>(r, j, rr, cc);
        pl.at(r0 + rr, c0 + cc) = static_cast<uint8_t>(p[j][r]);
        q_coord<PHASE>(r, j, rr, cc);
        pl.at(r0 + rr, c0 + cc) = static_cast<uint8_t>(q[j][r]);
      }
  } else {
    int p[2][4], q[2][4];  // column-major: p[j][r]
    for (int j = 0; j < 2; ++j)
      for (int r = 0; r < 4; ++r) {
        int rr, cc;
        p_coord<PHASE>(r, j, rr, cc);
        p[j][r] = pl.at(r0 + rr, c0 + cc);
        q_coord<PHASE>(r, j, rr, cc);
        q[j][r] = pl.at(r0 + rr, c0 + cc);
      }
    chroma_segment(p, q, tc);
    for (int r = 0; r < 4; ++r) {
      int rr, cc;
      p_coord<PHASE>(r, 0, rr, cc);
      pl.at(r0 + rr, c0 + cc) = static_cast<uint8_t>(p[0][r]);
      q_coord<PHASE>(r, 0, rr, cc);
      pl.at(r0 + rr, c0 + cc) = static_cast<uint8_t>(q[0][r]);
    }
  }
#endif
}

// Per-tile (Q7 phase order) filter step shared by the baseline sweep and the
// AVX-512 row sweep's tail: the four edge gates are already resolved to BS
// values (Q2 OOB->0 and the boundary gates applied by the caller).
template <bool CHROMA>
inline void filter_tile(const PlaneView &pl, int by, int bx,
                        int bs_v1, int bs_v2, int bs_h1, int bs_h2,
                        int beta, int tc) {
  if (CHROMA) {
    if (bs_v1 == 2) filter_tile_segment<0, true>(pl, by, bx, beta, tc);
    if (bs_v2 == 2) filter_tile_segment<1, true>(pl, by, bx, beta, tc);
    if (bs_h1 == 2) filter_tile_segment<2, true>(pl, by, bx, beta, tc);
    if (bs_h2 == 2) filter_tile_segment<3, true>(pl, by, bx, beta, tc);
  } else {
    if (bs_v1 > 0) filter_tile_segment<0, false>(pl, by, bx, beta, tc);
    if (bs_v2 > 0) filter_tile_segment<1, false>(pl, by, bx, beta, tc);
    if (bs_h1 > 0) filter_tile_segment<2, false>(pl, by, bx, beta, tc);
    if (bs_h2 > 0) filter_tile_segment<3, false>(pl, by, bx, beta, tc);
  }
}

}  // namespace gvct

#endif  // GVCT_DEBLOCK_CORE_H_
