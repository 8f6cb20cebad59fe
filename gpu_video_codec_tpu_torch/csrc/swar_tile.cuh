// SWAR form of the deblock (T1), shared by the CUDA kernel (swar_kernel.cu,
// built by nvcc) and the host build that the CPU tests load (host_shim.cpp,
// built by g++).
//
// A tile pair, A and B, shares 32-bit words: pixel (r, c) of both lives in
// one word, A's in the low halfword, B's in the high one, each a signed
// 16-bit lane.  The per-row math below is deblock_tile.cuh's (same
// formulas), written branchless over both lanes: every condition is a
// per-lane mask (0xFFFF where true) and every gated write a select.  Every
// intermediate fits a signed 16-bit lane (|.| < 2^12, ops/filters.py), so
// a lane holds a value as it is, with no bias.  The kernel is a quad of
// four lanes per tile pair (deblock_quad.cuh's geometry with
// QuadLane<hw2>); the pair functions at the end are its lanes' work
// between exchange points.
//
// Per-lane arithmetic uses the card's halfword instructions: CUDA's SIMD
// intrinsics (__vadd2, __vsub2, __vneg2, __vabs2, __vmaxs2, __vmins2,
// __vcmplts2) and the sm_90 DPX function __viaddmin_s16x2_relu, which
// gives clip2(x + d) = max(min(x + d, 255), 0) per lane in one call.
// Halfword shifts have no intrinsic: asr splits the lanes and shifts each
// as a sign-extended int; shl masks the bits the low lane would carry into
// the high one.  Each intrinsic has a portable host fallback (#ifndef
// __CUDA_ARCH__) so that g++ builds this header: the CPU tests hold those
// fallbacks against numpy int16 arithmetic (gvct_host_swar_op), not
// against the card's instructions; chip_smoke.py holds the kernel built
// on them against its plain version on the card.
#pragma once

#include <cstring>

#include "deblock_quad.cuh"

namespace gvct {
namespace swar {

GVCT_HD int lane_lo(uint32_t x) { return static_cast<int16_t>(x & 0xFFFFu); }
GVCT_HD int lane_hi(uint32_t x) { return static_cast<int16_t>(x >> 16); }
GVCT_HD uint32_t pack(int lo, int hi) {
  return (static_cast<uint32_t>(static_cast<uint16_t>(hi)) << 16) |
         static_cast<uint16_t>(lo);
}
GVCT_HD uint32_t splat(int c) { return pack(c, c); }

// -- the halfword primitives ---------------------------------------------------

GVCT_HD uint32_t vadd(uint32_t a, uint32_t b) {
#ifdef __CUDA_ARCH__
  return __vadd2(a, b);
#else
  return pack(lane_lo(a) + lane_lo(b), lane_hi(a) + lane_hi(b));
#endif
}
GVCT_HD uint32_t vsub(uint32_t a, uint32_t b) {
#ifdef __CUDA_ARCH__
  return __vsub2(a, b);
#else
  return pack(lane_lo(a) - lane_lo(b), lane_hi(a) - lane_hi(b));
#endif
}
GVCT_HD uint32_t vneg(uint32_t a) {
#ifdef __CUDA_ARCH__
  return __vneg2(a);
#else
  return pack(-lane_lo(a), -lane_hi(a));
#endif
}
GVCT_HD uint32_t vabs(uint32_t a) {
#ifdef __CUDA_ARCH__
  return __vabs2(a);
#else
  return pack(iabs(lane_lo(a)), iabs(lane_hi(a)));
#endif
}
GVCT_HD uint32_t vmax(uint32_t a, uint32_t b) {
#ifdef __CUDA_ARCH__
  return __vmaxs2(a, b);
#else
  const int l = lane_lo(a) > lane_lo(b) ? lane_lo(a) : lane_lo(b);
  const int h = lane_hi(a) > lane_hi(b) ? lane_hi(a) : lane_hi(b);
  return pack(l, h);
#endif
}
GVCT_HD uint32_t vmin(uint32_t a, uint32_t b) {
#ifdef __CUDA_ARCH__
  return __vmins2(a, b);
#else
  const int l = lane_lo(a) < lane_lo(b) ? lane_lo(a) : lane_lo(b);
  const int h = lane_hi(a) < lane_hi(b) ? lane_hi(a) : lane_hi(b);
  return pack(l, h);
#endif
}
// 0xFFFF in each lane where a < b (signed)
GVCT_HD uint32_t vlt(uint32_t a, uint32_t b) {
#ifdef __CUDA_ARCH__
  return __vcmplts2(a, b);
#else
  return pack(lane_lo(a) < lane_lo(b) ? -1 : 0, lane_hi(a) < lane_hi(b) ? -1 : 0);
#endif
}
// max(min(a + b, c), 0) per lane, the sum wrapping to 16 bits
GVCT_HD uint32_t vaddmin_relu(uint32_t a, uint32_t b, uint32_t c) {
#ifdef __CUDA_ARCH__
  return __viaddmin_s16x2_relu(a, b, c);
#else
  const uint32_t s = pack(lane_lo(a) + lane_lo(b), lane_hi(a) + lane_hi(b));
  const int l = lane_lo(s) < lane_lo(c) ? lane_lo(s) : lane_lo(c);
  const int h = lane_hi(s) < lane_hi(c) ? lane_hi(s) : lane_hi(c);
  return pack(l < 0 ? 0 : l, h < 0 ? 0 : h);
#endif
}
// Arithmetic >> k per lane, 0 <= k < 16: the high lane shifts as the
// word's top half (sign from bit 31), the low lane as its own sign-extended
// int; both halves then recombine.
GVCT_HD uint32_t vasr(uint32_t a, int k) {
  const uint32_t h = static_cast<uint32_t>(static_cast<int32_t>(a) >> k) & 0xFFFF0000u;
  const uint32_t l = static_cast<uint32_t>(static_cast<int32_t>(a << 16) >> (16 + k)) & 0xFFFFu;
  return h | l;
}
// << k per lane, 0 <= k < 16: the word's shift, less the low lane's top k
// bits that it moves into the high lane.
GVCT_HD uint32_t vshl(uint32_t a, int k) {
  return (a << k) & ~(((1u << k) - 1u) << 16);
}
// a where mask, else b (mask 0xFFFF per true lane)
GVCT_HD uint32_t vsel(uint32_t mask, uint32_t a, uint32_t b) { return (a & mask) | (b & ~mask); }

// A word of two lanes with the operators the filter formulas use.
struct hw2 {
  uint32_t w;
};
GVCT_HD hw2 operator+(hw2 a, hw2 b) { return {vadd(a.w, b.w)}; }
GVCT_HD hw2 operator-(hw2 a, hw2 b) { return {vsub(a.w, b.w)}; }
GVCT_HD hw2 operator-(hw2 a) { return {vneg(a.w)}; }
GVCT_HD hw2 operator&(hw2 a, hw2 m) { return {a.w & m.w}; }
GVCT_HD hw2 operator|(hw2 a, hw2 b) { return {a.w | b.w}; }
GVCT_HD hw2 operator~(hw2 a) { return {~a.w}; }
GVCT_HD hw2 operator<(hw2 a, hw2 b) { return {vlt(a.w, b.w)}; }
GVCT_HD hw2 abs2(hw2 a) { return {vabs(a.w)}; }
GVCT_HD hw2 asr(hw2 a, int k) { return {vasr(a.w, k)}; }
GVCT_HD hw2 shl(hw2 a, int k) { return {vshl(a.w, k)}; }
GVCT_HD hw2 sel(hw2 m, hw2 a, hw2 b) { return {vsel(m.w, a.w, b.w)}; }

// Thresholds as packed constants (both lanes), from make_thresholds.
struct Consts {
  hw2 beta, beta8, beta316, tc52, tc10, c, nc, c2, nc2, tc, ntc, one, two, four, eight, max_pixel;
};

GVCT_HD Consts make_consts(const Thresholds& th) {
  Consts k;
  k.beta = {splat(th.beta)};
  k.beta8 = {splat(th.beta8)};
  k.beta316 = {splat(th.beta316)};
  k.tc52 = {splat(th.tc52)};
  k.tc10 = {splat(th.tc10)};
  k.c = {splat(th.tc2)};
  k.nc = {splat(-th.tc2)};
  k.c2 = {splat(th.tc_half)};
  k.nc2 = {splat(-th.tc_half)};
  k.tc = {splat(th.tc)};
  k.ntc = {splat(-th.tc)};
  k.one = {splat(1)};
  k.two = {splat(2)};
  k.four = {splat(4)};
  k.eight = {splat(8)};
  k.max_pixel = {splat(255)};
  return k;
}

// [-c, c] clamp per lane (nc = -c)
GVCT_HD hw2 clip1(hw2 d, hw2 c, hw2 nc) { return {vmin(vmax(d.w, nc.w), c.w)}; }
// clip2(x + d) per lane, [0, 255]
GVCT_HD hw2 add_clip2(hw2 x, hw2 d, const Consts& k) {
  return {vaddmin_relu(x.w, d.w, k.max_pixel.w)};
}

// |x2 - 2 x1 + x0| (cpu.h:1086)
GVCT_HD hw2 second_deriv(const hw2 (&a)[4]) { return abs2(a[2] - (a[1] + a[1]) + a[0]); }

// Per-lane gate of one BS byte pair (luma: BS > 0, chroma: BS == 2).
template <bool CHROMA>
GVCT_HD hw2 gate_of(int bs_lo, int bs_hi) {
  const bool lo = CHROMA ? bs_lo == 2 : bs_lo > 0;
  const bool hi = CHROMA ? bs_hi == 2 : bs_hi > 0;
  return {(lo ? 0x0000FFFFu : 0u) | (hi ? 0xFFFF0000u : 0u)};
}

// __byte_perm(x, y, s): byte i of the result is byte (s >> 4i) & 7 of the
// eight bytes y:x (x is bytes 0-3).
GVCT_HD uint32_t byte_perm(uint32_t x, uint32_t y, uint32_t s) {
#ifdef __CUDA_ARCH__
  return __byte_perm(x, y, s);
#else
  const uint64_t b = static_cast<uint64_t>(y) << 32 | x;
  uint32_t r = 0;
  for (int i = 0; i < 4; ++i) {
    r |= static_cast<uint32_t>(b >> (8 * (s >> (4 * i) & 7)) & 0xFF) << (8 * i);
  }
  return r;
#endif
}

// -- the filter math of one segment row, both lanes ----------------------------------
//
// swar_exp.py::swar_luma_filter_planes / swar_chroma_filter_planes per
// row; the formulas of deblock_tile.cuh's row_terms, luma_decision,
// strong_row, normal_row and chroma_row.

// A luma row's second derivatives dp and dq and the mask of its strong
// conditions cond2-cond4, per lane.
struct RowTerms2 {
  hw2 dp, dq, strong;
};

GVCT_HD RowTerms2 row_terms(const hw2 (&p)[4], const hw2 (&q)[4], const Consts& k) {
  const hw2 dp = second_deriv(p), dq = second_deriv(q);
  return {dp, dq,
          (dp + dq < k.beta8) &                                          // cond2
              (abs2(p[3] - p[0]) + abs2(q[0] - q[3]) < k.beta8) &        // cond3
              (abs2(p[0] - q[0]) < k.tc52)};                             // cond4
}

// A lane's two words for the quad sums of a segment, from rows 0 and 3
// only (the other rows give 0): dp per lane with 1 at bit 10 where the row
// fails cond2-cond4, and dq.  Two rows sum to at most 2 * 510 + 2^11
// per lane, below 2^15, so the quad's 32-bit adds never carry from the low
// lane into the high one: they are __vadd2's sums.
constexpr uint32_t kFailBit = 0x04000400u;

GVCT_HD void pair_words(const RowTerms2& rt, int r, uint32_t& wp, uint32_t& wq) {
  const bool mine = r == 0 || r == 3;
  wp = mine ? rt.dp.w | (~rt.strong.w & kFailBit) : 0u;
  wq = mine ? rt.dq.w : 0u;
}

// A segment's per-lane masks: strong and normal filter (each under the BS
// gate and cond1), cond5 and cond6.
struct Decision {
  hw2 strong, normal, cond5, cond6;
};

// The decision from the quad sums sp and sq of pair_words' wp and wq.
GVCT_HD Decision luma_decision(hw2 gate, uint32_t sp, uint32_t sq, const Consts& k) {
  const hw2 dp = {sp & 0x03FF03FFu}, dq = {sq};
  const hw2 strong = hw2{sp & 0x0C000C00u} < k.one;  // no row failed cond2-cond4
  const hw2 on = gate & (dp + dq < k.beta);           // cond1
  return {on & strong, on & ~strong, dp < k.beta316, dq < k.beta316};
}

// One luma row under its segment's decision: the strong filter's and the
// normal filter's deltas both, selected per lane (distances 0-2).
GVCT_HD void luma_row(hw2 (&p)[4], hw2 (&q)[4], const Decision& d, const Consts& k) {
  const hw2 p0 = p[0], p1 = p[1], p2 = p[2], p3 = p[3];
  const hw2 q0 = q[0], q1 = q[1], q2 = q[2], q3 = q[3];
  // strong filter deltas, value form (cpu.h:1152-1199)
  const hw2 tpq = p0 + q0;
  const hw2 s = p1 + tpq, u = q1 + tpq;
  const hw2 s0p = clip1(asr(shl(s, 1) + p2 + q1 + k.four, 3) - p0, k.c, k.nc);
  const hw2 s1p = clip1(asr(s + p2 + k.two, 2) - p1, k.c, k.nc);
  const hw2 s2p = clip1(asr(shl(p3 + p2, 1) + p2 + s + k.four, 3) - p2, k.c, k.nc);
  const hw2 s0q = clip1(asr(shl(u, 1) + q2 + p1 + k.four, 3) - q0, k.c, k.nc);
  const hw2 s1q = clip1(asr(u + q2 + k.two, 2) - q1, k.c, k.nc);
  const hw2 s2q = clip1(asr(shl(q3 + q2, 1) + q2 + u + k.four, 3) - q2, k.c, k.nc);
  // normal filter (cpu.h:1252-1275): 9x = 8x + x, 3x = 2x + x per lane
  const hw2 d0 = q0 - p0, d1 = q1 - p1;
  const hw2 delta0 = asr(shl(d0, 3) + d0 - (shl(d1, 1) + d1) + k.eight, 4);
  const hw2 nrow = d.normal & (abs2(delta0) < k.tc10);
  const hw2 big_d = clip1(delta0, k.c, k.nc);
  const hw2 dp1 = clip1(asr(asr(p2 + p0 + k.one, 1) - p1 + big_d, 1), k.c2, k.nc2);
  const hw2 dq1 = clip1(asr(asr(q2 + q0 + k.one, 1) - q1 - big_d, 1), k.c2, k.nc2);
  p[0] = add_clip2(p0, sel(d.strong, s0p, big_d & nrow), k);
  p[1] = add_clip2(p1, sel(d.strong, s1p, dp1 & nrow & d.cond5), k);
  p[2] = add_clip2(p2, s2p & d.strong, k);
  q[0] = add_clip2(q0, sel(d.strong, s0q, -big_d & nrow), k);
  q[1] = add_clip2(q1, sel(d.strong, s1q, dq1 & nrow & d.cond6), k);
  q[2] = add_clip2(q2, s2q & d.strong, k);
}

// One chroma row (cpu.h:1431-1488, dq with swapped operands); gate: BS == 2
// per lane.
GVCT_HD void chroma_row(hw2& p0, hw2 p1, hw2& q0, hw2 q1, hw2 gate, const Consts& k) {
  const hw2 dp = clip1(asr(shl(p0 - q0, 2) + p1 - q1 + k.four, 3), k.tc, k.ntc);
  const hw2 dq = clip1(asr(shl(q0 - p0, 2) + q1 - p1 + k.four, 3), k.tc, k.ntc);
  const hw2 np = add_clip2(p0, dp & gate, k);
  q0 = add_clip2(q0, -(dq & gate), k);
  p0 = np;
}

// -- the quad of four lanes per tile pair (swar_kernel.cu) ---------------------------
//
// A block owns TB pairs of one tile row: tiles [c0, c0 + TB) (low lanes)
// and [c0 + Bx/2, c0 + Bx/2 + TB) (high lanes), 4 * TB threads; thread tid
// is lane r = tid & 3 of pair t = tid >> 2, in deblock_quad.cuh's geometry
// (tile rows r and 4 + r, then column r and column 4 + r rows 0-3, Q3
// included).  The stage holds the two runs interleaved: plane k at stage
// row k, byte 2t the low tile of pair t, byte 2t + 1 its high tile, so a
// lane's pixel pair is one 16-bit stage access, widened to a two-lane word
// by one byte permute.  The stride is 37 words: a warp's 8 pairs are 4
// words of a row, and the quad's four rows (k + 8i: 8 words apart mod 32;
// k + i: 5 apart) hit different banks.

constexpr int kPairStride = 4 * (2 * kQuadMaxTiles / 4 + 5);  // 148 bytes

using PairLane = QuadLane<hw2>;

}  // namespace swar

template <>
struct StageCell<swar::hw2> {
  static constexpr int kStride = swar::kPairStride;
  static constexpr int kRow = 8 * kStride;
  static constexpr int kBytes = 2;
  GVCT_HD static int offset(int t) { return t * kBytes; }
  // the pair's two bytes (low tile, high tile) widened to the two lanes
  GVCT_HD static swar::hw2 get(const uint8_t* s) {
#ifdef __CUDA_ARCH__
    const uint32_t x = *reinterpret_cast<const uint16_t*>(s);
#else
    uint16_t x;
    std::memcpy(&x, s, 2);
#endif
    return {swar::byte_perm(x, 0, 0x4140)};
  }
  // the two lanes (each 0-255) narrowed back to the pair's two bytes
  GVCT_HD static void put(uint8_t* s, swar::hw2 v) {
    const uint16_t x = static_cast<uint16_t>(swar::byte_perm(v.w, 0, 0x0020));
#ifdef __CUDA_ARCH__
    *reinterpret_cast<uint16_t*>(s) = x;
#else
    std::memcpy(s, &x, 2);
#endif
  }
};

namespace swar {

// The staging word of a launch: the widest, 8, 4 or 1 bytes, in which both
// runs of every block are aligned (a run starts at by * Bx + c0 or half
// further, with c0 a multiple of TB, so half, TB and the addresses decide).
GVCT_HD int pair_word_bytes(int half, int tb, const void* in, const void* out) {
  return quad_word_bytes(half, tb, in, out);
}

// The pair's per-lane gates in lane.bs: `lo` is the block's first low tile
// in each map, its high tile `half` further; n the block's pairs inside the
// grid.  The four lanes of a quad read the same two bytes of each map.
template <bool CHROMA>
GVCT_HD void pair_load_gates(PairLane& lane, const uint8_t* v1, const uint8_t* v2,
                             const uint8_t* h1, const uint8_t* h2, size_t lo, int half, int n) {
  const bool inside = lane.t < n;
  const size_t at = lo + lane.t;
  const uint8_t* maps[4] = {v1, v2, h1, h2};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    lane.bs[i] = inside ? gate_of<CHROMA>(maps[i][at], maps[i][at + half]) : hw2{0u};
  }
}

// 2W stage bytes: W bytes of the low run and W of the high run interleaved
// (lo0 hi0 lo1 hi1 ...), in 32-bit words (one word for W = 1).
template <int W>
struct Pair {
  uint32_t w[W < 2 ? 1 : W / 2];
};

template <int W>
GVCT_HD Pair<W> interleave(const Word<W>& lo, const Word<W>& hi) {
  Pair<W> x{};
  if constexpr (W == 1) {
    x.w[0] = lo.w[0] | hi.w[0] << 8;
  } else {
#pragma unroll
    for (int i = 0; i < W / 4; ++i) {
      x.w[2 * i] = byte_perm(lo.w[i], hi.w[i], 0x5140);
      x.w[2 * i + 1] = byte_perm(lo.w[i], hi.w[i], 0x7362);
    }
  }
  return x;
}

template <int W>
GVCT_HD void deinterleave(const Pair<W>& x, Word<W>& lo, Word<W>& hi) {
  if constexpr (W == 1) {
    lo.w[0] = x.w[0] & 0xFF;
    hi.w[0] = x.w[0] >> 8 & 0xFF;
  } else {
#pragma unroll
    for (int i = 0; i < W / 4; ++i) {
      lo.w[i] = byte_perm(x.w[2 * i], x.w[2 * i + 1], 0x6420);
      hi.w[i] = byte_perm(x.w[2 * i], x.w[2 * i + 1], 0x7531);
    }
  }
}

// A Pair at a stage position aligned to 2 (W = 1) or 4 bytes (W = 4, 8).
template <int W>
GVCT_HD void pair_put(uint8_t* s, const Pair<W>& x) {
#ifdef __CUDA_ARCH__
  if constexpr (W == 1) {
    *reinterpret_cast<uint16_t*>(s) = static_cast<uint16_t>(x.w[0]);
  } else {
#pragma unroll
    for (int i = 0; i < W / 2; ++i) reinterpret_cast<uint32_t*>(s)[i] = x.w[i];
  }
#else
  std::memcpy(s, x.w, 2 * W);
#endif
}

template <int W>
GVCT_HD Pair<W> pair_get(const uint8_t* s) {
  Pair<W> x{};
#ifdef __CUDA_ARCH__
  if constexpr (W == 1) {
    x.w[0] = *reinterpret_cast<const uint16_t*>(s);
  } else {
#pragma unroll
    for (int i = 0; i < W / 2; ++i) x.w[i] = reinterpret_cast<const uint32_t*>(s)[i];
  }
#else
  std::memcpy(x.w, s, 2 * W);
#endif
  return x;
}

// The block's cooperative load, deblock_quad.cuh's quad_stage_load over two
// runs: thread tid reads word m = tid % (TB / W) of the low and of the high
// run of the 16 / W planes k = 4W * j + tid / (TB / W), a group of loads
// before its stage stores, and stages each pair of words interleaved.  `lo`
// is the block's first low tile in plane 0, its high tile `half` further;
// bytes past the block's n pairs are staged as 0.  TB % W == 0.
template <int W>
GVCT_HD void pair_stage_load(const uint8_t* lo, size_t half, size_t plane, int n, int tb,
                             uint8_t* stage, int tid) {
  constexpr int kWords = 16 / W;
  constexpr int kGroup = kWords < kQuadInFlight / 2 ? kWords : kQuadInFlight / 2;
  const int wpp = tb / W;
  const int k0 = tid / wpp, m = tid - k0 * wpp;
#pragma unroll 1
  for (int j0 = 0; j0 < kWords; j0 += kGroup) {
    Word<W> a[kGroup], b[kGroup];
#pragma unroll
    for (int j = 0; j < kGroup; ++j) {
      const uint8_t* p = lo + static_cast<size_t>(4 * W * (j0 + j) + k0) * plane + W * m;
      a[j] = read_word<W>(p, n - W * m);
      b[j] = read_word<W>(p + half, n - W * m);
    }
#pragma unroll
    for (int j = 0; j < kGroup; ++j) {
      pair_put<W>(stage + (4 * W * (j0 + j) + k0) * kPairStride + 2 * W * m,
                  interleave<W>(a[j], b[j]));
    }
  }
}

// The block's cooperative store, the load's mapping; nothing past the grid.
template <int W>
GVCT_HD void pair_stage_store(const uint8_t* stage, uint8_t* lo, size_t half, size_t plane, int n,
                              int tb, int tid) {
  constexpr int kWords = 16 / W;
  constexpr int kGroup = kWords < kQuadInFlight / 2 ? kWords : kQuadInFlight / 2;
  const int wpp = tb / W;
  const int k0 = tid / wpp, m = tid - k0 * wpp;
#pragma unroll 1
  for (int j0 = 0; j0 < kWords; j0 += kGroup) {
    Word<W> a[kGroup], b[kGroup];
#pragma unroll
    for (int j = 0; j < kGroup; ++j) {
      deinterleave<W>(pair_get<W>(stage + (4 * W * (j0 + j) + k0) * kPairStride + 2 * W * m),
                      a[j], b[j]);
    }
#pragma unroll
    for (int j = 0; j < kGroup; ++j) {
      uint8_t* p = lo + static_cast<size_t>(4 * W * (j0 + j) + k0) * plane + W * m;
      write_word<W>(p, a[j], n - W * m);
      write_word<W>(p + half, b[j], n - W * m);
    }
  }
}

// Upper-vert and lower-vert words: w[0], w[1] of row r, w[2], w[3] of row 4 + r.
GVCT_HD void pair_vert_words(const PairLane& lane, const Consts& k, uint32_t (&w)[4]) {
  hw2 p[4], q[4];
  split_row(lane.a, p, q);
  pair_words(row_terms(p, q, k), lane.r, w[0], w[1]);
  split_row(lane.b, p, q);
  pair_words(row_terms(p, q, k), lane.r, w[2], w[3]);
}

// sum = the quad sums of pair_vert_words' w.
GVCT_HD void pair_vert_luma(PairLane& lane, const uint32_t (&sum)[4], const Consts& k) {
  hw2 p[4], q[4];
  split_row(lane.a, p, q);
  luma_row(p, q, luma_decision(lane.bs[0], sum[0], sum[1], k), k);
  join_row(lane.a, p, q);
  split_row(lane.b, p, q);
  luma_row(p, q, luma_decision(lane.bs[1], sum[2], sum[3], k), k);
  join_row(lane.b, p, q);
}

GVCT_HD void pair_left_words(const PairLane& lane, const Consts& k, uint32_t (&w)[2]) {
  hw2 p[4], q[4];
  split_row(lane.cl, p, q);
  pair_words(row_terms(p, q, k), lane.r, w[0], w[1]);
}

GVCT_HD void pair_left_luma(PairLane& lane, const uint32_t (&sum)[2], const Consts& k) {
  hw2 p[4], q[4];
  split_row(lane.cl, p, q);
  luma_row(p, q, luma_decision(lane.bs[2], sum[0], sum[1], k), k);
  join_row(lane.cl, p, q);
}

GVCT_HD void pair_right_words(const PairLane& lane, const Consts& k, uint32_t (&w)[2]) {
  hw2 p[4], q[4];
  split_right(lane, p, q);
  pair_words(row_terms(p, q, k), lane.r, w[0], w[1]);
}

GVCT_HD void pair_right_luma(PairLane& lane, const uint32_t (&sum)[2], const Consts& k) {
  hw2 p[4], q[4];
  split_right(lane, p, q);
  luma_row(p, q, luma_decision(lane.bs[3], sum[0], sum[1], k), k);
  join_right(lane, p, q);
}

GVCT_HD void pair_vert_chroma(PairLane& lane, const Consts& k) {
  chroma_row(lane.a[3], lane.a[2], lane.a[4], lane.a[5], lane.bs[0], k);
  chroma_row(lane.b[3], lane.b[2], lane.b[4], lane.b[5], lane.bs[1], k);
}

GVCT_HD void pair_hor_chroma(PairLane& lane, const Consts& k) {
  chroma_row(lane.cl[3], lane.cl[2], lane.cl[4], lane.cl[5], lane.bs[2], k);
  chroma_row(lane.cr[3], lane.cr[2], lane.cl[4], lane.cl[5], lane.bs[3], k);
}

}  // namespace swar
}  // namespace gvct
