// SWAR form of the per-tile deblock (T1), shared by the CUDA kernel
// (swar_kernel.cu, built by nvcc) and the host build that the CPU tests load
// (host_shim.cpp, built by g++).
//
// One thread owns two tiles, A and B.  Pixel (r, c) of both lives in one
// 32-bit word: A's in the low halfword, B's in the high one, each a signed
// 16-bit lane.  The sweep is deblock_tile.cuh's four phases (same geometry,
// same formulas), written branchless over both lanes: every condition is a
// per-lane mask (0xFFFF where true) and every gated write a select.  Every
// intermediate fits a signed 16-bit lane (|.| < 2^12, ops/filters.py), so a
// lane holds a value as it is, with no bias.
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

#include "deblock_tile.cuh"

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

// Luma segment on both lanes (swar_exp.py::swar_luma_filter_planes; the
// formulas of deblock_tile.cuh::luma_segment).  gate: BS > 0 per lane.
template <int PHASE>
GVCT_HD void luma_segment(hw2 (&t)[64], hw2 gate, const Consts& k) {
  hw2 p[4][4], q[4][4];
#pragma unroll
  for (int r = 0; r < 4; ++r) {
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      p[r][j] = t[p_at<PHASE>(r, j)];
      q[r][j] = t[q_at<PHASE>(r, j)];
    }
  }
  const hw2 dp0 = second_deriv(p[0]), dp3 = second_deriv(p[3]);
  const hw2 dq0 = second_deriv(q[0]), dq3 = second_deriv(q[3]);
  const hw2 pq0 = dp0 + dq0, pq3 = dp3 + dq3;
  const hw2 on = gate & (pq0 + pq3 < k.beta);                                   // cond1
  const hw2 strong = (pq0 < k.beta8) & (pq3 < k.beta8) &                        // cond2
                    (abs2(p[0][3] - p[0][0]) + abs2(q[0][0] - q[0][3]) < k.beta8) &  // cond3
                    (abs2(p[3][3] - p[3][0]) + abs2(q[3][0] - q[3][3]) < k.beta8) &
                    (abs2(p[0][0] - q[0][0]) < k.tc52) & (abs2(p[3][0] - q[3][0]) < k.tc52);
  const hw2 use_strong = on & strong;
  const hw2 use_normal = on & ~strong;
  const hw2 cond5 = dp0 + dp3 < k.beta316;
  const hw2 cond6 = dq0 + dq3 < k.beta316;
#pragma unroll
  for (int r = 0; r < 4; ++r) {
    const hw2 p0 = p[r][0], p1 = p[r][1], p2 = p[r][2], p3 = p[r][3];
    const hw2 q0 = q[r][0], q1 = q[r][1], q2 = q[r][2], q3 = q[r][3];
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
    const hw2 nrow = use_normal & (abs2(delta0) < k.tc10);
    const hw2 big_d = clip1(delta0, k.c, k.nc);
    const hw2 dp1 = clip1(asr(asr(p2 + p0 + k.one, 1) - p1 + big_d, 1), k.c2, k.nc2);
    const hw2 dq1 = clip1(asr(asr(q2 + q0 + k.one, 1) - q1 - big_d, 1), k.c2, k.nc2);
    t[p_at<PHASE>(r, 0)] = add_clip2(p0, sel(use_strong, s0p, big_d & nrow), k);
    t[p_at<PHASE>(r, 1)] = add_clip2(p1, sel(use_strong, s1p, dp1 & nrow & cond5), k);
    t[p_at<PHASE>(r, 2)] = add_clip2(p2, s2p & use_strong, k);
    t[q_at<PHASE>(r, 0)] = add_clip2(q0, sel(use_strong, s0q, -big_d & nrow), k);
    t[q_at<PHASE>(r, 1)] = add_clip2(q1, sel(use_strong, s1q, dq1 & nrow & cond6), k);
    t[q_at<PHASE>(r, 2)] = add_clip2(q2, s2q & use_strong, k);
  }
}

// Chroma segment on both lanes (cpu.h:1431-1488, dq with swapped operands);
// gate: BS == 2 per lane.
template <int PHASE>
GVCT_HD void chroma_segment(hw2 (&t)[64], hw2 gate, const Consts& k) {
#pragma unroll
  for (int r = 0; r < 4; ++r) {
    const hw2 p0 = t[p_at<PHASE>(r, 0)], p1 = t[p_at<PHASE>(r, 1)];
    const hw2 q0 = t[q_at<PHASE>(r, 0)], q1 = t[q_at<PHASE>(r, 1)];
    const hw2 dp = clip1(asr(shl(p0 - q0, 2) + p1 - q1 + k.four, 3), k.tc, k.ntc);
    const hw2 dq = clip1(asr(shl(q0 - p0, 2) + q1 - p1 + k.four, 3), k.tc, k.ntc);
    t[p_at<PHASE>(r, 0)] = add_clip2(p0, dp & gate, k);
    t[q_at<PHASE>(r, 0)] = add_clip2(q0, -(dq & gate), k);
  }
}

template <bool CHROMA, int PHASE>
GVCT_HD void segment(hw2 (&t)[64], hw2 gate, const Consts& k) {
  if constexpr (CHROMA) {
    chroma_segment<PHASE>(t, gate, k);
  } else {
    luma_segment<PHASE>(t, gate, k);
  }
}

// Per-lane gate of one BS byte pair (luma: BS > 0, chroma: BS == 2).
template <bool CHROMA>
GVCT_HD hw2 gate_of(int bs_lo, int bs_hi) {
  const bool lo = CHROMA ? bs_lo == 2 : bs_lo > 0;
  const bool hi = CHROMA ? bs_hi == 2 : bs_hi > 0;
  return {(lo ? 0x0000FFFFu : 0u) | (hi ? 0xFFFF0000u : 0u)};
}

// Load, filter and store the two tiles of a tile-planes tensor
// T[r, c, by, bx] ((r, c) planes `plane` bytes apart) whose cells are `lo`
// and `hi`; their BS bytes are at the same cells of the (By, Bx) maps.
template <bool CHROMA>
GVCT_HD void deblock_tile_pair_at(const uint8_t* in, uint8_t* out,
                                  const uint8_t* v1, const uint8_t* v2,
                                  const uint8_t* h1, const uint8_t* h2,
                                  size_t plane, size_t lo, size_t hi, const Thresholds& th) {
  const Consts k = make_consts(th);
  hw2 t[64];
#pragma unroll
  for (int i = 0; i < 64; ++i) {
    t[i].w = static_cast<uint32_t>(in[lo + i * plane]) |
             (static_cast<uint32_t>(in[hi + i * plane]) << 16);
  }
  segment<CHROMA, 0>(t, gate_of<CHROMA>(v1[lo], v1[hi]), k);
  segment<CHROMA, 1>(t, gate_of<CHROMA>(v2[lo], v2[hi]), k);
  segment<CHROMA, 2>(t, gate_of<CHROMA>(h1[lo], h1[hi]), k);
  segment<CHROMA, 3>(t, gate_of<CHROMA>(h2[lo], h2[hi]), k);
#pragma unroll
  for (int i = 0; i < 64; ++i) {
    out[lo + i * plane] = static_cast<uint8_t>(t[i].w);
    out[hi + i * plane] = static_cast<uint8_t>(t[i].w >> 16);
  }
}

// T1's thread: the tile pair (by, bx) and (by, bx + bx_n/2), bx < bx_n/2,
// of an (8, 8, by_n, bx_n) tile-planes tensor with (By, Bx) maps.
template <bool CHROMA>
GVCT_HD void deblock_pair(const uint8_t* in, uint8_t* out, const uint8_t* v1, const uint8_t* v2,
                          const uint8_t* h1, const uint8_t* h2, int by_n, int bx_n, size_t by,
                          size_t bx, const Thresholds& th) {
  const size_t plane = static_cast<size_t>(by_n) * bx_n;
  const size_t lo = by * bx_n + bx;
  deblock_tile_pair_at<CHROMA>(in, out, v1, v2, h1, h2, plane, lo, lo + bx_n / 2, th);
}

}  // namespace swar
}  // namespace gvct
