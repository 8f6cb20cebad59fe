// K1, K1c, K1-i16 and K1-i16c as a quad of four lanes per tile
// (deblock_kernel.cu, deblock_quad_kernel), shared by the CUDA kernel and
// the host build (host_shim.cpp).  A block owns TB consecutive cells (tiles)
// of the flattened (By, Bx) grid of one frame and 4 * TB threads.  The
// functions below are a thread's work between the kernel's exchange points
// (__syncthreads, __syncwarp, the quad's shuffles); the kernel runs them one
// after another in each thread, the host build runs every thread of a block
// through one function before the next.  The compute type T (int for K1/K1c,
// int16_t for K1-i16/K1-i16c) is a template parameter of the lane functions,
// passed on to deblock_tile.cuh's row math, and so is the bit depth BD (8,
// or 10 for K2-10; the luma exchange's field widths follow it); a lane's
// rows hold sample values 0 .. 2^BD - 1 as int whatever T.  T1
// (swar_tile.cuh) reuses the lane geometry and the staging words with a
// tile PAIR per quad (QuadLane<swar::hw2>).  T5
// (deblock_rows_quad_kernel) runs K1's lanes on the rows layout: a block
// owns TB tiles of one tile row, staged by TMA into RowsTmaCell's layout or
// in K1's words (rows_block, rows_staging).  K2 (deblock_packed_kernel)
// runs them on the frame's planes themselves: a block owns kPackedTiles
// tiles of one tile row of one plane, loaded by TMA as the picture's rows
// (packed_block, PackedCell<S>: 1-byte samples, or 2-byte ones for K2-10),
// and its lanes hold their samples in registers and pass them around the
// quad by shuffles, not through a stage (PackedTile, at the end).
//
// Thread tid is lane r = tid & 3 of tile t = tid >> 2, so a quad is four
// adjacent lanes of one warp.  Lane r is segment row r in every phase:
//   vertical phases: tile rows r and 4 + r (row r of upper-vert and of
//     lower-vert: disjoint pixels, so two independent chains);
//   horizontal phases: column r (left-hor row r, and right-hor row r's Q
//     side, quirk Q3) and column 4 + r rows 0-3 (right-hor row r's P side),
//     so right-hor reads the Q pixels left-hor wrote in the same lane.
// A luma segment's decision reads its rows 0 and 3: lanes 0 and 3 pack
// their row's terms into one word, lanes 1 and 2 contribute 0, and two
// xor-shuffles sum the words over the quad (the host build: a sum over the
// quad's array), so every lane holds the segment's terms.  The BS gate,
// cond1 and the strong/normal choice are thus one per quad; only the
// normal filter's per-row |delta0| gate differs by lane.
//
// Shared stage: plane (r, c) of the block's tiles at stage row k = 8r + c,
// stride kQuadStride bytes, tile t at column t.  A warp's 8 tiles are 2
// words of one row.  The stride is 17 words (the 32 banks are 32-bit
// words), so the four lanes of a quad reading one tile row each (stage rows
// k, k + 8, k + 16, k + 24: 8 words apart mod 32) or one column each (rows
// k .. k + 3: 17 apart) hit different banks.  The stage is 64 x 68 bytes,
// sized for the largest block, kQuadMaxTiles.
//
// The block moves its bytes between global memory and the stage in W-byte
// words (W = 8, 4 or 1, the widest that every run's alignment allows,
// quad_word_bytes): a plane's TB tiles are TB consecutive bytes at
// plane * k + cell0, so with cell0 a multiple of TB the runs are W-aligned
// when the plane size, TB and the base addresses are.
#pragma once

#include <cstring>
#include <type_traits>

#include "deblock_tile.cuh"

namespace gvct {

constexpr int kQuadLanes = 4;
constexpr int kQuadMaxTiles = 64;  // 4 * 64 = 256 threads per block
constexpr int kQuadStride = 4 * (kQuadMaxTiles / 4 + 1);  // 17 words: a row and a word of pad

// The widest word, 8, 4 or 1 bytes, in which a launch's runs are aligned.
GVCT_HD int quad_word_bytes(long long plane, int tb, const void* in, const void* out) {
  const unsigned long long addr = static_cast<unsigned long long>(
      reinterpret_cast<uintptr_t>(in) | reinterpret_cast<uintptr_t>(out));
  for (int w = 8; w > 1; w /= 2) {
    if (w != 2 && plane % w == 0 && tb % w == 0 && addr % w == 0) return w;
  }
  return 1;
}

// T5's block (deblock_kernel.cu, deblock_rows_quad_kernel): tiles
// [bx0, bx0 + tb) of tile row by in the rows layout R[by, r, c, bx] of a
// grid bx_n tiles wide.  Plane (r, c) of its first tile lies at
// tiles + (8r + c) * bx_n, its BS bytes at `map` in each (By, Bx) map; n of
// its tiles lie inside the grid.
struct RowsBlock {
  size_t tiles, map;
  int n;
};

GVCT_HD RowsBlock rows_block(size_t by, int bx0, int bx_n, int tb) {
  return {by * 64 * bx_n + bx0, by * bx_n + bx0, bx_n - bx0 < tb ? bx_n - bx0 : tb};
}

// T5's staging: route A, kRowsTma (the tensor memory accelerator), for
// blocks of whole TMA boxes (tb a multiple of kRowsBoxTiles) on a grid
// whose plane stride bx_n and both base addresses are multiples of 16 bytes
// (what a tensor map demands); otherwise route B's word bytes, 8, 4 or 1
// (quad_word_bytes with plane stride bx_n).
constexpr int kRowsTma = 0;
constexpr int kRowsBoxTiles = 32;  // RowsTmaCell's box width in tiles (bytes)

GVCT_HD int rows_staging(int bx_n, int tb, const void* in, const void* out) {
  const unsigned long long addr = static_cast<unsigned long long>(
      reinterpret_cast<uintptr_t>(in) | reinterpret_cast<uintptr_t>(out));
  if (tb % kRowsBoxTiles == 0 && bx_n % 16 == 0 && addr % 16 == 0) return kRowsTma;
  return quad_word_bytes(bx_n, tb, in, out);
}

// W bytes held in 32-bit words (byte e is byte e & 3 of word e >> 2).
template <int W>
struct Word {
  uint32_t w[W < 4 ? 1 : W / 4];
};

// The first `avail` of the W bytes at p (all W when avail >= W, in one
// aligned access on the device), the rest 0.
template <int W>
GVCT_HD Word<W> read_word(const uint8_t* p, int avail) {
  Word<W> x{};
  if (avail >= W) {
#ifdef __CUDA_ARCH__
    if constexpr (W == 8) {
      const uint2 v = *reinterpret_cast<const uint2*>(p);
      x.w[0] = v.x;
      x.w[1] = v.y;
    } else if constexpr (W == 4) {
      x.w[0] = *reinterpret_cast<const uint32_t*>(p);
    } else {
      x.w[0] = *p;
    }
#else
    std::memcpy(x.w, p, W);
#endif
  } else {
#pragma unroll
    for (int e = 0; e < W; ++e) {  // static indices keep x in registers
      if (e < avail) x.w[e >> 2] |= static_cast<uint32_t>(p[e]) << (8 * (e & 3));
    }
  }
  return x;
}

// Store the first `avail` bytes of x at p (all W in one access when
// avail >= W); nothing when avail <= 0.
template <int W>
GVCT_HD void write_word(uint8_t* p, const Word<W>& x, int avail) {
  if (avail >= W) {
#ifdef __CUDA_ARCH__
    if constexpr (W == 8) {
      *reinterpret_cast<uint2*>(p) = make_uint2(x.w[0], x.w[1]);
    } else if constexpr (W == 4) {
      *reinterpret_cast<uint32_t*>(p) = x.w[0];
    } else {
      *p = static_cast<uint8_t>(x.w[0]);
    }
#else
    std::memcpy(p, x.w, W);
#endif
  } else {
#pragma unroll
    for (int e = 0; e < W; ++e) {
      if (e < avail) p[e] = static_cast<uint8_t>(x.w[e >> 2] >> (8 * (e & 3)));
    }
  }
}

// A word at a 4-aligned stage position (W = 4, 8) or any (W = 1).
template <int W>
GVCT_HD void stage_put(uint8_t* s, const Word<W>& x) {
  if constexpr (W == 1) {
    *s = static_cast<uint8_t>(x.w[0]);
  } else {
#ifdef __CUDA_ARCH__
#pragma unroll
    for (int i = 0; i < W / 4; ++i) reinterpret_cast<uint32_t*>(s)[i] = x.w[i];
#else
    std::memcpy(s, x.w, W);
#endif
  }
}

template <int W>
GVCT_HD Word<W> stage_get(const uint8_t* s) {
  Word<W> x{};
  if constexpr (W == 1) {
    x.w[0] = *s;
  } else {
#ifdef __CUDA_ARCH__
#pragma unroll
    for (int i = 0; i < W / 4; ++i) x.w[i] = reinterpret_cast<const uint32_t*>(s)[i];
#else
    std::memcpy(x.w, s, W);
#endif
  }
  return x;
}

// A lane's pixel E as the stage holds it: one byte per tile at column t
// (E = int, K1); swar_tile.cuh specializes it for T1's tile pairs.  A
// stage layout C gives plane (r, c) of tile t at stage_cell<C>(stage, r, c,
// t): r * C::kRow + c * C::kStride + C::offset(t) bytes in.
template <typename E>
struct StageCell;

template <>
struct StageCell<int> {
  static constexpr int kStride = kQuadStride;  // bytes per stage row (plane column c)
  static constexpr int kRow = 8 * kStride;     // bytes per plane row r
  static constexpr int kBytes = 1;             // bytes per tile (pair) in a row
  GVCT_HD static int offset(int t) { return t * kBytes; }
  GVCT_HD static int get(const uint8_t* s) { return *s; }
  GVCT_HD static void put(uint8_t* s, int v) { *s = static_cast<uint8_t>(v); }
};

// T5's stage when the tensor memory accelerator (TMA) fills and drains it
// (deblock_kernel.cu, route A): the block's tiles in boxes of kBoxTiles,
// box h at h * kBoxBytes; a box holds plane (r, c) of its tiles at
// r * kRow + c * kStride, with a slot c = 8 per plane row that the load
// zero-fills and the store skips (the box runs past the tensor's 8 plane
// columns).  The stage rows are kBoxTiles = 32 bytes (8 banks) and plane
// (r, c) is row 9r + c, so row mod 4 is (r + c) mod 4: the quad's four
// lanes reading one tile row each (r, r + 1, r + 2, r + 3 at one c) or one
// column each (c .. c + 3 at one r) hit four different banks, as in K1's
// padded stage.  Dense 64-byte rows without the slot put the four row
// reads in one bank (rows 8 apart are 512 bytes apart).
struct RowsTmaCell : StageCell<int> {
  static constexpr int kBoxTiles = kRowsBoxTiles;  // the box's inner extent, bytes
  static constexpr int kBoxC = 9;               // plane columns per plane row, pad included
  static constexpr int kStride = kBoxTiles;
  static constexpr int kRow = kBoxC * kBoxTiles;
  static constexpr int kBoxBytes = 8 * kRow;    // 2,304 bytes, a multiple of 128
  GVCT_HD static int offset(int t) { return t / kBoxTiles * kBoxBytes + t % kBoxTiles; }
};

// K2's grid (deblock_kernel.cu, deblock_packed_kernel): (gx, rows, k).  A
// block owns kPackedTiles consecutive tiles of one tile row of one plane of
// one frame: grid row y < by is luma tile row y, blocks x < lx.  The chroma
// rows follow, laid out by the chroma planes' width cw.  Where a chroma row
// is half a luma row wide (4:2:0, 4:2:2: cw = w/2), grid row by + y is
// chroma tile row y of U (blocks x < cx) and of V (blocks cx <= x < 2 cx),
// side by side.  Where it is as wide as a luma row (4:4:4: cw = w, so cx =
// lx), side by side would double the grid's x extent and leave a quarter of
// its blocks past their rows' ends, so U and V each take grid rows of their
// own: by + y is U's tile row y and by + cby + y is V's, blocks x < cx.
// V's first block is (vx, vy) in either layout.  Blocks past their row's
// end own nothing (at 4:4:4 none but the last of a row can be short), and
// chroma rows are none under luma_only.  The tile grids are the chain's,
// (h + 8) / 8 x (w + 8) / 8 and (ch + 8) / 8 x (cw + 8) / 8, (ch, cw) the
// chroma planes' -- (h/2, w/2) at 4:2:0, (h, w/2) at 4:2:2, (h, w) at 4:4:4
// (H.265's SubHeightC and SubWidthC) -- runtime fields, so that one
// instance serves every format (utils/tiles.interior_to_tiles; every
// plane's edges on its own 8x8 grid): tile (by, bx) covers the plane's rows
// 8 by - 4 .. 8 by + 3 and columns 8 bx - 4 .. 8 bx + 3, zero outside it
// (Q6).
constexpr int kPackedTiles = 16;  // 64 threads: two whole warps

struct PackedGrid {
  int w, h, cw, ch;      // the luma plane; the chroma planes are cw x ch
  int by, bx, cby, cbx;  // the luma and the chroma tile grids
  int lx, cx;            // blocks per luma and per chroma tile row
  int vx, vy;            // V's first block: its column and its grid row
  int gx, rows;          // the grid's x and y extents
};

GVCT_HD PackedGrid packed_grid(int w, int h, int cw, int ch, int luma_only) {
  PackedGrid g;
  g.w = w;
  g.h = h;
  g.cw = cw;
  g.ch = ch;
  g.by = (h + 8) / 8;
  g.bx = (w + 8) / 8;
  g.cby = (ch + 8) / 8;
  g.cbx = (cw + 8) / 8;
  g.lx = (g.bx + kPackedTiles - 1) / kPackedTiles;
  g.cx = (g.cbx + kPackedTiles - 1) / kPackedTiles;
  const bool stacked = cw == w;  // 4:4:4: U's rows, then V's
  g.vx = stacked ? 0 : g.cx;
  g.vy = stacked ? g.by + g.cby : g.by;
  const int cgx = stacked ? g.cx : 2 * g.cx;
  g.gx = luma_only || g.lx >= cgx ? g.lx : cgx;
  g.rows = g.by + (luma_only ? 0 : (stacked ? 2 : 1) * g.cby);
  return g;
}

// Block (x, y) of a frame: its plane (0 luma, 1 U, 2 V), tile row by,
// first tile bx0, the n of its tiles inside the grid (n <= 0: a block past
// its row's end, which owns nothing), and its first tile in each of the
// plane's BS maps (one set for luma, one for U and V, shared by the
// frames).  No division: a block's threads all compute it.
struct PackedBlock {
  int plane, by, bx0, n;
  size_t map;
};

GVCT_HD PackedBlock packed_block(const PackedGrid& g, int x, int y) {
  PackedBlock k;
  int bx_n;
  if (y < g.by) {
    k.plane = 0;
    k.by = y;
    bx_n = g.bx;
  } else {
    const int v = x >= g.vx && y >= g.vy;
    k.plane = 1 + v;
    k.by = y - (v ? g.vy : g.by);
    x -= v ? g.vx : 0;
    bx_n = g.cbx;
  }
  k.bx0 = x * kPackedTiles;
  k.n = bx_n - k.bx0 < kPackedTiles ? bx_n - k.bx0 : kPackedTiles;
  k.map = static_cast<size_t>(k.by) * bx_n + k.bx0;
  return k;
}

// K2's box: the block's TMA box as it lands, 8 picture rows of kWidth
// samples from column 8 bx0 - 4 - kLead -- a tensor copy starts on a
// 16-byte boundary, and the block's first tile starts at 8 bx0 - 4, kLead
// samples in -- so sample (r, c) of tile t is at r * kRow + kSample * (kLead
// + 8t + c) bytes.  S, the sample type, is uint8_t (8 bits: kLead 12, rows
// of 144 bytes) or uint16_t (K2-10: kLead 4, rows of 136 samples, 272
// bytes).  The box lands densely at a 128-byte aligned address.  The lanes
// read it in words of 4 samples, kWord bytes (4 or 8), never one sample at
// a time (packed_read, below).
//
// Banks.  A tile row's half, 4 samples from column 4h (h = 0, 1), is a word
// at (row) kRow + offset(t) + h kWord bytes: offset(t) is 12 + 8t or 8 +
// 16t, so the word is aligned to its size (3 + 2t or 1 + 2t words in).
// Shared memory serves a warp's 4-byte reads in one pass over 32 banks of 4
// bytes, and its 8-byte reads in two passes, a half-warp each, over 16
// pairs of banks: kBanks words of kWord bytes (128 bytes) a pass.  A pass is
// conflict-free where its words lie in distinct banks mod kBanks.  A row
// moves a word kRowBanks banks (36 mod 32 = 4 at 8 bits, 34 mod 16 = 2 at
// 10), so rows 4 apart move it 4 kRowBanks = kBanks / 2, and tiles move it
// 2 banks.  Read row by row, the quad's four rows of a warp's tiles
// collide: word (row r, tile t) is in bank kRowBanks r + 2t + h + lead,
// which is one bank for the four (r, t) with 2r + t = 6 (8 bits) or r + t =
// 3 (10), four-way; packed_read spreads them (its note).
template <typename S>
struct PackedCell {
  static constexpr int kSample = sizeof(S);                   // bytes a sample
  static constexpr int kLead = 16 / kSample - 4;              // samples
  static constexpr int kWidth = kLead + 8 * kPackedTiles + 4;  // samples in a box row
  static constexpr int kRow = kSample * kWidth;               // bytes: a multiple of 16
  static constexpr int kBytes = 8 * kRow;
  static constexpr int kWord = 4 * kSample;                   // bytes: 4 samples
  static constexpr int kBanks = 128 / kWord;                  // words a pass spans
  static constexpr int kRowBanks = kRow / kWord % kBanks;     // banks a row moves a word
  GVCT_HD static int offset(int t) { return kSample * (kLead + 8 * t); }
};
static_assert(PackedCell<uint8_t>::kLead == 12 && PackedCell<uint8_t>::kRow == 144 &&
                  PackedCell<uint16_t>::kLead == 4 && PackedCell<uint16_t>::kRow == 272,
              "a block's box starts on a 16-byte boundary, 4 + kLead samples before its tiles");
static_assert(PackedCell<uint8_t>::kRow % 16 == 0 && PackedCell<uint16_t>::kRow % 16 == 0 &&
                  PackedCell<uint16_t>::kWidth <= 256,
              "a TMA box row is a multiple of 16 bytes and at most 256 elements");
static_assert(4 * PackedCell<uint8_t>::kRowBanks == PackedCell<uint8_t>::kBanks / 2 &&
                  4 * PackedCell<uint16_t>::kRowBanks == PackedCell<uint16_t>::kBanks / 2,
              "rows 4 apart lie half a pass of banks apart (packed_read's order relies on it)");

// A sample of bit depth BD as the planes hold it: a byte at 8 bits, a
// 16-bit word at 10 (yuv420p10le); K2's box is PackedCell<PackedSample<BD>>.
template <int BD>
using PackedSample = std::conditional_t<BD == 8, uint8_t, uint16_t>;

template <typename E = int>
struct QuadLane {
  int t, r;       // tile (pair) in the block, segment row
  E bs[4];        // K1: the tile's BS bytes (ver1, ver2, hor1, hor2), 0 past the grid
  E a[8], b[8];   // vertical phases: tile rows r and 4 + r
  E cl[8], cr[4]; // horizontal phases: column r, column 4 + r rows 0-3
};

template <typename E = int>
GVCT_HD QuadLane<E> quad_lane(int tid) {
  QuadLane<E> lane{};
  lane.t = tid >> 2;
  lane.r = tid & 3;
  return lane;
}

// The tile's BS bytes: `map` is the block's first tile in each map, n the
// block's tiles inside the grid.  The four lanes of a quad read one byte.
GVCT_HD void quad_load_bs(QuadLane<>& lane, const uint8_t* v1, const uint8_t* v2,
                          const uint8_t* h1, const uint8_t* h2, size_t map, int n) {
  const bool inside = lane.t < n;
  const size_t at = map + lane.t;
  lane.bs[0] = inside ? v1[at] : 0;
  lane.bs[1] = inside ? v2[at] : 0;
  lane.bs[2] = inside ? h1[at] : 0;
  lane.bs[3] = inside ? h2[at] : 0;
}

// Words a thread keeps in flight in the cooperative load and store.  With
// 1-byte words the 16 accesses go in two groups, one after the other (the
// group loop stays rolled): all 16 addresses live at once spilled past the
// 64 registers the kernel's launch bounds allow.
constexpr int kQuadInFlight = 8;

// The block's cooperative load, in W-byte words: thread tid reads word m =
// tid % (TB / W) of the 16 / W planes k = 4W * j + tid / (TB / W)
// (consecutive threads read consecutive words of one plane), a group of
// loads before its stage stores.  `src` is the block's first tile in plane
// 0; bytes past the grid's n tiles are staged as 0.  TB % W == 0.
template <int W>
GVCT_HD void quad_stage_load(const uint8_t* src, size_t plane, int n, int tb, uint8_t* stage,
                             int tid) {
  constexpr int kWords = 16 / W, kGroup = kWords < kQuadInFlight ? kWords : kQuadInFlight;
  const int wpp = tb / W;
  const int k0 = tid / wpp, m = tid - k0 * wpp;
#pragma unroll 1
  for (int j0 = 0; j0 < kWords; j0 += kGroup) {
    Word<W> v[kGroup];
#pragma unroll
    for (int j = 0; j < kGroup; ++j) {
      const int k = 4 * W * (j0 + j) + k0;
      v[j] = read_word<W>(src + static_cast<size_t>(k) * plane + W * m, n - W * m);
    }
#pragma unroll
    for (int j = 0; j < kGroup; ++j) {
      stage_put<W>(stage + (4 * W * (j0 + j) + k0) * kQuadStride + W * m, v[j]);
    }
  }
}

// The block's cooperative store, the load's mapping; nothing past the grid.
template <int W>
GVCT_HD void quad_stage_store(const uint8_t* stage, uint8_t* dst, size_t plane, int n, int tb,
                              int tid) {
  constexpr int kWords = 16 / W, kGroup = kWords < kQuadInFlight ? kWords : kQuadInFlight;
  const int wpp = tb / W;
  const int k0 = tid / wpp, m = tid - k0 * wpp;
#pragma unroll 1
  for (int j0 = 0; j0 < kWords; j0 += kGroup) {
    Word<W> v[kGroup];
#pragma unroll
    for (int j = 0; j < kGroup; ++j) {
      v[j] = stage_get<W>(stage + (4 * W * (j0 + j) + k0) * kQuadStride + W * m);
    }
#pragma unroll
    for (int j = 0; j < kGroup; ++j) {
      const int k = 4 * W * (j0 + j) + k0;
      write_word<W>(dst + static_cast<size_t>(k) * plane + W * m, v[j], n - W * m);
    }
  }
}

// The cell of plane (r, c) of tile t in a stage of layout C.
template <typename C>
GVCT_HD const uint8_t* stage_cell(const uint8_t* stage, int r, int c, int t) {
  return stage + r * C::kRow + c * C::kStride + C::offset(t);
}
template <typename C>
GVCT_HD uint8_t* stage_cell(uint8_t* stage, int r, int c, int t) {
  return stage + r * C::kRow + c * C::kStride + C::offset(t);
}

// Tile rows r and 4 + r: all 8 columns (luma), columns 2-5 (chroma).
template <bool CHROMA, typename E, typename C = StageCell<E>>
GVCT_HD void quad_read_rows(QuadLane<E>& lane, const uint8_t* stage) {
  const uint8_t* a = stage_cell<C>(stage, lane.r, 0, lane.t);
  const uint8_t* b = a + 4 * C::kRow;
#pragma unroll
  for (int c = CHROMA ? 2 : 0; c < (CHROMA ? 6 : 8); ++c) {
    lane.a[c] = C::get(a + c * C::kStride);
    lane.b[c] = C::get(b + c * C::kStride);
  }
}

// The columns the vertical phases may change: 1-6 (luma), 3-4 (chroma).
template <bool CHROMA, typename E, typename C = StageCell<E>>
GVCT_HD void quad_write_rows(const QuadLane<E>& lane, uint8_t* stage) {
  uint8_t* a = stage_cell<C>(stage, lane.r, 0, lane.t);
  uint8_t* b = a + 4 * C::kRow;
#pragma unroll
  for (int c = CHROMA ? 3 : 1; c < (CHROMA ? 5 : 7); ++c) {
    C::put(a + c * C::kStride, lane.a[c]);
    C::put(b + c * C::kStride, lane.b[c]);
  }
}

// Column r (rows 0-7 luma, 2-5 chroma) and column 4 + r (rows 0-3 luma,
// 2-3 chroma), after the whole quad wrote its rows.
template <bool CHROMA, typename E, typename C = StageCell<E>>
GVCT_HD void quad_read_cols(QuadLane<E>& lane, const uint8_t* stage) {
  const uint8_t* l = stage_cell<C>(stage, 0, lane.r, lane.t);
  const uint8_t* r = l + 4 * C::kStride;
#pragma unroll
  for (int i = CHROMA ? 2 : 0; i < (CHROMA ? 6 : 8); ++i) lane.cl[i] = C::get(l + i * C::kRow);
#pragma unroll
  for (int i = CHROMA ? 2 : 0; i < 4; ++i) lane.cr[i] = C::get(r + i * C::kRow);
}

// The pixels the horizontal phases may change: column r rows 1-6 and
// column 4 + r rows 1-3 (luma); rows 3-4 and row 3 (chroma).
template <bool CHROMA, typename E, typename C = StageCell<E>>
GVCT_HD void quad_write_cols(const QuadLane<E>& lane, uint8_t* stage) {
  uint8_t* l = stage_cell<C>(stage, 0, lane.r, lane.t);
  uint8_t* r = l + 4 * C::kStride;
#pragma unroll
  for (int i = CHROMA ? 3 : 1; i < (CHROMA ? 5 : 7); ++i) C::put(l + i * C::kRow, lane.cl[i]);
#pragma unroll
  for (int i = CHROMA ? 3 : 1; i < 4; ++i) C::put(r + i * C::kRow, lane.cr[i]);
}

// -- luma ----------------------------------------------------------------------

// A row's dp and dq are |p2 - 2 p1 + p0| of samples 0 .. 2^BD - 1: at most
// 2 (2^BD - 1), 510 at 8 bits in int and in int16_t alike (no int16 wrap)
// and 2,046 at 10, so the quad's sum of two rows fits a (BD + 2)-bit field:
// 10 bits at 8 (K1-i16 exchanges the same words as K1), 12 at 10.  The
// count of rows that fail the strong conditions (at most 2) sits above the
// two fields.
template <int BD>
struct QuadField {
  static constexpr int kBits = BD + 2;
  static constexpr uint32_t kMask = (1u << kBits) - 1;
  static constexpr int kMaxRowD = 2 * ((1 << BD) - 1);
  static_assert(2 * kMaxRowD <= static_cast<int>(kMask) && 2 * kBits + 2 <= 32,
                "a segment's dp and dq fit their fields, and the count fits above them");
};

// The lane's word for the quad sum: its row's dp and dq and a count of rows
// that fail the strong conditions, from rows 0 and 3 only.
template <int BD = 8>
GVCT_HD uint32_t quad_word(const RowTerms& rt, int r) {
  using F = QuadField<BD>;
  return (r == 0 || r == 3) ? static_cast<uint32_t>(rt.dp) |
                                  static_cast<uint32_t>(rt.dq) << F::kBits |
                                  static_cast<uint32_t>(!rt.strong) << 2 * F::kBits
                            : 0u;
}

// The segment's terms from the quad sum of quad_word.
template <int BD = 8>
GVCT_HD RowTerms segment_terms(uint32_t sum) {
  using F = QuadField<BD>;
  return RowTerms{static_cast<int>(sum & F::kMask), static_cast<int>(sum >> F::kBits & F::kMask),
                  (sum >> 2 * F::kBits) == 0};
}

// P and Q of a segment row that lies along a row array: p[j] = row[3 - j],
// q[j] = row[4 + j] (vertical phases, and left-hor along column r).
template <typename E>
GVCT_HD void split_row(const E (&row)[8], E (&p)[4], E (&q)[4]) {
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    p[j] = row[3 - j];
    q[j] = row[4 + j];
  }
}

template <typename E>
GVCT_HD void join_row(E (&row)[8], const E (&p)[4], const E (&q)[4]) {
#pragma unroll
  for (int j = 0; j < 3; ++j) {
    row[3 - j] = p[j];
    row[4 + j] = q[j];
  }
}

// Right-hor row r: P from column 4 + r, Q from column r (Q3).
template <typename E>
GVCT_HD void split_right(const QuadLane<E>& lane, E (&p)[4], E (&q)[4]) {
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    p[j] = lane.cr[3 - j];
    q[j] = lane.cl[4 + j];
  }
}

template <typename E>
GVCT_HD void join_right(QuadLane<E>& lane, const E (&p)[4], const E (&q)[4]) {
#pragma unroll
  for (int j = 0; j < 3; ++j) {
    lane.cr[3 - j] = p[j];
    lane.cl[4 + j] = q[j];
  }
}

// The lane's row of one luma segment, given the quad sum of its words.
template <typename T, int BD = 8>
GVCT_HD void quad_luma_row(int (&p)[4], int (&q)[4], int bs, uint32_t sum, const Thresholds& th) {
  if (gated_on<false>(bs)) luma_row<T, BD>(p, q, luma_decision<T>(segment_terms<BD>(sum), th), th);
}

// Upper-vert and lower-vert words: w[0] of row r, w[1] of row 4 + r.
template <typename T, int BD = 8>
GVCT_HD void quad_vert_words(const QuadLane<>& lane, const Thresholds& th, uint32_t (&w)[2]) {
  int p[4], q[4];
  split_row(lane.a, p, q);
  w[0] = quad_word<BD>(row_terms<T>(p, q, th), lane.r);
  split_row(lane.b, p, q);
  w[1] = quad_word<BD>(row_terms<T>(p, q, th), lane.r);
}

// sum = the quad sums of quad_vert_words' w[0] and w[1].
template <typename T, int BD = 8>
GVCT_HD void quad_vert_luma(QuadLane<>& lane, const uint32_t (&sum)[2], const Thresholds& th) {
  int p[4], q[4];
  split_row(lane.a, p, q);
  quad_luma_row<T, BD>(p, q, lane.bs[0], sum[0], th);
  join_row(lane.a, p, q);
  split_row(lane.b, p, q);
  quad_luma_row<T, BD>(p, q, lane.bs[1], sum[1], th);
  join_row(lane.b, p, q);
}

template <typename T, int BD = 8>
GVCT_HD uint32_t quad_left_word(const QuadLane<>& lane, const Thresholds& th) {
  int p[4], q[4];
  split_row(lane.cl, p, q);
  return quad_word<BD>(row_terms<T>(p, q, th), lane.r);
}

template <typename T, int BD = 8>
GVCT_HD void quad_left_luma(QuadLane<>& lane, uint32_t sum, const Thresholds& th) {
  int p[4], q[4];
  split_row(lane.cl, p, q);
  quad_luma_row<T, BD>(p, q, lane.bs[2], sum, th);
  join_row(lane.cl, p, q);
}

template <typename T, int BD = 8>
GVCT_HD uint32_t quad_right_word(const QuadLane<>& lane, const Thresholds& th) {
  int p[4], q[4];
  split_right(lane, p, q);
  return quad_word<BD>(row_terms<T>(p, q, th), lane.r);
}

template <typename T, int BD = 8>
GVCT_HD void quad_right_luma(QuadLane<>& lane, uint32_t sum, const Thresholds& th) {
  int p[4], q[4];
  split_right(lane, p, q);
  quad_luma_row<T, BD>(p, q, lane.bs[3], sum, th);
  join_right(lane, p, q);
}

// -- chroma: no decision, so no exchange -------------------------------------------

template <typename T, int BD = 8>
GVCT_HD void quad_chroma_row(int& p0, int p1, int& q0, int q1, int bs, int tc) {
  if (gated_on<true>(bs)) chroma_row<T, BD>(p0, p1, q0, q1, tc);
}

template <typename T, int BD = 8>
GVCT_HD void quad_vert_chroma(QuadLane<>& lane, const Thresholds& th) {
  quad_chroma_row<T, BD>(lane.a[3], lane.a[2], lane.a[4], lane.a[5], lane.bs[0], th.tc);
  quad_chroma_row<T, BD>(lane.b[3], lane.b[2], lane.b[4], lane.b[5], lane.bs[1], th.tc);
}

template <typename T, int BD = 8>
GVCT_HD void quad_hor_chroma(QuadLane<>& lane, const Thresholds& th) {
  quad_chroma_row<T, BD>(lane.cl[3], lane.cl[2], lane.cl[4], lane.cl[5], lane.bs[2], th.tc);
  quad_chroma_row<T, BD>(lane.cr[3], lane.cr[2], lane.cl[4], lane.cl[5], lane.bs[3], th.tc);
}

// -- K2: the tile in registers ---------------------------------------------------------
//
// K2 and K2-10 (deblock_kernel.cu, packed_quad_phases) hold a lane's
// samples in registers from the box's read to the plane's store.  A tile's
// four 4x4 blocks are f = 2s + h: rows 4s .. 4s + 3, columns 4h .. 4h + 3.
// Lane r holds word f, 4 samples, of each: row r of block f (so rows r and
// 4 + r of the tile, as the vertical phases want them), and after the
// quad's transpose of blocks 0-2, column r of block f (so column r and
// column 4 + r rows 0-3, as the horizontal phases want them; block 3,
// rows 4-7 of columns 4-7, no horizontal phase reads).  The rows go to
// and from QuadLane's arrays (packed_rows, packed_cols and their puts), so
// the phases are K1's functions as they are.

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

// A lane's four words, each 4 samples packed as the plane holds them: one
// 32-bit word at 8 bits, two at 10.
template <int BD>
struct PackedTile {
  using Cell = PackedCell<PackedSample<BD>>;
  static constexpr int kWords = Cell::kWord / 4;
  uint32_t x[4][kWords];

  // Sample c (0-3) of word f.
  GVCT_HD int get(int f, int c) const {
    if constexpr (BD == 8) {
      return static_cast<int>(byte_perm(x[f][0], 0, 0x4440 | c));
    } else {
      const uint32_t w = x[f][c >> 1];
      return static_cast<int>(c & 1 ? w >> 16 : w & 0xFFFF);
    }
  }
  // Sample c of word f set to v, the others kept.
  GVCT_HD void put(int f, int c, int v) {
    const uint32_t u = static_cast<uint32_t>(v);
    if constexpr (BD == 8) {
      x[f][0] = byte_perm(x[f][0], u, (0x3210u & ~(0xFu << 4 * c)) | 4u << 4 * c);
    } else {
      x[f][c >> 1] = byte_perm(x[f][c >> 1], u, c & 1 ? 0x5410 : 0x3254);
    }
  }
  // Word f made anew from v[c0 .. c0 + 3].
  template <int N>
  GVCT_HD void set(int f, const int (&v)[N], int c0) {
    uint32_t u[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) u[i] = static_cast<uint32_t>(v[c0 + i]);
    if constexpr (BD == 8) {
      x[f][0] = byte_perm(byte_perm(u[0], u[1], 0x0040), byte_perm(u[2], u[3], 0x0040), 0x5410);
    } else {
      x[f][0] = byte_perm(u[0], u[1], 0x5410);
      x[f][1] = byte_perm(u[2], u[3], 0x5410);
    }
  }
};

// Read order.  A lane (t, r) reads its four words at once, but not as
// f = 0, 1, 2, 3: with one f for the whole warp the rows collide four to a
// bank (the note on PackedCell).  Word f = 2s + h of lane (t, r) lies in
// bank
//   kRowBanks (4s + r) + 2t + h + lead = (kBanks/2) s + v + h + lead,
// v = kRowBanks r + 2t, mod kBanks.  Write v mod kBanks = (kBanks/2) w + u
// with u < kBanks/2 (u even, w = 0 or 1): the bank is (kBanks/2) (s ^ w) +
// u + h + lead.  At step j = 0 .. 3 the lane reads h = j & 1 and the s with
// s ^ w = (j >> 1) ^ (r & 1): f = j ^ m, m = 2 (w ^ (r & 1)), each of its
// words once over the four steps.  At one step h is the same over a pass,
// so its banks are told apart by (s ^ w, u).  The lanes of a pass with one
// u are four, one of each r (u fixes 2t mod 16 for a given r: one of a
// warp's 8 tiles at 8 bits; 2t mod 8: one of a half-warp's 4 at 10), and
// (j >> 1) ^ (r & 1) parts them two and two: every read is at most
// two-way, at both bit depths.  (Conflict-free reads would need h to vary
// by lane too, and the lane a second select a register to put its words
// in order; timed on the card, the selects cost more than the second way.)
// The lanes then take each word to its register with one select a
// register, a swap of rows r and 4 + r where m is 2.  Only the lane's own
// tile is read.

// Whether lane (t, r)'s m is 2: it reads row 4 + r before row r.
template <int BD>
GVCT_HD bool packed_read_swaps(int t, int r) {
  using C = typename PackedTile<BD>::Cell;
  return (((C::kRowBanks * r + 2 * t) & C::kBanks / 2) != 0) != ((r & 1) != 0);
}

// The byte in the box of the word lane (t, r) reads at step j, its word
// j ^ m: steps 0 and 1 read the halves of one row, steps 2 and 3 those of
// the row 4 away.
template <int BD>
GVCT_HD int packed_read_at(int t, int r, int j) {
  using C = typename PackedTile<BD>::Cell;
  const bool swap = packed_read_swaps<BD>(t, r);
  return (r + (swap ? 4 : 0)) * C::kRow + C::offset(t) + (j & 1) * C::kWord +
         (j & 2 ? (swap ? -4 : 4) * C::kRow : 0);
}

template <int BD>
GVCT_HD void packed_read(PackedTile<BD>& p, const uint8_t* stage, int t, int r) {
  constexpr int K = PackedTile<BD>::kWords;
  const bool swap = packed_read_swaps<BD>(t, r);
  uint32_t v[4][K];
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const uint8_t* s = stage + packed_read_at<BD>(t, r, j);
#ifdef __CUDA_ARCH__
    if constexpr (K == 1) {
      v[j][0] = *reinterpret_cast<const uint32_t*>(s);
    } else {
      const uint2 w = *reinterpret_cast<const uint2*>(s);
      v[j][0] = w.x;
      v[j][1] = w.y;
    }
#else
    std::memcpy(v[j], s, 4 * K);
#endif
  }
#pragma unroll
  for (int f = 0; f < 4; ++f) {
#pragma unroll
    for (int i = 0; i < K; ++i) p.x[f][i] = swap ? v[f ^ 2][i] : v[f][i];
  }
}

// Tile rows r and 4 + r into lane.a and lane.b: all 8 columns (luma),
// columns 2-5 (chroma).
template <bool CHROMA, int BD>
GVCT_HD void packed_rows(QuadLane<>& lane, const PackedTile<BD>& p) {
#pragma unroll
  for (int c = CHROMA ? 2 : 0; c < (CHROMA ? 6 : 8); ++c) {
    lane.a[c] = p.get(c >> 2, c & 3);
    lane.b[c] = p.get(2 + (c >> 2), c & 3);
  }
}

// The columns the vertical phases may change back into the words: 3-4
// (chroma); luma's 1-6 as whole words, with the unchanged 0 and 7.
template <bool CHROMA, int BD>
GVCT_HD void packed_put_rows(const QuadLane<>& lane, PackedTile<BD>& p) {
  if constexpr (CHROMA) {
#pragma unroll
    for (int c = 3; c < 5; ++c) {
      p.put(c >> 2, c & 3, lane.a[c]);
      p.put(2 + (c >> 2), c & 3, lane.b[c]);
    }
  } else {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      p.set(h, lane.a, 4 * h);
      p.set(2 + h, lane.b, 4 * h);
    }
  }
}

// The quad's 4x4 transpose of block f, as two exchanges of one 32-bit word
// a lane: k = 1 with lane r ^ 1, then k = 2 with lane r ^ 2 (the caller's
// xor-shuffles).  Exchange k transposes the 2x2 arrays of elements that
// lanes r and r ^ k hold: elements are samples, then pairs of samples, at
// 8 bits (one word a row: bytes, then 16-bit halves), pairs, then whole
// words at 10 (two words a row).  packed_send is the word lane r gives its
// partner; packed_take folds in the word it gets.  At 8 bits a lane gives
// its whole word and keeps the half it needs (one byte_perm); at 10 it
// gives only what the partner needs (exchange 1: the partner's column of
// each 2x2, one byte_perm; exchange 2: one whole word, a select).
template <int BD>
GVCT_HD uint32_t packed_send(const PackedTile<BD>& p, int f, int k, int r) {
  if constexpr (BD == 8) {
    return p.x[f][0];
  } else if (k == 1) {
    return byte_perm(p.x[f][0], p.x[f][1], r & 1 ? 0x5410 : 0x7632);
  } else {
    return r & 2 ? p.x[f][0] : p.x[f][1];
  }
}

template <int BD>
GVCT_HD void packed_take(PackedTile<BD>& p, int f, int k, int r, uint32_t got) {
  if constexpr (BD == 8) {
    p.x[f][0] = k == 1 ? byte_perm(p.x[f][0], got, r & 1 ? 0x3715 : 0x6240)
                       : byte_perm(p.x[f][0], got, r & 2 ? 0x3276 : 0x5410);
  } else if (k == 1) {
    p.x[f][0] = byte_perm(p.x[f][0], got, r & 1 ? 0x3254 : 0x5410);
    p.x[f][1] = byte_perm(p.x[f][1], got, r & 1 ? 0x3276 : 0x7610);
  } else {
    p.x[f][0] = r & 2 ? got : p.x[f][0];
    p.x[f][1] = r & 2 ? p.x[f][1] : got;
  }
}

// Column r (rows 0-7 luma, 2-5 chroma: blocks 0 and 2) and column 4 + r
// (rows 0-3 luma, 2-3 chroma: block 1), after the quad's transpose.
template <bool CHROMA, int BD>
GVCT_HD void packed_cols(QuadLane<>& lane, const PackedTile<BD>& p) {
#pragma unroll
  for (int i = CHROMA ? 2 : 0; i < (CHROMA ? 6 : 8); ++i) lane.cl[i] = p.get(2 * (i >> 2), i & 3);
#pragma unroll
  for (int i = CHROMA ? 2 : 0; i < 4; ++i) lane.cr[i] = p.get(1, i);
}

// The pixels the horizontal phases may change back into the words: rows
// 3-4 of column r and row 3 of column 4 + r (chroma); luma's rows 1-6 and
// 1-3 as whole words.
template <bool CHROMA, int BD>
GVCT_HD void packed_put_cols(const QuadLane<>& lane, PackedTile<BD>& p) {
  if constexpr (CHROMA) {
    p.put(0, 3, lane.cl[3]);
    p.put(2, 0, lane.cl[4]);
    p.put(1, 3, lane.cr[3]);
  } else {
    p.set(0, lane.cl, 0);
    p.set(2, lane.cl, 4);
    p.set(1, lane.cr, 0);
  }
}

// Lane (t, r)'s rows r and 4 + r of its tile into the plane (ph rows of pw
// samples, rows `row` bytes apart; the block's tiles from column x0 = 8 bx0
// - 4, row y0 = 8 by - 4): a word of 4 samples a store, 4 or 8 bytes at a
// multiple of its size (x0 + 8t + 4h is 4 mod 8 samples).  pw is a multiple
// of 4, so a word lies wholly inside the plane or wholly outside; words
// outside it, and tiles past the grid's n (which lie outside it too), are
// not stored.  A block whose 8 rows and 16 tiles all lie inside the plane
// (most blocks; the same for all its lanes) stores without the checks.
template <int BD>
GVCT_HD void packed_store(const PackedTile<BD>& p, uint8_t* plane, long long row, int ph, int pw,
                          int x0, int y0, int t, int r, int n) {
  using C = typename PackedTile<BD>::Cell;
  if (t >= n) return;
  const bool inside = n == kPackedTiles && y0 >= 0 && y0 + 8 <= ph && x0 >= 0 &&
                      x0 + 8 * kPackedTiles <= pw;
#pragma unroll
  for (int f = 0; f < 4; ++f) {
    const int y = y0 + 4 * (f >> 1) + r, x = x0 + 8 * t + 4 * (f & 1);
    if (!inside && (y < 0 || y >= ph || x < 0 || x >= pw)) continue;
    uint8_t* d = plane + y * row + C::kSample * x;
#ifdef __CUDA_ARCH__
    if constexpr (PackedTile<BD>::kWords == 1) {
      *reinterpret_cast<uint32_t*>(d) = p.x[f][0];
    } else {
      *reinterpret_cast<uint2*>(d) = make_uint2(p.x[f][0], p.x[f][1]);
    }
#else
    std::memcpy(d, p.x[f], C::kWord);
#endif
  }
}

}  // namespace gvct
