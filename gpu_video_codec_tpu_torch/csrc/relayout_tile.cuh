// Index math of the relayout kernels (T2 plane -> tile-planes, T3 tile-planes
// -> plane) and the YV12 pack kernel (T4), shared by the CUDA kernels
// (relayout_kernel.cu, built by nvcc) and the host build that the CPU tests
// load (host_shim.cpp, built by g++).  The per-block work is written once,
// here, as the loop a thread `tid` of NT threads runs (NT a compile-time
// constant, so the loops unroll); the kernel instantiates it with its block
// size, the host build with NT = 1 (one thread does a block's work) and with
// the kernel's NT (its threads run one after another in each phase).
//
// Tile-planes: T[r, c, by, bx] is extended pixel (8by + r, 8bx + c) of the
// plane zero-extended by `pad` on every side (Q6: padding is 0), over a grid
// of (by_grid, bx_grid) tiles.  Tiles past the extended plane are grid
// padding (zero pixels).  Tile rows count by truncating division (Q9: at
// 1080p chroma, (540 + 8) / 8 = 68 tile rows cover 544 of the 548 extended
// rows; the 4 dropped rows are padding the reference never sweeps).
//
// The flat view (Q9, `flat` = 1): the tile-planes are those of the
// reference's chroma sweep, which reads the padded plane's bytes as one flat
// run viewed as (vh, vw) = (8 * rows // 8, 8 * cols // 8) of the padded
// plane: T[r, c, by, bx] is padded byte f = (8by + r) * vw + 8bx + c, i.e.
// padded pixel (f / pw, f % pw) with pw = w + 2 pad -- interior pixel
// (f / pw - pad, f % pw - pad) when that lies inside, else 0.  When pw is a
// multiple of 8 the view is the first vh padded rows and the kernels take
// the row path below; otherwise ("sheared", w % 16 == 8 chroma) the plane
// side goes byte by byte through that index map.  The padded bytes past
// the view (f >= vh * vw, the flat tail, which can hold real bottom rows)
// are never filtered: T2 can copy them out to a flat buffer `rem` and T3
// write the interior ones back from it, in extra blocks of the same launch
// (grid rows 8 * by_grid and up), so a fresh output needs no other copy.
//
// Global accesses are 16 bytes wide and aligned by the actual address.  A
// contiguous global run -- a plane row segment, or one (r, c, by) tile-plane
// row segment -- is cut into the aligned 16-byte chunks that cover it: a
// head chunk holding its first (up to 15 + 1) bytes, a body of whole chunks
// and a tail chunk.  Whole chunks move as one 16-byte access.  A head or
// tail chunk is LOADED whole too (an aligned 16-byte chunk never crosses a
// page, and the bytes outside the run are masked off) and STORED in aligned
// pieces of 8, 4, 2 and 1 bytes that cover exactly the run's bytes.
#pragma once

#include <climits>
#include <cstddef>
#include <cstdint>
#include <cstring>

#ifndef GVCT_HD
#ifdef __CUDACC__
#define GVCT_HD __host__ __device__ __forceinline__
#else
#define GVCT_HD inline
#endif
#endif

#ifdef __CUDA_ARCH__
#define GVCT_UNROLL _Pragma("unroll")
#else
#define GVCT_UNROLL
#endif

namespace gvct {

constexpr int kTile = 8;                              // SAMPLE_BLOCK_SIZE
constexpr int kChunk = 16;                            // bytes per global access
constexpr int kSpanTiles = 256;                       // tiles of one block along Bx
constexpr int kSpanCols = kTile * kSpanTiles;         // 2,048 extended columns
constexpr int kRowChunks = kSpanCols / kChunk + 1;    // chunks of a span row at any residue
constexpr int kRunChunks = kSpanTiles / kChunk + 1;   // chunks of a 256-byte tile run
constexpr int kRowItems = kRowChunks;                 // plane-side chunks of a block: 129
constexpr int kRunItems = kTile * kRunChunks;         // tile-side chunks of a block: 136
constexpr int kStageBytes = kRowChunks * kChunk;       // 2,064
constexpr int kPackChunk = kChunk;                    // bytes per T4 thread
constexpr int kRelayoutThreads = 128;                 // NT of the T2 and T3 kernels

// Tiles covering an interior dim extended by `pad` on both sides
// (truncating, cpu.h:141-142, 450-451).
GVCT_HD int covered_tiles(int interior, int pad) { return (interior + 2 * pad) / kTile; }

// A batch of (h, w) interior planes and its tile-planes grid.  Batch index
// b = outer * n_inner + inner (n_inner = 2 puts U and V in one launch).
// Plane byte of interior pixel (i, j):
//   outer * p_outer + inner * p_inner + i * p_row + j
// Tile byte of T[r, c, by, bx]:
//   outer * t_outer + inner * t_inner + r * t_r + c * t_c + by * t_by + bx
// Flat tail byte m (flat view only; rem_n bytes a plane):
//   outer * r_outer + inner * r_inner + m
// Offsets inside one plane or one tile-planes block are 32-bit (make_geom
// checks that they fit); the batch offsets are 64-bit, taken once a block.
struct RelayoutGeom {
  int h, w, pad, by_grid, bx_grid, n_inner;
  long long p_outer, p_inner;
  int p_row;
  long long t_outer, t_inner;
  int t_r, t_c, t_by;
  int flat;           // the flat view (Q9) instead of the padded plane's rows
  int sheared;        // flat with pw % 8 != 0: the byte-wise plane side
  int pw, vh, vw;     // padded width; the tiled view's rows and columns
  int rem_n;          // flat tail bytes per plane (flat view only, else 0)
  long long r_outer, r_inner;
};

// The geometries the plain versions (ops/relayout_kernel.py) accept.  Rows
// view: an 8-aligned extended width, a grid at least as large as the
// covered tiles, and every interior row inside them.  Flat view: any
// interior, a grid at least as large as the view's tiles.
GVCT_HD bool geometry_ok(const RelayoutGeom& g) {
  if (g.h <= 0 || g.w <= 0 || g.pad < 0 || g.n_inner <= 0) return false;
  if (g.flat) {
    return g.vh > 0 && g.vw > 0 && g.by_grid >= g.vh / kTile && g.bx_grid >= g.vw / kTile;
  }
  return (g.w + 2 * g.pad) % kTile == 0 &&
         g.by_grid >= covered_tiles(g.h, g.pad) && g.bx_grid >= covered_tiles(g.w, g.pad) &&
         g.pad + g.h <= kTile * covered_tiles(g.h, g.pad);
}

// Build the launch geometry from the C entry points' arguments.  False for
// a geometry the plain versions reject, a negative stride, or a plane or
// tile-planes block whose offsets (plus a chunk of slack) overflow 32 bits.
GVCT_HD bool make_geom(RelayoutGeom* g, int h, int w, int pad, int by_grid, int bx_grid,
                       int n_inner, long long p_outer, long long p_inner, long long p_row,
                       long long t_outer, long long t_inner, long long t_r, long long t_c,
                       long long t_by, int flat = 0, long long r_outer = 0,
                       long long r_inner = 0) {
  if (h <= 0 || w <= 0 || pad < 0 || by_grid <= 0 || bx_grid <= 0 || p_row < 0 || t_r < 0 ||
      t_c < 0 || t_by < 0 || p_outer < 0 || p_inner < 0 || t_outer < 0 || t_inner < 0 ||
      r_outer < 0 || r_inner < 0 || (flat != 0 && flat != 1)) {
    return false;
  }
  const long long slack = static_cast<long long>(kTile) * bx_grid + 2 * kChunk;
  const long long plane_end = (h + pad) * p_row + slack;
  const long long tile_end = (kTile - 1) * (t_r + t_c) + (by_grid - 1) * t_by + slack;
  const long long padded = static_cast<long long>(h + 2 * pad) * (w + 2 * pad);
  if (plane_end > INT_MAX || tile_end > INT_MAX || padded + slack > INT_MAX) return false;
  const int pw = w + 2 * pad;
  const int vh = kTile * covered_tiles(h, pad), vw = kTile * covered_tiles(w, pad);
  *g = RelayoutGeom{h, w, pad, by_grid, bx_grid, n_inner, p_outer, p_inner,
                    static_cast<int>(p_row), t_outer, t_inner, static_cast<int>(t_r),
                    static_cast<int>(t_c), static_cast<int>(t_by), flat,
                    flat && pw % kTile != 0, pw, vh, vw,
                    flat ? static_cast<int>(padded - static_cast<long long>(vh) * vw) : 0,
                    r_outer, r_inner};
  return geometry_ok(*g);
}

// Blocks of grid row 8 * by_grid and up that the flat tail takes (one per
// kSpanCols bytes), when the launch copies it.
GVCT_HD int tail_blocks(const RelayoutGeom& g) { return (g.rem_n + kSpanCols - 1) / kSpanCols; }

GVCT_HD long long rem_base(const RelayoutGeom& g, long long b) {
  return (b / g.n_inner) * g.r_outer + (b % g.n_inner) * g.r_inner;
}

GVCT_HD long long plane_base(const RelayoutGeom& g, long long b) {
  return (b / g.n_inner) * g.p_outer + (b % g.n_inner) * g.p_inner;
}

GVCT_HD long long tiles_base(const RelayoutGeom& g, long long b) {
  return (b / g.n_inner) * g.t_outer + (b % g.n_inner) * g.t_inner;
}

GVCT_HD int min_i(int a, int b) { return a < b ? a : b; }
GVCT_HD int max_i(int a, int b) { return a > b ? a : b; }

// The byte offset of address `base + off` in its 16-byte chunk.
GVCT_HD int residue(const uint8_t* base, int off) {
  return static_cast<int>((reinterpret_cast<uintptr_t>(base) + static_cast<uintptr_t>(
                              static_cast<intptr_t>(off))) & (kChunk - 1));
}

// -- 16-byte chunks in registers -------------------------------------------------

// Byte e of a chunk is byte e & 3 of word e >> 2 (both sides little-endian).
struct Chunk {
  uint32_t w[4];
};

GVCT_HD Chunk load16(const uint8_t* p) {  // p is 16-byte aligned
#ifdef __CUDA_ARCH__
  const uint4 v = *reinterpret_cast<const uint4*>(p);
  return Chunk{{v.x, v.y, v.z, v.w}};
#else
  Chunk c;
  std::memcpy(c.w, p, kChunk);
  return c;
#endif
}

GVCT_HD void store16(uint8_t* p, const Chunk& c) {  // p is 16-byte aligned
#ifdef __CUDA_ARCH__
  *reinterpret_cast<uint4*>(p) = make_uint4(c.w[0], c.w[1], c.w[2], c.w[3]);
#else
  std::memcpy(p, c.w, kChunk);
#endif
}

// Word i of a chunk for a run-time i, without indexing the array (which
// would put it in local memory on the device).
GVCT_HD uint32_t word_at(const Chunk& c, int i) {
  return i == 0 ? c.w[0] : i == 1 ? c.w[1] : i == 2 ? c.w[2] : c.w[3];
}

// The chunk with every byte outside [lo, hi) set to 0.
GVCT_HD Chunk keep_bytes(const Chunk& c, int lo, int hi) {
  Chunk out;
  GVCT_UNROLL
  for (int i = 0; i < 4; ++i) {
    const int l = min_i(max_i(lo - 4 * i, 0), 4);
    const int h = min_i(max_i(hi - 4 * i, 0), 4);
    const unsigned long long keep = ((1ull << (8 * h)) - 1) & ~((1ull << (8 * l)) - 1);
    out.w[i] = c.w[i] & static_cast<uint32_t>(keep);
  }
  return out;
}

// Store one naturally aligned piece of 8, 4, 2 or 1 bytes: bytes [at, at +
// n) of chunk c at p + at.
GVCT_HD void store_piece(uint8_t* p, const Chunk& c, int at, int n) {
  const uint32_t word = word_at(c, at >> 2);
#ifdef __CUDA_ARCH__
  if (n == 8) {
    *reinterpret_cast<uint2*>(p + at) = make_uint2(word, word_at(c, (at >> 2) + 1));
  } else if (n == 4) {
    *reinterpret_cast<uint32_t*>(p + at) = word;
  } else if (n == 2) {
    *reinterpret_cast<uint16_t*>(p + at) = static_cast<uint16_t>(word >> (8 * (at & 3)));
  } else {
    p[at] = static_cast<uint8_t>(word >> (8 * (at & 3)));
  }
#else
  const uint32_t bytes[2] = {word >> (8 * (at & 3)), n == 8 ? word_at(c, (at >> 2) + 1) : 0};
  std::memcpy(p + at, bytes, n);  // little-endian: the piece's bytes in order
#endif
}

// Store bytes [lo, hi) of chunk c at the 16-byte aligned address p,
// touching no other byte: a whole chunk as one 16-byte store, a head chunk
// (hi = 16) in naturally aligned pieces of 1, 2, 4, 8 upwards from lo, a
// tail chunk (lo = 0) in pieces of 8, 4, 2, 1 up to hi, a run inside one
// chunk byte by byte.
GVCT_HD void store_bytes(uint8_t* p, const Chunk& c, int lo, int hi) {
  if (lo == 0 && hi == kChunk) {
    store16(p, c);
  } else if (hi == kChunk) {
    GVCT_UNROLL
    for (int n = 1; n < kChunk; n *= 2) {
      if (lo & n) {
        store_piece(p, c, lo, n);
        lo += n;
      }
    }
  } else if (lo == 0) {
    GVCT_UNROLL
    for (int n = kChunk / 2; n >= 1; n /= 2) {
      if (hi & n) {
        store_piece(p, c, lo, n);
        lo += n;
      }
    }
  } else {
    for (; lo < hi; ++lo) store_piece(p, c, lo, 1);
  }
}

// -- one block's runs ------------------------------------------------------------
//
// A block handles one extended row R = 8by + r of one plane and the span
// of tiles [bx0, bx0 + 256): on the plane side one run (the row's
// interior bytes), on the tile side the 8 runs T[r, c, by, bx0 ..], one
// per column c of the tile.  Its shared stage holds the span's 2,048
// extended columns 8bx0 + k at stage byte shift + k, where `shift` is the
// address residue of the row's plane-side column 0, so every aligned plane
// chunk is an aligned stage chunk.  Tile (r, c) of span tile t is stage
// column k = 8t + c.  (The 4 chunks of one run that a warp gathers or
// scatters lie 128 bytes apart, in one bank: padding the stage to spread
// them cost more address arithmetic per byte than the conflicts cost.)

// The plane side of the block's row: the in-plane offset of its column 0
// (may be negative: the columns left of the interior are padding), the
// stage columns [lo, hi) that are interior pixels (empty on a padding row),
// and the address residue of column 0.
struct PlaneRow {
  int off, lo, hi, shift;
};

GVCT_HD PlaneRow plane_row(const RelayoutGeom& g, const uint8_t* plane, int row, int bx0) {
  const int i = row - g.pad;          // interior row
  const int c0 = bx0 * kTile - g.pad;  // interior column of stage column 0
  const bool inside = i >= 0 && i < g.h;
  PlaneRow pr;
  pr.off = (inside ? i * g.p_row : 0) + c0;
  pr.lo = inside ? max_i(0, -c0) : 0;
  pr.hi = inside ? min_i(kSpanCols, g.w - c0) : 0;
  pr.shift = residue(plane, pr.off);
  return pr;
}

// Whether a flat-view block's plane side goes byte by byte (the sheared
// view, and the view's grid-padding rows past vh when its width is
// 8-aligned); its stage then starts at byte 0 (shift 0).  Every other
// block takes the row path, its stage shifted by the plane row's residue.
GVCT_HD bool flat_path(const RelayoutGeom& g, int row) { return g.sheared || row >= g.vh; }

// The sheared plane side: padded byte f of the flat run (f < (h + 2 pad) *
// pw) as the in-plane offset of its interior pixel, or -1 for padding.
// Walk a run with flat_next instead of dividing again per byte.
struct FlatPos {
  int pr, pc;  // padded row and column
};

GVCT_HD FlatPos flat_pos(const RelayoutGeom& g, int f) { return FlatPos{f / g.pw, f % g.pw}; }

GVCT_HD int flat_offset(const RelayoutGeom& g, const FlatPos& p) {
  const int i = p.pr - g.pad, j = p.pc - g.pad;
  return (i >= 0 && i < g.h && j >= 0 && j < g.w) ? i * g.p_row + j : -1;
}

GVCT_HD void flat_next(const RelayoutGeom& g, FlatPos* p) {
  if (++p->pc == g.pw) {
    p->pc = 0;
    ++p->pr;
  }
}

// The tile side: tile-plane (r, c) of extended row `row` = 8by + r, tiles
// [bx0, bx0 + n).
struct TileRun {
  int off, n, shift;
};

GVCT_HD TileRun tile_run(const RelayoutGeom& g, const uint8_t* tiles, int row, int c, int bx0) {
  TileRun tr;
  tr.off = (row % kTile) * g.t_r + c * g.t_c + (row / kTile) * g.t_by + bx0;
  tr.n = min_i(kSpanTiles, g.bx_grid - bx0);
  tr.shift = residue(tiles, tr.off);
  return tr;
}

// Plane-side item q (q < kRowItems): the row's aligned chunk q.  Sets the
// chunk's first stage column k0 and its interior bytes [lo, hi).
GVCT_HD void plane_item(const PlaneRow& pr, int q, int* k0, int* lo, int* hi) {
  *k0 = q * kChunk - pr.shift;
  *lo = max_i(pr.lo - *k0, 0);
  *hi = min_i(pr.hi - *k0, kChunk);
}

// Tile-side item k (k < kRunItems): aligned chunk q = k / 8 of run c = k % 8
// (c fastest: a warp covers 64 bytes of each of the 8 runs).  Sets the
// chunk's first span tile t0 and the run's bytes [lo, hi) of the chunk.
GVCT_HD void tile_item(const TileRun& tr, int q, int* t0, int* lo, int* hi) {
  *t0 = q * kChunk - tr.shift;
  *lo = max_i(-*t0, 0);
  *hi = min_i(tr.n - *t0, kChunk);
}

// T2, phase 1: fill the stage from the plane row, every load issued before
// the first stage store.  Padding (Q6), rows past the interior and grid
// padding columns are staged as 0.
template <int NT>
GVCT_HD void fwd_stage(const uint8_t* plane, uint8_t* stage, const RelayoutGeom& g, int row,
                       int bx0, int tid) {
  constexpr int kIters = (kRowItems + NT - 1) / NT;
  const PlaneRow pr = plane_row(g, plane, row, bx0);
  Chunk v[kIters];
  GVCT_UNROLL
  for (int it = 0; it < kIters; ++it) {
    const int q = it * NT + tid;
    int k0, lo, hi;
    plane_item(pr, q, &k0, &lo, &hi);
    v[it] = Chunk{{0, 0, 0, 0}};
    if (q < kRowItems && lo < hi) v[it] = keep_bytes(load16(plane + (pr.off + k0)), lo, hi);
  }
  GVCT_UNROLL
  for (int it = 0; it < kIters; ++it) {
    const int q = it * NT + tid;
    if (q < kRowItems) store16(stage + q * kChunk, v[it]);
  }
}

// T2, phase 2: write the row's 8 tile-plane runs, each 16-byte chunk
// gathered from the stage (its column 0 at byte `shift`) at a stride of 8
// columns.
template <int NT>
GVCT_HD void fwd_store_at(const uint8_t* stage, int shift, uint8_t* tiles,
                          const RelayoutGeom& g, int row, int bx0, int tid) {
  constexpr int kIters = (kRunItems + NT - 1) / NT;
  GVCT_UNROLL
  for (int it = 0; it < kIters; ++it) {
    const int k = it * NT + tid;
    if (k >= kRunItems) continue;
    const int c = k % kTile;
    const TileRun tr = tile_run(g, tiles, row, c, bx0);
    int t0, lo, hi;
    tile_item(tr, k / kTile, &t0, &lo, &hi);
    if (lo >= hi) continue;
    const int p0 = shift + c + 8 * t0;  // stage position of byte 0
    Chunk v{{0, 0, 0, 0}};
    GVCT_UNROLL
    for (int e = 0; e < kChunk; ++e) {
      if (e >= lo && e < hi) {
        v.w[e >> 2] |= static_cast<uint32_t>(stage[p0 + 8 * e]) << (8 * (e & 3));
      }
    }
    store_bytes(tiles + (tr.off + t0), v, lo, hi);
  }
}

// T2, phase 2 on the row path: the stage shifted by the plane row's residue.
template <int NT>
GVCT_HD void fwd_store(const uint8_t* stage, const uint8_t* plane, uint8_t* tiles,
                       const RelayoutGeom& g, int row, int bx0, int tid) {
  fwd_store_at<NT>(stage, plane_row(g, plane, row, bx0).shift, tiles, g, row, bx0, tid);
}

// T3, phase 1: fill the stage (its column 0 at byte `shift`) from the 8
// tile-plane runs, every load issued before the first stage store; a
// chunk's bytes land 8 columns apart.
template <int NT>
GVCT_HD void inv_stage_at(const uint8_t* tiles, int shift, uint8_t* stage,
                          const RelayoutGeom& g, int row, int bx0, int tid) {
  constexpr int kIters = (kRunItems + NT - 1) / NT;
  Chunk v[kIters];
  GVCT_UNROLL
  for (int it = 0; it < kIters; ++it) {
    const int k = it * NT + tid;
    if (k < kRunItems) {
      const TileRun tr = tile_run(g, tiles, row, k % kTile, bx0);
      int t0, lo, hi;
      tile_item(tr, k / kTile, &t0, &lo, &hi);
      if (lo < hi) v[it] = load16(tiles + (tr.off + t0));
    }
  }
  GVCT_UNROLL
  for (int it = 0; it < kIters; ++it) {
    const int k = it * NT + tid;
    if (k >= kRunItems) continue;
    const int c = k % kTile;
    const TileRun tr = tile_run(g, tiles, row, c, bx0);
    int t0, lo, hi;
    tile_item(tr, k / kTile, &t0, &lo, &hi);
    if (lo >= hi) continue;
    const int p0 = shift + c + 8 * t0;
    GVCT_UNROLL
    for (int e = 0; e < kChunk; ++e) {
      if (e >= lo && e < hi) {
        stage[p0 + 8 * e] = static_cast<uint8_t>(v[it].w[e >> 2] >> (8 * (e & 3)));
      }
    }
  }
}

// T3, phase 1 on the row path: the stage shifted by the plane row's residue.
template <int NT>
GVCT_HD void inv_stage(const uint8_t* tiles, const uint8_t* plane, uint8_t* stage,
                       const RelayoutGeom& g, int row, int bx0, int tid) {
  inv_stage_at<NT>(tiles, plane_row(g, plane, row, bx0).shift, stage, g, row, bx0, tid);
}

// T3, phase 2: write the row's interior pixels, one aligned stage chunk to
// one aligned plane chunk.
template <int NT>
GVCT_HD void inv_store(const uint8_t* stage, uint8_t* plane, const RelayoutGeom& g, int row,
                       int bx0, int tid) {
  constexpr int kIters = (kRowItems + NT - 1) / NT;
  const PlaneRow pr = plane_row(g, plane, row, bx0);
  GVCT_UNROLL
  for (int it = 0; it < kIters; ++it) {
    const int q = it * NT + tid;
    int k0, lo, hi;
    plane_item(pr, q, &k0, &lo, &hi);
    if (q < kRowItems && lo < hi) {
      store_bytes(plane + (pr.off + k0), load16(stage + q * kChunk), lo, hi);
    }
  }
}

// -- the flat path and the flat tail -----------------------------------------------
//
// On the flat path (flat_path) a block's stage holds the view's row `row`, virtual
// columns 8bx0 + k at stage byte k (shift 0): stage chunk q (q < 128) is
// the 16 view bytes from f = row * vw + 8bx0 + 16q on, gathered from the
// plane byte by byte (at most 16 consecutive padded bytes: a chunk crosses
// a padded row end at most twice), or scattered back to it.

constexpr int kSpanChunks = kSpanCols / kChunk;  // 128 stage chunks of a span

// T2, phase 1 on the flat path: view bytes outside the interior, past the
// view's columns or rows (grid padding) are staged as 0.
template <int NT>
GVCT_HD void fwd_stage_flat(const uint8_t* plane, uint8_t* stage, const RelayoutGeom& g,
                            int row, int bx0, int tid) {
  constexpr int kIters = (kSpanChunks + NT - 1) / NT;
  GVCT_UNROLL
  for (int it = 0; it < kIters; ++it) {
    const int q = it * NT + tid;
    if (q >= kSpanChunks) continue;
    const int vc = bx0 * kTile + q * kChunk;
    Chunk v{{0, 0, 0, 0}};
    if (row < g.vh && vc < g.vw) {
      FlatPos p = flat_pos(g, row * g.vw + vc);
      GVCT_UNROLL
      for (int e = 0; e < kChunk; ++e) {
        const int off = flat_offset(g, p);
        if (vc + e < g.vw && off >= 0) {
          v.w[e >> 2] |= static_cast<uint32_t>(plane[off]) << (8 * (e & 3));
        }
        flat_next(g, &p);
      }
    }
    store16(stage + q * kChunk, v);
  }
}

// T3, phase 2 on the flat path: the view bytes that are interior pixels go
// back to the plane; no other plane byte is written.
template <int NT>
GVCT_HD void inv_store_flat(const uint8_t* stage, uint8_t* plane, const RelayoutGeom& g,
                            int row, int bx0, int tid) {
  constexpr int kIters = (kSpanChunks + NT - 1) / NT;
  GVCT_UNROLL
  for (int it = 0; it < kIters; ++it) {
    const int q = it * NT + tid;
    const int vc = bx0 * kTile + q * kChunk;
    if (q >= kSpanChunks || row >= g.vh || vc >= g.vw) continue;
    const Chunk v = load16(stage + q * kChunk);
    FlatPos p = flat_pos(g, row * g.vw + vc);
    GVCT_UNROLL
    for (int e = 0; e < kChunk; ++e) {
      const int off = flat_offset(g, p);
      if (vc + e < g.vw && off >= 0) {
        plane[off] = static_cast<uint8_t>(word_at(v, e >> 2) >> (8 * (e & 3)));
      }
      flat_next(g, &p);
    }
  }
}

// The flat tail, bytes [part * kSpanCols, (part + 1) * kSpanCols) of
// rem_n: T2 copies them out to rem (0 for padding), T3 writes the interior
// ones back from rem.  Each thread takes 16 consecutive bytes an item:
// bytes [m0, m0 + n) of the tail, from padded byte `view + m0` on.
GVCT_HD int tail_item(const RelayoutGeom& g, int part, int q, int* m0) {
  *m0 = part * kSpanCols + q * kChunk;
  return q < kSpanChunks ? min_i(kChunk, g.rem_n - *m0) : 0;
}

template <int NT>
GVCT_HD void fwd_tail(const uint8_t* plane, uint8_t* rem, const RelayoutGeom& g, int part,
                      int tid) {
  constexpr int kIters = (kSpanChunks + NT - 1) / NT;
  GVCT_UNROLL
  for (int it = 0; it < kIters; ++it) {
    int m0;
    const int n = tail_item(g, part, it * NT + tid, &m0);
    if (n <= 0) continue;
    FlatPos p = flat_pos(g, g.vh * g.vw + m0);
    for (int e = 0; e < n; ++e) {
      const int off = flat_offset(g, p);
      rem[m0 + e] = off >= 0 ? plane[off] : 0;
      flat_next(g, &p);
    }
  }
}

template <int NT>
GVCT_HD void inv_tail(const uint8_t* rem, uint8_t* plane, const RelayoutGeom& g, int part,
                      int tid) {
  constexpr int kIters = (kSpanChunks + NT - 1) / NT;
  GVCT_UNROLL
  for (int it = 0; it < kIters; ++it) {
    int m0;
    const int n = tail_item(g, part, it * NT + tid, &m0);
    if (n <= 0) continue;
    FlatPos p = flat_pos(g, g.vh * g.vw + m0);
    for (int e = 0; e < n; ++e) {
      const int off = flat_offset(g, p);
      if (off >= 0) plane[off] = rem[m0 + e];
      flat_next(g, &p);
    }
  }
}

// T4: the packed frame is Y (yn bytes), then U, then V (cn bytes each).
// Returns the plane (0, 1, 2) that holds packed byte `off` and sets `at` to
// its offset there.
GVCT_HD int pack_source(long long off, long long yn, long long cn, long long* at) {
  if (off < yn) {
    *at = off;
    return 0;
  }
  off -= yn;
  if (off < cn) {
    *at = off;
    return 1;
  }
  *at = off - cn;
  return 2;
}

// T4: chunk k (16 bytes) of packed frame b.  Plane sizes are multiples of
// 16, so no chunk straddles two planes; every address is 16-byte aligned
// (the wrapper checks).  Strides are per frame.
GVCT_HD void pack_chunk(const uint8_t* y, const uint8_t* u, const uint8_t* v, uint8_t* out,
                        long long yn, long long cn, long long y_stride, long long u_stride,
                        long long v_stride, long long out_stride, long long b, long long k) {
  long long at = 0;
  const long long off = k * kPackChunk;
  const int p = pack_source(off, yn, cn, &at);
  const uint8_t* src = p == 0 ? y + b * y_stride : (p == 1 ? u + b * u_stride : v + b * v_stride);
  store16(out + b * out_stride + off, load16(src + at));
}

}  // namespace gvct
