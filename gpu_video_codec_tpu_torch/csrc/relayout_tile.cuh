// Index math of the relayout kernels (T2 plane -> tile-planes, T3 tile-planes
// -> plane) and the YV12 pack kernel (T4), shared by the CUDA kernels
// (relayout_kernel.cu, built by nvcc) and the host build that the CPU tests
// load (host_shim.cpp, built by g++).  The per-block work is written once,
// here, as the loop a thread `tid` of `nthreads` runs; the kernel calls it
// with threadIdx.x and blockDim.x, the host build with 0 and 1.
//
// Tile-planes: T[r, c, by, bx] is extended pixel (8by + r, 8bx + c) of the
// plane zero-extended by `pad` on every side (Q6: padding is 0), over a grid
// of (by_grid, bx_grid) tiles.  Tiles past the extended plane are grid
// padding (zero pixels).  Tile rows count by truncating division (Q9: at
// 1080p chroma, (540 + 8) / 8 = 68 tile rows cover 544 of the 548 extended
// rows; the 4 dropped rows are padding the reference never sweeps).
#pragma once

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

namespace gvct {

constexpr int kTile = 8;                         // SAMPLE_BLOCK_SIZE
constexpr int kSpanTiles = 64;                   // tiles of one block along Bx
constexpr int kSpanCols = kTile * kSpanTiles;    // 512 extended columns
constexpr int kStageBytes = kTile * kSpanCols;   // 8 extended rows x 512 columns
constexpr int kPackChunk = 16;                   // bytes per T4 thread

// Tiles covering an interior dim extended by `pad` on both sides
// (truncating, cpu.h:141-142, 450-451).
GVCT_HD int covered_tiles(int interior, int pad) { return (interior + 2 * pad) / kTile; }

// A batch of (h, w) interior planes and its tile-planes grid.  Batch index
// b = outer * n_inner + inner (n_inner = 2 puts U and V in one launch).
// Plane byte of interior pixel (i, j):
//   outer * p_outer + inner * p_inner + i * p_row + j
// Tile byte of T[r, c, by, bx]:
//   outer * t_outer + inner * t_inner + r * t_r + c * t_c + by * t_by + bx
struct RelayoutGeom {
  int h, w, pad, by_grid, bx_grid, n_inner;
  long long p_outer, p_inner, p_row;
  long long t_outer, t_inner, t_r, t_c, t_by;
};

// The geometries the plain versions (utils/tiles.py interior_to_tiles,
// tiles_to_interior) accept: an 8-aligned extended width, a grid at least
// as large as the covered tiles, and every interior row inside them.
GVCT_HD bool geometry_ok(const RelayoutGeom& g) {
  return g.h > 0 && g.w > 0 && g.pad >= 0 && g.n_inner > 0 &&
         (g.w + 2 * g.pad) % kTile == 0 &&
         g.by_grid >= covered_tiles(g.h, g.pad) && g.bx_grid >= covered_tiles(g.w, g.pad) &&
         g.pad + g.h <= kTile * covered_tiles(g.h, g.pad);
}

GVCT_HD long long plane_base(const RelayoutGeom& g, long long b) {
  return (b / g.n_inner) * g.p_outer + (b % g.n_inner) * g.p_inner;
}

GVCT_HD long long tiles_base(const RelayoutGeom& g, long long b) {
  return (b / g.n_inner) * g.t_outer + (b % g.n_inner) * g.t_inner;
}

// Plane byte (from the batch base) of extended pixel (R, C), or -1 where it
// is Q6 zero padding or lies in a grid padding tile (both are outside the
// interior once geometry_ok holds).
GVCT_HD long long interior_offset(const RelayoutGeom& g, int R, int C) {
  const int i = R - g.pad;
  const int j = C - g.pad;
  if (i < 0 || i >= g.h || j < 0 || j >= g.w) return -1;
  return i * g.p_row + j;
}

// Tile byte (from the batch base) of T[rc / 8, rc % 8, by, bx].
GVCT_HD long long tile_offset(const RelayoutGeom& g, int rc, int by, int bx) {
  return (rc / kTile) * g.t_r + (rc % kTile) * g.t_c + by * g.t_by + bx;
}

// A block stages the 8 extended rows of tile row `by` and the 512 columns of
// its 64 tiles from bx0, row-major: T[r, c] of its tile t is staged byte
// r * 512 + 8t + c.
GVCT_HD int stage_index(int rc, int t) {
  return (rc / kTile) * kSpanCols + t * kTile + rc % kTile;
}

// T2, phase 1: stage the block's extended rows (plane reads run along rows).
GVCT_HD void fwd_stage(const uint8_t* plane, uint8_t* stage, const RelayoutGeom& g,
                       int by, int bx0, int tid, int nthreads) {
  for (int k = tid; k < kStageBytes; k += nthreads) {
    const long long off = interior_offset(g, by * kTile + k / kSpanCols,
                                          bx0 * kTile + k % kSpanCols);
    stage[k] = off < 0 ? 0 : plane[off];
  }
}

// T2, phase 2: write the 64 tile planes' runs of up to 64 bytes along Bx.
GVCT_HD void fwd_store(const uint8_t* stage, uint8_t* tiles, const RelayoutGeom& g,
                       int by, int bx0, int tid, int nthreads) {
  for (int k = tid; k < kStageBytes; k += nthreads) {
    const int rc = k / kSpanTiles;
    const int t = k % kSpanTiles;
    if (bx0 + t < g.bx_grid) tiles[tile_offset(g, rc, by, bx0 + t)] = stage[stage_index(rc, t)];
  }
}

// T3, phase 1: stage the block's tiles (reads run along Bx).
GVCT_HD void inv_stage(const uint8_t* tiles, uint8_t* stage, const RelayoutGeom& g,
                       int by, int bx0, int tid, int nthreads) {
  for (int k = tid; k < kStageBytes; k += nthreads) {
    const int rc = k / kSpanTiles;
    const int t = k % kSpanTiles;
    stage[stage_index(rc, t)] = bx0 + t < g.bx_grid ? tiles[tile_offset(g, rc, by, bx0 + t)] : 0;
  }
}

// T3, phase 2: write the interior pixels of the staged rows (along rows).
GVCT_HD void inv_store(const uint8_t* stage, uint8_t* plane, const RelayoutGeom& g,
                       int by, int bx0, int tid, int nthreads) {
  for (int k = tid; k < kStageBytes; k += nthreads) {
    const long long off = interior_offset(g, by * kTile + k / kSpanCols,
                                          bx0 * kTile + k % kSpanCols);
    if (off >= 0) plane[off] = stage[k];
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

// Copy 16 bytes; both addresses are 16-byte aligned (the wrapper checks).
GVCT_HD void copy16(uint8_t* dst, const uint8_t* src) {
#ifdef __CUDA_ARCH__
  *reinterpret_cast<uint4*>(dst) = *reinterpret_cast<const uint4*>(src);
#else
  std::memcpy(dst, src, kPackChunk);
#endif
}

// T4: chunk k (16 bytes) of packed frame b.  Plane sizes are multiples of
// 16, so no chunk straddles two planes.  Strides are per frame.
GVCT_HD void pack_chunk(const uint8_t* y, const uint8_t* u, const uint8_t* v, uint8_t* out,
                        long long yn, long long cn, long long y_stride, long long u_stride,
                        long long v_stride, long long out_stride, long long b, long long k) {
  long long at = 0;
  const long long off = k * kPackChunk;
  const int p = pack_source(off, yn, cn, &at);
  const uint8_t* src = p == 0 ? y + b * y_stride : (p == 1 ? u + b * u_stride : v + b * v_stride);
  copy16(out + b * out_stride + off, src + at);
}

}  // namespace gvct
