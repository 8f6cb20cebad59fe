// Relayout and pack kernels of the streaming and device-resident paths on
// Hopper (sm_90a):
//
// T2 plane_to_tiles_kernel: (.., h, w) interior planes -> tile-planes of the
//    zero-extended plane.  Replaces tools/kernel_relayout_exp.py::fwd_inkernel
//    (fwd_kernel), which did the relayout on the TPU's matrix unit as s8
//    one-hot dots; here it is a gather through shared memory.
// T3 tiles_to_plane_kernel: the inverse, tile-planes -> interior planes.
//    Replaces kernel_relayout_exp.py::inv_inkernel (inv_kernel).
// T4 pack_yv12_kernel: Y, U and V planes -> one packed YV12 buffer.  Replaces
//    tools/pack_exp.py::pack_pallas (_pack_kernel), three HBM->HBM DMAs on the
//    TPU; TMA has no global->global copy, so this is a copy kernel.
//
// T2 and T3: one block of 128 threads per (plane of the batch, extended
// row R = 8by + r, span of 256 tiles along Bx): 1,088 blocks at 1080p
// luma and at 1080p U+V, about eight per SM, all resident at once.  The
// block stages its row's 2,048 extended columns in shared memory (2 KB) and
// moves every global byte in 16-byte accesses aligned by the actual
// address: the plane row on one side, the 8 runs T[r, c, by, bx0 ..] of up
// to 256 bytes (one per tile column c) on the other.  Each run is cut into
// the aligned chunks that cover it (relayout_tile.cuh): whole chunks are
// one uint4 access, a head or tail chunk is loaded whole and masked, and
// stored in aligned 8/4/2/1-byte pieces.  The stage is shifted by the
// address residue of the plane row, so plane chunks are aligned stage
// chunks (uint4 shared accesses); the transpose is the tile side's gather
// (T2) or scatter (T3) of a chunk's 16 bytes 8 stage bytes apart.  The
// thread count is a compile-time constant: a thread's loops unroll and it
// issues all of its global loads (1-2 chunks) before the first use, so the
// whole plane is in flight at once (about 16 KB per SM at 1080p luma).
// Index math inside a plane is 32-bit; the batch offset is 64-bit, once
// per block.
// The flat view (Q9 sheared chroma, w % 16 == 8): the same blocks, the
// plane side byte by byte through relayout_tile.cuh's index map instead of
// the aligned row chunks, and the flat tail in extra blocks of the same
// launch (grid rows 8 * By and up), so that a sheared frame runs T2 and T3
// and no PyTorch copy.  It is not on any common frame size's path.
// T4: one thread per 16 bytes of the output, with 16-byte loads and stores
// (plane offsets are multiples of 16 when w and h are multiples of 8).
//
// What bounds them: bytes.  Each moves its input once and its output once,
// with no arithmetic to speak of: at 1080p T2 luma reads 2.07 MB and writes
// 2.10 MB (1.25 us at 3.35 TB/s; chip_smoke.py computes the bounds), T4
// reads and writes 3.11 MB each (1.86 us).  So T2 and T3 move 16 bytes per
// access with the loads batched ahead of their uses.  The floor at these
// sizes is one launch: a plain 16-byte copy of the same bytes (T4 on the
// plane alone, timed by chip_smoke.py phase 4b) takes about twice the byte
// bound.  The design keeps one launch per plane group (luma; U and V
// together; the pack).

#include <cuda_runtime.h>

#include "relayout_tile.cuh"

namespace {

constexpr int kThreads = gvct::kRelayoutThreads;
constexpr int kPackThreads = 256;
constexpr int kMaxGridYZ = 65535;

// FLAT = false: the rows view, the code of every 8-aligned plane.  FLAT =
// true: the flat view (Q9), a separate instantiation, so that the rows
// view's code is not touched by it: its blocks take the row path where the
// view is 8-aligned rows, the flat path otherwise, and the flat tail in the
// grid rows past 8 * by_grid.
template <bool FLAT>
__global__ void __launch_bounds__(kThreads)
plane_to_tiles_kernel(const uint8_t* __restrict__ plane, uint8_t* __restrict__ tiles,
                      uint8_t* __restrict__ rem, gvct::RelayoutGeom g) {
  __shared__ __align__(16) uint8_t stage[gvct::kStageBytes];
  const long long b = blockIdx.z;
  const int row = blockIdx.y;
  const int bx0 = blockIdx.x * gvct::kSpanTiles;
  const uint8_t* src = plane + gvct::plane_base(g, b);
  uint8_t* dst = tiles + gvct::tiles_base(g, b);
  if (FLAT) {
    if (row >= gvct::kTile * g.by_grid) {  // a flat-tail block: returns whole, before any barrier
      if (blockIdx.x == 0) {
        gvct::fwd_tail<kThreads>(src, rem + gvct::rem_base(g, b), g,
                                 row - gvct::kTile * g.by_grid, threadIdx.x);
      }
      return;
    }
    if (gvct::flat_path(g, row)) {
      gvct::fwd_stage_flat<kThreads>(src, stage, g, row, bx0, threadIdx.x);
      __syncthreads();
      gvct::fwd_store_at<kThreads>(stage, 0, dst, g, row, bx0, threadIdx.x);
      return;
    }
  }
  gvct::fwd_stage<kThreads>(src, stage, g, row, bx0, threadIdx.x);
  __syncthreads();
  gvct::fwd_store<kThreads>(stage, src, dst, g, row, bx0, threadIdx.x);
}

template <bool FLAT>
__global__ void __launch_bounds__(kThreads)
tiles_to_plane_kernel(const uint8_t* __restrict__ tiles, uint8_t* __restrict__ plane,
                      const uint8_t* __restrict__ rem, gvct::RelayoutGeom g) {
  __shared__ __align__(16) uint8_t stage[gvct::kStageBytes];
  const long long b = blockIdx.z;
  const int row = blockIdx.y;
  const int bx0 = blockIdx.x * gvct::kSpanTiles;
  const uint8_t* src = tiles + gvct::tiles_base(g, b);
  uint8_t* dst = plane + gvct::plane_base(g, b);
  if (FLAT) {
    if (row >= gvct::kTile * g.by_grid) {  // a flat-tail block
      if (blockIdx.x == 0) {
        gvct::inv_tail<kThreads>(rem + gvct::rem_base(g, b), dst, g,
                                 row - gvct::kTile * g.by_grid, threadIdx.x);
      }
      return;
    }
    if (gvct::flat_path(g, row)) {
      gvct::inv_stage_at<kThreads>(src, 0, stage, g, row, bx0, threadIdx.x);
      __syncthreads();
      gvct::inv_store_flat<kThreads>(stage, dst, g, row, bx0, threadIdx.x);
      return;
    }
  }
  gvct::inv_stage<kThreads>(src, dst, stage, g, row, bx0, threadIdx.x);
  __syncthreads();
  gvct::inv_store<kThreads>(stage, dst, g, row, bx0, threadIdx.x);
}

__global__ void __launch_bounds__(kPackThreads)
pack_yv12_kernel(const uint8_t* __restrict__ y, const uint8_t* __restrict__ u,
                 const uint8_t* __restrict__ v, uint8_t* __restrict__ out, long long yn,
                 long long cn, long long y_stride, long long u_stride, long long v_stride,
                 long long out_stride) {
  const long long k = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (k * gvct::kPackChunk >= yn + 2 * cn) return;
  gvct::pack_chunk(y, u, v, out, yn, cn, y_stride, u_stride, v_stride, out_stride,
                   blockIdx.y, k);
}

int launch_relayout(bool inverse, const void* src, void* dst, int h, int w, int pad,
                    int by_grid, int bx_grid, int n_outer, int n_inner, long long p_outer,
                    long long p_inner, long long p_row, long long t_outer, long long t_inner,
                    long long t_r, long long t_c, long long t_by, int flat, void* rem,
                    long long r_outer, long long r_inner, int device, void* stream) {
  gvct::RelayoutGeom g;
  const long long nb = static_cast<long long>(n_outer) * n_inner;
  if (!gvct::make_geom(&g, h, w, pad, by_grid, bx_grid, n_inner, p_outer, p_inner, p_row,
                       t_outer, t_inner, t_r, t_c, t_by, flat, r_outer, r_inner) ||
      n_outer < 0 || nb > kMaxGridYZ || (rem != nullptr && !flat)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const long long rows = static_cast<long long>(gvct::kTile) * by_grid +
                         (rem != nullptr ? gvct::tail_blocks(g) : 0);
  if (rows > kMaxGridYZ) return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (nb == 0) return 0;
  const dim3 grid((bx_grid + gvct::kSpanTiles - 1) / gvct::kSpanTiles,
                  static_cast<unsigned>(rows), static_cast<unsigned>(nb));
  auto s = static_cast<cudaStream_t>(stream);
  auto in = static_cast<const uint8_t*>(src);
  auto out = static_cast<uint8_t*>(dst);
  auto r = static_cast<uint8_t*>(rem);
  if (inverse) {
    (flat ? tiles_to_plane_kernel<true> : tiles_to_plane_kernel<false>)<<<grid, kThreads, 0, s>>>(
        in, out, r, g);
  } else {
    (flat ? plane_to_tiles_kernel<true> : plane_to_tiles_kernel<false>)<<<grid, kThreads, 0, s>>>(
        in, out, r, g);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// T2.  plane: n_outer x n_inner interior (h, w) planes, strides p_*;
// tiles: the (8, 8, by_grid, bx_grid) tile-planes of each, strides t_* (Bx
// contiguous); flat = 1 tiles the flat view of the padded plane (Q9,
// relayout_tile.cuh), and then rem, if not null, receives each plane's
// flat tail (rem_n bytes, batch strides r_*).  Launches on `stream`
// without synchronizing; returns cudaGetLastError() after the launch (0 =
// ok), cudaErrorInvalidValue for a geometry the plain version rejects, a
// negative stride, or offsets inside one plane or tile-planes block past
// 32 bits (relayout_tile.cuh make_geom).
extern "C" int gvct_plane_to_tiles(const void* plane, void* tiles, int h, int w, int pad,
                                   int by_grid, int bx_grid, int n_outer, int n_inner,
                                   long long p_outer, long long p_inner, long long p_row,
                                   long long t_outer, long long t_inner, long long t_r,
                                   long long t_c, long long t_by, int flat, void* rem,
                                   long long r_outer, long long r_inner, int device,
                                   void* stream) {
  return launch_relayout(false, plane, tiles, h, w, pad, by_grid, bx_grid, n_outer, n_inner,
                         p_outer, p_inner, p_row, t_outer, t_inner, t_r, t_c, t_by, flat, rem,
                         r_outer, r_inner, device, stream);
}

// T3: the same operands, tile-planes -> interior planes; with flat = 1 and
// rem not null, the interior pixels of the flat tail are written from rem.
extern "C" int gvct_tiles_to_plane(const void* tiles, void* plane, int h, int w, int pad,
                                   int by_grid, int bx_grid, int n_outer, int n_inner,
                                   long long p_outer, long long p_inner, long long p_row,
                                   long long t_outer, long long t_inner, long long t_r,
                                   long long t_c, long long t_by, int flat, const void* rem,
                                   long long r_outer, long long r_inner, int device,
                                   void* stream) {
  return launch_relayout(true, tiles, plane, h, w, pad, by_grid, bx_grid, n_outer, n_inner,
                         p_outer, p_inner, p_row, t_outer, t_inner, t_r, t_c, t_by, flat,
                         const_cast<void*>(rem), r_outer, r_inner, device, stream);
}

// T4.  nb frames: y (yn bytes), u and v (cn bytes) -> out (yn + 2cn bytes),
// each with its per-frame stride.  yn, cn, the strides and the pointers are
// multiples of 16.
extern "C" int gvct_pack_yv12(const void* y, const void* u, const void* v, void* out,
                              long long yn, long long cn, int nb, long long y_stride,
                              long long u_stride, long long v_stride, long long out_stride,
                              int device, void* stream) {
  if (yn < 0 || cn < 0 || yn % gvct::kPackChunk || cn % gvct::kPackChunk || nb < 0 ||
      nb > kMaxGridYZ) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const long long chunks = (yn + 2 * cn) / gvct::kPackChunk;
  if (nb == 0 || chunks == 0) return 0;
  const dim3 grid(static_cast<unsigned>((chunks + kPackThreads - 1) / kPackThreads), nb);
  pack_yv12_kernel<<<grid, kPackThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint8_t*>(y), static_cast<const uint8_t*>(u),
      static_cast<const uint8_t*>(v), static_cast<uint8_t*>(out), yn, cn, y_stride, u_stride,
      v_stride, out_stride);
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* gvct_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
