// HEVC deblock of a tile grid on Hopper (sm_90a): luma and chroma in int
// (K1, K1c) and in int16 (K1-i16, K1-i16c) as one quad kernel of four lanes
// per tile (deblock_quad_kernel<CHROMA, W, T>), and T5 with one thread per
// tile.
//
// K1 and K1c replace the TPU kernel
// gpu_video_codec_tpu/ops/pallas_kernel.py::_kernel (:71, launched by
// deblock_tiles_pallas at :197), which swept (8, 8, BLOCK_BY, BLOCK_BX)
// VMEM blocks with tiles along the vector lanes.  K1-i16 and K1-i16c
// replace the same kernel called with dtype=int16 (pallas_kernel.py:139,
// :198; driven by tools/int16_probe.py and deblock_frame_pallas(dtype=)).
//
// What bounds them: bytes.  Each tile is 64 B in, 4 BS bytes in and 64 B
// out: at 1080p the luma grid (8, 8, 136, 241) moves 4.33 MB, 1.29 us at
// 3.35 TB/s, and U+V (2, 8, 8, 68, 121) 2.14 MB, 0.64 us; the int16 kernels
// move the same bytes.  In practice one launch that only copies the same
// bytes in 16-byte chunks takes 2.55-2.59 us (luma) and 2.28-2.32 us (U+V)
// on an H100 SXM (chip_smoke.py phase 4b), so that copy floor, not half the
// bound, is what a deblock can approach.
//
// Design.  One thread per tile (the first design, of all four until the
// int16 pair moved here too) put 32,776 luma threads on 132 SMs: about 8
// warps per SM, 2 per scheduler, each thread one dependent chain of 64 byte
// loads, four phases and 64 byte stores, with nothing to hide its latency,
// from planes 32,776 B apart; and a warp ran the union of the filter
// branches of 32 tiles.  In int16 the chain was longer still (128
// registers, 2,712 static SASS instructions against the quad's 960).
// Here a block owns TB consecutive tiles of a frame's flattened (By, Bx)
// grid, with 4 * TB threads (deblock_quad.cuh):
//   1. the block stages its 64 planes x TB bytes in shared memory with a
//      coalesced cooperative load in 8-, 4- or 1-byte words (the widest
//      the runs' alignment allows: a plane's TB tiles are TB consecutive
//      bytes starting at a multiple of TB), every load issued before a
//      store; each quad loads its tile's 4 BS bytes (one byte, broadcast);
//   2. after __syncthreads, lane r of a tile reads tile rows r and 4 + r
//      and runs upper-vert and lower-vert as two independent chains; each
//      segment's decision needs its rows 0 and 3, so lanes 0 and 3 pack
//      their terms into a word and two xor-shuffles sum it over the quad;
//   3. it writes the rows back, __syncwarp, and reads column r and column
//      4 + r rows 0-3 -- the stage is the transpose -- for left-hor then
//      right-hor, whose Q side (quirk Q3) is the column left-hor just
//      filtered in the same lane;
//   4. after __syncthreads, a cooperative store in the load's words, exact
//      to the byte at the grid's end.
// 4x the threads (131,104 at 1080p luma; at most 64 registers by
// __launch_bounds__, so at least 32 warps per SM), a quarter of the chain
// per lane, and a warp's branches are the union over 8 tiles, not 32.
// The grid is one wave at 1080p.  Lanes of tiles past the grid run every
// exchange with BS 0 and store nothing: no thread leaves before a barrier
// or a shuffle.  in == out is safe: a block loads all its bytes before it
// stores any, and blocks own disjoint tiles.
// The compute type T is the last template parameter, passed to the row
// math of deblock_tile.cuh: T = int is K1/K1c, T = int16_t K1-i16/K1-i16c.
// On the TPU int16 doubled the vector lanes of a VPU-bound step; a CUDA
// thread has no 16-bit lanes to double (its registers are 32-bit), so
// int16 is int arithmetic plus the narrowing that int16 wrap-around needs
// (deblock_tile.cuh::nar): a sign extension after each chain, 1,072 static
// SASS instructions against int's 960 at 8-byte words, in no more
// registers (46 against 47; chip_smoke.py phase 0).  The stage traffic,
// the exchange (dp and dq fit its 10-bit fields in int16 as in int:
// deblock_quad.cuh::kMaxRowD) and the launch are K1's.
// What the design costs: every block loads, filters and stores in
// lock-step inside the single wave, so the three phases add up rather than
// overlap, and the quad issues more instructions per tile than one thread
// per tile (each decision in four lanes, the stage traffic, the exchange);
// staged one byte at a time, the load and store alone took longer than the
// old kernel's whole run.  That work is paid per tile whatever the content:
// with every BS byte 0 the kernel takes 85% of its time on filtered tiles,
// so on content where cond1 fails and at batch 4, where one thread per tile
// has latency enough hidden, it is no faster than one thread per tile
// (PERF.md).
//
// What Hopper offers that does not apply: wgmma (there is no product; an
// integer stencil); TMA (a tensor map needs global strides that are
// multiples of 16 bytes, and the tile-plane stride By*Bx is 32,776 B for
// luma, 8 mod 16, and 8,228 B for U+V, 4 mod 16); cp.async (4- to 16-byte
// copies into shared memory need the same alignment the staging words
// have, and would save the registers of a load that is issued in full
// before any use anyway).
//
// Grid (ceil(By*Bx / TB), NB).  Batched maps have a batch stride of By*Bx
// (per-frame) or 0 (one map shared by the batch).
//
// T5 replaces tools/rowslayout_exp.py::_rows_kernel (deblock_rows_layout),
// which read the (By, r, c, Bx) layout a TPU relayout dot produces for free,
// planes[r][c] = block[:, r, c, :].  Here it is one thread per tile with
// tile (by, bx) at by*64*Bx + (r*8+c)*Bx + bx instead of
// (r*8+c)*By*Bx + by*Bx + bx: threads run along Bx, so every one of the 64
// loads and stores coalesces across a warp, and a warp's 64 rows lie in one
// 64*Bx-byte span instead of 64 planes By*Bx bytes apart.  Its bound is
// K1's bytes.  The grid is exact with a bounds guard; the JAX divisibility
// demand on block_by/block_bx is a Pallas matter.

#include <cuda_runtime.h>

#include "deblock_quad.cuh"

namespace {

// At most 64 registers: 4 blocks of the largest size fill the register file.
template <bool CHROMA, int W, typename T>
__global__ void __launch_bounds__(gvct::kQuadLanes * gvct::kQuadMaxTiles, 4)
    deblock_quad_kernel(const uint8_t* in, uint8_t* out, const uint8_t* __restrict__ v1,
                        const uint8_t* __restrict__ v2, const uint8_t* __restrict__ h1,
                        const uint8_t* __restrict__ h2, gvct::Thresholds th, long long plane,
                        long long map_batch_stride) {
  __shared__ __align__(16) uint8_t stage[64 * gvct::kQuadStride];
  const int tid = threadIdx.x;
  const int tb = blockDim.x / gvct::kQuadLanes;
  const long long cell = static_cast<long long>(blockIdx.x) * tb;
  const int n = static_cast<int>(min(static_cast<long long>(tb), plane - cell));
  const size_t b = blockIdx.y;
  const size_t tiles = b * 64 * plane + cell;
  gvct::QuadLane<> lane = gvct::quad_lane(tid);
  gvct::quad_load_bs(lane, v1, v2, h1, h2, b * map_batch_stride + cell, n);
  gvct::quad_stage_load<W>(in + tiles, plane, n, tb, stage, tid);
  __syncthreads();

  const unsigned quad = 0xFu << (tid & 28);  // the quad's lanes in its warp
  auto quad_sum = [quad](uint32_t w) {
    w += __shfl_xor_sync(quad, w, 1, gvct::kQuadLanes);
    return w + __shfl_xor_sync(quad, w, 2, gvct::kQuadLanes);
  };
  gvct::quad_read_rows<CHROMA>(lane, stage);
  if constexpr (CHROMA) {
    gvct::quad_vert_chroma<T>(lane, th);
  } else {
    uint32_t w[2];
    gvct::quad_vert_words<T>(lane, th, w);
    const uint32_t sum[2] = {quad_sum(w[0]), quad_sum(w[1])};
    gvct::quad_vert_luma<T>(lane, sum, th);
  }
  gvct::quad_write_rows<CHROMA>(lane, stage);
  __syncwarp(quad);
  gvct::quad_read_cols<CHROMA>(lane, stage);
  if constexpr (CHROMA) {
    gvct::quad_hor_chroma<T>(lane, th);
  } else {
    gvct::quad_left_luma<T>(lane, quad_sum(gvct::quad_left_word<T>(lane, th)), th);
    gvct::quad_right_luma<T>(lane, quad_sum(gvct::quad_right_word<T>(lane, th)), th);
  }
  gvct::quad_write_cols<CHROMA>(lane, stage);
  __syncthreads();
  gvct::quad_stage_store<W>(stage, out + tiles, plane, n, tb, tid);
}

template <bool CHROMA>
__global__ void deblock_rows_kernel(const uint8_t* in, uint8_t* out,
                                    const uint8_t* __restrict__ v1,
                                    const uint8_t* __restrict__ v2,
                                    const uint8_t* __restrict__ h1,
                                    const uint8_t* __restrict__ h2,
                                    gvct::Thresholds th, int bx_n) {
  const int bx = blockIdx.x * blockDim.x + threadIdx.x;
  if (bx >= bx_n) return;
  gvct::deblock_rows_tile<CHROMA>(in, out, v1, v2, h1, h2, bx_n, blockIdx.y, bx, th);
}

using TilesKernel = void (*)(const uint8_t*, uint8_t*, const uint8_t*, const uint8_t*,
                             const uint8_t*, const uint8_t*, gvct::Thresholds, long long,
                             long long);

template <bool CHROMA, typename T>
TilesKernel quad_kernel(int word_bytes) {
  return word_bytes == 8   ? deblock_quad_kernel<CHROMA, 8, T>
         : word_bytes == 4 ? deblock_quad_kernel<CHROMA, 4, T>
                           : deblock_quad_kernel<CHROMA, 1, T>;
}

// A launch of gvct_deblock_tiles: grid, threads per block and kernel, or
// threads == 0 for a block_bx out of range.  One block per block_bx cells
// of a frame's flattened grid, whatever the compute type.
struct TilesLaunch {
  dim3 grid;
  int threads = 0, word_bytes = 1;
  TilesKernel kernel = nullptr;
};

TilesLaunch tiles_launch(int chroma, int int16, int block_bx, int nb, int by, int bx,
                         const void* in, const void* out) {
  TilesLaunch l;
  const long long plane = static_cast<long long>(by) * bx;
  if (block_bx < 1 || block_bx > gvct::kQuadMaxTiles) return l;
  l.threads = gvct::kQuadLanes * block_bx;
  l.word_bytes = gvct::quad_word_bytes(plane, block_bx, in, out);
  l.kernel = int16 ? (chroma ? quad_kernel<true, int16_t>(l.word_bytes)
                             : quad_kernel<false, int16_t>(l.word_bytes))
                   : (chroma ? quad_kernel<true, int>(l.word_bytes)
                             : quad_kernel<false, int>(l.word_bytes));
  l.grid = dim3(static_cast<unsigned>((plane + block_bx - 1) / block_bx), nb);
  return l;
}

}  // namespace

// Launch on `stream` without synchronizing.  tiles: nb x (8, 8, by, bx)
// uint8, contiguous; maps: (by, bx) uint8 each, batch stride
// map_batch_stride.  int16 = 0: K1/K1c, int16 != 0: K1-i16/K1-i16c; either
// with block_bx tiles and 4 * block_bx threads per block (block_bx 1..64).
// Returns cudaGetLastError() after the launch (0 = ok).
extern "C" int gvct_deblock_tiles(const void* in, void* out, const void* v1,
                                  const void* v2, const void* h1, const void* h2,
                                  int beta, int tc, int nb, int by, int bx,
                                  long long map_batch_stride, int chroma, int int16,
                                  int block_bx, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const TilesLaunch l = tiles_launch(chroma, int16, block_bx, nb, by, bx, in, out);
  if (l.threads == 0) return static_cast<int>(cudaErrorInvalidValue);
  const gvct::Thresholds th = gvct::make_thresholds(beta, tc);
  auto s = static_cast<cudaStream_t>(stream);
  auto i = static_cast<const uint8_t*>(in);
  auto o = static_cast<uint8_t*>(out);
  auto m1 = static_cast<const uint8_t*>(v1);
  auto m2 = static_cast<const uint8_t*>(v2);
  auto m3 = static_cast<const uint8_t*>(h1);
  auto m4 = static_cast<const uint8_t*>(h2);
  l.kernel<<<l.grid, l.threads, 0, s>>>(i, o, m1, m2, m3, m4, th,
                                        static_cast<long long>(by) * bx, map_batch_stride);
  return static_cast<int>(cudaGetLastError());
}

// For K1/K1c (int16 = 0) or K1-i16/K1-i16c on an aligned (by, bx) grid with
// block_bx tiles per block: out[0] the blocks one SM holds at once
// (cudaOccupancyMaxActiveBlocksPerMultiprocessor), out[1] threads per
// block, out[2] the bytes per global access of the staging.  Returns a CUDA
// error code (0 = ok).
extern "C" int gvct_deblock_tiles_occupancy(int chroma, int int16, int block_bx, int by, int bx,
                                            int device, int* out) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const TilesLaunch l = tiles_launch(chroma, int16, block_bx, 1, by, bx, nullptr, nullptr);
  if (l.threads == 0) return static_cast<int>(cudaErrorInvalidValue);
  out[1] = l.threads;
  out[2] = l.word_bytes;
  return static_cast<int>(
      cudaOccupancyMaxActiveBlocksPerMultiprocessor(&out[0], l.kernel, l.threads, 0));
}

// T5: the rows layout (by, 8, 8, bx) uint8, contiguous; maps (by, bx).
// Launch on `stream` without synchronizing; returns cudaGetLastError().
extern "C" int gvct_deblock_rows(const void* in, void* out, const void* v1, const void* v2,
                                 const void* h1, const void* h2, int beta, int tc, int by,
                                 int bx, int chroma, int threads, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const gvct::Thresholds th = gvct::make_thresholds(beta, tc);
  const dim3 grid((bx + threads - 1) / threads, by);
  const dim3 block(threads);
  auto s = static_cast<cudaStream_t>(stream);
  auto i = static_cast<const uint8_t*>(in);
  auto o = static_cast<uint8_t*>(out);
  auto m1 = static_cast<const uint8_t*>(v1);
  auto m2 = static_cast<const uint8_t*>(v2);
  auto m3 = static_cast<const uint8_t*>(h1);
  auto m4 = static_cast<const uint8_t*>(h2);
  if (chroma) {
    deblock_rows_kernel<true><<<grid, block, 0, s>>>(i, o, m1, m2, m3, m4, th, bx);
  } else {
    deblock_rows_kernel<false><<<grid, block, 0, s>>>(i, o, m1, m2, m3, m4, th, bx);
  }
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* gvct_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
