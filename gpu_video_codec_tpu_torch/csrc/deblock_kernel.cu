// HEVC deblock of a tile grid on Hopper (sm_90a): luma (K1) and chroma
// (K1c) as one kernel templated on CHROMA and on the compute type T, int or
// int16_t (K1-i16); and T5, the same per-tile math on the "rows" layout.
//
// K1 replaces the TPU kernel gpu_video_codec_tpu/ops/pallas_kernel.py::_kernel
// (launched by deblock_tiles_pallas), which swept (8, 8, BLOCK_BY, BLOCK_BX)
// VMEM blocks with tiles along the vector lanes.  Here one thread owns one
// shifted 8x8 tile: it loads the tile's 64 bytes T[r, c, by, bx] and its four
// BS bytes into registers, runs the four edge phases (deblock_tile.cuh) and
// stores 64 bytes.  Threads run fastest along Bx, so each of the 64 plane
// loads and stores is contiguous across a warp.  No shared memory: a
// segment never leaves its tile, which also makes in == out safe.
//
// Grid (ceil(Bx / threads), By, NB); the guard `bx >= Bx` takes the place of
// the padding tiles the TPU kernel needed.  Batched maps have a batch stride
// of By*Bx (per-frame) or 0 (one map shared by the batch).
//
// What bounds it: a 1080p frame is 32,776 luma + 16,456 chroma tiles, each
// 64 B in + 4 B BS + 64 B out, about 6.5 MB (2 us at 3.35 TB/s), and a few
// thousand int ops per tile.  At that size the launch, not the kernel, may
// set the time.  The design keeps it to two launches per frame (luma, and U
// and V together) and leaves batching frames into one launch (the batch
// axis) and CUDA graphs to later work; wgmma and TMA do not apply to an
// integer stencil.
//
// K1-i16 replaces the same TPU kernel called with dtype=int16
// (pallas_kernel.py:139, driven by tools/int16_probe.py and
// deblock_frame_pallas(dtype=)).  On the TPU int16 doubled the vector lanes
// of a VPU-bound step.  A CUDA thread has no 16-bit lanes to double: its
// registers are 32-bit and int16 arithmetic is int arithmetic plus the
// narrowing that int16 wrap-around needs (deblock_tile.cuh::nar).  The
// design keeps K1's thread-per-tile shape and only changes T, so the two
// kernels differ in exactly the cost of int16 semantics on this card; the
// bounds are K1's.
//
// T5 replaces tools/rowslayout_exp.py::_rows_kernel (deblock_rows_layout),
// which read the (By, r, c, Bx) layout a TPU relayout dot produces for free,
// planes[r][c] = block[:, r, c, :].  Here it is K1's thread per tile with
// tile (by, bx) at by*64*Bx + (r*8+c)*Bx + bx instead of
// (r*8+c)*By*Bx + by*Bx + bx: threads still run along Bx, so every one of
// the 64 loads and stores coalesces across a warp, and a warp's 64 rows now
// lie in one 64*Bx-byte span instead of 64 planes By*Bx bytes apart.  Its
// bound is K1's bytes.  The grid is exact with a bounds guard; the JAX
// divisibility demand on block_by/block_bx is a Pallas matter.

#include <cuda_runtime.h>

#include "deblock_tile.cuh"

namespace {

template <typename T, bool CHROMA>
__global__ void deblock_tiles_kernel(const uint8_t* in, uint8_t* out,
                                     const uint8_t* __restrict__ v1,
                                     const uint8_t* __restrict__ v2,
                                     const uint8_t* __restrict__ h1,
                                     const uint8_t* __restrict__ h2,
                                     gvct::Thresholds th, int by_n, int bx_n,
                                     long long map_batch_stride) {
  const int bx = blockIdx.x * blockDim.x + threadIdx.x;
  if (bx >= bx_n) return;
  const size_t plane = static_cast<size_t>(by_n) * bx_n;
  const size_t cell = static_cast<size_t>(blockIdx.y) * bx_n + bx;
  const size_t b = blockIdx.z;
  gvct::deblock_tile_at<T, CHROMA>(in, out, v1, v2, h1, h2, plane,
                                   b * 64 * plane + cell,
                                   b * static_cast<size_t>(map_batch_stride) + cell, th);
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

template <typename T>
void launch_tiles(dim3 grid, dim3 block, cudaStream_t s, const uint8_t* i, uint8_t* o,
                  const uint8_t* m1, const uint8_t* m2, const uint8_t* m3, const uint8_t* m4,
                  const gvct::Thresholds& th, int by, int bx, long long map_batch_stride,
                  int chroma) {
  if (chroma) {
    deblock_tiles_kernel<T, true><<<grid, block, 0, s>>>(i, o, m1, m2, m3, m4, th, by, bx,
                                                         map_batch_stride);
  } else {
    deblock_tiles_kernel<T, false><<<grid, block, 0, s>>>(i, o, m1, m2, m3, m4, th, by, bx,
                                                          map_batch_stride);
  }
}

}  // namespace

// Launch on `stream` without synchronizing.  tiles: nb x (8, 8, by, bx)
// uint8, contiguous; maps: (by, bx) uint8 each, batch stride
// map_batch_stride.  int16 != 0 computes in int16_t (K1-i16).  Returns
// cudaGetLastError() after the launch (0 = ok).
extern "C" int gvct_deblock_tiles(const void* in, void* out, const void* v1,
                                  const void* v2, const void* h1, const void* h2,
                                  int beta, int tc, int nb, int by, int bx,
                                  long long map_batch_stride, int chroma, int int16,
                                  int threads, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const gvct::Thresholds th = gvct::make_thresholds(beta, tc);
  const dim3 grid((bx + threads - 1) / threads, by, nb);
  const dim3 block(threads);
  auto s = static_cast<cudaStream_t>(stream);
  auto i = static_cast<const uint8_t*>(in);
  auto o = static_cast<uint8_t*>(out);
  auto m1 = static_cast<const uint8_t*>(v1);
  auto m2 = static_cast<const uint8_t*>(v2);
  auto m3 = static_cast<const uint8_t*>(h1);
  auto m4 = static_cast<const uint8_t*>(h2);
  if (int16) {
    launch_tiles<int16_t>(grid, block, s, i, o, m1, m2, m3, m4, th, by, bx, map_batch_stride,
                          chroma);
  } else {
    launch_tiles<int>(grid, block, s, i, o, m1, m2, m3, m4, th, by, bx, map_batch_stride,
                      chroma);
  }
  return static_cast<int>(cudaGetLastError());
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
