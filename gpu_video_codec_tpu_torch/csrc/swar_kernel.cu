// T1: HEVC deblock of a tile-planes tensor in SWAR form on Hopper (sm_90a),
// two tiles per thread as the two signed 16-bit lanes of 32-bit words.
//
// Replaces tools/swar_exp.py::_swar_kernel (race.swar_call), whose math is
// swar_deblock_tiles / swar_deblock_planes_core / swar_luma_filter_planes /
// swar_chroma_filter_planes: K1's four-phase sweep on tile columns
// [0, Bx/2) and [Bx/2, Bx) packed as two 16-bit fields of one int32 lane.
// On the TPU it was a try at doubling the lanes of a VPU-bound step; with no
// per-field instructions it carried a bias per field and paid about 5x for
// a clamp.  Here one thread owns tiles (by, bx) and (by, bx + Bx/2), for
// bx < Bx/2, and runs swar_tile.cuh's sweep on them with the card's halfword
// instructions (SIMD intrinsics, DPX), no bias.
//
// What bounds it: the same bytes as K1 (every tile read and written once,
// four BS maps read once).  What it changes is the work per pixel: half the
// threads, each holding two tiles in 64 registers of two lanes, and a
// branchless sweep (masks and selects over both lanes) where K1 branches on
// cond1 and strong per tile and skips what a gate turns off.  It is the
// experiment that says whether K1's time is set by its integer operations:
// if so, halving the instruction stream should show.  Loads and stores stay
// coalesced: a warp reads 32 consecutive bytes of each tile plane for each
// lane.
//
// Grid (ceil((Bx/2) / threads), By); Bx must be even (the wrapper checks).

#include <cuda_runtime.h>

#include "swar_tile.cuh"

namespace {

template <bool CHROMA>
__global__ void swar_tiles_kernel(const uint8_t* in, uint8_t* out,
                                  const uint8_t* __restrict__ v1,
                                  const uint8_t* __restrict__ v2,
                                  const uint8_t* __restrict__ h1,
                                  const uint8_t* __restrict__ h2,
                                  gvct::Thresholds th, int by_n, int bx_n) {
  const int bx = blockIdx.x * blockDim.x + threadIdx.x;
  if (bx >= bx_n / 2) return;
  gvct::swar::deblock_pair<CHROMA>(in, out, v1, v2, h1, h2, by_n, bx_n, blockIdx.y, bx, th);
}

}  // namespace

// Launch on `stream` without synchronizing.  tiles: (8, 8, by, bx) uint8,
// contiguous, bx even; maps: (by, bx) uint8 each.  Returns
// cudaGetLastError() after the launch (0 = ok), or cudaErrorInvalidValue
// for an odd bx.
extern "C" int gvct_swar_tiles(const void* in, void* out, const void* v1, const void* v2,
                               const void* h1, const void* h2, int beta, int tc, int by, int bx,
                               int chroma, int threads, int device, void* stream) {
  if (bx % 2) return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const gvct::Thresholds th = gvct::make_thresholds(beta, tc);
  const dim3 grid((bx / 2 + threads - 1) / threads, by);
  const dim3 block(threads);
  auto s = static_cast<cudaStream_t>(stream);
  auto i = static_cast<const uint8_t*>(in);
  auto o = static_cast<uint8_t*>(out);
  auto m1 = static_cast<const uint8_t*>(v1);
  auto m2 = static_cast<const uint8_t*>(v2);
  auto m3 = static_cast<const uint8_t*>(h1);
  auto m4 = static_cast<const uint8_t*>(h2);
  if (chroma) {
    swar_tiles_kernel<true><<<grid, block, 0, s>>>(i, o, m1, m2, m3, m4, th, by, bx);
  } else {
    swar_tiles_kernel<false><<<grid, block, 0, s>>>(i, o, m1, m2, m3, m4, th, by, bx);
  }
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* gvct_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
