// T1: HEVC deblock of a tile-planes tensor in SWAR form on Hopper (sm_90a),
// tile pairs as the two signed 16-bit lanes of 32-bit words, four lanes per
// pair over a shared-memory stage.
//
// Replaces tools/swar_exp.py::_swar_kernel (race.swar_call), whose math is
// swar_deblock_tiles / swar_deblock_planes_core / swar_luma_filter_planes /
// swar_chroma_filter_planes: K1's four-phase sweep on tile columns
// [0, Bx/2) and [Bx/2, Bx) packed as two 16-bit fields of one int32 lane.
// On the TPU it was a try at doubling the lanes of a VPU-bound step; with no
// per-field instructions it carried a bias per field and paid about 5x for
// a clamp.  Here the pair (by, bx) and (by, bx + Bx/2), bx < Bx/2, is the
// low and high lane of every word, filtered with the card's halfword
// instructions (SIMD intrinsics, DPX) and no bias; the sweep stays
// branchless (masks and selects over both lanes) where K1 branches on
// cond1 and strong per tile.  It is the experiment that says whether K1's
// time is set by its integer operations: if so, halving the instruction
// stream should show.
//
// What bounds it: K1's bytes (every tile read and written once, the four
// BS maps read once): at the race grid (8, 8, 136, 256) 4.60 MB, 1.37 us at
// 3.35 TB/s.
//
// Design.  The first design was one thread per pair: 17,408 threads at the
// race grid, about 4 warps per SM, each holding 64 two-lane words (144
// registers, 3,912 static SASS instructions) in one dependent chain of 128
// byte loads, the full sweep and 128 byte stores, with nothing to hide its
// latency.  Here it takes K1's quad (deblock_kernel.cu, deblock_quad.cuh)
// with a pair where K1 has a tile (swar_tile.cuh):
//   1. a block owns TB pairs of one tile row, tiles [c0, c0 + TB) and
//      [c0 + Bx/2, c0 + Bx/2 + TB), and 4 * TB threads; grid
//      (ceil((Bx/2) / TB), By);
//   2. it stages both runs of every plane with the quad's coalesced loads in
//      8-, 4- or 1-byte words (the widest that Bx/2, TB and the addresses
//      allow), every load issued before a store, and interleaves each pair
//      of words with byte permutes: stage byte 2t is pair t's low tile,
//      2t + 1 its high one, so a lane's pixel pair is one 16-bit stage read
//      and one permute to a two-lane word -- half the stage reads the two
//      runs side by side would take;
//   3. lane r holds rows r and 4 + r of both tiles as two-lane words for the
//      vertical phases, then (after a __syncwarp) column r and column 4 + r
//      rows 0-3 for the horizontal ones, Q3 included, as in K1;
//   4. a segment's decision terms of rows 0 and 3 are two words per lane
//      (dp with the strong-failure count in bits 10-11 of each lane, and
//      dq), summed over the quad by two xor-shuffles each: no lane carries,
//      so the 32-bit adds are __vadd2's, and the decision stays two-lane
//      masks with no unpacking.  Four shuffles a segment, as many as two of
//      K1's packed words (one per tile) would take, without splitting and
//      re-packing the lanes;
//   5. after __syncthreads, a cooperative store in the load's words, exact
//      to the byte at the grid's end.
// 4x the threads of the first design (69,632 at the race grid), each with
// a quarter of a pair's chain, at most 85 registers under
// __launch_bounds__(256, 3).  Lanes of pairs past the grid run every
// exchange with gates 0 and store nothing: no thread leaves before a
// barrier or a shuffle.  in == out is safe: a block loads all its bytes
// before it stores any, and blocks own disjoint pairs.
//
// What Hopper offers that does not apply is K1's list: no product for
// wgmma; no TMA (the tile-plane stride By*Bx, 34,816 B at the race grid, is
// a multiple of 16 there but not at every even Bx: 32,776 B at 1080p luma
// is 8 mod 16); cp.async would copy the runs side by side, not interleaved.
//
// Bx must be even (the wrapper checks; the launcher refuses an odd Bx).

#include <cuda_runtime.h>

#include "swar_tile.cuh"

namespace {

// At most 85 registers: 3 blocks of the largest size fill the register
// file.  At 64 (K1's bound) the 4-byte-word luma entry spilled, and the
// race grid is 16-17 warps per SM whatever the bound.
template <bool CHROMA, int W>
__global__ void __launch_bounds__(gvct::kQuadLanes * gvct::kQuadMaxTiles, 3)
    swar_quad_kernel(const uint8_t* in, uint8_t* out, const uint8_t* __restrict__ v1,
                     const uint8_t* __restrict__ v2, const uint8_t* __restrict__ h1,
                     const uint8_t* __restrict__ h2, gvct::Thresholds th, int bx_n) {
  namespace s = gvct::swar;
  __shared__ __align__(16) uint8_t stage[64 * s::kPairStride];
  const int tid = threadIdx.x;
  const int tb = blockDim.x / gvct::kQuadLanes;
  const int half = bx_n / 2;
  const int c0 = blockIdx.x * tb;
  const int n = min(tb, half - c0);
  const size_t plane = static_cast<size_t>(gridDim.y) * bx_n;
  const size_t lo = static_cast<size_t>(blockIdx.y) * bx_n + c0;
  s::PairLane lane = gvct::quad_lane<s::hw2>(tid);
  s::pair_load_gates<CHROMA>(lane, v1, v2, h1, h2, lo, half, n);
  s::pair_stage_load<W>(in + lo, half, plane, n, tb, stage, tid);
  __syncthreads();

  const s::Consts k = s::make_consts(th);
  const unsigned quad = 0xFu << (tid & 28);  // the quad's lanes in its warp
  auto quad_sum = [quad](uint32_t w) {
    w += __shfl_xor_sync(quad, w, 1, gvct::kQuadLanes);
    return w + __shfl_xor_sync(quad, w, 2, gvct::kQuadLanes);
  };
  gvct::quad_read_rows<CHROMA>(lane, stage);
  if constexpr (CHROMA) {
    s::pair_vert_chroma(lane, k);
  } else {
    uint32_t w[4];
    s::pair_vert_words(lane, k, w);
    const uint32_t sum[4] = {quad_sum(w[0]), quad_sum(w[1]), quad_sum(w[2]), quad_sum(w[3])};
    s::pair_vert_luma(lane, sum, k);
  }
  gvct::quad_write_rows<CHROMA>(lane, stage);
  __syncwarp(quad);
  gvct::quad_read_cols<CHROMA>(lane, stage);
  if constexpr (CHROMA) {
    s::pair_hor_chroma(lane, k);
  } else {
    uint32_t w[2];
    s::pair_left_words(lane, k, w);
    s::pair_left_luma(lane, {quad_sum(w[0]), quad_sum(w[1])}, k);
    s::pair_right_words(lane, k, w);
    s::pair_right_luma(lane, {quad_sum(w[0]), quad_sum(w[1])}, k);
  }
  gvct::quad_write_cols<CHROMA>(lane, stage);
  __syncthreads();
  s::pair_stage_store<W>(stage, out + lo, half, plane, n, tb, tid);
}

using SwarKernel = void (*)(const uint8_t*, uint8_t*, const uint8_t*, const uint8_t*,
                            const uint8_t*, const uint8_t*, gvct::Thresholds, int);

template <bool CHROMA>
SwarKernel swar_kernel(int word_bytes) {
  return word_bytes == 8   ? swar_quad_kernel<CHROMA, 8>
         : word_bytes == 4 ? swar_quad_kernel<CHROMA, 4>
                           : swar_quad_kernel<CHROMA, 1>;
}

// A launch of gvct_swar_tiles, or threads == 0 for an odd bx or a block of
// pairs out of 1..64.
struct SwarLaunch {
  dim3 grid;
  int threads = 0, word_bytes = 1;
  SwarKernel kernel = nullptr;
};

SwarLaunch swar_launch(int chroma, int block, int by, int bx, const void* in, const void* out) {
  SwarLaunch l;
  if (bx % 2 || block < 1 || block > gvct::kQuadMaxTiles) return l;
  l.threads = gvct::kQuadLanes * block;
  l.word_bytes = gvct::swar::pair_word_bytes(bx / 2, block, in, out);
  l.kernel = chroma ? swar_kernel<true>(l.word_bytes) : swar_kernel<false>(l.word_bytes);
  l.grid = dim3((bx / 2 + block - 1) / block, by);
  return l;
}

}  // namespace

// Launch on `stream` without synchronizing.  tiles: (8, 8, by, bx) uint8,
// contiguous, bx even; maps: (by, bx) uint8 each; block: tile pairs per
// block (1..64, 4 * block threads).  Returns cudaGetLastError() after the
// launch (0 = ok), or cudaErrorInvalidValue for an odd bx or a block out of
// range.
extern "C" int gvct_swar_tiles(const void* in, void* out, const void* v1, const void* v2,
                               const void* h1, const void* h2, int beta, int tc, int by, int bx,
                               int chroma, int block, int device, void* stream) {
  const SwarLaunch l = swar_launch(chroma, block, by, bx, in, out);
  if (l.threads == 0) return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  l.kernel<<<l.grid, l.threads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint8_t*>(in), static_cast<uint8_t*>(out),
      static_cast<const uint8_t*>(v1), static_cast<const uint8_t*>(v2),
      static_cast<const uint8_t*>(h1), static_cast<const uint8_t*>(h2),
      gvct::make_thresholds(beta, tc), bx);
  return static_cast<int>(cudaGetLastError());
}

// For T1 on an aligned (by, bx) grid with `block` pairs per block: out[0]
// the blocks one SM holds at once, out[1] threads per block, out[2] the
// bytes per global access of the staging.  Returns a CUDA error code.
extern "C" int gvct_swar_tiles_occupancy(int chroma, int block, int by, int bx, int device,
                                         int* out) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const SwarLaunch l = swar_launch(chroma, block, by, bx, nullptr, nullptr);
  if (l.threads == 0) return static_cast<int>(cudaErrorInvalidValue);
  out[1] = l.threads;
  out[2] = l.word_bytes;
  return static_cast<int>(
      cudaOccupancyMaxActiveBlocksPerMultiprocessor(&out[0], l.kernel, l.threads, 0));
}

extern "C" const char* gvct_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
