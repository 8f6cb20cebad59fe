// HEVC deblock of a tile grid on Hopper (sm_90a): luma and chroma in int
// (K1, K1c) and in int16 (K1-i16, K1-i16c) as one quad kernel of four lanes
// per tile (deblock_quad_kernel<CHROMA, W, T>), T5, the same quad on the
// rows layout (deblock_rows_quad_kernel<CHROMA, Staging>), and K2, the same
// quad on the frames' planes (deblock_packed_kernel<8>), with K2-10, its
// instance on the 16-bit samples of HEVC Main 10 (deblock_packed_kernel<10>).
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
// deblock_quad.cuh::QuadField) and the launch are K1's.
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
// which read the (By, 8, 8, Bx) "rows" layout R[by, r, c, bx], planes[r][c]
// = block[:, r, c, :]: the layout the TPU's relayout dot leaves for free
// (its (8*By, [c, t]) output reshapes to it row-major; a plane's own free
// reshape is (By, 8, Bx, 8), element [by, r, bx, c]).  Its bound is K1's
// bytes: at the race grid (136, 8, 8, 256) 4.60 MB, 1.37 us at 3.35 TB/s.
//
// Design (deblock_rows_quad_kernel).  The first design ran one thread per
// tile (34,816 threads at the race grid, about 8 warps per SM, 96
// registers, one dependent chain of 64 byte loads, four phases and 64 byte
// stores, a warp running the union of 32 tiles' filter branches).  Here it
// is K1's quad (deblock_quad.cuh): a block owns TB consecutive tiles of one
// tile row by -- the planes of two tile rows are not contiguous in this
// layout, so blocks never cross one -- and 4 * TB threads, on a grid
// (ceil(Bx / TB), By); TB = 32 by default (ops/cuda_kernel.ROWS_BLOCK_BX;
// 1-64 accepted), chosen over 64 and 16 by timings (PERF.md §6).
// Plane (r, c)
// of the block's tiles is TB bytes at
// by*64*Bx + (8r + c)*Bx + bx0: the block's 64 planes are one box of 64
// rows x TB bytes, row stride Bx.  Two stagings, chosen by
// gvct::rows_staging from the shape and the pointers alone:
//   A. TMA (TB a multiple of 32, Bx and both base addresses multiples of 16
//      bytes, as a tensor map demands; the race grid).  One elected lane
//      of warp 0 loads the block's TB / 32 boxes with
//      cp.async.bulk.tensor.3d into shared memory, completing on an
//      mbarrier, while every lane loads its BS bytes; the lanes wait on the
//      barrier, run the quad, fence the stage to the async proxy, and after
//      __syncthreads the elected lane stores the boxes back and waits for
//      the stage to be read before the block exits.  The
//      tensor map is the (8*By, 8, Bx) uint8 view (plane row, plane column,
//      tile) with box (8, 9, 32): the plane-column extent runs one past
//      the tensor, so every plane row gets a pad slot that the load zero-
//      fills and the store skips, and tiles past the grid in a tail block
//      are zero-filled on load and clipped on store by the hardware.  The
//      box lands densely, so the stage is gvct::RowsTmaCell: 32-byte rows,
//      plane (r, c) at row 9r + c, and the quad's row and column reads fall
//      in four different banks.  Dense 64-byte rows (the 2-D box of 64
//      planes) put a quad's four row reads (planes 8 apart, 512 bytes) in
//      one bank and its column reads two to a bank; the tensor map's 64-byte
//      swizzle permutes 16-byte chunks by address bits 7-8, equal for
//      planes 8 apart, so it spreads the column reads but not the row reads.
//      A pad slot needs no address arithmetic in the lanes: the stage stays
//      linear in r and c, so the quad's code is K1's with other strides.
//      Chosen over dense 64- and 32-byte rows and over 16-byte boxes by
//      timings at the race grid during development (PERF.md §6).
//      The maps are encoded on the host with cuTensorMapEncodeTiled, reached
//      through cudaGetDriverEntryPoint (no -lcuda), cached by their inputs
//      (tensor_map), and passed as __grid_constant__ parameters.
//   B. words (every other case; the 1080p grid, Bx = 241): K1's cooperative
//      load and store in 8-, 4- or 1-byte words (quad_word_bytes with plane
//      stride Bx) into K1's padded stage, src the block's first tile in
//      plane 0 and planes Bx bytes apart.
// Neither route falls back to the other: a refused encode or launch is an
// error.  The BS cell of tile (by, bx) is by*Bx + bx, as in K1's flattened
// grid, so quad_load_bs serves unchanged.  Lanes of tiles past the grid run
// every exchange with BS 0 and store nothing.
//
// K2 (deblock_packed_kernel<8>) replaces no TPU kernel.  It is the cuda
// backend's whole packed YV12 step -- T2 -> K1 -> T3 for luma and T2 -> K1c
// -> T3 for U and V (models/streaming._deblock_planes_impl) -- as one
// kernel on the frames' planes, for k frames at once.  The tile-planes
// layout that T2 and T3 make exists because the TPU kernel wanted the
// shifted 8x8 tiles along its vector lanes; a Hopper block can stage them
// straight from the picture.  So K2 takes T2 x2 and T3 x2 off the step:
// together they read and wrote every frame byte twice more, 60% of the
// device's step at 1080p (PERF.md §5).
//
// What bounds it: bytes.  Each frame byte is read once and written once,
// 2 x 3wh/2 bytes a frame: 16 1080p or 4 4K frames move 99.5 MB, 29.7 us
// at 3.35 TB/s.  The quad's fixed work per tile (K1's 85%, PERF.md §6)
// stays; what goes is the layout's traffic and its launches.
//
// Design.  The grid is (blocks of a tile row, tile rows, k): one block per
// kPackedTiles = 16 consecutive tiles of each luma tile row, and of each U
// and each V tile row, two chroma rows to a grid row at 4:2:0 and 4:2:2
// (one at 4:4:4; gvct::packed_grid, and gvct::packed_block, which finds a
// block's place without a division); blocks past their
// row's end return at once.  The tile grids are the chain's, so the BS
// maps and their Q2 chroma gate are the chain's.  The plane is
// uniform in a block, so choosing the luma or the chroma quad does not
// diverge.  One elected lane of warp 0 loads the block's tiles -- 8
// picture rows from row 8 by - 4 -- as one box with
// cp.async.bulk.tensor.4d through a tensor map of the luma planes (x, y,
// 1, frame) or of the U and V planes (x, y, plane, frame), completing on
// an mbarrier, while every quad loads its tile's BS bytes.  The tensor
// map's zero fill outside the plane is Q6's zero padding.  A tensor copy's
// first column must lie on a 16-byte boundary (the card refuses others as
// an illegal instruction), and the tiles start at 8 bx0 - 4, so the box
// starts 12 bytes early, at 8 bx0 - 16, and is 144 bytes wide
// (gvct::PackedCell<uint8_t>).  The tile then lives in the lanes'
// registers, not in the stage (packed_quad_phases over deblock_quad.cuh's
// PackedTile): through the stage, as K1 runs, a luma lane made 49
// one-sample accesses (its rows, their write-back, its columns, theirs),
// the block read the stage once more to store it after a __syncthreads,
// and a warp's row reads fell two to a bank (four at 2-byte samples).
//   1. Each lane reads its tile's rows r and 4 + r from the box as four
//      words of 4 samples, in an order that differs by lane
//      (gvct::packed_read) so that no read of the warp is more than
//      two-way in a bank, where row by row they were four-way (its note
//      gives the arithmetic).  These four reads and the
//      mbarrier are the kernel's only shared-memory accesses.
//   2. The vertical phases run on the rows (K1's functions on QuadLane's
//      arrays, the samples taken out of the words and put back with byte
//      permutes, or 16-bit shifts and masks).
//   3. The quad transposes the tile's 4x4 blocks 0-2, two xor-shuffles of
//      one word a block (byte, then 16-bit permutes at 8 bits; 16-bit
//      permutes, then whole words at 10): lane r holds column r and column
//      4 + r rows 0-3 and runs left-hor and right-hor, with no stage write
//      and no __syncwarp between the phases; then it transposes back.
//   4. Each lane stores its own rows straight into the plane, a word of 4
//      samples a store (4 bytes at 8 bits, 8 at 10; the tile starts 4
//      samples past an 8-sample boundary, so a wider aligned store would
//      cross into a neighbour's tile): no __syncthreads and no second pass
//      over the stage.  Words outside the plane (the picture's border of
//      padding) and tiles past the grid (which lie outside it too) are not
//      stored.  No tensor copy can store the tiles: they start 4 samples
//      past a 16-byte boundary.
// Lanes of tiles past the grid run the quad with BS 0 on zeros (outside the
// plane): skipping whole warps of them timed no faster (the stage design).
// in == out is safe: shifted tiles are disjoint; a block's own bytes land
// in its box before any of its lanes stores; each lane reads from the box
// only its own tile's bytes and stores only its own tile; the neighbours'
// bytes the box also holds, filtered or not, are never read by its lanes
// nor stored.
// The tensor maps need 16-byte aligned bases and row, plane and frame
// strides: the caller's guard (ops/cuda_kernel.packed_fits: luma and
// chroma rows of 16-byte multiples, w % 32 == 0 at 4:2:0, which also leaves
// out the sheared Q9 widths, and 16-byte aligned addresses and strides)
// keeps every other input on the chain.  The maps
// are encoded on the host (tensor_map, cached as T5's are) when the launch
// is made or captured into a graph, never at a graph's replay.
//
// K2-10 (deblock_packed_kernel<10>) is K2 on HEVC Main 10's samples: 16-bit
// words in [0, 1023] (yuv420p10le), for 4K HDR services.  It replaces no
// TPU kernel (the JAX package filters 8-bit samples only) and no kernel of
// the port (there is no 10-bit chain).  The grid, the blocks, the lanes
// and the quad are K2's; what the bit depth changes is compile-time: the
// box is a UINT16 tensor map's, 136 samples (272 bytes) wide from 8 bx0 -
// 8, so that it still starts on a 16-byte boundary (gvct::PackedCell<
// uint16_t>: kLead 4 samples); a lane's words are 8 bytes, two 32-bit
// registers of two samples, read from and stored to 8-byte boundaries; the
// thresholds are the tables' scaled by 4 (gvct_deblock_packed); the luma
// exchange packs dp and dq into 12-bit fields (a 10-bit row's dp reaches
// 2,046, two rows 4,092: gvct::QuadField<10>); and every filtered sample is
// clipped at 1023 (deblock_tile.cuh, clip2<10>).  What bounds
// it: bytes, twice K2's on the same tiles, 199.1 MB for 4 4K frames, 59.4
// us at 3.35 TB/s.  Its guard is w % 16 == 0 (the chroma rows, w/2 samples
// of 2 bytes, are 16-byte multiples) with K2's address and stride rules
// (ops/cuda_kernel.packed_fits); a 10-bit batch outside it raises.
//
// 4:2:2 (HEVC's format range extensions, e.g. Main 4:2:2 10) changes only
// the chroma planes' height: (h, w/2) where 4:2:0 has (h/2, w/2).  Every
// plane's edges lie on its own 8x8 grid, so the chroma quad, its tiles and
// its BS maps are 4:2:0's, on (h + 8) / 8 chroma tile rows.  The height is
// a runtime field of the grid (gvct::PackedGrid::ch), read by the chroma
// tensor map's extent and the stores' row limit, so K2 and K2-10 serve both
// formats with one instance each.
//
// 4:4:4 (Main 4:4:4, Main 4:4:4 10) changes the chroma planes' width too:
// (h, w), so chroma edges fall every 8 luma columns as well as rows, and
// chroma is two thirds of the tiles.  The width is a runtime field beside
// the height (gvct::PackedGrid::cw), read by the chroma tensor map's
// extent, the stores' column limit and the grid's layout: U and V take
// grid rows of their own, one after the other, where side by side they
// would leave a quarter of a 4K grid's blocks past their rows' ends
// (gvct::packed_grid).  The quad, its tiles and its BS maps are 4:2:0's.

#include <cuda.h>  // CUtensorMap and the encode's types; nothing of libcuda is linked
#include <cuda_runtime.h>

#include <mutex>

#include "deblock_quad.cuh"

namespace {

// The quad's four phases over a staged block (every thread of the block,
// between the stage's fill and its drain): K1's and T5's lanes alike, on a
// stage of layout C.
template <bool CHROMA, typename T, typename C, int BD = 8>
__device__ __forceinline__ void quad_phases(gvct::QuadLane<>& lane, uint8_t* stage,
                                            const gvct::Thresholds& th, int tid) {
  const unsigned quad = 0xFu << (tid & 28);  // the quad's lanes in its warp
  auto quad_sum = [quad](uint32_t w) {
    w += __shfl_xor_sync(quad, w, 1, gvct::kQuadLanes);
    return w + __shfl_xor_sync(quad, w, 2, gvct::kQuadLanes);
  };
  gvct::quad_read_rows<CHROMA, int, C>(lane, stage);
  if constexpr (CHROMA) {
    gvct::quad_vert_chroma<T, BD>(lane, th);
  } else {
    uint32_t w[2];
    gvct::quad_vert_words<T, BD>(lane, th, w);
    const uint32_t sum[2] = {quad_sum(w[0]), quad_sum(w[1])};
    gvct::quad_vert_luma<T, BD>(lane, sum, th);
  }
  gvct::quad_write_rows<CHROMA, int, C>(lane, stage);
  __syncwarp(quad);
  gvct::quad_read_cols<CHROMA, int, C>(lane, stage);
  if constexpr (CHROMA) {
    gvct::quad_hor_chroma<T, BD>(lane, th);
  } else {
    gvct::quad_left_luma<T, BD>(lane, quad_sum(gvct::quad_left_word<T, BD>(lane, th)), th);
    gvct::quad_right_luma<T, BD>(lane, quad_sum(gvct::quad_right_word<T, BD>(lane, th)), th);
  }
  gvct::quad_write_cols<CHROMA, int, C>(lane, stage);
}

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
  quad_phases<CHROMA, T, gvct::StageCell<int>>(lane, stage, th, tid);
  __syncthreads();
  gvct::quad_stage_store<W>(stage, out + tiles, plane, n, tb, tid);
}

// -- T5's TMA staging: PTX of the tensor copies and the mbarrier ------------------

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// One thread: the barrier expects one arrival (the expect_tx below).
__device__ __forceinline__ void barrier_init(uint64_t* bar) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;" ::"r"(smem_addr(bar)) : "memory");
  asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
}

__device__ __forceinline__ void barrier_expect(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(smem_addr(bar)),
               "r"(bytes)
               : "memory");
}

// Until the barrier's phase 0 completes: the arrival and every byte.
__device__ __forceinline__ void barrier_wait(uint64_t* bar) {
  uint32_t done = 0;
  do {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}"
        : "=r"(done)
        : "r"(smem_addr(bar)), "r"(0u)
        : "memory");
  } while (!done);
}

// True in one lane of warp 0 (elect.sync), false elsewhere: the thread that
// issues a block's tensor copies.  Electing in a whole warp lets the
// compiler treat the copies' operands as warp-uniform; behind tid == 0 it
// wraps each copy in a loop over the distinct operand values.
__device__ __forceinline__ bool copy_thread(int tid) {
  if (tid >= 32) return false;
  uint32_t elected;
  asm volatile(
      "{\n.reg .b32 r;\n.reg .pred p;\n"
      "elect.sync r|p, 0xffffffff;\n"
      "selp.u32 %0, 1, 0, p;\n}"
      : "=r"(elected));
  return elected != 0;
}

__device__ __forceinline__ void tma_load(uint8_t* dst, const CUtensorMap* map, uint64_t* bar,
                                         int x, int y, int z) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%3, %4, %5}], [%2];" ::"r"(smem_addr(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_addr(bar)), "r"(x), "r"(y), "r"(z)
      : "memory");
}

__device__ __forceinline__ void tma_store(const CUtensorMap* map, const uint8_t* src, int x,
                                          int y, int z) {
  asm volatile("cp.async.bulk.tensor.3d.global.shared::cta.bulk_group [%0, {%2, %3, %4}], [%1];" ::
                   "l"(reinterpret_cast<uint64_t>(map)),
               "r"(smem_addr(src)), "r"(x), "r"(y), "r"(z)
               : "memory");
}

// Staging policies of deblock_rows_quad_kernel: route A (TMA) and route B
// (W-byte words).
struct RowsTma {
  using Cell = gvct::RowsTmaCell;
  static constexpr int kStageBytes = gvct::kQuadMaxTiles / Cell::kBoxTiles * Cell::kBoxBytes;
};

template <int W>
struct RowsWords {
  using Cell = gvct::StageCell<int>;
  static constexpr int kStageBytes = 64 * gvct::kQuadStride;
  __device__ static void load(const uint8_t* src, int plane, int n, int tb, uint8_t* stage,
                              int tid) {
    gvct::quad_stage_load<W>(src, plane, n, tb, stage, tid);
  }
  __device__ static void store(const uint8_t* stage, uint8_t* dst, int plane, int n, int tb,
                               int tid) {
    gvct::quad_stage_store<W>(stage, dst, plane, n, tb, tid);
  }
};

template <typename Staging>
constexpr bool kTmaStaging = false;
template <>
constexpr bool kTmaStaging<RowsTma> = true;

// T5: tiles [bx0, bx0 + TB) of tile row blockIdx.y of the rows layout,
// bx0 = blockIdx.x * TB, TB = blockDim.x / 4.  Route A reads and writes
// through in_map and out_map (in and out unused); route B through in and
// out (the maps unused).
template <bool CHROMA, typename Staging>
__global__ void __launch_bounds__(gvct::kQuadLanes * gvct::kQuadMaxTiles, 4)
    deblock_rows_quad_kernel(__grid_constant__ const CUtensorMap in_map,
                             __grid_constant__ const CUtensorMap out_map, const uint8_t* in,
                             uint8_t* out, const uint8_t* __restrict__ v1,
                             const uint8_t* __restrict__ v2, const uint8_t* __restrict__ h1,
                             const uint8_t* __restrict__ h2, gvct::Thresholds th, int bx_n) {
  using C = typename Staging::Cell;
  __shared__ __align__(128) uint8_t stage[Staging::kStageBytes];
  const int tid = threadIdx.x;
  const int tb = blockDim.x / gvct::kQuadLanes;
  const int bx0 = blockIdx.x * tb;
  const gvct::RowsBlock blk = gvct::rows_block(blockIdx.y, bx0, bx_n, tb);
  gvct::QuadLane<> lane = gvct::quad_lane(tid);
  if constexpr (kTmaStaging<Staging>) {
    __shared__ uint64_t bar;
    const int boxes = (blk.n + C::kBoxTiles - 1) / C::kBoxTiles;  // past the grid: none
    const int z = 8 * static_cast<int>(blockIdx.y);
    constexpr int kMaxBoxes = gvct::kQuadMaxTiles / C::kBoxTiles;
    if (tid == 0) barrier_init(&bar);
    __syncthreads();
    if (copy_thread(tid)) {
      barrier_expect(&bar, boxes * C::kBoxBytes);
#pragma unroll
      for (int h = 0; h < kMaxBoxes; ++h) {
        if (h < boxes) {
          tma_load(stage + h * C::kBoxBytes, &in_map, &bar, bx0 + h * C::kBoxTiles, 0, z);
        }
      }
    }
    gvct::quad_load_bs(lane, v1, v2, h1, h2, blk.map, blk.n);
    barrier_wait(&bar);
    quad_phases<CHROMA, int, C>(lane, stage, th, tid);
    asm volatile("fence.proxy.async.shared::cta;" ::: "memory");  // the stage, to the TMA
    __syncthreads();
    if (copy_thread(tid)) {
#pragma unroll
      for (int h = 0; h < kMaxBoxes; ++h) {
        if (h < boxes) {
          tma_store(&out_map, stage + h * C::kBoxBytes, bx0 + h * C::kBoxTiles, 0, z);
        }
      }
      asm volatile("cp.async.bulk.commit_group;" ::: "memory");
      asm volatile("cp.async.bulk.wait_group.read 0;" ::: "memory");  // the stage is read
    }
  } else {
    gvct::quad_load_bs(lane, v1, v2, h1, h2, blk.map, blk.n);
    Staging::load(in + blk.tiles, bx_n, blk.n, tb, stage, tid);
    __syncthreads();
    quad_phases<CHROMA, int, C>(lane, stage, th, tid);
    __syncthreads();
    Staging::store(stage, out + blk.tiles, bx_n, blk.n, tb, tid);
  }
}

// -- K2: the packed step on the frames' planes ------------------------------------

__device__ __forceinline__ void tma_load_4d(uint8_t* dst, const CUtensorMap* map, uint64_t* bar,
                                            int x, int y, int z, int f) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%3, %4, %5, %6}], [%2];" ::"r"(smem_addr(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_addr(bar)), "r"(x), "r"(y), "r"(z), "r"(f)
      : "memory");
}

// The four luma and the four chroma BS maps, (By, Bx) and (cBy, cBx).
struct PackedMaps {
  const uint8_t* luma[4];
  const uint8_t* chroma[4];
};

// Where K2 writes: the luma planes at y, frames y_frame and rows y_row bytes
// apart; the U and V planes at uv, frames uv_frame, planes uv_plane and
// rows uv_row bytes apart.
struct PackedOut {
  uint8_t* y;
  long long y_frame, y_row;
  uint8_t* uv;
  long long uv_frame, uv_plane, uv_row;
};

constexpr int kPackedThreads = gvct::kQuadLanes * gvct::kPackedTiles;

// K2's four phases on the lane's tile in registers (deblock_quad.cuh,
// PackedTile): quad_phases' order and row math, with the quad's transpose of
// blocks 0-2 (two xor-shuffles a block) where quad_phases goes through the
// stage between the vertical and the horizontal phases, and again after
// them, so the lane holds its rows for the store.
template <bool CHROMA, int BD>
__device__ __forceinline__ void packed_quad_phases(gvct::QuadLane<>& lane,
                                                   gvct::PackedTile<BD>& p,
                                                   const gvct::Thresholds& th) {
  // K2's blocks are two whole warps and every lane reaches every shuffle, so
  // the whole warp takes part: with a quad's mask nvcc wrapped each shuffle
  // in a convergence check, 1-2 us a launch on the card
  constexpr unsigned kWarp = 0xFFFFFFFFu;
  auto quad_sum = [](uint32_t w) {
    w += __shfl_xor_sync(kWarp, w, 1, gvct::kQuadLanes);
    return w + __shfl_xor_sync(kWarp, w, 2, gvct::kQuadLanes);
  };
  auto transpose = [&] {
#pragma unroll
    for (int k = 1; k <= 2; k *= 2) {
      uint32_t sent[3];
#pragma unroll
      for (int f = 0; f < 3; ++f) sent[f] = gvct::packed_send(p, f, k, lane.r);
#pragma unroll
      for (int f = 0; f < 3; ++f) {
        gvct::packed_take(p, f, k, lane.r,
                          __shfl_xor_sync(kWarp, sent[f], k, gvct::kQuadLanes));
      }
    }
  };
  gvct::packed_rows<CHROMA>(lane, p);
  if constexpr (CHROMA) {
    gvct::quad_vert_chroma<int, BD>(lane, th);
  } else {
    uint32_t w[2];
    gvct::quad_vert_words<int, BD>(lane, th, w);
    const uint32_t sum[2] = {quad_sum(w[0]), quad_sum(w[1])};
    gvct::quad_vert_luma<int, BD>(lane, sum, th);
  }
  gvct::packed_put_rows<CHROMA>(lane, p);
  transpose();
  gvct::packed_cols<CHROMA>(lane, p);
  if constexpr (CHROMA) {
    gvct::quad_hor_chroma<int, BD>(lane, th);
  } else {
    gvct::quad_left_luma<int, BD>(lane, quad_sum(gvct::quad_left_word<int, BD>(lane, th)), th);
    gvct::quad_right_luma<int, BD>(lane, quad_sum(gvct::quad_right_word<int, BD>(lane, th)),
                                   th);
  }
  gvct::packed_put_cols<CHROMA>(lane, p);
  transpose();
}

// At most 64 registers, as K1: 16 blocks of two warps to an SM.  BD 8: K2;
// BD 10: K2-10, the same grid and code on 2-byte samples (a UINT16 box,
// gvct::PackedCell<uint16_t>, and 8-byte words), with thresholds scaled by
// the caller, the exchange's 12-bit fields and the clip at 1023.
template <int BD>
__global__ void __launch_bounds__(kPackedThreads, 16)
    deblock_packed_kernel(__grid_constant__ const CUtensorMap y_in,
                          __grid_constant__ const CUtensorMap uv_in, PackedOut out,
                          PackedMaps maps, gvct::Thresholds th, gvct::PackedGrid g) {
  using C = gvct::PackedCell<gvct::PackedSample<BD>>;
  __shared__ __align__(128) uint8_t stage[C::kBytes];
  __shared__ uint64_t bar;
  const int tid = threadIdx.x;
  const gvct::PackedBlock blk = gvct::packed_block(g, blockIdx.x, blockIdx.y);
  if (blk.n <= 0) return;  // past its row's end: the whole block, before any barrier
  const bool chroma = blk.plane != 0;
  const int x0 = 8 * blk.bx0 - 4, y0 = 8 * blk.by - 4;
  const int z = chroma ? blk.plane - 1 : 0, f = blockIdx.z;
  const auto map = [&](int i) { return chroma ? maps.chroma[i] : maps.luma[i]; };
  gvct::QuadLane<> lane = gvct::quad_lane(tid);
  if (tid == 0) barrier_init(&bar);
  __syncthreads();
  if (copy_thread(tid)) {
    barrier_expect(&bar, C::kBytes);
    // each copy names its tensor map as a kernel parameter
    if (chroma) {
      tma_load_4d(stage, &uv_in, &bar, x0 - C::kLead, y0, z, f);
    } else {
      tma_load_4d(stage, &y_in, &bar, x0 - C::kLead, y0, z, f);
    }
  }
  gvct::quad_load_bs(lane, map(0), map(1), map(2), map(3), blk.map, blk.n);
  barrier_wait(&bar);
  gvct::PackedTile<BD> p;
  gvct::packed_read(p, stage, lane.t, lane.r);
  if (chroma) {
    packed_quad_phases<true>(lane, p, th);
  } else {
    packed_quad_phases<false>(lane, p, th);
  }
  uint8_t* plane = chroma ? out.uv + f * out.uv_frame + z * out.uv_plane : out.y + f * out.y_frame;
  gvct::packed_store(p, plane, chroma ? out.uv_row : out.y_row, chroma ? g.ch : g.h,
                     chroma ? g.cw : g.w, x0, y0, lane.t, lane.r, blk.n);
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

using RowsKernel = void (*)(CUtensorMap, CUtensorMap, const uint8_t*, uint8_t*, const uint8_t*,
                            const uint8_t*, const uint8_t*, const uint8_t*, gvct::Thresholds,
                            int);

template <bool CHROMA>
RowsKernel rows_kernel(int staging) {
  return staging == gvct::kRowsTma ? deblock_rows_quad_kernel<CHROMA, RowsTma>
         : staging == 8            ? deblock_rows_quad_kernel<CHROMA, RowsWords<8>>
         : staging == 4            ? deblock_rows_quad_kernel<CHROMA, RowsWords<4>>
                                   : deblock_rows_quad_kernel<CHROMA, RowsWords<1>>;
}

// A launch of gvct_deblock_rows, or threads == 0 for a block_bx out of
// range.  staging: gvct::kRowsTma (route A) or route B's word bytes.
struct RowsLaunch {
  dim3 grid;
  int threads = 0, staging = 1;
  RowsKernel kernel = nullptr;
};

RowsLaunch rows_launch(int chroma, int block_bx, int by, int bx, const void* in,
                       const void* out) {
  RowsLaunch l;
  if (block_bx < 1 || block_bx > gvct::kQuadMaxTiles) return l;
  l.threads = gvct::kQuadLanes * block_bx;
  l.staging = gvct::rows_staging(bx, block_bx, in, out);
  l.kernel = chroma ? rows_kernel<true>(l.staging) : rows_kernel<false>(l.staging);
  l.grid = dim3((bx + block_bx - 1) / block_bx, by);
  return l;
}

// Error codes of the tensor-map encode, past every cudaError_t.
constexpr int kNoEncodeEntry = 100001;
constexpr int kEncodeRefused = 100002;

using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                 const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                 const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                 CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

// The driver's cuTensorMapEncodeTiled through the runtime, or an error code.
int encode_entry(EncodeTiled* fn) {
  static EncodeTiled entry = nullptr;
  static int status = -1;
  static std::once_flag once;
  std::call_once(once, [] {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found = cudaDriverEntryPointSymbolNotFound;
#if CUDART_VERSION >= 12050
    const cudaError_t err = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &found);
#else
    const cudaError_t err =
        cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault, &found);
#endif
    if (err != cudaSuccess) {
      status = static_cast<int>(err);
    } else if (found != cudaDriverEntryPointSuccess || p == nullptr) {
      status = kNoEncodeEntry;
    } else {
      entry = reinterpret_cast<EncodeTiled>(p);
      status = 0;
    }
  });
  *fn = entry;
  return status;
}

// A tensor map of the tensor of `type` elements (UINT8 or UINT16) at
// `ptr`: `rank` dims innermost first, the byte strides of dims 1.., box
// `box` (elements), the L2 promotion `l2` (how much of a line one L2 miss
// fetches), no swizzle, zero fill outside the tensor.  Encoded maps
// are cached by all of these, a map's only inputs, so a cached map is the
// map the encode would give; 32 entries, replaced in turn.
constexpr int kMaxRank = 4;

int tensor_map(CUtensorMapDataType type, const void* ptr, int rank, const cuuint64_t* dims,
               const cuuint64_t* strides, const cuuint32_t* box, CUtensorMapL2promotion l2,
               CUtensorMap* map) {
  struct Entry {
    CUtensorMapDataType type = CU_TENSOR_MAP_DATA_TYPE_UINT8;
    const void* ptr = nullptr;
    int rank = 0;
    cuuint64_t dims[kMaxRank] = {}, strides[kMaxRank - 1] = {};
    cuuint32_t box[kMaxRank] = {};
    CUtensorMapL2promotion l2 = CU_TENSOR_MAP_L2_PROMOTION_NONE;
    CUtensorMap map;
    bool same(CUtensorMapDataType t, const void* p, int n, const cuuint64_t* d,
              const cuuint64_t* s, const cuuint32_t* b, CUtensorMapL2promotion q) const {
      if (t != type || p != ptr || n != rank || q != l2) return false;
      for (int i = 0; i < n; ++i) {
        if (d[i] != dims[i] || b[i] != box[i] || (i + 1 < n && s[i] != strides[i])) return false;
      }
      return true;
    }
  };
  static Entry cache[32];
  static int next = 0;
  static std::mutex lock;
  {
    std::lock_guard<std::mutex> g(lock);
    for (const Entry& e : cache) {
      if (e.same(type, ptr, rank, dims, strides, box, l2)) {
        *map = e.map;
        return 0;
      }
    }
  }
  EncodeTiled encode = nullptr;
  if (const int err = encode_entry(&encode)) return err;
  const cuuint32_t unit[kMaxRank] = {1, 1, 1, 1};
  if (encode(map, type, rank, const_cast<void*>(ptr), dims, strides, box,
             unit, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_NONE, l2,
             CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) != CUDA_SUCCESS) {
    return kEncodeRefused;
  }
  Entry e;
  e.type = type;
  e.ptr = ptr;
  e.rank = rank;
  e.l2 = l2;
  for (int i = 0; i < rank; ++i) {
    e.dims[i] = dims[i];
    e.box[i] = box[i];
    if (i + 1 < rank) e.strides[i] = strides[i];
  }
  e.map = *map;
  std::lock_guard<std::mutex> g(lock);
  cache[next] = e;
  next = (next + 1) % 32;
  return 0;
}

// Route A's tensor map of the rows layout at `ptr`, (by, 8, 8, bx) uint8:
// dims (bx, 8, 8 * by) innermost first -- tile, plane column, plane row --
// strides bx and 8 * bx bytes, box (kBoxTiles, kBoxC, 8).
int rows_tensor_map(const void* ptr, int by, int bx, CUtensorMap* map) {
  using C = gvct::RowsTmaCell;
  const cuuint64_t dims[3] = {static_cast<cuuint64_t>(bx), 8, 8ull * by};
  const cuuint64_t strides[2] = {static_cast<cuuint64_t>(bx), 8ull * bx};  // bytes, dims 1-2
  const cuuint32_t box[3] = {C::kBoxTiles, C::kBoxC, 8};
  return tensor_map(CU_TENSOR_MAP_DATA_TYPE_UINT8, ptr, 3, dims, strides, box,
                    CU_TENSOR_MAP_L2_PROMOTION_NONE, map);
}

// The L2 promotion of K2's (BD 8) and K2-10's (BD 10) box loads: how much
// of a 256-byte L2 line one L2 miss of a box row fetches from DRAM.  A box
// row is 144 bytes at 8 bits and 272 at 10, 16 of them before its first
// tile (gvct::PackedCell's lead, a sector that the block to the left reads
// too).  Without promotion L2 fetches the row sector by sector, 32 bytes a
// request.  Chosen by bit depth from a sweep of NONE, 64, 128 and 256 B
// with tools/kernel_time.py (PERF.md §6): 256 B at 8 bits (128 B within
// 0.5 us of it), 128 B at 10 bits (256 B 0.15-0.75 us slower); NONE and
// 64 B 1-10 us slower, alike.  An evict-first or evict-normal cache hint
// on the load was slower still.
template <int BD>
constexpr CUtensorMapL2promotion kPackedL2 =
    BD == 8 ? CU_TENSOR_MAP_L2_PROMOTION_L2_256B : CU_TENSOR_MAP_L2_PROMOTION_L2_128B;

// K2's tensor map of k frames' planes of BD-bit samples at `ptr`: dims (w,
// h, planes, k) innermost first, in samples, strides row, plane and frame
// (bytes), box (the stage's row, 8, 1, 1), promotion kPackedL2<BD>.
template <int BD>
int packed_tensor_map(const void* ptr, int w, int h, int planes, int k, long long row,
                      long long plane, long long frame, CUtensorMap* map) {
  using C = gvct::PackedCell<gvct::PackedSample<BD>>;
  const cuuint64_t dims[4] = {static_cast<cuuint64_t>(w), static_cast<cuuint64_t>(h),
                              static_cast<cuuint64_t>(planes), static_cast<cuuint64_t>(k)};
  const cuuint64_t strides[3] = {static_cast<cuuint64_t>(row), static_cast<cuuint64_t>(plane),
                                 static_cast<cuuint64_t>(frame)};
  const cuuint32_t box[4] = {C::kWidth, 8, 1, 1};
  return tensor_map(BD == 8 ? CU_TENSOR_MAP_DATA_TYPE_UINT8 : CU_TENSOR_MAP_DATA_TYPE_UINT16,
                    ptr, 4, dims, strides, box, kPackedL2<BD>, map);
}

// K2 (BD 8) or K2-10 (BD 10): the maps, then the launch.
template <int BD>
int packed_launch(const void* y_in, void* y_out, const void* uv_in, void* uv_out,
                  const long long* s, const void* const* maps, const gvct::Thresholds& th,
                  int w, int h, int cw, int ch, int k, int luma_only, cudaStream_t stream) {
  const gvct::PackedGrid g = gvct::packed_grid(w, h, cw, ch, luma_only);
  CUtensorMap tm[2] = {};
  if (const int e = packed_tensor_map<BD>(y_in, w, h, 1, k, s[1], h * s[1], s[0], &tm[0])) {
    return e;
  }
  if (!luma_only) {
    if (const int e = packed_tensor_map<BD>(uv_in, cw, ch, 2, k, s[6], s[5], s[4],
                                            &tm[1])) {
      return e;
    }
  }
  const PackedOut out{static_cast<uint8_t*>(y_out), s[2], s[3], static_cast<uint8_t*>(uv_out),
                      s[7], s[8], s[9]};
  PackedMaps m;
  for (int i = 0; i < 4; ++i) {
    m.luma[i] = static_cast<const uint8_t*>(maps[i]);
    m.chroma[i] = static_cast<const uint8_t*>(maps[4 + i]);
  }
  deblock_packed_kernel<BD><<<dim3(g.gx, g.rows, k), kPackedThreads, 0, stream>>>(
      tm[0], tm[1], out, m, th, g);
  return static_cast<int>(cudaGetLastError());
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

// T5, the rows quad: the rows layout (by, 8, 8, bx) uint8, contiguous; maps
// (by, bx); block_bx tiles of one tile row and 4 * block_bx threads per
// block (1..64), staged by route A or B as gvct::rows_staging says for
// these pointers.  Launch on `stream` without synchronizing; returns
// cudaGetLastError() after the launch, or the error of a tensor-map encode
// that failed (0 = ok).
extern "C" int gvct_deblock_rows(const void* in, void* out, const void* v1, const void* v2,
                                 const void* h1, const void* h2, int beta, int tc, int by,
                                 int bx, int chroma, int block_bx, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const RowsLaunch l = rows_launch(chroma, block_bx, by, bx, in, out);
  if (l.threads == 0) return static_cast<int>(cudaErrorInvalidValue);
  CUtensorMap maps[2] = {};
  if (l.staging == gvct::kRowsTma) {
    if (const int e = rows_tensor_map(in, by, bx, &maps[0])) return e;
    if (const int e = rows_tensor_map(out, by, bx, &maps[1])) return e;
  }
  l.kernel<<<l.grid, l.threads, 0, static_cast<cudaStream_t>(stream)>>>(
      maps[0], maps[1], static_cast<const uint8_t*>(in), static_cast<uint8_t*>(out),
      static_cast<const uint8_t*>(v1), static_cast<const uint8_t*>(v2),
      static_cast<const uint8_t*>(h1), static_cast<const uint8_t*>(h2),
      gvct::make_thresholds(beta, tc), bx);
  return static_cast<int>(cudaGetLastError());
}

// For T5 at (by, bx) with block_bx tiles per block and these pointers:
// out[0] the blocks one SM holds at once, out[1] threads per block, out[2]
// the staging (0: route A, TMA; else route B's bytes per access), out[3]
// the kernel's static shared memory in bytes, out[4] its registers per
// thread.  Returns a CUDA error code (0 = ok).
extern "C" int gvct_deblock_rows_occupancy(int chroma, int block_bx, int by, int bx,
                                           const void* in, const void* out, int device,
                                           int* info) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const RowsLaunch l = rows_launch(chroma, block_bx, by, bx, in, out);
  if (l.threads == 0) return static_cast<int>(cudaErrorInvalidValue);
  cudaFuncAttributes attr;
  err = cudaFuncGetAttributes(&attr, l.kernel);
  if (err != cudaSuccess) return static_cast<int>(err);
  info[1] = l.threads;
  info[2] = l.staging;
  info[3] = static_cast<int>(attr.sharedSizeBytes);
  info[4] = attr.numRegs;
  return static_cast<int>(
      cudaOccupancyMaxActiveBlocksPerMultiprocessor(&info[0], l.kernel, l.threads, 0));
}

// K2, the packed step of k frames: luma planes (k, h, w) and U and V
// planes (k, 2, ch, cw) of bit_depth-bit samples -- (h/2, w/2) at 4:2:0,
// (h, w/2) at 4:2:2, (h, w) at 4:4:4, the one difference between the
// formats -- uint8 at 8 (K2) and
// 16-bit words at 10 (K2-10), read at y_in and uv_in and written at y_out
// and uv_out (which may be the inputs: in place).  strides, in bytes:
// [0..1] the luma input's frame and row strides, [2..3] the luma output's,
// [4..6] the chroma input's frame, plane and row strides, [7..9] the chroma
// output's; the input's strides and addresses multiples of 16 (a tensor
// map's demand), the output's of the lanes' stores, 4 bytes at 8 bits and
// 8 at 10 (ops/cuda_kernel.packed_fits asks 16 of both).  maps: the four
// (By, Bx) luma and the four (cBy, cBx) chroma BS maps, shared by the
// frames.  cw, ch: the chroma planes' columns and rows.  beta and tc: the tables' beta'
// and tc' at the QP, scaled here by 2^(bit_depth - 8) (H.265 8.7.2.5).
// luma_only != 0: no chroma blocks (the chroma pointers unused).  Launch on `stream`
// without synchronizing; returns cudaGetLastError() after the launch, or
// the error of a tensor-map encode that failed, or cudaErrorInvalidValue
// for a bit depth other than 8 and 10 (0 = ok).
extern "C" int gvct_deblock_packed(const void* y_in, void* y_out, const void* uv_in, void* uv_out,
                                   const long long* strides, const void* const* maps, int beta,
                                   int tc, int w, int h, int cw, int ch, int k, int luma_only,
                                   int bit_depth, int device, void* stream) {
  if (bit_depth != 8 && bit_depth != 10) return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int up = bit_depth - 8;
  const gvct::Thresholds th = gvct::make_thresholds(beta << up, tc << up);
  const auto launch = bit_depth == 8 ? packed_launch<8> : packed_launch<10>;
  return launch(y_in, y_out, uv_in, uv_out, strides, maps, th, w, h, cw, ch, k, luma_only,
                static_cast<cudaStream_t>(stream));
}

// K2's launch (bit_depth 8) or K2-10's (10): info[0] the blocks one SM holds
// at once, info[1] threads per block, info[2] the kernel's static shared
// memory in bytes, info[3] its registers per thread.  Returns a CUDA error
// code (0 = ok).
extern "C" int gvct_deblock_packed_info(int device, int bit_depth, int* info) {
  if (bit_depth != 8 && bit_depth != 10) return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const auto kernel = bit_depth == 8 ? deblock_packed_kernel<8> : deblock_packed_kernel<10>;
  cudaFuncAttributes attr;
  err = cudaFuncGetAttributes(&attr, kernel);
  if (err != cudaSuccess) return static_cast<int>(err);
  info[1] = kPackedThreads;
  info[2] = static_cast<int>(attr.sharedSizeBytes);
  info[3] = attr.numRegs;
  return static_cast<int>(
      cudaOccupancyMaxActiveBlocksPerMultiprocessor(&info[0], kernel, kPackedThreads, 0));
}

extern "C" const char* gvct_error_string(int code) {
  if (code == kNoEncodeEntry) return "cuTensorMapEncodeTiled: no driver entry point";
  if (code == kEncodeRefused) return "cuTensorMapEncodeTiled refused a tensor map";
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
