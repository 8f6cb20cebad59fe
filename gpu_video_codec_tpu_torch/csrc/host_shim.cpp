// Host (g++) build of the kernels' per-tile math and indexing, for the CPU
// tests: each loop below visits the tiles, blocks or chunks that the CUDA
// grid assigns to its threads and calls the same functions the kernels do
// (deblock_tile.cuh, deblock_quad.cuh, swar_tile.cuh, relayout_tile.cuh).
// A quad kernel's block (K1, K1c, K1-i16, K1-i16c, T1) runs its threads one
// after another between the kernel's exchange points.

#include <cstring>
#include <vector>

#include "deblock_quad.cuh"
#include "relayout_tile.cuh"
#include "swar_tile.cuh"

namespace {

// The sum over thread tid's quad of word i of each thread's `stride` words
// in w: the quad's xor-shuffles.
uint32_t quad_sum(const std::vector<uint32_t>& w, int tid, int stride, int i) {
  const int q = tid & ~3;
  return w[stride * q + i] + w[stride * (q + 1) + i] + w[stride * (q + 2) + i] +
         w[stride * (q + 3) + i];
}

// How a block's lanes get their samples and give them back, between the
// kernel's exchange points: a shared stage of layout C that `in(stage)`
// fills as the kernel's staging does and `out(stage)` drains (K1, K1c, T5),
// or K2's tile in registers (PackedSamples below).  fill runs before the
// lanes' first read, turn between the vertical and the horizontal phases
// (the stage's __syncwarp), drain after the last write.
template <bool CHROMA, typename C, typename In, typename Out>
struct StagedSamples {
  In in;
  Out out;
  // either layout's size
  std::vector<uint8_t> stage = std::vector<uint8_t>(2 * gvct::RowsTmaCell::kBoxBytes);
  void fill() { in(stage.data()); }
  void rows(int, gvct::QuadLane<>& lane) {
    gvct::quad_read_rows<CHROMA, int, C>(lane, stage.data());
  }
  void put_rows(int, const gvct::QuadLane<>& lane) {
    gvct::quad_write_rows<CHROMA, int, C>(lane, stage.data());
  }
  void turn() {}
  void cols(int, gvct::QuadLane<>& lane) {
    gvct::quad_read_cols<CHROMA, int, C>(lane, stage.data());
  }
  void put_cols(int, const gvct::QuadLane<>& lane) {
    gvct::quad_write_cols<CHROMA, int, C>(lane, stage.data());
  }
  void drain() { out(stage.data()); }
};

template <bool CHROMA, typename C, typename In, typename Out>
StagedSamples<CHROMA, C, In, Out> staged(In in, Out out) {
  return {in, out};
}

// One block of deblock_kernel.cu's quad kernel at compute type T and bit
// depth BD, its samples moved by `s` (StagedSamples or PackedSamples); its
// 4 * tb threads run one after another between the kernel's exchange
// points; `wv`, `wl` and `wr` stand in for the shuffles: every thread
// publishes its words there, and each lane of a quad takes the sum of its
// quad's four.  `map` is the block's first tile in each BS map, n its tiles
// inside the grid.
template <bool CHROMA, typename T, int BD = 8, typename Samples>
void host_quad_block(Samples& s, const uint8_t* v1, const uint8_t* v2, const uint8_t* h1,
                     const uint8_t* h2, const gvct::Thresholds& th, int tb, size_t map, int n) {
  const int nt = gvct::kQuadLanes * tb;
  std::vector<gvct::QuadLane<>> lanes(nt);
  std::vector<uint32_t> wv(2 * nt), wl(nt), wr(nt);
  for (int tid = 0; tid < nt; ++tid) {
    lanes[tid] = gvct::quad_lane(tid);
    gvct::quad_load_bs(lanes[tid], v1, v2, h1, h2, map, n);
  }
  s.fill();
  // __syncthreads() (route A and K2: the wait on the load's barrier)
  for (int tid = 0; tid < nt; ++tid) {
    s.rows(tid, lanes[tid]);
    if (!CHROMA) {
      uint32_t w[2];
      gvct::quad_vert_words<T, BD>(lanes[tid], th, w);
      wv[2 * tid] = w[0];
      wv[2 * tid + 1] = w[1];
    }
  }
  for (int tid = 0; tid < nt; ++tid) {  // after the shuffles
    if (CHROMA) {
      gvct::quad_vert_chroma<T, BD>(lanes[tid], th);
    } else {
      const uint32_t sum[2] = {quad_sum(wv, tid, 2, 0), quad_sum(wv, tid, 2, 1)};
      gvct::quad_vert_luma<T, BD>(lanes[tid], sum, th);
    }
    s.put_rows(tid, lanes[tid]);
  }
  s.turn();
  for (int tid = 0; tid < nt; ++tid) {
    s.cols(tid, lanes[tid]);
    if (CHROMA) {
      gvct::quad_hor_chroma<T, BD>(lanes[tid], th);
    } else {
      wl[tid] = gvct::quad_left_word<T, BD>(lanes[tid], th);
    }
  }
  if (!CHROMA) {
    for (int tid = 0; tid < nt; ++tid) {
      gvct::quad_left_luma<T, BD>(lanes[tid], quad_sum(wl, tid, 1, 0), th);
      wr[tid] = gvct::quad_right_word<T, BD>(lanes[tid], th);
    }
    for (int tid = 0; tid < nt; ++tid) {
      gvct::quad_right_luma<T, BD>(lanes[tid], quad_sum(wr, tid, 1, 0), th);
    }
  }
  for (int tid = 0; tid < nt; ++tid) s.put_cols(tid, lanes[tid]);
  // __syncthreads() (K2: none; each lane stores its own words)
  s.drain();
}

// The quad kernel's route-B staging of a block: its threads' cooperative
// loads and stores in W-byte words, from and to `in` and `out` (the
// block's first tile in plane 0, planes `plane` bytes apart).
template <bool CHROMA, int W, typename T>
void host_quad_words(const uint8_t* in, uint8_t* out, const uint8_t* v1, const uint8_t* v2,
                     const uint8_t* h1, const uint8_t* h2, const gvct::Thresholds& th, int tb,
                     size_t plane, size_t map, int n) {
  const int nt = gvct::kQuadLanes * tb;
  auto s = staged<CHROMA, gvct::StageCell<int>>(
      [&](uint8_t* stage) {
        for (int tid = 0; tid < nt; ++tid) gvct::quad_stage_load<W>(in, plane, n, tb, stage, tid);
      },
      [&](const uint8_t* stage) {
        for (int tid = 0; tid < nt; ++tid) gvct::quad_stage_store<W>(stage, out, plane, n, tb, tid);
      });
  host_quad_block<CHROMA, T>(s, v1, v2, h1, h2, th, tb, map, n);
}

template <bool CHROMA, int W, typename T>
void host_quad(const uint8_t* in, uint8_t* out, const uint8_t* v1, const uint8_t* v2,
               const uint8_t* h1, const uint8_t* h2, const gvct::Thresholds& th, int tb,
               int nb, long long plane, long long map_batch_stride) {
  for (size_t b = 0; b < static_cast<size_t>(nb); ++b) {
    for (long long cell = 0; cell < plane; cell += tb) {
      const size_t tiles = b * 64 * plane + cell;
      const int n = plane - cell < tb ? static_cast<int>(plane - cell) : tb;
      host_quad_words<CHROMA, W, T>(in + tiles, out + tiles, v1, v2, h1, h2, th, tb, plane,
                                    b * map_batch_stride + cell, n);
    }
  }
}

// The quad kernel over its grid at compute type T: blocks of tb tiles
// (1..64) and 4 * tb threads, staged in the words the kernel would use for
// these pointers (gvct_host_quad_word_bytes).  Returns 0, or -1 for a tb
// out of range.
template <typename T>
int host_quad_grid(int tb, const uint8_t* in, uint8_t* out, const uint8_t* v1, const uint8_t* v2,
                   const uint8_t* h1, const uint8_t* h2, int beta, int tc, int nb, int by,
                   int bx, long long map_batch_stride, int chroma) {
  if (tb < 1 || tb > gvct::kQuadMaxTiles) return -1;
  const gvct::Thresholds th = gvct::make_thresholds(beta, tc);
  const long long plane = static_cast<long long>(by) * bx;
  const int w = gvct::quad_word_bytes(plane, tb, in, out);
  const auto run = chroma ? (w == 8   ? host_quad<true, 8, T>
                             : w == 4 ? host_quad<true, 4, T>
                                      : host_quad<true, 1, T>)
                          : (w == 8   ? host_quad<false, 8, T>
                             : w == 4 ? host_quad<false, 4, T>
                                      : host_quad<false, 1, T>);
  run(in, out, v1, v2, h1, h2, th, tb, nb, plane, map_batch_stride);
  return 0;
}

}  // namespace

// K1 / K1c: the quad kernel at T = int (host_quad_grid).
extern "C" int gvct_host_deblock_tiles_quad(int tb, const uint8_t* in, uint8_t* out,
                                            const uint8_t* v1, const uint8_t* v2,
                                            const uint8_t* h1, const uint8_t* h2, int beta,
                                            int tc, int nb, int by, int bx,
                                            long long map_batch_stride, int chroma) {
  return host_quad_grid<int>(tb, in, out, v1, v2, h1, h2, beta, tc, nb, by, bx,
                             map_batch_stride, chroma);
}

// K1-i16 / K1-i16c: the same quad kernel at T = int16_t.
extern "C" int gvct_host_deblock_tiles_i16(int tb, const uint8_t* in, uint8_t* out,
                                           const uint8_t* v1, const uint8_t* v2,
                                           const uint8_t* h1, const uint8_t* h2, int beta,
                                           int tc, int nb, int by, int bx,
                                           long long map_batch_stride, int chroma) {
  return host_quad_grid<int16_t>(tb, in, out, v1, v2, h1, h2, beta, tc, nb, by, bx,
                                 map_batch_stride, chroma);
}

// The bytes per global access of the quad kernel's staging for a grid of
// `plane` tiles per plane, tb tiles per block and these pointers.
extern "C" int gvct_host_quad_word_bytes(long long plane, int tb, const void* in,
                                         const void* out) {
  return gvct::quad_word_bytes(plane, tb, in, out);
}

namespace {

// T5's route-A stage of a block as its TMA boxes fill it (deblock_kernel.cu,
// RowsTma): box h holds tiles [32h, 32h + 32) of the block, element
// (x, c, r) of the box at h * kBoxBytes + r * kRow + c * kStride + x;
// elements past the grid (tile 32h + x >= n) and the pad column c = 8 are
// 0.  `src` is the block's first tile in plane 0, planes bx_n bytes apart.
void host_tma_load(const uint8_t* src, size_t bx_n, int n, uint8_t* stage) {
  using C = gvct::RowsTmaCell;
  for (int h = 0; h * C::kBoxTiles < n; ++h) {
    for (int r = 0; r < 8; ++r) {
      for (int c = 0; c < C::kBoxC; ++c) {
        for (int x = 0; x < C::kBoxTiles; ++x) {
          const int t = h * C::kBoxTiles + x;
          stage[h * C::kBoxBytes + r * C::kRow + c * C::kStride + x] =
              c < 8 && t < n ? src[(8 * r + c) * bx_n + t] : 0;
        }
      }
    }
  }
}

// The TMA boxes' store: every element inside the grid, none of the pad.
void host_tma_store(const uint8_t* stage, uint8_t* dst, size_t bx_n, int n) {
  using C = gvct::RowsTmaCell;
  for (int h = 0; h * C::kBoxTiles < n; ++h) {
    for (int r = 0; r < 8; ++r) {
      for (int c = 0; c < 8; ++c) {
        for (int x = 0; x < C::kBoxTiles && h * C::kBoxTiles + x < n; ++x) {
          dst[(8 * r + c) * bx_n + h * C::kBoxTiles + x] =
              stage[h * C::kBoxBytes + r * C::kRow + c * C::kStride + x];
        }
      }
    }
  }
}

template <bool CHROMA>
void host_rows(int tb, int staging, const uint8_t* in, uint8_t* out, const uint8_t* v1,
               const uint8_t* v2, const uint8_t* h1, const uint8_t* h2,
               const gvct::Thresholds& th, int by, int bx) {
  for (int y = 0; y < by; ++y) {
    for (int x0 = 0; x0 < bx; x0 += tb) {
      const gvct::RowsBlock blk = gvct::rows_block(y, x0, bx, tb);
      const uint8_t* src = in + blk.tiles;
      uint8_t* dst = out + blk.tiles;
      if (staging == gvct::kRowsTma) {
        auto s = staged<CHROMA, gvct::RowsTmaCell>(
            [&](uint8_t* stage) { host_tma_load(src, bx, blk.n, stage); },
            [&](const uint8_t* stage) { host_tma_store(stage, dst, bx, blk.n); });
        host_quad_block<CHROMA, int>(s, v1, v2, h1, h2, th, tb, blk.map, blk.n);
      } else if (staging == 8) {
        host_quad_words<CHROMA, 8, int>(src, dst, v1, v2, h1, h2, th, tb, bx, blk.map, blk.n);
      } else if (staging == 4) {
        host_quad_words<CHROMA, 4, int>(src, dst, v1, v2, h1, h2, th, tb, bx, blk.map, blk.n);
      } else {
        host_quad_words<CHROMA, 1, int>(src, dst, v1, v2, h1, h2, th, tb, bx, blk.map, blk.n);
      }
    }
  }
}

}  // namespace

// T5 (deblock_kernel.cu's rows quad) over its grid: the rows layout
// (by, 8, 8, bx), maps (by, bx), blocks of tb tiles of one tile row (1..64)
// and 4 * tb threads.  tma = 0 stages in the words route B would use for
// these pointers; tma != 0 stages as route A's TMA boxes would (the
// tensor map's zero fill and clipping done by hand), for a tb that route
// A takes.  Returns 0, or -1 for a tb out of range or a tma request route A
// cannot take.
extern "C" int gvct_host_deblock_rows(int tb, int tma, const uint8_t* in, uint8_t* out,
                                      const uint8_t* v1, const uint8_t* v2, const uint8_t* h1,
                                      const uint8_t* h2, int beta, int tc, int by, int bx,
                                      int chroma) {
  if (tb < 1 || tb > gvct::kQuadMaxTiles || (tma && tb % gvct::kRowsBoxTiles)) return -1;
  const gvct::Thresholds th = gvct::make_thresholds(beta, tc);
  const int staging = tma ? gvct::kRowsTma : gvct::quad_word_bytes(bx, tb, in, out);
  (chroma ? host_rows<true> : host_rows<false>)(tb, staging, in, out, v1, v2, h1, h2, th, by,
                                                bx);
  return 0;
}

// T5's route for a grid bx tiles wide, tb tiles per block and these
// pointers: 0 for route A (TMA), else route B's bytes per access.
extern "C" int gvct_host_rows_staging(int bx, int tb, const void* in, const void* out) {
  return gvct::rows_staging(bx, tb, in, out);
}

namespace {

// One plane of one frame as K2's tensor maps see it: ph rows of pw
// samples, read at `in` with rows in_row bytes apart, written at `out` with
// rows out_row apart.
struct HostPlane {
  const uint8_t* in;
  long long in_row;
  uint8_t* out;
  long long out_row;
  int ph, pw;
};

// K2's box of a block as the TMA loads it (deblock_kernel.cu,
// deblock_packed_kernel<BD>): the plane's rows y0 .. y0 + 7 and columns
// x0 - kLead onwards, kWidth samples of them, densely; 0 outside the plane.
template <typename C>
void host_packed_load(const HostPlane& p, int x0, int y0, uint8_t* stage) {
  for (int r = 0; r < 8; ++r) {
    for (int e = 0; e < C::kWidth; ++e) {
      const int y = y0 + r, x = x0 - C::kLead + e;
      uint8_t* d = stage + r * C::kRow + C::kSample * e;
      if (y >= 0 && y < p.ph && x >= 0 && x < p.pw) {
        std::memcpy(d, p.in + y * p.in_row + C::kSample * x, C::kSample);
      } else {
        std::memset(d, 0, C::kSample);
      }
    }
  }
}

// K2's lanes (deblock_kernel.cu, packed_quad_phases): fill loads the box
// and each lane reads its words (packed_read), turn and drain run the
// quad's transpose -- its two exchanges over every quad, each lane's word
// published before any is taken, as the xor-shuffles do -- and drain then
// stores each lane's words (packed_store).
template <bool CHROMA, int BD>
struct PackedSamples {
  using C = gvct::PackedCell<gvct::PackedSample<BD>>;
  static constexpr int kThreads = gvct::kQuadLanes * gvct::kPackedTiles;
  const HostPlane& p;
  int x0, y0, n;
  std::vector<uint8_t> stage = std::vector<uint8_t>(C::kBytes);
  std::vector<gvct::PackedTile<BD>> tiles = std::vector<gvct::PackedTile<BD>>(kThreads);
  void fill() {
    host_packed_load<C>(p, x0, y0, stage.data());
    for (int tid = 0; tid < kThreads; ++tid) {
      gvct::packed_read<BD>(tiles[tid], stage.data(), tid >> 2, tid & 3);
    }
  }
  void rows(int tid, gvct::QuadLane<>& lane) { gvct::packed_rows<CHROMA>(lane, tiles[tid]); }
  void put_rows(int tid, const gvct::QuadLane<>& lane) {
    gvct::packed_put_rows<CHROMA>(lane, tiles[tid]);
  }
  void turn() {
    for (int k = 1; k <= 2; k *= 2) {
      std::vector<uint32_t> sent(3 * kThreads);
      for (int tid = 0; tid < kThreads; ++tid) {
        for (int f = 0; f < 3; ++f) {
          sent[3 * tid + f] = gvct::packed_send(tiles[tid], f, k, tid & 3);
        }
      }
      for (int tid = 0; tid < kThreads; ++tid) {
        for (int f = 0; f < 3; ++f) {
          gvct::packed_take(tiles[tid], f, k, tid & 3, sent[3 * (tid ^ k) + f]);
        }
      }
    }
  }
  void cols(int tid, gvct::QuadLane<>& lane) { gvct::packed_cols<CHROMA>(lane, tiles[tid]); }
  void put_cols(int tid, const gvct::QuadLane<>& lane) {
    gvct::packed_put_cols<CHROMA>(lane, tiles[tid]);
  }
  void drain() {
    turn();
    for (int tid = 0; tid < kThreads; ++tid) {
      gvct::packed_store(tiles[tid], p.out, p.out_row, p.ph, p.pw, x0, y0, tid >> 2, tid & 3, n);
    }
  }
};

template <bool CHROMA, int BD>
void host_packed_block(const HostPlane& p, const gvct::PackedBlock& blk,
                       const uint8_t* const* maps, const gvct::Thresholds& th) {
  PackedSamples<CHROMA, BD> s{p, 8 * blk.bx0 - 4, 8 * blk.by - 4, blk.n};
  host_quad_block<CHROMA, int, BD>(s, maps[0], maps[1], maps[2], maps[3], th, gvct::kPackedTiles,
                                   blk.map, blk.n);
}

template <int BD>
void host_packed(const uint8_t* y_in, uint8_t* y_out, const uint8_t* uv_in, uint8_t* uv_out,
                 const long long* s, const uint8_t* const* maps, const gvct::Thresholds& th,
                 int w, int h, int cw, int ch, int k, int luma_only) {
  const gvct::PackedGrid g = gvct::packed_grid(w, h, cw, ch, luma_only);
  for (int f = 0; f < k; ++f) {
    for (int b = 0; b < g.rows * g.gx; ++b) {
      const gvct::PackedBlock blk = gvct::packed_block(g, b % g.gx, b / g.gx);
      if (blk.n <= 0) continue;
      if (blk.plane == 0) {
        const HostPlane p{y_in + f * s[0], s[1], y_out + f * s[2], s[3], h, w};
        host_packed_block<false, BD>(p, blk, maps, th);
      } else {
        const long long z = blk.plane - 1;
        const HostPlane p{uv_in + f * s[4] + z * s[5], s[6], uv_out + f * s[7] + z * s[8], s[9],
                          ch, cw};
        host_packed_block<true, BD>(p, blk, maps + 4, th);
      }
    }
  }
}

}  // namespace

// K2 (bit_depth 8) or K2-10 (10), deblock_kernel.cu's packed quad, over its
// grid, with gvct_deblock_packed's arguments (strides in bytes; beta and tc
// the tables', scaled here as there), its blocks one after another, each
// staged as its TMA box would stage it (the tensor map's zero fill done by
// hand) and stored in the kernel's words.  Returns 0, or -1 for a bit depth
// other than 8 and 10.
extern "C" int gvct_host_deblock_packed(const uint8_t* y_in, uint8_t* y_out, const uint8_t* uv_in,
                                        uint8_t* uv_out, const long long* s,
                                        const uint8_t* const* maps, int beta, int tc, int w,
                                        int h, int cw, int ch, int k, int luma_only,
                                        int bit_depth) {
  if (bit_depth != 8 && bit_depth != 10) return -1;
  const int up = bit_depth - 8;
  const gvct::Thresholds th = gvct::make_thresholds(beta << up, tc << up);
  const auto run = bit_depth == 8 ? host_packed<8> : host_packed<10>;
  run(y_in, y_out, uv_in, uv_out, s, maps, th, w, h, cw, ch, k, luma_only);
  return 0;
}

// K2's (bit_depth 8) or K2-10's (10) box reads (deblock_quad.cuh,
// packed_read): out[4 * tid + j] is the byte in the box that thread tid of
// a block reads at step j, a word of the returned size (4 or 8 bytes; -1
// for another bit depth).
extern "C" int gvct_host_packed_reads(int bit_depth, int* out) {
  if (bit_depth != 8 && bit_depth != 10) return -1;
  const auto at = bit_depth == 8 ? gvct::packed_read_at<8> : gvct::packed_read_at<10>;
  for (int tid = 0; tid < gvct::kQuadLanes * gvct::kPackedTiles; ++tid) {
    for (int j = 0; j < 4; ++j) out[4 * tid + j] = at(tid >> 2, tid & 3, j);
  }
  return bit_depth == 8 ? gvct::PackedTile<8>::Cell::kWord : gvct::PackedTile<10>::Cell::kWord;
}

// K2's grid for a frame (deblock_quad.cuh, packed_grid and packed_block):
// out[0] its x extent, out[1] its rows, out[2] its blocks past their rows'
// ends (n <= 0, which return at once), out[3] its short blocks (0 < n <
// kPackedTiles), out[4 + p] the tiles the blocks of plane p own (0 luma, 1
// U, 2 V).  Returns 0.
extern "C" int gvct_host_packed_grid(int w, int h, int cw, int ch, int luma_only, int* out) {
  const gvct::PackedGrid g = gvct::packed_grid(w, h, cw, ch, luma_only);
  out[0] = g.gx;
  out[1] = g.rows;
  for (int i = 2; i < 7; ++i) out[i] = 0;
  for (int y = 0; y < g.rows; ++y) {
    for (int x = 0; x < g.gx; ++x) {
      const gvct::PackedBlock blk = gvct::packed_block(g, x, y);
      if (blk.n <= 0) {
        ++out[2];
        continue;
      }
      out[3] += blk.n < gvct::kPackedTiles;
      out[4 + blk.plane] += blk.n;
    }
  }
  return 0;
}

namespace {

// One block of swar_kernel.cu's quad kernel: pairs [c0, c0 + tb) of tile
// row y, its 4 * tb threads one after another between the kernel's
// exchange points, `wv`, `wl` and `wr` standing in for the shuffles as in
// host_quad_block.
template <bool CHROMA, int W>
void host_swar_block(const uint8_t* in, uint8_t* out, const uint8_t* v1, const uint8_t* v2,
                     const uint8_t* h1, const uint8_t* h2, const gvct::Thresholds& th, int tb,
                     int by, int bx, int y, int c0) {
  namespace s = gvct::swar;
  const int nt = gvct::kQuadLanes * tb;
  const int half = bx / 2;
  const int n = half - c0 < tb ? half - c0 : tb;
  const size_t plane = static_cast<size_t>(by) * bx;
  const size_t lo = static_cast<size_t>(y) * bx + c0;
  const s::Consts k = s::make_consts(th);
  std::vector<uint8_t> stage(64 * s::kPairStride);
  std::vector<s::PairLane> lanes(nt);
  std::vector<uint32_t> wv(4 * nt), wl(2 * nt), wr(2 * nt);
  for (int tid = 0; tid < nt; ++tid) {
    lanes[tid] = gvct::quad_lane<s::hw2>(tid);
    s::pair_load_gates<CHROMA>(lanes[tid], v1, v2, h1, h2, lo, half, n);
    s::pair_stage_load<W>(in + lo, half, plane, n, tb, stage.data(), tid);
  }
  // __syncthreads()
  for (int tid = 0; tid < nt; ++tid) {
    gvct::quad_read_rows<CHROMA>(lanes[tid], stage.data());
    if (!CHROMA) {
      uint32_t w[4];
      s::pair_vert_words(lanes[tid], k, w);
      for (int i = 0; i < 4; ++i) wv[4 * tid + i] = w[i];
    }
  }
  for (int tid = 0; tid < nt; ++tid) {  // after the shuffles
    if (CHROMA) {
      s::pair_vert_chroma(lanes[tid], k);
    } else {
      const uint32_t sum[4] = {quad_sum(wv, tid, 4, 0), quad_sum(wv, tid, 4, 1),
                               quad_sum(wv, tid, 4, 2), quad_sum(wv, tid, 4, 3)};
      s::pair_vert_luma(lanes[tid], sum, k);
    }
    gvct::quad_write_rows<CHROMA>(lanes[tid], stage.data());
  }
  // __syncwarp()
  for (int tid = 0; tid < nt; ++tid) {
    gvct::quad_read_cols<CHROMA>(lanes[tid], stage.data());
    if (CHROMA) {
      s::pair_hor_chroma(lanes[tid], k);
    } else {
      uint32_t w[2];
      s::pair_left_words(lanes[tid], k, w);
      wl[2 * tid] = w[0];
      wl[2 * tid + 1] = w[1];
    }
  }
  if (!CHROMA) {
    for (int tid = 0; tid < nt; ++tid) {
      s::pair_left_luma(lanes[tid], {quad_sum(wl, tid, 2, 0), quad_sum(wl, tid, 2, 1)}, k);
      uint32_t w[2];
      s::pair_right_words(lanes[tid], k, w);
      wr[2 * tid] = w[0];
      wr[2 * tid + 1] = w[1];
    }
    for (int tid = 0; tid < nt; ++tid) {
      s::pair_right_luma(lanes[tid], {quad_sum(wr, tid, 2, 0), quad_sum(wr, tid, 2, 1)}, k);
    }
  }
  for (int tid = 0; tid < nt; ++tid) gvct::quad_write_cols<CHROMA>(lanes[tid], stage.data());
  // __syncthreads()
  for (int tid = 0; tid < nt; ++tid) {
    s::pair_stage_store<W>(stage.data(), out + lo, half, plane, n, tb, tid);
  }
}

template <bool CHROMA, int W>
void host_swar(const uint8_t* in, uint8_t* out, const uint8_t* v1, const uint8_t* v2,
               const uint8_t* h1, const uint8_t* h2, const gvct::Thresholds& th, int tb, int by,
               int bx) {
  for (int y = 0; y < by; ++y) {
    for (int c0 = 0; c0 < bx / 2; c0 += tb) {
      host_swar_block<CHROMA, W>(in, out, v1, v2, h1, h2, th, tb, by, bx, y, c0);
    }
  }
}

}  // namespace

// T1 (the quad kernel of swar_kernel.cu) over its grid: tiles (8, 8, by,
// bx) with bx even, blocks of tb tile pairs (x, x + bx/2) (1..64) and
// 4 * tb threads, staged in the words the kernel would use for these
// pointers (gvct_host_swar_word_bytes).  Returns 0, or -1 for an odd bx or
// a tb out of range.
extern "C" int gvct_host_swar_tiles(int tb, const uint8_t* in, uint8_t* out, const uint8_t* v1,
                                    const uint8_t* v2, const uint8_t* h1, const uint8_t* h2,
                                    int beta, int tc, int by, int bx, int chroma) {
  if (bx % 2 || tb < 1 || tb > gvct::kQuadMaxTiles) return -1;
  const gvct::Thresholds th = gvct::make_thresholds(beta, tc);
  const int w = gvct::swar::pair_word_bytes(bx / 2, tb, in, out);
  const auto run = chroma ? (w == 8   ? host_swar<true, 8>
                             : w == 4 ? host_swar<true, 4>
                                      : host_swar<true, 1>)
                          : (w == 8   ? host_swar<false, 8>
                             : w == 4 ? host_swar<false, 4>
                                      : host_swar<false, 1>);
  run(in, out, v1, v2, h1, h2, th, tb, by, bx);
  return 0;
}

// The bytes per global access of T1's staging for a grid bx tiles wide, tb
// pairs per block and these pointers.
extern "C" int gvct_host_swar_word_bytes(int bx, int tb, const void* in, const void* out) {
  return gvct::swar::pair_word_bytes(bx / 2, tb, in, out);
}

// One halfword primitive of swar_tile.cuh (its host fallback) applied to n
// words: out[i] = op(a[i], b[i], c[i]) with shift count k.  Ops: 0 add,
// 1 sub, 2 neg, 3 abs, 4 max, 5 min, 6 lt, 7 asr, 8 shl, 9 addmin_relu.
// Returns 0, or -1 for an unknown op.
extern "C" int gvct_host_swar_op(int op, const uint32_t* a, const uint32_t* b,
                                 const uint32_t* c, uint32_t* out, long long n, int k) {
  namespace s = gvct::swar;
  if (op < 0 || op > 9) return -1;
  for (long long i = 0; i < n; ++i) {
    switch (op) {
      case 0: out[i] = s::vadd(a[i], b[i]); break;
      case 1: out[i] = s::vsub(a[i], b[i]); break;
      case 2: out[i] = s::vneg(a[i]); break;
      case 3: out[i] = s::vabs(a[i]); break;
      case 4: out[i] = s::vmax(a[i], b[i]); break;
      case 5: out[i] = s::vmin(a[i], b[i]); break;
      case 6: out[i] = s::vlt(a[i], b[i]); break;
      case 7: out[i] = s::vasr(a[i], k); break;
      case 8: out[i] = s::vshl(a[i], k); break;
      default: out[i] = s::vaddmin_relu(a[i], b[i], c[i]); break;
    }
  }
  return 0;
}

namespace {

// T2 (inverse = 0) or T3 (inverse = 1) over the launch grid of
// relayout_kernel.cu, one block after another, each block's NT threads one
// after another within each phase (NT = 1: one thread does the block's
// work; NT = the kernel's block size: its partition of the work).
template <int NT>
int host_relayout(int inverse, const uint8_t* src, uint8_t* dst, int h, int w, int pad,
                  int by_grid, int bx_grid, int n_outer, int n_inner, long long p_outer,
                  long long p_inner, long long p_row, long long t_outer, long long t_inner,
                  long long t_r, long long t_c, long long t_by, int flat, uint8_t* rem,
                  long long r_outer, long long r_inner) {
  gvct::RelayoutGeom g;
  if (!gvct::make_geom(&g, h, w, pad, by_grid, bx_grid, n_inner, p_outer, p_inner, p_row,
                       t_outer, t_inner, t_r, t_c, t_by, flat, r_outer, r_inner) ||
      n_outer < 0 || (rem != nullptr && !flat)) {
    return -1;
  }
  alignas(16) uint8_t stage[gvct::kStageBytes];
  const long long nb = static_cast<long long>(n_outer) * n_inner;
  const int tile_rows = gvct::kTile * by_grid;
  const int rows = tile_rows + (rem != nullptr ? gvct::tail_blocks(g) : 0);
  for (long long b = 0; b < nb; ++b) {
    const uint8_t* src_b = src + (inverse ? gvct::tiles_base(g, b) : gvct::plane_base(g, b));
    uint8_t* dst_b = dst + (inverse ? gvct::plane_base(g, b) : gvct::tiles_base(g, b));
    for (int row = 0; row < rows; ++row) {
      if (row >= tile_rows) {  // a flat-tail block (block x 0 only)
        for (int tid = 0; tid < NT; ++tid) {
          if (inverse) {
            gvct::inv_tail<NT>(rem + gvct::rem_base(g, b), dst_b, g, row - tile_rows, tid);
          } else {
            gvct::fwd_tail<NT>(src_b, rem + gvct::rem_base(g, b), g, row - tile_rows, tid);
          }
        }
        continue;
      }
      const bool flat_path = flat && gvct::flat_path(g, row);
      for (int bx0 = 0; bx0 < bx_grid; bx0 += gvct::kSpanTiles) {
        for (int tid = 0; tid < NT; ++tid) {
          if (inverse && flat_path) {
            gvct::inv_stage_at<NT>(src_b, 0, stage, g, row, bx0, tid);
          } else if (inverse) {
            gvct::inv_stage<NT>(src_b, dst_b, stage, g, row, bx0, tid);
          } else if (flat_path) {
            gvct::fwd_stage_flat<NT>(src_b, stage, g, row, bx0, tid);
          } else {
            gvct::fwd_stage<NT>(src_b, stage, g, row, bx0, tid);
          }
        }
        for (int tid = 0; tid < NT; ++tid) {  // after the kernel's __syncthreads()
          if (!inverse && flat_path) {
            gvct::fwd_store_at<NT>(stage, 0, dst_b, g, row, bx0, tid);
          } else if (!inverse) {
            gvct::fwd_store<NT>(stage, src_b, dst_b, g, row, bx0, tid);
          } else if (flat_path) {
            gvct::inv_store_flat<NT>(stage, dst_b, g, row, bx0, tid);
          } else {
            gvct::inv_store<NT>(stage, dst_b, g, row, bx0, tid);
          }
        }
      }
    }
  }
  return 0;
}

int host_relayout_any(int threads, int inverse, const uint8_t* src, uint8_t* dst, int h, int w,
                      int pad, int by_grid, int bx_grid, int n_outer, int n_inner,
                      long long p_outer, long long p_inner, long long p_row, long long t_outer,
                      long long t_inner, long long t_r, long long t_c, long long t_by, int flat,
                      uint8_t* rem, long long r_outer, long long r_inner) {
  if (threads == 1) {
    return host_relayout<1>(inverse, src, dst, h, w, pad, by_grid, bx_grid, n_outer, n_inner,
                            p_outer, p_inner, p_row, t_outer, t_inner, t_r, t_c, t_by, flat,
                            rem, r_outer, r_inner);
  }
  if (threads == gvct::kRelayoutThreads) {
    return host_relayout<gvct::kRelayoutThreads>(
        inverse, src, dst, h, w, pad, by_grid, bx_grid, n_outer, n_inner, p_outer, p_inner,
        p_row, t_outer, t_inner, t_r, t_c, t_by, flat, rem, r_outer, r_inner);
  }
  return -1;
}

}  // namespace

// T2 (inverse = 0) or T3 (inverse = 1) over the launch grid of
// relayout_kernel.cu on the rows view, with `threads` = 1 or the kernel's
// block size (see host_relayout).  Returns 0, or -1 for a geometry the
// kernel's launcher refuses or another thread count.
extern "C" int gvct_host_relayout(int threads, int inverse, const uint8_t* src, uint8_t* dst,
                                  int h, int w, int pad, int by_grid, int bx_grid, int n_outer,
                                  int n_inner, long long p_outer, long long p_inner,
                                  long long p_row, long long t_outer, long long t_inner,
                                  long long t_r, long long t_c, long long t_by) {
  return host_relayout_any(threads, inverse, src, dst, h, w, pad, by_grid, bx_grid, n_outer,
                           n_inner, p_outer, p_inner, p_row, t_outer, t_inner, t_r, t_c, t_by,
                           0, nullptr, 0, 0);
}

// The same with the kernels' last four arguments: flat = 1 for the flat
// view (Q9), and the flat tail buffer rem (null: no tail blocks) with its
// batch strides.
extern "C" int gvct_host_relayout_flat(int threads, int inverse, const uint8_t* src,
                                       uint8_t* dst, int h, int w, int pad, int by_grid,
                                       int bx_grid, int n_outer, int n_inner, long long p_outer,
                                       long long p_inner, long long p_row, long long t_outer,
                                       long long t_inner, long long t_r, long long t_c,
                                       long long t_by, int flat, uint8_t* rem,
                                       long long r_outer, long long r_inner) {
  return host_relayout_any(threads, inverse, src, dst, h, w, pad, by_grid, bx_grid, n_outer,
                           n_inner, p_outer, p_inner, p_row, t_outer, t_inner, t_r, t_c, t_by,
                           flat, rem, r_outer, r_inner);
}

// T4 over the kernel's chunks.
extern "C" void gvct_host_pack_yv12(const uint8_t* y, const uint8_t* u, const uint8_t* v,
                                    uint8_t* out, long long yn, long long cn, int nb,
                                    long long y_stride, long long u_stride, long long v_stride,
                                    long long out_stride) {
  const long long chunks = (yn + 2 * cn) / gvct::kPackChunk;
  for (long long b = 0; b < nb; ++b) {
    for (long long k = 0; k < chunks; ++k) {
      gvct::pack_chunk(y, u, v, out, yn, cn, y_stride, u_stride, v_stride, out_stride, b, k);
    }
  }
}

extern "C" int gvct_host_covered_tiles(int interior, int pad) {
  return gvct::covered_tiles(interior, pad);
}
