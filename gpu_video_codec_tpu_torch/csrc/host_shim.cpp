// Host (g++) build of the deblock kernel's per-tile math, with the kernel's
// own indexing, for the CPU tests: the loop below visits the tiles that the
// CUDA grid assigns to its threads and calls the same deblock_tile_at.

#include "deblock_tile.cuh"

extern "C" void gvct_host_deblock_tiles(const uint8_t* in, uint8_t* out,
                                        const uint8_t* v1, const uint8_t* v2,
                                        const uint8_t* h1, const uint8_t* h2,
                                        int beta, int tc, int nb, int by, int bx,
                                        long long map_batch_stride, int chroma) {
  const gvct::Thresholds th = gvct::make_thresholds(beta, tc);
  const size_t plane = static_cast<size_t>(by) * bx;
  for (size_t b = 0; b < static_cast<size_t>(nb); ++b) {
    for (size_t cell = 0; cell < plane; ++cell) {
      const size_t tile = b * 64 * plane + cell;
      const size_t map = b * static_cast<size_t>(map_batch_stride) + cell;
      if (chroma) {
        gvct::deblock_tile_at<true>(in, out, v1, v2, h1, h2, plane, tile, map, th);
      } else {
        gvct::deblock_tile_at<false>(in, out, v1, v2, h1, h2, plane, tile, map, th);
      }
    }
  }
}
