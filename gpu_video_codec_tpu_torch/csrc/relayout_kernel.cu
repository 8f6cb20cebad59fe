// Relayout and pack kernels of the device-resident path on Hopper (sm_90a):
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
// T2 and T3: one block of 256 threads per (tile row, 64 tiles along Bx,
// plane of the batch).  It stages the block's 8 extended rows x 512 columns
// (4 KB) in shared memory, reading one side and writing the other along its
// contiguous axis: plane rows on one side, 64-byte runs along Bx of each of
// the 64 tile planes on the other.  The index math is relayout_tile.cuh.
// T4: one thread per 16 bytes of the output, with 16-byte loads and stores
// (plane offsets are multiples of 16 when w and h are multiples of 8).
//
// What bounds them: bytes.  Each moves its input once and its output once,
// with no arithmetic to speak of: at 1080p T2 luma reads 2.07 MB and writes
// 2.10 MB (1.25 us at 3.35 TB/s), T4 reads and writes 3.11 MB each (1.86 us).
// A launch costs a few microseconds, comparable at these sizes; the design
// keeps one launch per plane group (luma; U and V together; the pack).

#include <cuda_runtime.h>

#include "relayout_tile.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kPackThreads = 256;
constexpr int kMaxGridYZ = 65535;

__global__ void __launch_bounds__(kThreads)
plane_to_tiles_kernel(const uint8_t* __restrict__ plane, uint8_t* __restrict__ tiles,
                      gvct::RelayoutGeom g) {
  __shared__ uint8_t stage[gvct::kStageBytes];
  const long long b = blockIdx.z;
  const int by = blockIdx.y;
  const int bx0 = blockIdx.x * gvct::kSpanTiles;
  gvct::fwd_stage(plane + gvct::plane_base(g, b), stage, g, by, bx0, threadIdx.x, blockDim.x);
  __syncthreads();
  gvct::fwd_store(stage, tiles + gvct::tiles_base(g, b), g, by, bx0, threadIdx.x, blockDim.x);
}

__global__ void __launch_bounds__(kThreads)
tiles_to_plane_kernel(const uint8_t* __restrict__ tiles, uint8_t* __restrict__ plane,
                      gvct::RelayoutGeom g) {
  __shared__ uint8_t stage[gvct::kStageBytes];
  const long long b = blockIdx.z;
  const int by = blockIdx.y;
  const int bx0 = blockIdx.x * gvct::kSpanTiles;
  gvct::inv_stage(tiles + gvct::tiles_base(g, b), stage, g, by, bx0, threadIdx.x, blockDim.x);
  __syncthreads();
  gvct::inv_store(stage, plane + gvct::plane_base(g, b), g, by, bx0, threadIdx.x, blockDim.x);
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
                    long long t_r, long long t_c, long long t_by, int device, void* stream) {
  const gvct::RelayoutGeom g{h, w, pad, by_grid, bx_grid, n_inner, p_outer, p_inner,
                             p_row, t_outer, t_inner, t_r, t_c, t_by};
  const long long nb = static_cast<long long>(n_outer) * n_inner;
  if (!gvct::geometry_ok(g) || n_outer < 0 || nb > kMaxGridYZ || by_grid > kMaxGridYZ) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (nb == 0) return 0;
  const dim3 grid((bx_grid + gvct::kSpanTiles - 1) / gvct::kSpanTiles, by_grid,
                  static_cast<unsigned>(nb));
  auto s = static_cast<cudaStream_t>(stream);
  if (inverse) {
    tiles_to_plane_kernel<<<grid, kThreads, 0, s>>>(static_cast<const uint8_t*>(src),
                                                   static_cast<uint8_t*>(dst), g);
  } else {
    plane_to_tiles_kernel<<<grid, kThreads, 0, s>>>(static_cast<const uint8_t*>(src),
                                                   static_cast<uint8_t*>(dst), g);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// T2.  plane: n_outer x n_inner interior (h, w) planes, strides p_*;
// tiles: the (8, 8, by_grid, bx_grid) tile-planes of each, strides t_* (Bx
// contiguous).  Launches on `stream` without synchronizing; returns
// cudaGetLastError() after the launch (0 = ok), cudaErrorInvalidValue for a
// geometry the plain version rejects.
extern "C" int gvct_plane_to_tiles(const void* plane, void* tiles, int h, int w, int pad,
                                   int by_grid, int bx_grid, int n_outer, int n_inner,
                                   long long p_outer, long long p_inner, long long p_row,
                                   long long t_outer, long long t_inner, long long t_r,
                                   long long t_c, long long t_by, int device, void* stream) {
  return launch_relayout(false, plane, tiles, h, w, pad, by_grid, bx_grid, n_outer, n_inner,
                         p_outer, p_inner, p_row, t_outer, t_inner, t_r, t_c, t_by, device,
                         stream);
}

// T3: the same operands, tile-planes -> interior planes.
extern "C" int gvct_tiles_to_plane(const void* tiles, void* plane, int h, int w, int pad,
                                   int by_grid, int bx_grid, int n_outer, int n_inner,
                                   long long p_outer, long long p_inner, long long p_row,
                                   long long t_outer, long long t_inner, long long t_r,
                                   long long t_c, long long t_by, int device, void* stream) {
  return launch_relayout(true, tiles, plane, h, w, pad, by_grid, bx_grid, n_outer, n_inner,
                         p_outer, p_inner, p_row, t_outer, t_inner, t_r, t_c, t_by, device,
                         stream);
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
