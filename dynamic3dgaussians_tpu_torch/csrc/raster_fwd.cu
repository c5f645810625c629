// Forward tile compositing kernel (K1) for Hopper (sm_90a).
//
// Replaces dynamic3dgaussians_tpu/ops/pallas/raster_fwd.py
// ::pallas_composite_tiles (TPU Pallas kernel `_kernel`), with the same
// interface: a feature-major merged record table rec (8 + CV, ne_pad) in
// (tile, depth)-sorted pair order,
//   rows 0..7  = x, y, conic a, b, c (pre-scaled by log2 e), opacity, 0, 0
//   rows 8..   = CV value rows: channels..., depth, 1 (zero-padded to 8k)
// plus per-tile segments [start, start + count). Outputs per tile t and
// pixel p: raw (T, P, CV) accumulators, log_t (T, P, 1) final log2
// transmittance, n_active (T, 1, 1) chunks processed.
//
// Design: one thread block per tile, one thread per pixel. The block walks
// the tile's GLOBAL-aligned chunks base + k*chunk (base = start rounded down
// to a chunk), as the TPU kernel does, stages each chunk's in-segment
// records into shared memory with coalesced row loads (neighbouring threads
// read neighbouring records of one row), and every thread composites its
// pixel sequentially in log2 space with its CV accumulators in registers.
// After each chunk the block-wide test __syncthreads_or(log2T > LOG2_T_DEAD)
// reproduces the reference's tile-level stop rule exactly (chunk 0 always
// runs; the test sits at the same chunk boundaries), so n_active, which the
// backward kernel consumes, means the same thing on both sides.
//
// The alpha chain (power, exp2, clamps, 1/255 gate) is `alpha_cell` of
// alpha.cuh, shared with the backward kernel K2 (raster_bwd.cu): it is
// written with explicitly rounded intrinsics (__fmul_rn, ...) so nvcc cannot
// contract it into FMAs, alpha is then bitwise the value the plain PyTorch
// version and K2 compute on the same card, and a cell sitting on the 1/255
// gate falls on the same side in all three. The accumulation may use FMAs.
//
// What bounds it on an H100: operations. Each record is read from device
// memory once per tile that holds it (a few MB per frame), while every cell
// (record x pixel) costs ~20 float32 operations plus 3 SFU transcendentals
// (exp2, log2, exp2) plus 2*CV for the accumulation. The float32 and SFU
// work per cell is the limit; this first version does nothing yet to raise
// the rate (no double-buffered cp.async/TMA staging, one tile per block, no
// SFU/FMA balancing) -- that is later work.

#include <cuda_runtime.h>
#include <stdint.h>

#include "alpha.cuh"

namespace {

using d3g::GEOM_ROWS;

template <int CV>
__global__ void raster_fwd_kernel(const float* __restrict__ rec, int64_t ne_pad,
                  const int* __restrict__ starts,
                  const int* __restrict__ counts, int grid_w, int tile_h,
                  int tile_w, int chunk, float* __restrict__ raw,
                  float* __restrict__ log_t, int* __restrict__ n_active) {
  extern __shared__ float smem[];  // (GEOM_ROWS + CV) x chunk
  constexpr int R = GEOM_ROWS + CV;
  const int tile = blockIdx.x;
  const int tid = threadIdx.x;
  const int nthreads = blockDim.x;  // == tile_h * tile_w (one per pixel)
  const int start = starts[tile];
  const int count = counts[tile];
  const int base = (start / chunk) * chunk;
  const int shift = start - base;
  const int n_chunks = count == 0 ? 0 : (shift + count + chunk - 1) / chunk;

  const float px = (float)((tile % grid_w) * tile_w + tid % tile_w);
  const float py = (float)((tile / grid_w) * tile_h + tid / tile_w);

  float acc[CV];
#pragma unroll
  for (int c = 0; c < CV; ++c) acc[c] = 0.0f;
  float log2t = 0.0f;

  int k = 0;
  for (; k < n_chunks; ++k) {
    // the stop test doubles as the barrier that protects the previous
    // chunk's shared records from being overwritten while still read
    if (k > 0 && !__syncthreads_or(log2t > d3g::LOG2_T_DEAD)) break;
    const int lo = max(shift - k * chunk, 0);
    const int hi = min(shift + count - k * chunk, chunk);
    const int width = hi - lo;
    const float* src = rec + (int64_t)base + (int64_t)k * chunk + lo;
    for (int i = tid; i < R * width; i += nthreads) {
      const int r = i / width;
      const int j = i - r * width;
      smem[r * chunk + lo + j] = src[(int64_t)r * ne_pad + j];
    }
    __syncthreads();

    float cum = 0.0f;  // exclusive in-chunk sum of log2(1 - alpha)
    for (int j = lo; j < hi; ++j) {
      const d3g::AlphaCell cell = d3g::alpha_cell(smem, chunk, j, px, py);
      if (!d3g::alpha_live(cell)) continue;  // contributes exact zeros
      const float lg = d3g::log2_one_minus(cell.alpha);
      const float w = cell.alpha * exp2f(cum + log2t);
#pragma unroll
      for (int c = 0; c < CV; ++c)
        acc[c] += w * smem[(GEOM_ROWS + c) * chunk + j];
      cum += lg;
    }
    log2t += cum;
  }

  const int P = nthreads;
  float* out = raw + ((int64_t)tile * P + tid) * CV;
#pragma unroll
  for (int c = 0; c < CV; ++c) out[c] = acc[c];
  log_t[(int64_t)tile * P + tid] = log2t;
  if (tid == 0) n_active[tile] = k;
}

template <int CV>
cudaError_t launch(const float* rec, int64_t ne_pad, const int* starts,
                   const int* counts, int num_tiles, int grid_w, int tile_h,
                   int tile_w, int chunk, float* raw, float* log_t,
                   int* n_active, cudaStream_t stream) {
  const size_t smem = sizeof(float) * (GEOM_ROWS + CV) * (size_t)chunk;
  cudaError_t err = cudaFuncSetAttribute(
      raster_fwd_kernel<CV>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return err;
  raster_fwd_kernel<CV><<<num_tiles, tile_h * tile_w, smem, stream>>>(
      rec, ne_pad, starts, counts, grid_w, tile_h, tile_w, chunk, raw, log_t,
      n_active);
  return cudaGetLastError();
}

}  // namespace

// Returns a cudaError_t as int (0 = launched). An unsupported value-row
// count returns cudaErrorInvalidValue without launching.
extern "C" int d3g_raster_fwd(const float* rec, long long ne_pad, int n_rows,
                              const int* starts, const int* counts,
                              int num_tiles, int grid_w, int tile_h,
                              int tile_w, int chunk, float* raw, float* log_t,
                              int* n_active, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (num_tiles == 0) return (int)cudaSuccess;
  switch (n_rows - GEOM_ROWS) {
#define D3G_CASE(CV)                                                        \
  case CV:                                                                  \
    return (int)launch<CV>(rec, ne_pad, starts, counts, num_tiles, grid_w,  \
                           tile_h, tile_w, chunk, raw, log_t, n_active, s);
    D3G_CASE(8)
    D3G_CASE(16)
    D3G_CASE(24)
    D3G_CASE(32)
    D3G_CASE(40)
    D3G_CASE(48)
#undef D3G_CASE
    default:
      return (int)cudaErrorInvalidValue;
  }
}

extern "C" const char* d3g_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
