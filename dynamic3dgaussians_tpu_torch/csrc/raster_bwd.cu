// Backward tile compositing kernel (K2) for Hopper (sm_90a).
//
// Replaces dynamic3dgaussians_tpu/ops/pallas/raster_bwd.py
// ::pallas_composite_tiles_bwd (TPU Pallas kernel `_bwd_kernel`, default
// power_impl="vpu" semantics), with the same interface: the forward's
// merged record table rec (8 + CV, ne_pad) and tile segments
// [start, start + count), the forward's outputs n_active (T,) and final
// log2 transmittance log_t (T, P), and the cotangent d_raw (T, P, CV) of
// its accumulators. Output d_out (8 + CV, ne_pad): per-pair gradients at
// each pair's sorted slot, rows 0..5 = d{x, y, conic a, b, c, opacity},
// rows 8.. = d(value rows); rows 6, 7 and every slot the tile never walked
// stay as the caller zero-filled them.
//
// Design: one thread block per tile, one thread per pixel, as in K1. The
// block walks exactly the tile's n_active global-aligned chunks of the
// forward, last chunk first, and stages each chunk's in-segment records in
// shared memory. Every thread walks its pixel's records in reverse and
// rebuilds the transmittance in log space from the forward's final value:
//   log_t -= log2(1 - alpha);  T = 2^log_t;  w = alpha * T;
//   dw = d_acc . vals;  d_alpha = dw * T - suffix / (1 - alpha);
//   suffix += dw * w
// (suffix = the per-pixel sum of dw * w over all later records, alpha's
// effect on every later record's transmittance). T is never recovered by
// dividing by 1 - alpha. alpha comes from alpha.cuh, bitwise K1's. Per
// record, the 6 + CV gradient terms are summed over the tile's pixels
// deterministically: a warp-shuffle tree within each warp (skipped, with
// zeros written, when no lane of the warp has a live cell), then a
// fixed-order sum over the warps' partials in shared memory, in sub-batches
// of `sub` records. No atomics: every pair slot belongs to one tile, and a
// block writes only the slots of its own segment (the TPU kernel's
// read-modify-write of a chunk shared with the previous tile relied on its
// grid running in order; blocks here run in no order).
//
// What bounds it on an H100: operations, like K1. Every walked cell costs
// the alpha chain and gate (~16 float32 operations); every live cell adds
// ~20 + 2*CV for the transmittance, d_alpha and the 6 + CV terms, plus the
// shuffle reductions per live (warp, record): 5 shuffle-adds for each of
// the 6 + CV terms. The records are read once per tile (a few MB). This
// first version does nothing yet to raise the rate (no double-buffered
// staging, one tile per block, a full shuffle tree per live warp and term);
// making it fast is later work.

#include <cuda_runtime.h>
#include <stdint.h>

#include "alpha.cuh"

namespace {

using d3g::GEOM_ROWS;

constexpr unsigned FULL_MASK = 0xffffffffu;

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    v += __shfl_down_sync(FULL_MASK, v, off);
  return v;  // complete in lane 0
}

template <int CV>
__global__ void raster_bwd_kernel(
    const float* __restrict__ rec, int64_t ne_pad,
    const int* __restrict__ starts, const int* __restrict__ counts,
    const int* __restrict__ n_active, const float* __restrict__ log_t,
    const float* __restrict__ d_raw, int grid_w, int tile_h, int tile_w,
    int chunk, int sub, float* __restrict__ d_out) {
  constexpr int R = GEOM_ROWS + CV;  // staged record rows
  constexpr int G = 6 + CV;          // gradient terms reduced per record
  extern __shared__ float smem[];
  float* recs = smem;                // R x chunk
  float* part = smem + R * chunk;    // nwarps x G x sub warp partials
  const int tile = blockIdx.x;
  const int tid = threadIdx.x;
  const int nthreads = blockDim.x;   // == tile_h * tile_w, a multiple of 32
  const int nwarps = nthreads >> 5;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int start = starts[tile];
  const int count = counts[tile];
  const int nact = n_active[tile];
  if (count == 0 || nact == 0) return;  // uniform over the block
  const int base = (start / chunk) * chunk;
  const int shift = start - base;

  const float px = (float)((tile % grid_w) * tile_w + tid % tile_w);
  const float py = (float)((tile / grid_w) * tile_h + tid / tile_w);

  const int64_t pix = (int64_t)tile * nthreads + tid;
  float dacc[CV];
#pragma unroll
  for (int c = 0; c < CV; ++c) dacc[c] = d_raw[pix * CV + c];
  float logt = log_t[pix];
  float suffix = 0.0f;

  for (int k = nact - 1; k >= 0; --k) {
    const int lo = max(shift - k * chunk, 0);
    const int hi = min(shift + count - k * chunk, chunk);
    const int width = hi - lo;
    const float* src = rec + (int64_t)base + (int64_t)k * chunk + lo;
    __syncthreads();  // the previous chunk's records are no longer read
    for (int i = tid; i < R * width; i += nthreads) {
      const int r = i / width;
      const int j = i - r * width;
      recs[r * chunk + lo + j] = src[(int64_t)r * ne_pad + j];
    }
    __syncthreads();

    for (int jb_end = hi; jb_end > lo; jb_end -= sub) {
      const int jb0 = max(lo, jb_end - sub);
      float* my_part = part + warp * G * sub;
      for (int j = jb_end - 1; j >= jb0; --j) {
        const d3g::AlphaCell cell = d3g::alpha_cell(recs, chunk, j, px, py);
        const bool live = d3g::alpha_live(cell);
        float g[6] = {0.0f, 0.0f, 0.0f, 0.0f, 0.0f, 0.0f};
        float w = 0.0f;
        if (live) {
          const float one_m = __fsub_rn(1.0f, cell.alpha);
          logt -= d3g::log2_one_minus(cell.alpha);
          const float T = exp2f(logt);
          w = cell.alpha * T;
          float dw = 0.0f;
#pragma unroll
          for (int c = 0; c < CV; ++c)
            dw += dacc[c] * recs[(GEOM_ROWS + c) * chunk + j];
          const float d_alpha = dw * T - suffix / one_m;
          suffix += dw * w;
          const float d_rawv = cell.raw <= d3g::ALPHA_MAX ? d_alpha : 0.0f;
          // alpha = op * 2^power: d alpha / d power = raw * ln 2
          const float d_pow =
              cell.p0 < 0.0f ? d_rawv * cell.raw * d3g::LN2 : 0.0f;
          const float ca = recs[2 * chunk + j];
          const float cb = recs[3 * chunk + j];
          const float cc = recs[4 * chunk + j];
          const float dx = cell.dx, dy = cell.dy;
          g[0] = d_pow * -(ca * dx + cb * dy);
          g[1] = d_pow * -(cc * dy + cb * dx);
          g[2] = d_pow * (-0.5f * dx * dx);
          g[3] = d_pow * (-dx * dy);
          g[4] = d_pow * (-0.5f * dy * dy);
          g[5] = d_rawv * cell.e;
        }
        float* pj = my_part + (j - jb0);
        if (__any_sync(FULL_MASK, live)) {
#pragma unroll
          for (int r = 0; r < 6; ++r) {
            const float s = warp_sum(g[r]);
            if (lane == 0) pj[r * sub] = s;
          }
#pragma unroll
          for (int c = 0; c < CV; ++c) {
            const float s = warp_sum(dacc[c] * w);
            if (lane == 0) pj[(6 + c) * sub] = s;
          }
        } else if (lane == 0) {
          for (int r = 0; r < G; ++r) pj[r * sub] = 0.0f;
        }
      }
      __syncthreads();  // every warp's partials of this sub-batch are in
      const int nb = jb_end - jb0;
      float* dst = d_out + (int64_t)base + (int64_t)k * chunk + jb0;
      for (int i = tid; i < G * nb; i += nthreads) {
        const int r = i / nb;
        const int jj = i - r * nb;
        float s = 0.0f;
        for (int wp = 0; wp < nwarps; ++wp) s += part[(wp * G + r) * sub + jj];
        const int row = r < 6 ? r : GEOM_ROWS + (r - 6);
        dst[(int64_t)row * ne_pad + jj] = s;
      }
      __syncthreads();  // the partials are read before the next sub-batch
    }
  }
}

template <int CV>
cudaError_t launch(const float* rec, int64_t ne_pad, const int* starts,
                   const int* counts, const int* n_active, const float* log_t,
                   const float* d_raw, int num_tiles, int grid_w, int tile_h,
                   int tile_w, int chunk, float* d_out, cudaStream_t stream) {
  const int nthreads = tile_h * tile_w;
  const int nwarps = nthreads / 32;
  const int sub = nwarps <= 8 ? 32 : 8;
  const size_t smem =
      sizeof(float) * ((size_t)(GEOM_ROWS + CV) * chunk +
                       (size_t)nwarps * (6 + CV) * sub);
  cudaError_t err = cudaFuncSetAttribute(
      raster_bwd_kernel<CV>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return err;
  raster_bwd_kernel<CV><<<num_tiles, nthreads, smem, stream>>>(
      rec, ne_pad, starts, counts, n_active, log_t, d_raw, grid_w, tile_h,
      tile_w, chunk, sub, d_out);
  return cudaGetLastError();
}

}  // namespace

// Returns a cudaError_t as int (0 = launched). An unsupported value-row
// count, or a tile whose pixel count is not a multiple of 32 in [32, 1024],
// returns cudaErrorInvalidValue without launching.
extern "C" int d3g_raster_bwd(const float* rec, long long ne_pad, int n_rows,
                              const int* starts, const int* counts,
                              const int* n_active, const float* log_t,
                              const float* d_raw, int num_tiles, int grid_w,
                              int tile_h, int tile_w, int chunk, float* d_out,
                              void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int nthreads = tile_h * tile_w;
  if (nthreads < 32 || nthreads > 1024 || nthreads % 32)
    return (int)cudaErrorInvalidValue;
  if (num_tiles == 0) return (int)cudaSuccess;
  switch (n_rows - GEOM_ROWS) {
#define D3G_CASE(CV)                                                       \
  case CV:                                                                 \
    return (int)launch<CV>(rec, ne_pad, starts, counts, n_active, log_t,   \
                           d_raw, num_tiles, grid_w, tile_h, tile_w, chunk, \
                           d_out, s);
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
