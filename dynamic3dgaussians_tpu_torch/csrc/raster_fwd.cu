// Forward tile compositing kernel (K1) for Hopper (sm_90a).
//
// Replaces dynamic3dgaussians_tpu/ops/pallas/raster_fwd.py
// ::pallas_composite_tiles (TPU Pallas kernel `_kernel`), with the same
// interface: a feature-major merged record table rec (8 + CV, ne_pad) in
// (tile, depth)-sorted pair order,
//   rows 0..7  = x, y, conic a, b, c (pre-scaled by log2 e), opacity, r6, r7
//   rows 8..   = CV value rows: channels..., depth, 1 (zero-padded to 8k)
// plus per-tile segments [start, start + count). Outputs per tile t and
// pixel p (row-major in the tile): raw (T, P, CV) accumulators, log_t
// (T, P, 1) final log2 transmittance, n_active (T, 1, 1) chunks processed.
//
// One thread block per tile, one thread per pixel. The block walks the
// tile's GLOBAL-aligned chunks base + k*chunk (base = start rounded down to
// a chunk), as the TPU kernel does, and every thread composites its pixel
// sequentially in log2 space with its CV accumulators in registers. After
// each chunk the block-wide test __syncthreads_or(log2T > LOG2_T_DEAD)
// reproduces the reference's tile-level stop rule exactly (chunk 0 always
// runs; the test sits at the same chunk boundaries), so n_active, which the
// backward kernel consumes, means the same thing on both sides.
//
// The alpha chain (power, exp2, clamps, 1/255 gate) is `alpha_cell` of
// alpha.cuh, shared with the backward kernel K2 (raster_bwd.cu): written
// with explicitly rounded intrinsics so nvcc cannot contract it into FMAs,
// alpha is bitwise the value the plain PyTorch version and K2 compute on
// the same card, and a cell on the 1/255 gate falls on the same side in all
// three. The accumulation may use FMAs.
//
// What bounds it on an H100: the issue rate of the SM and the latency of
// each warp's walk. Each record is read from device memory once per tile
// that holds it (a few MB per frame), while every walked cell costs the
// alpha chain (~16 float32 operations and an exp2) and every live one 2
// transcendentals and 2 CV more. Only ~7 % of the walked cells pass the
// gate on the bench view, so the design walks fewer cells:
//  * Each warp is an 8x4 block of pixels (when the tile divides into such
//    blocks). Each record's conservative footprint box (alpha.cuh
//    record_box) is computed once per block; a warp tests its rectangle
//    against 32 records at a time (one ballot) and walks only the records
//    it hits, in order, two per step so that their alpha chains overlap. A
//    skipped record fails the gate at every pixel of the warp, and a dead
//    cell changes neither acc nor log2T, so the outputs are bitwise those
//    of walking every record. A warp that skips a whole chunk still takes
//    part in the stop test.
//  * Chunks are staged into shared memory with cp.async, double-buffered:
//    chunk k + 1 is copied while chunk k is walked, with coalesced 16-byte
//    row copies (a tile that stops discards its prefetch); its boxes are
//    computed from device memory after the walk of chunk k.
// On an H100 80GB HBM3 at 700 W (chip_smoke.py, bench view): 0.153 ms at
// CV 8, 0.324 ms at CV 40; at CV 40 the heaviest tile alone takes 0.25 ms,
// so the tail sets the end there. Launching the heaviest tiles first, as
// K2 does, did not pay here (PERF.md).
//
// Two compile-time variants, the reference's settings that change what is
// computed (the wrapper picks the instantiation):
//  * FUSED (power_impl="mxu_fused", the reference's chunk_logalpha_fused):
//    rows 6 and 7 hold log2 opacity and its clamp; per cell m = min(p0 +
//    r6, r7), live iff m >= log2(1/255), alpha = 2^m and w = 2^(m +
//    log2T). The footprint box is taken from row 6 (alpha.cuh
//    record_box_fused), so that it holds this gate.
//  * BF16 (kernel_precision="default"): the TPU's single bf16 pass of the
//    value product, w and each value rounded to bf16 (nearest even) before
//    acc += w * v. Each thread rounds the value rows it staged, once per
//    chunk (alpha.cuh round_staged_bf16); a live cell rounds only w.

#include <cuda_runtime.h>
#include <stdint.h>

#include "alpha.cuh"

namespace {

using d3g::GEOM_ROWS;

template <int CV, bool FUSED, bool BF16>
__global__ void raster_fwd_kernel(const float* __restrict__ rec, int64_t ne_pad,
                  const int* __restrict__ starts,
                  const int* __restrict__ counts, int grid_w, int tile_h,
                  int tile_w, int chunk, float* __restrict__ raw,
                  float* __restrict__ log_t, int* __restrict__ n_active,
                  unsigned long long* __restrict__ runs) {
  constexpr int R = GEOM_ROWS + CV;
  extern __shared__ float smem[];
  float* recs = smem;                   // 2 x R x chunk
  float* boxes = recs + 2 * R * chunk;  // 2 x 4 x chunk
  const int tile = blockIdx.x;
  const int tid = threadIdx.x;
  const int nthreads = blockDim.x;  // == tile_h * tile_w (one per pixel)
  const int lane = tid & 31;
  // lanes of this warp (the last one is partial when nthreads % 32 != 0)
  const int in_warp = min(32, nthreads - (tid & ~31));
  const unsigned wmask =
      in_warp == 32 ? d3g::FULL_MASK : (1u << in_warp) - 1u;
  if (runs != nullptr && tile == 0 && tid == 0)
    atomicAdd(runs + (FUSED ? 1 : 0) + (BF16 ? 2 : 0), 1ull);
  const int start = starts[tile];
  const int count = counts[tile];
  const int base = (start / chunk) * chunk;
  const int shift = start - base;
  const int n_chunks = count == 0 ? 0 : (shift + count + chunk - 1) / chunk;

  int lx, ly;
  d3g::pixel_of_thread(tid, tile_h, tile_w, lx, ly);
  const int gx = (tile % grid_w) * tile_w + lx;
  const int gy = (tile / grid_w) * tile_h + ly;
  const float px = (float)gx, py = (float)gy;
  const d3g::Rect rect = d3g::warp_rect(wmask, gx, gy);

  float acc[CV];
#pragma unroll
  for (int c = 0; c < CV; ++c) acc[c] = 0.0f;
  float log2t = 0.0f;

  const d3g::Stager st = d3g::make_stager(rec, ne_pad, chunk, tid, nthreads);
  if (n_chunks > 0) {  // chunk 0 and its boxes, before the walk
    d3g::stage_chunk<R>(st, recs, rec, ne_pad, base, chunk);
    for (int j = tid; j < chunk; j += nthreads)
      d3g::store_box(boxes, chunk, j,
                     d3g::table_box<FUSED>(rec + base, ne_pad, j));
  }

  int k = 0;
  for (; k < n_chunks; ++k) {
    d3g::cp_async_wait_all();
    if constexpr (BF16)  // the value rows of chunk k, rounded once
      d3g::round_staged_bf16<R, GEOM_ROWS>(st, recs + (k & 1) * R * chunk,
                                           chunk);
    // chunk k and its boxes are in, chunk k - 1 is no longer read; the stop
    // test rides on the same barrier
    if (k == 0)
      __syncthreads();
    else if (!__syncthreads_or(log2t > d3g::LOG2_T_DEAD))
      break;
    const int64_t col = (int64_t)base + (int64_t)k * chunk;
    const bool next = k + 1 < n_chunks;
    if (next)
      d3g::stage_chunk<R>(st, recs + ((k + 1) & 1) * R * chunk, rec, ne_pad,
                          col + chunk, chunk);
    const float* rc = recs + (k & 1) * R * chunk;
    const float* bx = boxes + (k & 1) * 4 * chunk;
    const int lo = max(shift - k * chunk, 0);
    const int hi = min(shift + count - k * chunk, chunk);

    float cum = 0.0f;  // exclusive in-chunk sum of log2(1 - alpha)
    auto accumulate = [&](float w, int j) {
      if constexpr (BF16) w = d3g::bf16_rne(w);  // the values are rounded
#pragma unroll
      for (int c = 0; c < CV; ++c)
        acc[c] += w * rc[(GEOM_ROWS + c) * chunk + j];
    };
    auto composite = [&](const d3g::AlphaCell& cell, int j) {
      if (!d3g::alpha_live(cell)) return;  // contributes exact zeros
      const float lg = d3g::log2_one_minus(cell.alpha);
      accumulate(cell.alpha * exp2f(cum + log2t), j);
      cum += lg;
    };
    auto composite_fused = [&](float m, int j) {
      if (!(m >= d3g::LOG2_ALPHA_EPS)) return;  // exact zeros
      const float lg = d3g::log2_one_minus(exp2f(m));
      accumulate(exp2f(__fadd_rn(__fadd_rn(m, cum), log2t)), j);
      cum += lg;
    };
    for (int j0 = lo & ~31; j0 < hi; j0 += 32) {
      const int jj = j0 + lane;
      const bool keep = jj >= lo && jj < hi &&
                        d3g::box_hits(d3g::load_box(bx, chunk, jj), rect);
      unsigned todo = __ballot_sync(wmask, keep);
      // two records per step, in order: their alpha chains do not depend on
      // each other, so the second's latency hides behind the first's
      while (todo) {
        const int ja = j0 + __ffs(todo) - 1;
        todo &= todo - 1u;
        const bool two = todo != 0u;
        const int jb = two ? j0 + __ffs(todo) - 1 : ja;
        todo &= todo - 1u;
        if constexpr (FUSED) {
          const float ma = d3g::fused_log_alpha(rc, chunk, ja, px, py);
          const float mb = d3g::fused_log_alpha(rc, chunk, jb, px, py);
          composite_fused(ma, ja);
          if (two) composite_fused(mb, jb);
        } else {
          const d3g::AlphaCell cell_a =
              d3g::alpha_cell(rc, chunk, ja, px, py);
          const d3g::AlphaCell cell_b =
              d3g::alpha_cell(rc, chunk, jb, px, py);
          composite(cell_a, ja);
          if (two) composite(cell_b, jb);
        }
      }
    }
    log2t += cum;

    if (next) {  // the boxes of chunk k + 1 (its copy is in flight)
      float* nb = boxes + ((k + 1) & 1) * 4 * chunk;
      for (int j = tid; j < chunk; j += nthreads)
        d3g::store_box(nb, chunk, j,
                       d3g::table_box<FUSED>(rec + col + chunk, ne_pad, j));
    }
  }
  d3g::cp_async_wait_all();  // a stopped tile's prefetch lands before exit

  const int64_t pix = (int64_t)tile * nthreads + ly * tile_w + lx;
  float* out = raw + pix * CV;
#pragma unroll
  for (int c = 0; c < CV; ++c) out[c] = acc[c];
  log_t[pix] = log2t;
  if (tid == 0) n_active[tile] = k;
}

template <int CV, bool FUSED, bool BF16>
cudaError_t launch(const float* rec, int64_t ne_pad, const int* starts,
                   const int* counts, int num_tiles, int grid_w, int tile_h,
                   int tile_w, int chunk, float* raw, float* log_t,
                   int* n_active, unsigned long long* runs,
                   cudaStream_t stream) {
  const size_t smem =
      sizeof(float) * (2 * (size_t)(GEOM_ROWS + CV) * chunk + 2 * 4 * chunk);
  cudaError_t err = cudaFuncSetAttribute(
      raster_fwd_kernel<CV, FUSED, BF16>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  raster_fwd_kernel<CV, FUSED, BF16>
      <<<num_tiles, tile_h * tile_w, smem, stream>>>(
          rec, ne_pad, starts, counts, grid_w, tile_h, tile_w, chunk, raw,
          log_t, n_active, runs);
  return cudaGetLastError();
}

template <int CV>
cudaError_t launch_variant(int variant, const float* rec, int64_t ne_pad,
                           const int* starts, const int* counts,
                           int num_tiles, int grid_w, int tile_h, int tile_w,
                           int chunk, float* raw, float* log_t, int* n_active,
                           unsigned long long* runs, cudaStream_t stream) {
  switch (variant) {
#define D3G_VARIANT(V, FUSED, BF16)                                          \
  case V:                                                                    \
    return launch<CV, FUSED, BF16>(rec, ne_pad, starts, counts, num_tiles,   \
                                   grid_w, tile_h, tile_w, chunk, raw,       \
                                   log_t, n_active, runs, stream);
    D3G_VARIANT(0, false, false)
    D3G_VARIANT(1, true, false)
    D3G_VARIANT(2, false, true)
    D3G_VARIANT(3, true, true)
#undef D3G_VARIANT
    default:
      return cudaErrorInvalidValue;
  }
}

}  // namespace

// Returns a cudaError_t as int (0 = launched). An unsupported value-row
// count or variant returns cudaErrorInvalidValue without launching.
// `variant`: bit 0 FUSED, bit 1 BF16. `runs`, when not null, is an array
// of 4 device counters, one per variant: each run of the kernel adds one
// (its first thread, with an atomic) to the counter of the instantiation
// that runs, runs[FUSED + 2 BF16], eager or replayed from a CUDA graph.
extern "C" int d3g_raster_fwd(const float* rec, long long ne_pad, int n_rows,
                              const int* starts, const int* counts,
                              int num_tiles, int grid_w, int tile_h,
                              int tile_w, int chunk, int variant, float* raw,
                              float* log_t, int* n_active,
                              unsigned long long* runs, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (num_tiles == 0) return (int)cudaSuccess;
  switch (n_rows - GEOM_ROWS) {
#define D3G_CASE(CV)                                                        \
  case CV:                                                                  \
    return (int)launch_variant<CV>(variant, rec, ne_pad, starts, counts,    \
                                   num_tiles, grid_w, tile_h, tile_w, chunk, \
                                   raw, log_t, n_active, runs, s);
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
