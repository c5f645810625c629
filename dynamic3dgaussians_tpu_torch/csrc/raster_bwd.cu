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
// Per pixel, walking the tile's n_active chunks of the forward last first,
// the transmittance is rebuilt in log space from the forward's final value:
//   log_t -= log2(1 - alpha);  T = 2^log_t;  w = alpha * T;
//   dw = d_acc . vals;  d_alpha = dw * T - suffix / (1 - alpha);
//   suffix += dw * w
// (suffix = the pixel's sum of dw * w over all later records). T is never
// recovered by dividing by 1 - alpha. alpha comes from alpha.cuh, bitwise
// K1's. Each record's 6 + CV gradient terms are sums over the tile's pixels.
//
// What bounds it on an H100: the issue rate of the SM and the latency of
// each warp's walk, not memory (the table is read once per tile, a few MB).
// Only ~7 % of the walked cells pass the 1/255 gate on the bench view, and
// ~25 % of the (warp, record) pairs hold one. The design spends
// instructions on those:
//  * One block per tile, one thread per pixel, each warp an 8x4 block of
//    pixels. Each record's conservative footprint box (alpha.cuh
//    record_box) is computed once per block; a warp tests its rectangle
//    against 32 records at a time (one ballot) and walks only the records
//    it hits, in a warp-uniform loop over the ballot's bits. A record it
//    skips fails the gate at all its pixels, so nothing changes.
//  * Per record a warp keeps, the 6 + CV terms are summed over its 32
//    lanes 8 at a time by a reduce-scatter (shuffles of 4, 2, 1 values,
//    then 2 butterflies: 9 shuffles for 8 terms where a shuffle tree per
//    term takes 40). Records with no live lane in the warp are skipped.
//  * The warps' partials of 32 records land in shared memory; after a
//    barrier the block sums them over warps in fixed warp order, skipping
//    warps that did not touch the record, and writes the slots some warp
//    touched. Deterministic, no atomics: every slot belongs to one tile and
//    a block writes only its own segment's slots.
//  * Chunks are staged into shared memory with cp.async, double-buffered:
//    chunk k - 1 is copied while chunk k is walked, with coalesced 16-byte
//    row copies; its footprint boxes are computed from device memory after
//    the walk of chunk k.
//  * Blocks take the tiles heaviest first (tile_order_kernel, launched
//    before the main kernel): the heaviest tile alone takes about half the
//    kernel's time, and in launch order it would start in a later wave.
// On an H100 80GB HBM3 at 700 W (chip_smoke.py, bench view, the wrapper's
// zero fill of d_out included): 0.315 ms at CV 8, 0.675 ms at CV 40.
// PERF.md has the measured worth of each step.

#include <cuda_runtime.h>
#include <stdint.h>

#include "alpha.cuh"

namespace {

using d3g::GEOM_ROWS;
using d3g::FULL_MASK;

constexpr int WORD = 32;  // records per ballot and per partial batch

// Sums v[0..7] over the warp's 32 lanes. On return lane l holds the total
// of term (l >> 2) & 7; the four lanes of a group of 4 hold it bitwise
// equal. Each reduce-scatter step halves the terms a lane carries and adds
// the partner's half: a fixed order, so the result is deterministic.
__device__ __forceinline__ float warp_sum8(float (&v)[8], int lane) {
  bool up = lane & 16;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float send = up ? v[i] : v[i + 4];
    const float keep = up ? v[i + 4] : v[i];
    v[i] = keep + __shfl_xor_sync(FULL_MASK, send, 16);
  }
  up = lane & 8;
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const float send = up ? v[i] : v[i + 2];
    const float keep = up ? v[i + 2] : v[i];
    v[i] = keep + __shfl_xor_sync(FULL_MASK, send, 8);
  }
  up = lane & 4;
  {
    const float send = up ? v[0] : v[1];
    const float keep = up ? v[1] : v[0];
    v[0] = keep + __shfl_xor_sync(FULL_MASK, send, 4);
  }
  float s = v[0];
  s += __shfl_xor_sync(FULL_MASK, s, 2);
  s += __shfl_xor_sync(FULL_MASK, s, 1);
  return s;
}

// Records tile t walks: its segment, cut at the forward's stop point.
__device__ __forceinline__ int walked_records(const int* __restrict__ starts,
                                              const int* __restrict__ counts,
                                              const int* __restrict__ n_active,
                                              int t, int chunk) {
  const int count = counts[t], nact = n_active[t];
  if (count == 0 || nact == 0) return 0;
  return min(count, nact * chunk - starts[t] % chunk);
}

// order[r] = the tile of rank r by records walked, heaviest first (ties by
// tile index), and block r of the main kernel takes it: blocks start
// roughly in index order, so the heaviest tiles, whose single-block latency
// can set the kernel's end, start in the first wave. Each thread ranks one
// tile against all others: T^2 comparisons, which add ~0.015 ms before the
// main kernel at T = 920 (H100 80GB HBM3, 700 W). Deterministic, no
// atomics.
__global__ void tile_order_kernel(const int* __restrict__ starts,
                                  const int* __restrict__ counts,
                                  const int* __restrict__ n_active,
                                  int num_tiles, int chunk,
                                  int* __restrict__ order) {
  extern __shared__ int wsh[];  // blockDim.x weights per pass
  const int u = blockIdx.x * blockDim.x + threadIdx.x;
  const int wu =
      u < num_tiles ? walked_records(starts, counts, n_active, u, chunk) : 0;
  int rank = 0;
  for (int v0 = 0; v0 < num_tiles; v0 += blockDim.x) {
    const int v = v0 + threadIdx.x;
    __syncthreads();
    wsh[threadIdx.x] =
        v < num_tiles ? walked_records(starts, counts, n_active, v, chunk) : 0;
    __syncthreads();
    const int n = min((int)blockDim.x, num_tiles - v0);
    for (int i = 0; i < n; ++i) {
      const int wv = wsh[i];
      rank += (wv > wu) || (wv == wu && v0 + i < u);
    }
  }
  if (u < num_tiles) order[rank] = u;
}

template <int CV>
__global__ void raster_bwd_kernel(
    const float* __restrict__ rec, int64_t ne_pad,
    const int* __restrict__ starts, const int* __restrict__ counts,
    const int* __restrict__ n_active, const float* __restrict__ log_t,
    const float* __restrict__ d_raw, int grid_w, int tile_h, int tile_w,
    int chunk, const int* __restrict__ order, float* __restrict__ d_out,
    unsigned long long* __restrict__ runs) {
  constexpr int R = GEOM_ROWS + CV;  // staged record rows
  constexpr int G = 6 + CV;          // gradient terms per record
  constexpr int GP = G + 1;          // partial row stride (odd: no conflicts)
  extern __shared__ float smem[];
  const int tile = order[blockIdx.x];  // heaviest tiles first
  const int tid = threadIdx.x;
  const int nthreads = blockDim.x;  // == tile_h * tile_w, a multiple of 32
  const int nwarps = nthreads >> 5;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  float* recs = smem;                          // 2 x R x chunk
  float* boxes = recs + 2 * R * chunk;         // 2 x 4 x chunk
  float* part = boxes + 2 * 4 * chunk;         // nwarps x WORD x GP
  unsigned* touched = reinterpret_cast<unsigned*>(part + nwarps * WORD * GP);

  if (runs != nullptr && blockIdx.x == 0 && tid == 0) atomicAdd(runs, 1ull);
  const int start = starts[tile];
  const int count = counts[tile];
  const int nact = n_active[tile];
  if (count == 0 || nact == 0) return;  // uniform over the block
  const int base = (start / chunk) * chunk;
  const int shift = start - base;

  int lx, ly;
  d3g::pixel_of_thread(tid, tile_h, tile_w, lx, ly);
  const int gx = (tile % grid_w) * tile_w + lx;
  const int gy = (tile / grid_w) * tile_h + ly;
  const float px = (float)gx, py = (float)gy;
  const d3g::Rect rect = d3g::warp_rect(FULL_MASK, gx, gy);

  const int64_t pix = (int64_t)tile * nthreads + ly * tile_w + lx;
  float dacc[CV];
#pragma unroll
  for (int c = 0; c < CV; ++c) dacc[c] = d_raw[pix * CV + c];
  float logt = log_t[pix];
  float suffix = 0.0f;

  const d3g::Stager st = d3g::make_stager(rec, ne_pad, chunk, tid, nthreads);
  // the last active chunk and its boxes, before the walk
  {
    const int64_t col = (int64_t)base + (int64_t)(nact - 1) * chunk;
    float* dst = recs + ((nact - 1) & 1) * R * chunk;
    d3g::stage_chunk<R>(st, dst, rec, ne_pad, col, chunk);
    float* bx = boxes + ((nact - 1) & 1) * 4 * chunk;
    for (int j = tid; j < chunk; j += nthreads)
      d3g::store_box(bx, chunk, j, d3g::table_box(rec + col, ne_pad, j));
  }

  for (int k = nact - 1; k >= 0; --k) {
    d3g::cp_async_wait_all();
    __syncthreads();  // chunk k and its boxes are in; chunk k + 1 is done
    const int64_t col = (int64_t)base + (int64_t)k * chunk;
    const bool next = k > 0;
    if (next)
      d3g::stage_chunk<R>(st, recs + ((k - 1) & 1) * R * chunk, rec, ne_pad,
                          col - chunk, chunk);
    const float* rc = recs + (k & 1) * R * chunk;
    const float* bx = boxes + (k & 1) * 4 * chunk;
    const int lo = max(shift - k * chunk, 0);
    const int hi = min(shift + count - k * chunk, chunk);

    for (int q = (hi - 1) / WORD; q >= lo / WORD; --q) {
      const int j0 = q * WORD;
      const int jj = j0 + lane;
      const bool keep = jj >= lo && jj < hi &&
                        d3g::box_hits(d3g::load_box(bx, chunk, jj), rect);
      unsigned todo = __ballot_sync(FULL_MASK, keep);
      unsigned done = 0u;
      float* my_part = part + warp * WORD * GP;
      // One kept record: the live lanes' terms, summed over the warp into
      // this warp's partials. false when no lane of the warp is live.
      auto walk = [&](const d3g::AlphaCell& cell, int b) {
        const int j = j0 + b;
        const bool live = d3g::alpha_live(cell);
        if (!__any_sync(FULL_MASK, live)) return false;
        float g[8] = {0.0f, 0.0f, 0.0f, 0.0f, 0.0f, 0.0f, 0.0f, 0.0f};
        float w = 0.0f;
        if (live) {
          const float one_m = __fsub_rn(1.0f, cell.alpha);
          logt -= d3g::log2_one_minus(cell.alpha);
          const float T = exp2f(logt);
          w = cell.alpha * T;
          float dw = 0.0f;
#pragma unroll
          for (int c = 0; c < CV; ++c)
            dw += dacc[c] * rc[(GEOM_ROWS + c) * chunk + j];
          // 2 ulp division: the IEEE one costs ~5 % of the kernel
          const float d_alpha = dw * T - __fdividef(suffix, one_m);
          suffix += dw * w;
          const float d_rawv = cell.raw <= d3g::ALPHA_MAX ? d_alpha : 0.0f;
          // alpha = op * 2^power: d alpha / d power = raw * ln 2
          const float d_pow =
              cell.p0 < 0.0f ? d_rawv * cell.raw * d3g::LN2 : 0.0f;
          const float ca = rc[2 * chunk + j];
          const float cb = rc[3 * chunk + j];
          const float cc = rc[4 * chunk + j];
          const float dx = cell.dx, dy = cell.dy;
          g[0] = d_pow * -(ca * dx + cb * dy);
          g[1] = d_pow * -(cc * dy + cb * dx);
          g[2] = d_pow * (-0.5f * dx * dx);
          g[3] = d_pow * (-dx * dy);
          g[4] = d_pow * (-0.5f * dy * dy);
          g[5] = d_rawv * cell.e;
        }
        const int t = (lane >> 2) & 7;
        float* pj = my_part + b * GP;
        {
          const float s = warp_sum8(g, lane);
          if ((lane & 3) == 0 && t < 6) pj[t] = s;
        }
#pragma unroll
        for (int c0 = 0; c0 < CV; c0 += 8) {
          float v[8];
#pragma unroll
          for (int i = 0; i < 8; ++i) v[i] = dacc[c0 + i] * w;
          const float s = warp_sum8(v, lane);
          if ((lane & 3) == 0) pj[6 + c0 + t] = s;
        }
        return true;
      };
      while (todo) {
        const int b = 31 - __clz(todo);
        todo &= ~(1u << b);
        if (walk(d3g::alpha_cell(rc, chunk, j0 + b, px, py), b))
          done |= 1u << b;
      }
      if (lane == 0) touched[warp] = done;
      __syncthreads();  // every warp's partials of this word are in
      unsigned any = 0u;
      for (int wp = 0; wp < nwarps; ++wp) any |= touched[wp];
      if (any) {
        float* dst = d_out + col + j0;
        for (int o = tid; o < G * WORD; o += nthreads) {
          const int r = o / WORD;
          const int i = o - r * WORD;
          if (!((any >> i) & 1u)) continue;
          float s = 0.0f;
          for (int wp = 0; wp < nwarps; ++wp)
            if ((touched[wp] >> i) & 1u) s += part[(wp * WORD + i) * GP + r];
          const int row = r < 6 ? r : GEOM_ROWS + (r - 6);
          dst[(int64_t)row * ne_pad + i] = s;
        }
      }
      __syncthreads();  // the partials are read before the next word
    }

    if (next) {  // the boxes of chunk k - 1 (its copy is in flight)
      float* nb = boxes + ((k - 1) & 1) * 4 * chunk;
      for (int j = tid; j < chunk; j += nthreads)
        d3g::store_box(nb, chunk, j,
                       d3g::table_box(rec + col - chunk, ne_pad, j));
    }
  }
}

template <int CV>
cudaError_t launch(const float* rec, int64_t ne_pad, const int* starts,
                   const int* counts, const int* n_active, const float* log_t,
                   const float* d_raw, int num_tiles, int grid_w, int tile_h,
                   int tile_w, int chunk, int* order, float* d_out,
                   unsigned long long* runs, cudaStream_t stream) {
  constexpr int order_threads = 256;
  tile_order_kernel<<<(num_tiles + order_threads - 1) / order_threads,
                      order_threads, order_threads * sizeof(int), stream>>>(
      starts, counts, n_active, num_tiles, chunk, order);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const int nthreads = tile_h * tile_w;
  const int nwarps = nthreads / 32;
  const size_t smem =
      sizeof(float) * (2 * (size_t)(GEOM_ROWS + CV) * chunk + 2 * 4 * chunk +
                       (size_t)nwarps * WORD * (6 + CV + 1)) +
      sizeof(unsigned) * nwarps;
  err = cudaFuncSetAttribute(
      raster_bwd_kernel<CV>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return err;
  raster_bwd_kernel<CV><<<num_tiles, nthreads, smem, stream>>>(
      rec, ne_pad, starts, counts, n_active, log_t, d_raw, grid_w, tile_h,
      tile_w, chunk, order, d_out, runs);
  return cudaGetLastError();
}

}  // namespace

// Returns a cudaError_t as int (0 = launched). An unsupported value-row
// count, or a tile whose pixel count is not a multiple of 32 in [32, 1024],
// returns cudaErrorInvalidValue without launching; so does a configuration
// whose shared memory exceeds the card's (large tiles at large CV).
// `order` is scratch of num_tiles ints (the tiles heaviest first).
// `runs`, when not null, is a device counter to which each run of the
// kernel adds one (as in raster_fwd.cu).
extern "C" int d3g_raster_bwd(const float* rec, long long ne_pad, int n_rows,
                              const int* starts, const int* counts,
                              const int* n_active, const float* log_t,
                              const float* d_raw, int num_tiles, int grid_w,
                              int tile_h, int tile_w, int chunk, int* order,
                              float* d_out, unsigned long long* runs,
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
                           order, d_out, runs, s);
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
