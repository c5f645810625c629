// Speed-of-light probe of the tile walk (K3) for Hopper (sm_90a).
//
// Replaces tools/bench_vpu_sol.py::build (TPU Pallas kernels `kern_compute`
// with `fused_process`, and `kern_dma`). Input: a feature-major record table
// rec (B, 16, ne) float32, ne = n_chunks * 256, one (16, ne) slice per walk:
//   rows 0..4  = x, y, conic a, b, c (log2 units), rows 6, 7 = the log2-op
//   rows of the fused path (min(p0 + row6, row7)), rows 8..15 = 8 values.
// Output: out (B, 2) float32, the two parts of each walk's scalar (their sum
// is the reference's scalar), so that each can be held on its own.
//
// A walk is the work of one 16x16 tile (pixel (px, py) = (lin % 16,
// lin / 16) of tile 0) over n_chunks blocks of 256 records:
//   compute_only    the fused cell pipeline over the SAME block n_chunks
//                   times (the block is staged once: no memory traffic after)
//   stream_compute  the same pipeline over the walk's n_chunks blocks
//   dma_only        streams every block and sums two 8x128 corners
// Per record and pixel: p0 = -(a dx^2 + c dy^2)/2 - b dx dy, m = min(p0 +
// row6, row7), m = -130 below log2(1/255); alpha = 2^m, l = log2(1 - alpha);
// the running sum of l over the block is the inclusive scan `cum`, w =
// 2^(m + (cum - l) + log2T), acc[0..7] += w * rows 8..15; after each block
// log2T += the block's total. Output [sum(acc), sum(log2T)] over the pixels;
// dma_only gives [sum of the rows 0..7 corner, sum of the rows 8..15 corner].
//
// What bounds the compute variants on an H100. A record is 16 float32 rows,
// 64 bytes, read once per 256 pixels: memory is far from the limit. Per cell
// the pipeline needs ~24 float32 instructions (p0 + row6 and the min 8, the
// gate 2, the scan step 6 with its 3 transcendentals, 8 multiply-adds). So
// three floors: FMA (38 operations per cell at 67 TFLOP/s, 42 ms card-wide,
// `tools/bench_sol.py::work`), SFU (3 per cell at 16 per clock per SM: 53 ms
// at 1.98 GHz) and issue (one warp instruction per clock per scheduler,
// loads and the loop included: ~28 per cell, ~62 ms). The first version
// spent ~60 issue slots per cell: 15 scalar shared-memory loads, the
// accurate exp2f/log2f sequences (range and denormal handling around each
// MUFU op) and every term recomputed per pixel.
//
// Design. One thread block per walk. Each 256-record block is staged into
// shared memory as it lies (feature-major, cp.async, double-buffered: block
// k + 1 is copied in while block k is walked); a thread then reads a row's
// values for 4 consecutive records in one 128-bit broadcast load (15 of them
// per 4 records, not 15 per record). Each thread holds PPT pixels of one
// tile column, so a record's per-column terms (dx, a dx^2, b dx) are
// computed once for all of them, and the pixels' independent chains, with
// the record loop unrolled 4 times (16 records per trip), give the
// schedulers instruction-level parallelism at 4 walks (16 warps) per SM.
// p0 + row6 is rounded step by step as the plain version rounds it (no
// contraction), so that the 1/255 gate falls alike on both sides: a
// factored form (4 instructions per cell instead of 8) put a cell of the
// 528 card-wide walks on the other side of the gate and that walk's acc
// out of its tolerance. The transcendentals are the single MUFU instructions
// ex2.approx.ftz / lg2.approx.ftz: a dead cell's 2^-130 flushes to 0, and
// their errors (2^-22) stay well inside the parts' tolerances. Moving one of
// the three to an FMA-pipe polynomial costs ~11 issue slots to free one MUFU
// op, and loses (`kernel_split.py`). The weight of a cell within a block is
// 2^(m + cum_before), summed per pixel into the block's own accumulators,
// which are scaled by 2^log2T once at the block's end (2^(a + b) = 2^a 2^b:
// log2T enters once per block, not per cell). Every cell of every block runs
// the whole pipeline; the sums over the pixels are fixed-order trees in
// shared memory: deterministic, no atomics.

#include <cuda_runtime.h>
#include <stdint.h>

#include "alpha.cuh"

namespace {

constexpr int P = 256;      // pixels of one 16x16 tile
constexpr int TILE = 16;    // tile side
constexpr int CHUNK = 256;  // records per staged block
constexpr int ROWS = 16;    // 8 geometry + 8 value rows
constexpr int NV = 8;       // value rows
constexpr int VAL_ROW = 8;  // first value row
constexpr float LOG2_ALPHA_EPS = -7.994353436858858f;  // log2(1/255)
constexpr float DEAD_EXP = -130.0f;  // exponent of a cell below the gate

// compute variants: pixels per thread (all in one tile column), threads per
// walk, records per step (one float4 of each row); 4 walks per SM must fit
constexpr int PPT = 2;
constexpr int THREADS = P / PPT;
constexpr int R = 4;
constexpr int WALKS_PER_SM = 4;

enum Kind { COMPUTE_ONLY = 0, DMA_ONLY = 1, STREAM_COMPUTE = 2 };

__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ float lg2(float x) {
  float y;
  asm("lg2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

// Stage the (ROWS, CHUNK) block at `src` (row stride ne) into shared memory.
__device__ __forceinline__ void stage(float* smem, const float* src,
                                      int64_t ne, int tid) {
#pragma unroll
  for (int r = 0; r < ROWS; ++r)
    smem[r * CHUNK + tid] = src[(int64_t)r * ne + tid];
}

// Row values of N consecutive records (N = 4: one 128-bit load).
template <int N>
__device__ __forceinline__ void load_row(const float* p, float (&d)[N]) {
  if constexpr (N == 4) {
    const float4 v = *reinterpret_cast<const float4*>(p);
    d[0] = v.x;
    d[1] = v.y;
    d[2] = v.z;
    d[3] = v.w;
  } else {
#pragma unroll
    for (int i = 0; i < N; ++i) d[i] = p[i];
  }
}

// Sum of v over the block's N threads in a fixed order (a tree in shared
// memory); every thread gets the result.
template <int N = P>
__device__ float block_sum(float v, float* red, int tid) {
  red[tid] = v;
  __syncthreads();
  for (int s = N / 2; s > 0; s >>= 1) {
    if (tid < s) red[tid] += red[tid + s];
    __syncthreads();
  }
  const float r = red[0];
  __syncthreads();
  return r;
}

template <bool RESIDENT>
__global__ void __launch_bounds__(THREADS, WALKS_PER_SM)
    sol_compute_kernel(const float* __restrict__ rec, int64_t ne,
                       int n_chunks, float* __restrict__ out) {
  // two buffers: block k + 1 is copied in while block k is walked
  __shared__ __align__(16) float smem[2][ROWS * CHUNK];
  __shared__ float red[THREADS];
  constexpr int TROWS = TILE / PPT;  // tile rows apart of a thread's pixels
  const int tid = threadIdx.x;
  const float* walk = rec + (int64_t)blockIdx.x * ROWS * ne;
  const float px = (float)(tid % TILE);
  float py[PPT];
#pragma unroll
  for (int i = 0; i < PPT; ++i) py[i] = (float)(tid / TILE + i * TROWS);

  float acc[PPT][NV], log2t[PPT];
#pragma unroll
  for (int i = 0; i < PPT; ++i) {
    log2t[i] = 0.0f;
#pragma unroll
    for (int c = 0; c < NV; ++c) acc[i][c] = 0.0f;
  }

  const d3g::Stager st = d3g::make_stager(walk, ne, CHUNK, tid, THREADS);
  d3g::stage_chunk<ROWS>(st, smem[0], walk, ne, 0, CHUNK);
  for (int k = 0; k < n_chunks; ++k) {
    if (!RESIDENT || k == 0) {
      d3g::cp_async_wait_all();
      __syncthreads();  // block k is in; every thread is done with k - 1
      if (!RESIDENT && k + 1 < n_chunks)  // into the buffer of block k - 1
        d3g::stage_chunk<ROWS>(st, smem[(k + 1) & 1], walk, ne,
                               (int64_t)(k + 1) * CHUNK, CHUNK);
    }
    const float* blk_rec = smem[RESIDENT ? 0 : k & 1];
    // cum: the exclusive running sum of log2(1 - alpha) in this block;
    // blk: the block's sums of 2^(m + cum) * values
    float cum[PPT], blk[PPT][NV];
#pragma unroll
    for (int i = 0; i < PPT; ++i) {
      cum[i] = 0.0f;
#pragma unroll
      for (int c = 0; c < NV; ++c) blk[i][c] = 0.0f;
    }
#pragma unroll 4
    for (int j = 0; j < CHUNK; j += R) {
      float x[R], y[R], a[R], b[R], cc[R], r6[R], r7[R], v[NV][R];
      load_row<R>(blk_rec + 0 * CHUNK + j, x);
      load_row<R>(blk_rec + 1 * CHUNK + j, y);
      load_row<R>(blk_rec + 2 * CHUNK + j, a);
      load_row<R>(blk_rec + 3 * CHUNK + j, b);
      load_row<R>(blk_rec + 4 * CHUNK + j, cc);
      load_row<R>(blk_rec + 6 * CHUNK + j, r6);
      load_row<R>(blk_rec + 7 * CHUNK + j, r7);
#pragma unroll
      for (int c = 0; c < NV; ++c)
        load_row<R>(blk_rec + (VAL_ROW + c) * CHUNK + j, v[c]);
#pragma unroll
      for (int q = 0; q < R; ++q) {
        // per record and column: dx, a dx^2, b dx
        const float dx = __fsub_rn(x[q], px);
        const float adx2 = __fmul_rn(__fmul_rn(a[q], dx), dx);
        const float bdx = __fmul_rn(b[q], dx);
#pragma unroll
        for (int i = 0; i < PPT; ++i) {
          const float dy = __fsub_rn(y[q], py[i]);
          const float s = __fadd_rn(adx2, __fmul_rn(__fmul_rn(cc[q], dy), dy));
          // -s/2 is exact, so the fma rounds as (-s/2) - b dx dy does
          const float p0 = fmaf(-0.5f, s, -__fmul_rn(bdx, dy));
          float m = fminf(__fadd_rn(p0, r6[q]), r7[q]);
          m = m >= LOG2_ALPHA_EPS ? m : DEAD_EXP;
          const float lg = lg2(1.0f - ex2(m));
          const float w = ex2(m + cum[i]);
          cum[i] += lg;
#pragma unroll
          for (int c = 0; c < NV; ++c) blk[i][c] = fmaf(w, v[c][q], blk[i][c]);
        }
      }
    }
#pragma unroll
    for (int i = 0; i < PPT; ++i) {
      const float t0 = ex2(log2t[i]);  // 1 in the first block
#pragma unroll
      for (int c = 0; c < NV; ++c) acc[i][c] = fmaf(t0, blk[i][c], acc[i][c]);
      log2t[i] += cum[i];
    }
  }

  float s = 0.0f, lt = 0.0f;
#pragma unroll
  for (int i = 0; i < PPT; ++i) {
    lt += log2t[i];
#pragma unroll
    for (int c = 0; c < NV; ++c) s += acc[i][c];
  }
  const float total_acc = block_sum<THREADS>(s, red, tid);
  const float total_logt = block_sum<THREADS>(lt, red, tid);
  if (tid == 0) {
    out[2 * blockIdx.x] = total_acc;
    out[2 * blockIdx.x + 1] = total_logt;
  }
}

// dma_only: element e = q * P + tid (q < 4) of each (8, 128) accumulator is
// row e / 128, column e % 128; acc_g sums the rows 0..7 corner, acc_v the
// rows 8..15 corner.
__global__ void __launch_bounds__(P)
    sol_dma_kernel(const float* __restrict__ rec, int64_t ne, int n_chunks,
                   float* __restrict__ out) {
  __shared__ float smem[ROWS * CHUNK];
  __shared__ float red[P];
  const int tid = threadIdx.x;
  const float* walk = rec + (int64_t)blockIdx.x * ROWS * ne;
  float acc_g[4] = {0.0f, 0.0f, 0.0f, 0.0f};
  float acc_v[4] = {0.0f, 0.0f, 0.0f, 0.0f};
  for (int k = 0; k < n_chunks; ++k) {
    if (k > 0) __syncthreads();
    stage(smem, walk + (int64_t)k * CHUNK, ne, tid);
    __syncthreads();
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      const int e = q * P + tid;
      const int r = e / 128;
      const int c = e % 128;
      acc_g[q] += smem[r * CHUNK + c];
      acc_v[q] += smem[(VAL_ROW + r) * CHUNK + 128 + c];
    }
  }
  const float total_g =
      block_sum((acc_g[0] + acc_g[1]) + (acc_g[2] + acc_g[3]), red, tid);
  const float total_v =
      block_sum((acc_v[0] + acc_v[1]) + (acc_v[2] + acc_v[3]), red, tid);
  if (tid == 0) {
    out[2 * blockIdx.x] = total_g;
    out[2 * blockIdx.x + 1] = total_v;
  }
}

}  // namespace

// Returns a cudaError_t as int (0 = launched). A table width that is not a
// positive multiple of 256 or an unknown kind returns cudaErrorInvalidValue
// without launching.
extern "C" int d3g_sol_probe(const float* rec, long long ne, int n_walks,
                             int kind, float* out, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (ne <= 0 || ne % CHUNK != 0 || n_walks <= 0)
    return (int)cudaErrorInvalidValue;
  const int n_chunks = (int)(ne / CHUNK);
  switch (kind) {
    case COMPUTE_ONLY:
      sol_compute_kernel<true><<<n_walks, THREADS, 0, s>>>(rec, ne, n_chunks,
                                                           out);
      break;
    case STREAM_COMPUTE:
      sol_compute_kernel<false><<<n_walks, THREADS, 0, s>>>(rec, ne,
                                                            n_chunks, out);
      break;
    case DMA_ONLY:
      sol_dma_kernel<<<n_walks, P, 0, s>>>(rec, ne, n_chunks, out);
      break;
    default:
      return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}
