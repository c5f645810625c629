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
// Design: one thread block per walk, one thread per pixel (256). Each block
// of records is staged into shared memory with coalesced row loads (256
// threads read 256 neighbouring floats of a row), then every thread runs the
// pipeline for its pixel sequentially over the block's records, which all
// threads read at the same address (a shared-memory broadcast). The sums over
// the pixels are fixed-order trees in shared memory: deterministic, no
// atomics.
//
// What bounds it on an H100: operations for the compute variants (38 float32
// operations and 3 SFU transcendentals per cell against 16 bytes per record
// read once per 256 pixels), bytes for dma_only. One walk occupies one SM of
// 132, so only a batch of walks (B a multiple of the SM count, each with its
// own slice of a table larger than the 50 MB L2) measures the card. This
// first version stages synchronously (no cp.async/TMA double buffering) and
// does not split the transcendentals between the SFU and the FMA pipes.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int P = 256;      // pixels of one 16x16 tile, one thread each
constexpr int CHUNK = 256;  // records per staged block
constexpr int ROWS = 16;    // 8 geometry + 8 value rows
constexpr int NV = 8;       // value rows
constexpr int VAL_ROW = 8;  // first value row
constexpr float LOG2_ALPHA_EPS = -7.994353436858858f;  // log2(1/255)
constexpr float DEAD_EXP = -130.0f;  // exponent of a cell below the gate

enum Kind { COMPUTE_ONLY = 0, DMA_ONLY = 1, STREAM_COMPUTE = 2 };

// Stage the (ROWS, CHUNK) block at `src` (row stride ne) into shared memory.
__device__ __forceinline__ void stage(float* smem, const float* src,
                                      int64_t ne, int tid) {
#pragma unroll
  for (int r = 0; r < ROWS; ++r)
    smem[r * CHUNK + tid] = src[(int64_t)r * ne + tid];
}

// Sum of v over the block's P threads in a fixed order (a tree in shared
// memory); every thread gets the result.
__device__ float block_sum(float v, float* red, int tid) {
  red[tid] = v;
  __syncthreads();
  for (int s = P / 2; s > 0; s >>= 1) {
    if (tid < s) red[tid] += red[tid + s];
    __syncthreads();
  }
  const float r = red[0];
  __syncthreads();
  return r;
}

template <bool RESIDENT>
__global__ void __launch_bounds__(P)
    sol_compute_kernel(const float* __restrict__ rec, int64_t ne,
                       int n_chunks, float* __restrict__ out) {
  __shared__ float smem[ROWS * CHUNK];
  __shared__ float red[P];
  const int tid = threadIdx.x;
  const float* walk = rec + (int64_t)blockIdx.x * ROWS * ne;
  const float px = (float)(tid % 16);
  const float py = (float)(tid / 16);

  float acc[NV];
#pragma unroll
  for (int c = 0; c < NV; ++c) acc[c] = 0.0f;
  float log2t = 0.0f;

  for (int k = 0; k < n_chunks; ++k) {
    if (!RESIDENT || k == 0) {
      if (k > 0) __syncthreads();  // every thread is done with block k - 1
      stage(smem, walk + (RESIDENT ? 0 : (int64_t)k * CHUNK), ne, tid);
      __syncthreads();
    }
    float cum = 0.0f;  // inclusive running sum of log2(1 - alpha)
#pragma unroll 4
    for (int j = 0; j < CHUNK; ++j) {
      const float dx = smem[0 * CHUNK + j] - px;
      const float dy = smem[1 * CHUNK + j] - py;
      const float p0 = -0.5f * (smem[2 * CHUNK + j] * dx * dx +
                                smem[4 * CHUNK + j] * dy * dy) -
                       smem[3 * CHUNK + j] * dx * dy;
      float m = fminf(p0 + smem[6 * CHUNK + j], smem[7 * CHUNK + j]);
      m = m >= LOG2_ALPHA_EPS ? m : DEAD_EXP;
      const float lg = log2f(1.0f - exp2f(m));
      cum += lg;
      const float w = exp2f((m + (cum - lg)) + log2t);
#pragma unroll
      for (int c = 0; c < NV; ++c)
        acc[c] = fmaf(w, smem[(VAL_ROW + c) * CHUNK + j], acc[c]);
    }
    log2t += cum;
  }

  float s = 0.0f;
#pragma unroll
  for (int c = 0; c < NV; ++c) s += acc[c];
  const float total_acc = block_sum(s, red, tid);
  const float total_logt = block_sum(log2t, red, tid);
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
      sol_compute_kernel<true><<<n_walks, P, 0, s>>>(rec, ne, n_chunks, out);
      break;
    case STREAM_COMPUTE:
      sol_compute_kernel<false><<<n_walks, P, 0, s>>>(rec, ne, n_chunks, out);
      break;
    case DMA_ONLY:
      sol_dma_kernel<<<n_walks, P, 0, s>>>(rec, ne, n_chunks, out);
      break;
    default:
      return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}
