// Pair emission kernel (E1) for Hopper (sm_90a).
//
// Replaces the emission of dynamic3dgaussians_tpu/ops/binning.py
// ::emit_pairs, which the JAX package leaves to XLA (it has no Pallas
// kernel): each gaussian's tile rect (tx0, ty0, tx1, ty1, count, from
// ops/projection.py::tile_rect) becomes K = max_tiles_per_gaussian emission
// slots of int32 tile keys in the k-major layout key[k * N + gaussian], the
// sentinel num_tiles in an unused slot, and the int32 count n_dropped_rect.
//
//  * Exact cull (emit_cull_kernel; opacity given and enum_cap > K): rect
//    cells c = 0 .. min(count, enum_cap) - 1 in rect order (ty = ty0 + c /
//    rw, tx = tx0 + c % rw) are tested with the alpha bound op *
//    exp(-lam_min |d|^2 / 2) >= 1/255 * 0.999 over the cell's pixel box;
//    the r-th passing cell takes slot r while r < K. Per gaussian the drop
//    count is max(passing - K, 0) + min(max(count - enum_cap, 0), passable),
//    passable the cells of the alpha-reach square of half side dmax.
//  * No cull (emit_rect_kernel): slot k < min(count, K) takes rect cell k;
//    the drops are count - min(count, K).
//
// The plain version (ops/binning.py::emit_pairs) computes the cull with
// PyTorch's elementwise ops, which round after every operation, and rank-
// compacts with a cumsum and one where + sum over the (enum_cap, N) cell
// grid per slot: K passes over enum_cap x N cells. Here one thread walks
// its gaussian's cells once and writes slot r at its r-th passing cell.
// The keys are bitwise the plain version's on the same card: every float
// operation of the bound and of dmax is written in the plain version's
// order with explicitly rounded intrinsics (no FMA contraction), with
// expf, logf and IEEE sqrt and division as PyTorch's CUDA ops use them (no
// fast math), with NaN propagated as torch.maximum and torch.clamp do, and
// with PyTorch's CUDA handling of Python scalars: a tensor divided by a
// Python scalar is multiplied by its float32 reciprocal, and every other
// scalar is rounded to float32 first. The wrapper passes those float32
// constants (ops/cuda/emit.py).
//
// Design: one thread per gaussian. The rank compaction is sequential per
// gaussian, and a thread keeps its running rank in a register; in the
// k-major layout the writes of neighbouring gaussians to the same slot are
// neighbouring words. Trip counts vary with the rect (0 to enum_cap
// cells); a warp per gaussian (ballot + popc ranks) would balance large
// rects but stride its slot writes by N. Every slot is written, the
// sentinel included, so no fill runs before it. The drop terms are summed
// per warp and added with one int32 atomic per warp (modular, as the plain
// version's int64 sum cast to int32).
//
// What bounds it on an H100: device memory for the slots (K x N x 4 bytes
// written, 10 x N x 4 read), 0.071 ms at K = 64, N = 800,768; the tested
// cells (up to enum_cap per gaussian, ~17 float32 operations with an expf
// each) stay under that at the card's float32 rate. Measured on an H100
// 80GB HBM3 at 700 W (chip_smoke.py, emit_vs_plain): 0.244 ms there, 3.5x
// the bound (the dead capacity rows each walk 128 cells, most gaussians a
// few), and 0.022 ms at the bench view's K = 8.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int BLOCK = 256;
constexpr unsigned FULL_MASK = 0xffffffffu;

// The float32 constants of the plain version's Python scalars, as PyTorch
// rounds them on the card.
struct CullConsts {
  float gate;       // ALPHA_EPS * 0.999 (the cull's gate)
  float inv_gate;   // 1 / gate (safe_op / gate is safe_op * inv_gate)
  float eps;        // ALPHA_EPS (the opacity floor of dmax)
  float lam_floor;  // 1e-12
  float dmax_cap;   // (grid_w + 1) * tile_w + (grid_h + 1) * tile_h
  float inv_tile_w; // 1 / tile_w
  float inv_tile_h; // 1 / tile_h
};

// torch.clamp(v, min=lo) / torch.clamp(v, max=hi): NaN passes through
__device__ __forceinline__ float clamp_min(float v, float lo) {
  return isnan(v) ? v : fmaxf(v, lo);
}
__device__ __forceinline__ float clamp_max(float v, float hi) {
  return isnan(v) ? v : fminf(v, hi);
}
// torch.maximum: NaN if either is NaN
__device__ __forceinline__ float maximum(float a, float b) {
  if (isnan(a)) return a;
  if (isnan(b)) return b;
  return fmaxf(a, b);
}

// Adds each lane's `v` to *total, one atomic per warp. Every lane of the
// warp must call it.
__device__ __forceinline__ void add_drops(int v, int* total) {
  const unsigned sum = __reduce_add_sync(FULL_MASK, (unsigned)v);
  if ((threadIdx.x & 31) == 0 && sum != 0u) atomicAdd(total, (int)sum);
}

__global__ void __launch_bounds__(BLOCK)
emit_cull_kernel(const float* __restrict__ x2d, const float* __restrict__ y2d,
                 const float* __restrict__ conic_a,
                 const float* __restrict__ conic_b,
                 const float* __restrict__ conic_c,
                 const float* __restrict__ opacity,
                 const int* __restrict__ tx0s, const int* __restrict__ ty0s,
                 const int* __restrict__ tx1s, const int* __restrict__ raws,
                 int n, int k_cap, int enum_cap, int tile_h, int tile_w,
                 int grid_w, int num_tiles, CullConsts k,
                 int* __restrict__ key, int* __restrict__ dropped,
                 unsigned long long* __restrict__ runs) {
  if (runs != nullptr && blockIdx.x == 0 && threadIdx.x == 0)
    atomicAdd(runs, 1ull);
  const int g = blockIdx.x * BLOCK + threadIdx.x;
  int drops = 0;
  if (g < n) {
    const float a = conic_a[g], b = conic_b[g], c = conic_c[g];
    const float x = x2d[g], y = y2d[g], op = opacity[g];
    const int tx0 = tx0s[g], ty0 = ty0s[g], raw = raws[g];
    const int rw = max(tx1s[g] - tx0, 1);
    // lam_min = clamp(mid - sqrt(dif^2 + b^2), min=0)
    const float mid = __fmul_rn(0.5f, __fadd_rn(a, c));
    const float dif = __fmul_rn(0.5f, __fsub_rn(a, c));
    const float lam = clamp_min(
        __fsub_rn(mid, __fsqrt_rn(__fadd_rn(__fmul_rn(dif, dif),
                                            __fmul_rn(b, b)))),
        0.0f);
    const float neg_half_lam = __fmul_rn(-0.5f, lam);
    const float edge_w = (float)(tile_w - 1), edge_h = (float)(tile_h - 1);
    const int cells = min(raw, enum_cap);
    int rank = 0;
    int tx = tx0, ty = ty0;
    for (int cell = 0; cell < cells; ++cell) {
      const float bx0 = (float)(tx * tile_w);
      const float by0 = (float)(ty * tile_h);
      const float ddx = clamp_min(
          maximum(__fsub_rn(bx0, x), __fsub_rn(x, __fadd_rn(bx0, edge_w))),
          0.0f);
      const float ddy = clamp_min(
          maximum(__fsub_rn(by0, y), __fsub_rn(y, __fadd_rn(by0, edge_h))),
          0.0f);
      const float d2 = __fadd_rn(__fmul_rn(ddx, ddx), __fmul_rn(ddy, ddy));
      const float bound = __fmul_rn(op, expf(__fmul_rn(neg_half_lam, d2)));
      if (bound >= k.gate) {
        if (rank < k_cap) key[(int64_t)rank * n + g] = ty * grid_w + tx;
        ++rank;
      }
      if (++tx == tx0 + rw) {
        tx = tx0;
        ++ty;
      }
    }
    for (int s = min(rank, k_cap); s < k_cap; ++s)
      key[(int64_t)s * n + g] = num_tiles;
    // passable: the rect cells within the alpha reach dmax of the center
    const float safe_op = clamp_min(op, k.eps);
    float dmax = __fsqrt_rn(__fdiv_rn(
        __fmul_rn(2.0f, logf(__fmul_rn(safe_op, k.inv_gate))),
        clamp_min(lam, k.lam_floor)));
    dmax = clamp_max(dmax, k.dmax_cap);
    const float nx = __fadd_rn(
        __fsub_rn(floorf(__fmul_rn(__fadd_rn(x, dmax), k.inv_tile_w)),
                  floorf(__fmul_rn(__fsub_rn(x, dmax), k.inv_tile_w))),
        1.0f);
    const float ny = __fadd_rn(
        __fsub_rn(floorf(__fmul_rn(__fadd_rn(y, dmax), k.inv_tile_h)),
                  floorf(__fmul_rn(__fsub_rn(y, dmax), k.inv_tile_h))),
        1.0f);
    // float -> int32 as PyTorch's cast on the card: round toward zero,
    // saturating, NaN to 0
    const int passable = __float2int_rz(__fmul_rn(nx, ny));
    const int beyond = min(max(raw - enum_cap, 0), passable);
    drops = max(rank - k_cap, 0) + beyond;
  }
  add_drops(drops, dropped);
}

__global__ void __launch_bounds__(BLOCK)
emit_rect_kernel(const int* __restrict__ tx0s, const int* __restrict__ ty0s,
                 const int* __restrict__ tx1s, const int* __restrict__ raws,
                 int n, int k_cap, int grid_w, int num_tiles,
                 int* __restrict__ key, int* __restrict__ dropped,
                 unsigned long long* __restrict__ runs) {
  if (runs != nullptr && blockIdx.x == 0 && threadIdx.x == 0)
    atomicAdd(runs, 1ull);
  const int g = blockIdx.x * BLOCK + threadIdx.x;
  int drops = 0;
  if (g < n) {
    const int tx0 = tx0s[g], ty0 = ty0s[g], raw = raws[g];
    const int rw = max(tx1s[g] - tx0, 1);
    const int count = min(raw, k_cap);
    int tx = tx0, ty = ty0;
    for (int s = 0; s < k_cap; ++s) {
      key[(int64_t)s * n + g] = s < count ? ty * grid_w + tx : num_tiles;
      if (++tx == tx0 + rw) {
        tx = tx0;
        ++ty;
      }
    }
    drops = raw - count;
  }
  add_drops(drops, dropped);
}

}  // namespace

// Returns a cudaError_t as int (0 = launched). `cull` != 0 runs the exact
// cull over enum_cap rect cells (x2d .. opacity and the constants are read
// only then). key: (k_cap * n) int32, every slot written; dropped: one
// int32, to which the drops are ADDED (the caller zeroes it). `runs`, when
// not null, is a device counter to which each run of the kernel adds one
// (its first thread, with an atomic), eager or replayed from a CUDA graph.
extern "C" int d3g_emit_pairs(
    const float* x2d, const float* y2d, const float* conic_a,
    const float* conic_b, const float* conic_c, const float* opacity,
    const int* tx0, const int* ty0, const int* tx1, const int* raw, int n,
    int k_cap, int cull, int enum_cap, int tile_h, int tile_w, int grid_w,
    int num_tiles, float gate, float inv_gate, float eps, float lam_floor,
    float dmax_cap, float inv_tile_w, float inv_tile_h, int* key,
    int* dropped, unsigned long long* runs, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (n <= 0 || k_cap <= 0) return (int)cudaErrorInvalidValue;
  const int blocks = (n + BLOCK - 1) / BLOCK;
  if (cull) {
    const CullConsts k{gate, inv_gate, eps, lam_floor, dmax_cap, inv_tile_w,
                       inv_tile_h};
    emit_cull_kernel<<<blocks, BLOCK, 0, s>>>(
        x2d, y2d, conic_a, conic_b, conic_c, opacity, tx0, ty0, tx1, raw, n,
        k_cap, enum_cap, tile_h, tile_w, grid_w, num_tiles, k, key, dropped,
        runs);
  } else {
    emit_rect_kernel<<<blocks, BLOCK, 0, s>>>(tx0, ty0, tx1, raw, n, k_cap,
                                              grid_w, num_tiles, key,
                                              dropped, runs);
  }
  return (int)cudaGetLastError();
}

// expf (fn 0), logf (fn 1) or IEEE sqrt (fn 2) of n floats, as E1's cull
// evaluates them: held against torch.exp / torch.log / torch.sqrt on the
// card (chip_smoke.py), which the cull must agree with bitwise.
__global__ void emit_math_kernel(const float* __restrict__ in, int64_t n,
                                 int fn, float* __restrict__ out) {
  const int64_t i = (int64_t)blockIdx.x * BLOCK + threadIdx.x;
  if (i >= n) return;
  const float v = in[i];
  out[i] = fn == 0 ? expf(v) : fn == 1 ? logf(v) : __fsqrt_rn(v);
}

extern "C" int d3g_emit_math(const float* in, long long n, int fn,
                             float* out, void* stream) {
  if (n <= 0 || fn < 0 || fn > 2) return (int)cudaErrorInvalidValue;
  const long long blocks = (n + BLOCK - 1) / BLOCK;
  emit_math_kernel<<<(unsigned)blocks, BLOCK, 0,
                     static_cast<cudaStream_t>(stream)>>>(in, n, fn, out);
  return (int)cudaGetLastError();
}
