// Pair emission kernel (E1) for Hopper (sm_90a).
//
// Replaces the emission of dynamic3dgaussians_tpu/ops/binning.py
// ::emit_pairs, which the JAX package leaves to XLA (it has no Pallas
// kernel), and the compaction of its K-slot keys that every sorted-pair
// path runs next. The reference gives each gaussian K =
// max_tiles_per_gaussian emission slots (slot = k * N + gaussian, k-major)
// holding tile keys or the sentinel; E1 writes only the live pairs, each
// with its tile key and its slot, compacted in slot order (the order of
// torch.nonzero over the K-slot keys), the live count and n_dropped_rect.
//
//  * Rect (ops/projection.py::tile_rect, fused): tx0 = clamp(floor((x - r)
//    / tile_w), 0, grid_w), tx1 = clamp(floor((x + r) / tile_w) + 1, 0,
//    grid_w), the same in y, count = (tx1 - tx0)(ty1 - ty0) if valid else 0.
//  * Exact cull (opacity given and enum_cap > K): rect cells c = 0 ..
//    min(count, enum_cap) - 1 in rect order (ty = ty0 + c / rw, tx = tx0 +
//    c % rw) are tested with the alpha bound op * exp(-lam_min |d|^2 / 2) >=
//    1/255 * 0.999 over the cell's pixel box; gaussian g's pairs are its
//    first n(g) = min(passing, K) passing cells, the r-th in slot r. The
//    drops per gaussian are max(passing - K, 0) + min(max(count - enum_cap,
//    0), passable), passable the cells of the alpha-reach square of half
//    side dmax.
//  * No cull: the first n(g) = min(count, K) rect cells; drops count - n(g).
//
// The pair (g, k), k < n(g), goes to offset sum_{k' < k} #{g' : n(g') > k'}
// + #{g' < g : n(g') > k}. Three launches:
//  1. count (one thread per gaussian, BLOCK a block): the rect, the walk
//     that counts passing cells, n(g) as uint16, the drop terms, and per
//     block b and slot k the count #{g in b : n(g) > k} (warp ballots),
//     into a k-major (K + 1, blocks) matrix whose last row is the block's
//     drops;
//  2. scan: one block per row, the exclusive prefix over blocks in place
//     and the row's total;
//  3. write: each block takes its slot bases (a warp scan of the totals
//     plus its own row prefixes) and, from per-warp ballots of n(g) > k,
//     each gaussian's rank among the block's gaussians with a k-th pair;
//     then the walk again, each passing cell written to its offset while
//     its rank is below n(g). With a capacity only the first `cap` pairs
//     are written and the columns past the live count get the sentinel tile
//     and the sink slot K * N. Block 0 writes [live, past the capacity] and
//     the drops (the drops row's total, modular as the plain version's
//     int64 sum cast to int32), and counts the run.
// No host read: the eager wrapper reads the totals between 2 and 3 to size
// the output; a captured step passes its capacity.
//
// The keys are bitwise the plain version's on the same card: every float
// operation of the rect, the bound and dmax is written in the plain
// version's order with explicitly rounded intrinsics (no FMA contraction),
// with expf, logf and IEEE sqrt and division as PyTorch's CUDA ops use
// them (no fast math), with NaN passed as torch.maximum and torch.clamp
// pass it, and with PyTorch's CUDA handling of Python scalars: a tensor
// divided by a Python scalar is multiplied by its float32 reciprocal, and
// every other scalar is rounded to float32 first. The wrapper passes those
// float32 constants (ops/cuda/emit.py).
//
// Design for the H100. The function's bytes are its inputs once (29 B a
// gaussian with the cull) and 8 B a live pair: at K = 64 on the bench
// training's 800,768 rows ~24 MB, 0.0073 ms at 3.35 TB/s, where the K-slot
// form wrote 205 MB of slots. The walk is the rest:
//  * a gaussian with !(op >= gate) (NaN included) has no passing cell
//    (exp of a non-positive argument is at most 1, so the bound is at most
//    op, or NaN): its walk is skipped, its drop terms still computed. The
//    trainers' dead capacity rows are such rows.
//  * the live walks are 1 to enum_cap cells: a rect of at most SOLO
//    tested cells is walked by its own lane, a larger one by the whole
//    warp, 32 cells a step, ranks from a ballot and popc. A warp's time is
//    then its longest small rect plus ceil(cells / 32) steps per large one.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int BLOCK = 256;        // gaussians per block of passes 1 and 3
constexpr int WARPS = BLOCK / 32;
constexpr int SCAN_THREADS = 1024;
constexpr int MAX_K = 512;        // pass 3's shared memory: 17 K words
constexpr int SOLO = 16;          // the largest walk a lane makes alone
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

struct Inputs {
  const float* x2d;
  const float* y2d;
  const int* radius;
  const unsigned char* valid;   // torch.bool
  const float* conic_a;         // the cull's inputs (null without it)
  const float* conic_b;
  const float* conic_c;
  const float* opacity;
  int n, k_cap, enum_cap, tile_h, tile_w, grid_h, grid_w, num_tiles;
  CullConsts k;
};

// One gaussian's walk: its rect and the cells it walks (tested with the
// cull, emitted without).
struct Gauss {
  float x, y, op, nhl;   // centre, opacity, -lam_min / 2
  int tx0, ty0, rw;      // rect origin and width (at least 1)
  int cells;             // cells to walk (0: none)
};

// torch.clamp(v, min=lo) / torch.clamp(v, max=hi) / torch.clamp(v, lo,
// hi): NaN passes through
__device__ __forceinline__ float clamp_min(float v, float lo) {
  return isnan(v) ? v : fmaxf(v, lo);
}
__device__ __forceinline__ float clamp_max(float v, float hi) {
  return isnan(v) ? v : fminf(v, hi);
}
__device__ __forceinline__ float clamp_both(float v, float lo, float hi) {
  return isnan(v) ? v : fminf(fmaxf(v, lo), hi);
}
// torch.maximum: NaN if either is NaN
__device__ __forceinline__ float maximum(float a, float b) {
  if (isnan(a)) return a;
  if (isnan(b)) return b;
  return fmaxf(a, b);
}
// float -> int32 as PyTorch's cast on the card: round toward zero,
// saturating, NaN to 0
__device__ __forceinline__ int to_i32(float v) { return __float2int_rz(v); }

// tile_rect of gaussian g: (tx0, ty0, width, raw count)
__device__ __forceinline__ void tile_rect(const Inputs& in, int g, float x,
                                          float y, int& tx0, int& ty0,
                                          int& rw, int& raw) {
  const float r = __int2float_rn(in.radius[g]);
  const float gw = (float)in.grid_w, gh = (float)in.grid_h;
  const float iw = in.k.inv_tile_w, ih = in.k.inv_tile_h;
  tx0 = to_i32(clamp_both(floorf(__fmul_rn(__fsub_rn(x, r), iw)), 0.0f, gw));
  ty0 = to_i32(clamp_both(floorf(__fmul_rn(__fsub_rn(y, r), ih)), 0.0f, gh));
  const int tx1 = to_i32(clamp_both(
      __fadd_rn(floorf(__fmul_rn(__fadd_rn(x, r), iw)), 1.0f), 0.0f, gw));
  const int ty1 = to_i32(clamp_both(
      __fadd_rn(floorf(__fmul_rn(__fadd_rn(y, r), ih)), 1.0f), 0.0f, gh));
  raw = in.valid[g] ? (tx1 - tx0) * (ty1 - ty0) : 0;
  rw = max(tx1 - tx0, 1);
}

// lam_min = clamp(mid - sqrt(dif^2 + b^2), min=0)
__device__ __forceinline__ float lam_min(float a, float b, float c) {
  const float mid = __fmul_rn(0.5f, __fadd_rn(a, c));
  const float dif = __fmul_rn(0.5f, __fsub_rn(a, c));
  return clamp_min(
      __fsub_rn(mid, __fsqrt_rn(__fadd_rn(__fmul_rn(dif, dif),
                                          __fmul_rn(b, b)))),
      0.0f);
}

// Gaussian g's walk; raw its rect count, lam its lam_min (cull only).
template <bool CULL>
__device__ __forceinline__ Gauss load_gauss(const Inputs& in, int g,
                                            int& raw, float& lam) {
  Gauss q;
  q.x = in.x2d[g];
  q.y = in.y2d[g];
  tile_rect(in, g, q.x, q.y, q.tx0, q.ty0, q.rw, raw);
  if (CULL) {
    q.op = in.opacity[g];
    lam = lam_min(in.conic_a[g], in.conic_b[g], in.conic_c[g]);
    q.nhl = __fmul_rn(-0.5f, lam);
    // no cell of a row with !(op >= gate) can pass: skip its walk
    q.cells = q.op >= in.k.gate ? max(min(raw, in.enum_cap), 0) : 0;
  } else {
    q.op = q.nhl = lam = 0.0f;
    q.cells = max(min(raw, in.k_cap), 0);
  }
  return q;
}

__device__ __forceinline__ Gauss no_gauss() {
  Gauss q;
  q.x = q.y = q.op = q.nhl = 0.0f;
  q.tx0 = q.ty0 = q.cells = 0;
  q.rw = 1;
  return q;
}

__device__ __forceinline__ Gauss shfl_gauss(const Gauss& q, int src) {
  Gauss p;
  p.x = __shfl_sync(FULL_MASK, q.x, src);
  p.y = __shfl_sync(FULL_MASK, q.y, src);
  p.op = __shfl_sync(FULL_MASK, q.op, src);
  p.nhl = __shfl_sync(FULL_MASK, q.nhl, src);
  p.tx0 = __shfl_sync(FULL_MASK, q.tx0, src);
  p.ty0 = __shfl_sync(FULL_MASK, q.ty0, src);
  p.rw = __shfl_sync(FULL_MASK, q.rw, src);
  p.cells = __shfl_sync(FULL_MASK, q.cells, src);
  return p;
}

// The exact cull of one cell: the alpha bound over its pixel box against
// the gate, in the plain version's operations and order.
__device__ __forceinline__ bool cell_passes(const Inputs& in, const Gauss& q,
                                            int tx, int ty) {
  const float bx0 = (float)(tx * in.tile_w);
  const float by0 = (float)(ty * in.tile_h);
  const float edge_w = (float)(in.tile_w - 1);
  const float edge_h = (float)(in.tile_h - 1);
  const float ddx = clamp_min(
      maximum(__fsub_rn(bx0, q.x), __fsub_rn(q.x, __fadd_rn(bx0, edge_w))),
      0.0f);
  const float ddy = clamp_min(
      maximum(__fsub_rn(by0, q.y), __fsub_rn(q.y, __fadd_rn(by0, edge_h))),
      0.0f);
  const float d2 = __fadd_rn(__fmul_rn(ddx, ddx), __fmul_rn(ddy, ddy));
  const float bound = __fmul_rn(q.op, expf(__fmul_rn(q.nhl, d2)));
  return bound >= in.k.gate;
}

// Passing cells of each lane's gaussian (all of them: the drops need the
// count past K). Every lane of the warp must call it.
__device__ int count_passing(const Inputs& in, const Gauss& q) {
  const int lane = threadIdx.x & 31;
  const bool big = q.cells > SOLO;
  int passing = 0;
  if (!big) {
    int tx = q.tx0, ty = q.ty0;
    for (int c = 0; c < q.cells; ++c) {
      passing += cell_passes(in, q, tx, ty) ? 1 : 0;
      if (++tx == q.tx0 + q.rw) {
        tx = q.tx0;
        ++ty;
      }
    }
  }
  unsigned bigs = __ballot_sync(FULL_MASK, big);
  while (bigs) {
    const int src = __ffs(bigs) - 1;
    bigs &= bigs - 1;
    const Gauss p = shfl_gauss(q, src);
    int got = 0;
    for (int base = 0; base < p.cells; base += 32) {
      const int c = base + lane;
      const bool ok = c < p.cells &&
                      cell_passes(in, p, p.tx0 + c % p.rw, p.ty0 + c / p.rw);
      got += __popc(__ballot_sync(FULL_MASK, ok));
    }
    if (lane == src) passing = got;
  }
  return passing;
}

// Pass 1: n(g), the drop terms and the block's per-slot counts.
template <bool CULL>
__global__ void __launch_bounds__(BLOCK)
emit_count_kernel(Inputs in, unsigned short* __restrict__ n_out,
                  int* __restrict__ cnt, int nb) {
  extern __shared__ int s_cnt[];   // k_cap
  __shared__ unsigned s_drops;
  const int lane = threadIdx.x & 31;
  const int k_cap = in.k_cap;
  for (int k = threadIdx.x; k < k_cap; k += BLOCK) s_cnt[k] = 0;
  if (threadIdx.x == 0) s_drops = 0u;
  __syncthreads();

  const int g = blockIdx.x * BLOCK + threadIdx.x;
  int raw = 0;
  float lam = 0.0f;
  const Gauss q = g < in.n ? load_gauss<CULL>(in, g, raw, lam) : no_gauss();
  int ng = 0;
  unsigned drops = 0u;
  if (CULL) {
    const int passing = count_passing(in, q);
    if (g < in.n) {
      ng = min(passing, k_cap);
      // passable: the rect cells within the alpha reach dmax of the center
      const float safe_op = clamp_min(q.op, in.k.eps);
      float dmax = __fsqrt_rn(__fdiv_rn(
          __fmul_rn(2.0f, logf(__fmul_rn(safe_op, in.k.inv_gate))),
          clamp_min(lam, in.k.lam_floor)));
      dmax = clamp_max(dmax, in.k.dmax_cap);
      const float iw = in.k.inv_tile_w, ih = in.k.inv_tile_h;
      const float nx = __fadd_rn(
          __fsub_rn(floorf(__fmul_rn(__fadd_rn(q.x, dmax), iw)),
                    floorf(__fmul_rn(__fsub_rn(q.x, dmax), iw))),
          1.0f);
      const float ny = __fadd_rn(
          __fsub_rn(floorf(__fmul_rn(__fadd_rn(q.y, dmax), ih)),
                    floorf(__fmul_rn(__fsub_rn(q.y, dmax), ih))),
          1.0f);
      const int passable = to_i32(__fmul_rn(nx, ny));
      const int beyond = min(max(raw - in.enum_cap, 0), passable);
      drops = (unsigned)max(passing - k_cap, 0) + (unsigned)beyond;
    }
  } else if (g < in.n) {
    ng = q.cells;
    drops = (unsigned)(raw - min(raw, k_cap));
  }
  if (g < in.n) n_out[g] = (unsigned short)ng;

  const int wmax = __reduce_max_sync(FULL_MASK, ng);
  for (int k = 0; k < wmax; ++k) {
    const int c = __popc(__ballot_sync(FULL_MASK, ng > k));
    if (lane == 0) atomicAdd(&s_cnt[k], c);
  }
  const unsigned wdrops = __reduce_add_sync(FULL_MASK, drops);
  if (lane == 0 && wdrops != 0u) atomicAdd(&s_drops, wdrops);
  __syncthreads();
  for (int k = threadIdx.x; k < k_cap; k += BLOCK)
    cnt[(int64_t)k * nb + blockIdx.x] = s_cnt[k];
  if (threadIdx.x == 0) cnt[(int64_t)k_cap * nb + blockIdx.x] = (int)s_drops;
}

__device__ __forceinline__ unsigned warp_inclusive_scan(unsigned v) {
  const int lane = threadIdx.x & 31;
#pragma unroll
  for (int d = 1; d < 32; d <<= 1) {
    const unsigned t = __shfl_up_sync(FULL_MASK, v, d);
    if (lane >= d) v += t;
  }
  return v;
}

// Pass 2: row blockIdx.x of the (K + 1, nb) count matrix to its exclusive
// prefix over blocks, in place; its total to totals[row]. Modular (the
// drops row is summed modulo 2^32, as the plain version's cast).
__global__ void __launch_bounds__(SCAN_THREADS)
emit_scan_kernel(int* __restrict__ cnt, int nb, int* __restrict__ totals) {
  __shared__ unsigned s_warp[SCAN_THREADS / 32];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  int* row = cnt + (int64_t)blockIdx.x * nb;
  const int per = (nb + SCAN_THREADS - 1) / SCAN_THREADS;
  const int lo = min((int)threadIdx.x * per, nb), hi = min(lo + per, nb);
  unsigned s = 0u;
  for (int i = lo; i < hi; ++i) s += (unsigned)row[i];
  const unsigned incl = warp_inclusive_scan(s);
  if (lane == 31) s_warp[warp] = incl;
  __syncthreads();
  if (warp == 0) s_warp[lane] = warp_inclusive_scan(s_warp[lane]);
  __syncthreads();
  unsigned run = incl - s + (warp ? s_warp[warp - 1] : 0u);
  for (int i = lo; i < hi; ++i) {
    const unsigned c = (unsigned)row[i];
    row[i] = (int)run;
    run += c;
  }
  if (threadIdx.x == SCAN_THREADS - 1) totals[blockIdx.x] = (int)s_warp[31];
}

// Where pass 3 writes: the block's slot offsets and per-warp ballots.
struct Place {
  const int* off;        // (K,) first offset of the block's k-th pairs
  const unsigned* bal;   // (K,) this warp's ballot of n(g) > k
  const int* pre;        // (K,) k-th pairs of the block's earlier warps
  int cap, n;
  int* tile;
  int* slot;

  // the r-th pair of the gaussian g of lane `src` of this warp
  __device__ __forceinline__ void put(int r, int key, int src, int g) const {
    const int at = off[r] + pre[r] + __popc(bal[r] & ((1u << src) - 1u));
    if (at < cap) {
      tile[at] = key;
      slot[at] = r * n + g;
    }
  }
};

// Writes each lane's gaussian's first ng pairs. Every lane of the warp
// must call it.
template <bool CULL>
__device__ void write_pairs(const Inputs& in, const Gauss& q, int g, int ng,
                            const Place& at) {
  const int lane = threadIdx.x & 31;
  const bool big = ng > 0 && q.cells > SOLO;
  if (ng > 0 && !big) {
    int tx = q.tx0, ty = q.ty0, r = 0;
    for (int c = 0; c < q.cells && r < ng; ++c) {
      if (!CULL || cell_passes(in, q, tx, ty)) {
        at.put(r, ty * in.grid_w + tx, lane, g);
        ++r;
      }
      if (++tx == q.tx0 + q.rw) {
        tx = q.tx0;
        ++ty;
      }
    }
  }
  unsigned bigs = __ballot_sync(FULL_MASK, big);
  while (bigs) {
    const int src = __ffs(bigs) - 1;
    bigs &= bigs - 1;
    const Gauss p = shfl_gauss(q, src);
    const int png = __shfl_sync(FULL_MASK, ng, src);
    const int pg = __shfl_sync(FULL_MASK, g, src);
    int got = 0;
    for (int base = 0; base < p.cells && got < png; base += 32) {
      const int c = base + lane;
      const int tx = p.tx0 + c % p.rw, ty = p.ty0 + c / p.rw;
      const bool ok = c < p.cells && (!CULL || cell_passes(in, p, tx, ty));
      const unsigned m = __ballot_sync(FULL_MASK, ok);
      if (ok) {
        const int r = got + __popc(m & ((1u << lane) - 1u));
        if (r < png) at.put(r, ty * in.grid_w + tx, src, pg);
      }
      got += __popc(m);
    }
  }
}

// Pass 3: the pairs to their offsets, the fill past the live count, the
// counts and the drops.
template <bool CULL>
__global__ void __launch_bounds__(BLOCK)
emit_write_kernel(Inputs in, const unsigned short* __restrict__ n_in,
                  const int* __restrict__ cnt,
                  const int* __restrict__ totals, int nb, int cap,
                  int* __restrict__ out_tile, int* __restrict__ out_slot,
                  long long* __restrict__ counts, int* __restrict__ dropped,
                  unsigned long long* __restrict__ runs) {
  extern __shared__ int smem[];
  const int k_cap = in.k_cap;
  int* s_off = smem;                                      // K
  unsigned* s_bal = reinterpret_cast<unsigned*>(smem + k_cap);  // WARPS K
  int* s_pre = smem + k_cap + WARPS * k_cap;              // WARPS K
  __shared__ int s_live;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;

  // slot k's pairs start at sum_{k' < k} totals[k'] (a warp scan), the
  // block's at that plus its row prefix
  if (warp == 0) {
    unsigned carry = 0u;
    for (int k0 = 0; k0 < k_cap; k0 += 32) {
      const int k = k0 + lane;
      const unsigned v = k < k_cap ? (unsigned)totals[k] : 0u;
      const unsigned incl = warp_inclusive_scan(v);
      if (k < k_cap)
        s_off[k] = (int)(carry + incl - v) +
                   cnt[(int64_t)k * nb + blockIdx.x];
      carry += __shfl_sync(FULL_MASK, incl, 31);
    }
    if (lane == 0) s_live = (int)carry;
  }
  const int g = blockIdx.x * BLOCK + threadIdx.x;
  const int ng = g < in.n ? (int)n_in[g] : 0;
  const int wmax = __reduce_max_sync(FULL_MASK, ng);
  for (int k = 0; k < wmax; ++k) {
    const unsigned b = __ballot_sync(FULL_MASK, ng > k);
    if (lane == 0) s_bal[warp * k_cap + k] = b;
  }
  for (int k = wmax + lane; k < k_cap; k += 32) s_bal[warp * k_cap + k] = 0u;
  __syncthreads();
  for (int k = threadIdx.x; k < k_cap; k += BLOCK) {
    int run = 0;
    for (int w = 0; w < WARPS; ++w) {
      s_pre[w * k_cap + k] = run;
      run += __popc(s_bal[w * k_cap + k]);
    }
  }
  __syncthreads();
  const int n_live = s_live;

  if (wmax > 0) {
    int raw = 0;
    float lam = 0.0f;
    const Gauss q = ng > 0 ? load_gauss<CULL>(in, g, raw, lam) : no_gauss();
    const Place at{s_off, s_bal + warp * k_cap, s_pre + warp * k_cap, cap,
                   in.n, out_tile, out_slot};
    write_pairs<CULL>(in, q, g, ng, at);
  }
  const int sink = k_cap * in.n;
  for (int64_t i = (int64_t)n_live + (int64_t)blockIdx.x * BLOCK +
                   threadIdx.x;
       i < cap; i += (int64_t)gridDim.x * BLOCK) {
    out_tile[i] = in.num_tiles;
    out_slot[i] = sink;
  }
  if (blockIdx.x == 0 && threadIdx.x == 0) {
    counts[0] = n_live;
    counts[1] = max(n_live - cap, 0);
    *dropped = totals[k_cap];
    if (runs != nullptr) atomicAdd(runs, 1ull);
  }
}

Inputs make_inputs(const float* x2d, const float* y2d, const int* radius,
                   const unsigned char* valid, const float* conic_a,
                   const float* conic_b, const float* conic_c,
                   const float* opacity, int n, int k_cap, int enum_cap,
                   int tile_h, int tile_w, int grid_h, int grid_w,
                   float gate, float inv_gate, float eps, float lam_floor,
                   float dmax_cap, float inv_tile_w, float inv_tile_h) {
  return Inputs{x2d, y2d, radius, valid, conic_a, conic_b, conic_c, opacity,
                n, k_cap, enum_cap, tile_h, tile_w, grid_h, grid_w,
                grid_h * grid_w,
                CullConsts{gate, inv_gate, eps, lam_floor, dmax_cap,
                           inv_tile_w, inv_tile_h}};
}

bool bad_shape(int n, int k_cap, int nb) {
  return n <= 0 || k_cap <= 0 || k_cap > MAX_K ||
         nb != (n + BLOCK - 1) / BLOCK ||
         (int64_t)k_cap * n >= ((int64_t)1 << 31);
}

}  // namespace

// The two entry points take the same inputs: x2d, y2d (n,) float32,
// radius (n,) int32, valid (n,) bool; with cull != 0 (the exact cull over
// enum_cap rect cells) conic_a, conic_b, conic_c, opacity (n,) float32
// (else null), and the float32 constants. nb = ceil(n / 256) blocks; a
// rect of at most SOLO walked cells is walked by its lane, a larger one
// by its warp.
//
// d3g_emit_count runs passes 1 and 2: n_each (n,) uint16, cnt ((k_cap +
// 1) * nb,) int32 and totals (k_cap + 1,) int32, all written; the live
// count is the sum of totals[0 .. k_cap). d3g_emit_write runs pass 3 on
// them: tile and slot (cap,) int32 (the first cap pairs; the sentinel and
// the sink slot k_cap * n past the live count), counts (2,) int64 [live
// pairs, past cap], dropped () int32, all written. `runs`, when not null,
// is a device counter to which each run of pass 3 adds one, eager or
// replayed from a CUDA graph. Each returns a cudaError_t as int (0 =
// launched).
extern "C" int d3g_emit_count(
    const float* x2d, const float* y2d, const int* radius,
    const unsigned char* valid, const float* conic_a, const float* conic_b,
    const float* conic_c, const float* opacity, int n, int k_cap, int cull,
    int enum_cap, int tile_h, int tile_w, int grid_h, int grid_w, float gate,
    float inv_gate, float eps, float lam_floor, float dmax_cap,
    float inv_tile_w, float inv_tile_h, int nb,
    unsigned short* n_each, int* cnt, int* totals, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (bad_shape(n, k_cap, nb)) return (int)cudaErrorInvalidValue;
  const Inputs in = make_inputs(x2d, y2d, radius, valid, conic_a, conic_b,
                                conic_c, opacity, n, k_cap, enum_cap, tile_h,
                                tile_w, grid_h, grid_w, gate, inv_gate, eps,
                                lam_floor, dmax_cap, inv_tile_w, inv_tile_h);
  const size_t smem = (size_t)k_cap * sizeof(int);
  if (cull)
    emit_count_kernel<true><<<nb, BLOCK, smem, s>>>(in, n_each, cnt, nb);
  else
    emit_count_kernel<false><<<nb, BLOCK, smem, s>>>(in, n_each, cnt, nb);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  emit_scan_kernel<<<k_cap + 1, SCAN_THREADS, 0, s>>>(cnt, nb, totals);
  return (int)cudaGetLastError();
}

extern "C" int d3g_emit_write(
    const float* x2d, const float* y2d, const int* radius,
    const unsigned char* valid, const float* conic_a, const float* conic_b,
    const float* conic_c, const float* opacity, int n, int k_cap, int cull,
    int enum_cap, int tile_h, int tile_w, int grid_h, int grid_w, float gate,
    float inv_gate, float eps, float lam_floor, float dmax_cap,
    float inv_tile_w, float inv_tile_h, int nb,
    const unsigned short* n_each, const int* cnt, const int* totals, int cap,
    int* tile, int* slot, long long* counts, int* dropped,
    unsigned long long* runs, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (bad_shape(n, k_cap, nb) || cap < 0) return (int)cudaErrorInvalidValue;
  const Inputs in = make_inputs(x2d, y2d, radius, valid, conic_a, conic_b,
                                conic_c, opacity, n, k_cap, enum_cap, tile_h,
                                tile_w, grid_h, grid_w, gate, inv_gate, eps,
                                lam_floor, dmax_cap, inv_tile_w, inv_tile_h);
  const size_t smem = (size_t)(1 + 2 * WARPS) * k_cap * sizeof(int);
  if (cull)
    emit_write_kernel<true><<<nb, BLOCK, smem, s>>>(
        in, n_each, cnt, totals, nb, cap, tile, slot, counts, dropped, runs);
  else
    emit_write_kernel<false><<<nb, BLOCK, smem, s>>>(
        in, n_each, cnt, totals, nb, cap, tile, slot, counts, dropped, runs);
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
