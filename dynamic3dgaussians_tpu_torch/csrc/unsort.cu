// The render backward's pair-to-gaussian sum (U1) for Hopper (sm_90a).
//
// Replaces no Pallas kernel: the JAX package leaves the unsort and the sum
// over the K emission slots to XLA (dynamic3dgaussians_tpu/ops/
// sorted_raster.py:327-376, `composite_bwd`), and the port summed a zeroed
// (rows, K * N) per-slot buffer over K (ops/sorted_raster.py::slot_sum).
// U1 computes the same gradient of the record table, (R, N):
//
//   out[r, g] = sum over k ascending of d_pairs[r, j] where slot[j] = k N + g
//
// for the rows r < n_rows that carry a gradient; rows n_rows .. R - 1 (the
// ones row and the pad rows) are written 0. Each sum starts from +0.0 and
// adds only the live pairs' terms, in ascending k, with no float atomics:
// the plain version (ops/cuda/unsort.py::unsort_sum_plain, torch.where(
// live, acc + d, acc) over k) computes the same adds in the same order, so
// the two agree bitwise, and a replayed window repeats bitwise. A column
// whose slot is outside [0, K N) (the static form's sink slot K N) adds
// nothing. A gaussian's live slots may be any subset of its K slots (a
// tile stripe keeps only its own pairs); live slots are unique.
//
// Launches (the launcher first zeroes kend, N int32):
//  1. u1_map: a block per COLS = 128 columns. Each column's slot is read:
//     a live column (slot in [0, K N)) sets map[slot] = j and kend[g] =
//     max(kend[g], k + 1) (an integer atomicMax, exact in any order). The
//     block copies its columns' n_rows gradient values from d_pairs
//     (row-major, row stride ld: each row's columns coalesced reads)
//     through shared memory into pair-major records of RW = 4 ceil((n_rows
//     + 1) / 4) floats, the last one the slot's bits (the tag), its 128
//     records written as one contiguous, coalesced stream. A dead column
//     writes only its tag, -1. `map` (K N int32) is scratch that is never
//     filled.
//  2. u1_sum: one thread per gaussian g (coalesced over g), blockIdx.y a
//     group of up to 4 V output rows. It walks k in [0, kend[g]), four
//     slots at a time, takes j = map[k N + g] only where 0 <= j < M and
//     the record's tag equals k N + g (the back-pointer makes the unfilled
//     map safe: a stale j either fails the test or is this run's column of
//     that slot), adds the record's values into registers and writes its
//     rows once.
//
// Design for the H100. The work the result needs is each live pair's
// n_rows gradient values read once and the (R, N) result written once: at
// the bench training (1.30 M live pairs, 800,768 rows, R = 16) 134 MB,
// 0.04 ms at 3.35 TB/s. The per-slot buffer it replaces was zeroed,
// scattered into and read: 3 x 3.28 GB. Reading d_pairs' columns in
// gaussian order would cost one 32-byte sector per row per pair (~0.67
// GB); pass 1 reads them in column order instead and writes them
// pair-major (two coalesced streams of M RW floats), so that pass 2 reads
// a pair's values as RW / 4 float4s from one record. How pass 1 is laid
// out matters (H100, the windowed step's 1.7 M columns, R = 16 / 48): each
// record written from its own thread (RW / 4 float4 stores to 32 lines a
// warp instruction) took 0.16 / 0.77 ms; 32 columns a block through shared
// memory 0.16 / 0.31 ms, each short block waiting on its slot reads, then
// its loads, then its stores; 128 columns a block, the loads issued beside
// the slot reads, 0.12 / 0.29 ms. Pass 2 reads the map in k-major rows
// (coalesced over g) only up to each gaussian's last live slot; nothing
// passes over all K N entries.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;   // threads of a block, both passes
constexpr int COLS = 128;      // columns of a u1_map block
constexpr int MAX_RW = 92;     // a u1_map block's records fit in 48 KB

__global__ void __launch_bounds__(THREADS)
u1_map(const long long* __restrict__ slot, const float* __restrict__ d_pairs,
       long long ld, int m, int n_rows, int rw, int n_gauss, int n_slots,
       float* __restrict__ rec, int* __restrict__ map,
       int* __restrict__ kend) {
  extern __shared__ float tile[];    // COLS records of rw + 1 floats
  __shared__ int s_tag[COLS];
  constexpr int GROUPS = THREADS / COLS;
  const int j0 = blockIdx.x * COLS;
  const int ncol = min(COLS, m - j0);
  const int lane = threadIdx.x % COLS;
  const int group = threadIdx.x / COLS;
  int tag = -1;
  if (lane < ncol) {
    const long long s = slot[j0 + lane];
    if (s >= 0 && s < n_slots) tag = static_cast<int>(s);
  }
  // the values are loaded whatever the tag (a dead column's are in
  // bounds), so that the loads need not wait for the slot's
  float* own = tile + lane * (rw + 1);   // rw + 1 odd: no bank conflicts
  const float* src = d_pairs + j0 + lane;
  for (int i = group; i < rw - 1; i += GROUPS) {
    const float v = lane < ncol && i < n_rows ? src[(size_t)i * ld] : 0.f;
    own[i] = tag >= 0 ? v : 0.f;
  }
  if (group == 0) {
    own[rw - 1] = __int_as_float(tag);
    s_tag[lane] = tag;
    if (tag >= 0) {
      map[tag] = j0 + lane;
      atomicMax(&kend[tag % n_gauss], tag / n_gauss + 1);
    }
  }
  __syncthreads();
  float* dst = rec + (size_t)j0 * rw;
  for (int f = threadIdx.x; f < ncol * rw; f += THREADS) {
    const int c = f / rw;
    const int i = f - c * rw;
    if (i == rw - 1 || s_tag[c] >= 0) dst[f] = tile[c * (rw + 1) + i];
  }
}

// V float4s of rows a pass; the pass's rows start at 4 V blockIdx.y.
template <int V>
__global__ void __launch_bounds__(THREADS)
u1_sum(const float4* __restrict__ rec, const int* __restrict__ map,
       const int* __restrict__ kend, int m, int nq, int n_rows,
       int n_out_rows, int n_gauss, float* __restrict__ out,
       unsigned long long* __restrict__ runs) {
  if (runs != nullptr && blockIdx.x == 0 && blockIdx.y == 0 &&
      threadIdx.x == 0)
    atomicAdd(runs, 1ull);
  const int g = blockIdx.x * THREADS + threadIdx.x;
  if (g >= n_gauss) return;
  const int q0 = blockIdx.y * V;
  const int nqv = (n_rows + 3) / 4;   // float4s holding gradient values
  float4 acc[V];
#pragma unroll
  for (int v = 0; v < V; ++v) acc[v] = make_float4(0.f, 0.f, 0.f, 0.f);
  const int ke = kend[g];
  // four slots at a time: their map entries are loaded together, then each
  // record's tag and values together, and added in ascending k
  for (int k0 = 0; k0 < ke; k0 += 4) {
    int j[4];
#pragma unroll
    for (int u = 0; u < 4; ++u)
      j[u] = k0 + u < ke ? map[(k0 + u) * n_gauss + g] : -1;
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      if (static_cast<unsigned>(j[u]) >= static_cast<unsigned>(m)) continue;
      const float4* r = rec + (size_t)j[u] * nq;
      const int tag =
          __float_as_int(reinterpret_cast<const float*>(r)[4 * nq - 1]);
      float4 x[V];
#pragma unroll
      for (int v = 0; v < V; ++v)
        x[v] = q0 + v < nqv ? r[q0 + v] : make_float4(0.f, 0.f, 0.f, 0.f);
      if (tag != (k0 + u) * n_gauss + g) continue;
#pragma unroll
      for (int v = 0; v < V; ++v) {
        if (q0 + v < nqv) {
          acc[v].x = __fadd_rn(acc[v].x, x[v].x);
          acc[v].y = __fadd_rn(acc[v].y, x[v].y);
          acc[v].z = __fadd_rn(acc[v].z, x[v].z);
          acc[v].w = __fadd_rn(acc[v].w, x[v].w);
        }
      }
    }
  }
#pragma unroll
  for (int v = 0; v < V; ++v) {
    const float a[4] = {acc[v].x, acc[v].y, acc[v].z, acc[v].w};
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      const int row = 4 * (q0 + v) + c;
      if (row < n_out_rows)
        out[(size_t)row * n_gauss + g] = row < n_rows ? a[c] : 0.f;
    }
  }
}

template <int V>
cudaError_t launch_sum(const float4* rec, const int* map, const int* kend,
                       int m, int nq, int n_rows, int n_out_rows,
                       int n_gauss, float* out, unsigned long long* runs,
                       cudaStream_t s) {
  const int nq_out = (n_out_rows + 3) / 4;
  const dim3 grid((n_gauss + THREADS - 1) / THREADS, (nq_out + V - 1) / V);
  u1_sum<V><<<grid, THREADS, 0, s>>>(rec, map, kend, m, nq, n_rows,
                                     n_out_rows, n_gauss, out, runs);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// d3g_unsort_sum: both passes. slot (m) int64 the emission slot of each
// column of d_pairs (n_rows or more rows of m floats, row stride ld);
// rec (m * 4 ceil((n_rows + 1) / 4)) float, map (n_slots) int and kend
// (n_gauss) int are scratch (kend is zeroed here); out (n_out_rows,
// n_gauss) float is written whole. n_slots = K * n_gauss < 2^31,
// 4 ceil((n_rows + 1) / 4) <= MAX_RW. `runs`, when not null, counts each
// run.
int d3g_unsort_sum(const long long* slot, const float* d_pairs, long long ld,
                   int m, int n_rows, int n_out_rows, int n_gauss,
                   int n_slots, float* rec, int* map, int* kend, float* out,
                   unsigned long long* runs, void* stream) {
  if (m < 0 || n_rows < 0 || n_rows > n_out_rows || n_gauss <= 0 ||
      n_slots < 0 || n_slots % n_gauss != 0 || (m > 0 && ld < m))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int nq = (n_rows + 1 + 3) / 4;
  const int rw = 4 * nq;
  if (rw > MAX_RW) return static_cast<int>(cudaErrorInvalidValue);
  const float4* rec4 = reinterpret_cast<const float4*>(rec);
  cudaError_t err = cudaMemsetAsync(kend, 0, sizeof(int) * n_gauss, s);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (m > 0) {
    const size_t smem = sizeof(float) * COLS * (rw + 1);
    u1_map<<<(m + COLS - 1) / COLS, THREADS, smem, s>>>(
        slot, d_pairs, ld, m, n_rows, rw, n_gauss, n_slots, rec, map, kend);
    err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  const int nq_out = (n_out_rows + 3) / 4;
  if (nq_out <= 4)
    err = launch_sum<4>(rec4, map, kend, m, nq, n_rows, n_out_rows, n_gauss,
                        out, runs, s);
  else if (nq_out <= 8)
    err = launch_sum<8>(rec4, map, kend, m, nq, n_rows, n_out_rows, n_gauss,
                        out, runs, s);
  else if (nq_out <= 12)
    err = launch_sum<12>(rec4, map, kend, m, nq, n_rows, n_out_rows,
                         n_gauss, out, runs, s);
  else
    err = launch_sum<16>(rec4, map, kend, m, nq, n_rows, n_out_rows,
                         n_gauss, out, runs, s);
  return static_cast<int>(err);
}

}  // extern "C"
