// The edge terms of the physics losses of t > 0 (P1) for Hopper (sm_90a).
//
// Replaces no Pallas kernel: the JAX package leaves
// dynamic3dgaussians_tpu/train/losses.py::physics_losses to XLA, and the
// port's plain version (train/losses.py::edge_losses_torch) runs each term
// as PyTorch ops over every (capacity row, neighbour) pair. P1 computes the
// three edge terms, rigid, rot and iso, and their gradient into the
// activated means (cap, 3) and rotations (cap, 4), over the kNN graph's
// edges (i, k) -> j = idx[i, k]:
//
//   q = normalize(rots ⊗ prev_inv)            (each row's relative rotation)
//   o = means[j] - means[i], c = R(q_i)^T o
//   rigid = sqrt(|c - prev_offset[i, k]|^2 w + 1e-20)
//   rot   = sqrt(|q_j - q_i|^2 w + 1e-20)
//   iso   = sqrt((sqrt(|o|^2 + 1e-20) - dist[i, k])^2 w + 1e-20)
//
// each summed over the edges with fg[i] (foreground and alive) and j >= 0
// and divided by max(count, 1), count the number of such edges: the plain
// version's masked means. Every float operation of an edge's forward is
// written in the plain version's order with explicitly rounded intrinsics
// (no FMA contraction), rsqrtf as PyTorch's CUDA rsqrt, IEEE sqrt and
// division, NaN through torch.clamp as PyTorch passes it. The sums are in
// another order than torch.sum's, so the losses agree to float32 rounding,
// not bitwise.
//
// Rows walked: the edge plan's destination prefix, n_dst =
// edge_row_ptr.numel() - 1 rows (the trainer reorders the foreground to the
// front and ops/neighbor.py::build_edge_reduction checks that no edge lies
// past it); a full-capacity plan walks every row. n_dst and K are shapes,
// so there is no host read and a CUDA graph captures the four launches.
//
// Launches (no float atomics: every sum has a fixed order, so a replayed
// window is bitwise repeatable):
//  1. fwd_partial: block b takes rows [b R, (b + 1) R), R = rows_per_block
//     (the wrapper's max(1, min(256, 1024 / K)), at most 1,024 edges); its
//     rows' means, fg and relative rotations are formed once into shared
//     memory; thread t walks the block's edges t, t + 256, ... in order,
//     summing the three terms and the count; a shared-memory tree (s =
//     128, 64, .., 1: a[t] += a[t + s]) gives the block's partials.
//  2. fwd_final: one block; thread t sums partials t, t + 256, ... in order,
//     then the same tree; writes the three losses and the count.
//  3. bwd_edges: the same blocks; each edge recomputes its forward (nothing
//     per edge is saved) and forms its gradient, scaled by the upstream
//     scalars read on the device over max(count, 1): the row's own part
//     (-d o, d q_i: 7 floats) into shared memory, the neighbour's part (d o,
//     d q_j) at the edge's destination-sorted slot rank[e] of a scatter
//     buffer (8 floats, one 32-byte sector). Edges with j >= 0 that are not
//     valid write zeros there; edges with j < 0 sort past row_ptr[n_dst]
//     and write nothing. Then thread r sums row r's K own parts in order.
//  4. bwd_rows: one thread per capacity row; a row r < n_dst sums its run
//     row_ptr[r] .. row_ptr[r + 1] of the scatter buffer in order (the
//     plain _Lookup.backward's summation order), adds its own part, and
//     takes d q through normalize and the quaternion product into d rots;
//     rows past n_dst, and rows whose d q is exactly 0, get exact zeros.
//
// Design for the H100. The function's bytes are each edge's inputs once
// (index, weight, distance, t - 1 offset: 24 B) and each prefix row's
// means, rotation and inverse rotation read and two gradients written
// (72 B): at the bench training's ~2.0 M edges and ~100,000 prefix rows
// ~55 MB, ~0.017 ms at 3.35 TB/s; with the scatter buffer written and read
// (2 x 32 B an edge) and the edges read twice (forward, backward), ~230 MB,
// ~0.07 ms. The (rows, K) streams are read coalesced (consecutive threads,
// consecutive edges); the neighbours' rows are gathered from the ~4.4 MB
// prefix table, which stays in the 50 MB L2. The work per edge is ~250
// float operations, far below the bytes' floor.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;      // threads of every block
constexpr int MAX_EDGES = 1024;   // edges of a block (R K <= MAX_EDGES)
constexpr int ROW_F = 8;          // the row cache: m x, y, z, fg, q 0..3
constexpr int OWN_F = 7;          // an edge's own part: -d o (3), d q_i (4)
constexpr int SCAT_F = 8;         // a scatter record: d o (3), d q_j (4), 0

struct Inputs {
  const float* means;           // (cap, 3)
  const float* rots;            // (cap, 4) normalised
  const float* prev_inv;        // (cap, 4)
  const unsigned char* fg;      // (cap,) torch.bool, foreground & alive
  const int* idx;               // (cap, K), -1 = none
  const float* weight;          // (cap, K)
  const float* dist;            // (cap, K)
  const float* prev_offset;     // (cap, K, 3)
  int n_dst, k, rows_per_block;
};

__device__ __forceinline__ float mul(float a, float b) {
  return __fmul_rn(a, b);
}
__device__ __forceinline__ float add(float a, float b) {
  return __fadd_rn(a, b);
}
__device__ __forceinline__ float sub(float a, float b) {
  return __fsub_rn(a, b);
}
// torch.clamp(v, min=lo): NaN passes through
__device__ __forceinline__ float clamp_min(float v, float lo) {
  return isnan(v) ? v : fmaxf(v, lo);
}

struct Quat {
  float w, x, y, z;
};

// ops/quat.py::quat_mult(a, b), in its order of operations
__device__ __forceinline__ Quat quat_mult(const Quat& a, const Quat& b) {
  Quat p;
  p.w = sub(sub(sub(mul(a.w, b.w), mul(a.x, b.x)), mul(a.y, b.y)),
            mul(a.z, b.z));
  p.x = sub(add(add(mul(a.w, b.x), mul(a.x, b.w)), mul(a.y, b.z)),
            mul(a.z, b.y));
  p.y = add(add(sub(mul(a.w, b.y), mul(a.x, b.z)), mul(a.y, b.w)),
            mul(a.z, b.x));
  p.z = add(sub(add(mul(a.w, b.z), mul(a.x, b.y)), mul(a.y, b.x)),
            mul(a.z, b.w));
  return p;
}

__device__ __forceinline__ Quat load_quat(const float* p, int r) {
  const float4 v = reinterpret_cast<const float4*>(p)[r];
  return Quat{v.x, v.y, v.z, v.w};
}

// q * rsqrt(clamp(sum(q * q), min=1e-24)), ops/quat.py::normalize; `inv`
// and `ss` are kept for the backward
__device__ __forceinline__ Quat normalize(const Quat& q, float& inv,
                                          float& ss) {
  ss = add(add(add(mul(q.w, q.w), mul(q.x, q.x)), mul(q.y, q.y)),
           mul(q.z, q.z));
  inv = rsqrtf(clamp_min(ss, 1e-24f));
  return Quat{mul(q.w, inv), mul(q.x, inv), mul(q.y, inv), mul(q.z, inv)};
}

// row r's relative rotation normalize(rots[r] ⊗ prev_inv[r])
__device__ __forceinline__ Quat rel_rot(const Inputs& in, int r) {
  float inv, ss;
  return normalize(quat_mult(load_quat(in.rots, r),
                             load_quat(in.prev_inv, r)), inv, ss);
}

// R(q) of the plain version, built elementwise: r[a][b]
struct Rot {
  float r[3][3];
};

__device__ __forceinline__ Rot rotmat(const Quat& q) {
  Rot m;
  m.r[0][0] = sub(1.0f, mul(2.0f, add(mul(q.y, q.y), mul(q.z, q.z))));
  m.r[0][1] = mul(2.0f, sub(mul(q.x, q.y), mul(q.w, q.z)));
  m.r[0][2] = mul(2.0f, add(mul(q.x, q.z), mul(q.w, q.y)));
  m.r[1][0] = mul(2.0f, add(mul(q.x, q.y), mul(q.w, q.z)));
  m.r[1][1] = sub(1.0f, mul(2.0f, add(mul(q.x, q.x), mul(q.z, q.z))));
  m.r[1][2] = mul(2.0f, sub(mul(q.y, q.z), mul(q.w, q.x)));
  m.r[2][0] = mul(2.0f, sub(mul(q.x, q.z), mul(q.w, q.y)));
  m.r[2][1] = mul(2.0f, add(mul(q.y, q.z), mul(q.w, q.x)));
  m.r[2][2] = sub(1.0f, mul(2.0f, add(mul(q.x, q.x), mul(q.y, q.y))));
  return m;
}

// One edge's forward, kept for its backward.
struct Edge {
  float o[3];      // means[j] - means[i]
  float e[3];      // R^T o - prev_offset
  float rigid;     // the three terms
  float dq[4];     // q_j - q_i
  float rot;
  float mag;       // sqrt(|o|^2 + 1e-20)
  float t;         // mag - dist
  float iso;
};

__device__ __forceinline__ Edge edge_forward(const float* m, const Quat& q,
                                             const Rot& R, const float* n,
                                             const Quat& nq, float w,
                                             float d, const float* po) {
  Edge f;
  for (int a = 0; a < 3; ++a) f.o[a] = sub(n[a], m[a]);
  for (int b = 0; b < 3; ++b) {
    const float c = add(add(mul(R.r[0][b], f.o[0]), mul(R.r[1][b], f.o[1])),
                        mul(R.r[2][b], f.o[2]));
    f.e[b] = sub(c, po[b]);
  }
  f.rigid = __fsqrt_rn(add(
      mul(add(add(mul(f.e[0], f.e[0]), mul(f.e[1], f.e[1])),
              mul(f.e[2], f.e[2])), w), 1e-20f));
  f.dq[0] = sub(nq.w, q.w);
  f.dq[1] = sub(nq.x, q.x);
  f.dq[2] = sub(nq.y, q.y);
  f.dq[3] = sub(nq.z, q.z);
  f.rot = __fsqrt_rn(add(
      mul(add(add(add(mul(f.dq[0], f.dq[0]), mul(f.dq[1], f.dq[1])),
                  mul(f.dq[2], f.dq[2])), mul(f.dq[3], f.dq[3])), w),
      1e-20f));
  f.mag = __fsqrt_rn(add(add(add(mul(f.o[0], f.o[0]), mul(f.o[1], f.o[1])),
                             mul(f.o[2], f.o[2])), 1e-20f));
  f.t = sub(f.mag, d);
  f.iso = __fsqrt_rn(add(mul(mul(f.t, f.t), w), 1e-20f));
  return f;
}

// The block's rows into shared memory: means, fg and relative rotation.
__device__ __forceinline__ int load_rows(const Inputs& in, float* s_row) {
  const int row0 = blockIdx.x * in.rows_per_block;
  const int nrows = min(in.rows_per_block, in.n_dst - row0);
  for (int r = threadIdx.x; r < nrows; r += THREADS) {
    const int i = row0 + r;
    float* s = s_row + r * ROW_F;
    for (int a = 0; a < 3; ++a) s[a] = in.means[(int64_t)i * 3 + a];
    s[3] = in.fg[i] ? 1.0f : 0.0f;
    const Quat q = rel_rot(in, i);
    s[4] = q.w;
    s[5] = q.x;
    s[6] = q.y;
    s[7] = q.z;
  }
  __syncthreads();
  return nrows;
}

__device__ __forceinline__ void load_neighbour(const Inputs& in, int j,
                                               float* n, Quat& nq) {
  for (int a = 0; a < 3; ++a) n[a] = in.means[(int64_t)j * 3 + a];
  nq = rel_rot(in, j);
}

// a[t] += a[t + s] for s = THREADS / 2 .. 1, every thread calling
template <typename T>
__device__ __forceinline__ void tree_sum(T* a) {
  for (int s = THREADS / 2; s > 0; s >>= 1) {
    __syncthreads();
    if (threadIdx.x < s) a[threadIdx.x] += a[threadIdx.x + s];
  }
  __syncthreads();
}

// Pass 1: per-block partial sums of the three terms and the count.
__global__ void __launch_bounds__(THREADS)
p1_fwd_partial(Inputs in, float* __restrict__ part,
               int* __restrict__ part_count) {
  extern __shared__ float s_row[];
  __shared__ float s_sum[3][THREADS];
  __shared__ int s_cnt[THREADS];
  const int nrows = load_rows(in, s_row);
  const int k = in.k, ne = nrows * k;
  const int64_t e0 = (int64_t)blockIdx.x * in.rows_per_block * k;
  float acc[3] = {0.0f, 0.0f, 0.0f};
  int cnt = 0;
  for (int le = threadIdx.x; le < ne; le += THREADS) {
    const int64_t e = e0 + le;
    const int j = in.idx[e];
    const float* s = s_row + (le / k) * ROW_F;
    if (j < 0 || s[3] == 0.0f) continue;
    float n[3];
    Quat nq;
    load_neighbour(in, j, n, nq);
    const Quat q{s[4], s[5], s[6], s[7]};
    const Edge f = edge_forward(s, q, rotmat(q), n, nq, in.weight[e],
                                in.dist[e], in.prev_offset + e * 3);
    acc[0] = add(acc[0], f.rigid);
    acc[1] = add(acc[1], f.rot);
    acc[2] = add(acc[2], f.iso);
    ++cnt;
  }
  for (int c = 0; c < 3; ++c) s_sum[c][threadIdx.x] = acc[c];
  s_cnt[threadIdx.x] = cnt;
  for (int c = 0; c < 3; ++c) tree_sum(s_sum[c]);
  tree_sum(s_cnt);
  if (threadIdx.x == 0) {
    for (int c = 0; c < 3; ++c) part[blockIdx.x * 3 + c] = s_sum[c][0];
    part_count[blockIdx.x] = s_cnt[0];
  }
}

// Pass 2: the partials summed in a fixed order; the losses and the count.
__global__ void __launch_bounds__(THREADS)
p1_fwd_final(const float* __restrict__ part,
             const int* __restrict__ part_count, int nb,
             float* __restrict__ out_rigid, float* __restrict__ out_rot,
             float* __restrict__ out_iso, float* __restrict__ out_count,
             unsigned long long* __restrict__ runs) {
  __shared__ float s_sum[3][THREADS];
  __shared__ long long s_cnt[THREADS];
  float acc[3] = {0.0f, 0.0f, 0.0f};
  long long cnt = 0;
  for (int b = threadIdx.x; b < nb; b += THREADS) {
    for (int c = 0; c < 3; ++c) acc[c] = add(acc[c], part[b * 3 + c]);
    cnt += part_count[b];
  }
  for (int c = 0; c < 3; ++c) s_sum[c][threadIdx.x] = acc[c];
  s_cnt[threadIdx.x] = cnt;
  for (int c = 0; c < 3; ++c) tree_sum(s_sum[c]);
  tree_sum(s_cnt);
  if (threadIdx.x == 0) {
    const float count = (float)s_cnt[0];
    const float den = fmaxf(count, 1.0f);
    *out_rigid = __fdiv_rn(s_sum[0][0], den);
    *out_rot = __fdiv_rn(s_sum[1][0], den);
    *out_iso = __fdiv_rn(s_sum[2][0], den);
    *out_count = count;
    if (runs != nullptr) atomicAdd(runs, 1ull);
  }
}

// d q from d R of R(q) built elementwise (rotmat)
__device__ __forceinline__ void rotmat_backward(const Quat& q,
                                                const float dR[3][3],
                                                float* dq) {
  const float w = q.w, x = q.x, y = q.y, z = q.z;
  // r00 = 1 - 2 (y y + z z), r11 = 1 - 2 (x x + z z), r22 = 1 - 2 (x x + y y)
  dq[2] -= 4.0f * y * dR[0][0];
  dq[3] -= 4.0f * z * dR[0][0];
  dq[1] -= 4.0f * x * dR[1][1];
  dq[3] -= 4.0f * z * dR[1][1];
  dq[1] -= 4.0f * x * dR[2][2];
  dq[2] -= 4.0f * y * dR[2][2];
  // r01 = 2 (x y - w z), r10 = 2 (x y + w z)
  const float a01 = 2.0f * dR[0][1], a10 = 2.0f * dR[1][0];
  dq[1] += y * (a01 + a10);
  dq[2] += x * (a01 + a10);
  dq[0] += z * (a10 - a01);
  dq[3] += w * (a10 - a01);
  // r02 = 2 (x z + w y), r20 = 2 (x z - w y)
  const float a02 = 2.0f * dR[0][2], a20 = 2.0f * dR[2][0];
  dq[1] += z * (a02 + a20);
  dq[3] += x * (a02 + a20);
  dq[0] += y * (a02 - a20);
  dq[2] += w * (a02 - a20);
  // r12 = 2 (y z - w x), r21 = 2 (y z + w x)
  const float a12 = 2.0f * dR[1][2], a21 = 2.0f * dR[2][1];
  dq[2] += z * (a12 + a21);
  dq[3] += y * (a12 + a21);
  dq[0] += x * (a21 - a12);
  dq[1] += w * (a21 - a12);
}

// Pass 3: each edge's gradient; own parts summed per row, neighbour parts
// scattered to their destination-sorted slots.
__global__ void __launch_bounds__(THREADS)
p1_bwd_edges(Inputs in, const float* __restrict__ g_rigid,
             const float* __restrict__ g_rot,
             const float* __restrict__ g_iso,
             const float* __restrict__ count,
             const int* __restrict__ rank, float* __restrict__ scat,
             float* __restrict__ own) {
  extern __shared__ float smem[];
  float* s_row = smem;                                   // R ROW_F
  float* s_own = smem + in.rows_per_block * ROW_F;       // R K OWN_F
  const int nrows = load_rows(in, s_row);
  const int k = in.k, ne = nrows * k;
  const int64_t e0 = (int64_t)blockIdx.x * in.rows_per_block * k;
  // d loss / d term of each valid edge: upstream / max(count, 1), as the
  // plain masked mean's division backward
  const float den = fmaxf(*count, 1.0f);
  const float gr = g_rigid ? __fdiv_rn(*g_rigid, den) : 0.0f;
  const float gq = g_rot ? __fdiv_rn(*g_rot, den) : 0.0f;
  const float gi = g_iso ? __fdiv_rn(*g_iso, den) : 0.0f;
  for (int le = threadIdx.x; le < ne; le += THREADS) {
    const int64_t e = e0 + le;
    const int j = in.idx[e];
    const float* s = s_row + (le / k) * ROW_F;
    float do_[3] = {0.0f, 0.0f, 0.0f};
    float dqi[4] = {0.0f, 0.0f, 0.0f, 0.0f};
    float dqj[4] = {0.0f, 0.0f, 0.0f, 0.0f};
    if (j >= 0 && s[3] != 0.0f) {
      float n[3];
      Quat nq;
      load_neighbour(in, j, n, nq);
      const Quat q{s[4], s[5], s[6], s[7]};
      const Rot R = rotmat(q);
      const float w = in.weight[e];
      const Edge f = edge_forward(s, q, R, n, nq, w, in.dist[e],
                                  in.prev_offset + e * 3);
      // rigid: d e = (gr / (2 rigid)) w 2 e; c = R^T o
      const float sr = (gr / (2.0f * f.rigid)) * w;
      float dc[3];
      for (int b = 0; b < 3; ++b) dc[b] = sr * (2.0f * f.e[b]);
      float dR[3][3];
      for (int a = 0; a < 3; ++a) {
        do_[a] = R.r[a][0] * dc[0] + R.r[a][1] * dc[1] + R.r[a][2] * dc[2];
        for (int b = 0; b < 3; ++b) dR[a][b] = f.o[a] * dc[b];
      }
      rotmat_backward(q, dR, dqi);
      // rot: d (q_j - q_i) = (gq / (2 rot)) w 2 (q_j - q_i)
      const float sq = (gq / (2.0f * f.rot)) * w;
      for (int c = 0; c < 4; ++c) {
        const float g = sq * (2.0f * f.dq[c]);
        dqj[c] = g;
        dqi[c] -= g;
      }
      // iso: d mag = (gi / (2 iso)) w 2 t; d |o|^2 = d mag / (2 mag)
      const float si = (gi / (2.0f * f.iso)) * w * (2.0f * f.t);
      const float so = si / (2.0f * f.mag);
      for (int a = 0; a < 3; ++a) do_[a] += so * (2.0f * f.o[a]);
    }
    float* o = s_own + le * OWN_F;
    for (int a = 0; a < 3; ++a) o[a] = -do_[a];
    for (int c = 0; c < 4; ++c) o[3 + c] = dqi[c];
    if (j >= 0) {
      float4* dst = reinterpret_cast<float4*>(scat + (int64_t)rank[e] *
                                              SCAT_F);
      dst[0] = make_float4(do_[0], do_[1], do_[2], dqj[0]);
      dst[1] = make_float4(dqj[1], dqj[2], dqj[3], 0.0f);
    }
  }
  __syncthreads();
  const int row0 = blockIdx.x * in.rows_per_block;
  for (int r = threadIdx.x; r < nrows; r += THREADS) {
    float acc[OWN_F] = {0.0f, 0.0f, 0.0f, 0.0f, 0.0f, 0.0f, 0.0f};
    for (int kk = 0; kk < k; ++kk) {
      const float* o = s_own + (r * k + kk) * OWN_F;
      for (int c = 0; c < OWN_F; ++c) acc[c] = add(acc[c], o[c]);
    }
    float4* dst = reinterpret_cast<float4*>(own + (int64_t)(row0 + r) *
                                            SCAT_F);
    dst[0] = make_float4(acc[0], acc[1], acc[2], acc[3]);
    dst[1] = make_float4(acc[4], acc[5], acc[6], 0.0f);
  }
}

// Pass 4: each row's neighbour run in order plus its own part; d q through
// normalize and the quaternion product.
__global__ void __launch_bounds__(THREADS)
p1_bwd_rows(Inputs in, int cap, const int* __restrict__ row_ptr,
            const float* __restrict__ scat, const float* __restrict__ own,
            float* __restrict__ d_means, float* __restrict__ d_rots,
            unsigned long long* __restrict__ runs) {
  const int r = blockIdx.x * THREADS + threadIdx.x;
  if (runs != nullptr && r == 0) atomicAdd(runs, 1ull);
  if (r >= cap) return;
  float t[8] = {0.0f, 0.0f, 0.0f, 0.0f, 0.0f, 0.0f, 0.0f, 0.0f};
  if (r < in.n_dst) {
    float nb[8] = {0.0f, 0.0f, 0.0f, 0.0f, 0.0f, 0.0f, 0.0f, 0.0f};
    const float4* s = reinterpret_cast<const float4*>(scat);
    for (int p = row_ptr[r]; p < row_ptr[r + 1]; ++p) {
      const float4 a = s[(int64_t)p * 2], b = s[(int64_t)p * 2 + 1];
      nb[0] = add(nb[0], a.x);
      nb[1] = add(nb[1], a.y);
      nb[2] = add(nb[2], a.z);
      nb[3] = add(nb[3], a.w);
      nb[4] = add(nb[4], b.x);
      nb[5] = add(nb[5], b.y);
      nb[6] = add(nb[6], b.z);
    }
    const float4* ow = reinterpret_cast<const float4*>(own);
    const float4 a = ow[(int64_t)r * 2], b = ow[(int64_t)r * 2 + 1];
    const float o[7] = {a.x, a.y, a.z, a.w, b.x, b.y, b.z};
    for (int c = 0; c < 7; ++c) t[c] = add(o[c], nb[c]);
  }
  for (int a = 0; a < 3; ++a) d_means[(int64_t)r * 3 + a] = t[a];
  float dr[4] = {0.0f, 0.0f, 0.0f, 0.0f};
  if (t[3] != 0.0f || t[4] != 0.0f || t[5] != 0.0f || t[6] != 0.0f) {
    // rel = v * inv, inv = rsqrt(clamp(|v|^2, 1e-24)), v = rots ⊗ prev_inv
    const Quat q1 = load_quat(in.rots, r), q2 = load_quat(in.prev_inv, r);
    const Quat v = quat_mult(q1, q2);
    float inv, ss;
    normalize(v, inv, ss);
    const float g[4] = {t[3], t[4], t[5], t[6]};
    const float vv[4] = {v.w, v.x, v.y, v.z};
    const float dot = g[0] * vv[0] + g[1] * vv[1] + g[2] * vv[2] +
                      g[3] * vv[3];
    // d |v|^2 = -0.5 dot inv^3, passed where |v|^2 >= 1e-24
    const float dss = ss >= 1e-24f ? -0.5f * dot * (inv * inv * inv) : 0.0f;
    float dv[4];
    for (int c = 0; c < 4; ++c) dv[c] = g[c] * inv + dss * (2.0f * vv[c]);
    // d q1 of q1 ⊗ q2 (q2 = prev_inv)
    dr[0] = dv[0] * q2.w + dv[1] * q2.x + dv[2] * q2.y + dv[3] * q2.z;
    dr[1] = -dv[0] * q2.x + dv[1] * q2.w - dv[2] * q2.z + dv[3] * q2.y;
    dr[2] = -dv[0] * q2.y + dv[1] * q2.z + dv[2] * q2.w - dv[3] * q2.x;
    dr[3] = -dv[0] * q2.z - dv[1] * q2.y + dv[2] * q2.x + dv[3] * q2.w;
  }
  reinterpret_cast<float4*>(d_rots)[r] = make_float4(dr[0], dr[1], dr[2],
                                                     dr[3]);
}

Inputs make_inputs(const float* means, const float* rots,
                   const float* prev_inv, const unsigned char* fg,
                   const int* idx, const float* weight, const float* dist,
                   const float* prev_offset, int n_dst, int k,
                   int rows_per_block) {
  return Inputs{means, rots, prev_inv, fg, idx, weight, dist, prev_offset,
                n_dst, k, rows_per_block};
}

bool bad_shape(int n_dst, int k, int rows_per_block) {
  return n_dst < 0 || k < 1 || rows_per_block < 1 ||
         rows_per_block > THREADS || rows_per_block * k > MAX_EDGES;
}

}  // namespace

extern "C" {

// d3g_physics_fwd: passes 1 and 2. part (nb * 3) float and part_count (nb)
// int are scratch, nb = ceil(n_dst / rows_per_block); the losses and the
// count are written to four 0-d float tensors. `runs`, when not null,
// counts each run.
int d3g_physics_fwd(const float* means, const float* rots,
                    const float* prev_inv, const unsigned char* fg,
                    const int* idx, const float* weight, const float* dist,
                    const float* prev_offset, int n_dst, int k,
                    int rows_per_block, float* part, int* part_count,
                    float* out_rigid, float* out_rot, float* out_iso,
                    float* out_count, unsigned long long* runs,
                    void* stream) {
  if (bad_shape(n_dst, k, rows_per_block))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const Inputs in = make_inputs(means, rots, prev_inv, fg, idx, weight, dist,
                                prev_offset, n_dst, k, rows_per_block);
  const int nb = (n_dst + rows_per_block - 1) / rows_per_block;
  if (nb > 0) {
    const size_t smem = (size_t)rows_per_block * ROW_F * sizeof(float);
    p1_fwd_partial<<<nb, THREADS, smem, s>>>(in, part, part_count);
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  p1_fwd_final<<<1, THREADS, 0, s>>>(part, part_count, nb, out_rigid,
                                     out_rot, out_iso, out_count, runs);
  return static_cast<int>(cudaGetLastError());
}

// d3g_physics_bwd: passes 3 and 4. g_rigid, g_rot, g_iso: the upstream
// scalars on the device (null: 0); count: the forward's. scat (n_dst K * 8)
// and own (n_dst * 8) float are scratch; d_means (cap, 3) and d_rots (cap,
// 4) are written whole.
int d3g_physics_bwd(const float* means, const float* rots,
                    const float* prev_inv, const unsigned char* fg,
                    const int* idx, const float* weight, const float* dist,
                    const float* prev_offset, int n_dst, int k,
                    int rows_per_block, int cap, const float* g_rigid,
                    const float* g_rot, const float* g_iso,
                    const float* count, const int* rank, const int* row_ptr,
                    float* scat, float* own, float* d_means, float* d_rots,
                    unsigned long long* runs, void* stream) {
  if (bad_shape(n_dst, k, rows_per_block) || cap < n_dst)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const Inputs in = make_inputs(means, rots, prev_inv, fg, idx, weight, dist,
                                prev_offset, n_dst, k, rows_per_block);
  const int nb = (n_dst + rows_per_block - 1) / rows_per_block;
  if (nb > 0) {
    const size_t smem = (size_t)rows_per_block * (ROW_F + k * OWN_F) *
                        sizeof(float);
    p1_bwd_edges<<<nb, THREADS, smem, s>>>(in, g_rigid, g_rot, g_iso, count,
                                           rank, scat, own);
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  const int rb = (cap + THREADS - 1) / THREADS;
  if (rb > 0)
    p1_bwd_rows<<<rb, THREADS, 0, s>>>(in, cap, row_ptr, scat, own, d_means,
                                       d_rots, runs);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
