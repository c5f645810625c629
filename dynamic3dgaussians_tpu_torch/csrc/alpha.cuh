// The per-cell alpha chain shared by the forward (K1, raster_fwd.cu) and the
// backward (K2, raster_bwd.cu) tile kernels.
//
// Both kernels must see the same alpha for every (record, pixel) cell, bit
// for bit: a cell that sits on the 1/255 gate and falls on one side in the
// forward and on the other in the backward would give a gradient for a term
// the image never had. The chain is therefore written once, here, with
// explicitly rounded intrinsics (__fmul_rn, __fadd_rn, __fsub_rn) so that
// nvcc cannot contract any of it into FMAs; the plain PyTorch versions run
// the same operations one rounding at a time and agree with it too.
//
// Record rows (feature-major table, `chunk` columns staged in shared
// memory): 0 x, 1 y, 2 conic a, 3 conic b, 4 conic c (a, b, c pre-scaled by
// log2 e, so transmittance runs in base 2), 5 opacity, and under the fused
// variant (power_impl="mxu_fused") 6 r6 = log2(max(op, 2^-100)), 7 r7 =
// min(r6, log2 0.99), filled where the table is made (sorted_raster.py).

#pragma once

#include <cuda_bf16.h>
#include <stdint.h>

namespace d3g {

constexpr int GEOM_ROWS = 8;
constexpr float ALPHA_EPS = 1.0f / 255.0f;
constexpr float ALPHA_MAX = 0.99f;
constexpr float LOG2_T_DEAD = -13.287712379549449f;  // log2(1e-4)
constexpr float LN2 = 0.6931471805599453f;
// the fused variant's gate, log2(ALPHA_EPS), compared in log2-alpha space
constexpr float LOG2_ALPHA_EPS = -7.994353436858858f;

struct AlphaCell {
  float dx, dy;  // record center minus pixel center
  float p0;      // -(a dx^2 + c dy^2)/2 - b dx dy, before the clamp at 0
  float e;       // 2^min(p0, 0)
  float raw;     // opacity * e, before the clamp at ALPHA_MAX
  float alpha;   // min(ALPHA_MAX, raw); the cell is live iff alpha >= EPS
};

// p0 of record j (column of the staged chunk `rec`) at pixel (px, py),
// with the record's offsets dx, dy from the pixel.
__device__ __forceinline__ float power_p0(const float* rec, int chunk, int j,
                                          float px, float py, float& dx,
                                          float& dy) {
  const float ca = rec[2 * chunk + j];
  const float cb = rec[3 * chunk + j];
  const float cc = rec[4 * chunk + j];
  dx = __fsub_rn(rec[0 * chunk + j], px);
  dy = __fsub_rn(rec[1 * chunk + j], py);
  const float quad = __fadd_rn(__fmul_rn(__fmul_rn(ca, dx), dx),
                               __fmul_rn(__fmul_rn(cc, dy), dy));
  return __fsub_rn(__fmul_rn(-0.5f, quad), __fmul_rn(__fmul_rn(cb, dx), dy));
}

// Alpha of record j (column of the staged chunk `rec`) at pixel (px, py).
__device__ __forceinline__ AlphaCell alpha_cell(const float* rec, int chunk,
                                                int j, float px, float py) {
  AlphaCell c;
  const float op = rec[5 * chunk + j];
  c.p0 = power_p0(rec, chunk, j, px, py, c.dx, c.dy);
  c.e = exp2f(fminf(c.p0, 0.0f));
  c.raw = __fmul_rn(op, c.e);
  c.alpha = fminf(ALPHA_MAX, c.raw);
  return c;
}

// The fused variant's log2 alpha of record j at pixel (px, py), the
// reference's chunk_logalpha_fused: m = min(p0 + r6, r7), p0 unclamped (r7
// <= r6 caps it); the cell is live iff m >= LOG2_ALPHA_EPS, and then alpha
// = 2^m.
__device__ __forceinline__ float fused_log_alpha(const float* rec, int chunk,
                                                 int j, float px, float py) {
  float dx, dy;
  const float p0 = power_p0(rec, chunk, j, px, py, dx, dy);
  return fminf(__fadd_rn(p0, rec[6 * chunk + j]), rec[7 * chunk + j]);
}

// x rounded to bf16 (nearest even) and back: an operand of the TPU's single
// bf16 pass of a matrix product (kernel_precision="default").
__device__ __forceinline__ float bf16_rne(float x) {
  return __bfloat162float(__float2bfloat16_rn(x));
}

__device__ __forceinline__ bool alpha_live(const AlphaCell& c) {
  return c.alpha >= ALPHA_EPS;
}

// log2(1 - alpha), the cell's step of log2 transmittance.
__device__ __forceinline__ float log2_one_minus(float alpha) {
  return log2f(__fsub_rn(1.0f, alpha));
}

// ---------------------------------------------------------------------------
// The tile walk shared by K1 and K2: the footprint cull, the thread-to-pixel
// map and the asynchronous chunk staging.

constexpr unsigned FULL_MASK = 0xffffffffu;

// Conservative box [x_lo, x_hi] x [y_lo, y_hi] of the pixel centres at which
// a record can pass the 1/255 gate. A cell is live iff op * 2^p0 >= EPS with
// p0 = -Q/2, Q = a dx^2 + 2 b dx dy + c dy^2, i.e. iff Q <= 2 L, L =
// log2(op / EPS); on that ellipse |dx| <= sqrt(2L c / det) and |dy| <=
// sqrt(2L a / det), det = a c - b^2. The margins cover the rounding of the
// kernels' alpha chain: 2L is raised by 1e-5 and by a relative 64 u a c / det
// (u = 2^-24; the chain's rounding error of p0 is at most ~16 u (a c / det) Q
// for a positive definite conic), det is taken from below, and each extent
// gets 1e-4 relative and 0.01 px. op < EPS is dead at every pixel (raw = op
// * e with e <= 1): an empty box. A conic that is not positive definite, or
// anything NaN or infinite, gets an unbounded box (never culled). Under the
// fused variant the gate is m = min(p0 + r6, r7) >= log2(EPS) (the add
// rounds by at most 2.4e-7 at |m| < 8): L = r6 - log2(EPS), within 2.4e-7
// (the 1e-5 margin covers both), and r6 < log2(EPS) is dead at every pixel,
// since m <= r7 <= r6. Mirrored in Python by
// ops/cuda/raster_fwd.py::footprint_boxes.
struct Box {
  float x_lo, x_hi, y_lo, y_hi;
};

// The box of the ellipse Q <= l2 (l2 = 2 L) with its margins.
__device__ __forceinline__ Box box_of(float x, float y, float a, float b,
                                      float c, float l2) {
  const float inf = __int_as_float(0x7f800000);
  const float ac = __fmul_rn(a, c);
  // det from below: a c (1 - 2^-20) - b^2 (1 + 2^-20)
  const float det =
      __fsub_rn(__fmul_rn(ac, 0.99999904632568359375f),
                __fmul_rn(__fmul_rn(b, b), 1.00000095367431640625f));
  // (2 L + 1e-5)(1 + 1e-5 + 2^-18 a c / det)
  const float q = __fmul_rn(
      __fadd_rn(l2, 1e-5f),
      __fadd_rn(1.0f + 1e-5f,
                __fmul_rn(3.814697265625e-06f, __fdiv_rn(ac, det))));
  if (!(a > 0.0f && c > 0.0f && det > 0.0f && q < inf))
    return Box{-inf, inf, -inf, inf};
  const float rx = __fadd_rn(
      __fmul_rn(__fsqrt_rn(__fdiv_rn(__fmul_rn(q, c), det)), 1.0001f), 0.01f);
  const float ry = __fadd_rn(
      __fmul_rn(__fsqrt_rn(__fdiv_rn(__fmul_rn(q, a), det)), 1.0001f), 0.01f);
  return Box{__fsub_rn(x, rx), __fadd_rn(x, rx), __fsub_rn(y, ry),
             __fadd_rn(y, ry)};
}

__device__ __forceinline__ Box record_box(float x, float y, float a, float b,
                                          float c, float op) {
  const float inf = __int_as_float(0x7f800000);
  if (op < ALPHA_EPS) return Box{inf, -inf, inf, -inf};
  return box_of(x, y, a, b, c,
                __fmul_rn(2.0f, log2f(__fdiv_rn(op, ALPHA_EPS))));
}

__device__ __forceinline__ Box record_box_fused(float x, float y, float a,
                                                float b, float c, float r6) {
  const float inf = __int_as_float(0x7f800000);
  if (r6 < LOG2_ALPHA_EPS) return Box{inf, -inf, inf, -inf};
  return box_of(x, y, a, b, c,
                __fmul_rn(2.0f, __fsub_rn(r6, LOG2_ALPHA_EPS)));
}

// A warp's pixel rectangle [x0, x1] x [y0, y1] (pixel centres).
struct Rect {
  float x0, x1, y0, y1;
};

// false only if the box misses the rectangle (NaN bounds never miss).
__device__ __forceinline__ bool box_hits(const Box& b, const Rect& r) {
  return !(b.x_hi < r.x0 || b.x_lo > r.x1 || b.y_hi < r.y0 || b.y_lo > r.y1);
}

// The box rows kept beside a staged chunk: x_lo, x_hi, y_lo, y_hi.
__device__ __forceinline__ void store_box(float* box, int chunk, int j,
                                          const Box& b) {
  box[0 * chunk + j] = b.x_lo;
  box[1 * chunk + j] = b.x_hi;
  box[2 * chunk + j] = b.y_lo;
  box[3 * chunk + j] = b.y_hi;
}

__device__ __forceinline__ Box load_box(const float* box, int chunk, int j) {
  return Box{box[0 * chunk + j], box[1 * chunk + j], box[2 * chunk + j],
             box[3 * chunk + j]};
}

// The box of record `j` of the table column block starting at `src`, read
// from device memory (the geometry rows of the record table); FUSED: the
// fused variant's gate, from row 6.
template <bool FUSED = false>
__device__ __forceinline__ Box table_box(const float* __restrict__ src,
                                         int64_t ne_pad, int j) {
  if constexpr (FUSED)
    return record_box_fused(src[j], src[ne_pad + j], src[2 * ne_pad + j],
                            src[3 * ne_pad + j], src[4 * ne_pad + j],
                            src[6 * ne_pad + j]);
  else
    return record_box(src[j], src[ne_pad + j], src[2 * ne_pad + j],
                      src[3 * ne_pad + j], src[4 * ne_pad + j],
                      src[5 * ne_pad + j]);
}

// Tile-local pixel (lx, ly) of thread `tid`. When the tile splits into 8x4
// blocks, each warp takes one block (lanes row-major inside it, blocks
// row-major over the tile): a record's footprint meets fewer warps than
// with the row-major map, which stays for other tile shapes. Mirrored by
// ops/cuda/raster_fwd.py::warp_pixel_map.
__device__ __forceinline__ void pixel_of_thread(int tid, int tile_h,
                                                int tile_w, int& lx, int& ly) {
  if (tile_w % 8 == 0 && tile_h % 4 == 0) {
    const int warp = tid >> 5, lane = tid & 31;
    const int per_row = tile_w >> 3;
    const int wy = warp / per_row;
    lx = (warp - wy * per_row) * 8 + (lane & 7);
    ly = wy * 4 + (lane >> 3);
  } else {
    ly = tid / tile_w;
    lx = tid - ly * tile_w;
  }
}

// The rectangle spanned by the pixels of the lanes in `mask`.
__device__ __forceinline__ Rect warp_rect(unsigned mask, int gx, int gy) {
  return Rect{(float)__reduce_min_sync(mask, gx),
              (float)__reduce_max_sync(mask, gx),
              (float)__reduce_min_sync(mask, gy),
              (float)__reduce_max_sync(mask, gy)};
}

// Asynchronous copy of one chunk of the table (rows x chunk floats starting
// at column `col` of the (rows, ne_pad) table) into shared memory, 16 bytes
// per copy when the rows are 16-byte aligned, else 4. Thread `tid` copies
// elements tid, tid + nthreads, ... of the chunk; (r0, v0) is its first
// (row, column vector) and (r_step, v_step) the stride, all computed once
// per kernel, so the loop has no division. The caller commits and waits.
struct Stager {
  int per_row, r0, v0, r_step, v_step;
  bool vec;
};

__device__ __forceinline__ Stager make_stager(const float* rec, int64_t ne_pad,
                                              int chunk, int tid,
                                              int nthreads) {
  Stager s;
  s.vec = ((reinterpret_cast<uintptr_t>(rec) & 15) == 0) &&
          (ne_pad % 4 == 0) && (chunk % 4 == 0);
  s.per_row = s.vec ? chunk >> 2 : chunk;
  s.r0 = tid / s.per_row;
  s.v0 = tid - s.r0 * s.per_row;
  s.r_step = nthreads / s.per_row;
  s.v_step = nthreads - s.r_step * s.per_row;
  return s;
}

template <int ROWS>
__device__ __forceinline__ void stage_chunk(const Stager& s, float* dst,
                                            const float* __restrict__ rec,
                                            int64_t ne_pad, int64_t col,
                                            int chunk) {
  int r = s.r0, v = s.v0;
  while (r < ROWS) {
    const float* g = rec + (int64_t)r * ne_pad + col;
    float* d = dst + r * chunk;
    const unsigned sa = static_cast<unsigned>(__cvta_generic_to_shared(
        s.vec ? d + 4 * v : d + v));
    if (s.vec)
      asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(sa),
                   "l"(g + 4 * v));
    else
      asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(sa),
                   "l"(g + v));
    r += s.r_step;
    v += s.v_step;
    if (v >= s.per_row) {
      v -= s.per_row;
      ++r;
    }
  }
  asm volatile("cp.async.commit_group;\n" ::);
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

// Rounds to bf16 (nearest even), in place, the elements of rows [ROW_LO,
// ROWS) of a staged chunk that this thread copied (`stage_chunk`'s
// pattern): called after cp_async_wait_all, before the barrier that
// publishes the chunk, so each value is rounded once per chunk and not in
// every cell that reads it (the BF16 variants' value rows).
template <int ROWS, int ROW_LO>
__device__ __forceinline__ void round_staged_bf16(const Stager& s, float* dst,
                                                  int chunk) {
  int r = s.r0, v = s.v0;
  while (r < ROWS) {
    if (r >= ROW_LO) {
      float* d = dst + r * chunk;
      if (s.vec) {
        float4* q = reinterpret_cast<float4*>(d + 4 * v);
        float4 x = *q;
        x.x = bf16_rne(x.x);
        x.y = bf16_rne(x.y);
        x.z = bf16_rne(x.z);
        x.w = bf16_rne(x.w);
        *q = x;
      } else {
        d[v] = bf16_rne(d[v]);
      }
    }
    r += s.r_step;
    v += s.v_step;
    if (v >= s.per_row) {
      v -= s.per_row;
      ++r;
    }
  }
}

}  // namespace d3g
