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
// log2 e, so transmittance runs in base 2), 5 opacity.

#pragma once

namespace d3g {

constexpr int GEOM_ROWS = 8;
constexpr float ALPHA_EPS = 1.0f / 255.0f;
constexpr float ALPHA_MAX = 0.99f;
constexpr float LOG2_T_DEAD = -13.287712379549449f;  // log2(1e-4)
constexpr float LN2 = 0.6931471805599453f;

struct AlphaCell {
  float dx, dy;  // record center minus pixel center
  float p0;      // -(a dx^2 + c dy^2)/2 - b dx dy, before the clamp at 0
  float e;       // 2^min(p0, 0)
  float raw;     // opacity * e, before the clamp at ALPHA_MAX
  float alpha;   // min(ALPHA_MAX, raw); the cell is live iff alpha >= EPS
};

// Alpha of record j (column of the staged chunk `rec`) at pixel (px, py).
__device__ __forceinline__ AlphaCell alpha_cell(const float* rec, int chunk,
                                                int j, float px, float py) {
  AlphaCell c;
  const float ca = rec[2 * chunk + j];
  const float cb = rec[3 * chunk + j];
  const float cc = rec[4 * chunk + j];
  const float op = rec[5 * chunk + j];
  c.dx = __fsub_rn(rec[0 * chunk + j], px);
  c.dy = __fsub_rn(rec[1 * chunk + j], py);
  const float quad = __fadd_rn(__fmul_rn(__fmul_rn(ca, c.dx), c.dx),
                               __fmul_rn(__fmul_rn(cc, c.dy), c.dy));
  c.p0 = __fsub_rn(__fmul_rn(-0.5f, quad),
                   __fmul_rn(__fmul_rn(cb, c.dx), c.dy));
  c.e = exp2f(fminf(c.p0, 0.0f));
  c.raw = __fmul_rn(op, c.e);
  c.alpha = fminf(ALPHA_MAX, c.raw);
  return c;
}

__device__ __forceinline__ bool alpha_live(const AlphaCell& c) {
  return c.alpha >= ALPHA_EPS;
}

// log2(1 - alpha), the cell's step of log2 transmittance.
__device__ __forceinline__ float log2_one_minus(float alpha) {
  return log2f(__fsub_rn(1.0f, alpha));
}

}  // namespace d3g
