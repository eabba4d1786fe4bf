// Per-pixel splat step shared by composite_fwd.cu and composite_bwd.cu.
//
// The backward recomputes the forward's transmittance chain and must take
// every contribution decision (T_incl >= 1e-4) exactly as the forward that
// produced the loss did. Both kernels therefore evaluate a splat here, and
// the arithmetic uses the round-to-nearest intrinsics, which the compiler
// may not contract into fused multiply-adds: the same inputs give the same
// bits in either kernel, whatever code surrounds the call.
#pragma once

#include <cuda_runtime.h>

namespace instag {

constexpr int kTile = 16;
constexpr int kPix = kTile * kTile;   // threads per CTA: one per pixel
constexpr float kAlphaMin = 1.0f / 255.0f;
constexpr float kTMin = 1e-4f;

struct SplatAlpha {
  float dx, dy;     // pixel minus splat centre, tile-local
  float power;      // -1/2 (A dx^2 + C dy^2) - B dx dy
  float pre;        // op * e^power (before the 0.99 clamp)
  float alpha;      // min(0.99, pre)
  bool ok;          // power <= 0 and alpha >= 1/255
};

// Splat (gx, gy, conic A/B/C, opacity) at tile-local pixel (xf, yf); gx and
// gy are already tile-local (px - tile x0, py - tile y0).
__device__ __forceinline__ SplatAlpha splat_alpha(float xf, float yf,
                                                  float gx, float gy,
                                                  float ca, float cb,
                                                  float cc, float op) {
  SplatAlpha s;
  s.dx = __fsub_rn(xf, gx);
  s.dy = __fsub_rn(yf, gy);
  const float quad = __fadd_rn(__fmul_rn(__fmul_rn(ca, s.dx), s.dx),
                               __fmul_rn(__fmul_rn(cc, s.dy), s.dy));
  s.power = __fsub_rn(__fmul_rn(-0.5f, quad),
                      __fmul_rn(__fmul_rn(cb, s.dx), s.dy));
  s.pre = __fmul_rn(op, expf(s.power));
  s.alpha = fminf(0.99f, s.pre);
  s.ok = s.power <= 0.f && s.alpha >= kAlphaMin;
  return s;
}

// log1p(-alpha), the per-splat step of the log transmittance.
__device__ __forceinline__ float log_step(float alpha) {
  return log1pf(-alpha);
}

}  // namespace instag
