// Per-pixel splat step and log-T carry shared by composite_fwd.cu and
// composite_bwd.cu.
//
// The backward recomputes the forward's transmittance chain and must take
// every contribution decision (T_incl >= 1e-4) exactly as the forward that
// produced the loss did. Both kernels therefore evaluate a splat here, and
// the arithmetic uses the round-to-nearest intrinsics, which the compiler
// may not contract into fused multiply-adds: the same inputs give the same
// bits in either kernel, whatever code surrounds the call. Both run the
// serial carry of those steps through carry_group below.
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

// Exclusive prefix of one int per thread, in thread order, over a CTA of
// kThreads threads; *total gets the CTA's sum. Every thread must call it.
template <int kThreads>
__device__ __forceinline__ int block_exclusive_sum(int v, int* s_warp,
                                                   int* total) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  int incl = v;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const int y = __shfl_up_sync(0xffffffffu, incl, o);
    if (lane >= o) incl += y;
  }
  if (lane == 31) s_warp[warp] = incl;
  __syncthreads();
  int before = 0, sum = 0;
#pragma unroll
  for (int w = 0; w < kThreads / 32; ++w) {
    const int x = s_warp[w];
    before += w < warp ? x : 0;
    sum += x;
  }
  *total = sum;
  __syncthreads();  // s_warp may be written again
  return before + incl - v;
}

// expf(x) >= 1.2e-4 for every x above this: the stop test cannot fail there.
constexpr float kLogTSure = -9.0f;

// The serial log-T carry over a group of 8 slots, in slot order. step[u] is
// log_step(alpha) of slot u where the slot is ok (always < 0, since alpha >=
// 1/255) and 0 where it is not or lies past the segment: adding 0 leaves the
// sum's bits alone, so the 8 sums are taken first, and since log-T never
// rises one compare of the last settles all 8 stop tests unless it reaches
// kLogTSure; there each slot runs the forward's exact test expf(log_t) >=
// 1e-4. log_t (the contributing slots' sum) and done carry across calls.
// Returns the mask of contributing slots; a slot that stops the pixel sets
// done and stop = at + u. A contributing slot's log T is the running
// __fadd_rn sum of step[0..u] from the log_t the group started with.
__device__ __forceinline__ unsigned carry_group(const float (&step)[8],
                                                float& log_t, bool& done,
                                                int at, int& stop) {
  float run = log_t;
#pragma unroll
  for (int u = 0; u < 8; ++u) run = __fadd_rn(run, step[u]);
  unsigned keep = 0;
  if (!done && run > kLogTSure) {  // every slot's test passes
    log_t = run;
#pragma unroll
    for (int u = 0; u < 8; ++u) keep |= (step[u] < 0.f ? 1u : 0u) << u;
    return keep;
  }
#pragma unroll
  for (int u = 0; u < 8; ++u) {
    if (!done && step[u] < 0.f) {
      const float next = __fadd_rn(log_t, step[u]);
      if (next > kLogTSure || expf(next) >= kTMin) {
        log_t = next;
        keep |= 1u << u;
      } else {
        done = true;
        stop = at + u;
      }
    }
  }
  return keep;
}

}  // namespace instag
