// Fused per-tile Gaussian composite, forward — hand-written for Hopper (sm_90a).
//
// Replaces instag_tpu/ops/pallas_composite.py::_fwd_kernel (reached through
// _fwd_call / composite_tiles_fused). Same [F, T, K] contract:
//   feats rows: 0 px, 1 py, 2 conicA, 3 conicB, 4 conicC, 5 opacity,
//               6..6+C-1 composited channels, then A aux channels
//               (slots >= cnt[t] carry opacity 0; valid slots are a prefix);
//   out [T, C+2+A, 256] channel-major: C channel sums, alpha (sum of w),
//               T_final, A aux sums.
// For tile t at (tx*16, ty*16) and tile-local pixel (x, y), slots k < cnt[t]
// are walked front to back:
//   power = -1/2 (A dx^2 + C dy^2) - B dx dy,   dx = x - (px - tx*16), ...
//   alpha = min(0.99, op e^power), 0 unless power <= 0 and alpha >= 1/255
//   logT += log1p(-alpha);  contributes iff exp(logT) >= 1e-4,
//   with weight w = exp(logT) alpha / (1 - alpha) (= T_excl alpha).
// T_final integrates log1p(-alpha) over contributing splats only.
//
// What bounds it on an H100: the least time is set by bytes, the feats of
// the valid slots read once ((6+C+A) * sum(cnt) floats) plus the output
// written once ((C+2+A) * 256 floats per tile): ~11 MB, ~3.3 us at the
// serving shape (C=8, A=0, K=256, 1024 tiles at 512^2). The pair work,
// ~26 + 2(C+A) fp32 operations (three of them exp/log1p) for each of at
// most sum(cnt) * 256 pixel-splat pairs, is ~1.4 us at the fp32 peak. This
// first version reaches neither: on an H100 at that shape it takes ~70 us
// (PERF.md), because the splats sit in a few busy tiles and each pixel's
// walk over them is one dependent chain (each splat's transmittance needs
// the one before), so the busy CTAs are latency bound.
//
// Design: one CTA per tile, one thread per pixel (256 threads). The splats'
// rows are staged through shared memory in batches of 256 (every thread
// then reads the same address: a broadcast). The transmittance carry stays
// in the log domain, as on the TPU, so contribution decisions match it at
// the 1e-4 edge. The per-splat step lives in composite_common.cuh, shared
// with the backward, which recomputes this chain bit for bit. The
// contribution test is monotone in k, so a pixel is done at its first
// non-contributing splat (exact), and the CTA leaves once all 256 pixels
// are done or the batches pass cnt[t]. float32 throughout; no tensor cores.

#include <cuda_runtime.h>

#include "composite_common.cuh"

namespace {

using instag::kPix;
using instag::kTile;
using instag::kTMin;
constexpr int kBatch = 256;           // splats staged per batch

template <int NV>  // NV = C + A accumulated value rows
__global__ void __launch_bounds__(kPix)
composite_fwd_kernel(const float* __restrict__ feats,
                     const int* __restrict__ cnt,
                     float* __restrict__ out,
                     int T, int K, int tiles_x, int n_chan) {
  constexpr int kRows = 6 + NV;
  __shared__ float sm[kRows * kBatch];

  const int t = blockIdx.x;
  const int p = threadIdx.x;
  const int n = min(cnt[t], K);
  const float xf = static_cast<float>(p % kTile);
  const float yf = static_cast<float>(p / kTile);
  const float txf = static_cast<float>((t % tiles_x) * kTile);
  const float tyf = static_cast<float>((t / tiles_x) * kTile);

  float acc[NV];
#pragma unroll
  for (int c = 0; c < NV; ++c) acc[c] = 0.f;
  float wsum = 0.f;
  float log_t = 0.f;       // full carry: drives transmittance / contribution
  float log_t_c = 0.f;     // contributing-only carry: T_final
  bool done = false;

  for (int base = 0; base < n; base += kBatch) {
    const int nb = min(kBatch, n - base);
    __syncthreads();  // the previous batch is no longer read
    if (p < nb) {
#pragma unroll
      for (int r = 0; r < kRows; ++r)
        sm[r * kBatch + p] = feats[(static_cast<size_t>(r) * T + t) * K + base + p];
    }
    __syncthreads();
    if (!done) {
      for (int j = 0; j < nb; ++j) {
        const instag::SplatAlpha s = instag::splat_alpha(
            xf, yf, __fsub_rn(sm[0 * kBatch + j], txf),
            __fsub_rn(sm[1 * kBatch + j], tyf), sm[2 * kBatch + j],
            sm[3 * kBatch + j], sm[4 * kBatch + j], sm[5 * kBatch + j]);
        if (!s.ok) continue;  // log1p(-0) = 0
        const float alpha = s.alpha;
        const float l = instag::log_step(alpha);
        log_t = __fadd_rn(log_t, l);
        const float t_incl = expf(log_t);
        if (!(t_incl >= kTMin)) {  // no later splat can contribute
          done = true;
          break;
        }
        const float w = t_incl * alpha / (1.f - alpha);
        log_t_c = __fadd_rn(log_t_c, l);
        wsum += w;
#pragma unroll
        for (int c = 0; c < NV; ++c) acc[c] += w * sm[(6 + c) * kBatch + j];
      }
    }
    if (__syncthreads_and(done)) break;
  }

  float* o = out + static_cast<size_t>(t) * (NV + 2) * kPix + p;
#pragma unroll
  for (int c = 0; c < NV; ++c) {
    const int row = c < n_chan ? c : c + 2;  // aux rows follow alpha, T_final
    o[row * kPix] = acc[c];
  }
  o[n_chan * kPix] = wsum;
  o[(n_chan + 1) * kPix] = expf(log_t_c);
}

template <int NV>
cudaError_t launch(const float* feats, const int* cnt, float* out, int T,
                   int K, int tiles_x, int n_chan, cudaStream_t stream) {
  if (T > 0)
    composite_fwd_kernel<NV><<<T, kPix, 0, stream>>>(feats, cnt, out, T, K,
                                                     tiles_x, n_chan);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// Launches on `stream`; returns cudaGetLastError() after the launch.
// n_chan + n_aux must be in [1, 16].
int composite_fwd_launch(const void* feats, const void* cnt, void* out, int T,
                         int K, int tiles_x, int n_chan, int n_aux,
                         void* stream) {
  const float* f = static_cast<const float*>(feats);
  const int* c = static_cast<const int*>(cnt);
  float* o = static_cast<float*>(out);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (n_chan + n_aux) {
#define INSTAG_CASE(nv) \
  case nv:              \
    return launch<nv>(f, c, o, T, K, tiles_x, n_chan, s);
    INSTAG_CASE(1) INSTAG_CASE(2) INSTAG_CASE(3) INSTAG_CASE(4)
    INSTAG_CASE(5) INSTAG_CASE(6) INSTAG_CASE(7) INSTAG_CASE(8)
    INSTAG_CASE(9) INSTAG_CASE(10) INSTAG_CASE(11) INSTAG_CASE(12)
    INSTAG_CASE(13) INSTAG_CASE(14) INSTAG_CASE(15) INSTAG_CASE(16)
#undef INSTAG_CASE
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

const char* composite_fwd_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
