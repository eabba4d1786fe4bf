// Fused per-tile Gaussian composite, backward — hand-written for Hopper (sm_90a).
//
// Replaces instag_tpu/ops/pallas_composite.py::_bwd_kernel (reached through
// _bwd_call / the custom VJP of composite_tiles_fused): the analytic VJP of
// composite_fwd.cu. Inputs are the forward's feats [F, T, K] and cnt [T],
// and the cotangent g [T, C+2+A, 256] of its output (C channel rows, alpha,
// T_final, A aux rows). Output dfeats [F, T, K]: per (tile, slot) the
// gradient of each feature row; rows >= 6+C+A and slots the walk never
// reaches are zero. For pixel p and contributing slot i (front to back):
//   G_i      = sum_c g_c chan_ci + g_alpha            (dL/dw_i; aux excluded)
//   S_i      = sum_{j>i} G_j w_j                      (suffix sum)
//   dalpha_i = G_i T_excl_i - (S_i + g_T T_final) / (1 - alpha_i)
//   dpow_i   = dalpha_i op e^power   if alpha_i < 0.99 (not clamped), else 0
// and summed over the tile's 256 pixels:
//   d px = A sum(dpow dx) + B sum(dpow dy),  d py = C sum(dpow dy) + B sum(dpow dx)
//   d A = -1/2 sum(dpow dx^2), d B = -sum(dpow dx dy), d C = -1/2 sum(dpow dy^2)
//   d op = sum(dpow) / op,     d chan_c = sum(g_c w),  d aux_a = sum(g_aux_a w)
// The aux rows see stop-gradient weights: they get g_aux w and add nothing
// to dalpha, as in the TPU kernel.
//
// What bounds it on an H100: bytes, mostly the dense dfeats written once
// (F*T*K floats, 16.8 MB at the training shape C=8, A=2, K=256, 1024
// tiles at 512^2) plus the feats of the valid slots and the g of the busy
// tiles: ~5.3 us at 3.35 TB/s. The pair arithmetic, a forward recompute
// and the gradient terms (~49 + 6C + 4A fp32 operations per evaluated
// pixel-splat pair), is ~3.4 us at the fp32 peak. This first version takes
// ~0.23 ms on an H100 at that shape (PERF.md): like the forward, its work
// sits in the few busy tiles, where each pixel walks a dependent chain of
// transcendentals, here three times (the forward recompute, the batch
// recompute and the reverse sweep), and each slot needs 6 + C + A sums
// over 256 pixels.
//
// Design: one CTA per tile, one thread per pixel.
//   Pass 1 recomputes the forward with the per-pixel sequential log-T carry
//   of composite_fwd.cu (the step is shared through composite_common.cuh),
//   so every contribution decision is the forward's, bit for bit. It keeps
//   each pixel's stop slot and T_final, and the entry log-T of every batch
//   of 32 slots in shared memory.
//   Pass 2 walks the batches back to front. It recomputes the batch's chain
//   from its entry (log-T after each slot into shared memory), then runs
//   back through it carrying S per pixel. Each slot's 6 + C + A per-pixel
//   terms are summed by warp shuffles (skipped when no lane of the warp
//   contributes) into shared memory, one partial per warp; the 8 partials
//   are then added in a fixed order and one thread writes each
//   (row, tile, slot) value. No global atomics; the result is
//   deterministic. An empty tile is zero-filled without reading its g.
//   float32 throughout, no tensor cores, no fast-math exp.

#include <cuda_runtime.h>

#include "composite_common.cuh"

namespace {

using instag::kPix;
using instag::kTile;
using instag::kTMin;
constexpr int kBatch = 32;            // slots per batch of the reverse sweep
constexpr int kWarps = kPix / 32;

template <int NV>
size_t shared_bytes(int K) {
  const int n_batches = (K + kBatch - 1) / kBatch;
  return sizeof(float) * ((6 + NV) * kBatch * (2 + kWarps)
                          + static_cast<size_t>(n_batches + kBatch) * kPix);
}

template <int NV>  // NV = C + A value rows
__global__ void __launch_bounds__(kPix)
composite_bwd_kernel(const float* __restrict__ feats,
                     const int* __restrict__ cnt,
                     const float* __restrict__ g,
                     float* __restrict__ dfeats,
                     int F, int T, int K, int tiles_x, int n_chan) {
  constexpr int kRows = 6 + NV;       // feature rows read and written
  extern __shared__ float smem[];
  const int n_batches = (K + kBatch - 1) / kBatch;
  float* s_feat = smem;                               // [kRows][kBatch]
  float* s_entry = s_feat + kRows * kBatch;           // [n_batches][kPix]
  float* s_logt = s_entry + n_batches * kPix;         // [kBatch][kPix]
  float* s_part = s_logt + kBatch * kPix;             // [kWarps][kRows][kBatch]
  float* s_sum = s_part + kWarps * kRows * kBatch;    // [kRows][kBatch]
  __shared__ int s_used;

  const int t = blockIdx.x;
  const int p = threadIdx.x;
  const int lane = p & 31;
  const int warp = p >> 5;
  const int n = min(cnt[t], K);
  const float xf = static_cast<float>(p % kTile);
  const float yf = static_cast<float>(p / kTile);
  const float txf = static_cast<float>((t % tiles_x) * kTile);
  const float tyf = static_cast<float>((t / tiles_x) * kTile);
  const size_t row_stride = static_cast<size_t>(T) * K;
  float* out_t = dfeats + static_cast<size_t>(t) * K;  // row r: + r*row_stride

  if (n == 0) {  // an empty tile: zeros, and its cotangents are never read
    for (int r = 0; r < F; ++r)
      for (int k = p; k < K; k += kPix) out_t[r * row_stride + k] = 0.f;
    return;
  }

  // ---- pass 1: the forward chain, as composite_fwd.cu walks it ----------
  if (p == 0) s_used = 0;
  __syncthreads();
  float log_t = 0.f;      // full carry: transmittance and contribution
  float log_t_c = 0.f;    // contributing-only carry: T_final
  int stop = n;           // first slot that does not contribute (n if none)
  bool done = false;
  for (int b = 0; b * kBatch < n; ++b) {
    const int base = b * kBatch;
    const int nb = min(kBatch, n - base);
    __syncthreads();  // the previous batch is no longer read
    if (p < 6 * kBatch) {
      const int r = p / kBatch, j = p % kBatch;
      if (j < nb)
        s_feat[r * kBatch + j] =
            feats[(static_cast<size_t>(r) * T + t) * K + base + j];
    }
    __syncthreads();
    s_entry[b * kPix + p] = log_t;
    if (!done) {
      for (int j = 0; j < nb; ++j) {
        const instag::SplatAlpha s = instag::splat_alpha(
            xf, yf, __fsub_rn(s_feat[0 * kBatch + j], txf),
            __fsub_rn(s_feat[1 * kBatch + j], tyf), s_feat[2 * kBatch + j],
            s_feat[3 * kBatch + j], s_feat[4 * kBatch + j],
            s_feat[5 * kBatch + j]);
        if (!s.ok) continue;
        const float l = instag::log_step(s.alpha);
        log_t = __fadd_rn(log_t, l);
        if (!(expf(log_t) >= kTMin)) {
          done = true;
          stop = base + j;
          break;
        }
        log_t_c = __fadd_rn(log_t_c, l);
      }
    }
    if (__syncthreads_and(done)) break;
  }
  atomicMax(&s_used, stop);

  // ---- this pixel's cotangents --------------------------------------------
  const float* g_p = g + static_cast<size_t>(t) * (NV + 2) * kPix + p;
  float gv[NV];  // channel rows, then aux rows (feature row order)
#pragma unroll
  for (int c = 0; c < NV; ++c)
    gv[c] = g_p[(c < n_chan ? c : c + 2) * kPix];
  const float g_alpha = g_p[n_chan * kPix];
  const float btf = g_p[(n_chan + 1) * kPix] * expf(log_t_c);
  __syncthreads();
  const int used = s_used;  // slots past every pixel's stop have zero grads
  const int n_used_batches = (used + kBatch - 1) / kBatch;

  // ---- pass 2: batches back to front --------------------------------------
  float S = 0.f;
  for (int b = n_used_batches - 1; b >= 0; --b) {
    const int base = b * kBatch;
    const int nb = min(kBatch, n - base);
    __syncthreads();  // the previous batch's shared arrays are no longer read
    for (int i = p; i < kRows * kBatch; i += kPix) {
      const int r = i / kBatch, j = i % kBatch;
      s_feat[i] = j < nb
          ? feats[(static_cast<size_t>(r) * T + t) * K + base + j] : 0.f;
    }
    __syncthreads();

    // the batch's chain from its recorded entry: log-T after each slot
    float lt = s_entry[b * kPix + p];
    for (int j = 0; j < nb && base + j < stop; ++j) {
      const instag::SplatAlpha s = instag::splat_alpha(
          xf, yf, __fsub_rn(s_feat[0 * kBatch + j], txf),
          __fsub_rn(s_feat[1 * kBatch + j], tyf), s_feat[2 * kBatch + j],
          s_feat[3 * kBatch + j], s_feat[4 * kBatch + j],
          s_feat[5 * kBatch + j]);
      if (s.ok) lt = __fadd_rn(lt, instag::log_step(s.alpha));
      s_logt[j * kPix + p] = lt;
    }

    for (int j = nb - 1; j >= 0; --j) {
      float q[kRows];
#pragma unroll
      for (int r = 0; r < kRows; ++r) q[r] = 0.f;
      bool active = false;
      if (base + j < stop) {
        const instag::SplatAlpha s = instag::splat_alpha(
            xf, yf, __fsub_rn(s_feat[0 * kBatch + j], txf),
            __fsub_rn(s_feat[1 * kBatch + j], tyf), s_feat[2 * kBatch + j],
            s_feat[3 * kBatch + j], s_feat[4 * kBatch + j],
            s_feat[5 * kBatch + j]);
        if (s.ok) {
          active = true;
          const float t_incl = expf(s_logt[j * kPix + p]);
          const float one_m = 1.f - s.alpha;
          const float w = t_incl * s.alpha / one_m;
          const float t_excl = t_incl / one_m;
          float G = g_alpha;
#pragma unroll
          for (int c = 0; c < NV; ++c)
            if (c < n_chan) G += s_feat[(6 + c) * kBatch + j] * gv[c];
          const float dalpha = G * t_excl - (S + btf) / one_m;
          const float dpow = s.pre < 0.99f ? dalpha * s.pre : 0.f;
          q[0] = dpow;
          q[1] = dpow * s.dx;
          q[2] = dpow * s.dy;
          q[3] = dpow * s.dx * s.dx;
          q[4] = dpow * s.dx * s.dy;
          q[5] = dpow * s.dy * s.dy;
#pragma unroll
          for (int c = 0; c < NV; ++c) q[6 + c] = gv[c] * w;
          S += G * w;
        }
      }
      float* part = s_part + warp * kRows * kBatch + j;
      if (__any_sync(0xffffffffu, active)) {
#pragma unroll
        for (int r = 0; r < kRows; ++r) {
          float v = q[r];
#pragma unroll
          for (int off = 16; off > 0; off >>= 1)
            v += __shfl_down_sync(0xffffffffu, v, off);
          if (lane == 0) part[r * kBatch] = v;
        }
      } else if (lane == 0) {
#pragma unroll
        for (int r = 0; r < kRows; ++r) part[r * kBatch] = 0.f;
      }
    }
    __syncthreads();

    // the 8 warp partials, in a fixed order
    for (int i = p; i < kRows * kBatch; i += kPix) {
      float v = 0.f;
#pragma unroll
      for (int w = 0; w < kWarps; ++w) v += s_part[w * kRows * kBatch + i];
      s_sum[i] = v;
    }
    __syncthreads();

    // one thread per (row, slot): moments -> feature-row gradients
    for (int i = p; i < kRows * kBatch; i += kPix) {
      const int r = i / kBatch, j = i % kBatch;
      if (j >= nb) continue;
      const float m1 = s_sum[0 * kBatch + j];
      const float mx = s_sum[1 * kBatch + j];
      const float my = s_sum[2 * kBatch + j];
      float v;
      switch (r) {
        case 0: v = s_feat[2 * kBatch + j] * mx + s_feat[3 * kBatch + j] * my; break;
        case 1: v = s_feat[4 * kBatch + j] * my + s_feat[3 * kBatch + j] * mx; break;
        case 2: v = -0.5f * s_sum[3 * kBatch + j]; break;
        case 3: v = -s_sum[4 * kBatch + j]; break;
        case 4: v = -0.5f * s_sum[5 * kBatch + j]; break;
        case 5: {
          const float op = s_feat[5 * kBatch + j];
          v = op > 0.f ? m1 / fmaxf(op, 1e-20f) : 0.f;
          break;
        }
        default: v = s_sum[i];
      }
      out_t[r * row_stride + base + j] = v;
    }
  }

  // ---- zeros: slots past the walk, and rows past 6 + C + A -------------
  const int written = min(n_used_batches * kBatch, n);
  for (int r = 0; r < F; ++r) {
    for (int k = (r < kRows ? written : 0) + p; k < K; k += kPix)
      out_t[r * row_stride + k] = 0.f;
  }
}

template <int NV>
cudaError_t launch(const float* feats, const int* cnt, const float* g,
                   float* dfeats, int F, int T, int K, int tiles_x,
                   int n_chan, cudaStream_t stream) {
  const size_t bytes = shared_bytes<NV>(K);
  cudaError_t err = cudaFuncSetAttribute(
      composite_bwd_kernel<NV>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(bytes));
  if (err != cudaSuccess) return err;
  if (T > 0)
    composite_bwd_kernel<NV><<<T, kPix, bytes, stream>>>(
        feats, cnt, g, dfeats, F, T, K, tiles_x, n_chan);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// Launches on `stream`; returns cudaGetLastError() after the launch.
// g is [T, n_chan + 2 + n_aux, 256]; n_chan + n_aux must be in [1, 16] and
// F >= 6 + n_chan + n_aux. Writes every element of dfeats [F, T, K].
int composite_bwd_launch(const void* feats, const void* cnt, const void* g,
                         void* dfeats, int F, int T, int K, int tiles_x,
                         int n_chan, int n_aux, void* stream) {
  const float* f = static_cast<const float*>(feats);
  const int* c = static_cast<const int*>(cnt);
  const float* gg = static_cast<const float*>(g);
  float* d = static_cast<float*>(dfeats);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (n_chan + n_aux) {
#define INSTAG_CASE(nv) \
  case nv:              \
    return launch<nv>(f, c, gg, d, F, T, K, tiles_x, n_chan, s);
    INSTAG_CASE(1) INSTAG_CASE(2) INSTAG_CASE(3) INSTAG_CASE(4)
    INSTAG_CASE(5) INSTAG_CASE(6) INSTAG_CASE(7) INSTAG_CASE(8)
    INSTAG_CASE(9) INSTAG_CASE(10) INSTAG_CASE(11) INSTAG_CASE(12)
    INSTAG_CASE(13) INSTAG_CASE(14) INSTAG_CASE(15) INSTAG_CASE(16)
#undef INSTAG_CASE
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

const char* composite_bwd_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
