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
// What bounds it on an H100 (3.35 TB/s, 67 TFLOP/s fp32): bytes, the feats
// of the valid slots read once ((6+C+A) * sum(cnt) floats) and the output
// written once ((C+2+A) * 256 floats a tile): 11 MB, 3.3 us at the serving
// shape (C=8, A=0, K=256, 1024 tiles at 512^2), 10.5 MB of it the idle
// tiles' output. The operations, 26 + 2(C+A) fp32 a pixel-splat pair, are
// 1.4 us for the synthetic face's 2.2 M pairs and 22-24 us (the bound) on a
// cloud that busies every tile (35.5 M pairs). Beyond both lies latency: a
// pixel's log-T carry is a chain of dependent adds in slot order (~240 on
// the face), and each pair's evaluation a chain of transcendentals.
// One CTA of 256 threads a tile, one thread a pixel walking its slots
// through a data-dependent break, takes 0.068 ms on the face, whose splats
// sit in 36 of 1024 tiles: 36 SMs do all the work, 8 warps each, every
// slot's transcendentals waiting on the one before. This design takes
// 0.022 ms there, and on the every-tile cloud 0.125 ms, within 1.5 % of
// that loop alone, on an NVIDIA H100 80GB HBM3 at 700 W (PERF.md).
//
// Design: two kernels, launched together on every call; each counts the
// busy tiles on the card and takes the tiles that are its own.
//   * composite_fwd_split_kernel, launched first, while the busy tiles are
//     few: S CTAs take each busy tile (the most, up to 16, with which every
//     part is resident at once), 256/S pixels and S threads a pixel each.
//     Per segment of 64 slots or fewer (2048 pairs)
//       (A) threads evaluate splat_alpha and log1p(-alpha) of the segment's
//           (slot, pixel) pairs into shared memory;
//       (B) one thread a pixel runs the serial log-T carry in slot order
//           (composite_common.cuh's carry_group, which the backward runs
//           too: __fadd_rn, one compare for 8 slots above log-T -9, the
//           exact expf test below it) and keeps log T of each contributing
//           slot;
//       (C) all threads form the weights (expf, the IEEE divide, off the
//           serial path) and the C + A channel sums and wsum of their slots.
//     (B) of segment s runs beside (A) of segment s + 1 on the pixel's
//     other threads, so the carry's latency hides behind the evaluation;
//     the segments stop once every pixel of the CTA is done. Rows are
//     staged by cp.async two segments ahead (three buffers): shared memory
//     does not grow with K. A pixel's S partial sums are added in lane
//     order: no float atomics, two runs give the same bits.
//   * composite_fwd_kernel, one CTA a tile, the split kernel's programmatic
//     dependent, which runs beside it: CTA t writes idle tile t (zeros,
//     T_final = 1) as float4 stores, and walks busy tile t one thread a
//     pixel when the busy tiles fill the card, where that loop is near the
//     instruction-issue limit. Kept apart from the split kernel so that
//     each gets its own registers: this loop keeps 40 to 48 and 5 to 6
//     CTAs an SM; the split kernel takes 80.
// Contribution decisions and T_final are the one-thread-a-pixel loop's bit
// for bit on either path (and the backward's pass 1's); the other rows
// differ from it only by the order of the sums.
// float32 throughout, no tensor cores, no fast-math exp.

#include <cuda_pipeline.h>
#include <cuda_runtime.h>

#include <cstdint>

#include "composite_common.cuh"

namespace {

using instag::kPix;
using instag::kTile;
using instag::kTMin;
constexpr int kThreads = kPix;        // 256
constexpr int kBatch = 256;           // slots a batch, one thread a pixel
constexpr int kMaxSeg = 64;           // slots a segment, split
constexpr int kMaxSplit = 16;         // CTAs per busy tile, at most
constexpr int kPairs = 2048;          // (slot, pixel) pairs a segment
constexpr int kSplitCtas = 3;         // split CTAs an SM: 80 registers
constexpr float kNoContrib = 1.f;     // log T marker of a slot that adds 0

template <int S>
struct Split {
  static constexpr int value = S;
};

// CTAs per busy tile, from the busy-tile count and the split kernel's
// resident CTAs: the most, up to 16, with which every part is resident at
// once; 1 (the one-thread-a-pixel kernel's) once 2 would not be.
__device__ __forceinline__ int split_for(int n_busy, int resident) {
  int s = 1;
  while (s < kMaxSplit && n_busy * 2 * s <= resident) s *= 2;
  return s;
}

// The busy tiles: every thread counts a run of ceil(T/256) tiles; returns
// the busy tiles before this thread's run, *n_busy the CTA's total.
__device__ __forceinline__ int count_busy(const int* cnt, int T, int K,
                                          int* s_scan, int* n_busy,
                                          int* t0, int* t1, int* mine) {
  const int per = (T + kThreads - 1) / kThreads;
  *t0 = min(T, static_cast<int>(threadIdx.x) * per);
  *t1 = min(T, *t0 + per);
  *mine = 0;
  for (int t = *t0; t < *t1; ++t) *mine += min(cnt[t], K) > 0;
  return instag::block_exclusive_sum<kThreads>(*mine, s_scan, n_busy);
}

// Idle tile t's output: zeros, and T_final = 1, as float4 stores.
template <int NV>
__device__ __forceinline__ void write_idle(float* out, int t, int n_chan) {
  constexpr int kOut = NV + 2;
  float4* o = reinterpret_cast<float4*>(out + static_cast<size_t>(t) * kOut *
                                                  kPix);
  for (int i = threadIdx.x; i < kOut * kPix / 4; i += kThreads) {
    const float v = i / (kPix / 4) == n_chan + 1 ? 1.f : 0.f;
    o[i] = make_float4(v, v, v, v);
  }
}

// ---- one CTA a tile: idle tiles, and busy tiles when they fill the card ----
template <int NV>  // NV = C + A accumulated value rows
__device__ __forceinline__ void walk_tile(const float* __restrict__ feats,
                                          const int* __restrict__ cnt,
                                          float* __restrict__ out, int T,
                                          int K, int tiles_x, int n_chan,
                                          int resident) {
  constexpr int kRows = 6 + NV;
  __shared__ float sm[kRows * kBatch];
  __shared__ int s_scan[kThreads / 32];
  const int t = blockIdx.x;
  const int p = threadIdx.x;
  const int n = min(cnt[t], K);
  if (n <= 0) {
    write_idle<NV>(out, t, n_chan);
    return;
  }
  int n_busy, t0, t1, mine;
  count_busy(cnt, T, K, s_scan, &n_busy, &t0, &t1, &mine);
  if (split_for(n_busy, resident) > 1) return;  // the split kernel's tile

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
        sm[r * kBatch + p] =
            feats[(static_cast<size_t>(r) * T + t) * K + base + p];
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
__global__ void __launch_bounds__(kThreads)
composite_fwd_kernel(const float* __restrict__ feats,
                     const int* __restrict__ cnt,
                     float* __restrict__ out,
                     int T, int K, int tiles_x, int n_chan, int resident) {
  walk_tile<NV>(feats, cnt, out, T, K, tiles_x, n_chan, resident);
  // This grid is the split kernel's programmatic dependent and runs beside
  // it: the two write disjoint tiles. One thread waits for the split grid
  // all the same (in an ordinary launch it returns at once), so that this
  // grid cannot complete before it, and work queued after it sees both.
  if (blockIdx.x == 0 && threadIdx.x == 0)
    asm volatile("griddepcontrol.wait;" ::: "memory");
}

// Dynamic shared memory of the split kernel, in floats: three segments'
// staged rows [3][6+NV][seg], then two segments' [seg][pixel] alphas and log
// steps (log T after (B)); the lanes' partial sums [S][NV+1][256/S] reuse
// the floats. 48.5 KB at C+A = 16.
template <int NV>
struct SplitSmem {
  static constexpr int kRows = 6 + NV;
  static constexpr int kStage = 3 * kRows * kMaxSeg;
  static constexpr int kWalk = kStage + 4 * kPairs;
  static constexpr int kCombine = kThreads * (NV + 1);
  static constexpr int kFloats = kWalk > kCombine ? kWalk : kCombine;
};

// ---- S CTAs a busy tile, while the busy tiles are few ---------------------
template <int NV>
__global__ void __launch_bounds__(kThreads, kSplitCtas)
composite_fwd_split_kernel(const float* __restrict__ feats,
                           const int* __restrict__ cnt,
                           float* __restrict__ out,
                           int T, int K, int tiles_x, int n_chan,
                           int resident) {
  using L = SplitSmem<NV>;
  constexpr int kRows = L::kRows;
  constexpr int kOut = NV + 2;
  extern __shared__ __align__(16) float smem[];
  __shared__ int s_scan[kThreads / 32];
  __shared__ int s_tile;
  const int tid = threadIdx.x;
  // every CTA is resident at once: composite_fwd_kernel launches at once
  asm volatile("griddepcontrol.launch_dependents;");

  int n_busy, t0, t1, mine;
  const int before = count_busy(cnt, T, K, s_scan, &n_busy, &t0, &t1, &mine);
  const int split = split_for(n_busy, resident);
  if (split == 1) return;  // composite_fwd_kernel's tiles
  const bool vec = K % 4 == 0 && reinterpret_cast<uintptr_t>(feats) % 16 == 0;
  const size_t rs = static_cast<size_t>(T) * K;

  // ---- the busy tiles' parts, in turn over the grid ----
  for (int item = blockIdx.x; item < n_busy * split; item += gridDim.x) {
    const int rank = item / split, part = item - rank * split;
    __syncthreads();  // the previous item's shared memory is no longer read
    if (rank >= before && rank < before + mine) {
      int k = before;
      for (int t = t0; t < t1; ++t)
        if (min(cnt[t], K) > 0 && k++ == rank) s_tile = t;
    }
    __syncthreads();
    const int t = s_tile;
    const int n = min(cnt[t], K);
    const float txf = static_cast<float>((t % tiles_x) * kTile);
    const float tyf = static_cast<float>((t / tiles_x) * kTile);
    float* o_t = out + static_cast<size_t>(t) * kOut * kPix;
    const float* src = feats + static_cast<size_t>(t) * K;

    // ---- walk this CTA's part of the tile
    auto walk = [&](auto split_c) {
      constexpr int S = decltype(split_c)::value;
      constexpr int P = kPix / S;
      constexpr int seg = kPairs / P < kMaxSeg ? kPairs / P : kMaxSeg;
      const int px = tid % P, lane = tid / P;
      const int p = part * P + px;  // tile-local pixel
      const float xf = static_cast<float>(p % kTile);
      const float yf = static_cast<float>(p / kTile);
      const int n_seg = (n + seg - 1) / seg;
      float* s_alpha = smem + L::kStage;  // [2][seg][P]
      float* s_lt = s_alpha + 2 * kPairs; // [2][seg][P]: log step, then log T
      auto rows = [&](int s) { return smem + (s % 3) * kRows * seg; };

      // ---- stage the tile's rows: segment s's slots into rows(s) [row][seg]
      auto stage = [&](int s) {
        const int at = s * seg, ns = min(seg, n - at);
        float* dst = rows(s);
        if (vec) {  // 16-byte copies: at and K are multiples of 4, so a copy
                    // that starts below n ends within K
          for (int i = tid; i < kRows * seg / 4; i += kThreads) {
            const int r = i / (seg / 4), j = 4 * (i - r * (seg / 4));
            if (j < ns)
              __pipeline_memcpy_async(dst + r * seg + j,
                                      src + r * rs + at + j,
                                      4 * sizeof(float));
          }
        } else {
          for (int i = tid; i < kRows * seg; i += kThreads) {
            const int r = i / seg, j = i - r * seg;
            if (j < ns)
              __pipeline_memcpy_async(dst + i, src + r * rs + at + j,
                                      sizeof(float));
          }
        }
        __pipeline_commit();
      };
      // (A) segment s's alphas and log steps (0 where not ok), on the slots
      // first, first + stride, ...
      auto eval = [&](int s, int first, int stride) {
        const float* sm = rows(s);
        float* al = s_alpha + (s & 1) * kPairs;
        float* ls = s_lt + (s & 1) * kPairs;
        const int ns = min(seg, n - s * seg);
#pragma unroll 4
        for (int jj = first; jj < ns; jj += stride) {
          const instag::SplatAlpha a = instag::splat_alpha(
              xf, yf, __fsub_rn(sm[jj], txf), __fsub_rn(sm[seg + jj], tyf),
              sm[2 * seg + jj], sm[3 * seg + jj], sm[4 * seg + jj],
              sm[5 * seg + jj]);
          al[jj * P + px] = a.alpha;
          ls[jj * P + px] = a.ok ? instag::log_step(a.alpha) : 0.f;
        }
      };

      float acc[NV];
#pragma unroll
      for (int c = 0; c < NV; ++c) acc[c] = 0.f;
      float wsum = 0.f;
      float log_t = 0.f;  // the contributing slots' sum of log1p(-alpha)
      bool done = false;
      int stop = 0;  // (the backward's)
      stage(0);
      if (n_seg > 1) stage(1);
      __pipeline_wait_prior(n_seg > 1 ? 1 : 0);
      __syncthreads();
      eval(0, lane, S);
      // Segment s: lane 0 runs (B) of s while the other lanes run (A) of
      // s + 1, then every lane (C) of s; three segments' rows are staged.
      for (int s = 0; s < n_seg; ++s) {
        __pipeline_wait_prior(0);  // segment s + 1's rows have landed
        __syncthreads();           // (A) of s is done, and (C) of s - 1
        if (s + 2 < n_seg) stage(s + 2);
        const int ns = min(seg, n - s * seg);
        float* al = s_alpha + (s & 1) * kPairs;
        float* ls = s_lt + (s & 1) * kPairs;
        // ---- the segments ----
        // (B) the carry, one thread a pixel, 8 slots at a time
        if (lane == 0) {
          for (int j0 = 0; j0 < ns; j0 += 8) {
            float step[8];
#pragma unroll
            for (int u = 0; u < 8; ++u)
              step[u] = j0 + u < ns ? ls[(j0 + u) * P + px] : 0.f;
            float run = log_t;  // a contributing slot's log T, again
            const unsigned keep =
                instag::carry_group(step, log_t, done, j0, stop);
#pragma unroll
            for (int u = 0; u < 8; ++u) {
              run = __fadd_rn(run, step[u]);
              if (j0 + u < ns)
                ls[(j0 + u) * P + px] = (keep >> u) & 1u ? run : kNoContrib;
            }
          }
        }
        if (lane != 0 && s + 1 < n_seg) eval(s + 1, lane - 1, S - 1);
        const bool all_done = __syncthreads_and(lane != 0 || done);
        // (C) weights and sums over this thread's slots
        const float* sm = rows(s);
#pragma unroll 4
        for (int jj = lane; jj < ns; jj += S) {
          const float lt = ls[jj * P + px];
          if (lt <= 0.f) {
            const float alpha = al[jj * P + px];
            const float w = expf(lt) * alpha / (1.f - alpha);
            wsum += w;
#pragma unroll
            for (int c = 0; c < NV; ++c) acc[c] += w * sm[(6 + c) * seg + jj];
          }
        }
        if (all_done) break;
      }

      // ---- the lanes' partial sums, added in lane order --------------------
      __pipeline_wait_prior(0);
      __syncthreads();  // the walk's shared memory is free
      float* s_part = smem;  // [S][NV+1][P]
#pragma unroll
      for (int c = 0; c < NV; ++c)
        s_part[(lane * (NV + 1) + c) * P + px] = acc[c];
      s_part[(lane * (NV + 1) + NV) * P + px] = wsum;
      if (lane == 0) o_t[(n_chan + 1) * kPix + p] = expf(log_t);
      __syncthreads();
      for (int i = tid; i < (NV + 1) * P; i += kThreads) {
        const int c = i / P, x = i % P;
        float v = s_part[c * P + x];
#pragma unroll
        for (int l = 1; l < S; ++l) v += s_part[(l * (NV + 1) + c) * P + x];
        const int row = c == NV ? n_chan : (c < n_chan ? c : c + 2);
        o_t[row * kPix + part * P + x] = v;
      }
    };
    switch (split) {
      case 2: walk(Split<2>()); break;
      case 4: walk(Split<4>()); break;
      case 8: walk(Split<8>()); break;
      default: walk(Split<kMaxSplit>()); break;
    }
  }
}

template <int NV>
cudaError_t launch(const float* feats, const int* cnt, float* out, int T,
                   int K, int tiles_x, int n_chan, cudaStream_t stream) {
  if (T < 1) return cudaSuccess;
  constexpr size_t bytes = sizeof(float) * SplitSmem<NV>::kFloats;
  cudaError_t err = cudaFuncSetAttribute(
      composite_fwd_split_kernel<NV>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(bytes));
  if (err != cudaSuccess) return err;
  static int per_sm = 0;  // resident split CTAs an SM, the same on every sm_90
  if (per_sm == 0) {
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &per_sm, composite_fwd_split_kernel<NV>, kThreads, bytes);
    if (err != cudaSuccess) return err;
  }
  int dev = 0, sms = 0;
  err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return err;
  const int resident = per_sm * sms;
  if (resident < 1) return cudaErrorInvalidConfiguration;
  composite_fwd_split_kernel<NV><<<resident, kThreads, bytes, stream>>>(
      feats, cnt, out, T, K, tiles_x, n_chan, resident);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  cudaLaunchAttribute attr;
  attr.id = cudaLaunchAttributeProgrammaticStreamSerialization;
  attr.val.programmaticStreamSerializationAllowed = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(T);
  cfg.blockDim = dim3(kThreads);
  cfg.stream = stream;
  cfg.attrs = &attr;
  cfg.numAttrs = 1;
  return cudaLaunchKernelEx(&cfg, composite_fwd_kernel<NV>, feats, cnt, out,
                            T, K, tiles_x, n_chan, resident);
}

}  // namespace

extern "C" {

// Launches the two kernels on `stream`; returns the first CUDA error.
// n_chan + n_aux must be in [1, 16]; any K. Writes every element of out
// [T, n_chan + 2 + n_aux, 256].
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
