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
// What bounds it on an H100: at the training shape (C=8, A=2, K=256, 1024
// tiles at 512^2) the bytes, ~5.3 us at 3.35 TB/s, are mostly the dense
// dfeats (16.8 MB, of which the idle tiles' zeros are 16.2 MB). The busy
// tiles' own work is bound by operations: ~49 + 6C + 4A fp32 operations per
// evaluated pixel-splat pair, ~3.4 us at the fp32 peak for the synthetic
// face's 2.2 M pairs, all in 36 of 1024 tiles. What holds a kernel back is
// latency: each splat's terms are a chain of dependent transcendentals, and
// a tile has only 256 pixels. PR 2's kernel (one CTA of 256 threads per
// tile, one thread per pixel walking the chain three times, 80 warp
// shuffles per slot and warp) took 0.2275 ms there on an NVIDIA H100 80GB
// HBM3 at 700 W; a first redesign with one thread per pixel in clusters
// of four 64-thread CTAs took 0.1045 ms, most of it with one warp per
// scheduler waiting on its own chain. This design takes 0.0607 ms there
// (0.2245 ms for PR 2's in the same call), and 0.545 ms (PR 2's 0.535) on
// a cloud that busies all 1024 tiles, where its 16 warps an SM wait on the
// same chains (PERF.md).
//
// Design: the work that is independent per (slot, pixel) pair runs on four
// threads per pixel; only the two carries that must be serial run on one.
//   * A persistent grid of clusters of 4 CTAs (as many as fit at once)
//     takes the tiles in turn from a list that every CTA builds from cnt,
//     busy tiles first: a busy tile's 256 pixels are split over the
//     cluster's 4 CTAs (64 pixels and 256 threads each), so it runs on 4
//     SMs, and the clusters left over zero the idle tiles' dfeats meanwhile
//     (coalesced stores, the same bytes as a memset). A busy tile's CTAs
//     zero its rows past 6 + C + A and its slots past cnt, and stage its
//     feature rows in shared memory.
//   * Pass 1, per segment of 64 slots: (A) four threads per pixel evaluate
//     splat_alpha and log1p(-alpha) of the segment's slots through
//     composite_common.cuh into shared memory; (B) one thread per pixel
//     adds the log steps with __fadd_rn in slot order and applies the
//     forward's stop test expf(log_t) >= 1e-4 (skipped while log_t > -9,
//     where expf(log_t) > 1.2e-4 for certain), through the header's
//     carry_group, which the forward's carry runs too: every contribution
//     decision and T_final are composite_fwd.cu's, bit for bit. It keeps op
//     e^power where the slot contributes and 0 elsewhere: each splat is
//     evaluated once per pixel. The segments stop when every pixel is done.
//   * Pass 2, per segment back to front: (C1) four threads per pixel form G
//     per (slot, pixel); (C2) one thread per pixel carries the suffix sum S
//     and the transmittance, recovered by T_excl = T_incl / (1 - alpha)
//     from T_final (no transcendental), and writes dpow and w; (C3) the
//     segment's sums over the CTA's pixels as FFMA loops in pixel order,
//     each thread one slot and one half of the pixels, for the six dpow
//     moments or the C + A channel products.
//   * The 4 CTAs' partial sums (two halves each) are added in a fixed
//     order through distributed shared memory, and one thread per slot
//     writes the slot's rows. No atomics on floats: two runs give the same
//     bits.
//   float32 throughout, no tensor cores, no fast-math exp. Shared memory is
//   ~(65 + 6 + C + A) * 4 bytes per slot of K and 4 bytes per tile: K up to
//   ~500 fits at 1024 tiles.

#include <cooperative_groups.h>
#include <cuda_pipeline.h>
#include <cuda_runtime.h>

#include "composite_common.cuh"

namespace cg = cooperative_groups;

namespace {

using instag::kPix;
using instag::kTile;
constexpr int kCluster = 4;                  // CTAs per busy tile
constexpr int kPx = kPix / kCluster;         // pixels per CTA
constexpr int kLanes = 4;                    // threads per pixel
constexpr int kThreads = kPx * kLanes;
constexpr int kSeg = 64;                     // slots per segment
constexpr int kLd = kPx + 1;                 // row stride of [slot][pixel]
constexpr int kHalf = kPx / 2;               // pixels per partial sum
constexpr size_t kMaxShared = 232448 - 1024;

static_assert(kThreads == 4 * kSeg, "the sums give each slot 4 threads");

// Dynamic shared memory, in floats: [ks][kLd] per-(slot, pixel) terms (each
// segment's area then holds its [6+NV][2][kSeg] partial sums), [kSeg][kLd]
// the segment's log steps, then G, then w, [6+NV][ks] the tile's feature
// rows, [kPx][NG] this CTA's cotangent rows, and [T] ints, the tiles in
// the order the clusters take them.
// ks is K rounded up to kSeg.
template <int NV>
struct Layout {
  static constexpr int kRows = 6 + NV;
  static constexpr int NG = (NV + 3) / 4 * 4;
  int ks, seg, feat, g, tiles, total;
  __host__ __device__ Layout(int K, int T)
      : ks((K + kSeg - 1) / kSeg * kSeg),
        seg(ks * kLd),
        feat(seg + kSeg * kLd),
        g(feat + kRows * ks),
        tiles(g + kPx * NG),
        total(tiles + T) {}
};

template <int NV>  // NV = C + A value rows
__global__ void __launch_bounds__(kThreads, 2)
composite_bwd_kernel(const float* __restrict__ feats,
                     const int* __restrict__ cnt,
                     const float* __restrict__ g,
                     float* __restrict__ dfeats,
                     int F, int T, int K, int tiles_x, int n_chan) {
  using L = Layout<NV>;
  constexpr int kRows = L::kRows;
  constexpr int NG = L::NG;
  extern __shared__ __align__(16) float smem[];
  __shared__ int s_scan[kThreads / 32];
  __shared__ int s_used;
  const L lay(K, T);
  const int ks = lay.ks;
  float* s_pre = smem;               // [ks][kLd]
  float* s_seg = smem + lay.seg;     // [kSeg][kLd]
  float* s_feat = smem + lay.feat;   // [kRows][ks]
  float* s_g = smem + lay.g;         // [kPx][NG]
  int* s_tiles = reinterpret_cast<int*>(smem + lay.tiles);

  cg::cluster_group cluster = cg::this_cluster();
  const int rank = static_cast<int>(cluster.block_rank());
  const int tid = threadIdx.x;
  const int px = tid % kPx, lane = tid / kPx;
  const int p = rank * kPx + px;     // tile-local pixel
  const float xf = static_cast<float>(p % kTile);
  const float yf = static_cast<float>(p / kTile);
  const size_t rs = static_cast<size_t>(T) * K;

  // ---- the tiles, busy ones first, each group in tile order ----------------
  int n_busy;
  {
    const int per = (T + kThreads - 1) / kThreads;
    const int t0 = min(T, tid * per), t1 = min(T, t0 + per);
    int mine = 0;
    for (int t = t0; t < t1; ++t) mine += cnt[t] > 0;
    int at = instag::block_exclusive_sum<kThreads>(mine, s_scan, &n_busy);
    for (int t = t0; t < t1; ++t) {
      if (cnt[t] > 0)
        s_tiles[at++] = t;
      else
        s_tiles[n_busy + t - at] = t;
    }
    __syncthreads();
  }

  // the clusters take the tiles in turn; an idle tile is only zeroed
  const int n_clusters = static_cast<int>(gridDim.x) / kCluster;
  for (int k = static_cast<int>(blockIdx.x) / kCluster; k < T;
       k += n_clusters) {
    const int t = s_tiles[k];
    const int n = k < n_busy ? min(cnt[t], K) : 0;
    // zeros: every row past 6 + C + A, and every slot past n
    for (int i = rank * kThreads + tid; i < F * K; i += kCluster * kThreads) {
      const int r = i / K, j = i - r * K;
      if (r >= kRows || j >= n)
        dfeats[r * rs + static_cast<size_t>(t) * K + j] = 0.f;
    }
    if (n == 0) continue;
    const int n_pad = (n + kSeg - 1) / kSeg * kSeg;
    const float txf = static_cast<float>((t % tiles_x) * kTile);
    const float tyf = static_cast<float>((t / tiles_x) * kTile);

    // ---- the tile's feature rows, copied asynchronously; zeros past n -----
    for (int i = tid; i < kRows * n_pad; i += kThreads) {
      const int r = i / n_pad, j = i - r * n_pad;
      float* dst = s_feat + r * ks + j;
      if (j < n)
        __pipeline_memcpy_async(
            dst, feats + (static_cast<size_t>(r) * T + t) * K + j,
            sizeof(float));
      else
        *dst = 0.f;
    }
    __pipeline_commit();

    // this pixel's cotangents, loaded meanwhile (every lane keeps them)
    const float* g_p = g + static_cast<size_t>(t) * (NV + 2) * kPix + p;
    float gv[NV];  // channel rows, then aux rows (feature row order)
#pragma unroll
    for (int c = 0; c < NV; ++c) gv[c] = g_p[(c < n_chan ? c : c + 2) * kPix];
    const float g_alpha = g_p[n_chan * kPix];
    const float g_T = g_p[(n_chan + 1) * kPix];
    if (lane == 0) {
#pragma unroll
      for (int c = 0; c < NG; ++c) s_g[px * NG + c] = c < NV ? gv[c] : 0.f;
    }
    if (tid == 0) s_used = 0;
    __pipeline_wait_prior(0);
    __syncthreads();
    for (int j = tid; j < n; j += kThreads) {  // tile-local, as the forward
      s_feat[j] = __fsub_rn(s_feat[j], txf);
      s_feat[ks + j] = __fsub_rn(s_feat[ks + j], tyf);
    }
    __syncthreads();

    // ---- pass 1: the forward chain, as composite_fwd.cu decides it --------
    float log_t = 0.f;  // sum of the contributing slots' log1p(-alpha)
    int stop = n;       // first slot that does not contribute (n if none)
    bool done = false;
    for (int base = 0; base < n; base += kSeg) {
      const int nb = min(kSeg, n - base);
      // (A) the segment's splat terms: op e^power, or -1 where not ok, and
      // the log steps, 0 where not ok
#pragma unroll 4
      for (int jj = lane; jj < kSeg; jj += kLanes) {
        if (jj < nb) {
          const int j = base + jj;
          const instag::SplatAlpha s = instag::splat_alpha(
              xf, yf, s_feat[j], s_feat[ks + j], s_feat[2 * ks + j],
              s_feat[3 * ks + j], s_feat[4 * ks + j], s_feat[5 * ks + j]);
          s_pre[j * kLd + px] = s.ok ? s.pre : -1.f;
          s_seg[jj * kLd + px] = s.ok ? instag::log_step(s.alpha) : 0.f;
        }
      }
      __syncthreads();
      // (B) the log-T carry and the stop test, in slot order, 8 slots at a
      // time (composite_common.cuh's carry_group, as the forward runs it)
      if (lane == 0) {
        for (int j0 = 0; j0 < nb; j0 += 8) {
          float pr[8], step[8];
#pragma unroll
          for (int u = 0; u < 8; ++u) {
            const bool in = j0 + u < nb;
            pr[u] = in ? s_pre[(base + j0 + u) * kLd + px] : -1.f;
            step[u] = in ? s_seg[(j0 + u) * kLd + px] : 0.f;
          }
          const unsigned keep =
              instag::carry_group(step, log_t, done, base + j0, stop);
#pragma unroll
          for (int u = 0; u < 8; ++u)
            if (j0 + u < nb)
              s_pre[(base + j0 + u) * kLd + px] =
                  (keep >> u) & 1u ? pr[u] : 0.f;
        }
      }
      if (__syncthreads_and(lane != 0 || done)) break;
    }
    if (lane == 0) atomicMax(&s_used, stop);
    const float t_final = expf(log_t);  // the forward's T_final, bit for bit
    const float btf = g_T * t_final;
    __syncthreads();
    const int used = s_used;  // slots past every pixel's stop: zero terms
    const int n_seg = n_pad / kSeg;
    const int used_seg = (used + kSeg - 1) / kSeg;

    // segments no pixel of this CTA reaches: zero partial sums
    for (int b = used_seg; b < n_seg; ++b)
      for (int i = tid; i < kRows * 2 * kSeg; i += kThreads)
        s_pre[b * kSeg * kLd + i] = 0.f;

    // ---- pass 2: segments back to front -----------------------------------
    float S = 0.f;          // suffix sum of G w
    float t_cur = t_final;  // T_incl of the current slot
    for (int b = used_seg - 1; b >= 0; --b) {
      const int base = b * kSeg;
      float* pre_b = s_pre + base * kLd;
      // (C1) G per (slot, pixel)
#pragma unroll 4
      for (int jj = lane; jj < kSeg; jj += kLanes) {
        float G = g_alpha;
#pragma unroll
        for (int c = 0; c < NV; ++c)
          if (c < n_chan) G = fmaf(s_feat[(6 + c) * ks + base + jj], gv[c], G);
        s_seg[jj * kLd + px] = G;
      }
      __syncthreads();
      // (C2) the suffix sum and the transmittance, back to front
      if (lane == 0) {
        for (int j0 = kSeg - 8; j0 >= 0; j0 -= 8) {
          float pr[8], G[8], a[8], r[8];
#pragma unroll
          for (int u = 0; u < 8; ++u) {
            pr[u] = base + j0 + u < used ? pre_b[(j0 + u) * kLd + px] : 0.f;
            G[u] = s_seg[(j0 + u) * kLd + px];
            a[u] = fminf(0.99f, pr[u]);
            r[u] = __fdividef(1.f, 1.f - a[u]);  // 1 - a in [0.01, 1]
          }
#pragma unroll
          for (int u = 7; u >= 0; --u) {
            const float t_excl = t_cur * r[u];
            const float w = t_excl * a[u];
            const float dalpha = G[u] * t_excl - (S + btf) * r[u];
            pre_b[(j0 + u) * kLd + px] = pr[u] < 0.99f ? dalpha * pr[u] : 0.f;
            s_seg[(j0 + u) * kLd + px] = w;
            S = fmaf(G[u], w, S);
            t_cur = t_excl;
          }
        }
      }
      __syncthreads();
      // (C3) the segment's sums over this CTA's pixels, in pixel order:
      // thread (slot js, part h), h = 0, 1 the dpow moments and h = 2, 3 the
      // channel products, over pixel half h % 2
      const int js = tid % kSeg, h = tid / kSeg;
      const int i0 = (h & 1) * kHalf;
      float m[6] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
      float acc[NV];
#pragma unroll
      for (int c = 0; c < NV; ++c) acc[c] = 0.f;
      if (h < 2) {
        const float gx = s_feat[base + js], gy = s_feat[ks + base + js];
        const float* d_row = pre_b + js * kLd;
        const int x0 = (rank * kPx) % kTile, y0 = (rank * kPx) / kTile;
#pragma unroll 8
        for (int i = i0; i < i0 + kHalf; ++i) {
          const float dx = __fsub_rn(static_cast<float>(x0 + i % kTile), gx);
          const float dy = __fsub_rn(static_cast<float>(y0 + i / kTile), gy);
          const float d = d_row[i];
          const float ddx = d * dx, ddy = d * dy;
          m[0] += d;
          m[1] += ddx;
          m[2] += ddy;
          m[3] = fmaf(ddx, dx, m[3]);
          m[4] = fmaf(ddx, dy, m[4]);
          m[5] = fmaf(ddy, dy, m[5]);
        }
      } else {
        const float* w_row = s_seg + js * kLd;
#pragma unroll 4
        for (int i = i0; i < i0 + kHalf; ++i) {
          const float w = w_row[i];
          const float4* gi = reinterpret_cast<const float4*>(s_g + i * NG);
#pragma unroll
          for (int c4 = 0; c4 < NG / 4; ++c4) {
            const float4 gg = gi[c4];
            const float gs[4] = {gg.x, gg.y, gg.z, gg.w};
#pragma unroll
            for (int e = 0; e < 4; ++e)
              if (4 * c4 + e < NV)
                acc[4 * c4 + e] = fmaf(gs[e], w, acc[4 * c4 + e]);
          }
        }
      }
      __syncthreads();  // the segment's dpow and w are read: it takes sums
      float* part = pre_b + (h & 1) * kSeg + js;  // [kRows][2][kSeg]
      if (h < 2) {
#pragma unroll
        for (int r = 0; r < 6; ++r) part[r * 2 * kSeg] = m[r];
      } else {
#pragma unroll
        for (int c = 0; c < NV; ++c) part[(6 + c) * 2 * kSeg] = acc[c];
      }
    }

    // ---- the partial sums of the 4 CTAs, in rank order -> gradients --------
    cluster.sync();
    const int chunk = (n + kCluster - 1) / kCluster;  // slots per CTA
    for (int j = rank * chunk + tid; j < min(n, (rank + 1) * chunk);
         j += kThreads) {
      const int off = (j / kSeg) * kSeg * kLd + j % kSeg;
      float v[kRows];
#pragma unroll
      for (int r = 0; r < kRows; ++r) v[r] = 0.f;
#pragma unroll
      for (int rk = 0; rk < kCluster; ++rk) {
        const float* peer = cluster.map_shared_rank(s_pre, rk) + off;
#pragma unroll
        for (int r = 0; r < kRows; ++r)
          v[r] += peer[2 * r * kSeg] + peer[(2 * r + 1) * kSeg];
      }
      const float ca = s_feat[2 * ks + j], cb = s_feat[3 * ks + j];
      const float cc = s_feat[4 * ks + j], op = s_feat[5 * ks + j];
      float* out = dfeats + static_cast<size_t>(t) * K + j;
      out[0] = ca * v[1] + cb * v[2];
      out[rs] = cc * v[2] + cb * v[1];
      out[2 * rs] = -0.5f * v[3];
      out[3 * rs] = -v[4];
      out[4 * rs] = -0.5f * v[5];
      out[5 * rs] = op > 0.f ? v[0] / fmaxf(op, 1e-20f) : 0.f;
#pragma unroll
      for (int c = 0; c < NV; ++c) out[(6 + c) * rs] = v[6 + c];
    }
    cluster.sync();  // peers read this CTA's sums and rows until here
  }
}

template <int NV>
size_t shared_bytes(int K, int T) {
  return sizeof(float) * static_cast<size_t>(Layout<NV>(K, T).total);
}

template <int NV>
cudaError_t launch(const float* feats, const int* cnt, const float* g,
                   float* dfeats, int F, int T, int K, int tiles_x,
                   int n_chan, cudaStream_t stream) {
  const size_t bytes = shared_bytes<NV>(K, T);
  if (K < 1 || bytes > kMaxShared ||
      static_cast<long long>(F) * T * K >= (1LL << 31))
    return cudaErrorInvalidValue;
  if (T < 1) return cudaSuccess;
  cudaError_t err = cudaFuncSetAttribute(composite_bwd_kernel<NV>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(bytes));
  if (err != cudaSuccess) return err;
  cudaLaunchAttribute attr;
  attr.id = cudaLaunchAttributeClusterDimension;
  attr.val.clusterDim.x = kCluster;
  attr.val.clusterDim.y = 1;
  attr.val.clusterDim.z = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(kCluster);
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = bytes;
  cfg.stream = stream;
  cfg.attrs = &attr;
  cfg.numAttrs = 1;
  int clusters = 0;  // as many clusters as are resident at once
  err = cudaOccupancyMaxActiveClusters(&clusters, composite_bwd_kernel<NV>,
                                       &cfg);
  if (err != cudaSuccess) return err;
  if (clusters < 1) return cudaErrorInvalidConfiguration;
  cfg.gridDim = dim3(kCluster * min(clusters, T));
  return cudaLaunchKernelEx(&cfg, composite_bwd_kernel<NV>, feats, cnt, g,
                            dfeats, F, T, K, tiles_x, n_chan);
}

}  // namespace

extern "C" {

// Launches on `stream`; returns the first CUDA error. g is
// [T, n_chan + 2 + n_aux, 256]; n_chan + n_aux must be in [1, 16],
// F >= 6 + n_chan + n_aux, F * T * K < 2^31, and K and T small enough for
// composite_bwd_shared_bytes(K, T, n_chan + n_aux) to fit in a CTA (K = 256
// does up to ~20k tiles). Writes every element of dfeats [F, T, K].
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

// Dynamic shared memory of one CTA for K slots, T tiles and nv = n_chan +
// n_aux value rows (0 for an nv the kernel does not take).
long long composite_bwd_shared_bytes(int K, int T, int nv) {
  switch (nv) {
#define INSTAG_CASE(v) \
  case v:              \
    return static_cast<long long>(shared_bytes<v>(K, T));
    INSTAG_CASE(1) INSTAG_CASE(2) INSTAG_CASE(3) INSTAG_CASE(4)
    INSTAG_CASE(5) INSTAG_CASE(6) INSTAG_CASE(7) INSTAG_CASE(8)
    INSTAG_CASE(9) INSTAG_CASE(10) INSTAG_CASE(11) INSTAG_CASE(12)
    INSTAG_CASE(13) INSTAG_CASE(14) INSTAG_CASE(15) INSTAG_CASE(16)
#undef INSTAG_CASE
    default:
      return 0;
  }
}

const char* composite_bwd_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
