// Tile -> splat scatter-add — hand-written for Hopper (sm_90a).
//
// Replaces instag_tpu/ops/pallas_scatter.py::_scatter_kernel (reached
// through scatter_add_tiles): the VJP of the per-tile feature gather
// ftiles[F, T, K] = feats[F, ids[T, K]] (valid prefix of cnt[t] slots):
//   acc[F, N] = 0;  acc[f, ids[t, j]] += g[f, t, j]  for j < cnt[t].
// The TPU kernel kept [N/128, F, 128] rows and rotated lanes because Mosaic
// cannot index lanes dynamically; nothing of that layout is needed here.
//
// What bounds it on an H100: bytes. g and ids of the valid slots read once
// and acc written once: ~2.6 MB at the training shape (F=16, N=32768,
// sum(cnt) ~8.5k of T*K = 262k slots at 512^2), under 1 us at 3.35 TB/s.
//
// Design: one thread per (tile, slot); slots >= cnt[t] return at once, so
// the work follows sum(cnt), not T*K. A thread reads its splat id and adds
// its F values with fp32 atomicAdd (a splat sits in a few tiles, so
// collisions are rare). Neighbouring threads read neighbouring slots of
// each g row (coalesced). The order of the adds to one splat is not fixed,
// so the last bits of a sum may differ between runs. Ids outside [0, N)
// are skipped. acc is zeroed on the same stream first.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 128;

__global__ void __launch_bounds__(kThreads)
scatter_add_kernel(const float* __restrict__ g, const int* __restrict__ ids,
                   const int* __restrict__ cnt, float* __restrict__ acc,
                   int F, int T, int K, int N, int blocks_per_tile) {
  const int t = blockIdx.x / blocks_per_tile;
  const int j = (blockIdx.x % blocks_per_tile) * kThreads + threadIdx.x;
  if (j >= min(cnt[t], K)) return;
  const int id = ids[static_cast<size_t>(t) * K + j];
  if (id < 0 || id >= N) return;
  const size_t g_stride = static_cast<size_t>(T) * K;
  const float* gp = g + static_cast<size_t>(t) * K + j;
  for (int f = 0; f < F; ++f)
    atomicAdd(acc + static_cast<size_t>(f) * N + id, gp[f * g_stride]);
}

}  // namespace

extern "C" {

// Zeroes acc [F, N] and launches on `stream`; returns the first CUDA error
// (cudaGetLastError() after the launch).
int scatter_add_launch(const void* g, const void* ids, const void* cnt,
                       void* acc, int F, int T, int K, int N, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err = cudaMemsetAsync(
      acc, 0, sizeof(float) * static_cast<size_t>(F) * N, s);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int blocks_per_tile = (K + kThreads - 1) / kThreads;
  const long long blocks = static_cast<long long>(T) * blocks_per_tile;
  if (blocks > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
  if (blocks > 0)
    scatter_add_kernel<<<static_cast<unsigned>(blocks), kThreads, 0, s>>>(
        static_cast<const float*>(g), static_cast<const int*>(ids),
        static_cast<const int*>(cnt), static_cast<float*>(acc), F, T, K, N,
        blocks_per_tile);
  return static_cast<int>(cudaGetLastError());
}

const char* scatter_add_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
