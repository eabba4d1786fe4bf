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
// and acc written once: ~2.7 MB at the training shape (F=16, N=32768,
// sum(cnt) ~8.5k of T*K = 262k slots at 512^2), ~0.8 us at 3.35 TB/s. A
// call this small is set by latency instead: the zeroing of acc (a pass of
// its own, ~2.4 us as PyTorch's fill), the launches, the chain of dependent
// loads in front of the adds, and how many SMs share a busy tile's fp32
// atomics. PR 2's version (a memset, then blocks of 128 threads behind
// three levels of dependent loads) took 0.0087 ms there on an NVIDIA H100
// 80GB HBM3 at 700 W, against 0.0069-0.0073 ms for index_add_ on columns
// masked beforehand; this one takes ~0.0065 ms in the same calls (PERF.md).
//
// Design: two kernels on the launch stream, chained by Hopper's
// programmatic dependent launch. The first zeroes acc (a float4 a thread
// where acc is aligned) and at once lets the second start; the second
// loads what it needs while the zeros are written and waits for them
// (griddepcontrol.wait) only before its adds. The add kernel is one thread per (tile, slot) in
// blocks of 64: the 4096 adds of a full tile (256 slots, 16 rows) spread
// over 4 blocks, and the T * K / 64 blocks, most of which have nothing to
// add, are still one wave. A thread loads cnt[t] and its slot's id
// together (the id of a slot past cnt is read but unused), then its slot's
// F values of g (neighbouring threads read neighbouring slots of a g row),
// and adds them with fp32 atomics (red.global). The order of the adds to
// one splat is not fixed, so the last bits of a sum may differ between
// runs. Ids outside [0, N) are skipped. Persistent grids that first scan
// cnt to spread the valid slots evenly, with the zeros in a memset or
// behind a grid-wide barrier, were slower on the card (PERF.md).

#include <cstdint>

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 64;        // slots a block of the add kernel
constexpr int kZeroThreads = 256;

// acc[0, n) = 0, in stores of V (float4 where acc allows, else float).
// Lets the kernel that follows on the stream launch at once.
template <typename V>
__global__ void __launch_bounds__(kZeroThreads)
zero_kernel(V* __restrict__ acc, long long n) {
  asm volatile("griddepcontrol.launch_dependents;");
  const long long stride = static_cast<long long>(gridDim.x) * kZeroThreads;
  for (long long i = static_cast<long long>(blockIdx.x) * kZeroThreads +
                     threadIdx.x;
       i < n; i += stride)
    acc[i] = V{};
}

template <typename V>
cudaError_t zero(void* acc, long long n, int sms, cudaStream_t s) {
  long long blocks = (n + kZeroThreads - 1) / kZeroThreads;
  blocks = blocks < 8LL * sms ? blocks : 8LL * sms;
  zero_kernel<V><<<static_cast<unsigned>(blocks), kZeroThreads, 0, s>>>(
      static_cast<V*>(acc), n);
  return cudaGetLastError();
}

__global__ void __launch_bounds__(kThreads)
scatter_add_kernel(const float* __restrict__ g, const int* __restrict__ ids,
                   const int* __restrict__ cnt, float* __restrict__ acc,
                   int F, int T, int K, int N, int blocks_per_tile) {
  const int t = blockIdx.x / blocks_per_tile;
  const int j = (blockIdx.x % blocks_per_tile) * kThreads + threadIdx.x;
  const int n = min(cnt[t], K);
  const int id = j < K ? ids[static_cast<size_t>(t) * K + j] : -1;
  // Past griddepcontrol.wait the zero kernel's stores are complete and
  // visible (in an ordinary launch it returns at once). A thread with
  // nothing to add leaves at once and frees its slot; the first thread
  // waits all the same, so this grid cannot complete before the zeros.
  const bool adds = j < n && id >= 0 && id < N;
  if (adds || (blockIdx.x == 0 && threadIdx.x == 0))
    asm volatile("griddepcontrol.wait;" ::: "memory");
  if (!adds) return;
  const size_t g_stride = static_cast<size_t>(T) * K;
  const float* gp = g + static_cast<size_t>(t) * K + j;
  for (int f = 0; f < F; ++f)
    atomicAdd(acc + static_cast<size_t>(f) * N + id, gp[f * g_stride]);
}

}  // namespace

extern "C" {

// Zeroes acc [F, N] and adds into it, both on `stream`; returns the first
// CUDA error.
int scatter_add_launch(const void* g, const void* ids, const void* cnt,
                       void* acc, int F, int T, int K, int N, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (F < 0 || T < 0 || K < 0 || N < 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const long long n_acc = static_cast<long long>(F) * N;
  if (n_acc == 0) return cudaSuccess;
  const int blocks_per_tile = (K + kThreads - 1) / kThreads;
  const long long blocks = static_cast<long long>(T) * blocks_per_tile;
  if (blocks > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
  int dev = 0, sms = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return static_cast<int>(err);
  err = n_acc % 4 == 0 && reinterpret_cast<uintptr_t>(acc) % 16 == 0
      ? zero<float4>(acc, n_acc / 4, sms, s)
      : zero<float>(acc, n_acc, sms, s);
  if (err != cudaSuccess || blocks == 0) return static_cast<int>(err);
  cudaLaunchAttribute attr;
  attr.id = cudaLaunchAttributeProgrammaticStreamSerialization;
  attr.val.programmaticStreamSerializationAllowed = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(static_cast<unsigned>(blocks));
  cfg.blockDim = dim3(kThreads);
  cfg.stream = s;
  cfg.attrs = &attr;
  cfg.numAttrs = 1;
  return static_cast<int>(cudaLaunchKernelEx(
      &cfg, scatter_add_kernel, static_cast<const float*>(g),
      static_cast<const int*>(ids), static_cast<const int*>(cnt),
      static_cast<float*>(acc), F, T, K, N, blocks_per_tile));
}

const char* scatter_add_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
