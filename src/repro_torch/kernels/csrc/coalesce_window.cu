// RLU coalescing-window mask for Hopper (sm_90a): coalesce_window_mask.
//
// Replaces the Pallas TPU kernel of repro/kernels/coalesce_window.py
// (_window_kernel).  For an (m,) int32 probe stream it writes the (m,) bool
// mask "this key equals one of the previous window-1 keys": the probes the
// paper's 8-entry optimization buffer filters (§3.2.1, Fig. 7).  The TPU
// kernel walks the stream block by block and carries each block's tail,
// which XLA builds on the host side as a (blocks, window-1) array; blocks
// here run in parallel in no order, so each one reads the keys before its
// tile itself.
//
// What bounds it: bytes.  Per key it reads 4 bytes and writes 1, and does
// window-1 compares; at 60M keys that is 300 MB against 0.4 G compares, far
// below the compare rate.  Design: one thread per key.  A block stages its
// 256-key tile and the window-1 keys before it (the halo, read from global
// memory, so block boundaries need nothing from the host) in shared memory
// with coalesced loads, then each thread compares its key against the
// window-1 keys before it from shared memory.  Any window from 2 to 32.
//
// Meaning at the stream start: a position before 0 holds nothing and never
// matches, whatever the key (the plain version in core/dedup.py agrees).
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kMaxHalo = 31;  // window <= 32

__global__ void __launch_bounds__(kThreads)
coalesce_window_kernel(const int32_t* __restrict__ keys,
                       uint8_t* __restrict__ out, int64_t m, int window) {
  __shared__ int32_t tile[kMaxHalo + kThreads];
  const int halo = window - 1;
  const int t = threadIdx.x;
  const int64_t base = static_cast<int64_t>(blockIdx.x) * kThreads;
  const int64_t i = base + t;
  if (i < m) tile[kMaxHalo + t] = keys[i];
  if (t < halo) {
    const int64_t j = base - halo + t;  // the halo: keys before the tile
    if (j >= 0) tile[kMaxHalo - halo + t] = keys[j];
  }
  __syncthreads();
  if (i >= m) return;
  const int32_t k = tile[kMaxHalo + t];
  // only positions >= 0 exist: d <= i
  const int reach = i < halo ? static_cast<int>(i) : halo;
  bool hit = false;
  for (int d = 1; d <= reach; ++d) hit |= tile[kMaxHalo + t - d] == k;
  out[i] = hit ? 1 : 0;
}

}  // namespace

extern "C" int coalesce_window_mask_launch(const void* keys, void* out,
                                           int64_t m, int32_t window,
                                           void* stream) {
  if (window < 2 || window > kMaxHalo + 1) return cudaErrorInvalidValue;
  if (m == 0) return cudaSuccess;
  const unsigned grid = static_cast<unsigned>((m + kThreads - 1) / kThreads);
  coalesce_window_kernel<<<grid, kThreads, 0,
                           static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int32_t*>(keys), static_cast<uint8_t*>(out), m,
      window);
  return cudaGetLastError();
}
