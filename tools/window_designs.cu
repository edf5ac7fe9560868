// Designs of coalesce_window_mask, timed side by side on the card by
// tools/kernel_designs.py.  The design the port ships is in
// src/repro_torch/kernels/csrc/coalesce_window.cu (included here, so that it
// runs as it ships); these are the others it was measured against:
//
//   tile     the first design: one key a thread; a block stages its
//            256-key tile and the window-1 keys before it in shared memory,
//            waits at a barrier, then compares its key against the keys
//            before it in a loop whose trip count is the window;
//   runs     window 8, 16-byte aligned keys: lane t owns the 16 consecutive
//            keys 16t..16t+15 of its warp's 512, four 16-byte loads (each
//            spread over 2 KiB across the warp: every sector is requested
//            by two loads) and one 16-byte store; the 7 keys before its run
//            from the lane before it, a warp's first lane reading them from
//            global memory;
//   generic  the shipped chunks on their generic path (the halo's capacity
//            16, the window a predicate) at window 8: what compiling the
//            window as such buys.
#include "../src/repro_torch/kernels/csrc/coalesce_window.cu"

namespace {

__global__ void __launch_bounds__(kThreads)
tile_kernel(const int32_t* __restrict__ keys, uint8_t* __restrict__ out,
            int64_t m, int window) {
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
  const int reach = i < halo ? static_cast<int>(i) : halo;
  bool hit = false;
  for (int d = 1; d <= reach; ++d) hit |= tile[kMaxHalo + t - d] == k;
  out[i] = hit ? 1 : 0;
}

// runs of 16 at window 8; the keys after the last whole run one a thread
__global__ void __launch_bounds__(kThreads)
runs_kernel(const int32_t* __restrict__ keys, uint8_t* __restrict__ out,
            int64_t m) {
  constexpr int H = 7, R = 16;
  const int64_t t = static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x;
  const int lane = threadIdx.x & 31;
  const int64_t runs = m / R;
  const bool active = t < runs;
  const int64_t start = t * R;
  int32_t k[R];
  if (active) {
    const int4* src = reinterpret_cast<const int4*>(keys + start);
    int4 v[R / 4];
#pragma unroll
    for (int q = 0; q < R / 4; ++q) v[q] = __ldcs(src + q);
#pragma unroll
    for (int q = 0; q < R / 4; ++q) {
      k[4 * q] = v[q].x;
      k[4 * q + 1] = v[q].y;
      k[4 * q + 2] = v[q].z;
      k[4 * q + 3] = v[q].w;
    }
  } else {
#pragma unroll
    for (int p = 0; p < R; ++p) k[p] = 0;
  }
  int32_t a[H];
#pragma unroll
  for (int j = 0; j < H; ++j) {
    a[j] = __shfl_up_sync(kFull, k[R - H + j], 1);
    const int64_t pos = start - H + j;
    if (lane == 0 && active) a[j] = pos >= 0 ? __ldg(keys + pos) : 0;
  }
  if (active) {
    uint32_t w[R / 4] = {0, 0, 0, 0};
#pragma unroll
    for (int p = 0; p < R; ++p) {
      bool hit = false;
#pragma unroll
      for (int d = 1; d <= H; ++d) {
        const int c = H + p - d;
        const int32_t prev = c >= H ? k[c >= H ? c - H : 0] : a[c < H ? c : 0];
        hit |= prev == k[p] && start + p - d >= 0;
      }
      w[p / 4] |= static_cast<uint32_t>(hit) << (8 * (p % 4));
    }
    __stcs(reinterpret_cast<uint4*>(out + start),
           make_uint4(w[0], w[1], w[2], w[3]));
  }
  const int64_t i = runs * R + t;
  if (i < m) {
    const int32_t key = keys[i];
    const int64_t reach = i < H ? i : H;
    bool hit = false;
    for (int64_t d = 1; d <= reach; ++d) hit |= keys[i - d] == key;
    out[i] = hit ? 1 : 0;
  }
}

}  // namespace

// design: 0 tile, 1 runs (window 8, keys and output 16-byte aligned), 2
// generic (window 8).
extern "C" int window_design_launch(int32_t design, const void* keys,
                                    void* out, int64_t m, int32_t window,
                                    void* stream) {
  const auto* k = static_cast<const int32_t*>(keys);
  auto* o = static_cast<uint8_t*>(out);
  const auto s = static_cast<cudaStream_t>(stream);
  if (window < 2 || window > kMaxHalo + 1 || m == 0) {
    return cudaErrorInvalidValue;
  }
  switch (design) {
    case 0:
      tile_kernel<<<static_cast<unsigned>((m + kThreads - 1) / kThreads),
                    kThreads, 0, s>>>(k, o, m, window);
      return cudaGetLastError();
    case 1: {
      if (window != 8 || reinterpret_cast<uintptr_t>(k) % 16 ||
          reinterpret_cast<uintptr_t>(o) % 16) {
        return cudaErrorInvalidValue;
      }
      const int64_t threads = m / 16 > 16 ? m / 16 : 16;
      runs_kernel<<<static_cast<unsigned>((threads + kThreads - 1) /
                                          kThreads), kThreads, 0, s>>>(
          k, o, m);
      return cudaGetLastError();
    }
    case 2:
      if (window != 8) return cudaErrorInvalidValue;
      return launch_window<16, false>(k, o, m, window - 1, s);
    default: return cudaErrorInvalidValue;
  }
}
