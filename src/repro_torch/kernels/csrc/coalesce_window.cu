// RLU coalescing-window mask for Hopper (sm_90a): coalesce_window_mask.
//
// Replaces the Pallas TPU kernel of repro/kernels/coalesce_window.py
// (_window_kernel).  For an (m,) int32 probe stream it writes the (m,) bool
// mask "this key equals one of the previous window-1 keys": the probes the
// paper's 8-entry optimization buffer filters (§3.2.1, Fig. 7).  The TPU
// kernel walks the stream block by block and carries each block's tail,
// which XLA builds on the host side as a (blocks, window-1) array; threads
// here run in parallel in no order, so each one gets the keys before its
// own from its neighbours or reads them itself.
//
// What bounds it: bytes.  Per key it reads 4 bytes and writes 1, and does
// window-1 compares; at 60M keys that is 300 MB against 0.4 G compares, far
// below the compare rate.  To stream 300 MB at HBM's rate the card needs
// megabytes of loads in flight and whole sectors in every request.  So a
// warp owns a span of 512 consecutive keys in four chunks of 128, and lane
// t the four keys 4t..4t+3 of each chunk: four 16-byte evict-first loads a
// lane, all issued before the first compare (64 bytes in flight a lane,
// where one key a thread had 4), each contiguous across the warp (512
// bytes), and four 4-byte stores of its mask bytes, each contiguous too.
// The keys before a lane's four (the halo, window-1 of them) are the keys
// of the lanes before it, moved over with __shfl_sync, one shuffle a halo
// key: up to 2 lanes back at window 8, up to 8 at window 32; lanes below
// that distance take them from the previous chunk of the lanes at the
// warp's end, and in the first chunk read them from global memory, where
// they sit in L2.  No shared memory, no barrier, no loop with a trip count
// known only at run time: window 8 is compiled as such, the other windows
// take a generic path with the halo's capacity (16 or 31) fixed and the
// window a predicate on each compare.
//
// A keys pointer that is not 16-byte aligned (a slice) leaves a scalar
// head (up to 3 keys, until the keys align), and a length that is not a
// whole number of spans a scalar tail (up to 511 keys): the first threads
// of the grid take them one key a thread, reading the keys before theirs
// from global memory.  The spans store their mask with 4-byte stores where
// the output at the first span is 4-byte aligned, else byte by byte.
//
// Designs measured against this one (tools/window_designs.cu): one key a
// thread with a 256-key tile and its halo in shared memory behind a
// barrier (the first design, 3.2x this one's time at window 8); runs of 16
// consecutive keys a lane, four 16-byte loads each spread over 2 KiB of a
// warp's span and one 16-byte store, the halo from the lane before (as
// fast at window 8: bytes, not the layout, bound both); this kernel on its
// generic path at window 8 (2.1x).
//
// Meaning at the stream start: a position before 0 holds nothing and never
// matches, whatever the key (the plain version in core/dedup.py agrees).
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kChunks = 4;                 // chunks of a warp's span
constexpr int kSpan = 32 * 4 * kChunks;    // keys of a warp's span
constexpr int kMaxHalo = 31;               // window <= 32
constexpr unsigned kFull = 0xffffffffu;

// The mask bytes of one lane's four keys k (positions base .. base + 3) in
// one chunk.  a[j]: the key at base - H + j.  H: the halo's capacity;
// kExact: the halo is H (window H + 1), else `halo` <= H.  kCheck: some
// positions may lie before the stream's start (the first span only).
template <int H, bool kExact, bool kCheck>
__device__ __forceinline__ uint32_t chunk_mask(const int32_t (&k)[4],
                                               const int32_t (&a)[H],
                                               int halo, int64_t base) {
  uint32_t w = 0;
#pragma unroll
  for (int p = 0; p < 4; ++p) {
    bool hit = false;
#pragma unroll
    for (int d = 1; d <= H; ++d) {
      const int c = H + p - d;  // index into [halo a, keys k]
      const int32_t prev = c >= H ? k[c >= H ? c - H : 0] : a[c < H ? c : 0];
      bool ok = prev == k[p];
      if (!kExact) ok &= d <= halo;
      if (kCheck) ok &= base + p - d >= 0;
      hit |= ok;
    }
    w |= static_cast<uint32_t>(hit) << (8 * p);
  }
  return w;
}

// head: keys before the first span (scalar), spans: whole spans of kSpan
// from there, n_scalar: head plus the tail after the spans.  kVec: the
// output at the first span is 4-byte aligned.
template <int H, bool kExact, bool kVec>
__global__ void __launch_bounds__(kThreads)
window_kernel(const int32_t* __restrict__ keys, uint8_t* __restrict__ out,
              int64_t m, int64_t head, int64_t spans, int64_t n_scalar,
              int halo) {
  const int64_t t = static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x;
  const int64_t warp = t / 32;
  const int lane = threadIdx.x & 31;
  if (warp < spans) {  // the whole warp or none of it
    const int64_t span = head + warp * kSpan;
    const int4* src = reinterpret_cast<const int4*>(keys + span);
    int4 v[kChunks];
#pragma unroll
    for (int q = 0; q < kChunks; ++q) v[q] = __ldcs(src + 32 * q + lane);
    int32_t k[kChunks][4];
#pragma unroll
    for (int q = 0; q < kChunks; ++q) {
      k[q][0] = v[q].x;
      k[q][1] = v[q].y;
      k[q][2] = v[q].z;
      k[q][3] = v[q].w;
    }
#pragma unroll
    for (int q = 0; q < kChunks; ++q) {
      const int64_t base = span + 128 * q + 4 * lane;
      // the halo: the key `back` before base is key r of the lane `dist`
      // back; a lane below dist gets it from the previous chunk of the lane
      // at the warp's end, or in the first chunk from global memory
      int32_t a[H];
#pragma unroll
      for (int j = 0; j < H; ++j) {
        const int back = H - j;           // 1 .. H
        const int dist = (back + 3) / 4;  // lanes back: 1 .. 8
        const int r = 4 * dist - back;    // 0 .. 3
        const int32_t mine =
            q > 0 && lane >= 32 - dist ? k[q > 0 ? q - 1 : 0][r] : k[q][r];
        a[j] = __shfl_sync(kFull, mine, (lane - dist) & 31);
        if (q == 0 && lane < dist) {
          const int64_t pos = base - back;
          a[j] = pos >= 0 && (kExact || back <= halo) ? __ldg(keys + pos) : 0;
        }
      }
      const uint32_t w = span >= H
          ? chunk_mask<H, kExact, false>(k[q], a, halo, base)
          : chunk_mask<H, kExact, true>(k[q], a, halo, base);
      if (kVec) {
        __stcs(reinterpret_cast<uint32_t*>(out + span) + 32 * q + lane, w);
      } else {
#pragma unroll
        for (int p = 0; p < 4; ++p) {
          out[base + p] = static_cast<uint8_t>(w >> (8 * p));
        }
      }
    }
  }
  // the scalar head and tail, one key a thread
  if (t < n_scalar) {
    const int64_t i = t < head ? t : head + spans * kSpan + (t - head);
    const int32_t key = keys[i];
    const int reach = i < halo ? static_cast<int>(i) : halo;
    bool hit = false;
    for (int d = 1; d <= reach; ++d) hit |= keys[i - d] == key;
    out[i] = hit ? 1 : 0;
  }
}

template <int H, bool kExact>
int launch_window(const int32_t* keys, uint8_t* out, int64_t m, int halo,
                  cudaStream_t s) {
  // keys before the first 16-byte aligned one (a slice may start anywhere)
  const int64_t mis = static_cast<int64_t>(
      reinterpret_cast<uintptr_t>(keys) % 16);
  if (mis % 4) return cudaErrorMisalignedAddress;
  int64_t head = (16 - mis) % 16 / 4;
  if (head > m) head = m;
  const int64_t spans = (m - head) / kSpan;
  const int64_t n_scalar = m - spans * kSpan;  // head + tail
  const int64_t threads = 32 * spans > n_scalar ? 32 * spans : n_scalar;
  const unsigned grid = static_cast<unsigned>((threads + kThreads - 1) /
                                              kThreads);
  const bool vec = reinterpret_cast<uintptr_t>(out + head) % 4 == 0;
  if (vec) {
    window_kernel<H, kExact, true><<<grid, kThreads, 0, s>>>(
        keys, out, m, head, spans, n_scalar, halo);
  } else {
    window_kernel<H, kExact, false><<<grid, kThreads, 0, s>>>(
        keys, out, m, head, spans, n_scalar, halo);
  }
  return cudaGetLastError();
}

// window 8 as such; the other windows with a halo of capacity 16 (up to 4
// lanes back) or 31 (up to 8)
int launch_coalesce(const int32_t* keys, uint8_t* out, int64_t m, int window,
                    cudaStream_t s) {
  const int halo = window - 1;
  if (window == 8) return launch_window<7, true>(keys, out, m, halo, s);
  if (halo <= 16) return launch_window<16, false>(keys, out, m, halo, s);
  return launch_window<kMaxHalo, false>(keys, out, m, halo, s);
}

}  // namespace

extern "C" int coalesce_window_mask_launch(const void* keys, void* out,
                                           int64_t m, int32_t window,
                                           void* stream) {
  if (window < 2 || window > kMaxHalo + 1) return cudaErrorInvalidValue;
  if (m == 0) return cudaSuccess;
  return launch_coalesce(static_cast<const int32_t*>(keys),
                         static_cast<uint8_t*>(out), m, window,
                         static_cast<cudaStream_t>(stream));
}
